"""What one cell is: its entry in ``BENCHMARK.json``, its configuration's
file, its traffic mix's file and its limits' file, each found by name.

A cell ``<config>.<traffic>`` reads ``portbench/configs/<config>.json`` (as
``BENCHMARK.json`` names it), ``portbench/traffic/<traffic>.json`` and
``portbench/limits/<cell>.json``; the code that runs it is found the same way
(``portbench/drivers/<driver>.py``, ``portbench/reference/<model>.py``,
``portbench/work/<name>.py``, ``portbench/metrics/<metric>.py``). Adding a cell,
a mix or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

PACKAGE = Path(__file__).resolve().parents[1]
ROOT = PACKAGE.parent


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str) -> ModuleType:
    """``portbench/<kind>/<name>.py`` by path (a metric's name holds dots)."""
    path = PACKAGE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]  # the metrics this cell reports with --trace 0
    per_layer: List[Dict[str, Any]]  # and with --trace 1


def _reports(metric: Dict[str, Any], cell: str, e2e_names: List[str]) -> bool:
    """Whether ``cell`` reports ``metric``: its ``workloads`` name the cell,
    or, without the key, the cell reports the end-to-end metric it moves
    (an end-to-end metric without the key: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_names


def load_cell(workload: str, bench: Optional[Dict[str, Any]] = None) -> Cell:
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"unknown workload {workload!r}; known: {sorted(entries)}")
    w = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(PACKAGE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(PACKAGE / "limits" / f"{workload}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload, names)]
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e, per_layer)
