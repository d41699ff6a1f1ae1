"""The run's last line and its refusals."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.lib import spec
from portbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", ["din_amazon.train", "deepfm_criteo.train_dense"])
@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line_has_exactly_the_contracts_keys(workload, trace):
    # 1024 rows: at 64 DeepFM's bf16 gradients are too few to average out the
    # rounding that the cells' 8192-row limits allow for
    r = run.run_cell(tiny.cell(workload, batch=1024), 31, 0.3, trace, torch.device("cpu"), 0.0)
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(r) == want
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    cell = spec.load_cell(workload)
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(r["metrics"]) <= names
    if not trace:
        assert set(r["metrics"]) == names
    assert set(r["checks"]) == set(cell.limits)
    json.dumps(r, allow_nan=False)


def test_without_a_card_the_run_prints_no_result_and_fails(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = run.main(["--workload", "din_amazon.train", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert code != 0 and out.out == "" and "CUDA" in out.err


def test_the_import_check_compares_whole_top_level_names():
    assert run.forbidden_modules(["tpurec_torch", "tpurec_torch.ops", "numpy", "jaxtyping"]) == []
    assert run.forbidden_modules(["tpurec.models", "jax", "jaxlib.xla", "flax.linen"]) == [
        "flax.linen", "jax", "jaxlib.xla", "tpurec.models"]


def test_what_a_run_imports_holds_to_the_rule():
    code = (
        "import sys; sys.path.insert(0, '.');"
        "from portbench import run; from portbench.lib import spec, program;"
        "from tpurec_torch.train.trainer import Trainer;"
        "[spec.load_module(k, p.stem) for k in ('drivers', 'metrics', 'reference', 'work')"
        " for p in sorted((spec.PACKAGE / k).glob('*.py')) if p.stem != '__init__'];"
        "print(run.forbidden_modules())"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card, capsys):
    assert run.main(["--workload", "din_amazon.train", "--seed", "2147483659", "--seconds", "2"]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
