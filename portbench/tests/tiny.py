"""Cells at a size a CPU test can hold: the configurations' widths, a few
ids a field, short histories and small batches."""

from __future__ import annotations

import copy

from portbench.lib import spec

SMALL = {"batch": 64, "pool": 4, "warmup_steps": 1, "profile_steps": 3}


def cell(workload: str, batch: int = SMALL["batch"]) -> spec.Cell:
    c = spec.load_cell(workload)
    cfg = copy.deepcopy(c.config)
    cfg["features"] = {k: min(v, 97 + 13 * i) for i, (k, v) in enumerate(cfg["features"].items())}
    if cfg.get("max_seq_length"):
        cfg["max_seq_length"] = 16
    mix = dict(c.traffic, **dict(SMALL, batch=batch))
    return spec.Cell(c.name, c.chips, cfg, mix, dict(c.limits), c.end_to_end, c.per_layer)
