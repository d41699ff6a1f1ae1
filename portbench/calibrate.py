"""The readings that a cell's limits are set from, on the chip at the
cell's own size:

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 [--sides program,control,half]

For each seed, each side's numbers against the plain fp32 reference:

- ``program``: the system under test, through the run's own set-up (its
  first steps), with no window;
- ``control``: the reference put in the program's place, computed in fp8
  where the program computes in bf16 (``reference.common.fp8``);
- ``half``: the reference in the program's place on half of each batch,
  the loss the mean over the rest;
- ``leaves``: each leaf's norms, program against reference, for looking
  into which leaf sets a number.

A state left unchanged reads 1 by the training numbers' measure and needs
no run. Prints one JSON line a seed and side, then the largest program
reading and the smallest reading of each other side for each number.
"""

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib import check, spec  # noqa: E402
from portbench.lib.trace import Tracer  # noqa: E402
from portbench.reference.common import ROUNDINGS, make_weights, train_readings  # noqa: E402
from portbench.drivers.train import CHECK_STEPS  # noqa: E402


def leaf_table(prog, ref) -> dict:
    """Each leaf's first-gradient and change norms, program against
    reference, for looking into which leaf sets a number."""
    return {k: [prog["grad_norms"].get(k), ref["grad_norms"][k], prog["change_norms"].get(k),
                ref["change_norms"][k]] for k in ref["grad_norms"]}


def train_sides(cell, seed, device, sides):
    driver = spec.load_module("drivers", cell.traffic["driver"]).Driver(cell, seed, device, Tracer(False))
    out = {}
    if "program" in sides:
        driver.setup()
        prog = driver.readings
        driver.release()
    else:
        from portbench.lib import traffic

        driver.pool = traffic.make_pool(cell.config, cell.traffic, seed)
    gc.collect()
    empty_cache(device)
    ref_mod, cfg, batches = driver.reference, cell.config, driver.pool[:CHECK_STEPS]
    weights = make_weights(ref_mod.layout(cfg), seed, device)
    ref = train_readings(ref_mod.forward, cfg, weights, batches, device)
    if "program" in sides:
        out["program"] = check.train_numbers(prog, ref)
    if "leaves" in sides:
        out["leaves"] = leaf_table(prog, ref) | {"losses": [prog["losses"], ref["losses"]]}
    if "control" in sides:
        ctl = train_readings(ref_mod.forward, cfg, weights, batches, device, ROUNDINGS["fp8"])
        out["control"] = check.train_numbers(ctl, ref)
    if "half" in sides:
        rows = slice(0, int(cell.traffic["batch"]) // 2)
        half = train_readings(ref_mod.forward, cfg, weights, batches, device, rows=rows)
        out["half"] = check.train_numbers(half, ref)
    return out


def empty_cache(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sides", default="program,control,half")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    device = torch.device(args.device)
    cell = spec.load_cell(args.workload)
    sides = args.sides.split(",")
    summary = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        for side, numbers in train_sides(cell, seed, device, sides).items():
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side, **numbers}),
                  flush=True)
            if side == "leaves":
                continue
            for name, v in numbers.items():
                key = (side, name)
                pick = max if side == "program" else min
                summary[key] = v if key not in summary else pick(summary[key], v)
    print(json.dumps({"summary": {f"{s}.{n}": v for (s, n), v in sorted(summary.items())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
