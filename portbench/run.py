"""Run one cell of the port's benchmark once, on the machine it starts on:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It loads the cell (``BENCHMARK.json`` and the files it names), makes the
weights and the traffic from the seed, builds the system under test
(``tpurec_torch`` only), warms up, measures for ``--seconds``, checks what
the timed path produced against the plain reference, and prints one JSON
line last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` (with ``--trace 1`` its busy and traced
seconds), with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, which also end standard error. It exits
non-zero and prints no result without a CUDA device, with fewer devices
than the cell asks for, or when JAX or the JAX package was imported.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib import check, spec  # noqa: E402
from portbench.lib.trace import Tracer  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpurec")


def forbidden_modules(names=None):
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``tpurec_torch`` passes."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def power_limit_w():
    """The card's power limit in W from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _number(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device, t_start: float):
    """One run of ``cell``: returns the result's dict (``checks`` last)."""
    import torch

    tracer = Tracer(trace)
    driver = spec.load_module("drivers", cell.traffic["driver"]).Driver(cell, seed, device, tracer)
    driver.setup()
    if trace:
        tracer.warm()
    setup_s = time.perf_counter() - t_start
    tracer.spans.clear()
    tracer.marks.clear()
    driver.window(seconds)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics = {}
    if trace:
        ctx = driver.layer_context()
        for m in cell.per_layer:
            value = spec.load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(driver.end_to_end(), setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": False, "attempted": driver.attempted(), "failed": 0, "metrics": metrics,
              "device": dev}
    if trace:
        prof = tracer.profile
        start, end = prof.span_us() if prof else (0.0, 0.0)
        dev["busy_s"] = prof.busy_and_gaps()[0] * 1e-6 if prof else 0.0
        dev["window_s"] = (end - start) * 1e-6
        if prof is not None:
            result["breakdown"] = prof.breakdown()
            hosts = [(a, b) for a, b, _ in prof.host]
            print(f"trace: device ops {len(prof.device)} over [{start:.0f}, {end:.0f}] us; host spans "
                  f"{len(hosts)} over [{min(hosts, default=(0, 0))[0]:.0f}, "
                  f"{max((b for _, b in hosts), default=0):.0f}] us", file=sys.stderr)
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, failed = driver.check(cell.limits)
    ok, checks = check.verdict(numbers, cell.limits)
    result["failed"] = int(failed)
    result["correct"] = bool(ok and failed == 0 and result["attempted"] > 0)
    if cuda:
        dev["power_limit_w"] = power_limit_w()
    result["checks"] = {k: {"value": _number(v["value"]), "limit": v["limit"]} for k, v in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "portbench" / "cuda_cache"))
    # one host thread for the process's own CPU work (the feed's pinned
    # copies, numpy): the host-paced cell's runs spread by tens of percent
    # on a busy host, and a thread pool there adds waits for its slowest
    # thread (PERF.md gives what it costs the feed)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, _T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run imported {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
