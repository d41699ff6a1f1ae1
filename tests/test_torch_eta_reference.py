"""The benchmark's plain ETA (``portbench/reference/eta.py``) against the
port's ETA on the CPU, through the benchmark's driver for it
(``portbench/drivers/train_two_stage.py``): the cell
``eta_taobao.train_long`` at a tiny size (``portbench/tests/tiny.py``: a
few ids a field, L = 16), seeded weights and projection, three dense steps
of the configuration's ``gsu_esu`` loss.

Limits: in fp32 both sides compute the same sums on the same device, so
the losses agree to 1e-6 of their value and the gradient and change norms
to 1e-5 and 1e-3 of the larger leaf (``portbench/tests``' DIN and DeepFM
limits); in bf16 to bf16's rounding (2e-3, 2e-2 and 5e-2, the same tests'),
over batches of 512 rows (``BF16_BATCH``).
The picks are discrete, so the program's ``topk_indices`` equal the
reference's exactly in both.

The search picks ``topk`` = 5 of the 16 steps here (the cell's 16 would
pick them all), and the recent attention keeps ``short_len`` = 4.
"""

import numpy as np
import pytest
import torch

from portbench.lib import check, spec, traffic
from portbench.lib.trace import Tracer
from portbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 4242
WORKLOAD = "eta_taobao.train_long"
# bf16 runs take 512 rows: at 64 a head's bias moves by bf16's rounding
# under Adam by up to 7 % of its change (4 hash bits)
BF16_BATCH = 512


def _cell(dtype="float32", **params):
    c = tiny.cell(WORKLOAD, batch=BF16_BATCH if dtype == "bfloat16" else tiny.SMALL["batch"])
    c.config["compute_dtype"] = dtype
    c.config["params"] = dict(c.config["params"], topk=5, short_len=4, **params)
    return c


def _driver(cell):
    return spec.load_module("drivers", cell.traffic["driver"]).Driver(cell, SEED, CPU, Tracer(False))


def _numbers(cell):
    driver = _driver(cell)
    driver.setup()
    numbers, failed = driver.check(cell.limits)
    assert failed == 0
    return driver, numbers


def _picks(driver, batch):
    """The program's and the reference's picks on one host batch, from the
    driver's weights and projection (before any step)."""
    model = driver.trainer.init_state(seed=1).model
    weights = driver._weights()
    proj = driver._projection()
    model.load_state_dict(dict(weights, hash_proj=proj))
    inputs = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        got = model.eval()(inputs)["topk_indices"].long()
        want = driver.reference.forward(weights, inputs, driver.cfg, lambda x: x, proj)[2]
    return got, want


def _sparse_rows(pool):
    """Each batch with row 0 holding no live step and row 1 three."""
    for b in pool:
        for name in ("hist_item", "hist_cate"):
            b[name][0] = 0
            b[name][1, 3:] = 0
    return pool


CASES = {"default": {}, "4_hash_bits": {"n_hash_bits": 4}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_agree_in_fp32(case):
    _, n = _numbers(_cell(**CASES[case]))
    assert n["loss_gap"] < 1e-6 and n["grad_gap"] < 1e-5 and n["change_gap"] < 1e-3, n
    assert n["grad_diff"] < 1e-5, n


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_in_bf16_stay_within_bf16_rounding(case):
    _, n = _numbers(_cell("bfloat16", **CASES[case]))
    assert n["loss_gap"] < 2e-3 and n["grad_gap"] < 2e-2 and n["change_gap"] < 5e-2, n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_four_hash_bits_tie_heavily_and_pick_as_the_program_does(dtype):
    """At 4 bits most of a row's 16 similarities tie: the picks follow the
    lower step first, exactly as the program's ``topk_select``."""
    cell = _cell(dtype, n_hash_bits=4)
    driver = _driver(cell)
    driver.setup()
    batch = driver.pool[0]
    got, want = _picks(driver, batch)
    assert torch.equal(got, want)
    from portbench.reference import eta

    cfg = driver.cfg
    table = driver._weights()["emb.embedding"]
    keys = torch.cat([torch.nn.functional.embedding(torch.as_tensor(batch[s]), table)
                      for s in cfg["sequences"]], dim=-1)
    query = torch.cat([torch.nn.functional.embedding(torch.as_tensor(batch[q]), table)
                       for q in cfg["query_features"]], dim=-1)
    proj = driver._projection()
    sim = (eta.simhash(query, proj)[:, None, :] == eta.simhash(keys, proj)).sum(dim=-1)
    # ties: a row's 16 similarities take at most 5 values
    assert float((sim[:, :, None] == sim[:, None, :]).float().mean()) > 0.2
    # within a run of equal similarity the picks are in step order
    rows = torch.arange(got.shape[0])[:, None]
    picked = sim[rows, got]
    same = picked[:, 1:] == picked[:, :-1]
    assert bool((got[:, 1:][same] > got[:, :-1][same]).all())
    assert bool(same.any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_with_fewer_live_steps_than_k_and_with_none(dtype, monkeypatch):
    """Row 0 of every batch has no live step and row 1 three, fewer than
    ``topk``: the three steps agree as above, and the picks are the
    program's (row 0 its first k steps, row 1 its three live steps first)."""
    make_pool = traffic.make_pool
    monkeypatch.setattr(traffic, "make_pool", lambda *a: _sparse_rows(make_pool(*a)))
    cell = _cell(dtype)
    driver, n = _numbers(cell)
    if dtype == "float32":
        assert n["loss_gap"] < 1e-6 and n["grad_gap"] < 1e-5 and n["change_gap"] < 1e-3, n
    else:
        assert n["loss_gap"] < 2e-3 and n["grad_gap"] < 2e-2 and n["change_gap"] < 5e-2, n
    got, want = _picks(driver, driver.pool[0])
    assert torch.equal(got, want)
    assert got[0].tolist() == list(range(5))
    assert sorted(got[1, :3].tolist()) == [0, 1, 2]


def test_the_projection_round_trips_through_the_buffer():
    """The seed's projection is loaded bit for bit into ``hash_proj``, stays
    a buffer (no parameter, no optimizer state), is unchanged by the steps,
    and another seed draws another one."""
    cell = _cell()
    driver = _driver(cell)
    driver.setup()
    model = driver.state.model
    proj = driver._projection()
    assert proj.shape == (64, cell.config["params"]["n_hash_bits"]) and proj.dtype == torch.float32
    assert torch.equal(model.hash_proj, proj)
    assert "hash_proj" not in dict(model.named_parameters())
    assert all(p is not model.hash_proj for p in driver.state.optimizer.state)
    assert torch.equal(model.state_dict()["hash_proj"], proj)
    other = driver.reference.projection(cell.config, SEED + 1, CPU)
    assert not torch.equal(other, proj)
    assert abs(float(proj.mean())) < 0.5 and 0.5 < float(proj.std()) < 1.5


def test_a_state_left_unchanged_and_half_a_batch_are_far_from_the_reference():
    """The numbers of a state the steps left unchanged read 1 by the change
    norms; half of each batch moves the first gradient: both fail the
    cell's limits, which the program passes."""
    cell = _cell("bfloat16")
    driver, n = _numbers(cell)
    assert check.verdict(n, cell.limits)[0], n
    half = check.train_numbers(driver._reference(rows=slice(0, int(cell.traffic["batch"]) // 2)),
                               driver._reference())
    assert not check.verdict(half, cell.limits)[0], half
    readings = dict(driver.readings, change_norms={k: 0.0 for k in driver.readings["change_norms"]})
    unchanged = check.train_numbers(readings, driver._reference())
    assert unchanged["change_gap"] == pytest.approx(1.0)
    assert not check.verdict(unchanged, cell.limits)[0], unchanged


def test_the_control_fails_a_number_the_program_passes():
    """The reference in the program's place in fp8 where the program
    computes in bf16 fails one of the cell's limits, which the program
    passes (``calibrate_two_stage.py``'s sides, at 512 rows)."""
    cell = _cell("bfloat16")
    sides = _driver(cell).sides(["program", "control"])
    assert all(sides["program"][k] <= v for k, v in cell.limits.items()), sides
    assert any(sides["control"][k] > v for k, v in cell.limits.items()), sides


def test_the_reference_imports_nothing_of_the_program_and_keeps_tf32_off():
    import ast

    src = (spec.PACKAGE / "reference" / "eta.py").read_text()
    for node in ast.walk(ast.parse(src)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in ("tpurec_torch", "tpurec", "jax", "jaxlib", "flax"), name
    assert "with plain_fp32():" in src


def test_the_work_count_holds_the_search_once_and_the_rest_three_times():
    cell = spec.load_cell(WORKLOAD)
    work = spec.load_module("work", cell.config["work"])
    base = {"rows": 8192, "live": 0, "ids": 0}
    more = dict(base, live=1000)
    # a live step adds its SimHash product alone: K x n_bits multiply-adds
    assert work.flops(cell.config, more) - work.flops(cell.config, base) == 2 * 64 * 16 * 1000
    per_row = (work.flops(cell.config, dict(base, rows=2)) - work.flops(cell.config, dict(base, rows=1)))
    assert per_row == pytest.approx(2 * 64 * 16 + 3 * (2 * 64 * 64 * (2 + 32) + 4 * 16 * 64
                                                       + 2 * 64 * 64 * (2 + 16) + 4 * 8 * 64
                                                       + 2 * (160 * 64 + 64 * 32 + 32 * 2)
                                                       + 2 * (224 * 64 + 64 * 32 + 32 * 2)))
    assert np.isfinite(work.flops(cell.config, {"rows": 8192, "live": 8192 * 1024, "ids": 0}))
