"""The port's sorted-stream embedding ops against
``tpurec.ops.pallas.embedding_update`` on the CPU (its Pallas kernels in
interpret mode, as ``tests/test_fused_embedding.py`` runs them), and a numpy
emulation of the CUDA design of ``fused_scatter_add`` held against the plain
version.

Tolerances:
- ids, orders and gathered rows: exact (they are copies);
- aggregated gradients: both sides sum in fp32, in other orders (the JAX
  kernel by one-hot matmuls over 128-id blocks), atol = rtol = 1e-5 for sums
  of a few dozen N(0, 1) rows;
- the emulation: each row within ``SUM_RTOL`` (2^-20, 16 fp32 ulps) of the
  sum of its rows' magnitudes, plus ``SUM_ATOL`` = 1e-7 (fp32 sums of the
  same terms in two orders);
- after Adam: rtol 2e-5, atol 2e-6 (``test_fused_embedding.py``'s own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurec.ops.pallas import embedding_update as jeu
from tpurec_torch.ops import embedding_update as eu
from tpurec_torch.ops import kernels

torch.set_num_threads(1)

GRAD_TOL = dict(atol=1e-5, rtol=1e-5)
ADAM_TOL = dict(atol=2e-6, rtol=2e-5)
SUM_RTOL = 2.0**-20
SUM_ATOL = 1e-7


def _ids(v, n, seed=0, skew=0.0):
    """n ids in [0, v); a share ``skew`` of them is id 0 (padding-like)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, v, size=n)
    return np.where(rng.random(n) < skew, 0, ids).astype(np.int64)


def _normal(shape, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _plans(ids, v, block_rows=1024, chunk=256):
    """(JAX plan, port plan) over the same ids: small chunks (several per
    case) and one table tile (see ``test_fused_scatter_add_over_many_tiles``)."""
    jplan = jeu.make_scatter_plan(jnp.asarray(ids), v, block_rows, chunk)
    return jplan, eu.make_scatter_plan(torch.from_numpy(ids), v)


# --------------------------------------------------------------------------
# the plan
@pytest.mark.parametrize("skew", [0.0, 0.4])
def test_make_scatter_plan_matches_jax(skew):
    ids = _ids(700, 3000, skew=skew)
    jplan, plan = _plans(ids, 700)
    assert plan.n == jplan.n == 3000 and plan.num_rows == 700
    assert plan.sids.dtype == torch.int32 and plan.order.dtype == torch.int64
    np.testing.assert_array_equal(plan.sids.numpy(), np.asarray(jplan.sids[: jplan.n]))
    np.testing.assert_array_equal(plan.order.numpy(), np.asarray(jplan.order))


# --------------------------------------------------------------------------
# kernel #9's function, against the JAX kernel
@pytest.mark.parametrize(
    "v,d,n,skew",
    [(1000, 1, 3000, 0.0), (333, 8, 900, 0.0), (1000, 32, 2100, 0.4), (300, 160, 1003, 0.0)],
)
def test_fused_scatter_add_matches_jax(v, d, n, skew):
    """Duplicates in every case (n ≥ v/3), more than one 256-id chunk, the
    (V, 1) w-table width and a width above 128 (JAX column slabs)."""
    ids = _ids(v, n, skew=skew)
    grads = _normal((n, d))
    jplan, plan = _plans(ids, v)
    jgs = jnp.take(jnp.asarray(grads), jplan.order, axis=0)
    want = jeu.fused_scatter_add(v, d, jplan, jgs, interpret=True)
    got = eu.fused_scatter_add(v, d, plan, torch.from_numpy(grads).index_select(0, plan.order))
    assert got.shape == (v, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
    untouched = np.setdiff1d(np.arange(v), ids)
    assert not got.numpy()[untouched].any()
    ref = jeu.scatter_add_reference((v, d), jnp.asarray(ids), jnp.asarray(grads))
    np.testing.assert_allclose(
        eu.scatter_add_plain(v, torch.from_numpy(ids), torch.from_numpy(grads)).numpy(),
        np.asarray(ref), **GRAD_TOL,
    )


@pytest.mark.parametrize("v,d", [(300, 160), (5000, 8)])
def test_fused_scatter_add_over_many_tiles(v, d):
    """Where the table spans more than one of the JAX kernel's tiles. The
    JAX kernel masks tiles a pass never visited by multiplying them with 0
    (``embedding_update.py:266-268``), so NaN in such a tile poisons every
    row of G: in interpret mode on the CPU it returns NaN on every row here
    (a fault of the reference, ROADMAP Queue 3). The port is held to the
    JAX plain reference, ``scatter_add_reference``."""
    ids = _ids(v, 1003, seed=11)
    grads = _normal((1003, d), seed=12)
    plan = eu.make_scatter_plan(torch.from_numpy(ids), v)
    got = eu.fused_scatter_add(v, d, plan, torch.from_numpy(grads).index_select(0, plan.order))
    want = jeu.scatter_add_reference((v, d), jnp.asarray(ids), jnp.asarray(grads))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


def test_fused_scatter_add_wrapper_takes_the_plain_version_on_cpu():
    ids = _ids(50, 200)
    grads = torch.from_numpy(_normal((200, 4)))
    plan = eu.make_scatter_plan(torch.from_numpy(ids), 50)
    before = eu.fused_scatter_add.launches
    got = eu.fused_scatter_add(50, 4, plan, grads[plan.order])
    assert torch.equal(got, eu.scatter_add_plain(50, plan.sids, grads[plan.order]))
    assert eu.fused_scatter_add.launches == before  # no kernel on the CPU
    eu.fused_scatter_add.launches = eu.gather_rows_sorted.launches = 3
    kernels.reset_launch_counts()
    assert eu.fused_scatter_add.launches == eu.gather_rows_sorted.launches == 0


# --------------------------------------------------------------------------
# the CUDA design of kernel #9, emulated in numpy
def _pow2_at_least(x):
    w = 1
    while w < x and w < 32:
        w *= 2
    return w


def _rows_per_step(d):
    """Rows of the stream a warp of a tile block takes a step: a lane holds 4
    columns where D is a multiple of 4, else 1, and a row takes that many
    columns a lane rounded up to a power of two lanes, at most 32
    (``row_lanes`` in ``csrc/embedding_update.cu``)."""
    vw = 4 if d % 4 == 0 else 1
    return 32 // _pow2_at_least(-(-d // vw))


def _emulate_fused_scatter_add(sids, grads, v, steps, warps=8, fold=True, carry=True):
    """``csrc/embedding_update.cu``'s fused_scatter_add step for step in fp32,
    the columns of a row side by side (each column is summed in the same
    order). A warp walks a slice of ``steps`` steps of ``_rows_per_step(d)``
    rows (the kernel takes 8 or 32 steps; fewer here, so small streams cross
    many slices): a segmented scan across each step's rows, the open run
    carried from step to step, runs that end inside the slice summed and the
    pieces of runs that cross it left as warp partials; each tile of
    ``warps`` slices folds those in slice order; the tile where a run that
    crosses tiles ends adds the tile partials one by one where they are at
    most 8, else in ``warps`` stripes (lanes across partials, a butterfly
    across lanes), then the stripes in warp order. Zero blocks write zeros on
    the rows no id touches (here: G starts as zeros). The partials start as
    NaN, so one read before it is written shows.
    ``fold=False`` restarts the fold's sum at every slice of a tile;
    ``carry=False`` keeps only the part of a run inside the tile where it
    begins."""
    n, d = grads.shape
    p = _rows_per_step(d)
    p2 = 32 // _pow2_at_least(d)  # finishing: a lane a column, the rest across partials
    w_rows = steps * p
    t_rows = warps * w_rows
    slices = -(-n // w_rows)
    tiles = -(-slices // warps)
    g_out = np.zeros((v, d), np.float32)
    warp_head = np.full((slices, d), np.nan, np.float32)
    warp_tail = np.full((slices, d), np.nan, np.float32)
    tile_head = np.full((tiles, d), np.nan, np.float32)
    tile_tail = np.full((tiles, d), np.nan, np.float32)

    def write(i, val):
        if 0 <= i < v:
            g_out[i] = val

    flags = []
    for s in range(slices):  # tile blocks: each warp's walk
        a, b = s * w_rows, min((s + 1) * w_rows, n)
        first, last = sids[a], sids[b - 1]
        hc = a > 0 and sids[a - 1] == first
        to = b < n and sids[b] == last
        flags.append((first, last, hc, to))

        def emit(i, val):
            if hc and i == first:
                warp_head[s] = val
            elif to and i == last:
                warp_tail[s] = val
            else:
                write(i, val)

        cur, acc = first, np.zeros(d, np.float32)
        for base in range(a, b, p):
            rows = min(p, b - base)
            ids, x = sids[base : base + rows], grads[base : base + rows].copy()
            if ids[0] != cur:
                emit(cur, acc)
                cur, acc = ids[0], np.zeros(d, np.float32)
            k = 1
            while k < p:
                y = x.copy()
                for q in range(k, rows):
                    if ids[q - k] == ids[q]:
                        y[q] = x[q] + x[q - k]
                x, k = y, 2 * k
            x[ids == cur] += acc
            for q in range(rows - 1):
                if ids[q + 1] != ids[q]:
                    emit(ids[q], x[q])
            cur, acc = ids[rows - 1], x[rows - 1]
        emit(cur, acc)
    for t in range(tiles):  # tile blocks: the fold
        acc, is_open, from_prev, rid = None, False, False, 0
        for s in range(t * warps, min((t + 1) * warps, slices)):
            first, last, hc, to = flags[s]
            whole = hc and to and first == last
            if hc:
                if s == t * warps:
                    acc, from_prev, rid = warp_head[s].copy(), True, first
                else:
                    acc = acc + warp_head[s] if fold else warp_head[s].copy()
                is_open = True
                if not whole:
                    if from_prev:
                        tile_head[t] = acc
                    else:
                        write(rid, acc)
                    is_open = False
            if to and not whole:
                acc, is_open, from_prev, rid = warp_tail[s].copy(), True, False, last
        if is_open:
            (tile_head if from_prev else tile_tail)[t] = acc
    for s in range(tiles if tiles > 1 else 0):  # the tile where a crossing run ends
        s0, s1 = s * t_rows, min((s + 1) * t_rows, n)
        i = sids[s1 - 1]
        if not (s1 < n and sids[s1] == i and not (s0 > 0 and sids[s0 - 1] == i)):
            continue
        e = (int(np.searchsorted(sids, i, side="right")) - 1) // t_rows
        total = tile_tail[s].copy()
        if e - s <= 8:  # one warp, tile by tile
            for j in range(s + 1, e + 1 if carry else s + 1):
                total = total + tile_head[j]
            write(i, total)
            continue
        per = -(-(e - s) // warps)
        for w in range(warps):
            j0, j1 = s + 1 + w * per, min(s + 1 + (w + 1) * per, e + 1)
            lanes = np.zeros((p2, d), np.float32)
            for q in range(p2):
                for j in range(j0 + q, j1, p2):
                    lanes[q] = lanes[q] + tile_head[j]
            m = 1
            while m < p2:
                lanes, m = lanes + lanes[np.arange(p2) ^ m], 2 * m
            if carry:
                total = total + lanes[0]
        write(i, total)
    return g_out


def _sum_reading(got, sids, grads, v):
    """max over rows of |got − plain| / (SUM_ATOL + SUM_RTOL · Σ|g| of the row)."""
    want = eu.scatter_add_plain(v, torch.from_numpy(sids), torch.from_numpy(grads)).numpy()
    scale = eu.scatter_add_plain(v, torch.from_numpy(sids), torch.from_numpy(np.abs(grads))).numpy()
    return float((np.abs(got - want) / (SUM_ATOL + SUM_RTOL * scale)).max())


@pytest.mark.parametrize(
    "v,d,n,skew,outside,steps",
    [
        (300, 8, 1003, 0.0, 0.0, 2),  # 16 rows a step, slices of 32, tiles of 256
        (300, 33, 1003, 0.0, 0.0, 16),  # D above 32 (one row a step), not a multiple of 4
        (40, 1, 517, 0.36, 0.0, 1),  # D=1 with a long id-0 run over slices and tiles, as DIN's padding
        (5, 3, 2000, 0.0, 0.0, 4),  # three lanes of four live: every run crosses tiles
        (20, 4, 300, 1.0, 0.0, 1),  # every id equal: one run through every tile
        (20, 4, 1, 0.0, 0.0, 64),
        (1000, 1, 3000, 0.0, 0.0, 1),  # D=1, short runs across slice boundaries
        (50, 5, 2000, 0.5, 0.0, 2),  # a run over ~16 tiles: two a stripe when finished
        (100, 2, 600, 0.0, 0.1, 2),  # ids outside [0, V), dropped
    ],
)
def test_emulated_scatter_design_matches_plain(v, d, n, skew, outside, steps):
    rng = np.random.default_rng(5)
    ids = _ids(v, n, seed=3, skew=skew)
    ids = np.where(rng.random(n) < outside, np.where(rng.random(n) < 0.5, -3, v + 2), ids)
    sids = np.sort(ids).astype(np.int32)
    grads = _normal((n, d), seed=4)
    got = _emulate_fused_scatter_add(sids, grads, v, steps)
    assert not np.isnan(got).any()
    keep = (sids >= 0) & (sids < v)
    assert _sum_reading(got, sids[keep], grads[keep], v) <= 1.0
    want = jeu.scatter_add_reference((v, d), jnp.asarray(sids[keep]), jnp.asarray(grads[keep]))
    np.testing.assert_allclose(got, np.asarray(want), **GRAD_TOL)
    # the check has teeth: a fold that drops what runs carry across slices
    # of a tile, and a finish that drops what they carry across tiles,
    # must read above the limit where such runs are
    w_rows = steps * _rows_per_step(d)
    pos = np.arange(n)
    enters = (pos % w_rows == 0) & (pos > 0) & keep
    enters[1:] &= sids[1:] == sids[:-1]
    if (enters & (pos // w_rows % 8 != 0)).any():
        broken = _emulate_fused_scatter_add(sids, grads, v, steps, fold=False)
        assert _sum_reading(broken, sids[keep], grads[keep], v) > 1.0
    start = np.searchsorted(sids, sids)
    if (keep & (pos // (8 * w_rows) != start // (8 * w_rows))).any():
        broken = _emulate_fused_scatter_add(sids, grads, v, steps, carry=False)
        assert _sum_reading(broken, sids[keep], grads[keep], v) > 1.0


def test_emulated_scatter_in_one_slice_is_the_plain_sum_bit_for_bit():
    """Where a step is one row (D=33: a lane a column), a run inside one
    slice is summed row by row in stream order, as ``index_add_`` sums it on
    the CPU."""
    ids = _ids(20, 64, seed=5)
    sids = np.sort(ids).astype(np.int32)
    grads = _normal((64, 33), seed=6)
    got = _emulate_fused_scatter_add(sids, grads, 20, steps=64)
    want = eu.scatter_add_plain(20, torch.from_numpy(sids), torch.from_numpy(grads)).numpy()
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# Adam over the aggregated gradient
def _adam_case(v, d, n, seed=0, skew=0.0):
    ids = _ids(v, n, seed=seed, skew=skew)
    grads = _normal((n, d), seed=seed + 1)
    table = _normal((v, d), seed=seed + 2, scale=0.05)
    m = _normal((v, d), seed=seed + 3, scale=0.01)
    vv = np.abs(_normal((v, d), seed=seed + 4, scale=0.01))
    return ids, grads, table, m, vv


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _assert_adam(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ADAM_TOL)


@pytest.mark.parametrize("v,d,n,skew", [(1000, 32, 3000, 0.4), (2048, 1, 3000, 0.0)])
def test_fused_scatter_adam_and_reference_match_jax(v, d, n, skew):
    ids, grads, table, m, vv = _adam_case(v, d, n, skew=skew)
    args = (jnp.asarray(table), jnp.asarray(m), jnp.asarray(vv), jnp.asarray(ids), jnp.asarray(grads))
    want = jeu.fused_scatter_adam(*args, jnp.int32(3), 1e-2, chunk=256, interpret=True)
    got = eu.fused_scatter_adam(*_t(table, m, vv, ids, grads), 3, 1e-2)
    _assert_adam(got, want)
    ref = eu.scatter_adam_reference(*_t(table, m, vv, ids, grads), 3, 1e-2)
    _assert_adam(ref, jeu.scatter_adam_reference(*args, jnp.int32(3), 1e-2))


def test_scatter_adam_sorted_and_grouped_match_jax():
    """Two tables of one id space (the FM v- and w-tables) on one plan."""
    ids, grads, table, m, vv = _adam_case(500, 16, 1500, seed=7)
    _, grads1, table1, m1, vv1 = _adam_case(500, 1, 1500, seed=8)
    jplan, plan = _plans(ids, 500)
    jg = [jnp.take(jnp.asarray(g), jplan.order, axis=0) for g in (grads, grads1)]
    tg = [torch.from_numpy(g).index_select(0, plan.order) for g in (grads, grads1)]
    want = jeu.scatter_adam_sorted(
        jnp.asarray(table), jnp.asarray(m), jnp.asarray(vv), jplan, jg[0], jnp.int32(2), 3e-3,
        interpret=True,
    )
    _assert_adam(eu.scatter_adam_sorted(*_t(table, m, vv), plan, tg[0], 2, 3e-3), want)
    jt = [jnp.asarray(x) for x in (table, table1)]
    jm = [jnp.asarray(x) for x in (m, m1)]
    jv = [jnp.asarray(x) for x in (vv, vv1)]
    want = jeu.scatter_adam_grouped(jt, jm, jv, jplan, jg, jnp.int32(2), 3e-3, interpret=True)
    got = eu.scatter_adam_grouped(
        _t(table, table1), _t(m, m1), _t(vv, vv1), plan, tg, 2, 3e-3
    )
    for got_list, want_list in zip(got, want):
        _assert_adam(got_list, want_list)


def test_adam_update_matches_jax():
    _, g, table, m, vv = _adam_case(64, 8, 1, seed=9)
    want = jeu.adam_update(*map(jnp.asarray, (table, m, vv, g[:1].repeat(64, 0))), jnp.int32(5), 1e-3)
    got = eu.adam_update_(*_t(table, m, vv, g[:1].repeat(64, 0)), 5, 1e-3)
    _assert_adam(got, want)


# --------------------------------------------------------------------------
# kernel #10's function, unpermute, the packed-view math
@pytest.mark.parametrize("d", [1, 16, 160])
def test_gather_rows_sorted_and_unpermute_match_jax(d):
    ids = _ids(700, 3000, seed=2, skew=0.2)
    table = _normal((700, d), seed=3)
    jplan, plan = _plans(ids, 700)
    want = jeu.gather_rows_sorted(jnp.asarray(table), jplan, interpret=True)
    rows = eu.gather_rows_sorted(torch.from_numpy(table), plan)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        eu.gather_rows_grouped([torch.from_numpy(table)], plan)[0].numpy(), rows.numpy()
    )
    back = eu.unpermute_rows(rows, plan)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jeu.unpermute_rows(want, jplan)))
    np.testing.assert_array_equal(back.numpy(), table[ids])


def test_unpermute_backward_is_the_gather_by_order():
    ids = _ids(300, 512, seed=3)
    jplan, plan = _plans(ids, 300, chunk=128)
    rows = _normal((512, 4), seed=4)
    cot = _normal((512, 4), seed=5)
    _, vjp = jax.vjp(lambda r: jeu.unpermute_rows(r, jplan), jnp.asarray(rows))
    (want,) = vjp(jnp.asarray(cot))
    x = torch.from_numpy(rows).requires_grad_()
    eu.unpermute_rows(x, plan).backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(x.grad.numpy(), cot[plan.order.numpy()])


@pytest.mark.parametrize("d", [1, 8, 32, 160])
def test_packed_math_matches_jax(d):
    v = 256  # a multiple of 128/d, so the JAX versions take the packed view
    ids = _ids(v, 900, seed=6, skew=0.2)
    table = _normal((v, d), seed=7)
    grads = _normal((900, d), seed=8)
    np.testing.assert_array_equal(
        eu.packed_take(torch.from_numpy(table), torch.from_numpy(ids)).numpy(),
        np.asarray(jeu.packed_take(jnp.asarray(table), jnp.asarray(ids))),
    )
    np.testing.assert_allclose(
        eu.packed_scatter_add(v, torch.from_numpy(ids), torch.from_numpy(grads)).numpy(),
        np.asarray(jeu.packed_scatter_add(v, jnp.asarray(ids), jnp.asarray(grads))), **GRAD_TOL,
    )
    np.testing.assert_array_equal(
        eu.packed_count_rows(v, torch.from_numpy(ids)).numpy(),
        np.asarray(jeu.packed_count_rows(v, jnp.asarray(ids))),
    )
