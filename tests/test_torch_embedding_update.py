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
def _emulate_fused_scatter_add(sids, grads, v, slice_rows, warps=8, carry=True):
    """``csrc/embedding_update.cu``'s algorithm step for step in fp32: pass 1
    sums runs inside slices of ``slice_rows`` and leaves head/tail partials of
    runs that cross slices (unwritten partials are NaN, so reading one shows);
    pass 2 adds each crossing run's partials in ``warps`` contiguous stripes,
    then the stripes in warp order. ``carry=False`` skips pass 2."""
    n, d = grads.shape
    g_out = np.zeros((v, d), np.float32)
    slices = -(-n // slice_rows)
    head = np.full((slices, d), np.nan, np.float32)
    tail = np.full((slices, d), np.nan, np.float32)
    for s in range(slices):
        s0, s1 = s * slice_rows, min((s + 1) * slice_rows, n)
        head_carried = s0 > 0 and sids[s0 - 1] == sids[s0]
        tail_open = s1 < n and sids[s1] == sids[s1 - 1]

        def emit(i, acc, start, end):
            if start == s0 and head_carried:
                head[s] = acc
            elif end == s1 and tail_open:
                tail[s] = acc
            else:
                g_out[i] = acc

        cur, start, acc = sids[s0], s0, np.zeros(d, np.float32)
        for r in range(s0, s1):
            if sids[r] != cur:
                emit(cur, acc, start, r)
                cur, start, acc = sids[r], r, np.zeros(d, np.float32)
            acc = acc + grads[r]
        emit(cur, acc, start, s1)
    for s in range(slices if carry else 0):
        s0, s1 = s * slice_rows, min((s + 1) * slice_rows, n)
        i = sids[s1 - 1]
        if not (s1 < n and sids[s1] == i and not (s0 > 0 and sids[s0 - 1] == i)):
            continue
        end = int(np.searchsorted(sids, i, side="right"))
        e = (end - 1) // slice_rows
        per = -(-(e - s) // warps)
        stripes = []
        for w in range(warps):
            acc = np.zeros(d, np.float32)
            for j in range(s + 1 + w * per, min(s + 1 + (w + 1) * per, e + 1)):
                acc = acc + head[j]
            stripes.append(acc)
        total = tail[s]
        for st in stripes:
            total = total + st
        g_out[i] = total
    return g_out


def _sum_reading(got, sids, grads, v):
    """max over rows of |got − plain| / (SUM_ATOL + SUM_RTOL · Σ|g| of the row)."""
    want = eu.scatter_add_plain(v, torch.from_numpy(sids), torch.from_numpy(grads)).numpy()
    scale = eu.scatter_add_plain(v, torch.from_numpy(sids), torch.from_numpy(np.abs(grads))).numpy()
    return float((np.abs(got - want) / (SUM_ATOL + SUM_RTOL * scale)).max())


@pytest.mark.parametrize(
    "v,d,n,skew,slice_rows",
    [
        (300, 8, 1003, 0.0, 4),  # ragged: runs cross many slice boundaries
        (300, 33, 1003, 0.0, 128),  # D not a multiple of 32
        (40, 1, 517, 0.36, 8),  # a long id-0 run over ~23 slices, as DIN's padding
        (5, 3, 2000, 0.0, 16),  # every run crosses slices
        (20, 4, 300, 1.0, 16),  # every id equal: one run crosses every slice
        (20, 4, 1, 0.0, 128),
    ],
)
def test_emulated_scatter_design_matches_plain(v, d, n, skew, slice_rows):
    ids = _ids(v, n, seed=3, skew=skew)
    sids = np.sort(ids).astype(np.int32)
    grads = _normal((n, d), seed=4)
    got = _emulate_fused_scatter_add(sids, grads, v, slice_rows)
    assert not np.isnan(got).any()
    assert _sum_reading(got, sids, grads, v) <= 1.0
    # the check has teeth: without pass 2 the carried parts are lost
    if n > slice_rows and (sids[slice_rows:] == sids[slice_rows - 1]).any():
        broken = _emulate_fused_scatter_add(sids, grads, v, slice_rows, carry=False)
        assert _sum_reading(broken, sids, grads, v) > 1.0


def test_emulated_scatter_in_one_slice_is_the_plain_sum_bit_for_bit():
    """A run inside one slice is summed row by row in stream order, as
    ``index_add_`` sums it on the CPU."""
    ids = _ids(50, 128, seed=5)
    sids = np.sort(ids).astype(np.int32)
    grads = _normal((128, 8), seed=6)
    got = _emulate_fused_scatter_add(sids, grads, 50, slice_rows=128)
    want = eu.scatter_add_plain(50, torch.from_numpy(sids), torch.from_numpy(grads)).numpy()
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
