"""The PyTorch port's kernel modules against the JAX package on the CPU.

Each plain version (``*_plain`` in ``tpurec_torch.ops.kernels``) is held
against the JAX ``*_reference`` and against the Pallas kernel run in
interpret mode, on the same numpy inputs made from a seed, in fp32 at
atol/rtol 1e-5 (the two frameworks sum in different orders; the values are
O(1)). The CUDA kernels themselves are checked on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurec.ops.pallas import kernels as jk
from tpurec_torch.ops import kernels as tk
from tpurec_torch.ops.interactions import fm_second_order

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _din_inputs(seed, b=16, l=16, d=8, h=36, with_alpha=True):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, l + 1, size=(b,))  # ragged, incl. an empty row
    lengths[0] = 0
    mask = (np.arange(l)[None, :] < lengths[:, None]).astype(np.float32)
    args = [
        rng.normal(size=(b, d)).astype(np.float32),
        rng.normal(size=(b, l, d)).astype(np.float32),
        mask,
        (0.3 * rng.normal(size=(4 * d, h))).astype(np.float32),
        (0.1 * rng.normal(size=(h,))).astype(np.float32),
        (0.3 * rng.normal(size=(h,))).astype(np.float32),
        rng.uniform(0.0, 0.5, size=(h,)).astype(np.float32) if with_alpha else None,
    ]
    return args


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


def _torch(args):
    return [None if a is None else torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("with_alpha", [True, False], ids=["prelu", "relu"])
def test_din_attention_plain_matches_reference_and_interpret(with_alpha):
    args = _din_inputs(0, with_alpha=with_alpha)
    pooled, scores = tk.din_attention_plain(*_torch(args))
    ref_p, ref_s = jk.din_attention_reference(*_jax(args))
    np.testing.assert_allclose(pooled.numpy(), np.asarray(ref_p), **TOL)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_s), **TOL)
    # the Pallas kernel computes its dots at the TPU's default precision; in
    # interpret mode on the CPU they run in fp32
    ker_p, ker_s = jk.din_attention_fused(*_jax(args), interpret=True)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(ker_p), **TOL)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ker_s), **TOL)
    # the masked steps score exactly 0; the empty row pools to 0
    assert np.all(scores.numpy()[args[2] == 0] == 0.0)
    assert np.all(pooled.numpy()[0] == 0.0)


def test_din_attention_wrapper_takes_plain_on_cpu():
    args = _torch(_din_inputs(1, b=5, l=7, d=16, h=9))
    before = tk.din_attention_fused.launches
    got = tk.din_attention_fused(*args)
    want = tk.din_attention_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tk.din_attention_fused.launches == before  # no kernel launch on the CPU


@pytest.mark.parametrize("shape", [(16, 5, 8), (16, 26, 8), (3, 26, 32)])
def test_fm_second_order_plain_matches_reference_and_interpret(shape):
    emb = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    got = tk.fm_second_order_plain(torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(got, np.asarray(jk.fm_second_order_reference(jnp.asarray(emb))), **TOL)
    ker = jk.fm_second_order_fused(jnp.asarray(emb), interpret=True)
    np.testing.assert_allclose(got, np.asarray(ker), **TOL)
    before = tk.fm_second_order_fused.launches
    assert torch.equal(tk.fm_second_order_fused(torch.from_numpy(emb)), torch.from_numpy(got))
    assert tk.fm_second_order_fused.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(16, 6, 8), (4, 26, 32)])
def test_fm_second_order_op_matches_jax(dtype, shape):
    """``ops.interactions.fm_second_order`` computes in fp32 and casts back
    to the embedding dtype, as the JAX op does through its kernel (off the
    TPU the JAX op computes bf16 inputs in bf16, so the comparison is with
    the JAX kernel's numbers). bf16 results agree to one bf16 rounding
    (2^-7 relative)."""
    emb = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    jt = jnp.asarray(emb).astype(dtype)
    tt = torch.from_numpy(emb).to(getattr(torch, dtype))
    got = fm_second_order(tt)
    want = jk.fm_second_order_fused(jt.astype(jnp.float32), interpret=True).astype(dtype)
    assert got.dtype == tt.dtype and got.shape == (shape[0],)
    tol = TOL if dtype == "float32" else dict(atol=1e-2, rtol=2.0**-7)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol
    )


# --------------------------------------------------------------------------
# DIN attention backward
def _cotangents(seed, b, l, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, d)).astype(np.float32), rng.normal(size=(b, l)).astype(np.float32)]


@pytest.mark.parametrize("with_alpha", [True, False], ids=["prelu", "relu"])
def test_din_attention_bwd_plain_matches_interpret_and_grad(with_alpha):
    """``din_attention_bwd_plain`` against the Pallas backward in interpret
    mode and against ``jax.grad`` of the reference, with both cotangents
    non-zero and B=70 (three 32-row tiles, the last padded), at
    ``tests/test_pallas.py``'s rtol 2e-3 / atol 2e-5."""
    import jax

    b, l, d, h = 70, 16, 8, 36
    args = _din_inputs(6, b=b, l=l, d=d, h=h, with_alpha=with_alpha)
    alpha = args[6] if with_alpha else np.zeros(h, np.float32)
    gp, gs = _cotangents(7, b, l, d)
    full = args[:6] + [alpha, gp, gs]
    got = tk.din_attention_bwd_plain(*_torch(full))
    tol = dict(rtol=2e-3, atol=2e-5)
    ker = jk.din_attention_bwd_fused(*_jax(full), interpret=True)
    for name, g, w in zip(("dq", "dk", "dw1", "db1", "dw2", "dalpha"), got, ker):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **tol)

    q, k, m, w1, b1, w2 = _jax(args[:6])

    def objective(q, k, w1, b1, w2, a):
        p, s = jk.din_attention_reference(q, k, m, w1, b1, w2, a if with_alpha else None)
        return jnp.sum(p * gp) + jnp.sum(s * gs)

    want = jax.grad(objective, argnums=range(6))(q, k, w1, b1, w2, jnp.asarray(alpha))
    for i, (g, w) in enumerate(zip(got, want)):
        if i < 5 or with_alpha:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def test_din_attention_autograd_gradcheck():
    """``DinAttention`` (plain forward, hand-written plain backward on the
    CPU) against finite differences in float64; the relu form gives alpha
    no gradient, the mask never gets one."""
    rng = np.random.default_rng(8)
    b, l, d, h = 3, 5, 4, 6
    mask = torch.from_numpy((rng.random((b, l)) < 0.7).astype(np.float64))
    tensors = [
        torch.from_numpy(rng.normal(size=s)).requires_grad_()
        for s in ((b, d), (b, l, d), (4 * d, h), (h,), (h,), (h,))
    ]
    q, k, w1, b1, w2, alpha = tensors
    alpha.data.uniform_(0.1, 0.5)

    def fn(q, k, w1, b1, w2, alpha):
        return tk.DinAttention.apply(q, k, mask, w1, b1, w2, alpha)

    assert torch.autograd.gradcheck(fn, tuple(tensors), eps=1e-6, atol=1e-6)
    assert torch.autograd.gradcheck(
        lambda q, k, w1, b1, w2: tk.DinAttention.apply(q, k, mask, w1, b1, w2, None),
        (q, k, w1, b1, w2), eps=1e-6, atol=1e-6,
    )
    m = mask.clone().requires_grad_()
    pooled, scores = tk.DinAttention.apply(q, k, m, w1, b1, w2, None)
    (pooled.sum() + scores.sum()).backward()
    assert m.grad is None


def test_wrappers_refuse_grad_off_the_cpu():
    """On any tensor that is not on the CPU the bare wrappers raise under
    grad mode when an input requires grad (here on the ``meta`` device, so
    the check runs without a card); without grad they reach the device
    check, which refuses a device that is neither CPU nor CUDA."""
    args = [None if a is None else torch.from_numpy(a).to("meta") for a in _din_inputs(9, b=2, l=3)]
    w1 = args[3].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad"):
        tk.din_attention_fused(*args[:3], w1, *args[4:])
    emb = torch.empty(2, 3, 8, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        tk.fm_second_order_fused(emb)
    with pytest.raises(RuntimeError, match="requires grad"):
        tk.din_attention_bwd_fused(*args[:3], w1, *args[4:], args[0], args[2])
    with torch.no_grad(), pytest.raises(ValueError, match="neither CPU nor CUDA"):
        tk.din_attention_fused(*args[:3], w1, *args[4:])


def test_bwd_wrapper_takes_plain_on_cpu():
    args = _torch(_din_inputs(10, b=5, l=7, d=16, h=9))
    gp, gs = _torch(_cotangents(11, 5, 7, 16))
    before = tk.din_attention_bwd_fused.launches
    got = tk.din_attention_bwd_fused(*args, gp, gs)
    want = tk.din_attention_bwd_plain(*args, gp, gs)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tk.din_attention_bwd_fused.launches == before
    tk.reset_launch_counts()
    assert tk.din_attention_bwd_fused.launches == tk.din_attention_fused.launches == 0


def _holey_inputs(seed, b, l, d, h):
    """``_din_inputs`` with a mask with holes (not a prefix), an all-zero row
    and a row whose only live step is the last."""
    args = _din_inputs(seed, b=b, l=l, d=d, h=h)
    rng = np.random.default_rng(seed + 100)
    mask = (rng.random((b, l)) < 0.6).astype(np.float32)
    mask[0] = 0.0
    mask[1] = 0.0
    mask[1, -1] = 1.0
    args[2] = mask
    return args + _cotangents(seed + 1, b, l, d)


def _bwd_readings(got, want):
    """Each output's error in units of its limit (at most 1 passes): dq and
    dkeys elementwise at atol = rtol = 1e-4 (``KERNEL_TOL`` of the card
    checks), the parameter gradients at 1e-4 of their largest value
    (``DIN_BWD_PARAM_RTOL``)."""
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        err = (g - w).abs()
        if i < 2:
            out.append(float((err / (1e-4 + 1e-4 * w.abs())).max()))
        else:
            out.append(float(err.max()) / (1e-4 * max(float(w.abs().max()), 1e-30)))
    return out


@pytest.mark.parametrize("products", ["fp32", "3xtf32", "1xtf32"])
def test_din_attention_unfolded_products_emulation(products):
    """The forward CUDA kernel's arithmetic: lin as one product over the
    shared weight ``[w_k; w_p]`` in fp32, in 3xTF32 (what the kernel's tensor
    cores compute) and in single TF32, against ``din_attention_plain`` and
    tpurec's Pallas kernel in interpret mode, with a mask with holes, an
    all-zero row and a row whose only live step is the last, at the size of
    ``test_din_attention_plain_matches_reference_and_interpret`` (at 1e-5,
    wider rows' pooled sums already differ by their order in fp32). fp32 and
    3xTF32 hold ``TOL``; single TF32 must miss it (by ~100x here), so the
    card's check of that version can fail."""
    args = _holey_inputs(14, 16, 16, 8, 36)[:7]
    got = [g.numpy() for g in tk.din_attention_unfolded(*_torch(args), products=products)]
    plain = [w.numpy() for w in tk.din_attention_plain(*_torch(args))]
    pallas = [np.asarray(w) for w in jk.din_attention_fused(*_jax(args), interpret=True)]
    for want in (plain, pallas):
        close = [np.allclose(g, w, **TOL) for g, w in zip(got, want)]
        assert close == ([False, False] if products == "1xtf32" else [True, True]), close
    # masked steps score exactly 0; the all-zero row pools to 0
    assert np.all(got[1][args[2] == 0] == 0.0)
    assert np.all(got[0][0] == 0.0)


@pytest.mark.parametrize("products", ["fp32", "3xtf32", "1xtf32"])
def test_din_bwd_unfolded_products_emulation(products):
    """The CUDA kernel's arithmetic: the backward unfolded over the shared
    weight ``[w_k; w_p]``, its three products in fp32, in 3xTF32 (what the
    kernel's tensor cores compute) and in single TF32, against
    ``din_attention_bwd_plain`` at B=512, L=48, D=32, H=36. fp32 and 3xTF32
    hold the card's limits; single TF32 must miss them (PReLU's slope flips
    where lin is near 0), so the check can fail. fp32 is also held to the
    Pallas backward in interpret mode at a small size, at the tolerance of
    ``test_din_attention_bwd_plain_matches_interpret_and_grad``."""
    args = _torch(_holey_inputs(12, 512, 48, 32, 36))
    got = tk.din_attention_bwd_unfolded(*args, products=products)
    readings = _bwd_readings(got, tk.din_attention_bwd_plain(*args))
    if products == "1xtf32":
        assert max(readings) > 10.0, readings
    else:
        assert max(readings) <= 1.0, readings
        # the steps past a row's last live step, and a dead row, are exact 0
        mask = args[2]
        assert torch.all(got[1][mask == 0] == 0.0)
    if products == "fp32":
        small = _holey_inputs(13, 70, 16, 8, 36)
        got = tk.din_attention_bwd_unfolded(*_torch(small), products="fp32")
        ker = jk.din_attention_bwd_fused(*_jax(small), interpret=True)
        for name, g, w in zip(("dq", "dk", "dw1", "db1", "dw2", "dalpha"), got, ker):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, rtol=2e-3, atol=2e-5)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-11, -(1.0 + 2.0**-11), 3.0e-3])
    r = tk.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2.0**-10  # ties away from zero
    assert r[2] == 1.0 + 2.0**-9 and r[3] == -(1.0 + 2.0**-10)
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)
