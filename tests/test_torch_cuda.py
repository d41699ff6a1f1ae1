"""The port's CUDA kernels against their plain versions, on the card. Every
test here is marked ``cuda`` and skips where there is no GPU. The file
imports no JAX, so on a machine without it run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: fp32 on both sides with TF32 off; the kernels sum in another
order than the plain versions, so values of O(1)-O(10) agree to ~1e-5
relative: atol/rtol 1e-4. The aggregated embedding gradient (kernel #9) is
held row by row to 2^-20 (16 fp32 ulps) of the sum of its rows' magnitudes
plus 1e-7: a run of ~10^5 rows sums to 10^2-10^3 in either order. The FM
cross term (kernel #1) over every width is held to 1e-5 of the terms it
sums (``_fm_limit``). Gathered rows (kernel #10) are copies: exact.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _din_args(card, b, l, d, h, with_alpha, seed=0, holes=False):
    """DIN attention inputs. The mask is a prefix of random length, or with
    ``holes`` random steps with an all-zero first row and a second row whose
    only live step is the last."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, l + 1, size=(b,))
    mask = (np.arange(l)[None, :] < lengths[:, None]).astype(np.float32)
    if holes:
        mask = (rng.random((b, l)) < 0.5).astype(np.float32)
        mask[0] = 0.0
        if b > 1:
            mask[1] = 0.0
            mask[1, -1] = 1.0
    arrays = [
        rng.normal(size=(b, d)),
        rng.normal(size=(b, l, d)),
        mask,
        0.3 * rng.normal(size=(4 * d, h)),
        0.1 * rng.normal(size=(h,)),
        0.3 * rng.normal(size=(h,)),
        rng.uniform(0.0, 0.5, size=(h,)) if with_alpha else None,
    ]
    return [
        None if a is None else torch.as_tensor(a, dtype=torch.float32, device=card)
        for a in arrays
    ]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,l,d,h,with_alpha,holes",
    [(256, 64, 32, 36, True, False), (256, 64, 32, 36, False, False), (37, 200, 16, 7, True, False),
     (9, 5, 8, 80, True, False), (64, 33, 64, 36, True, False),
     # the tensor-core kernel's edges: masks with holes, an all-zero row, a
     # row live only at its last step; L = 1 and around the 16-step tile;
     # every D; H = 128, its widest build, and H = 129 and 200, which run the
     # fp32 kernel; L = 8192, more than the fp32 kernel's shared memory holds
     (300, 64, 32, 36, True, True), (130, 1, 32, 36, True, False), (130, 1, 8, 7, False, True),
     (130, 15, 8, 7, True, True), (130, 16, 16, 36, False, True), (130, 17, 32, 1, True, True),
     (77, 200, 64, 80, True, True), (40, 33, 64, 128, True, True), (40, 33, 32, 129, True, True),
     (40, 64, 16, 200, False, True), (2, 8192, 8, 5, True, False)],
)
def test_din_attention_kernel_matches_plain(card, b, l, d, h, with_alpha, holes):
    from tpurec_torch.ops import kernels

    args = _din_args(card, b, l, d, h, with_alpha, holes=holes)
    assert kernels._library("din_attention").din_attention_route(d, h) == (h <= kernels.DIN_TC_MAX_H)
    before = kernels.din_attention_fused.launches
    pooled, scores = kernels.din_attention_fused(*args)
    again = kernels.din_attention_fused(*args)
    torch.cuda.synchronize()
    assert kernels.din_attention_fused.launches == before + 2
    ref_p, ref_s = kernels.din_attention_plain(*args)
    torch.testing.assert_close(pooled, ref_p, **TOL)
    torch.testing.assert_close(scores, ref_s, **TOL)
    # each row is summed by one warp in a fixed order: the same bits each call
    assert torch.equal(pooled, again[0]) and torch.equal(scores, again[1])


@pytest.mark.cuda
def test_din_attention_kernel_rejects_what_it_does_not_take(card):
    from tpurec_torch.ops import kernels

    args = _din_args(card, 4, 8, 12, 5, True)  # D=12 is not built
    with pytest.raises(ValueError):
        kernels.din_attention_fused(*args)
    # H past the tensor-core kernel runs the fp32 kernel, whose block holds a
    # row's keys: refused where they do not fit
    args = _din_args(card, 2, 8192, 64, 200, True)
    with pytest.raises(ValueError, match="shared"):
        kernels.din_attention_fused(*args)
    args = _din_args(card, 4, 8, 8, 5, True)
    with pytest.raises(TypeError):
        kernels.din_attention_fused(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        kernels.din_attention_fused(args[0].cpu(), *args[1:])
    # a contiguous view one float into its storage: the float4 key loads
    # would fault, so the wrapper refuses it
    keys = args[1]
    shifted = torch.empty(keys.numel() + 1, device=card)[1:].view(keys.shape)
    shifted.copy_(keys)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        kernels.din_attention_fused(args[0], shifted, *args[2:])
    pooled, _ = kernels.din_attention_fused(args[0], shifted.clone(), *args[2:])
    torch.testing.assert_close(pooled, kernels.din_attention_plain(*args)[0], **TOL)


@pytest.mark.cuda
def test_din_attention_bwd_kernel_rejects_what_it_does_not_take(card):
    from tpurec_torch.ops import kernels

    def cotangents(b, l, d):
        return [torch.randn(b, d, device=card), torch.randn(b, l, device=card)]

    args = _din_args(card, 4, 8, 12, 5, True)  # D=12 is not built
    with pytest.raises(ValueError, match="key width"):
        kernels.din_attention_bwd_fused(*args, *cotangents(4, 8, 12))
    args = _din_args(card, 4, 8, 8, 5, True)
    grads = cotangents(4, 8, 8)
    with pytest.raises(TypeError):
        kernels.din_attention_bwd_fused(*args, grads[0].double(), grads[1])
    with pytest.raises(ValueError, match="shapes"):
        kernels.din_attention_bwd_fused(*args, grads[0], grads[1][:, :4])
    with pytest.raises(ValueError, match="hidden width"):
        kernels.din_attention_bwd_fused(*_din_args(card, 2, 8, 8, 129, True), *cotangents(2, 8, 8))
    with pytest.raises(ValueError, match="shared"):  # W alone outgrows a block
        kernels.din_attention_bwd_fused(
            *_din_args(card, 2, 8, 64, 128, True), *cotangents(2, 8, 64)
        )
    shifted = torch.empty(args[1].numel() + 1, device=card)[1:].view(args[1].shape)
    shifted.copy_(args[1])
    with pytest.raises(ValueError, match="16-byte"):
        kernels.din_attention_bwd_fused(args[0], shifted, *args[2:], *grads)


def _assert_close_scaled(got, want, rtol=1e-4, what=""):
    """|got - want| within rtol of the largest |want| (at least 1): the
    parameter gradients are sums over B·L terms taken in another order."""
    got, want = got.detach(), want.detach()
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= rtol * scale, f"{what}: max abs err {err} at scale {scale}"


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,l,d,h,with_alpha,holes",
    [(1024, 64, 32, 36, True, False), (1024, 64, 32, 36, False, False),
     (1003, 64, 32, 36, True, False), (37, 200, 16, 7, True, False), (9, 1, 8, 80, True, False),
     (64, 33, 64, 36, False, False), (3, 5, 8, 1, True, False),
     # the tiled design's edges: masks with holes, a row live only at its
     # last step, all-zero rows; L around the 16-step tile; H = 1, 7, 36, 80;
     # every D; L=4096 (the old kernel's shared-memory refusal)
     (300, 64, 32, 36, True, True), (130, 15, 8, 7, True, True), (130, 16, 16, 36, True, True),
     (130, 17, 32, 1, True, True), (77, 200, 64, 80, True, True), (40, 17, 64, 7, False, True),
     (2, 4096, 8, 5, True, False)],
)
def test_din_attention_bwd_kernel_matches_plain(card, b, l, d, h, with_alpha, holes):
    from tpurec_torch.ops import kernels

    args = _din_args(card, b, l, d, h, True, holes=holes)
    if not with_alpha:
        args[-1] = torch.zeros_like(args[-1])
    gen = torch.Generator(card).manual_seed(3)
    grads = [torch.randn(b, d, device=card, generator=gen), torch.randn(b, l, device=card, generator=gen)]
    before = kernels.din_attention_bwd_fused.launches
    got = kernels.din_attention_bwd_fused(*args, *grads)
    again = kernels.din_attention_bwd_fused(*args, *grads)
    torch.cuda.synchronize()
    assert kernels.din_attention_bwd_fused.launches == before + 2
    want = kernels.din_attention_bwd_plain(*args, *grads)
    names = ("dq", "dkeys", "dw1", "db1", "dw2", "dalpha")
    for name, g, w in zip(names[:2], got[:2], want[:2]):
        torch.testing.assert_close(g, w, **TOL, msg=name)
    for name, g, w in zip(names[2:], got[2:], want[2:]):
        _assert_close_scaled(g, w, what=name)
    # partials are added in a fixed order: the same bits on every run
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64])
def test_din_attention_bwd_kernel_takes_the_kinks_side(card, d):
    """Where lin = (the activation unit's pre-activation) lies a hair from
    PReLU's kink, the slope's side decides a whole g·w2·(1 − alpha) of dkeys
    and dq. Each of the 36 columns gets one live step at ±1e-6 from the
    kink (b1 shifted so); the kernel's gradients must equal the plain
    version's in fp64 there (fp32's rounding of lin is ~1e-7)."""
    _kinks_side(card, d, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64])
def test_din_attention_bwd_kernel_takes_the_kinks_side_within_fp32_rounding(card, d):
    """As above at ±1e-9 from the kink (b1's fp32 rounding then leaves each
    lin within ~1e-8 of it): below the rounding of the fp32 folds of w1
    (w1_a + w1_b, w1_c − w1_b), so the kernel's fp64 evaluation must take w1
    itself to take the plain version's side."""
    _kinks_side(card, d, 1e-9)


def _kinks_side(card, d, margin):
    from tpurec_torch.ops import kernels

    b, l, h = 512, 64, 36
    args = _din_args(card, b, l, d, h, True, seed=7)
    q, k, m, w1, b1 = [t.double() for t in args[:5]]
    lin = k @ (w1[2 * d:3 * d] - w1[d:2 * d]) + (q[:, None] * k) @ w1[3 * d:] \
        + (q @ (w1[:d] + w1[d:2 * d]))[:, None] + b1
    live = m.nonzero().cpu().numpy()
    rng = np.random.default_rng(8)
    for col, (r, s) in enumerate(live[rng.choice(len(live), size=h, replace=False)]):
        b1[col] -= lin[r, s, col] - (margin if col % 2 else -margin)
    args[4] = b1.float()
    gen = torch.Generator(card).manual_seed(9)
    grads = [torch.randn(b, d, device=card, generator=gen), torch.randn(b, l, device=card, generator=gen)]
    got = kernels.din_attention_bwd_fused(*args, *grads)
    want = [w.float() for w in kernels.din_attention_bwd_plain(
        *[t.double() for t in args], *[g.double() for g in grads])]
    names = ("dq", "dkeys", "dw1", "db1", "dw2", "dalpha")
    for name, g, w in zip(names[:2], got[:2], want[:2]):
        torch.testing.assert_close(g, w, **TOL, msg=name)
    for name, g, w in zip(names[2:], got[2:], want[2:]):
        _assert_close_scaled(g, w, what=name)


@pytest.mark.cuda
def test_din_attention_autograd_on_card_matches_cpu(card):
    """``DinAttention`` on the card (both kernels) against the same inputs on
    the CPU (the plain versions)."""
    from tpurec_torch.ops import kernels

    args = _din_args(card, 300, 64, 32, 36, True)
    gen = torch.Generator(card).manual_seed(4)
    gp, gs = torch.randn(300, 32, device=card, generator=gen), torch.randn(300, 64, device=card, generator=gen)

    def grads(tensors, gp, gs):
        leaves = [t.clone().requires_grad_(i != 2) for i, t in enumerate(tensors)]
        pooled, scores = kernels.DinAttention.apply(*leaves)
        torch.autograd.backward([pooled, scores], [gp, gs])
        return [pooled, scores] + [t.grad for i, t in enumerate(leaves) if i != 2]

    before = (kernels.din_attention_fused.launches, kernels.din_attention_bwd_fused.launches)
    on_card = grads(args, gp, gs)
    torch.cuda.synchronize()
    assert (kernels.din_attention_fused.launches, kernels.din_attention_bwd_fused.launches) == (
        before[0] + 1, before[1] + 1
    )
    on_cpu = grads([t.cpu() for t in args], gp.cpu(), gs.cpu())
    for i, (g, w) in enumerate(zip(on_card, on_cpu)):
        _assert_close_scaled(g.cpu(), w, what=f"output {i}")


@pytest.mark.cuda
def test_kernel_wrappers_refuse_grad(card):
    """The bare wrappers record no backward: under grad mode they raise on an
    input that requires grad, and run under ``torch.no_grad()``."""
    from tpurec_torch.ops import kernels

    args = _din_args(card, 4, 8, 8, 5, True)
    w1 = args[3].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad"):
        kernels.din_attention_fused(*args[:3], w1, *args[4:])
    emb = torch.randn(4, 3, 8, device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        kernels.fm_second_order_fused(emb)
    with torch.no_grad():
        kernels.din_attention_fused(*args[:3], w1, *args[4:])
        kernels.fm_second_order_fused(emb)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8192, 26, 32), (32, 26, 32), (7, 5, 3), (100, 1, 128)])
def test_fm_kernel_matches_plain(card, shape):
    from tpurec_torch.ops import kernels

    emb = torch.randn(*shape, device=card, generator=torch.Generator(card).manual_seed(0))
    before = kernels.fm_second_order_fused.launches
    got = kernels.fm_second_order_fused(emb)
    torch.cuda.synchronize()
    assert kernels.fm_second_order_fused.launches == before + 1
    torch.testing.assert_close(got, kernels.fm_second_order_plain(emb), **TOL)


def _fm_limit(emb):
    """1e-5 of each row's 0.5·Σ_d[(Σ_f e)² + Σ_f e²], plus 1e-6. The kernel
    and the plain version sum those terms in fp32 in other orders and the
    result cancels them ((Σ_f e)² − Σ_f e²), so its error scales with the
    terms and not with the result: at most 4.3e-7 of them over F ≤ 39,
    D ≤ 256 in a CPU emulation, where ``TOL`` itself reads up to 1.2 (F=26,
    D=128) on rows whose result is near 0."""
    e = emb.double()
    return 1e-5 * 0.5 * (e.sum(dim=1).square() + e.square().sum(dim=1)).sum(dim=-1) + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 2, 26, 39])
@pytest.mark.parametrize("d", [1, 3, 8, 16, 32, 33, 64, 128, 256])
def test_fm_kernel_every_width(card, f, d):
    """Every F and D at B = 1, 8, 32, 256 (the server's smallest, rank-20
    and rank-200 buckets), 1003 and 8192: rows read unpadded, in 16-byte
    loads where D % 4 == 0 and 4-byte ones else, lanes folded by a
    butterfly where D/4 (or D) divides 32 and in order else, wider rows in
    passes of 32 units. One launch a call; two calls the same bits."""
    from tpurec_torch.ops import kernels

    gen = torch.Generator(card).manual_seed(1000 * f + d)
    for b in (1, 8, 32, 256, 1003, 8192):
        emb = torch.randn(b, f, d, device=card, generator=gen)
        before = kernels.fm_second_order_fused.launches
        got = kernels.fm_second_order_fused(emb)
        torch.cuda.synchronize()
        assert kernels.fm_second_order_fused.launches == before + 1
        err = (got - kernels.fm_second_order_plain(emb)).abs().double()
        assert bool((err <= _fm_limit(emb)).all()), (b, float(err.max()))
        assert torch.equal(got, kernels.fm_second_order_fused(emb))


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,d", [(1003, 26, 32), (8, 26, 32), (37, 2, 256), (5, 39, 4), (64, 3, 8)])
def test_fm_kernel_takes_an_unaligned_input(card, b, f, d):
    """An input that starts 4 bytes past a 16-byte boundary (a view one
    float into its buffer, contiguous, so the wrapper passes it as it is)
    takes the 4-byte loads: right, and the same bits on two calls."""
    from tpurec_torch.ops import kernels

    buf = torch.randn(b * f * d + 1, device=card, generator=torch.Generator(card).manual_seed(b))
    emb = buf[1:].view(b, f, d)
    assert emb.data_ptr() % 16 == 4 and emb.is_contiguous()
    got = kernels.fm_second_order_fused(emb)
    torch.cuda.synchronize()
    err = (got - kernels.fm_second_order_plain(emb)).abs().double()
    assert bool((err <= _fm_limit(emb)).all()), float(err.max())
    assert torch.equal(got, kernels.fm_second_order_fused(emb))


@pytest.mark.cuda
def test_fm_kernel_refuses_what_it_does_not_take(card):
    from tpurec_torch.ops import kernels

    emb = torch.randn(4, 3, 8, device=card)
    with pytest.raises(TypeError, match="must be float32"):
        kernels.fm_second_order_fused(emb.double())
    with pytest.raises(ValueError, match=r"expected \(B, F, D\)"):
        kernels.fm_second_order_fused(emb[0])
    with pytest.raises(ValueError, match="pad to 64x512, above the 16384-element tile"):
        kernels.fm_second_order_fused(torch.randn(2, 33, 257, device=card))
    before = kernels.fm_second_order_fused.launches
    assert kernels.fm_second_order_fused(emb[:0]).shape == (0,)
    assert kernels.fm_second_order_fused.launches == before  # B = 0: no launch


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["din", "deepfm"])
def test_model_on_card_matches_cpu(card, name):
    """A whole model through its kernel on the card against the same weights
    on the CPU (fp32 compute)."""
    from tpurec_torch.config import EmbeddingConfig, ModelConfig
    from tpurec_torch.data.schema import DataInfo
    from tpurec_torch.models import build_model

    rng = np.random.default_rng(1)
    if name == "din":
        info, batch = _small_din(rng)
    else:
        info = DataInfo.from_dims([f"f{i}" for i in range(8)], [50] * 8)
        batch = {f"f{i}": rng.integers(50 * i, 50 * i + 50, size=(64,)) for i in range(8)}
    config = ModelConfig(name=name, embedding=EmbeddingConfig(dim=32 if name == "din" else 8))
    on_card = build_model(config, info, device=card).eval()
    on_cpu = build_model(config, info, device="cpu").eval()
    on_cpu.load_state_dict({k: v.cpu() for k, v in on_card.state_dict().items()})
    with torch.inference_mode():
        got = on_card({k: torch.as_tensor(v, device=card) for k, v in batch.items()})["output"]
        want = on_cpu({k: torch.as_tensor(v) for k, v in batch.items()})["output"]
    torch.testing.assert_close(got.cpu(), want, **TOL)


def _small_din(rng):
    """A small DIN schema (D=32 from the config, L=16) and a 64-row batch."""
    from tpurec_torch.data.schema import DataInfo

    info = DataInfo.from_dims(
        ["user_tag", "item_id", "item_tag"], [10, 200, 5], sequence_names=["history"],
        max_seq_length=16, user_features=["user_tag"], item_features=["item_id", "item_tag"],
    )
    batch = {
        n: rng.integers(o, o + d, size=(64,))
        for n, o, d in zip(info.feature_names, info.feature_offsets, info.feature_dims)
    }
    batch["history"] = np.where(
        rng.random((64, 16)) < 0.7, rng.integers(1, 215, size=(64, 16)), 0
    )
    return info, batch


@pytest.mark.cuda
def test_train_step_on_card_matches_plain_attention(card):
    """One fp32 ``Trainer.train_step`` of a small DIN on the card, through
    both DIN kernels, against the same step with the plain attention forward
    and backward: the loss (1e-5), every gradient (1e-3 of its largest
    value: sums over the batch in another order) and every parameter after
    Adam (1e-5; its first step moves a weight by about lr = 1e-3)."""
    from unittest import mock

    from tpurec_torch.config import ExperimentConfig
    from tpurec_torch.ops import kernels
    from tpurec_torch.train.trainer import Trainer

    rng = np.random.default_rng(2)
    info, batch = _small_din(rng)
    batch["label"] = rng.integers(0, 2, size=(64,)).astype(np.float32)
    config = ExperimentConfig.from_dict(dict(
        model=dict(name="din", embedding=dict(dim=32)),
        train=dict(compute_dtype="float32", log_every_steps=0),
    ))
    trainer = Trainer(config, info, device=card)

    def step():
        state = trainer.init_state(batch)
        state, _, logs = trainer.train_step(state, trainer.device_batch(batch), trainer.metrics.init())
        return float(logs["loss"]), {n: (p.grad, p.detach()) for n, p in state.model.named_parameters()}

    before = (kernels.din_attention_fused.launches, kernels.din_attention_bwd_fused.launches)
    loss, got = step()
    assert (kernels.din_attention_fused.launches, kernels.din_attention_bwd_fused.launches) == (
        before[0] + 1, before[1] + 1
    )
    with mock.patch.object(kernels, "din_attention_fused", kernels.din_attention_plain), \
            mock.patch.object(kernels, "din_attention_bwd_fused", kernels.din_attention_bwd_plain):
        want_loss, want = step()
    assert abs(loss - want_loss) <= 1e-5
    for name, (want_grad, want_param) in want.items():
        grad, param = got[name]
        err = float((grad - want_grad).abs().max())
        assert err <= 1e-3 * float(want_grad.abs().max()), f"{name}: grad err {err}"
        torch.testing.assert_close(param, want_param, atol=1e-5, rtol=0, msg=name)


# --------------------------------------------------------------------------
# the sorted-stream embedding kernels (#9, #10)
SUM_RTOL, SUM_ATOL = 2.0**-20, 1e-7


def _sorted_stream(card, n, v, d, skew=0.0, seed=0, outside=0.0):
    """A plan over n ids in [0, v) (a share ``skew`` of them id 0, and a
    share ``outside`` of them -3 or v + 2, outside the table) and fp32
    gradients in id order."""
    from tpurec_torch.ops import embedding_update as eu

    gen = torch.Generator(card).manual_seed(seed)
    ids = torch.randint(0, v, (n,), device=card, generator=gen)
    ids = torch.where(torch.rand(n, device=card, generator=gen) < skew, 0, ids)
    far = torch.where(torch.rand(n, device=card, generator=gen) < 0.5, -3, v + 2)
    ids = torch.where(torch.rand(n, device=card, generator=gen) < outside, far, ids)
    plan = eu.make_scatter_plan(ids, v)
    return plan, torch.randn(n, d, device=card, generator=gen)


def _sum_reading(got, plan, grads):
    from tpurec_torch.ops import embedding_update as eu

    want = eu.scatter_add_plain(plan.num_rows, plan.sids, grads)
    scale = eu.scatter_add_plain(plan.num_rows, plan.sids, grads.abs())
    return float(((got - want).abs() / (SUM_ATOL + SUM_RTOL * scale)).max())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,v,d,skew,outside",
    [(50_000, 400_000, 32, 0.0, 0.0), (50_000, 400_000, 1, 0.0, 0.0),
     (60_000, 2_000, 32, 0.36, 0.0), (1003, 300, 8, 0.0, 0.0), (1003, 300, 64, 0.0, 0.0),
     (1003, 300, 160, 0.0, 0.0), (5000, 300, 4, 1.0, 0.0), (1, 10, 3, 0.0, 0.0),
     (0, 10, 8, 0.0, 0.0),
     # widths whose rows share a warp's lanes unevenly, or spill past 32
     (3000, 500, 2, 0.0, 0.0), (3000, 500, 3, 0.0, 0.0), (3000, 500, 5, 0.0, 0.0),
     (50_000, 400_000, 16, 0.0, 0.0), (3000, 300, 33, 0.0, 0.0),
     # D=1, runs of ~33 rows across slices (2,048 rows) and tiles (16,384)
     (100_000, 3000, 1, 0.0, 0.0),
     # one run through the whole stream
     (100_000, 50, 1, 1.0, 0.0), (100_000, 50, 32, 1.0, 0.0),
     # ids outside [0, V), which are dropped
     (20_000, 1000, 8, 0.0, 0.1), (100_000, 3000, 1, 0.0, 0.1)],
)
def test_fused_scatter_add_kernel_matches_plain(card, n, v, d, skew, outside):
    """Every row within its limit of ``scatter_add_plain`` over the ids in
    [0, V); rows no such id touches exactly 0; two calls the same bits (no
    float atomics); a version that keeps only each id's first occurrence
    reads above the limit."""
    from tpurec_torch.ops import embedding_update as eu

    plan, grads = _sorted_stream(card, n, v, d, skew, outside=outside)
    before = eu.fused_scatter_add.launches
    got = eu.fused_scatter_add(v, d, plan, grads)
    again = eu.fused_scatter_add(v, d, plan, grads)
    torch.cuda.synchronize()
    assert eu.fused_scatter_add.launches == before + 2
    assert got.shape == (v, d) and torch.equal(got, again)
    if n == 0:
        assert not got.any()
        return
    inside = (plan.sids >= 0) & (plan.sids < v)
    assert outside or inside.all()
    plan, grads = plan._replace(sids=plan.sids[inside], n=int(inside.sum())), grads[inside]
    assert _sum_reading(got, plan, grads) <= 1.0
    touched = torch.zeros(v, dtype=torch.bool, device=card)
    touched[plan.sids.long()] = True
    assert not got[~touched].any()
    # a version that loses what runs carry past the tile they begin in
    tile = eu.scatter_tile_rows(d)
    start = torch.searchsorted(plan.sids, plan.sids)
    keep = torch.arange(plan.n, device=card) // tile == start // tile
    if not keep.all():
        dropped = eu.scatter_add_plain(v, plan.sids[keep], grads[keep])
        assert _sum_reading(dropped, plan, grads) > 1.0
    if plan.sids.unique().numel() < plan.n:
        first = torch.ones(plan.n, dtype=torch.bool, device=card)
        first[1:] = plan.sids[1:] != plan.sids[:-1]
        keep_first = eu.scatter_add_plain(v, plan.sids[first], grads[first])
        assert _sum_reading(keep_first, plan, grads) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [104, 4])
def test_fused_scatter_add_on_an_ffm_stream(card, d):
    """#9 on FFM's stream (26 fields of 80,000 ids, B=8192: N=212,992 ids
    over 2,080,128 rows, feature-major as the fused engine concatenates
    them) at the field-aware table's width F·k = 104 and at k = 4: within
    the limit of ``scatter_add_plain``, two calls the same bits, and a
    version that loses what runs carry past a slice above the limit."""
    from tpurec_torch.embedding.ops import pad_vocab
    from tpurec_torch.ops import embedding_update as eu

    rng = np.random.default_rng(3)
    ids = np.concatenate([rng.integers(80_000 * f, 80_000 * (f + 1), size=8192) for f in range(26)])
    v = pad_vocab(26 * 80_000)
    plan = eu.make_scatter_plan(torch.as_tensor(ids, device=card), v)
    grads = torch.randn(plan.n, d, device=card, generator=torch.Generator(card).manual_seed(3))
    got = eu.fused_scatter_add(v, d, plan, grads)
    again = eu.fused_scatter_add(v, d, plan, grads)
    assert got.shape == (v, d) and torch.equal(got, again)
    assert _sum_reading(got, plan, grads) <= 1.0
    rows = eu.scatter_slice_rows(d)
    start = torch.searchsorted(plan.sids, plan.sids)
    keep = torch.arange(plan.n, device=card) // rows == start // rows
    assert not keep.all()
    dropped = eu.scatter_add_plain(v, plan.sids[keep], grads[keep])
    assert _sum_reading(dropped, plan, grads) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("name,params,dim", [
    ("ffm", {}, 4), ("onn", {}, 4), ("pnn", {"product_type": "outer", "kernel_type": "mat"}, 8),
])
def test_fm_family_model_on_card_matches_cpu(card, name, params, dim):
    """FFM's and ONN's field-aware lookups and products and PNN's outer
    tower on the card against the same weights on the CPU (fp32)."""
    from tpurec_torch.config import EmbeddingConfig, ModelConfig
    from tpurec_torch.data.schema import DataInfo
    from tpurec_torch.models import build_model

    rng = np.random.default_rng(2)
    info = DataInfo.from_dims([f"f{i}" for i in range(8)], [50] * 8)
    batch = {f"f{i}": rng.integers(50 * i, 50 * i + 50, size=(64,)) for i in range(8)}
    config = ModelConfig(name=name, params=params, embedding=EmbeddingConfig(dim=dim))
    on_card = build_model(config, info, device=card).eval()
    on_cpu = build_model(config, info, device="cpu").eval()
    on_cpu.load_state_dict({k: v.cpu() for k, v in on_card.state_dict().items()})
    with torch.inference_mode():
        got = on_card({k: torch.as_tensor(v, device=card) for k, v in batch.items()})["logit"]
        want = on_cpu({k: torch.as_tensor(v) for k, v in batch.items()})["logit"]
    torch.testing.assert_close(got.cpu(), want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,v,d", [(50_000, 400_000, 32), (1003, 300, 5), (1003, 300, 160),
                                   (3000, 50, 1), (0, 10, 4)])
def test_gather_rows_kernel_matches_plain(card, n, v, d):
    from tpurec_torch.ops import embedding_update as eu

    plan, _ = _sorted_stream(card, n, v, 1, skew=0.3)
    table = torch.randn(v, d, device=card)
    before = eu.gather_rows_sorted.launches
    rows = eu.gather_rows_sorted(table, plan)
    torch.cuda.synchronize()
    assert eu.gather_rows_sorted.launches == before + 1
    assert torch.equal(rows, eu.gather_rows_plain(table, plan.sids))
    assert torch.equal(eu.unpermute_rows(rows, plan), table[plan.sids[torch.sort(plan.order).indices].long()])


@pytest.mark.cuda
def test_embedding_update_wrappers_refuse_what_the_kernels_do_not_take(card):
    from tpurec_torch.ops import embedding_update as eu

    plan, grads = _sorted_stream(card, 100, 50, 8)
    with pytest.raises(TypeError, match="int32"):
        eu.fused_scatter_add(50, 8, plan._replace(sids=plan.sids.long()), grads)
    with pytest.raises(TypeError, match="float32"):
        eu.fused_scatter_add(50, 8, plan, grads.double())
    with pytest.raises(ValueError, match="sids are on"):
        eu.gather_rows_sorted(torch.randn(50, 8, device=card), plan._replace(sids=plan.sids.cpu()))
    with pytest.raises(RuntimeError, match="requires grad"):
        eu.fused_scatter_add(50, 8, plan, grads.clone().requires_grad_())
    with torch.no_grad():
        eu.fused_scatter_add(50, 8, plan, grads.clone().requires_grad_())


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["fused_adam", "rowwise_adam", "host_adam"])
def test_sparse_engine_on_card_matches_cpu(card, opt):
    """Three fp32 steps of a small FM in a sparse engine on the card (kernel
    #9 in the fused engine, twice a step) against the same steps on the CPU:
    the loss of each step (1e-5) and the tables after them (2e-6: Adam
    steps of lr = 1e-3 from gradients summed in another order)."""
    from tpurec_torch.config import ExperimentConfig
    from tpurec_torch.data.schema import DataInfo
    from tpurec_torch.ops import embedding_update as eu
    from tpurec_torch.train.trainer import Trainer

    info = DataInfo.from_dims([f"f{i}" for i in range(8)], [50] * 8)

    def batch(seed):
        r = np.random.default_rng(seed)
        out = {f"f{i}": r.integers(50 * i, 50 * i + 50, size=(256,)) for i in range(8)}
        out["label"] = r.integers(0, 2, size=(256,)).astype(np.float32)
        return out

    config = ExperimentConfig.from_dict(dict(
        model=dict(name="fm", embedding=dict(dim=8)),
        train=dict(compute_dtype="float32", log_every_steps=0, sparse_embedding=True,
                   optimizer=dict(embedding_optimizer=opt)),
    ))
    trainers = [Trainer(config, info, device=card), Trainer(config, info, device="cpu")]
    states = [t.init_state(batch(0)) for t in trainers]
    states[1].model.load_state_dict({k: v.cpu() for k, v in states[0].model.state_dict().items()})
    before = eu.fused_scatter_add.launches
    for i in range(3):
        losses = []
        for j, (t, s) in enumerate(zip(trainers, states)):
            states[j], _, logs = t.train_step(s, t.device_batch(batch(10 + i)), t.metrics.init())
            losses.append(float(logs["loss"]))
        assert abs(losses[0] - losses[1]) <= 1e-5, losses
    torch.cuda.synchronize()
    assert eu.fused_scatter_add.launches - before == (6 if opt == "fused_adam" else 0)
    for name in ("v.embedding", "w.w.embedding"):
        got = states[0].model.get_parameter(name).detach().cpu()[:-1]
        want = states[1].model.get_parameter(name).detach()[:-1]
        torch.testing.assert_close(got, want, atol=2e-6, rtol=0, msg=name)


# --------------------------------------------------------------------------
# the DCN-family kernels (#2 cross network, #3 CIN, #6 SENet-bilinear)
def _cin_args(card, b, f, d, sizes, seed=0):
    gen = torch.Generator(card).manual_seed(seed)
    weights, h = [], f
    for s in sizes:
        weights.append(torch.randn(h * f, s, device=card, generator=gen) / (h * f) ** 0.5)
        h = s
    return torch.randn(b, f, d, device=card, generator=gen), weights


def _senet_args(card, b, f, d, with_bias=True, seed=0):
    gen = torch.Generator(card).manual_seed(seed)
    r = max(1, f // 3)

    def rn(*shape, scale=1.0):
        return scale * torch.randn(*shape, device=card, generator=gen)

    return [rn(b, f, d), rn(f, r, scale=0.5), rn(r, f, scale=0.5), rn(d, d, scale=0.3),
            rn(r, scale=0.3) if with_bias else None, rn(f, scale=0.3) if with_bias else None]


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,layers", [(8192, 416, 3), (1003, 429, 2), (1003, 429, 6), (7, 1, 1),
                                        (3, 3000, 2), (0, 8, 2)])
def test_cross_network_kernel_matches_plain(card, b, d, layers):
    from tpurec_torch.ops import kernels

    gen = torch.Generator(card).manual_seed(0)
    x0 = torch.randn(b, d, device=card, generator=gen)
    w = torch.randn(layers, d, device=card, generator=gen) * 0.5 / d**0.5
    bias = torch.randn(layers, d, device=card, generator=gen)
    before = kernels.cross_network_fused.launches
    got = kernels.cross_network_fused(x0, w, bias)
    torch.cuda.synchronize()
    assert got.shape == (b, d)
    assert kernels.cross_network_fused.launches == before + (1 if b else 0)
    torch.testing.assert_close(got, kernels.cross_network_plain(x0, w, bias), **TOL)


def _cross_args(card, b, d, layers, seed=0):
    gen = torch.Generator(card).manual_seed(seed)
    x0 = torch.randn(b, d, device=card, generator=gen)
    w = torch.randn(layers, d, device=card, generator=gen) * 0.5 / d**0.5
    return x0, w, torch.randn(layers, d, device=card, generator=gen)


@pytest.mark.cuda
@pytest.mark.parametrize("layers", [1, 2, 3, 6])
@pytest.mark.parametrize("d", [1, 7, 16, 416, 429, 1024, 8192])
def test_cross_network_kernel_every_width(card, d, layers):
    """Every D and L at B = 1, 1003 and 8192: a warp a row up to D = 1024
    (w and b staged in shared memory), a block a row at D = 8192; 16-byte
    units where D % 4 == 0, 4-byte ones else. One launch a call; two calls
    the same bits."""
    from tpurec_torch.ops import kernels

    assert kernels._library("cross_network").cross_network_route(d, layers) == int(d <= 1024)
    for b in (1, 1003, 8192):
        x0, w, bias = _cross_args(card, b, d, layers, seed=d + layers)
        before = kernels.cross_network_fused.launches
        got = kernels.cross_network_fused(x0, w, bias)
        torch.cuda.synchronize()
        assert kernels.cross_network_fused.launches == before + 1
        torch.testing.assert_close(got, kernels.cross_network_plain(x0, w, bias), **TOL)
        assert torch.equal(got, kernels.cross_network_fused(x0, w, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,layers", [(8192, 416, 3), (1024, 416, 3), (37, 8192, 2), (5, 64, 1)])
def test_cross_network_kernel_takes_unaligned_inputs(card, b, d, layers):
    """x0, w and b that start 4 bytes past a 16-byte boundary (views one
    float into their buffers, contiguous) take the 4-byte units: right, and
    the same bits on two calls."""
    from tpurec_torch.ops import kernels

    args = []
    for t in _cross_args(card, b, d, layers):
        buf = torch.empty(t.numel() + 1, device=card)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == 4 and view.is_contiguous()
        args.append(view)
    got = kernels.cross_network_fused(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, kernels.cross_network_plain(*args), **TOL)
    assert torch.equal(got, kernels.cross_network_fused(*args))


def _cin_reading(got, want):
    """|got − want| over 1e-4 of each output column's largest |value|: at
    most 1 passes (sums of H·F products a level, in another order)."""
    scale = want.abs().amax(dim=0).clamp_min(1e-30)
    return float(((got - want).abs() / scale).max()) / 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,d,sizes", [(1003, 7, 8, (5, 9, 3)), (256, 26, 32, (128, 128)),
                                         (37, 26, 32, (64, 64)), (5, 3, 200, (4,)), (9, 2, 5, (1, 1)),
                                         (0, 4, 8, (3, 2)), (1, 26, 32, (128, 128)),
                                         (8192, 26, 32, (128, 128)), (64, 1, 16, (3, 5)),
                                         (300, 5, 1, (12, 7)), (77, 6, 17, (10, 20, 30)),
                                         (45, 4, 33, (8,) * 8), (9, 26, 128, (128, 128)),
                                         (7, 5, 129, (16, 13)), (50, 3, 8, (138, 130)),
                                         (50, 3, 8, (150, 130)), (20, 26, 32, (160, 150))])
def test_cin_kernel_matches_plain(card, b, f, d, sizes):
    """Any F, D and level sizes (not only multiples of 128): the slice's
    shape at B = 1, 256 and 8192; F = 1; D = 1, 5, 8, 16, 17, 32, 33 and the
    128-row block tile's edges 128, 129 and 200; one, two, three and eight
    levels; S not a multiple of 8 and above the 128-column tile; S past the
    tensor-core kernel's shared memory (the fp32-FMA kernel runs); K = H·F
    not a multiple of 8; B = 0 (no launch). Two calls give the same bits."""
    from tpurec_torch.ops import kernels

    emb, weights = _cin_args(card, b, f, d, sizes)
    before = kernels.cin_fused.launches
    got = kernels.cin_fused(emb, weights)
    torch.cuda.synchronize()
    assert got.shape == (b, sum(sizes))
    assert kernels.cin_fused.launches == before + (1 if b else 0)
    if b == 0:
        return
    assert _cin_reading(got, kernels.cin_plain(emb, weights)) <= 1.0
    assert torch.equal(got, kernels.cin_fused(emb, weights))


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,d,with_bias", [(1003, 5, 24, True), (1003, 2, 24, True), (256, 26, 32, True),
                                             (37, 6, 7, False), (3, 1, 4, True), (0, 4, 8, True)])
def test_senet_bilinear_kernel_matches_plain(card, b, f, d, with_bias):
    from tpurec_torch.ops import kernels

    args = _senet_args(card, b, f, d, with_bias)
    before = kernels.senet_bilinear_fused.launches
    got = kernels.senet_bilinear_fused(*args)
    torch.cuda.synchronize()
    p = f * (f - 1) // 2
    assert got.shape == (b, p, d)
    assert kernels.senet_bilinear_fused.launches == before + (1 if b and p else 0)
    torch.testing.assert_close(got, kernels.senet_bilinear_plain(*args), **TOL)


@pytest.mark.cuda
def test_dcn_kernels_refuse_what_they_do_not_take(card):
    from tpurec_torch.ops import kernels

    x0, w = torch.randn(4, 8, device=card), torch.randn(2, 8, device=card)
    with pytest.raises(TypeError):
        kernels.cross_network_fused(x0.double(), w.double(), w.double())
    with pytest.raises(ValueError, match="is on"):
        kernels.cross_network_fused(x0, w.cpu(), w)
    with pytest.raises(ValueError, match="shapes"):
        kernels.cross_network_fused(x0, w[:, :4], w[:, :4])
    with pytest.raises(ValueError, match="pads to"):
        kernels.cross_network_fused(torch.randn(2, 9000, device=card), torch.randn(1, 9000, device=card),
                                    torch.randn(1, 9000, device=card))
    with pytest.raises(RuntimeError, match="requires grad"):
        kernels.cross_network_fused(x0, w.clone().requires_grad_(), w)
    emb, weights = _cin_args(card, 4, 3, 8, (4, 2))
    with pytest.raises(TypeError):
        kernels.cin_fused(emb.half(), weights)
    with pytest.raises(ValueError, match="is on"):
        kernels.cin_fused(emb, [weights[0].cpu(), weights[1]])
    with pytest.raises(ValueError, match="level 1"):
        kernels.cin_fused(emb, [weights[0], weights[0]])
    with pytest.raises(ValueError, match="levels"):
        kernels.cin_fused(emb, [torch.randn(9, 3, device=card)] + [torch.randn(9, 3, device=card)] * 8)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.cin_fused(emb, [torch.randn(9, 1000, device=card)])
    with pytest.raises(RuntimeError, match="requires grad"):
        kernels.cin_fused(emb.clone().requires_grad_(), weights)
    args = _senet_args(card, 4, 5, 8)
    with pytest.raises(TypeError):
        kernels.senet_bilinear_fused(args[0].bfloat16(), *args[1:])
    with pytest.raises(ValueError, match="is on"):
        kernels.senet_bilinear_fused(*args[:3], args[3].cpu(), *args[4:])
    with pytest.raises(ValueError, match="shapes"):
        kernels.senet_bilinear_fused(args[0], args[2], args[1], *args[3:])
    with pytest.raises(RuntimeError, match="requires grad"):
        kernels.senet_bilinear_fused(*args[:3], args[3].clone().requires_grad_(), *args[4:])
    with torch.no_grad():
        kernels.cross_network_fused(x0, w.clone().requires_grad_(), w)
        kernels.cin_fused(emb.clone().requires_grad_(), weights)
        kernels.senet_bilinear_fused(*args[:3], args[3].clone().requires_grad_(), *args[4:])


@pytest.mark.cuda
@pytest.mark.parametrize("name,params,kernel", [
    ("dcn", {}, "cross_network"), ("dcn", {"cross_type": "matrix"}, None),
    ("xdeepfm", {"cin_layer_sizes": (5, 9, 3)}, "cin"), ("fibinet", {}, "senet_bilinear"),
    ("fibinet", {"bilinear_mode": "each"}, None),
])
def test_dcn_family_on_card_matches_cpu(card, name, params, kernel):
    """A DCN-family model (fp32 compute, continuous features) through its
    kernel on the card against the same weights on the CPU; in training mode
    the kernel is not launched."""
    from tpurec_torch.config import EmbeddingConfig, ModelConfig
    from tpurec_torch.data.schema import DataInfo
    from tpurec_torch.models import build_model
    from tpurec_torch.ops import kernels

    names, dims = ["uid", "iid", "utag", "itag"], [50, 80, 10, 12]
    info = DataInfo.from_dims(names, dims, continuous_names=["c1", "c2"])
    rng = np.random.default_rng(5)
    batch = {n: rng.integers(o, o + d, size=(300,)) for n, o, d in zip(names, info.feature_offsets, dims)}
    batch.update(c1=rng.normal(size=(300,)).astype(np.float32), c2=rng.normal(size=(300,)).astype(np.float32))
    config = ModelConfig(name=name, params=params, embedding=EmbeddingConfig(dim=16))
    on_card = build_model(config, info, device=card).eval()
    on_cpu = build_model(config, info, device="cpu").eval()
    on_cpu.load_state_dict({k: v.cpu() for k, v in on_card.state_dict().items()})
    counts = lambda: tuple(getattr(kernels, f"{n}_fused").launches  # noqa: E731
                           for n in ("cross_network", "cin", "senet_bilinear"))
    before = counts()
    with torch.inference_mode():
        got = on_card({k: torch.as_tensor(v, device=card) for k, v in batch.items()})["logit"]
        want = on_cpu({k: torch.as_tensor(v) for k, v in batch.items()})["logit"]
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(counts(), before)]
    assert launched == [int(kernel == n) for n in ("cross_network", "cin", "senet_bilinear")]
    torch.testing.assert_close(got.cpu(), want, **TOL)
    before = counts()
    out = on_card.train()({k: torch.as_tensor(v, device=card) for k, v in batch.items()})["logit"]
    out.sum().backward()
    assert counts() == before


# --------------------------------------------------------------------------
# capsule dynamic routing (#7 forward, #8 backward)
def _routing_args(card, b, l, d, e, k, seed=0, holes=False):
    """behavior, a mask of lengths 0..L (row b // 2 all zero where B > 1),
    S at the scale of its glorot init, and a broadcast (1, K, L) logits0 as
    the model passes it. With ``holes`` every other row's mask is random
    steps and the row after b // 2 is live at its last step only."""
    gen = torch.Generator(card).manual_seed(seed)
    lengths = torch.randint(0, l + 1, (b,), device=card, generator=gen)
    if b > 1:
        lengths[b // 2] = 0
    mask = (torch.arange(l, device=card)[None, :] < lengths[:, None]).float()
    if holes:
        mask[::2] = (torch.rand(mask[::2].shape, device=card, generator=gen) < 0.5).float()
        if b > 1:
            mask[b // 2] = 0.0
        mask[(b // 2 + 1) % b] = 0.0
        mask[(b // 2 + 1) % b, -1] = 1.0
    beh = torch.randn(b, l, d, device=card, generator=gen)
    s = torch.randn(d, e, device=card, generator=gen) * (2.0 / (d + e)) ** 0.5
    l0 = torch.randn(1, k, l, device=card, generator=gen).expand(b, k, l)
    return [beh, mask, s, l0]


def _routing_variant(beh, mask, s, l0, iters, stop_grad=True, chain=True):
    """The plain routing with two switches that break it on purpose:
    ``stop_grad=False`` differentiates through every iteration's u,
    ``chain=False`` lets only the last iteration's softmax reach logits0."""
    from tpurec_torch.ops.capsule import squash

    u = torch.einsum("bld,de->ble", beh, s)
    live = mask.bool()[:, None, :]
    logits = l0
    for it in range(iters):
        last = it == iters - 1
        lg = logits if (chain or last) else logits.detach()
        w = torch.softmax(torch.where(live, lg, -1e9), dim=1) * mask[:, None, :]
        src = u if (last or not stop_grad) else u.detach()
        caps = squash(torch.einsum("bkl,ble->bke", w, src))
        if not last:
            logits = logits + torch.einsum("bke,ble->bkl", caps, src)
    return caps


def _routing_grads(fn, args, g):
    leaves = [t.detach().clone().requires_grad_() for t in (args[0], args[2], args[3])]
    with torch.enable_grad():
        out = fn(leaves[0], args[1], leaves[1], leaves[2])
        return torch.autograd.grad(out, leaves, g)


def _routing_reading(got, want):
    """dbehavior and dlogits0 elementwise at TOL; dS (a sum over B·L rows)
    at 1e-4 of its largest value: at most 1 passes."""
    out = []
    for i, (x, y) in enumerate(zip(got, want)):
        if i == 1:
            out.append(float((x - y).abs().max()) / (1e-4 * max(float(y.abs().max()), 1e-30)))
        else:
            out.append(float(((x - y).abs() / (TOL["atol"] + TOL["rtol"] * y.abs())).max()))
    return max(out)


# (B, L, D, E, K, iterations): the slice's shape, ragged ones, B=1, L at
# the forward's 16-step tile edges (15, 16, 17, 65), D and E that are no
# multiple of 8, and the widest E and the most steps the forward takes
ROUTING_SHAPES = [(1024, 64, 64, 64, 4, 3), (9, 12, 8, 8, 4, 3), (33, 50, 48, 40, 3, 3),
                  (9, 12, 8, 8, 4, 1), (33, 50, 48, 40, 3, 2), (5, 1, 3, 2, 1, 3),
                  (1, 64, 64, 64, 4, 3), (7, 15, 64, 64, 4, 3), (7, 16, 32, 24, 4, 3),
                  (7, 17, 20, 12, 3, 2), (5, 65, 64, 64, 4, 3), (9, 33, 13, 21, 4, 3),
                  (6, 40, 5, 100, 2, 3), (4, 64, 64, 128, 8, 3), (3, 128, 16, 16, 4, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("holes", [False, True])
@pytest.mark.parametrize("b,l,d,e,k,iters", ROUTING_SHAPES)
def test_capsule_routing_kernel_matches_plain(card, b, l, d, e, k, iters, holes):
    """#7 against its plain version, with a broadcast and a materialised
    logits0, with prefix masks and masks with holes; two calls give the
    same bits; a forward that ignores the mask, or runs one iteration
    fewer, misses the tolerance."""
    from tpurec_torch.ops import kernels

    args = _routing_args(card, b, l, d, e, k, holes=holes)
    before = kernels.capsule_routing_fused.launches
    got = kernels.capsule_routing_fused(*args, iters)
    dense = kernels.capsule_routing_fused(*args[:3], args[3].contiguous(), iters)
    again = kernels.capsule_routing_fused(*args, iters)
    torch.cuda.synchronize()
    assert kernels.capsule_routing_fused.launches == before + 3
    assert torch.equal(got, again)
    assert got.shape == (b, k, e) and (b == 1 or not got[b // 2].any())
    want = kernels.capsule_routing_plain(*args, iters)
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(dense, want, **TOL)
    if l > 1:
        no_mask = kernels.capsule_routing_plain(args[0], torch.ones_like(args[1]), *args[2:], iters)
        assert not torch.allclose(no_mask, want, **TOL)
    if iters > 1 and k > 1:  # with one capsule every iteration routes the same
        assert not torch.allclose(kernels.capsule_routing_plain(*args, iters - 1), want, **TOL)


# #8 also at the slice's B=8192 and past the tensor-core kernel's limits
# (L > 128, E > 128), which take the fp32-FMA kernel
ROUTING_BWD_SHAPES = ROUTING_SHAPES + [(8192, 64, 64, 64, 4, 3), (3, 200, 16, 16, 4, 2),
                                       (4, 12, 8, 136, 2, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("holes", [False, True])
@pytest.mark.parametrize("b,l,d,e,k,iters", ROUTING_BWD_SHAPES)
def test_capsule_routing_bwd_kernel_matches_plain(card, b, l, d, e, k, iters, holes):
    """#8 against autograd of the plain version: dbehavior, dlogits0 at TOL,
    dS at 1e-4 of its largest value, with prefix masks and masks with
    holes; the C side's route (the tensor-core kernel for L, E <= 128);
    rows past a row's last live step are zeros; two calls the same bits; a
    backward through the stop-gradient iterations, or one that gives
    logits0 only the last iteration, reads above the limit."""
    from tpurec_torch.ops import kernels

    args = _routing_args(card, b, l, d, e, k, seed=1, holes=holes)
    g = torch.randn(b, k, e, device=card, generator=torch.Generator(card).manual_seed(2))
    before = kernels.capsule_routing_bwd_fused.launches
    got = kernels.capsule_routing_bwd_fused(*args, g, iters)
    again = kernels.capsule_routing_bwd_fused(*args, g, iters)
    torch.cuda.synchronize()
    assert kernels.capsule_routing_bwd_fused.launches == before + 2
    route = kernels._library("capsule_routing").capsule_routing_bwd_route(l, d, e, k, iters)
    assert route == int(l <= kernels.CAPSULE_MAX_STEPS and e <= kernels.CAPSULE_MAX_WIDTH)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert [t.shape for t in got] == [(b, l, d), (d, e), (b, k, l)]
    steps = torch.arange(l, device=card)
    last = torch.where(args[1] != 0, steps, -1).max(dim=1).values
    past = steps[None, :] > last[:, None]
    assert not got[0][past].any() and not got[2].transpose(1, 2)[past].any()
    want = kernels.capsule_routing_bwd_plain(*args, g, iters)
    assert _routing_reading(got, want) <= 1.0
    if iters > 1 and k > 1:
        for broken in (dict(stop_grad=False), dict(chain=False)):
            fn = lambda x, m, s, l0: _routing_variant(x, m, s, l0, iters, **broken)  # noqa: E731
            assert _routing_reading(_routing_grads(fn, args, g), want) > 1.0, broken


@pytest.mark.cuda
def test_capsule_routing_function_on_card_matches_cpu(card):
    """``CapsuleRouting`` on the card (both kernels, once each) against the
    same inputs on the CPU (the plain versions); no gradient for the mask."""
    from tpurec_torch.ops import kernels

    args = _routing_args(card, 300, 64, 64, 64, 4, seed=3)
    g = torch.randn(300, 4, 64, device=card, generator=torch.Generator(card).manual_seed(4))

    def run(tensors, g):
        leaves = [t.detach().clone().requires_grad_(i != 1) for i, t in enumerate(tensors)]
        out = kernels.CapsuleRouting.apply(*leaves, 3)
        out.backward(g)
        assert leaves[1].grad is None
        return [out.detach(), leaves[0].grad, leaves[2].grad, leaves[3].grad]

    before = (kernels.capsule_routing_fused.launches, kernels.capsule_routing_bwd_fused.launches)
    on_card = run(args, g)
    torch.cuda.synchronize()
    assert (kernels.capsule_routing_fused.launches, kernels.capsule_routing_bwd_fused.launches) == (
        before[0] + 1, before[1] + 1
    )
    on_cpu = run([t.cpu() for t in args], g.cpu())
    for i, (x, y) in enumerate(zip(on_card, on_cpu)):
        _assert_close_scaled(x.cpu(), y, what=f"output {i}")


@pytest.mark.cuda
def test_capsule_routing_kernels_refuse_what_they_do_not_take(card):
    from tpurec_torch.ops import kernels

    beh, mask, s, l0 = _routing_args(card, 4, 8, 6, 5, 3)
    g = torch.randn(4, 3, 5, device=card)
    with pytest.raises(TypeError):
        kernels.capsule_routing_fused(beh.double(), mask, s, l0)
    with pytest.raises(ValueError, match="is on"):
        kernels.capsule_routing_fused(beh, mask, s.cpu(), l0)
    with pytest.raises(ValueError, match="agree"):
        kernels.capsule_routing_fused(beh, mask[:, :4], s, l0)
    with pytest.raises(ValueError, match="num_iters"):
        kernels.capsule_routing_fused(beh, mask, s, l0, 0)
    big = _routing_args(card, 2, 2000, 64, 64, 4)
    with pytest.raises(ValueError, match="steps"):
        kernels.capsule_routing_fused(*big)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.capsule_routing_bwd_fused(*big, torch.zeros(2, 4, 64, device=card))
    with pytest.raises(ValueError, match="capsule width"):
        kernels.capsule_routing_fused(*_routing_args(card, 2, 8, 6, 129, 3))
    with pytest.raises(ValueError, match="g "):
        kernels.capsule_routing_bwd_fused(beh, mask, s, l0, g[:, :2])
    with pytest.raises(RuntimeError, match="requires grad"):
        kernels.capsule_routing_fused(beh, mask, s.clone().requires_grad_(), l0)
    with pytest.raises(RuntimeError, match="requires grad"):
        kernels.capsule_routing_bwd_fused(beh, mask, s, l0, g.clone().requires_grad_())
    with torch.no_grad():
        kernels.capsule_routing_fused(beh, mask, s.clone().requires_grad_(), l0)
    assert kernels.capsule_routing_fused(beh[:0], mask[:0], s, l0[:0]).shape == (0, 3, 5)
    # behavior that is NaN past each row's last live step: the backward
    # never reads it (x arrives as zeros there) and gives what it gives for
    # zeros, where the plain version multiplies it by w = 0 and gives NaN
    mask = (torch.arange(8, device=card)[None, :] < torch.tensor([[3], [8], [0], [5]], device=card)).float()
    zeros = torch.where(mask[:, :, None] != 0, beh, 0.0)
    nan = torch.where(mask[:, :, None] != 0, beh, float("nan"))
    got = kernels.capsule_routing_bwd_fused(nan, mask, s, l0, g)
    assert all(torch.equal(x, y) for x, y in zip(got, kernels.capsule_routing_bwd_fused(zeros, mask, s, l0, g)))
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert not bool(torch.isfinite(kernels.capsule_routing_bwd_plain(nan, mask, s, l0, g)[1]).all())
    assert _routing_reading(got, kernels.capsule_routing_bwd_plain(zeros, mask, s, l0, g)) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("name,params", [("mind", {}), ("mind", {"normalize_logits": True}),
                                         ("comirec", {"variant": "dr"}), ("sine", {})])
def test_retrieval_model_on_card_matches_cpu(card, name, params):
    """A multi-interest model (fp32) on the card against the same weights on
    the CPU: MIND launches #7 once outside training and neither kernel in a
    training forward and backward (the module's math, as in the JAX
    package)."""
    from tpurec_torch.config import EmbeddingConfig, ModelConfig
    from tpurec_torch.data.schema import DataInfo
    from tpurec_torch.models import build_model
    from tpurec_torch.ops import kernels

    rng = np.random.default_rng(6)
    info = DataInfo.from_dims(
        ["user_tag", "item_id", "item_tag"], [10, 200, 5], sequence_names=["history", "history_tags"],
        sequence_query_features=["item_id", "item_tag"], max_seq_length=16,
        user_features=["user_tag"], item_features=["item_id", "item_tag"],
    )
    batch = {n: rng.integers(o, o + d, size=(64,))
             for n, o, d in zip(info.feature_names, info.feature_offsets, info.feature_dims)}
    live = rng.random((64, 16)) < 0.7
    batch["history"] = np.where(live, rng.integers(11, 211, size=(64, 16)), 0)
    batch["history_tags"] = np.where(live, rng.integers(211, 216, size=(64, 16)), 0)
    config = ModelConfig(name=name, params=params, embedding=EmbeddingConfig(dim=16))
    on_card = build_model(config, info, device=card).eval()
    on_cpu = build_model(config, info, device="cpu").eval()
    on_cpu.load_state_dict({k: v.cpu() for k, v in on_card.state_dict().items()})
    counts = lambda: (kernels.capsule_routing_fused.launches,  # noqa: E731
                      kernels.capsule_routing_bwd_fused.launches)
    before = counts()
    with torch.inference_mode():
        got = on_card({k: torch.as_tensor(v, device=card) for k, v in batch.items()})
        want = on_cpu({k: torch.as_tensor(v) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert counts() == (before[0] + int(name == "mind"), before[1])
    for key in ("user_embedding", "interest_capsules", "output"):
        torch.testing.assert_close(got[key].cpu(), want[key], **TOL, msg=key)
    before = counts()
    out = on_card.train()({k: torch.as_tensor(v, device=card) for k, v in batch.items()})
    out["output"].sum().backward()
    torch.cuda.synchronize()
    assert counts() == before


# --------------------------------------------------------------------------
# the rest of the DCN family (no kernel of its own; NFM's fused step runs #9)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_and_k_max_pool_on_card_match_cpu(card, dtype):
    """``Conv`` (cuDNN, widths 6 and 7) and ``k_max_pool`` on the card
    against the CPU: the conv to ``TOL`` in fp32 and to 2^-7 relative in
    bf16 (one rounding of the output); k-max values and, among ties (a
    coarse grid), their gradient equal, as both sort stably."""
    from tpurec_torch.ops import conv

    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(5)
    for width, c_in in ((6, 1), (7, 3)):
        module = conv.Conv(c_in, 4, width)
        module.init_weights(gen)
        x = torch.randn(64, 13, 8, c_in, generator=gen).to(dt)
        want = module(x)
        got = module.to(card)(x.to(card))
        tol = TOL if dtype == "float32" else dict(atol=1e-2, rtol=2.0**-7)
        torch.testing.assert_close(got.cpu().float(), want.float(), **tol)
    x = (torch.round(torch.randn(64, 13, 8, 4, generator=gen) * 2) / 2 + 0.25).to(dt)
    w = torch.randn(64, 5, 8, 4, generator=gen)
    grads = []
    for device in ("cpu", card):
        xd = x.detach().to(device).requires_grad_()
        out = conv.k_max_pool(xd, 5, dim=1)
        (out.float() * w.to(device)).sum().backward()
        grads.append((out.detach().cpu(), xd.grad.cpu()))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])


def _dcn_rest_schema(rng, b=64):
    """8 fields of 50 ids and 3 continuous columns, and a ``b``-row batch."""
    from tpurec_torch.data.schema import DataInfo

    names = [f"f{i}" for i in range(8)]
    info = DataInfo.from_dims(names, [50] * 8, continuous_names=["c0", "c1", "c2"])
    batch = {n: rng.integers(50 * i, 50 * i + 50, size=(b,)) for i, n in enumerate(names)}
    for c in info.continuous_names:
        batch[c] = rng.normal(size=(b,)).astype(np.float32)
    batch["label"] = rng.integers(0, 2, size=(b,)).astype(np.float32)
    return info, batch


@pytest.mark.cuda
@pytest.mark.parametrize("name,params,dim", [
    ("nfm", {}, 8), ("deep_crossing", {}, 8), ("fnn", {}, 8), ("ccpm", {}, 8), ("fgcnn", {}, 8),
    ("afm", {}, 8), ("autoint", {"num_attention_layers": 3, "num_heads": 2, "head_dim": 32}, 16),
])
def test_dcn_rest_model_on_card_matches_cpu(card, name, params, dim):
    """NFM, DeepCrossing, FNN, CCPM, FGCNN, AFM and AutoInt (fp32) on the
    card against the same weights on the CPU, NFM with running statistics
    of its own: no kernel is launched."""
    from tpurec_torch.config import EmbeddingConfig, ModelConfig
    from tpurec_torch.models import build_model
    from tpurec_torch.ops import embedding_update as eu
    from tpurec_torch.ops import kernels

    info, batch = _dcn_rest_schema(np.random.default_rng(7))
    batch.pop("label")
    config = ModelConfig(name=name, params=params, embedding=EmbeddingConfig(dim=dim))
    on_card = build_model(config, info, device=card).eval()
    if name == "nfm":
        on_card.bn.running_mean.uniform_(-0.01, 0.01)
        on_card.bn.running_var.uniform_(1e-3, 2e-3)
    on_cpu = build_model(config, info, device="cpu").eval()
    on_cpu.load_state_dict({k: v.cpu() for k, v in on_card.state_dict().items()})
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = on_card({k: torch.as_tensor(v, device=card) for k, v in batch.items()})["logit"]
        want = on_cpu({k: torch.as_tensor(v) for k, v in batch.items()})["logit"]
    torch.cuda.synchronize()
    assert kernels.fm_second_order_fused.launches == 0 and eu.fused_scatter_add.launches == 0
    torch.testing.assert_close(got.cpu(), want, **TOL)


@pytest.mark.cuda
def test_nfm_fused_step_on_card_matches_cpu(card):
    """Three fp32 steps of NFM in the fused engine on the card (#9 twice a
    step, D=8 and D=1) against the same steps on the CPU: the loss of each
    (1e-5), the tables (2e-6) and the BatchNorm's running statistics after
    them (1e-6)."""
    from tpurec_torch.config import ExperimentConfig
    from tpurec_torch.ops import embedding_update as eu
    from tpurec_torch.train.trainer import Trainer

    info, _ = _dcn_rest_schema(np.random.default_rng(0))
    config = ExperimentConfig.from_dict(dict(
        model=dict(name="nfm", embedding=dict(dim=8)),
        train=dict(compute_dtype="float32", log_every_steps=0, sparse_embedding=True,
                   optimizer=dict(embedding_optimizer="fused_adam")),
    ))
    trainers = [Trainer(config, info, device=card), Trainer(config, info, device="cpu")]
    first = _dcn_rest_schema(np.random.default_rng(10), 256)[1]
    states = [t.init_state(first) for t in trainers]
    states[1].model.load_state_dict({k: v.cpu() for k, v in states[0].model.state_dict().items()})
    before = eu.fused_scatter_add.launches
    for i in range(3):
        batch = _dcn_rest_schema(np.random.default_rng(10 + i), 256)[1]
        losses = []
        for j, (t, s) in enumerate(zip(trainers, states)):
            states[j], _, logs = t.train_step(s, t.device_batch(batch), t.metrics.init())
            losses.append(float(logs["loss"]))
        assert abs(losses[0] - losses[1]) <= 1e-5, losses
    torch.cuda.synchronize()
    assert eu.fused_scatter_add.launches - before == 6
    for name in ("emb.embedding", "w.w.embedding"):
        got = states[0].model.get_parameter(name).detach().cpu()[:-1]
        want = states[1].model.get_parameter(name).detach()[:-1]
        torch.testing.assert_close(got, want, atol=2e-6, rtol=0, msg=name)
    for buf in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(states[0].model.bn, buf).cpu(), getattr(states[1].model.bn, buf),
                                   atol=1e-6, rtol=0, msg=buf)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(300,), (7, 5, 40), (64, 20000)])
def test_top_k_tie_order_on_the_card_equals_the_cpu(card, shape):
    """``top_k`` keeps ``lax.top_k``'s order (the lower index first among
    equal values) on the card as on the CPU, where the tests hold it to JAX;
    the (64, 20000) case is a slice of the index build's shape."""
    from tpurec_torch.ops.topk import top_k

    x = torch.from_numpy(np.random.default_rng(0).integers(0, 6, size=shape).astype(np.float32))
    for k in (1, 5, 20):
        want_v, want_i = top_k(x, k)
        got_v, got_i = top_k(x.to(card), k)
        assert torch.equal(got_i.cpu(), want_i) and torch.equal(got_v.cpu(), want_v), k


# --------------------------------------------------------------------------
# the multi-task and personalization families
def _multitask_schema(rng, b=64):
    """8 fields of 50 ids, one continuous column, and a ``b``-row batch with
    the click ``ctr``, the conversion ``cvr`` (only given a click) and
    ``label``."""
    from tpurec_torch.data.schema import DataInfo

    names = [f"f{i}" for i in range(8)]
    info = DataInfo.from_dims(names, [50] * 8, continuous_names=["c0"])
    batch = {n: rng.integers(50 * i, 50 * i + 50, size=(b,)) for i, n in enumerate(names)}
    batch["c0"] = rng.normal(size=(b,)).astype(np.float32)
    ctr = (rng.random(b) < 0.5).astype(np.float32)
    batch.update(ctr=ctr, label=ctr, cvr=ctr * (rng.random(b) < 0.5).astype(np.float32))
    return info, batch


@pytest.mark.cuda
@pytest.mark.parametrize("name,params", [
    ("mmoe", {}), ("esmm", {}), ("ple", {}), ("esm2", {}), ("escm2", {}),
    ("escm2", {"counterfact_mode": "dr"}), ("fdn", {}), ("poso_mlp", {}), ("poso_mha", {}),
    ("poso_mmoe", {}), ("pepnet", {}),
])
def test_multitask_model_on_card_matches_cpu(card, name, params):
    """Every output of each multi-task and personalization model (the
    in-model losses included) in eval mode on the card against the same
    weights on the CPU (fp32); no kernel is launched."""
    from tpurec_torch.config import EmbeddingConfig, ModelConfig
    from tpurec_torch.models import build_model
    from tpurec_torch.ops import embedding_update as eu
    from tpurec_torch.ops import kernels

    info, batch = _multitask_schema(np.random.default_rng(8))
    config = ModelConfig(name=name, params=params, embedding=EmbeddingConfig(dim=8))
    on_card = build_model(config, info, device=card).eval()
    on_cpu = build_model(config, info, device="cpu").eval()
    on_cpu.load_state_dict({k: v.cpu() for k, v in on_card.state_dict().items()})
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = on_card({k: torch.as_tensor(v, device=card) for k, v in batch.items()})
        want = on_cpu({k: torch.as_tensor(v) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert eu.fused_scatter_add.launches == 0
    assert set(got) == set(want)
    for key in want:
        torch.testing.assert_close(got[key].cpu(), want[key], **TOL, msg=key)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mmoe", "poso_mmoe"])
def test_multitask_fused_step_on_card_matches_cpu(card, name):
    """Three fp32 ``multi_task`` steps of mmoe and poso_mmoe (whose gate
    field is looked up twice) in the fused engine on the card (#9 once a
    step: one table) against the same steps on the CPU: the loss of each
    (1e-5) and the table after them (2e-6)."""
    from tpurec_torch.config import ExperimentConfig
    from tpurec_torch.ops import embedding_update as eu
    from tpurec_torch.train.trainer import Trainer

    info, _ = _multitask_schema(np.random.default_rng(0))
    config = ExperimentConfig.from_dict(dict(
        model=dict(name=name, embedding=dict(dim=8)),
        train=dict(compute_dtype="float32", log_every_steps=0, loss="multi_task",
                   sparse_embedding=True, optimizer=dict(embedding_optimizer="fused_adam")),
    ))
    trainers = [Trainer(config, info, device=card), Trainer(config, info, device="cpu")]
    first = _multitask_schema(np.random.default_rng(10), 256)[1]
    states = [t.init_state(first) for t in trainers]
    states[1].model.load_state_dict({k: v.cpu() for k, v in states[0].model.state_dict().items()})
    before = eu.fused_scatter_add.launches
    for i in range(3):
        batch = _multitask_schema(np.random.default_rng(10 + i), 256)[1]
        losses = []
        for j, (t, s) in enumerate(zip(trainers, states)):
            states[j], _, logs = t.train_step(s, t.device_batch(batch), t.metrics.init())
            losses.append(float(logs["loss"]))
        assert abs(losses[0] - losses[1]) <= 1e-5, losses
    torch.cuda.synchronize()
    assert eu.fused_scatter_add.launches - before == 3
    got = states[0].model.emb.embedding.detach().cpu()[:-1]
    want = states[1].model.emb.embedding.detach()[:-1]
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)


# --------------------------------------------------------------------------
# the recurrent sequence models and the FiBiNET++ family
def _sequence_schema(rng, b=64, l=16):
    """Three profile fields and two aligned series of ``l`` steps (item ids
    and their tags) with holes, row 0 with no live step, and each series'
    sampled negatives (``neg_<series>``); a ``b``-row batch with ``label``."""
    from tpurec_torch.data.schema import DataInfo

    info = DataInfo.from_dims(
        ["user_tag", "item_id", "item_tag"], [20, 60, 12],
        sequence_names=["history", "history_tags"], sequence_query_features=["item_id", "item_tag"],
        user_features=["user_tag"], item_features=["item_id", "item_tag"],
        max_seq_length=l, padding_index=0,
    )
    span = dict(zip(info.feature_names, zip(info.feature_offsets, info.feature_dims)))
    batch = {n: rng.integers(o, o + d, size=(b,)) for n, (o, d) in span.items()}
    live = rng.random((b, l)) < 0.7
    live[0] = False
    for series, query in zip(info.sequence_names, info.sequence_query_features):
        o, d = span[query]
        batch[series] = np.where(live, rng.integers(o, o + d, size=(b, l)), 0)
        batch[f"neg_{series}"] = np.where(live, rng.integers(o, o + d, size=(b, l)), 0)
    batch["label"] = rng.integers(0, 2, size=(b,)).astype(np.float32)
    return info, batch


SEQUENCE_CARD_MODELS = [
    ("dien", {}, 1), ("dien", {"gru_mode": "agru"}, 1), ("dien", {"gru_mode": "aigru"}, 1),
    ("dsin", {"num_sessions": 4}, 2), ("sdm", {}, 0),
    ("fibinet_pp", {}, 0), ("masknet", {"mode": "serial"}, 0), ("masknet", {"mode": "parallel"}, 0),
    ("contextnet", {"block_mode": "pointwise"}, 0), ("contextnet", {"block_mode": "singlelayer"}, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,params,attentions", SEQUENCE_CARD_MODELS)
def test_sequence_model_on_card_matches_cpu(card, name, params, attentions):
    """DIEN (each evolution mode), DSIN, SDM and the FiBiNET++ family (fp32,
    eval mode) on the card against the same weights on the CPU, every
    output; DIEN and DSIN launch #4 once per attention, the others no
    kernel."""
    from tpurec_torch.config import EmbeddingConfig, ModelConfig
    from tpurec_torch.models import build_model
    from tpurec_torch.ops import embedding_update as eu
    from tpurec_torch.ops import kernels

    if name in ("dien", "dsin", "sdm"):
        info, batch = _sequence_schema(np.random.default_rng(9))
    else:
        info, batch = _multitask_schema(np.random.default_rng(9))
    batch.pop("label")
    config = ModelConfig(name=name, params=params, embedding=EmbeddingConfig(dim=8))
    on_card = build_model(config, info, device=card).eval()
    if hasattr(on_card, "cat_bn"):  # running statistics of its own
        on_card.cat_bn.running_mean.uniform_(-0.1, 0.1)
        on_card.cat_bn.running_var.uniform_(0.5, 1.5)
    on_cpu = build_model(config, info, device="cpu").eval()
    on_cpu.load_state_dict({k: v.cpu() for k, v in on_card.state_dict().items()})
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = on_card({k: torch.as_tensor(v, device=card) for k, v in batch.items()})
        want = on_cpu({k: torch.as_tensor(v) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert kernels.din_attention_fused.launches == attentions and eu.fused_scatter_add.launches == 0
    assert set(got) == set(want)
    for key in want:
        torch.testing.assert_close(got[key].cpu(), want[key], **TOL, msg=lambda m, k=key: f"{k}: {m}")


@pytest.mark.cuda
def test_dien_fused_step_on_card_matches_cpu(card):
    """Three fp32 DIEN steps with the sampled negative series in the fused
    engine on the card (#9 once a step over the profile, query, history and
    negative ids; #4 and #5 once a step, #5 with gp = 0) against the same
    steps on the CPU: the loss of each (1e-5) and the table after them
    (2e-6)."""
    from tpurec_torch.config import ExperimentConfig
    from tpurec_torch.ops import embedding_update as eu
    from tpurec_torch.ops import kernels
    from tpurec_torch.train.trainer import Trainer

    info, _ = _sequence_schema(np.random.default_rng(0))
    config = ExperimentConfig.from_dict(dict(
        model=dict(name="dien", embedding=dict(dim=8)),
        train=dict(compute_dtype="float32", log_every_steps=0, sparse_embedding=True,
                   optimizer=dict(embedding_optimizer="fused_adam")),
    ))
    trainers = [Trainer(config, info, device=card), Trainer(config, info, device="cpu")]
    first = _sequence_schema(np.random.default_rng(10), 256)[1]
    states = [t.init_state(first) for t in trainers]
    states[1].model.load_state_dict({k: v.cpu() for k, v in states[0].model.state_dict().items()})
    kernels.reset_launch_counts()
    for i in range(3):
        batch = _sequence_schema(np.random.default_rng(10 + i), 256)[1]
        losses = []
        for j, (t, s) in enumerate(zip(trainers, states)):
            states[j], _, logs = t.train_step(s, t.device_batch(batch), t.metrics.init())
            losses.append(float(logs["loss"]))
        assert abs(losses[0] - losses[1]) <= 1e-5, losses
    torch.cuda.synchronize()
    assert eu.fused_scatter_add.launches == 3
    assert kernels.din_attention_fused.launches == kernels.din_attention_bwd_fused.launches == 3
    got = states[0].model.emb.embedding.detach().cpu()[:-1]
    want = states[1].model.emb.embedding.detach()[:-1]
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("l", [64, 4])
def test_din_attention_bwd_kernel_with_zero_pooled_cotangent(card, l):
    """#5 as DIEN runs it: gp = 0 and gs the gradient of a loss through the
    softmax of the scores over the live steps (so 0 at masked steps), at
    DIEN's (8192, 64, 32, 36) and DSIN's session shape (8192, 4, 32, 36)
    with a mask with holes; gs scaled to a largest |value| of 1. The
    reference is the plain version in fp64: over 8192 × 64 × 36
    pre-activations some lie within fp32's rounding of PReLU's kink, where
    the fp32 plain version takes the other slope and the kernel, which
    takes lin there in fp64, does not."""
    from tpurec_torch.ops import kernels

    b, d, h = 8192, 32, 36
    args = _din_args(card, b, l, d, h, True, seed=11, holes=True)
    _, scores = kernels.din_attention_plain(*args)
    scores = scores.detach().requires_grad_(True)
    live = args[2].bool()
    weights = torch.softmax(torch.where(live, scores, -1e9), dim=-1) * live.any(dim=-1, keepdim=True)
    target = torch.randn(b, l, device=card, generator=torch.Generator(card).manual_seed(12))
    (gs,) = torch.autograd.grad((weights * target).sum(), scores)
    gs = gs / gs.abs().max()
    gp = torch.zeros(b, d, device=card)
    assert not gs[~live].any() and gs.abs().sum() > 0
    got = kernels.din_attention_bwd_fused(*args, gp, gs)
    want = [w.float() for w in kernels.din_attention_bwd_plain(*[a.double() for a in args + [gp, gs]])]
    names = ("dq", "dkeys", "dw1", "db1", "dw2", "dalpha")
    for name, g, w in zip(names[:2], got[:2], want[:2]):
        torch.testing.assert_close(g, w, **TOL, msg=lambda m, n=name: f"{n}: {m}")
    for name, g, w in zip(names[2:], got[2:], want[2:]):
        _assert_close_scaled(g, w, what=name)
    assert all(torch.equal(x, y) for x, y in zip(got, kernels.din_attention_bwd_fused(*args, gp, gs)))


# --------------------------------------------------------------------------
# the long-sequence and DMR families: the hashing ops, #9 at CAN's widths
SIGN_MARGIN = 1e-5  # as the CPU tests': |x·p| beyond fp32 rounding of the products


def _recorded_bits(fn):
    """Run ``fn()`` with the port's ``simhash_bits`` recorded where the
    models call it: (its result, each call's (x, projection, bits) on the
    CPU, in call order)."""
    from unittest import mock

    from tpurec_torch.ops import hashing

    simhash = hashing.simhash_bits
    calls = []

    def recorded(x, projection):
        bits = simhash(x, projection)
        calls.append((x.detach().cpu(), projection.cpu(), bits.cpu()))
        return bits

    with mock.patch.object(hashing, "simhash_bits", recorded), \
            mock.patch("tpurec_torch.models.sim.simhash_bits", recorded):
        out = fn()
    return out, calls


def _flipped_rows(card_calls, cpu_calls):
    """The batch rows (axis 0 of every hashed tensor) where a card bit
    differs from the CPU's; every such flip must be a product within
    ``SIGN_MARGIN`` of 0 (an fp32 sum in another order). Returns (rows,
    number of flipped bits)."""
    assert len(card_calls) == len(cpu_calls)
    rows, flips = set(), 0
    for (_, _, got), (x, proj, want) in zip(card_calls, cpu_calls):
        flipped = got != want
        if flipped.any():
            products = torch.einsum("...d,db->...b", x.double(), proj.double()).abs()
            assert (products[flipped] < SIGN_MARGIN).all(), products[flipped]
            flips += int(flipped.sum())
            rows |= set(flipped.reshape(flipped.shape[0], -1).any(dim=-1).nonzero()[:, 0].tolist())
    return rows, flips


@pytest.mark.cuda
def test_hashing_ops_on_card_match_cpu(card):
    """SimHash bits, bucket ids, Hamming similarities and the top-k picks
    (integer scores: ties everywhere, an empty row) equal the CPU's where
    every product lies beyond ``SIGN_MARGIN`` (asserted on the CPU);
    ``lsh_attention`` and ``sketch_pool`` to ``TOL``."""
    from tpurec_torch.ops import hashing

    rng = np.random.default_rng(21)
    x = rng.normal(size=(64, 40, 16)).astype(np.float32)
    proj = rng.normal(size=(16, 12)).astype(np.float32)
    groups = rng.normal(size=(4, 16, 3)).astype(np.float32)
    mask = (rng.random((64, 40)) < 0.7).astype(np.float32)
    mask[0] = 0.0
    products = np.abs(np.einsum("bld,dn->bln", x.astype(np.float64), proj))
    assert products.min() > SIGN_MARGIN
    assert np.abs(np.einsum("bld,gdn->bgln", x.astype(np.float64), groups)).min() > SIGN_MARGIN
    cpu = [torch.tensor(a) for a in (x, proj, groups, mask)]
    dev = [t.to(card) for t in cpu]
    for fn in (hashing.simhash_bits, hashing.lsh_bucket_ids):
        assert torch.equal(fn(dev[0], dev[1]).cpu(), fn(cpu[0], cpu[1]))
    bits = [hashing.simhash_bits(t[0], t[1]) for t in (dev, cpu)]
    sim = [hashing.hamming_similarity(b[:, 0], b) for b in bits]
    assert torch.equal(sim[0].cpu(), sim[1])
    for k in (1, 5, 16, 40):
        got = hashing.topk_select(sim[0].float(), dev[3], k)
        want = hashing.topk_select(sim[1].float(), cpu[3], k)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), k
    torch.testing.assert_close(hashing.lsh_attention(dev[0], dev[0], dev[1][:, :4], dev[3]).cpu(),
                               hashing.lsh_attention(cpu[0], cpu[0], cpu[1][:, :4], cpu[3]), **TOL)
    torch.testing.assert_close(hashing.sketch_pool(dev[0], dev[3], dev[2], dev[0][:, 0]).cpu(),
                               hashing.sketch_pool(cpu[0], cpu[3], cpu[2], cpu[0][:, 0]), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [152, 56])
def test_fused_scatter_add_at_the_co_action_widths(card, d):
    """#9 at CAN's induction-table widths (4·D + 24 at D = 32 and 8) on a
    fused step's stream (B = 2048 rows of 3 profile ids, 2 query ids and two
    64-step series over DIN's 21,504 rows, sequences column-major, a share
    padded with id 0): within the limit of ``scatter_add_plain``, two calls
    the same bits, and a version that loses what runs carry past a slice
    above the limit."""
    from tpurec_torch.ops import embedding_update as eu

    rng = np.random.default_rng(5)
    b, l, v = 2048, 64, 21_504
    cols = [rng.integers(1, v, size=b) for _ in range(5)]
    for _ in range(2):
        series = np.where(rng.random((b, l)) < 0.3, 0, rng.integers(1, v, size=(b, l)))
        cols.append(series.T.reshape(-1))
    plan = eu.make_scatter_plan(torch.as_tensor(np.concatenate(cols), device=card), v)
    grads = torch.randn(plan.n, d, device=card, generator=torch.Generator(card).manual_seed(5))
    got = eu.fused_scatter_add(v, d, plan, grads)
    again = eu.fused_scatter_add(v, d, plan, grads)
    assert got.shape == (v, d) and torch.equal(got, again)
    assert _sum_reading(got, plan, grads) <= 1.0
    rows = eu.scatter_slice_rows(d)
    start = torch.searchsorted(plan.sids, plan.sids)
    keep = torch.arange(plan.n, device=card) // rows == start // rows
    assert not keep.all()
    dropped = eu.scatter_add_plain(v, plan.sids[keep], grads[keep])
    assert _sum_reading(dropped, plan, grads) > 1.0


LONG_SEQ_CARD_MODELS = [
    ("sim", {"topk": 5}, 0), ("sim", {"topk": 5, "use_dien_trunk": True}, 1),
    ("can", {}, 0), ("can", {"use_dien_trunk": True}, 1),
    ("eta", {"topk": 5, "short_len": 4}, 0),
    ("eta", {"topk": 5, "short_len": 4, "lsh_self_attention": True}, 0),
    ("dmr", {}, 0), ("dmt", {}, 0), ("dmt", {"bias_features": ["user_tag"]}, 0),
    ("finalmlp", {}, 0), ("sdim", {"n_hash_bits": 3, "short_len": 5}, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,params,attentions", LONG_SEQ_CARD_MODELS)
def test_long_seq_model_on_card_matches_cpu(card, name, params, attentions):
    """SIM, CAN (each with and without the DIEN trunk), ETA (with and
    without the LSH self-attention), DMR, DMT, FinalMLP and SDIM (fp32, eval
    mode) on the card against the same weights on the CPU: every SimHash bit
    equal to the CPU's unless its product lies within ``SIGN_MARGIN`` of 0
    (``_flipped_rows``), and on every row without such a flip every output
    to ``TOL``, ``topk_indices`` exactly; the DIEN trunk launches #4 once."""
    from tpurec_torch.config import EmbeddingConfig, ModelConfig
    from tpurec_torch.models import build_model
    from tpurec_torch.ops import embedding_update as eu
    from tpurec_torch.ops import kernels

    if name == "finalmlp":
        info, batch = _multitask_schema(np.random.default_rng(9))
    else:
        info, batch = _sequence_schema(np.random.default_rng(9))
    batch.pop("label")
    config = ModelConfig(name=name, params=params, embedding=EmbeddingConfig(dim=8))
    on_card = build_model(config, info, device=card).eval()
    on_cpu = build_model(config, info, device="cpu").eval()
    on_cpu.load_state_dict({k: v.cpu() for k, v in on_card.state_dict().items()})
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got, card_bits = _recorded_bits(
            lambda: on_card({k: torch.as_tensor(v, device=card) for k, v in batch.items()}))
        want, cpu_bits = _recorded_bits(lambda: on_cpu({k: torch.as_tensor(v) for k, v in batch.items()}))
    torch.cuda.synchronize()
    assert kernels.din_attention_fused.launches == attentions and eu.fused_scatter_add.launches == 0
    assert bool(cpu_bits) == (name in ("eta", "sdim"))
    flipped, _ = _flipped_rows(card_bits, cpu_bits)
    keep = torch.tensor([r not in flipped for r in range(next(iter(batch.values())).shape[0])])
    assert keep.sum() >= keep.numel() - 2, sorted(flipped)
    assert set(got) == set(want)
    for key in want:
        g, w = got[key].cpu()[keep], want[key][keep]
        if key == "topk_indices":
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g, w, **TOL, msg=lambda m, k=key: f"{k}: {m}")


@pytest.mark.cuda
def test_can_fused_step_on_card_matches_cpu(card):
    """Three fp32 CAN steps (``gsu_esu``) in the fused engine on the card
    (#9 once per table a step: ``emb`` and the two induction tables, 56
    wide at D = 8) against the same steps on the CPU: the loss of each
    (1e-5) and the tables after them (2e-6)."""
    from tpurec_torch.config import ExperimentConfig
    from tpurec_torch.ops import embedding_update as eu
    from tpurec_torch.train.trainer import Trainer

    info, _ = _sequence_schema(np.random.default_rng(0))
    config = ExperimentConfig.from_dict(dict(
        model=dict(name="can", embedding=dict(dim=8)),
        train=dict(compute_dtype="float32", log_every_steps=0, loss="gsu_esu", sparse_embedding=True,
                   optimizer=dict(embedding_optimizer="fused_adam")),
    ))
    trainers = [Trainer(config, info, device=card), Trainer(config, info, device="cpu")]
    first = _sequence_schema(np.random.default_rng(10), 256)[1]
    states = [t.init_state(first) for t in trainers]
    states[1].model.load_state_dict({k: v.cpu() for k, v in states[0].model.state_dict().items()})
    before = eu.fused_scatter_add.launches
    for i in range(3):
        batch = _sequence_schema(np.random.default_rng(10 + i), 256)[1]
        losses = []
        for j, (t, s) in enumerate(zip(trainers, states)):
            states[j], _, logs = t.train_step(s, t.device_batch(batch), t.metrics.init())
            losses.append(float(logs["loss"]))
        assert abs(losses[0] - losses[1]) <= 1e-5, losses
    torch.cuda.synchronize()
    assert eu.fused_scatter_add.launches - before == 9
    for name in ("emb.embedding", "induction_emb_item_id.embedding", "induction_emb_item_tag.embedding"):
        got = states[0].model.get_parameter(name).detach().cpu()[:-1]
        want = states[1].model.get_parameter(name).detach()[:-1]
        torch.testing.assert_close(got, want, atol=2e-6, rtol=0, msg=lambda m, n=name: f"{n}: {m}")


# --------------------------------------------------------------------------
# the building blocks' options (``chip_smoke.py`` phase 17 at a small size):
# built on the CPU from a seed, run on the card with its dropout masks drawn
# from a CUDA generator and recorded, then on the CPU with the same masks.
# fp32 outputs and input gradients at atol 1e-5, rtol 1e-4 (TF32 off; sums
# in other orders); bf16 to 2^-5 of each one's largest |value|.
BLOCK_MLP_CASES = {
    "sigmoid": (dict(activation="sigmoid"), True),
    "tanh": (dict(activation="tanh"), True),
    "gelu": (dict(activation="gelu"), True),
    "softmax": (dict(out_activation="softmax"), True),
    "bn_train": (dict(use_bn=True), True),
    "bn_eval": (dict(use_bn=True), False),
    "ln": (dict(use_ln=True), True),
    "dropout": (dict(dropout_rate=0.1), True),
}


def _blocks_on_card_and_cpu(card, module, x, g, train):
    """(card output, input gradient, buffers), (CPU ...), the masks drawn."""
    import copy

    from tpurec_torch.ops import mlp as tmlp

    on_card = copy.deepcopy(module).to(card).train(train)
    module.train(train)
    masks, draw = [], tmlp.Dropout.keep_mask

    def record(self, *args, **kwargs):
        masks.append(draw(self, *args, **kwargs))
        return masks[-1]

    xc = x.detach().to(card).clone().requires_grad_()
    with pytest.MonkeyPatch.context() as mp, \
            tmlp.dropout_generator(on_card, torch.Generator(device=card).manual_seed(3)):
        mp.setattr(tmlp.Dropout, "keep_mask", record)
        out = on_card(xc)
    out.backward(g.to(card))
    queue = [m.cpu() for m in masks]
    xh = x.detach().clone().requires_grad_()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmlp.Dropout, "keep_mask", lambda self, shape, device, columns=None: queue.pop(0))
        want = module(xh)
    want.backward(g)
    assert not queue
    got = (out.detach().cpu(), xc.grad.cpu(), [b.cpu() for b in on_card.buffers()])
    return got, (want.detach(), xh.grad, list(module.buffers())), len(masks)


def _assert_blocks(got, want, bf16):
    for a, b in zip([got[0], got[1], *got[2]], [want[0], want[1], *want[2]]):
        a, b = a.float().numpy(), b.float().numpy()
        if bf16:
            np.testing.assert_allclose(a, b, atol=2.0**-5 * np.abs(b).max(), rtol=0)
        else:
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(BLOCK_MLP_CASES))
def test_mlp_options_on_card_match_cpu(card, case, dtype):
    """The MLP's activations, BatchNorm (training, with its running
    statistics, and eval with redrawn ones), LayerNorm and dropout on the
    card against the CPU port, 64 rows of 24 through (16, 8)."""
    from tpurec_torch.initializers import init_parameters
    from tpurec_torch.ops.mlp import MLP

    kw, train = BLOCK_MLP_CASES[case]
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(64, 24, generator=gen).to(dt)
    g = torch.randn(64, 8, generator=gen).to(dt)
    mlp = init_parameters(MLP(24, (16, 8), dtype=dt, **kw), seed=2)
    if kw.get("use_bn"):
        mlp.bn_0.running_mean.normal_(0.0, 0.5, generator=gen)
        mlp.bn_0.running_var.uniform_(0.5, 1.5, generator=gen)
    got, want, masks = _blocks_on_card_and_cpu(card, mlp, x, g, train)
    assert masks == (1 if kw.get("dropout_rate") else 0)
    _assert_blocks(got, want, dtype == "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_head_attention_options_on_card_match_cpu(card, dtype):
    """``MultiHeadAttention(out_dim=32, use_layer_norm=False, dropout 0.1)``
    at AutoInt's D=16, 2 heads of 32, over 39 fields of 32 rows in training
    mode, on the card against the CPU port (the residual dropped)."""
    from tpurec_torch.initializers import init_parameters
    from tpurec_torch.ops.attention import MultiHeadAttention

    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(4)
    q = torch.randn(32, 39, 16, generator=gen).to(dt)
    g = torch.randn(32, 39, 32, generator=gen).to(dt)
    mha = init_parameters(MultiHeadAttention(16, 2, 32, dtype=dt, out_dim=32, use_layer_norm=False,
                                             dropout_rate=0.1), seed=5)
    assert not mha.residual and mha.ln is None
    got, want, masks = _blocks_on_card_and_cpu(card, mha, q, g, True)
    assert masks == 1 and tuple(got[0].shape) == (32, 39, 32)
    _assert_blocks(got, want, dtype == "bfloat16")


@pytest.mark.cuda
def test_dropout_draw_on_card(card):
    """Dropout's draw on the card: the keep count of 10^6 within 6σ of the
    binomial's mean, the same generator state the same mask, and
    ``apply_dropout_mask`` and its gradient equal to the CPU's, fp32 and
    bf16; training without a generator raises."""
    from tpurec_torch.ops.mlp import Dropout, apply_dropout_mask, dropout_generator

    drop = Dropout(0.1)
    gen = torch.Generator(device=card).manual_seed(6)
    with dropout_generator(drop, gen):
        state = gen.get_state()
        keep = drop.keep_mask((1000, 1000), card)
        gen.set_state(state)
        assert torch.equal(keep, drop.keep_mask((1000, 1000), card))
    assert abs(int(keep.sum()) - 0.9e6) < 6.0 * np.sqrt(1e6 * 0.9 * 0.1)
    x = torch.randn(1000, 1000, device=card, generator=gen)
    for dt in (torch.float32, torch.bfloat16):
        xc = x.to(dt).clone().requires_grad_()
        xh = x.to(dt).cpu().clone().requires_grad_()
        yc, yh = apply_dropout_mask(xc, keep, 0.1), apply_dropout_mask(xh, keep.cpu(), 0.1)
        yc.sum().backward()
        yh.sum().backward()
        assert torch.equal(yc.detach().cpu(), yh.detach()) and torch.equal(xc.grad.cpu(), xh.grad)
    with pytest.raises(RuntimeError, match="needs a generator"):
        drop.train()(x)


# --------------------------------------------------------------------------
# the mesh on the card: two ranks share cuda:0 over gloo, which reduces
# CUDA tensors through the host (NCCL allows one rank of a communicator on a
# device). The ranks are processes of this file (``tests/test_torch_mesh.py``'s
# ``run_world``); ``din_attention_cp`` runs #4 and #5 on each rank's half of
# the steps and is held, with every gradient, to the one-device plain
# version in fp64 (atol/rtol 1e-4; the weights' gradients to 1e-4 of their
# largest value: sums over B·L steps).
CP_CARD_SHAPE = (256, 128, 32, 36)


def _card_mesh_world(inputs):
    import torch.distributed as dist

    from tpurec_torch.config import MeshConfig
    from tpurec_torch.core.collectives import pmax, psum, replicated_input
    from tpurec_torch.core.mesh import make_mesh
    from tpurec_torch.ops import kernels
    from tpurec_torch.ops.attention_cp import din_attention_cp

    torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    mesh = make_mesh(MeshConfig(data=1, model=2))
    group = mesh.model_group
    x = torch.full((3,), float(rank + 1), device="cuda", requires_grad=True)
    c = torch.tensor([1.0, 2.0, 3.0], device="cuda")
    y = psum(x, group)
    (y * c).sum().backward()
    z = torch.full((3,), 2.0, device="cuda", requires_grad=True)
    (replicated_input(z, group) * (rank + 1)).sum().backward()
    out = {"psum": y.detach().cpu().numpy(), "psum_grad": x.grad.cpu().numpy(),
           "replicated_grad": z.grad.cpu().numpy(),
           "max": pmax(torch.tensor([float(rank), -float(rank)], device="cuda"), group).cpu().numpy()}

    b, l, d, h = CP_CARD_SHAPE
    q, keys, mask, w1, b1, w2, alpha = _din_args(torch.device("cuda"), b, l, d, h, True, seed=3,
                                                holes=True)
    rng = np.random.default_rng(4)
    cot_p = torch.as_tensor(rng.normal(size=(b, d)), dtype=torch.float32, device="cuda")
    cot_s = torch.as_tensor(rng.normal(size=(b, l)), dtype=torch.float32, device="cuda")
    steps = slice(rank * l // 2, (rank + 1) * l // 2)
    leaves = [t.clone().requires_grad_() for t in (q, w1, b1, w2, alpha)]
    k_loc = keys[:, steps].contiguous().requires_grad_()
    kernels.reset_launch_counts()
    pooled, scores = din_attention_cp(leaves[0], k_loc, mask[:, steps].contiguous(), *leaves[1:],
                                      mesh)
    ((pooled * cot_p).sum() + (scores * cot_s[:, steps]).sum()).backward()
    torch.cuda.synchronize()
    out["launches"] = (kernels.din_attention_fused.launches, kernels.din_attention_bwd_fused.launches)
    args64 = [t.double().requires_grad_() for t in (q, keys, w1, b1, w2, alpha)]
    wp, ws = kernels.din_attention_plain(args64[0], args64[1], mask.double(), *args64[2:])
    loss = (wp * cot_p.double()).sum() + (ws * cot_s.double()).sum()
    grads = torch.autograd.grad(loss, args64)
    got = [pooled, scores, leaves[0].grad, k_loc.grad] + [t.grad for t in leaves[1:]]
    want = [wp, ws[:, steps], grads[0], grads[1][:, steps]] + list(grads[2:])
    out["cp"] = [(g.detach().double().cpu().numpy(), w.detach().cpu().numpy()) for g, w in zip(got, want)]
    out["tp_din"] = _card_tp_din_step(mesh)
    return out


def _card_tp_din_step(mesh):
    """One fp32 DIN step with its ``mlp`` tensor parallel over ``mesh``'s
    model = 2 on cuda:0, and the same step on one device from the same
    seed: both losses, both parameter sets (whole), #4/#5 launches."""
    from tpurec_torch.config import EmbeddingConfig, ExperimentConfig, ModelConfig, TrainConfig
    from tpurec_torch.core.mesh import MeshContext
    from tpurec_torch.dryrun import tiny_dataset
    from tpurec_torch.models.registry import sharded_weights
    from tpurec_torch.ops import kernels
    from tpurec_torch.train.trainer import Trainer, whole_tensors

    info, batch = tiny_dataset(batch=64)
    cfg = ExperimentConfig(
        model=ModelConfig(name="din", embedding=EmbeddingConfig(dim=8, used_id_l2=1e-6)),
        train=TrainConfig(compute_dtype="float32", log_every_steps=0),
    )
    out = {}
    for key, ctx in (("tp", mesh), ("one", MeshContext())):
        trainer = Trainer(cfg, info, device="cuda", mesh_ctx=ctx)
        state = trainer.init_state()
        kernels.reset_launch_counts()
        state, _, logs = trainer.train_step(state, trainer.device_batch(batch), trainer.metrics.init())
        torch.cuda.synchronize()
        params = {n: t.cpu().numpy() for n, t in whole_tensors(state.model).items()}
        out[key] = {"loss": float(logs["loss"]), "params": params,
                    "shards": sorted(sharded_weights(state.model)),
                    "launches": (kernels.din_attention_fused.launches,
                                 kernels.din_attention_bwd_fused.launches)}
    return out


@pytest.fixture(scope="module")
def card_mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import os

    from test_torch_mesh import run_world, shared_world

    return shared_world(tmp_path_factory, "torch_cuda_mesh",
                        lambda d: run_world(os.path.abspath(__file__), "card2", 2, d, {}))


@pytest.mark.cuda
def test_psum_over_gloo_on_cuda_tensors(card, card_mesh):
    """The sum over two ranks on cuda:0 and its identity backward (twice the
    cotangent if it all-reduced), ``replicated_input``'s summed backward and
    ``pmax``, on CUDA tensors over gloo."""
    for res in card_mesh:
        np.testing.assert_array_equal(res["psum"], np.full(3, 3.0))
        np.testing.assert_array_equal(res["psum_grad"], [1.0, 2.0, 3.0])
        np.testing.assert_array_equal(res["replicated_grad"], np.full(3, 3.0))
        np.testing.assert_array_equal(res["max"], [1.0, 0.0])


@pytest.mark.cuda
def test_din_attention_cp_on_card_matches_plain(card, card_mesh):
    """``din_attention_cp`` over model = 2 with #4 and #5 on each rank's
    half of the steps (a mask with holes, an all-zero row): pooled, the
    rank's scores and every gradient against the one-device plain version
    in fp64."""
    names = ("pooled", "scores", "dq", "dkeys", "dw1", "db1", "dw2", "dalpha")
    for res in card_mesh:
        assert res["launches"] == (1, 1)
        for name, (got, want) in zip(names, res["cp"]):
            if name in ("dw1", "db1", "dw2", "dalpha"):
                np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0,
                                           err_msg=name)
            else:
                np.testing.assert_allclose(got, want, **TOL, err_msg=name)


@pytest.mark.cuda
def test_tensor_parallel_din_step_on_card_matches_one_device(card, card_mesh):
    """DIN with its ``mlp`` tensor parallel over two ranks on cuda:0 (gloo):
    ``dense_0`` and ``dense_1`` split, #4 and #5 once in the step; one fp32
    step from the same seed against one device: the loss (rtol 2e-4, atol
    2e-5) and every parameter, gathered (rtol 5e-3, atol 5e-5: the CPU
    mesh tests' tolerances; the row layer sums two partial products)."""
    for res in card_mesh:
        tp, one = res["tp_din"]["tp"], res["tp_din"]["one"]
        assert tp["shards"] == ["mlp.dense_0.bias", "mlp.dense_0.weight", "mlp.dense_1.weight"]
        assert tp["launches"] == one["launches"] == (1, 1)
        np.testing.assert_allclose(tp["loss"], one["loss"], rtol=2e-4, atol=2e-5)
        assert set(tp["params"]) == set(one["params"])
        for n, want in one["params"].items():
            got = tp["params"][n][: want.shape[0]]
            np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-5, err_msg=n)


if __name__ == "__main__":
    from test_torch_mesh import rank_main

    rank_main({"card2": _card_mesh_world})


@pytest.mark.cuda
def test_trace_counts_syncs_and_times_the_feed_on_the_card(card):
    """The port's tracing on the card: the sync counter sees a ``.item()``,
    reads 0 over dense DIN steps (bf16, through both DIN kernels), and
    ``device_batch`` pins and copies in its own spans."""
    from tpurec_torch.config import EmbeddingConfig, ExperimentConfig, ModelConfig, TrainConfig
    from tpurec_torch.core import trace
    from tpurec_torch.train.trainer import Trainer

    rec = trace.start()
    try:
        with trace.span("item"):
            torch.ones(1, device=card).item()
    finally:
        trace.stop()
    assert rec.named("item")[0].syncs == 1

    info, batch = _small_din(np.random.default_rng(2))
    batch["label"] = np.random.default_rng(3).integers(0, 2, size=(64,)).astype(np.float32)
    config = ExperimentConfig(
        model=ModelConfig(name="din", embedding=EmbeddingConfig(dim=32)),
        train=TrainConfig(compute_dtype="bfloat16", log_every_steps=0),
    )
    trainer = Trainer(config, info, device=card)
    state, metric_state = trainer.init_state(), trainer.metrics.init()
    state, metric_state, _ = trainer.train_step(state, trainer.device_batch(batch), metric_state)
    torch.cuda.synchronize()
    rec = trace.start()
    try:
        for _ in range(3):
            state, metric_state, _ = trainer.train_step(state, trainer.device_batch(batch), metric_state)
    finally:
        trace.stop()
    torch.cuda.synchronize()
    assert sum(s.syncs for s in rec.spans) + rec.loose_syncs == 0
    for k in range(3):
        feed = [(s.name, s.parent.name if s.parent else None) for s in rec.spans
                if s.step == k and s.name.startswith("feed")]
        assert feed == [("feed", None), ("feed.pin", "feed"), ("feed.copy", "feed")]


# --------------------------------------------------------------------------
# the optimizer chain's kernel (adam_update.cu) against its foreach twin

def _ulps(got, want):
    """Element-wise distance in fp32 ulps (a step between adjacent floats;
    -0 and +0 are one value)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(2**31) - i, i)

    return (ordered(got) - ordered(want)).abs()


# the lists the chain's kernel is held on: a scalar, odd and large lengths,
# tables with a coefficient a row (R) and L2 (L), and views off a 16-byte
# boundary ("view": every array one element past it, so the kernel takes a
# head of three elements; "skew": only the parameter off it, so every
# element is a 4-byte load)
_CHAIN_TENSORS = [((1,), ""), ((3,), ""), ((4097,), "L"), ((2_000_003,), ""), ((1000, 11), "LR"),
                  ((7, 5), "R"), ((1001,), "view"), ((1001,), "skew")]


def _chain_array(card, a, how="", which=""):
    """``a`` on the card; one element past a 16-byte boundary where ``how``
    puts array ``which`` there."""
    t = torch.as_tensor(a, dtype=torch.float32, device=card)
    if how == "view" or (how == "skew" and which == "p"):
        base = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        base[1:] = t.reshape(-1)
        t = base[1:].view(t.shape)
    return t


def _chain_lists(card, sgd):
    rng = np.random.default_rng(6)
    out = dict(p=[], m=[], v=[], l2=[], coef=[])
    for shape, how in _CHAIN_TENSORS:
        out["p"].append(_chain_array(card, 0.05 * rng.standard_normal(shape), how, "p"))
        out["m"].append(None if sgd else _chain_array(card, 0.01 * rng.standard_normal(shape), how))
        out["v"].append(None if sgd else _chain_array(card, np.abs(1e-4 * rng.standard_normal(shape)), how))
        out["l2"].append(3e-3 if "L" in how else None)
        out["coef"].append(
            _chain_array(card, np.abs(1e-2 * rng.standard_normal((shape[0], 1)))) if "R" in how else None
        )
    return out


def _chain_grads(card, rng, step):
    return [_chain_array(card, (1.0 + step) * rng.standard_normal(shape), how, "g")
            for shape, how in _CHAIN_TENSORS]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
@pytest.mark.parametrize("clip", ["off", "keep", "scale"])
@pytest.mark.parametrize("terms", [False, True])
def test_adam_update_kernel_matches_the_foreach_chain(card, name, clip, terms):
    """Three steps of the chain's kernel against its plain twin (PyTorch's
    foreach ops) on the card from the same state and gradients: every
    element of the parameters and both moments within 4 fp32 ulps (the
    kernel rounds each operation as the foreach chain does). The clip off,
    on with norm < clip (kept) and with norm ≥ clip (scaled); with
    ``terms`` the coupled L2 and the row coefficients. One launch a step."""
    from tpurec_torch.ops import kernels

    sgd = name == "sgd"
    rng = np.random.default_rng(5)
    sides = [_chain_lists(card, sgd) for _ in range(3)]  # kernel, plain, the state before
    before = kernels.adam_update_fused.launches
    for step in range(1, 4):
        grads = _chain_grads(card, rng, step)
        norm, limit = None, 0.0
        if clip != "off":
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            limit = float(norm) * (2.0 if clip == "keep" else 0.5)
        hp = dict(lr=1e-3 * step, bc1=1.0 - 0.9**step, bc2=1.0 - 0.999**step, b1=0.9, b2=0.999,
                  eps=1e-7, weight_decay=1e-2 if name == "adamw" else 0.0, norm=norm, clip=limit)
        for fn, s in zip((kernels.adam_update_fused, kernels.adam_update_plain), sides[:2]):
            fn(s["p"], grads, None if sgd else s["m"], None if sgd else s["v"],
               l2=s["l2"] if terms else None, row_coef=s["coef"] if terms else None, **hp)
    torch.cuda.synchronize()
    assert kernels.adam_update_fused.launches - before == 3
    for key in ("p",) if sgd else ("p", "m", "v"):
        for i, (got, want, was) in enumerate(zip(*(side[key] for side in sides))):
            assert not torch.equal(got, was)
            worst = int(_ulps(got, want).max())
            assert worst <= 4, f"{key}[{i}] {_CHAIN_TENSORS[i]}: {worst} ulps"


@pytest.mark.cuda
def test_adam_update_kernel_cuts_a_long_list_into_launches(card):
    """A list longer than one launch takes (``adam_update_max_tensors()``)
    runs in launches of that many, and every tensor is updated as the plain
    twin updates it."""
    from tpurec_torch.ops import kernels

    per_launch = kernels._library("adam_update").adam_update_max_tensors()
    n = 2 * per_launch + 3
    rng = np.random.default_rng(7)
    state = [torch.as_tensor(rng.standard_normal((n, 33)), dtype=torch.float32, device=card)
             for _ in range(4)]
    state[3] = state[3].abs()
    sides = [[list(t.clone().unbind(0)) for t in state] for _ in range(2)]
    hp = dict(lr=1e-3, bc1=0.1, bc2=1.0 - 0.999, b1=0.9, b2=0.999, eps=1e-7)
    before = kernels.adam_update_fused.launches
    kernels.adam_update_fused(sides[0][0], sides[0][1], sides[0][2], sides[0][3], **hp)
    kernels.adam_update_plain(sides[1][0], sides[1][1], sides[1][2], sides[1][3], **hp)
    torch.cuda.synchronize()
    assert kernels.adam_update_fused.launches - before == 3
    for k in (0, 2, 3):
        for got, want in zip(sides[0][k], sides[1][k]):
            assert int(_ulps(got, want).max()) <= 4


@pytest.mark.cuda
def test_adam_update_kernel_launches_from_its_kept_table(card):
    """With a ``cache`` the wrapper builds its descriptor table once and
    launches from it while every address is the same, gives the bits of a
    call without one, rebuilds the table when a gradient moves, and checks
    a tensor it has not seen at that address."""
    from tpurec_torch.ops import kernels

    rng = np.random.default_rng(10)
    lists = _chain_lists(card, False)
    sides = [{k: [t.clone() for t in lists[k]] for k in ("p", "m", "v")} for _ in range(2)]
    grads = _chain_grads(card, rng, 1)
    hp = dict(lr=1e-3, bc1=0.1, bc2=1.0 - 0.999, b1=0.9, b2=0.999, eps=1e-7, l2=lists["l2"],
              row_coef=lists["coef"])
    cache = {}
    for step in range(3):
        kernels.adam_update_fused(sides[0]["p"], grads, sides[0]["m"], sides[0]["v"], **hp, cache=cache)
        kernels.adam_update_fused(sides[1]["p"], grads, sides[1]["m"], sides[1]["v"], **hp)
        if step == 0:
            tables = cache["tables"]
        assert cache["tables"] is tables
    moved = [g.clone() for g in grads]
    kernels.adam_update_fused(sides[0]["p"], moved, sides[0]["m"], sides[0]["v"], **hp, cache=cache)
    kernels.adam_update_fused(sides[1]["p"], moved, sides[1]["m"], sides[1]["v"], **hp)
    assert cache["tables"] is not tables
    torch.cuda.synchronize()
    for k in ("p", "m", "v"):
        assert all(torch.equal(a, b) for a, b in zip(sides[0][k], sides[1][k]))
    moved[2] = moved[2].to(torch.bfloat16)
    with pytest.raises(TypeError, match="grads\\[2\\] must be float32"):
        kernels.adam_update_fused(sides[0]["p"], moved, sides[0]["m"], sides[0]["v"], **hp, cache=cache)


@pytest.mark.cuda
def test_adam_update_on_a_table_matches_its_plain_math(card):
    """The fused engine's ``adam_update_`` (the chain's kernel with one
    tensor, fp32 bias corrections) against the plain twin on the same table
    over three steps: within 4 ulps, one launch a step."""
    from tpurec_torch.embedding.sparse import bias_correction
    from tpurec_torch.ops import embedding_update as eu
    from tpurec_torch.ops import kernels

    rng = np.random.default_rng(8)
    state = [torch.as_tensor(a, dtype=torch.float32, device=card) for a in (
        0.05 * rng.standard_normal((4099, 10)), 0.01 * rng.standard_normal((4099, 10)),
        np.abs(1e-4 * rng.standard_normal((4099, 10))))]
    sides = [[t.clone() for t in state] for _ in range(2)]
    before = kernels.adam_update_fused.launches
    for step in range(1, 4):
        g = torch.as_tensor(rng.standard_normal((4099, 10)), dtype=torch.float32, device=card)
        eu.adam_update_(sides[0][0], sides[0][1], sides[0][2], g, step, 1e-3)
        kernels.adam_update_plain([sides[1][0]], [g], [sides[1][1]], [sides[1][2]], lr=1e-3,
                                  bc1=bias_correction(0.9, step), bc2=bias_correction(0.999, step),
                                  b1=0.9, b2=0.999, eps=1e-7)
    torch.cuda.synchronize()
    assert kernels.adam_update_fused.launches - before == 3
    for got, want in zip(*sides):
        assert int(_ulps(got, want).max()) <= 4


@pytest.mark.cuda
def test_chain_optimizer_on_card_launches_the_kernel_once_a_step(card):
    """``ChainOptimizer`` over a small MLP's parameters on the card, fed the
    same gradients as the same optimizer on the CPU (the foreach chain
    there): one launch a step, and the parameters and moments alike to fp32
    rounding."""
    from tpurec_torch.config import OptimizerConfig
    from tpurec_torch.ops import kernels
    from tpurec_torch.train.trainer import ChainOptimizer

    torch.manual_seed(0)
    nets = [torch.nn.Sequential(torch.nn.Linear(37, 64), torch.nn.ReLU(), torch.nn.Linear(64, 1))]
    nets.append(torch.nn.Sequential(torch.nn.Linear(37, 64), torch.nn.ReLU(), torch.nn.Linear(64, 1)))
    nets[1].load_state_dict(nets[0].state_dict())
    nets[0].to(card)
    config = OptimizerConfig(name="adamw", learning_rate=1e-2, weight_decay=1e-3, grad_clip_norm=0.5)
    opts = [ChainOptimizer(list(n.named_parameters()), config, {}, {}) for n in nets]
    rng = np.random.default_rng(9)
    before = kernels.adam_update_fused.launches
    for _ in range(3):
        grads = [rng.standard_normal(tuple(p.shape)) for p in nets[1].parameters()]
        for net, opt in zip(nets, opts):
            for p, g in zip(net.parameters(), grads):
                p.grad = torch.as_tensor(g, dtype=torch.float32, device=p.device)
            opt.step()
    torch.cuda.synchronize()
    assert kernels.adam_update_fused.launches - before == 3
    for (name, got), want in zip(nets[0].named_parameters(), nets[1].parameters()):
        torch.testing.assert_close(got.detach().cpu(), want.detach(), atol=1e-6, rtol=1e-5, msg=name)
        for key in ("mu", "nu"):
            torch.testing.assert_close(opts[0].state[got][key].cpu(), opts[1].state[want][key],
                                       atol=1e-7, rtol=1e-5, msg=name)
