"""The port's CUDA and Triton kernels against their plain versions, on the
card. Every test here is marked ``cuda`` and skips where there is no GPU.
The file imports no JAX, so on a machine without it run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: fp32 on both sides with TF32 off; the kernels sum in another
order than the plain versions, so values of O(1)-O(10) agree to ~1e-5
relative: atol/rtol 1e-4.
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


def _din_args(card, b, l, d, h, with_alpha, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, l + 1, size=(b,))
    mask = (np.arange(l)[None, :] < lengths[:, None]).astype(np.float32)
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
    "b,l,d,h,with_alpha",
    [(256, 64, 32, 36, True), (256, 64, 32, 36, False), (37, 200, 16, 7, True),
     (9, 5, 8, 80, True), (64, 33, 64, 36, True)],
)
def test_din_attention_kernel_matches_plain(card, b, l, d, h, with_alpha):
    from tpurec_torch.ops import kernels

    args = _din_args(card, b, l, d, h, with_alpha)
    before = kernels.din_attention_fused.launches
    pooled, scores = kernels.din_attention_fused(*args)
    torch.cuda.synchronize()
    assert kernels.din_attention_fused.launches == before + 1
    ref_p, ref_s = kernels.din_attention_plain(*args)
    torch.testing.assert_close(pooled, ref_p, **TOL)
    torch.testing.assert_close(scores, ref_s, **TOL)


@pytest.mark.cuda
def test_din_attention_kernel_rejects_what_it_does_not_take(card):
    from tpurec_torch.ops import kernels

    args = _din_args(card, 4, 8, 12, 5, True)  # D=12 is not built
    with pytest.raises(ValueError):
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
    with pytest.raises(ValueError, match="shared"):
        kernels.din_attention_bwd_fused(
            *_din_args(card, 2, 4096, 8, 5, True), *cotangents(2, 4096, 8)
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
    "b,l,d,h,with_alpha",
    [(1024, 64, 32, 36, True), (1024, 64, 32, 36, False), (1003, 64, 32, 36, True),
     (37, 200, 16, 7, True), (9, 1, 8, 80, True), (64, 33, 64, 36, False), (3, 5, 8, 1, True)],
)
def test_din_attention_bwd_kernel_matches_plain(card, b, l, d, h, with_alpha):
    from tpurec_torch.ops import kernels

    args = _din_args(card, b, l, d, h, True)
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
