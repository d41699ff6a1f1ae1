"""The port's CUDA and Triton kernels against their plain versions, on the
card. Every test here is marked ``cuda`` and skips where there is no GPU.
The file imports no JAX, so on a machine without it run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: fp32 on both sides with TF32 off; the kernels sum in another
order than the plain versions, so values of O(1)-O(10) agree to ~1e-5
relative: atol/rtol 1e-4. The aggregated embedding gradient (kernel #9) is
held row by row to 2^-20 (16 fp32 ulps) of the sum of its rows' magnitudes
plus 1e-7: a run of ~10^5 rows sums to 10^2-10^3 in either order. Gathered
rows (kernel #10) are copies: exact.
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


# --------------------------------------------------------------------------
# the sorted-stream embedding kernels (#9, #10)
SUM_RTOL, SUM_ATOL = 2.0**-20, 1e-7


def _sorted_stream(card, n, v, d, skew=0.0, seed=0):
    """A plan over n ids in [0, v) (a share ``skew`` of them id 0) and fp32
    gradients in id order."""
    from tpurec_torch.ops import embedding_update as eu

    gen = torch.Generator(card).manual_seed(seed)
    ids = torch.randint(0, v, (n,), device=card, generator=gen)
    ids = torch.where(torch.rand(n, device=card, generator=gen) < skew, 0, ids)
    plan = eu.make_scatter_plan(ids, v)
    return plan, torch.randn(n, d, device=card, generator=gen)


def _sum_reading(got, plan, grads):
    from tpurec_torch.ops import embedding_update as eu

    want = eu.scatter_add_plain(plan.num_rows, plan.sids, grads)
    scale = eu.scatter_add_plain(plan.num_rows, plan.sids, grads.abs())
    return float(((got - want).abs() / (SUM_ATOL + SUM_RTOL * scale)).max())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,v,d,skew",
    [(50_000, 400_000, 32, 0.0), (50_000, 400_000, 1, 0.0), (60_000, 2_000, 32, 0.36),
     (1003, 300, 8, 0.0), (1003, 300, 64, 0.0), (1003, 300, 160, 0.0), (5000, 300, 4, 1.0),
     (1, 10, 3, 0.0), (0, 10, 8, 0.0)],
)
def test_fused_scatter_add_kernel_matches_plain(card, n, v, d, skew):
    """Every row within its limit of ``scatter_add_plain``; rows no id
    touches exactly 0; two calls the same bits (no float atomics); a version
    that drops what runs carry across slices, or keeps only each id's first
    occurrence, reads above the limit."""
    from tpurec_torch.ops import embedding_update as eu

    plan, grads = _sorted_stream(card, n, v, d, skew)
    before = eu.fused_scatter_add.launches
    got = eu.fused_scatter_add(v, d, plan, grads)
    again = eu.fused_scatter_add(v, d, plan, grads)
    torch.cuda.synchronize()
    assert eu.fused_scatter_add.launches == before + 2
    assert got.shape == (v, d) and torch.equal(got, again)
    if n == 0:
        assert not got.any()
        return
    assert _sum_reading(got, plan, grads) <= 1.0
    touched = torch.zeros(v, dtype=torch.bool, device=card)
    touched[plan.sids.long()] = True
    assert not got[~touched].any()
    if plan.sids.unique().numel() < n:
        first = torch.ones(n, dtype=torch.bool, device=card)
        first[1:] = plan.sids[1:] != plan.sids[:-1]
        keep_first = eu.scatter_add_plain(v, plan.sids[first], grads[first])
        assert _sum_reading(keep_first, plan, grads) > 1.0


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
