"""The port's multi-interest retrieval slice (capsule routing, MIND, ComiRec,
SINE, the diversity path) against the JAX package on the CPU.

Inputs are made with numpy from a seed; weights go from the JAX modules and
models through ``tpurec_torch.bridge``. Tolerances:

- the routing init: within 4 fp32 ulp of ``jax.random.normal`` (XLA's and
  numpy's log1p and sqrt inside the erfinv polynomial round differently);
- the routing kernels' plain versions: rtol 2e-4, atol 1e-5 against
  ``capsule_routing_reference`` and the Pallas kernel in interpret mode
  (``tests/test_pallas.py:236``); their gradients rtol 1e-3, atol 1e-5
  (``tests/test_pallas.py:275``);
- fp32 modules and models: atol/rtol 1e-5 (values O(1));
- bf16 MIND routing outside training: the port runs the kernel route in
  fp32 and casts, where the JAX module on the CPU (no Pallas there) runs its
  own math in bf16. It is held to the JAX kernel run in fp32 (interpret
  mode) and cast to one bf16 rounding (atol 1e-2, rtol 2^-7), and to the JAX
  bf16 module to 2^-5 of the largest |value| (a few bf16 roundings of u and
  z, taken at other places);
- one fp32 train step: ``tests/test_torch_train.py``'s limits (loss 1e-5,
  gradients 1e-4 of their largest value, parameters after Adam 2e-6);
- slates: the same item ids in the same order; scores to 1e-5.
"""

import json
import urllib.request
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from test_torch_train import FP32, _assert_grads, _assert_params, _by_torch_name
from tpurec.config import EmbeddingConfig as JEmbeddingConfig
from tpurec.config import ExperimentConfig as JExperimentConfig
from tpurec.config import ModelConfig as JModelConfig
from tpurec.config import TrainConfig as JTrainConfig
from tpurec.core.mesh import make_mesh
from tpurec.data.schema import DataInfo as JDataInfo
from tpurec.models import build_model as jax_build_model
from tpurec.ops import capsule as jcap
from tpurec.ops.pallas import kernels as jk
from tpurec.ops.pallas.kernels import set_training_phase
from tpurec.serving import OfflineIndexer as JOfflineIndexer
from tpurec.serving import diversity as jdiv
from tpurec.serving.server import RecommendService as JRecommendService
from tpurec.train import Trainer as JTrainer
from tpurec.train.losses import add_auxiliary as jadd_auxiliary
from tpurec_torch.bridge import params_from_jax
from tpurec_torch.config import EmbeddingConfig, ExperimentConfig, ModelConfig
from tpurec_torch.data.schema import DataInfo
from tpurec_torch.initializers import jax_normal
from tpurec_torch.models import build_model
from tpurec_torch.models.mind import sampling_generator
from tpurec_torch.ops import capsule as tcap
from tpurec_torch.ops import kernels as tk
from tpurec_torch.serving import DictKVStore, OfflineIndexer
from tpurec_torch.serving import diversity as tdiv
from tpurec_torch.serving.export import Servable
from tpurec_torch.serving.server import RecommendService, serve_background
from tpurec_torch.train.trainer import Trainer

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
KERNEL_TOL = dict(atol=1e-5, rtol=2e-4)
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)
BF16_ONE_ROUNDING = dict(atol=1e-2, rtol=2.0**-7)
BF16_SCALED_RTOL = 2.0**-5

# the schema of tests/test_models_mind.py
SCHEMA = dict(
    feature_names=["item_id", "user_tag", "item_tag"], feature_dims=[100, 10, 12],
    feature_offsets=[1, 101, 111], total_dims=123, sequence_names=["history"],
    max_seq_length=16, padding_index=0, user_features=["user_tag"],
    item_features=["item_id", "item_tag"],
)
L = 16


def _infos():
    return JDataInfo(**SCHEMA), DataInfo(**SCHEMA)


def _batch(b=6, seed=0):
    rng = np.random.default_rng(seed)
    seq = rng.integers(1, 101, size=(b, L))
    lengths = rng.integers(2, L + 1, size=(b,))
    return {
        "item_id": rng.integers(1, 101, size=(b,)),
        "user_tag": rng.integers(101, 111, size=(b,)),
        "item_tag": rng.integers(111, 123, size=(b,)),
        "history": np.where(np.arange(L)[None, :] < lengths[:, None], seq, 0),
    }


def _numpy_tree(variables):
    variables = {k: v for k, v in fnn.unbox(variables).items() if k != "regularization"}
    return jax.tree.map(np.asarray, variables)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# --------------------------------------------------------------------------
# the routing init
@pytest.mark.parametrize("k,l", [(4, 64), (4, 12), (3, 50), (1, 1), (8, 200)])
def test_routing_init_matches_jax_random_normal(k, l):
    want = np.asarray(jax.random.normal(jax.random.key(7), (1, k, l), jnp.float32))
    got = jax_normal(7, k * l).reshape(1, k, l)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert ulps.max() <= 4, ulps.max()
    routing = tcap.CapsuleRouting(8, k, 8)
    routing.routing_init(l + 5)  # a longer stream first: (1, K, L) is not its slice
    np.testing.assert_array_equal(routing.routing_init(l).numpy(), got)


# --------------------------------------------------------------------------
# kernels #7 and #8: the plain versions against the JAX references and the
# Pallas kernels in interpret mode
def _routing_inputs(b, l, d, e, k, seed=4, empty_row=True):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, l + 1, size=(b,))
    if empty_row:
        lengths[b // 2] = 0  # a row whose mask is all zero
    mask = (np.arange(l)[None, :] < lengths[:, None]).astype(np.float32)
    return [_normal(rng, b, l, d), mask, _normal(rng, d, e, scale=0.5), _normal(rng, b, k, l)]


ROUTING_CASES = [(16, 12, 8, 8, 4, 3), (9, 6, 4, 4, 3, 3), (9, 12, 8, 8, 4, 1),
                 (33, 20, 12, 10, 3, 2), (5, 7, 6, 5, 2, 3)]


@pytest.mark.parametrize("b,l,d,e,k,iters", ROUTING_CASES)
def test_capsule_routing_plain_matches_reference_and_interpret(b, l, d, e, k, iters):
    args = _routing_inputs(b, l, d, e, k)
    got = tk.capsule_routing_plain(*map(torch.from_numpy, args), iters).numpy()
    jargs = tuple(map(jnp.asarray, args))
    assert got.shape == (b, k, e)
    np.testing.assert_allclose(got, np.asarray(jk.capsule_routing_reference(*jargs, iters)), **KERNEL_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jk.capsule_routing_fused(*jargs, iters, interpret=True)), **KERNEL_TOL
    )
    assert not got[b // 2].any()  # an empty row routes to zero capsules


@pytest.mark.parametrize("b,l,d,e,k,iters", ROUTING_CASES)
def test_capsule_routing_bwd_plain_matches_interpret(b, l, d, e, k, iters):
    args = _routing_inputs(b, l, d, e, k)
    g = _normal(np.random.default_rng(5), b, k, e)
    got = tk.capsule_routing_bwd_plain(*map(torch.from_numpy, args), torch.from_numpy(g), iters)
    want = jk.capsule_routing_bwd_fused(*map(jnp.asarray, args), jnp.asarray(g), iters, interpret=True)
    for name, x, y in zip(("dbehavior", "dS", "dlogits0"), got, want):
        assert x.shape == y.shape, name
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("b,iters", [(8, 3), (9, 3), (9, 1)])
def test_capsule_function_gradients_match_jax_grad(b, iters):
    """``CapsuleRouting``'s autograd on the CPU (the plain twins) against
    ``jax.grad`` through the Pallas kernel's custom VJP (interpret mode) and
    through the reference: behavior, S and logits0; none for the mask."""
    beh, mask, s, l0 = _routing_inputs(b, 6, 4, 4, 3, seed=6)

    def jloss(fn):
        return lambda x, ss, ll: jnp.sum(jnp.cos(fn(x, jnp.asarray(mask), ss, ll)))

    jargs = (jnp.asarray(beh), jnp.asarray(s), jnp.asarray(l0))
    fused = jax.grad(jloss(lambda *a: jk.capsule_routing_fused(*a, iters, interpret=True)),
                     argnums=(0, 1, 2))(*jargs)
    ref = jax.grad(jloss(lambda *a: jk.capsule_routing_reference(*a, iters)), argnums=(0, 1, 2))(*jargs)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (beh, s, l0)]
    m = torch.from_numpy(mask).requires_grad_()
    out = tk.CapsuleRouting.apply(leaves[0], m, leaves[1], leaves[2], iters)
    torch.cos(out).sum().backward()
    assert m.grad is None
    for leaf, x, y in zip(leaves, fused, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(x), **GRAD_TOL)
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(y), **GRAD_TOL)


def _holey_routing_inputs(b, l, d, e, k, seed):
    """``chip_smoke.py``'s routing inputs (randn behavior and logits0, S at
    its glorot scale, lengths L/4..L) with holes: every other row's mask is
    random steps, row 0 is all zero and row 1 is live at its last step
    only."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(l // 4, l + 1, size=(b,))
    mask = (np.arange(l)[None, :] < lengths[:, None]).astype(np.float32)
    mask[::2] = (rng.random((len(mask[::2]), l)) < 0.5).astype(np.float32)
    mask[0] = 0.0
    mask[1] = 0.0
    mask[1, -1] = 1.0
    s = _normal(rng, d, e, scale=(2.0 / (d + e)) ** 0.5)
    return [_normal(rng, b, l, d), mask, s, _normal(rng, 1, k, l).repeat(b, axis=0)]


@pytest.mark.parametrize("products", ["fp32", "3xtf32", "1xtf32"])
@pytest.mark.parametrize("b,l,d,e,k,iters", [(256, 64, 64, 64, 4, 3), (33, 50, 48, 40, 3, 3)])
def test_capsule_routing_tf32_products_emulation(b, l, d, e, k, iters, products):
    """The CUDA kernel's arithmetic: the routing with its products in fp32,
    in 3xTF32 (what the kernel's tensor cores compute for u = x·S) and in
    single TF32, against ``capsule_routing_plain`` in units of the card's
    limit (atol = rtol = 1e-4, ``chip_smoke.py``'s ``KERNEL_TOL``). fp32 and
    3xTF32 hold it; single TF32 must miss it (the softmax and the squash
    amplify u's error), so the check can fail. The all-zero row routes to
    zero capsules."""
    args = [torch.from_numpy(a) for a in _holey_routing_inputs(b, l, d, e, k, seed=b)]
    want = tk.capsule_routing_plain(*args, iters)
    got = tk.capsule_routing_products(*args, iters, products=products)
    reading = float(((got - want).abs() / (1e-4 + 1e-4 * want.abs())).max())
    if products == "1xtf32":
        assert reading > 1.0, reading
    else:
        assert reading <= 1.0, reading
        assert not got[0].any()


def _routing_bwd_reading(got, want):
    """``chip_smoke.py``'s ``routing_bwd_reading``: dbehavior and dlogits0
    elementwise at atol = rtol = 1e-4, dS (a sum over B·L rows) at 1e-4 of
    its largest value; at most 1 passes."""
    out = []
    for i, (x, y) in enumerate(zip(got, want)):
        if i == 1:
            out.append(float((x - y).abs().max()) / (1e-4 * float(y.abs().max())))
        else:
            out.append(float(((x - y).abs() / (1e-4 + 1e-4 * y.abs())).max()))
    return max(out)


@pytest.mark.parametrize("products", ["fp32", "3xtf32", "1xtf32"])
@pytest.mark.parametrize("b,l,d,e,k,iters", [(256, 64, 64, 64, 4, 3), (33, 50, 48, 40, 3, 3)])
def test_capsule_routing_bwd_products_emulation(b, l, d, e, k, iters, products):
    """The backward CUDA kernel's arithmetic: its tensor-core products u =
    x·S and dz·Sᵀ in fp32, in 3xTF32 (as the kernel) and in single TF32, against
    ``capsule_routing_bwd_plain`` at the card's limits. fp32 and 3xTF32
    hold them, fp32 also against the Pallas backward in interpret mode;
    single TF32 must miss them, so the check can fail."""
    inputs = _holey_routing_inputs(b, l, d, e, k, seed=b)
    g = _normal(np.random.default_rng(b + 1), b, k, e)
    args = [torch.from_numpy(a) for a in inputs]
    got = tk.capsule_routing_bwd_products(*args, torch.from_numpy(g), iters, products=products)
    reading = _routing_bwd_reading(got, tk.capsule_routing_bwd_plain(*args, torch.from_numpy(g), iters))
    if products == "1xtf32":
        assert reading > 1.0, reading
        return
    assert reading <= 1.0, reading
    if products == "fp32":
        jargs = [jnp.asarray(a) for a in inputs]
        want = jk.capsule_routing_bwd_fused(*jargs, jnp.asarray(g), iters, interpret=True)
        assert _routing_bwd_reading(got, [torch.from_numpy(np.array(w)) for w in want]) <= 1.0


def test_routing_wrappers_take_plain_on_cpu_and_count_nothing():
    args = [torch.from_numpy(a) for a in _routing_inputs(9, 12, 8, 8, 4)]
    g = torch.ones(9, 4, 8)
    tk.reset_launch_counts()
    assert torch.equal(tk.capsule_routing_fused(*args, 2), tk.capsule_routing_plain(*args, 2))
    for x, y in zip(tk.capsule_routing_bwd_fused(*args, g, 2), tk.capsule_routing_bwd_plain(*args, g, 2)):
        assert torch.equal(x, y)
    # a broadcast logits0 (batch stride 0) gives what the materialised one gives
    l0 = args[3][:1].expand(9, 4, 12)
    assert torch.equal(tk.capsule_routing_fused(*args[:3], l0, 2),
                       tk.capsule_routing_fused(*args[:3], l0.contiguous(), 2))
    assert tk.capsule_routing_fused.launches == tk.capsule_routing_bwd_fused.launches == 0


# --------------------------------------------------------------------------
# the modules
def _routing_pair(mode, dtype, seed=1):
    rng = np.random.default_rng(seed)
    b, d, e, k = 7, 8, 8, 4
    beh = _normal(rng, b, L, d)
    lengths = rng.integers(0, L + 1, size=(b,))
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    jmod = jcap.CapsuleRouting(num_capsules=k, dim=e, mode=mode, max_length=L, dtype=jdt)
    jbeh = jnp.asarray(beh, jnp.bfloat16 if jdt else jnp.float32)
    variables = _numpy_tree(jmod.init(jax.random.key(seed), jbeh, jnp.asarray(mask)))
    tdt = getattr(torch, dtype)
    port = tcap.CapsuleRouting(d, k, e, mode=mode, max_length=L, dtype=tdt)
    params_from_jax(port, variables)
    return jmod, variables, port, (jbeh, jnp.asarray(mask)), (torch.from_numpy(beh).to(tdt), torch.from_numpy(mask))


@pytest.mark.parametrize("mode", ["shared", "per_pos"])
@pytest.mark.parametrize("train", [False, True])
def test_capsule_routing_module_fp32_matches_jax(mode, train):
    """fp32: every route agrees with the JAX module's math; 'shared' outside
    training calls the kernel wrapper once, in training never."""
    jmod, variables, port, jargs, targs = _routing_pair(mode, "float32")
    want_caps, want_mask = jmod.apply(variables, *jargs)
    port.train(train)
    with mock.patch.object(tk, "capsule_routing_fused", side_effect=tk.capsule_routing_fused) as spy:
        caps, cap_mask = port(*targs)
    assert spy.call_count == int(mode == "shared" and not train)
    np.testing.assert_allclose(caps.detach().numpy(), np.asarray(want_caps), **KERNEL_TOL)
    np.testing.assert_array_equal(cap_mask.numpy(), np.asarray(want_mask))


@pytest.mark.parametrize("mode", ["shared", "per_pos"])
def test_capsule_routing_module_training_gradients_match_jax(mode):
    jmod, variables, port, jargs, targs = _routing_pair(mode, "float32", seed=2)
    leaf = "S" if mode == "shared" else "W"

    def jloss(params, beh):
        caps, _ = jmod.apply({"params": params}, beh, jargs[1])
        return jnp.sum(jnp.sin(caps))

    jg_params, jg_beh = jax.grad(jloss, argnums=(0, 1))(variables["params"], jargs[0])
    beh = targs[0].clone().requires_grad_()
    caps, _ = port.train()(beh, targs[1])
    torch.sin(caps).sum().backward()
    np.testing.assert_allclose(getattr(port, leaf).grad.numpy(), np.asarray(jg_params[leaf]), **GRAD_TOL)
    np.testing.assert_allclose(beh.grad.numpy(), np.asarray(jg_beh), **GRAD_TOL)


@pytest.mark.parametrize("mode", ["shared", "per_pos"])
@pytest.mark.parametrize("train", [False, True])
def test_capsule_routing_module_bf16(mode, train):
    jmod, variables, port, jargs, targs = _routing_pair(mode, "bfloat16", seed=3)
    want = np.asarray(jmod.apply(variables, *jargs)[0], np.float32)
    with torch.no_grad():
        got = port.train(train)(*targs)[0]
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    scale = BF16_SCALED_RTOL * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= scale
    if mode == "shared" and not train:
        # the kernel route: the JAX kernel in fp32 on the same bf16 behavior, cast
        b, _, _ = jargs[0].shape
        l0 = jnp.broadcast_to(jax.random.normal(jax.random.key(7), (1, 4, L)), (b, 4, L))
        kernel = jk.capsule_routing_fused(
            jargs[0].astype(jnp.float32), jargs[1], jnp.asarray(variables["params"]["S"]), l0, 3,
            interpret=True,
        ).astype(jnp.bfloat16)
        np.testing.assert_allclose(got, np.asarray(kernel, np.float32), **BF16_ONE_ROUNDING)


def test_valid_capsule_mask_and_label_aware_attention_match_jax():
    rng = np.random.default_rng(9)
    lens = np.array([0, 1, 2, 3, 4, 5, 8, 9, 16, 100], np.float32)
    np.testing.assert_array_equal(
        tcap.valid_capsule_mask(torch.from_numpy(lens), 4).numpy(),
        np.asarray(jcap.valid_capsule_mask(jnp.asarray(lens), 4)),
    )
    caps, target = _normal(rng, 10, 4, 6), _normal(rng, 10, 6)
    cap_mask = np.asarray(jcap.valid_capsule_mask(jnp.asarray(lens), 4))
    for power in (1.0, 2.0):
        want = jcap.LabelAwareAttention(power).apply({}, jnp.asarray(caps), jnp.asarray(cap_mask),
                                                      jnp.asarray(target))
        got = tcap.LabelAwareAttention(power)(*map(torch.from_numpy, (caps, cap_mask, target)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------------
# the models
MODELS = {
    "mind": ("mind", {}),
    "mind_cosine": ("mind", {"normalize_logits": True}),
    "comirec_sa": ("comirec", {"variant": "sa"}),
    "comirec_dr_cosine": ("comirec", {"variant": "dr", "normalize_logits": True}),
    "sine": ("sine", {}),
}


def _model_pair(case, dtype="float32", **extra):
    name, params = MODELS[case]
    params = dict(params, **extra)
    jinfo, info = _infos()
    batch = _batch()
    jparams = dict(params, **({} if dtype == "float32" else {"dtype": jnp.bfloat16}))
    tparams = dict(params, **({} if dtype == "float32" else {"dtype": dtype}))
    jmodel = jax_build_model(JModelConfig(name=name, params=jparams, embedding=JEmbeddingConfig(dim=8)), jinfo)
    variables = _numpy_tree(jmodel.init(jax.random.key(0), {k: jnp.asarray(v) for k, v in batch.items()}))
    model = build_model(ModelConfig(name=name, params=tparams, embedding=EmbeddingConfig(dim=8)), info, device="cpu")
    params_from_jax(model, variables)
    return jmodel, variables, model, batch


@pytest.mark.parametrize("case", list(MODELS))
def test_model_matches_jax(case):
    jmodel, variables, model, batch = _model_pair(case)
    want = jmodel.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()}, train=False)
    with torch.inference_mode():
        got = model.eval()(_torch(batch))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(), np.asarray(want[k], np.float32), **TOL, err_msg=k)


@pytest.mark.parametrize("case", ["mind", "sine"])
def test_model_training_outputs_match_jax(case):
    """Training mode: the module math (and SINE's auxiliary loss)."""
    jmodel, variables, model, batch = _model_pair(case)
    set_training_phase(True)
    try:
        want = jmodel.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()}, train=True,
                            rngs={"dropout": jax.random.key(1)})
    finally:
        set_training_phase(False)
    with mock.patch.object(tk, "capsule_routing_fused", side_effect=tk.capsule_routing_fused) as spy:
        got = model.train()(_torch(batch))
    assert spy.call_count == 0
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), **TOL, err_msg=k)


def test_mind_bf16_matches_jax():
    jmodel, variables, model, batch = _model_pair("mind", "bfloat16")
    want = jmodel.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()}, train=False)
    with torch.inference_mode():
        got = model.eval()(_torch(batch))
    for k in ("user_embedding", "interest_capsules", "output"):
        w = np.asarray(want[k], np.float32)
        err = float(np.abs(got[k].float().numpy() - w).max())
        assert err <= BF16_SCALED_RTOL * float(np.abs(w).max()), (k, err)


def test_sampled_logits_match_jax_given_its_negatives():
    """The JAX model's own negative ids (recorded from its draws) fed to the
    port's scoring give its logits; the port's own draw stays in each query
    feature's range, never draws the padding id and comes from the generator
    it is handed."""
    jmodel, variables, model, batch = _model_pair("mind_cosine", num_sampled_negatives=7)
    drawn = []
    randint = jax.random.randint

    def record(*args, **kw):
        drawn.append(np.asarray(randint(*args, **kw)))
        return drawn[-1]

    with mock.patch.object(jax.random, "randint", side_effect=record):
        set_training_phase(True)
        try:
            want = jmodel.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()}, train=True,
                                rngs={"dropout": jax.random.key(1), "sampling": jax.random.key(2)})
        finally:
            set_training_phase(False)
    neg_ids = torch.as_tensor(np.stack(drawn, axis=-1).astype(np.int64))
    with mock.patch.object(type(model), "sample_negative_ids", return_value=neg_ids):
        got = model.train()(_torch(batch))
    assert got["logits"].shape == (6, 8)
    np.testing.assert_allclose(got["logits"].detach().numpy(), np.asarray(want["logits"]), **TOL)

    with pytest.raises(RuntimeError, match="generator"):
        model(_torch(batch))
    draws = []
    for _ in range(2):
        with sampling_generator(model, torch.Generator().manual_seed(3)):
            draws.append(model.sample_negative_ids(500, torch.device("cpu")))
    assert torch.equal(draws[0], draws[1]) and draws[0].shape == (500, 7, 1)
    assert int(draws[0].min()) == 1 and int(draws[0].max()) == 100  # item_id's range, no padding id


# --------------------------------------------------------------------------
# one dense-engine train step against the JAX Trainer, then evaluate
def _jax_grads(jt, js, jbatch, model):
    def loss_fn(params):
        out, _ = jt.model.apply(
            {"params": params, **js.model_state}, jbatch, train=True,
            mutable=["batch_stats", "regularization"],
            rngs={"dropout": jax.random.key(0), "sampling": jax.random.key(1)},
        )
        loss, _ = jt.loss_fn(out, jbatch)
        return jadd_auxiliary(loss, out)[0]

    set_training_phase(True)
    try:
        return _by_torch_name(jax.jit(jax.grad(loss_fn))(js.params), model)
    finally:
        set_training_phase(False)


@pytest.mark.parametrize("case", ["mind_cosine", "sine"])
def test_train_step_and_evaluate_match_jax(case):
    """One fp32 dense ``in_batch_softmax`` step: loss, every gradient and
    every parameter after Adam; the step takes the module math (no call of
    the routing wrapper). ``evaluate`` over two batches equals JAX's, MIND's
    calling the wrapper once a batch."""
    name, params = MODELS[case]
    jinfo, info = _infos()
    data = _batch(b=32, seed=1)
    jcfg = JExperimentConfig(
        model=JModelConfig(name=name, params=params, embedding=JEmbeddingConfig(dim=8)),
        train=JTrainConfig(compute_dtype="float32", log_every_steps=0, loss="in_batch_softmax"),
    )
    cfg = ExperimentConfig.from_json(jcfg.to_json())
    jt = JTrainer(jcfg, jinfo, mesh_ctx=make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    js = jt.init_state(data)
    pt = Trainer(cfg, info, device="cpu")
    ps = pt.init_state(data)
    params_from_jax(ps.model, jax.tree.map(np.asarray, {"params": js.params, **js.model_state}))
    jbatch = jt.device_batch(data)
    want_grads = _jax_grads(jt, js, jbatch, ps.model)
    js2, _, jlogs = jt.train_step(js, jbatch, jt.metrics.init())
    with mock.patch.object(tk, "capsule_routing_fused", side_effect=tk.capsule_routing_fused) as spy:
        ps2, _, plogs = pt.train_step(ps, pt.device_batch(data), pt.metrics.init())
        assert spy.call_count == 0
        np.testing.assert_allclose(float(plogs["loss"]), float(jlogs["loss"]), atol=FP32["loss"], rtol=0)
        _assert_grads(ps2.model, want_grads, FP32["grad"])
        _assert_params(ps2.model, _by_torch_name(js2.params, ps2.model), FP32["param"])
        evals = [_batch(b=16, seed=10 + i) for i in range(2)]
        got = pt.evaluate(ps2, evals)
        assert spy.call_count == (2 if name == "mind" else 0)
    want = jt.evaluate(js2, evals)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=1e-6, err_msg=k)


def test_trainer_hands_its_generator_to_the_sampled_negatives():
    """A step with sampled negatives draws from ``TrainState.generator``: the
    same seed gives the same loss, another seed another."""
    _, info = _infos()
    data = _batch(b=16, seed=2)

    def first_loss(seed):
        cfg = ExperimentConfig.from_dict({
            "model": {"name": "mind", "params": {"num_sampled_negatives": 5}, "embedding": {"dim": 8}},
            "train": {"compute_dtype": "float32", "log_every_steps": 0, "loss": "in_batch_softmax"},
        })
        trainer = Trainer(cfg, info, device="cpu")
        state = trainer.init_state(data, seed=0)
        state.generator.manual_seed(seed)
        _, _, logs = trainer.train_step(state, trainer.device_batch(data), trainer.metrics.init())
        return float(logs["loss"])

    assert first_loss(1) == first_loss(1)
    assert first_loss(1) != first_loss(2)


# --------------------------------------------------------------------------
# the diversity path: slates against tpurec.serving.diversity
def _slate_inputs(seed=0, u=12, k=3, n=60, d=8, cats=5):
    rng = np.random.default_rng(seed)
    return _normal(rng, u, k, d), _normal(rng, n, d), rng.integers(0, cats, size=n)


@pytest.mark.parametrize("weight", [0.0, 0.05, 10.0])
@pytest.mark.parametrize("single_vector", [False, True])
def test_diverse_topk_matches_jax(weight, single_vector):
    caps, items, cats = _slate_inputs()
    if single_vector:
        caps = caps[:, 0]
    want_idx, want_val = jdiv.diverse_topk(caps, items, 10, cats, weight, batch_size=5)
    got_idx, got_val = tdiv.diverse_topk(caps, items, 10, cats, weight, batch_size=5, device="cpu")
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_allclose(got_val, want_val, **TOL)
    if weight == 10.0:  # a dominating bonus: the first five picks cover the five categories
        assert all(len(set(cats[row[:5]])) == 5 for row in got_idx)


def test_greedy_diverse_topk_matches_jax_with_ties_and_category_minus_one():
    rng = np.random.default_rng(3)
    scores = np.round(_normal(rng, 2, 40), 1)  # many ties: the first maximum wins
    cats = rng.integers(-1, 4, size=40)
    for weight in (0.0, 0.2, 5.0):
        want = jdiv.greedy_diverse_topk(jnp.asarray(scores), jnp.asarray(cats), 12, weight)
        got = tdiv.greedy_diverse_topk(torch.from_numpy(scores), torch.from_numpy(cats), 12, weight)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def mind_services(tmp_path_factory):
    """tpurec's and the port's MIND with the same weights, each behind an
    ``OfflineIndexer`` (capsule towers, plain and diverse) and a
    ``RecommendService`` with item categories."""
    jmodel, variables, model, _ = _model_pair("mind")
    servable = Servable(model)
    rng = np.random.default_rng(4)
    item_ids = np.arange(1, 101)
    item_tags = 111 + item_ids % 12
    cats = item_ids % 5
    hist = rng.integers(1, 101, size=(20, L))
    hist[:, 12:] = 0
    user_profile = {f"u{j}": [int(101 + j % 10), [int(x) for x in hist[j]]] for j in range(20)}
    item_profile = {f"i{i}": [int(i), int(t)] for i, t in zip(item_ids, item_tags)}
    user_names, item_names = ["user_tag", "history"], ["item_id", "item_tag"]

    def full(batch, np_mod):  # the dummy target / history the towers need
        b = batch[user_names[0] if user_names[0] in batch else item_names[0]].shape[0]
        out = dict(batch)
        out.setdefault("item_id", np_mod.ones((b,), dtype=np_mod.int64))
        out.setdefault("item_tag", np_mod.full((b,), 111, dtype=np_mod.int64))
        out.setdefault("user_tag", np_mod.full((b,), 101, dtype=np_mod.int64))
        out.setdefault("history", np_mod.ones((b, L), dtype=np_mod.int64))
        return out

    j_apply = jax.jit(lambda b: jmodel.apply(variables, b, train=False))
    towers = {
        "jax": (lambda b: j_apply(full(b, jnp))["interest_capsules"],
                lambda b: j_apply(full(b, jnp))["item_embedding"]),
        "port": (lambda b: servable.predict(full(b, torch))["interest_capsules"],
                 lambda b: servable.predict(full(b, torch))["item_embedding"]),
    }
    out = {"cats": {f"i{i}": int(c) for i, c in zip(item_ids, cats)}}
    for side, (user_tower, item_tower) in towers.items():
        indexer_cls = JOfflineIndexer if side == "jax" else OfflineIndexer
        kw = {} if side == "jax" else {"device": "cpu"}
        indexer = indexer_cls(user_tower, item_tower, user_profile, item_profile, user_names,
                              item_names, batch_size=8, **kw)
        runs = {}
        for label, extra in (("plain", {}), ("diverse", {"item_categories": cats, "diversity_weight": 10.0})):
            kv = DictKVStore()
            runs[label] = indexer.run(str(tmp_path_factory.mktemp(f"{side}_{label}")), kv_store=kv,
                                      topk=10, key_prefix="MIND", **extra)
        service_cls = JRecommendService if side == "jax" else RecommendService
        out[side] = dict(
            runs=runs,
            service=service_cls(
                user_tower=user_tower, user_profile=user_profile, user_feature_names=user_names,
                kv_store=runs["plain"]["kv"], item_ids=runs["plain"]["item_ids"],
                item_embeddings=runs["plain"]["item_embeddings"], item_categories=cats,
                key_prefix="MIND", **kw,
            ),
        )
    return out


def test_indexer_capsule_slates_match_jax(mind_services):
    for label in ("plain", "diverse"):
        port, jax_ = mind_services["port"]["runs"][label], mind_services["jax"]["runs"][label]
        assert port["user_embeddings"].shape == (20, 4, 8)
        np.testing.assert_allclose(port["user_embeddings"], jax_["user_embeddings"], **TOL)
        for uid in port["user_ids"]:
            got, want = port["kv"].get(f"MIND_{uid}"), jax_["kv"].get(f"MIND_{uid}")
            assert got.split("\t")[0] == want.split("\t")[0], (label, uid)
            np.testing.assert_allclose([float(x) for x in got.split("\t")[1].split(",")],
                                       [float(x) for x in want.split("\t")[1].split(",")], **TOL)
    cats = mind_services["cats"]
    plain, diverse = (mind_services["port"]["runs"][r]["kv"] for r in ("plain", "diverse"))
    for uid in mind_services["port"]["runs"]["plain"]["user_ids"]:
        p, d = (kv.get(f"MIND_{uid}").split("\t")[0].split(",") for kv in (plain, diverse))
        assert p[0] == d[0] and len({cats[i] for i in d[:5]}) == 5


@pytest.mark.parametrize("weight", [0.0, 10.0])
def test_service_retrieve_online_matches_jax(mind_services, weight):
    for uid in ("u0", "u7", "u19"):
        req = {"user_id": uid, "type": "retrieve", "topk": 10, "diversity_weight": weight}
        got = mind_services["port"]["service"].predict(req)["result"]
        want = mind_services["jax"]["service"].predict(req)["result"]
        assert list(got) == list(want)
        np.testing.assert_allclose(list(got.values()), list(want.values()), **TOL)


def test_diversity_weight_over_http(mind_services):
    svc = mind_services["port"]["service"]
    server = serve_background(svc, port=0)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/predict"
        req = {"user_id": "u3", "type": "retrieve", "topk": 10, "diversity_weight": 10.0}
        with urllib.request.urlopen(urllib.request.Request(
            url, data=json.dumps(req).encode(), headers={"Content-Type": "application/json"}
        ), timeout=30) as resp:
            body = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
    assert body["result"] == svc.predict(req)["result"]
    assert len({mind_services["cats"][i] for i in list(body["result"])[:5]}) == 5


@pytest.mark.parametrize("table_optimizer", ["adam", "rowwise_adam"])
def test_sampled_negatives_refuse_the_sparse_engines(table_optimizer):
    """A lazy-sparse engine's lookup sees only the batch's rows, so sampled
    negatives (ids from the whole table) raise there rather than index
    the wrong rows (the fused engine refuses ``in_batch_softmax``
    already)."""
    _, info = _infos()
    data = _batch(b=16, seed=2)
    cfg = ExperimentConfig.from_dict({
        "model": {"name": "mind", "params": {"num_sampled_negatives": 5}, "embedding": {"dim": 8}},
        "train": {"compute_dtype": "float32", "log_every_steps": 0, "loss": "in_batch_softmax",
                  "sparse_embedding": True, "optimizer": {"embedding_optimizer": table_optimizer}},
    })
    trainer = Trainer(cfg, info, device="cpu")
    state = trainer.init_state(data)
    with pytest.raises(ValueError, match="whole table"):
        trainer.train_step(state, trainer.device_batch(data), trainer.metrics.init())
