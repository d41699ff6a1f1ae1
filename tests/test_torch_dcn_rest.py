"""The rest of the port's DCN family (NFM, DeepCrossing, FNN, CCPM, FGCNN,
AFM, AutoInt) and their ops (the conv blocks and k-max pooling, the
residual unit, AFM's attention pooling, multi-head attention, the flax
norms) against the JAX package on the CPU.

Inputs are made with numpy from a seed; weights go from the JAX modules and
models through ``tpurec_torch.bridge``. Tolerances:

- fp32 ops, modules and models: atol/rtol 1e-5 (the two frameworks sum in
  different orders; values are O(1)-O(10)); k-max pooling moves values
  and is held exactly, its gradient too;
- bf16 ops and modules: the JAX result to 2^-5 of its largest |value|
  (bf16 roundings, 2^-9 relative each, taken at other places by the two
  frameworks), as ``tests/test_torch_dcn.py``;
- bf16 models: probabilities to 2e-2, as ``tests/test_torch_models.py``;
- one fp32 dense train step: ``tests/test_torch_train.py``'s limits (loss
  1e-5, gradients 1e-4 of their largest value, parameters after Adam
  2e-6), NFM's running statistics to 1e-6;
- NFM's fused engine over three steps: ``tests/test_torch_engines_fused.py``'s
  limits, within one of tpurec's tiles (ROADMAP Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from test_torch_dcn import (
    BF16_SCALED_RTOL,
    TOL,
    _batch,
    _infos,
    _jax_grads,
    _normal,
    _numpy_tree,
    _redraw,
)
from test_torch_engines_fused import run_both, sparse_configs
from test_torch_train import FP32, _assert_grads, _assert_params, _by_torch_name
from tpurec.config import EmbeddingConfig as JEmbeddingConfig
from tpurec.config import ExperimentConfig as JExperimentConfig
from tpurec.config import ModelConfig as JModelConfig
from tpurec.config import TrainConfig as JTrainConfig
from tpurec.core.mesh import make_mesh
from tpurec.models import build_model as jax_build_model
from tpurec.models.dcn import FNN as JFNN
from tpurec.ops import attention as jattn
from tpurec.ops import conv as jconv
from tpurec.ops import interactions as ji
from tpurec.train import Trainer as JTrainer
from tpurec_torch.bridge import _flatten, _torch_leaf, params_from_jax
from tpurec_torch.config import EmbeddingConfig, ExperimentConfig, ModelConfig
from tpurec_torch.models import build_model
from tpurec_torch.models.dcn import FNN
from tpurec_torch.ops import attention as tattn
from tpurec_torch.ops import conv as tconv
from tpurec_torch.ops import interactions as ti
from tpurec_torch.ops import mlp as tmlp
from tpurec_torch.ops import kernels as tk
from tpurec_torch.train.trainer import Trainer

torch.set_num_threads(1)

DTYPES = ["float32", "bfloat16"]


def _as_dtype(x, dtype):
    """x rounded to ``dtype`` and back, as numpy fp32 (the same input for
    both frameworks)."""
    return np.asarray(jnp.asarray(x).astype(dtype).astype(jnp.float32))


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_SCALED_RTOL * np.abs(want).max(), rtol=0)


# --------------------------------------------------------------------------
# k-max pooling and the convolution
@pytest.mark.parametrize("dtype", DTYPES)
def test_k_max_pool_with_ties_matches_jax(dtype):
    """Values on a coarse grid, so that most rows hold ties across the k-th
    place: the values exactly, and the gradient of a weighted sum, which
    among tied values goes to the later index in both (a descending sort
    would give it to the earlier one)."""
    rng = np.random.default_rng(0)
    x = _as_dtype(np.round(rng.normal(size=(16, 9, 3, 2)) * 2) / 2 + 0.25, dtype)
    w = _normal(rng, 16, 4, 3, 2)
    jx = jnp.asarray(x).astype(dtype)
    want = jconv.k_max_pool(jx, 4, axis=1)
    want_grad = jax.grad(lambda a: jnp.sum(jconv.k_max_pool(a, 4, axis=1).astype(jnp.float32) * w))(jx)
    tx = torch.tensor(x).to(getattr(torch, dtype)).requires_grad_()
    got = tconv.k_max_pool(tx, 4, dim=1)
    (got.float() * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(tx.grad.float().numpy(), np.asarray(want_grad.astype(jnp.float32)))
    # a descending sort takes the earlier of tied values: its gradient
    # would land elsewhere, so the check can tell
    earlier = torch.sort(torch.tensor(x), dim=1, descending=True, stable=True).indices[:, :4]
    earlier_support = torch.zeros(x.shape).scatter(1, earlier, 1.0)
    assert not torch.equal(earlier_support, (tx.grad != 0).float())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width,c_in,c_out", [(6, 1, 4), (7, 3, 5), (1, 2, 3)])
def test_conv_matches_flax(width, c_in, c_out, dtype):
    """``Conv`` against flax's ``nn.Conv(kernel_size=(width, 1),
    padding="SAME")`` on an NHWC input of 13 fields: at even width 6 lax
    pads 2 fields before and 3 after, at odd width 7 3 and 3."""
    rng = np.random.default_rng(1)
    jdt = None if dtype == "float32" else jnp.bfloat16
    x = _as_dtype(_normal(rng, 5, 13, 4, c_in), dtype)
    jm = fnn.Conv(c_out, kernel_size=(width, 1), padding="SAME", dtype=jdt)
    variables = _redraw(_numpy_tree(jm.init(jax.random.key(0), jnp.asarray(x))), seed=2)
    want = np.asarray(jm.apply(variables, jnp.asarray(x).astype(dtype)).astype(jnp.float32))
    module = tconv.Conv(c_in, c_out, width, None if dtype == "float32" else torch.bfloat16)
    module.kernel.data = torch.from_numpy(variables["params"]["kernel"])
    module.bias.data = torch.from_numpy(variables["params"]["bias"])
    got = module(torch.tensor(x).to(getattr(torch, dtype)))
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    _close(got.detach().float().numpy(), want, dtype)


def test_conv_init_is_lecun_over_its_fan_in():
    """The kernel's spread is flax's lecun normal with fan-in width·C_in
    (the Dense rule would take the kernel's second axis, 1)."""
    module = tconv.Conv(8, 16, 7)
    module.init_weights(torch.Generator().manual_seed(0))
    jk = fnn.initializers.lecun_normal()(jax.random.key(0), (7, 1, 8, 16))
    np.testing.assert_allclose(float(module.kernel.detach().std()), float(jnp.std(jk)), rtol=0.1)
    assert float(module.kernel.detach().abs().max()) <= 2 / np.sqrt(56) / 0.8796 + 1e-6


# --------------------------------------------------------------------------
# the modules against the JAX modules
def _module_case(name, dtype):
    """(JAX module, port module factory, numpy input)."""
    rng = np.random.default_rng(3)
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    f, d = 13, 6
    emb = _normal(rng, 37, f, d)
    cases = {
        "ccpm": (jconv.CCPM((4, 3), (6, 5), dtype=jdt), lambda: tconv.CCPM(f, d, (4, 3), (6, 5), tdt), emb),
        "ccpm_3": (jconv.CCPM((2, 3, 2), (3, 4, 5), dtype=jdt),
                   lambda: tconv.CCPM(f, d, (2, 3, 2), (3, 4, 5), tdt), emb),
        "fgcnn": (jconv.FGCNN((8, 10), (7, 7), (2, 2), (3, 3), dtype=jdt),
                  lambda: tconv.FGCNN(f, d, (8, 10), (7, 7), (2, 2), (3, 3), tdt), emb),
        "residual": (jconv.ResidualBlock(9, dtype=jdt), lambda: tconv.ResidualBlock(20, 9, tdt),
                     _normal(rng, 37, 20)),
        "afm": (ji.AFMInteraction(5, dtype=jdt), lambda: ti.AFMInteraction(d, 5, tdt), emb),
    }
    return cases[name]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["ccpm", "ccpm_3", "fgcnn", "residual", "afm"])
def test_module_matches_jax(name, dtype):
    """CCPM's k schedule and NHWC flatten, FGCNN's NHWC ``recombine`` input,
    the residual unit and AFM's attention pooling, on weights redrawn at
    0.3 so that every term works."""
    jm, make, x = _module_case(name, dtype)
    x = _as_dtype(x, dtype)
    variables = _redraw(_numpy_tree(jm.init(jax.random.key(0), jnp.asarray(x))), seed=4)
    want = np.asarray(jm.apply(variables, jnp.asarray(x).astype(dtype)).astype(jnp.float32))
    module = params_from_jax(make(), variables)
    with torch.no_grad():
        got = module(torch.tensor(x).to(getattr(torch, dtype)))
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), want, dtype)
    assert np.std(want) > 0.05


def test_fm_second_order_bi_interaction_matches_jax():
    """``reduce_dim=False``: the (B, D) bi-interaction in the embedding's
    dtype, in train and eval mode alike, and no kernel wrapper called."""
    rng = np.random.default_rng(5)
    for dtype in DTYPES:
        x = _as_dtype(_normal(rng, 37, 7, 6), dtype)
        want = np.asarray(ji.fm_second_order(jnp.asarray(x).astype(dtype), reduce_dim=False)
                          .astype(jnp.float32))
        before = tk.fm_second_order_fused.launches
        for training in (True, False):
            got = ti.fm_second_order(torch.tensor(x).to(getattr(torch, dtype)), training, reduce_dim=False)
            assert got.shape == (37, 6) and got.dtype == getattr(torch, dtype)
            _close(got.float().numpy(), want, dtype)
        assert tk.fm_second_order_fused.launches == before


# --------------------------------------------------------------------------
# attention
@pytest.mark.parametrize("mask", [None, "keys", "pairs"])
def test_scaled_dot_attention_matches_jax(mask):
    rng = np.random.default_rng(6)
    q, k, v = _normal(rng, 5, 2, 7, 4), _normal(rng, 5, 2, 9, 4), _normal(rng, 5, 2, 9, 3)
    m = None
    if mask == "keys":
        m = (rng.random((5, 9)) < 0.6).astype(np.float32)
        m[:, 0] = 1.0
    elif mask == "pairs":
        m = (rng.random((5, 7, 9)) < 0.6).astype(np.float32)
        m[..., 0] = 1.0
    jm = None if m is None else jattn.expand_mask(jnp.asarray(m), 7, 9)
    want = np.asarray(jattn.scaled_dot_attention(*map(jnp.asarray, (q, k, v)), jm))
    tm = None if m is None else tattn.expand_mask(torch.from_numpy(m), 7, 9)
    if m is not None:
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    got = tattn.scaled_dot_attention(*map(torch.from_numpy, (q, k, v)), tm)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["self", "self_masked", "cross"])
def test_multi_head_attention_matches_jax(kind, dtype):
    """Self-attention over 39 fields (AutoInt's), with a key mask, and cross
    attention of 1 query over 9 keys of another width (the sequence
    models'), weights redrawn at 0.3."""
    rng = np.random.default_rng(7)
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    q = _as_dtype(_normal(rng, 6, 39 if kind != "cross" else 1, 16), dtype)
    kv = _as_dtype(_normal(rng, 6, 9, 12), dtype) if kind == "cross" else None
    mask = None
    if kind == "self_masked":
        mask = (rng.random((6, 39)) < 0.7).astype(np.float32)
        mask[:, 0] = 1.0
    jm = jattn.MultiHeadAttention(num_heads=2, head_dim=8, dtype=jdt)
    jargs = [jnp.asarray(q).astype(dtype)]
    jkw = {} if kv is None else {"kv": jnp.asarray(kv).astype(dtype)}
    if mask is not None:
        jkw["mask"] = jnp.asarray(mask)
    variables = _redraw(_numpy_tree(jm.init(jax.random.key(0), *jargs, **jkw)), seed=8)
    want = np.asarray(jm.apply(variables, *jargs, **jkw).astype(jnp.float32))
    module = params_from_jax(tattn.MultiHeadAttention(16, 2, 8, None if kv is None else 12, tdt),
                             variables)
    tkw = {} if kv is None else {"kv": torch.tensor(kv).to(getattr(torch, dtype))}
    if mask is not None:
        tkw["mask"] = torch.from_numpy(mask)
    with torch.no_grad():
        got = module(torch.tensor(q).to(getattr(torch, dtype)), **tkw)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    _close(got.float().numpy(), want, dtype)


# --------------------------------------------------------------------------
# the norms
@pytest.mark.parametrize("dtype", DTYPES)
def test_batch_norm_matches_flax(dtype):
    """NFM's ``nn.BatchNorm`` (scale, bias, eps 1e-5, momentum 0.99): the
    train-mode output and the updated running statistics, then the
    eval-mode output from them; fp32 output for a bf16 input, as flax's
    with ``dtype=None``."""
    rng = np.random.default_rng(9)
    x = _as_dtype(_normal(rng, 37, 6, scale=2.0) + 1.0, dtype)
    jm = fnn.BatchNorm()
    variables = jm.init(jax.random.key(0), jnp.asarray(x), use_running_average=True)
    variables = _numpy_tree(variables)
    variables["params"] = _redraw(variables["params"], seed=10)
    variables["batch_stats"] = {"mean": _normal(rng, 6, scale=0.3),
                                "var": np.abs(_normal(rng, 6)) + 0.5}
    jx = jnp.asarray(x).astype(dtype)
    want, stats = jm.apply(variables, jx, use_running_average=False, mutable=["batch_stats"])
    want_eval = jm.apply({**variables, **stats}, jx, use_running_average=True)
    module = params_from_jax(tmlp.BatchNorm(6), variables)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    got = module.train()(tx)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(module, name).numpy(), np.asarray(stats["batch_stats"][key]),
                                   atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(module.eval()(tx).detach().numpy(), np.asarray(want_eval), **TOL)


def test_dice_batch_norm_keeps_the_input_dtype():
    """Dice's BatchNorm (no scale, no bias, eps 1e-9) has no parameter and
    returns the input's dtype, as flax's does."""
    module = tmlp.BatchNorm(4, use_scale=False, use_bias=False, epsilon=1e-9)
    assert not list(module.parameters())
    assert module.train()(torch.randn(8, 4, dtype=torch.bfloat16)).dtype == torch.bfloat16


@pytest.mark.parametrize("dtype,module_dtype", [("float32", None), ("bfloat16", None),
                                                 ("bfloat16", "bfloat16"), ("float32", "bfloat16")])
def test_layer_norm_matches_flax(dtype, module_dtype):
    """``nn.LayerNorm``: eps 1e-6, fp32 statistics, the result in the module
    dtype (None: the promotion with fp32)."""
    rng = np.random.default_rng(11)
    x = _as_dtype(_normal(rng, 5, 7, 16, scale=3.0) + 2.0, dtype)
    jm = fnn.LayerNorm(dtype=None if module_dtype is None else jnp.bfloat16)
    variables = _redraw(_numpy_tree(jm.init(jax.random.key(0), jnp.asarray(x))), seed=12)
    want = jm.apply(variables, jnp.asarray(x).astype(dtype))
    module = params_from_jax(tmlp.LayerNorm(16, None if module_dtype is None else torch.bfloat16),
                             variables)
    got = module(torch.tensor(x).to(getattr(torch, dtype)))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _close(got.detach().float().numpy(), np.asarray(want.astype(jnp.float32)),
           "float32" if want.dtype == jnp.float32 else "bfloat16")


# --------------------------------------------------------------------------
# the seven models against the JAX models (tests/test_models_dcn.py's schema)
MODELS = {
    "nfm": ("nfm", {}),
    "deep_crossing": ("deep_crossing", {}),
    "fnn": ("fnn", {}),
    "ccpm": ("ccpm", {}),
    "fgcnn": ("fgcnn", {}),
    "afm": ("afm", {}),
    "autoint": ("autoint", {"num_attention_layers": 3, "num_heads": 2, "head_dim": 32}),
}


def _pair(case, dtype="float32", redraw=True):
    name, params = MODELS[case]
    jinfo, info = _infos()
    batch = _batch()
    jparams = dict(params, **({} if dtype == "float32" else {"dtype": jnp.bfloat16}))
    tparams = dict(params, **({} if dtype == "float32" else {"dtype": "bfloat16"}))
    jmodel = jax_build_model(JModelConfig(name=name, params=jparams, embedding=JEmbeddingConfig(dim=8)), jinfo)
    variables = _numpy_tree(jmodel.init(jax.random.key(0), {k: jnp.asarray(v) for k, v in batch.items()}))
    if redraw:  # a norm's scale about 1, as a trained one is
        variables["params"] = _redraw(variables["params"], seed=8)
        variables["params"] = jax.tree_util.tree_map_with_path(
            lambda path, a: a + 1.0 if path[-1].key == "scale" else a, variables["params"])
    if "batch_stats" in variables:  # running statistics a trained model would hold
        rng = np.random.default_rng(13)
        stats = variables["batch_stats"]["bn"]
        stats["mean"] = _normal(rng, *stats["mean"].shape, scale=0.01)
        stats["var"] = np.abs(_normal(rng, *stats["var"].shape, scale=1e-3)) + 1e-3
    model = build_model(ModelConfig(name=name, params=tparams, embedding=EmbeddingConfig(dim=8)), info, "cpu")
    params_from_jax(model, variables)
    want = jmodel.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()}, train=False)
    with torch.inference_mode():
        got = model.eval()({k: torch.as_tensor(v) for k, v in batch.items()})
    return variables, model, got, want


@pytest.mark.parametrize("case", list(MODELS))
def test_model_matches_jax_fp32(case):
    _, _, got, want = _pair(case)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key, **TOL)
    assert np.std(np.asarray(want["logit"])) > 0.1


@pytest.mark.parametrize("case", list(MODELS))
def test_model_matches_jax_bf16_compute(case):
    _, _, got, want = _pair(case, "bfloat16", redraw=False)
    out = got["output"]
    assert out.dtype == torch.float32 and torch.all((out >= 0) & (out <= 1))
    np.testing.assert_allclose(out.numpy(), np.asarray(want["output"]), atol=2e-2, rtol=0)


@pytest.mark.parametrize("case", list(MODELS))
def test_param_shapes_match_jax(case):
    """Every flax leaf has a port parameter or buffer of the shape the
    bridge gives it (a Dense kernel transposed, a conv kernel kept) and
    nothing is left over on either side."""
    variables, model, _, _ = _pair(case)
    port = model.state_dict()
    want = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            name, arr = _torch_leaf(collection, path, value, model)
            want[".".join(path[:-1] + (name,))] = arr.shape
    assert want == {k: tuple(v.shape) for k, v in port.items()}
    kernels = [k for k in port if k.endswith(".kernel")]
    assert bool(kernels) == (case in ("ccpm", "fgcnn"))


def test_fnn_init_embedding_from_fm_matches_jax():
    """FNN's table seeded from a trained FM's ``v``, on state dicts as the
    JAX static method does on param trees: the seeded model equals the
    JAX one seeded alike."""
    jinfo, info = _infos()
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    fm_cfg = JModelConfig(name="fm", embedding=JEmbeddingConfig(dim=8))
    fnn_cfg = JModelConfig(name="fnn", embedding=JEmbeddingConfig(dim=8))
    jfm, jfnn = jax_build_model(fm_cfg, jinfo), jax_build_model(fnn_cfg, jinfo)
    fm_vars = _redraw(_numpy_tree(jfm.init(jax.random.key(1), batch)), seed=14)
    fnn_vars = _redraw(_numpy_tree(jfnn.init(jax.random.key(2), batch)), seed=15)
    seeded = {"params": JFNN.init_embedding_from_fm(fnn_vars["params"], fm_vars["params"])}
    want = jfnn.apply(seeded, batch, train=False)["logit"]
    fm = params_from_jax(build_model(ModelConfig.from_dict(fm_cfg.to_dict()), info, "cpu"), fm_vars)
    fnn = params_from_jax(build_model(ModelConfig.from_dict(fnn_cfg.to_dict()), info, "cpu"), fnn_vars)
    state = FNN.init_embedding_from_fm(fnn.state_dict(), fm.state_dict())
    assert torch.equal(state["emb.embedding"], fm.v.embedding) and state is not fnn.state_dict()
    fnn.load_state_dict(state)
    with torch.inference_mode():
        got = fnn.eval()({k: torch.as_tensor(np.array(v)) for k, v in batch.items()})["logit"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------------
# one dense-engine train step against the JAX Trainer, then evaluate
@pytest.mark.parametrize("case", list(MODELS))
def test_train_step_and_evaluate_match_jax(case):
    """One fp32 dense step: the loss, every gradient, every parameter after
    Adam and NFM's running statistics; then ``evaluate`` over two batches."""
    name, params = MODELS[case]
    jinfo, info = _infos()
    data = _batch(b=32, seed=1, label=True)
    jcfg = JExperimentConfig(
        model=JModelConfig(name=name, params=params, embedding=JEmbeddingConfig(dim=8)),
        train=JTrainConfig(compute_dtype="float32", log_every_steps=0),
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
    ps2, _, plogs = pt.train_step(ps, pt.device_batch(data), pt.metrics.init())
    np.testing.assert_allclose(float(plogs["loss"]), float(jlogs["loss"]), atol=FP32["loss"], rtol=0)
    _assert_grads(ps2.model, want_grads, FP32["grad"])
    _assert_params(ps2.model, _by_torch_name(js2.params, ps2.model), FP32["param"])
    if name == "nfm":
        stats = js2.model_state["batch_stats"]["bn"]
        for buf, key in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(getattr(ps2.model.bn, buf).numpy(), np.asarray(stats[key]),
                                       atol=1e-6, rtol=0, err_msg=buf)
    evals = [_batch(b=16, seed=10 + i, label=True) for i in range(2)]
    got, want = pt.evaluate(ps2, evals), jt.evaluate(js2, evals)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


# --------------------------------------------------------------------------
# NFM in the fused engine
def test_nfm_fused_engine_matches_jax():
    """Three fp32 steps of NFM in the fused engine (#9's plain version on
    the CPU, once per table a step) against tpurec's fused engine: the loss
    of each step, then the tables, Adam's moments on every row, every dense
    parameter and the BatchNorm's running statistics."""
    jcfg, cfg = sparse_configs("nfm", "fused_adam", 0.01)
    _, js, _, ps = run_both("nfm", jcfg, cfg)
    assert set(ps.table_opt) == {"emb.embedding", "w.w.embedding"}
    stats = js.model_state["batch_stats"]["bn"]
    for buf, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(ps.model.bn, buf).numpy(), np.asarray(stats[key]),
                                   atol=1e-6, rtol=0, err_msg=buf)
