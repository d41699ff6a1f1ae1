"""The port's DCN family (DCN vector and matrix cross, xDeepFM, FiBiNET) and
its three kernels' plain versions against the JAX package on the CPU.

Inputs are made with numpy from a seed; weights go from the JAX modules and
models through ``tpurec_torch.bridge``. Tolerances:

- plain versions and fp32 modules and models: atol/rtol 1e-5 (the two
  frameworks sum in different orders; values are O(1)-O(10));
- bf16 modules: the JAX module's bf16 output to 2^-5 of its largest |value|
  (a few bf16 roundings, 2^-9 relative each, of intermediates as large as
  the output, taken at other places by the two frameworks; a small output
  element keeps the error of the large terms that cancelled in it). At inference the port computes the cross stack, CIN and
  SENet-bilinear in fp32 and casts (the TPU kernels' path) where JAX on the
  CPU runs the cross stack in bf16, so the cross stack is held to the JAX
  kernel run in fp32 (interpret mode) and cast, to one bf16 rounding
  (1e-2 + 2^-7), as ``test_fm_second_order_op_matches_jax`` does;
- bf16 models: probabilities to 2e-2, as ``tests/test_torch_models.py``;
- one fp32 train step: ``tests/test_torch_train.py``'s limits (loss 1e-5,
  gradients 1e-4 of their largest value, parameters after Adam 2e-6).
"""

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
from tpurec.ops import interactions as ji
from tpurec.ops.pallas import kernels as jk
from tpurec.ops.pallas.kernels import set_training_phase
from tpurec.train import Trainer as JTrainer
from tpurec.train.losses import add_auxiliary as jadd_auxiliary
from tpurec_torch.bridge import params_from_jax
from tpurec_torch.config import EmbeddingConfig, ExperimentConfig, ModelConfig
from tpurec_torch.data.schema import DataInfo
from tpurec_torch.models import build_model
from tpurec_torch.ops import interactions as ti
from tpurec_torch.ops import kernels as tk

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_SCALED_RTOL = 2.0**-5
BF16_ONE_ROUNDING = dict(atol=1e-2, rtol=2.0**-7)

# the schema of tests/test_models_dcn.py: 4 fields, 3 continuous features
NAMES, DIMS, CONT = ["uid", "iid", "utag", "itag"], [50, 80, 10, 12], ["c1", "c2", "c3"]


def _numpy_tree(variables):
    variables = {k: v for k, v in fnn.unbox(variables).items() if k != "regularization"}
    return jax.tree.map(np.asarray, variables)


def _redraw(variables, seed, scale=0.3):
    """Every leaf redrawn from N(0, scale²), so biases and every term do work."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (scale * rng.normal(size=a.shape)).astype(np.float32), variables)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


# --------------------------------------------------------------------------
# plain versions against the JAX references and the Pallas kernels
@pytest.mark.parametrize("b,d,layers", [(37, 13, 3), (5, 64, 1), (20, 33, 6)])
def test_cross_network_plain_matches_reference_and_interpret(b, d, layers):
    rng = np.random.default_rng(0)
    # w at 0.5/sqrt(D), so that x·w_l stays O(1) and x does not grow with L
    x0, w, bias = _normal(rng, b, d), _normal(rng, layers, d, scale=0.5 / np.sqrt(d)), _normal(rng, layers, d)
    got = tk.cross_network_plain(*map(torch.from_numpy, (x0, w, bias))).numpy()
    jargs = tuple(map(jnp.asarray, (x0, w, bias)))
    np.testing.assert_allclose(got, np.asarray(jk.cross_network_reference(*jargs)), **TOL)
    np.testing.assert_allclose(got, np.asarray(jk.cross_network_stack(*jargs, interpret=True)), **TOL)


def _cin_inputs(seed, b, f, d, sizes):
    """emb and one weight a level, scaled so that every level stays O(1)."""
    rng = np.random.default_rng(seed)
    weights, h = [], f
    for s in sizes:
        weights.append(_normal(rng, h * f, s, scale=1.0 / np.sqrt(h * f)))
        h = s
    return _normal(rng, b, f, d), weights


@pytest.mark.parametrize(
    "b,f,d,sizes", [(16, 4, 6, (5, 3)), (37, 7, 8, (5, 9, 3)), (8, 26, 4, (128, 128)), (3, 1, 5, (2,))]
)
def test_cin_plain_matches_reference_and_interpret(b, f, d, sizes):
    emb, weights = _cin_inputs(1, b, f, d, sizes)
    got = tk.cin_plain(torch.from_numpy(emb), [torch.from_numpy(w) for w in weights]).numpy()
    jargs = (jnp.asarray(emb), tuple(map(jnp.asarray, weights)))
    assert got.shape == (b, sum(sizes))
    np.testing.assert_allclose(got, np.asarray(jk.cin_reference(*jargs)), **TOL)
    np.testing.assert_allclose(got, np.asarray(jk.cin_fused(*jargs, interpret=True)), **TOL)


def _col_reading(got, want):
    """max |got − want| over 1e-4 of each output column's largest |want|
    (``chip_smoke.py``'s ``CIN_COL_RTOL``): at most 1 passes."""
    scale = np.abs(want).max(axis=0).clip(min=1e-30)
    return float((np.abs(got - want) / scale).max()) / 1e-4


@pytest.mark.parametrize("products", ["fp32", "3xtf32", "1xtf32"])
@pytest.mark.parametrize("b,f,d,sizes", [(8, 26, 32, (128, 128)), (37, 7, 8, (5, 9, 3)), (16, 4, 6, (5, 3))])
def test_cin_tf32_products_emulation(b, f, d, sizes, products):
    """The CUDA kernel's arithmetic (H contracted first for each field, the
    sum over fields in order) with its products in fp32, in 3xTF32 (what
    the kernel's tensor cores compute) and in single TF32, against
    tpurec's ``cin_reference`` and its Pallas kernel in interpret mode:
    fp32 and 3xTF32 hold ``TOL`` and 1e-4 of each column's largest |value|
    (the card's limit); single TF32 must read above the card's limit (22-31×
    at these shapes), so the check can fail."""
    emb, weights = _cin_inputs(1, b, f, d, sizes)
    got = tk.cin_products(torch.from_numpy(emb), [torch.from_numpy(w) for w in weights], products).numpy()
    jargs = (jnp.asarray(emb), tuple(map(jnp.asarray, weights)))
    assert got.shape == (b, sum(sizes))
    for want in (np.asarray(jk.cin_reference(*jargs)), np.asarray(jk.cin_fused(*jargs, interpret=True))):
        if products == "1xtf32":
            assert _col_reading(got, want) > 1.0
        else:
            np.testing.assert_allclose(got, want, **TOL)
            assert _col_reading(got, want) <= 1.0


def _senet_inputs(seed, b, f, d, with_bias=True):
    rng = np.random.default_rng(seed)
    r = max(1, f // 3)
    return [
        _normal(rng, b, f, d), _normal(rng, f, r, scale=0.5), _normal(rng, r, f, scale=0.5),
        _normal(rng, d, d, scale=0.3),
        _normal(rng, r, scale=0.3) if with_bias else None,
        _normal(rng, f, scale=0.3) if with_bias else None,
    ]


@pytest.mark.parametrize(
    "b,f,d,with_bias", [(16, 5, 24, True), (37, 2, 8, True), (4, 26, 32, True), (9, 6, 7, False)]
)
def test_senet_bilinear_plain_matches_reference_and_interpret(b, f, d, with_bias):
    args = _senet_inputs(2, b, f, d, with_bias)
    got = tk.senet_bilinear_plain(*[None if a is None else torch.from_numpy(a) for a in args]).numpy()
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    assert got.shape == (b, f * (f - 1) // 2, d)
    np.testing.assert_allclose(got, np.asarray(jk.senet_bilinear_reference(*jargs)), **TOL)
    np.testing.assert_allclose(got, np.asarray(jk.senet_bilinear_fused(*jargs, interpret=True)), **TOL)


# --------------------------------------------------------------------------
# wrappers on the CPU
def test_wrappers_take_plain_on_cpu_and_count_nothing():
    rng = np.random.default_rng(3)
    tk.reset_launch_counts()
    cross = [torch.from_numpy(a) for a in (_normal(rng, 9, 11), _normal(rng, 2, 11), _normal(rng, 2, 11))]
    assert torch.equal(tk.cross_network_fused(*cross), tk.cross_network_plain(*cross))
    emb, weights = _cin_inputs(4, 9, 5, 6, (4, 3))
    emb, weights = torch.from_numpy(emb), [torch.from_numpy(w) for w in weights]
    assert torch.equal(tk.cin_fused(emb, weights), tk.cin_plain(emb, weights))
    senet = [torch.from_numpy(a) for a in _senet_inputs(5, 9, 5, 6)]
    assert torch.equal(tk.senet_bilinear_fused(*senet), tk.senet_bilinear_plain(*senet))
    assert tk.cross_network_fused.launches == tk.cin_fused.launches == 0
    assert tk.senet_bilinear_fused.launches == 0
    tk.cross_network_fused.launches = tk.cin_fused.launches = tk.senet_bilinear_fused.launches = 3
    tk.reset_launch_counts()
    assert tk.cross_network_fused.launches == tk.cin_fused.launches == 0
    assert tk.senet_bilinear_fused.launches == 0


def test_wrappers_refuse_grad_off_the_cpu():
    """Off the CPU (here the ``meta`` device) the wrappers raise under grad
    mode when an input requires grad; without grad they reach the device
    check."""
    x0 = torch.empty(4, 8, device="meta", requires_grad=True)
    wb = torch.empty(2, 8, device="meta")
    with pytest.raises(RuntimeError, match="requires grad"):
        tk.cross_network_fused(x0, wb, wb)
    emb = torch.empty(4, 3, 5, device="meta")
    w = torch.empty(9, 4, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        tk.cin_fused(emb, [w])
    w1, w2 = torch.empty(3, 1, device="meta", requires_grad=True), torch.empty(1, 3, device="meta")
    with pytest.raises(RuntimeError, match="requires grad"):
        tk.senet_bilinear_fused(emb, w1, w2, torch.empty(5, 5, device="meta"))
    with torch.no_grad():
        for call in (lambda: tk.cross_network_fused(x0, wb, wb), lambda: tk.cin_fused(emb, [w])):
            with pytest.raises(ValueError, match="neither CPU nor CUDA"):
                call()


def test_pair_indices_match_jax():
    for f in (2, 5, 26):
        for a, b in zip(ti.pair_indices(f), ji.pair_indices(f)):
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# interaction modules against the JAX modules, eval and train modes
def _module_case(name, dtype):
    """(JAX module, port module factory, numpy input)."""
    rng = np.random.default_rng(6)
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    f, d = 5, 6
    emb = _normal(rng, 37, f, d)
    cases = {
        "cross": (ji.CrossNetwork(3, dtype=jdt), lambda: ti.CrossNetwork(13, 3), _normal(rng, 37, 13)),
        "cross_matrix": (
            ji.CrossNetworkMatrix(2, dtype=jdt), lambda: ti.CrossNetworkMatrix(13, 2, tdt),
            _normal(rng, 37, 13),
        ),
        "cin": (ji.CIN((5, 9, 3), dtype=jdt), lambda: ti.CIN(f, (5, 9, 3), tdt), emb),
        "senet": (ji.SENet(2, dtype=jdt), lambda: ti.SENet(f, 2, tdt), emb),
        "bilinear_all": (ji.BilinearInteraction("all"), lambda: ti.BilinearInteraction(f, d, "all"), emb),
        "bilinear_each": (ji.BilinearInteraction("each"), lambda: ti.BilinearInteraction(f, d, "each"), emb),
        "bilinear_interaction": (
            ji.BilinearInteraction("interaction"), lambda: ti.BilinearInteraction(f, d, "interaction"), emb,
        ),
        "senet_bilinear": (ji.SENetBilinear(2, dtype=jdt), lambda: ti.SENetBilinear(f, d, 2), emb),
    }
    return cases[name]


MODULES = ["cross", "cross_matrix", "cin", "senet", "bilinear_all", "bilinear_each",
           "bilinear_interaction", "senet_bilinear"]


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MODULES)
def test_interaction_module_matches_jax(name, dtype, mode):
    jm, make, x = _module_case(name, dtype)
    x_dt = x if dtype == "float32" else np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    variables = _redraw(_numpy_tree(jm.init(jax.random.key(0), jnp.asarray(x))), seed=7)
    jx = jnp.asarray(x_dt).astype(dtype)
    want = np.asarray(jm.apply(variables, jx).astype(jnp.float32))
    module = params_from_jax(make(), variables)
    module.train(mode == "train")
    tx = torch.tensor(x_dt).to(getattr(torch, dtype))
    with torch.no_grad():
        out = module(tx)
    assert out.dtype == tx.dtype
    got = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    elif name == "cross" and mode == "eval":
        w = np.concatenate([variables["params"][f"w_{i}"].T for i in range(3)])
        bias = np.stack([variables["params"][f"b_{i}"] for i in range(3)])
        fp32 = jk.cross_network_stack(jnp.asarray(x_dt), jnp.asarray(w), jnp.asarray(bias), interpret=True)
        np.testing.assert_allclose(
            got, np.asarray(fp32.astype(jnp.bfloat16).astype(jnp.float32)), **BF16_ONE_ROUNDING
        )
    else:
        np.testing.assert_allclose(got, want, atol=BF16_SCALED_RTOL * np.abs(want).max(), rtol=0)


def test_modules_dispatch_by_mode():
    """Eval mode calls the kernel's wrapper once; train mode never calls it
    and trains through the plain math."""
    cases = [
        ("cross_network", lambda: ti.CrossNetwork(7, 2), torch.randn(5, 7)),
        ("cin", lambda: ti.CIN(3, (4, 2)), torch.randn(5, 3, 6)),
        ("senet_bilinear", lambda: ti.SENetBilinear(3, 6, 2), torch.randn(5, 3, 6)),
    ]
    gen = torch.Generator().manual_seed(0)
    for name, make, x in cases:
        module = make()
        module.init_weights(gen)
        fused = getattr(tk, f"{name}_fused")
        with mock.patch.object(tk, f"{name}_fused", side_effect=fused) as spy:
            with torch.no_grad():
                module.eval()(x)
            assert spy.call_count == 1, name
            module.train()(x).sum().backward()
            assert spy.call_count == 1, name
        assert all(p.grad is not None for p in module.parameters()), name


# --------------------------------------------------------------------------
# models against the JAX models
MODELS = {
    "dcn": ("dcn", {}),
    "dcn_matrix": ("dcn", {"cross_type": "matrix"}),
    "xdeepfm": ("xdeepfm", {"cin_layer_sizes": (5, 9, 3)}),
    "fibinet_all": ("fibinet", {}),
    "fibinet_each": ("fibinet", {"bilinear_mode": "each"}),
    "fibinet_interaction": ("fibinet", {"bilinear_mode": "interaction"}),
}


def _infos():
    kw = dict(continuous_names=CONT)
    return JDataInfo.from_dims(NAMES, DIMS, **kw), DataInfo.from_dims(NAMES, DIMS, **kw)


def _batch(b=37, seed=0, label=False):
    rng = np.random.default_rng(seed)
    out, off = {}, 0
    for n, d in zip(NAMES, DIMS):
        out[n] = rng.integers(off, off + d, size=(b,))
        off += d
    for c in CONT:
        out[c] = rng.normal(size=(b,)).astype(np.float32)
    if label:
        out["label"] = rng.integers(0, 2, size=(b,)).astype(np.float32)
    return out


def _pair(case, dtype="float32", redraw=True):
    name, params = MODELS[case]
    jinfo, info = _infos()
    batch = _batch()
    jparams = dict(params, **({} if dtype == "float32" else {"dtype": jnp.bfloat16}))
    tparams = dict(params, **({} if dtype == "float32" else {"dtype": "bfloat16"}))
    jmodel = jax_build_model(JModelConfig(name=name, params=jparams, embedding=JEmbeddingConfig(dim=8)), jinfo)
    variables = _numpy_tree(jmodel.init(jax.random.key(0), {k: jnp.asarray(v) for k, v in batch.items()}))
    if redraw:
        variables = _redraw(variables, seed=8)
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
    """Every flax leaf has a port param of the same shape: only a leaf named
    ``kernel`` is transposed; the raw leaves (``w_{i}``, ``compress_{i}``,
    ``squeeze_kernel``...) keep theirs."""
    variables, model, _, _ = _pair(case)
    port = model.state_dict()
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    assert len(flat) == len(port)
    for path, leaf in flat:
        keys = [p.key for p in path]
        transposed = keys[-1] == "kernel"
        name = "weight" if transposed else keys[-1]
        assert tuple(port[".".join(keys[:-1] + [name])].shape) == (leaf.shape[::-1] if transposed else leaf.shape)


def test_bridge_raises_on_unmatched_leaves():
    variables, model, _, _ = _pair("fibinet_all")
    params = variables["params"]
    odd = {"params": {**params, "senet_bilinear": {**params["senet_bilinear"], "squeeze_kernl": np.zeros(1)}}}
    with pytest.raises(KeyError, match="unmatched param leaf"):
        params_from_jax(model, odd)
    stray = {"params": {**params, "senet_bilinear": {**params["senet_bilinear"], "w_7": np.zeros(2)}}}
    with pytest.raises(RuntimeError, match="Unexpected"):
        params_from_jax(model, stray)
    flipped = jax.tree.map(lambda a: a, variables)
    flipped["params"]["senet_bilinear"]["squeeze_kernel"] = params["senet_bilinear"]["squeeze_kernel"].T
    with pytest.raises(RuntimeError, match="size mismatch"):
        params_from_jax(model, flipped)
    dcn_vars, dcn, _, _ = _pair("dcn")
    wrong = jax.tree.map(lambda a: a, dcn_vars)
    wrong["params"]["cross"]["w_0"] = dcn_vars["params"]["cross"]["w_0"].T  # (1, D)
    with pytest.raises(RuntimeError, match="size mismatch"):
        params_from_jax(dcn, wrong)


# --------------------------------------------------------------------------
# one dense-engine train step against the JAX Trainer, then evaluate
TRAIN_CASES = {
    "dcn": ("dcn", {}, "cross_network"),
    "xdeepfm": ("xdeepfm", {"cin_layer_sizes": (5, 9, 3)}, "cin"),
    "fibinet": ("fibinet", {}, "senet_bilinear"),
}


def _jax_grads(jt, js, jbatch, model):
    """The JAX dense step's loss gradient, traced in the training phase as
    its trainer traces the step (so its modules take the reference math)."""

    def loss_fn(params):
        out, _ = jt.model.apply(
            {"params": params, **js.model_state}, jbatch, train=True,
            mutable=["batch_stats", "regularization"], rngs={"dropout": jax.random.key(0)},
        )
        loss, _ = jt.loss_fn(out, jbatch)
        return jadd_auxiliary(loss, out)[0]

    set_training_phase(True)
    try:
        return _by_torch_name(jax.jit(jax.grad(loss_fn))(js.params), model)
    finally:
        set_training_phase(False)


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_step_and_evaluate_match_jax(case):
    """One fp32 dense step: loss, every gradient and every parameter after
    Adam; the step takes the plain math (the kernel's wrapper is not called).
    Then ``evaluate`` over two batches equals JAX's and calls the wrapper
    once a batch."""
    name, params, kernel = TRAIN_CASES[case]
    jinfo, info = _infos()
    data = _batch(b=32, seed=1, label=True)
    jcfg = JExperimentConfig(
        model=JModelConfig(name=name, params=params, embedding=JEmbeddingConfig(dim=8)),
        train=JTrainConfig(compute_dtype="float32", log_every_steps=0),
    )
    cfg = ExperimentConfig.from_json(jcfg.to_json())
    jt = JTrainer(jcfg, jinfo, mesh_ctx=make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    js = jt.init_state(data)
    from tpurec_torch.train.trainer import Trainer

    pt = Trainer(cfg, info, device="cpu")
    ps = pt.init_state(data)
    params_from_jax(ps.model, jax.tree.map(np.asarray, {"params": js.params, **js.model_state}))
    jbatch = jt.device_batch(data)
    want_grads = _jax_grads(jt, js, jbatch, ps.model)
    js2, _, jlogs = jt.train_step(js, jbatch, jt.metrics.init())
    fused = getattr(tk, f"{kernel}_fused")
    with mock.patch.object(tk, f"{kernel}_fused", side_effect=fused) as spy:
        ps2, _, plogs = pt.train_step(ps, pt.device_batch(data), pt.metrics.init())
        assert spy.call_count == 0
        np.testing.assert_allclose(float(plogs["loss"]), float(jlogs["loss"]), atol=FP32["loss"], rtol=0)
        _assert_grads(ps2.model, want_grads, FP32["grad"])
        _assert_params(ps2.model, _by_torch_name(js2.params, ps2.model), FP32["param"])
        evals = [_batch(b=16, seed=10 + i, label=True) for i in range(2)]
        got = pt.evaluate(ps2, evals)
        assert spy.call_count == 2
    want = jt.evaluate(js2, evals)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
