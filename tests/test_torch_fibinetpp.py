"""The port's FiBiNET++ family (``models/fibinetpp.py``: fibinet_pp, masknet
in its serial and parallel modes, contextnet with pointwise and
single-layer blocks) and flax's ``BatchNorm`` with a ``dtype`` against the
JAX package on the CPU.

Inputs are made with numpy from a seed (``tests/test_torch_dcn.py``'s
schema: 4 fields over 152 ids and 3 continuous columns, D=8); weights go
from the JAX models through ``tpurec_torch.bridge``, every leaf redrawn
(norm scales about 1, running statistics a trained model would hold).
Tolerances:

- fp32 modules and models: atol/rtol 1e-5 (``TOL``; sums in other orders);
- bf16 compute: each output to 2^-5 of its largest |value|
  (``BF16_SCALED_RTOL``), as ``tests/test_torch_dcn_rest.py``'s modules;
- running statistics: 1e-6;
- gradients and one fp32 ``Trainer`` step: ``tests/test_torch_train.py``'s
  limits (gradients 1e-4 of their largest value, loss 1e-5, parameters
  after Adam 2e-6), ``evaluate``'s metrics to 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from test_torch_dcn import BF16_SCALED_RTOL, TOL, _batch, _infos, _normal, _numpy_tree, _redraw
from test_torch_train import FP32, _assert_grads, _assert_params, _by_torch_name
from tpurec.config import EmbeddingConfig as JEmbeddingConfig
from tpurec.config import ExperimentConfig as JExperimentConfig
from tpurec.config import ModelConfig as JModelConfig
from tpurec.config import TrainConfig as JTrainConfig
from tpurec.core.mesh import make_mesh
from tpurec.models import build_model as jax_build_model
from tpurec.train import Trainer as JTrainer
from tpurec_torch import bridge
from tpurec_torch.bridge import params_from_jax
from tpurec_torch.config import EmbeddingConfig, ExperimentConfig, ModelConfig
from tpurec_torch.models import build_model
from tpurec_torch.ops import mlp as tmlp
from tpurec_torch.train.trainer import Trainer

torch.set_num_threads(1)

DTYPES = ["float32", "bfloat16"]


def _close(got, want, dtype, key=""):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=key, **TOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_SCALED_RTOL * np.abs(want).max(), rtol=0,
                                   err_msg=key)


def _stats(rng, shapes):
    """Running statistics a trained model would hold: means about 0,
    variances about 0.1."""
    return {name: {"mean": _normal(rng, *s["mean"].shape, scale=0.1),
                   "var": np.abs(_normal(rng, *s["var"].shape, scale=0.05)) + 0.05}
            for name, s in shapes.items()}


# --------------------------------------------------------------------------
# flax's BatchNorm with a dtype
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("in_dtype", DTYPES)
def test_batch_norm_with_dtype_matches_flax(in_dtype, train):
    """``nn.BatchNorm(dtype=bfloat16)`` (FiBiNET++'s ``cat_bn``): the
    statistics and the normalisation in fp32, the result in bf16; in
    training also the updated running statistics."""
    rng = np.random.default_rng(1)
    x = np.asarray(jnp.asarray(_normal(rng, 37, 6, scale=2.0) + 1.0).astype(in_dtype).astype(jnp.float32))
    jm = fnn.BatchNorm(dtype=jnp.bfloat16)
    jx = jnp.asarray(x).astype(in_dtype)
    variables = _numpy_tree(jm.init(jax.random.key(0), jx, use_running_average=True))
    variables["params"] = _redraw(variables["params"], seed=2)
    variables["batch_stats"] = {"mean": _normal(rng, 6, scale=0.3), "var": np.abs(_normal(rng, 6)) + 0.5}
    want, stats = jm.apply(variables, jx, use_running_average=not train, mutable=["batch_stats"])
    module = params_from_jax(tmlp.BatchNorm(6, dtype=torch.bfloat16), variables).train(train)
    got = module(torch.tensor(x).to(getattr(torch, in_dtype)))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # one bf16 rounding of the same fp32 value, or of a neighbour
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2.0**-8, atol=1e-6)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(module, name).numpy(), np.asarray(stats["batch_stats"][key]),
                                   atol=1e-6, rtol=1e-6)


def test_nfm_bn_output_is_unchanged_by_the_dtype_argument():
    """NFM's ``bn`` takes no dtype: in a bf16 NFM it still returns fp32, the
    values of flax's ``nn.BatchNorm()`` (``dtype=None``) on the same input."""
    jinfo, info = _infos()
    model = build_model(ModelConfig(name="nfm", params={"dtype": "bfloat16"}, embedding=EmbeddingConfig(dim=8)),
                        info, "cpu")
    assert model.bn.dtype is None
    seen = {}
    model.bn.register_forward_hook(lambda m, args, out: seen.update(x=args[0], y=out))
    state = {k: v.clone() for k, v in model.bn.state_dict().items()}
    with torch.no_grad():
        model.train()({k: torch.as_tensor(v) for k, v in _batch(label=True).items()})
    assert seen["x"].dtype == torch.bfloat16 and seen["y"].dtype == torch.float32
    variables = {"params": {"scale": state["scale"].numpy(), "bias": state["bias"].numpy()},
                 "batch_stats": {"mean": state["running_mean"].numpy(), "var": state["running_var"].numpy()}}
    want, _ = fnn.BatchNorm().apply(variables, jnp.asarray(seen["x"].float().numpy()).astype(jnp.bfloat16),
                                    use_running_average=False, mutable=["batch_stats"])
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(seen["y"].numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------------
# the models
MODELS = {
    # case: (registry name, params)
    "fibinet_pp": ("fibinet_pp", {}),
    "masknet_serial": ("masknet", {"mode": "serial"}),
    "masknet_parallel": ("masknet", {"mode": "parallel"}),
    "contextnet_pointwise": ("contextnet", {"block_mode": "pointwise"}),
    "contextnet_singlelayer": ("contextnet", {"block_mode": "singlelayer"}),
}


def _jparams(params, dtype):
    return dict(params, **({} if dtype == "float32" else {"dtype": jnp.bfloat16}))


@functools.lru_cache(maxsize=None)
def _variables(case):
    name, params = MODELS[case]
    jinfo, _ = _infos()
    jm = jax_build_model(JModelConfig(name=name, params=params, embedding=JEmbeddingConfig(dim=8)), jinfo)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    shapes = fnn.unbox(jax.eval_shape(jm.init, jax.random.key(0), batch))
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 1.0 if path[-1].key == "scale" else a, _redraw(shapes["params"], seed=3))
    return {"params": params, "batch_stats": _stats(np.random.default_rng(4), shapes["batch_stats"])}


def _models(case, dtype="float32"):
    """(JAX model, its variables, the port model with the same weights)."""
    name, params = MODELS[case]
    jinfo, info = _infos()
    jm = jax_build_model(JModelConfig(name=name, params=_jparams(params, dtype),
                                      embedding=JEmbeddingConfig(dim=8)), jinfo)
    tparams = dict(params, **({} if dtype == "float32" else {"dtype": "bfloat16"}))
    model = build_model(ModelConfig(name=name, params=tparams, embedding=EmbeddingConfig(dim=8)), info, "cpu")
    variables = _variables(case)
    return jm, variables, params_from_jax(model, variables)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("case", list(MODELS))
def test_model_matches_jax(case, mode, dtype):
    """Every output in eval mode (the running statistics) and in train mode
    (the batch's, and the running statistics ``cat_bn`` leaves), its shape
    and dtype."""
    jm, variables, model = _models(case, dtype)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    train = mode == "train"
    want, state = jm.apply(variables, jb, train=train, mutable=["batch_stats", "regularization"])
    getattr(model, mode)()
    with torch.no_grad():
        got = model({k: torch.as_tensor(v) for k, v in batch.items()})
    assert set(got) == set(want) == {"logit", "output"}
    for key in want:
        w = np.asarray(jnp.asarray(want[key]).astype(jnp.float32))
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype), key
        _close(got[key].float().numpy(), w, dtype, key)
    assert np.std(np.asarray(want["logit"])) > 0.05
    stats = state["batch_stats"]["cat_bn"] if train else variables["batch_stats"]["cat_bn"]
    for buf, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(model.cat_bn, buf).numpy(), np.asarray(stats[key]),
                                   atol=1e-6, rtol=1e-6, err_msg=buf)


@pytest.mark.parametrize("case", list(MODELS))
def test_gradients_match_jax(case):
    """fp32 train mode: the gradient of every parameter (the shared table's
    and ``cont_emb``'s included) of a weighted sum of the logits."""
    jm, variables, model = _models(case)
    batch = _batch(seed=5)
    weights = np.random.default_rng(6).normal(size=37).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(params):
        out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, jb, train=True,
                          mutable=["batch_stats", "regularization"])
        return jnp.sum(out["logit"] * weights)

    want = _by_torch_name(jax.jit(jax.grad(loss))(variables["params"]), model)
    model.train().zero_grad()
    (model({k: torch.as_tensor(v) for k, v in batch.items()})["logit"] * torch.from_numpy(weights)).sum().backward()
    _assert_grads(model, want, FP32["grad"])
    assert model.cont_emb.grad.abs().sum() > 0


@pytest.mark.parametrize("case", list(MODELS))
def test_param_shapes_match_jax(case):
    """Every flax leaf (and running statistic) has a port parameter or
    buffer of the shape the bridge gives it, and nothing is left over: the
    raw ``bilinear_w``, ``ctx_proj`` and ``ffn_w_{i}`` keep their layouts."""
    _, variables, model = _models(case)
    want = {}
    for collection in ("params", "batch_stats"):
        for path, value in bridge._flatten(variables[collection]):
            name, arr = bridge._torch_leaf(collection, path, value, model)
            want[".".join(path[:-1] + (name,))] = arr.shape
    assert want == {k: tuple(v.shape) for k, v in model.state_dict().items()}
    raw = {k: v for k, v in want.items() if k in ("bilinear_w", "ctx_proj") or k.startswith("ffn_w_")}
    expected = {"fibinet_pp": {"bilinear_w": (8, 8)},
                "contextnet_pointwise": {"ctx_proj": (7, 64, 8)},
                "contextnet_singlelayer": {"ctx_proj": (7, 64, 8), "ffn_w_0": (7, 8, 8), "ffn_w_1": (7, 8, 8)}}
    assert raw == expected.get(case, {})


def test_train_step_and_evaluate_match_jax():
    """fibinet_pp, one fp32 dense step: the loss, every parameter after Adam
    and ``cat_bn``'s running statistics (the gradients are
    ``test_gradients_match_jax``'s); then ``evaluate`` over two batches."""
    jinfo, info = _infos()
    data = _batch(b=32, seed=1, label=True)
    jcfg = JExperimentConfig(
        model=JModelConfig(name="fibinet_pp", embedding=JEmbeddingConfig(dim=8)),
        train=JTrainConfig(compute_dtype="float32", log_every_steps=0),
    )
    cfg = ExperimentConfig.from_json(jcfg.to_json())
    jt = JTrainer(jcfg, jinfo, mesh_ctx=make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    js = jt.init_state(data)
    pt = Trainer(cfg, info, device="cpu")
    ps = pt.init_state(data)
    params_from_jax(ps.model, jax.tree.map(np.asarray, {"params": js.params, **js.model_state}))
    js2, _, jlogs = jt.train_step(js, jt.device_batch(data), jt.metrics.init())
    ps2, _, plogs = pt.train_step(ps, pt.device_batch(data), pt.metrics.init())
    np.testing.assert_allclose(float(plogs["loss"]), float(jlogs["loss"]), atol=FP32["loss"], rtol=0)
    _assert_params(ps2.model, _by_torch_name(js2.params, ps2.model), FP32["param"])
    stats = js2.model_state["batch_stats"]["cat_bn"]
    for buf, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(ps2.model.cat_bn, buf).numpy(), np.asarray(stats[key]),
                                   atol=1e-6, rtol=0, err_msg=buf)
    evals = [_batch(b=16, seed=10 + i, label=True) for i in range(2)]
    got, want = pt.evaluate(ps2, evals), jt.evaluate(js2, evals)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=1e-6, err_msg=k)
