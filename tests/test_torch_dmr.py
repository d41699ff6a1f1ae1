"""The port's DMR, DMT, FinalMLP and SDIM (``models/dmr.py``) against the JAX
package on the CPU.

Inputs are ``tests/test_torch_long_seq.py``'s (``_tiny_dataset``'s schema:
two aligned series of L=16, D=8, with holes, an empty row and rows of
repeated ids), plus seeded ``ctr``/``cvr`` labels for DMT; weights go from
the JAX modules through ``tpurec_torch.bridge``, SDIM's ``constants``
included. Tolerances:

- fp32 models: atol/rtol 1e-5 (``TOL``);
- bf16 compute: each output to 2^-5 of its largest |value|
  (``BF16_SCALED_RTOL``);
- DMR's auxiliary loss: as its model's outputs;
- gradients, one fp32 ``Trainer`` step and ``evaluate``:
  ``tests/test_torch_train.py``'s limits (loss 1e-5, gradients 1e-4 of
  their largest value, parameters after Adam 2e-6, metrics 1e-6);
- SDIM in the fused and lazy-sparse engines over three steps:
  ``tests/test_torch_long_seq.py``'s ``assert_state_matches``.

SDIM's sketches hash: its model tests assert that the smallest |x·p| on
their inputs exceeds ``SIGN_MARGIN``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_long_seq import (
    DTYPES,
    SIGN_MARGIN,
    _close,
    _f32,
    _torch_batch,
    _variable_shapes,
    assert_state_matches,
    smallest_products,
)
from test_torch_long_seq import _data as _long_seq_data
from test_torch_dcn import _redraw
from test_torch_engines_fused import pair, step_both
from test_torch_train import FP32, _assert_grads, _assert_params, _by_torch_name
from tpurec.config import EmbeddingConfig as JEmbeddingConfig
from tpurec.config import ExperimentConfig as JExperimentConfig
from tpurec.config import ModelConfig as JModelConfig
from tpurec.config import OptimizerConfig as JOptimizerConfig
from tpurec.config import TrainConfig as JTrainConfig
from tpurec.core.mesh import make_mesh
from tpurec.models import build_model as jax_build_model
from tpurec.train import Trainer as JTrainer
from tpurec_torch import bridge
from tpurec_torch.bridge import params_from_jax
from tpurec_torch.config import EmbeddingConfig, ExperimentConfig, ModelConfig
from tpurec_torch.initializers import init_parameters
from tpurec_torch.models import build_model
from tpurec_torch.models import dmr as tdmr
from tpurec_torch.ops import embedding_update as eu
from tpurec_torch.serving.export import load_servable
from tpurec_torch.train.trainer import Trainer

torch.set_num_threads(1)

MODELS = {
    # case: (registry name, params)
    "dmr": ("dmr", {}),
    "dmt": ("dmt", {}),
    "dmt_bias": ("dmt", dict(bias_features=["user_tag"])),
    "finalmlp": ("finalmlp", {}),
    "sdim": ("sdim", dict(n_hash_bits=3, short_len=5)),
}
HASHING = ("sdim",)


def _data(b=24, seed=0):
    """``tests/test_torch_long_seq.py``'s batch plus seeded multi-task
    labels."""
    jinfo, info, data = _long_seq_data(b=b, seed=seed)
    rng = np.random.default_rng(seed + 200)
    data["ctr"] = rng.integers(0, 2, size=(b,)).astype(np.float32)
    data["cvr"] = (data["ctr"] * rng.integers(0, 2, size=(b,))).astype(np.float32)
    return jinfo, info, data


def _jparams(params, dtype):
    return dict(params, **({} if dtype == "float32" else {"dtype": jnp.bfloat16}))


@functools.lru_cache(maxsize=None)
def _variables(case, seed=3):
    name, params = MODELS[case]
    jinfo, _, data = _data()
    jm = jax_build_model(JModelConfig(name=name, params=params, embedding=JEmbeddingConfig(dim=8)), jinfo)
    return _redraw(_variable_shapes(jm, data), seed=seed)


def _models(case, dtype="float32"):
    name, params = MODELS[case]
    jinfo, info, _ = _data()
    jm = jax_build_model(JModelConfig(name=name, params=_jparams(params, dtype),
                                      embedding=JEmbeddingConfig(dim=8)), jinfo)
    tparams = dict(params, **({} if dtype == "float32" else {"dtype": "bfloat16"}))
    model = build_model(ModelConfig(name=name, params=tparams, embedding=EmbeddingConfig(dim=8)), info, "cpu")
    return jm, _variables(case), params_from_jax(model, _variables(case))


def _forward(model, batch, hashing):
    with torch.no_grad():
        out, smallest = smallest_products(lambda: model(_torch_batch(batch)))
    if hashing:
        assert smallest and min(smallest) > SIGN_MARGIN, smallest
    return out


OUTPUTS = {
    "dmr": {"logit", "output"},
    "dmt": {"ctr_logit", "ctr_output", "cvr_logit", "cvr_output"},
    "finalmlp": {"logit", "output"},
    "sdim": {"gsu_logits", "esu_logits", "output", "long_term_interest"},
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("case", list(MODELS))
def test_model_matches_jax(case, mode, dtype):
    """Every output in eval and train mode (DMR's ``auxiliary_loss`` in
    training; DMT's bias logit added in training only), its shape and
    dtype."""
    jm, variables, model = _models(case, dtype)
    _, _, batch = _data()
    train = mode == "train"
    want = jm.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()}, train=train)
    getattr(model, mode)()
    got = _forward(model, batch, case in HASHING)
    name = MODELS[case][0]
    assert set(got) == set(want) == OUTPUTS[name] | ({"auxiliary_loss"} if name == "dmr" and train else set())
    for key in want:
        w = _f32(want[key])
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype), key
        _close(got[key].float().numpy(), w, dtype, key)
    key = {"dmt": "ctr_logit", "sdim": "esu_logits"}.get(name, "logit")
    assert np.std(np.asarray(want[key])) > 0.05
    if case == "sdim":
        assert not got["long_term_interest"][0].any()  # no valid step: nothing pooled


def test_dmt_bias_logit_only_in_training():
    """The bias towers exist in both modes, and their logit moves the train
    output but not the eval one."""
    _, _, plain = _models("dmt")
    _, _, biased = _models("dmt_bias")
    batch = _torch_batch(_data()[2])
    assert hasattr(biased, "ctr_bias_tower") and not hasattr(plain, "ctr_bias_tower")
    with torch.no_grad():
        ev, tr = biased.eval()(batch), biased.train()(batch)
    assert (ev["ctr_logit"] - tr["ctr_logit"]).abs().max() > 1e-3


def test_dmr_auxiliary_loss_needs_rows_with_two_valid_steps():
    """A row with fewer than two valid steps adds nothing to DMR's auxiliary
    loss: with every history cut to its first step, the loss is 0 in both
    packages (the mean's denominator is at least 1), and the other outputs
    still match."""
    jm, variables, model = _models("dmr")
    _, _, batch = _data(seed=8)
    for n in ("history", "history_tags"):
        batch[n] = batch[n].copy()
        batch[n][:, 1:] = 0
    want = jm.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()}, train=True)
    with torch.no_grad():
        got = model.train()(_torch_batch(batch))
    assert float(want["auxiliary_loss"]) == float(got["auxiliary_loss"]) == 0.0
    np.testing.assert_allclose(got["logit"].numpy(), np.asarray(want["logit"]), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["dmr", "dmt_bias", "finalmlp", "sdim"])
def test_gradients_match_jax(case):
    """fp32, training mode: the gradient of every parameter (the table
    included) of a weighted sum of the logits plus DMR's auxiliary loss."""
    jm, variables, model = _models(case)
    _, _, batch = _data(seed=6)
    keys = {"dmr": ["logit"], "dmt_bias": ["ctr_logit", "cvr_logit"], "finalmlp": ["logit"],
            "sdim": ["gsu_logits", "esu_logits"]}[case]
    rng = np.random.default_rng(7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    consts = {k: v for k, v in variables.items() if k != "params"}
    shapes = {k: jm.apply(variables, jb)[k].shape for k in keys}
    weights = {k: rng.normal(size=shapes[k]).astype(np.float32) for k in keys}

    def scalar(out, w):
        total = sum((out[k] * w[k]).sum() for k in keys)
        return total + out["auxiliary_loss"] if "auxiliary_loss" in out else total

    want = _by_torch_name(jax.jit(jax.grad(lambda p: scalar(
        jm.apply({"params": p, **consts}, jb, train=True), {k: jnp.asarray(v) for k, v in weights.items()})))(
        variables["params"]), model)
    model.train().zero_grad()
    scalar(model(_torch_batch(batch)), {k: torch.from_numpy(v) for k, v in weights.items()}).backward()
    _assert_grads(model, want, FP32["grad"])
    assert model.emb.embedding.grad.abs().sum() > 0


@pytest.mark.parametrize("case", list(MODELS))
def test_param_shapes_match_jax(case):
    """Every flax leaf, SDIM's ``hash_projections`` included (a buffer, not
    a parameter), has a port tensor of the shape the bridge gives it, and
    nothing is left over; DMR's and DMT's position tables have L rows."""
    _, variables, model = _models(case)
    want = {}
    for path, value in bridge._flatten(variables["params"]):
        name, arr = bridge._torch_leaf("params", path, value, model)
        want[".".join(path[:-1] + (name,))] = arr.shape
    consts = {".".join(p): v.shape for p, v in bridge._flatten(variables.get("constants", {}))}
    assert {**want, **consts} == {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert not set(consts) & {n for n, _ in model.named_parameters()}
    if case == "sdim":
        assert consts == {"hash_projections": (4, 16, 3)}
    if case == "dmr":
        assert want["pos.pos"] == (16, 16)
    if case.startswith("dmt"):
        assert want["pos_0.pos"] == want["pos_1.pos"] == (16, 8)
        assert "dec_0.ln.scale" in want and want["dec_0.out.weight"] == (16, 8)


def test_finalmlp_w12_init_uses_flax_fans():
    """glorot uniform over (h, d1, d2) with fan_in = h·d1 and fan_out = h·d2,
    as flax's ``variance_scaling`` takes a 3-D shape."""
    _, info, _ = _data()
    model = build_model(ModelConfig(name="finalmlp", params=dict(stream_dims=[64, 32], num_fusion_heads=4),
                                    embedding=EmbeddingConfig(dim=8)), info, "cpu", seed=2)
    w = model.w12.detach()
    h, d1, d2 = w.shape
    limit = np.sqrt(6.0 / (h * d1 + h * d2))
    assert tuple(w.shape) == (4, 8, 8)
    assert float(w.abs().max()) <= limit and float(w.abs().max()) > 0.9 * limit
    assert abs(float(w.std()) - limit / np.sqrt(3.0)) < 0.1 * limit


def test_sdim_own_projections_give_jax_sketches():
    """SDIM's own ``hash_projections`` (``make_projections``, key 11) and
    JAX's init, the same params: the same long-term interest and logits on
    the tests' inputs."""
    name, params = MODELS["sdim"]
    jinfo, info, batch = _data(seed=4)
    jm = jax_build_model(JModelConfig(name=name, params=params, embedding=JEmbeddingConfig(dim=8)), jinfo)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    real = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jb))
    variables = {"params": _variables("sdim")["params"], "constants": real["constants"]}
    want = jm.apply(variables, jb)
    model = build_model(ModelConfig(name=name, params=params, embedding=EmbeddingConfig(dim=8)), info, "cpu")
    np.testing.assert_array_max_ulp(model.hash_projections.numpy(), real["constants"]["hash_projections"],
                                    maxulp=4)
    own = {k: v.numpy() for k, v in model.named_buffers()}
    params_from_jax(model, {"params": variables["params"], "constants": own})
    got = _forward(model.eval(), batch, True)
    for key in ("long_term_interest", "gsu_logits", "esu_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5, rtol=1e-5, err_msg=key)


def test_position_tables_need_the_sequence_length():
    _, info, _ = _data()
    kw = dict(user_features=["user_tag"], item_features=["item_id"], sequence_features=["history"],
              vocab_size=info.total_dims)
    for cls in (tdmr.DMR, tdmr.DMT):
        with pytest.raises(ValueError, match="max_seq_length"):
            cls(**kw)
    model = init_parameters(tdmr.DMR(**kw, max_seq_length=32), seed=0)
    assert tuple(model.pos.pos.shape) == (32, 8)


# --------------------------------------------------------------------------
# the Trainer
TRAIN_CASES = {"dmr": "bce", "dmt_bias": "multi_task", "sdim": "gsu_esu"}


def _configs(case, loss, engine=None, used_id_l2=0.0, **train):
    name, params = MODELS[case]
    if engine is not None:
        train.update(sparse_embedding=True, optimizer=JOptimizerConfig(embedding_optimizer=engine))
    jcfg = JExperimentConfig(
        model=JModelConfig(name=name, params=params, embedding=JEmbeddingConfig(dim=8, used_id_l2=used_id_l2)),
        train=JTrainConfig(compute_dtype="float32", log_every_steps=0, loss=loss, **train),
    )
    return jcfg, ExperimentConfig.from_json(jcfg.to_json())


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_step_and_evaluate_match_jax(case):
    """One fp32 dense step: the loss, DMR's auxiliary term, every parameter
    after Adam, SDIM's constants untouched; then ``evaluate`` over two
    batches."""
    jcfg, cfg = _configs(case, TRAIN_CASES[case])
    jinfo, info, data = _data(b=32, seed=1)
    jt = JTrainer(jcfg, jinfo, mesh_ctx=make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    js = jt.init_state(data)
    pt = Trainer(cfg, info, device="cpu")
    ps = pt.init_state(data)
    params_from_jax(ps.model, jax.tree.map(np.asarray, {"params": js.params, **js.model_state}))
    buffers = {k: v.clone() for k, v in ps.model.named_buffers()}
    js2, _, jlogs = jt.train_step(js, jt.device_batch(data), jt.metrics.init())
    ps2, _, plogs = pt.train_step(ps, pt.device_batch(data), pt.metrics.init())
    assert set(plogs) == set(jlogs)
    for key in jlogs:
        np.testing.assert_allclose(float(plogs[key]), float(jlogs[key]), atol=FP32["loss"], rtol=0, err_msg=key)
    assert ("auxiliary_loss" in plogs) == (case == "dmr")
    _assert_params(ps2.model, _by_torch_name(js2.params, ps2.model), FP32["param"])
    for name, value in ps2.model.named_buffers():
        assert torch.equal(value, buffers[name]), name
    evals = [_data(b=16, seed=10 + i)[2] for i in range(2)]
    got, want = pt.evaluate(ps2, evals), jt.evaluate(js2, evals)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("engine", ["fused_adam", "adam"])
def test_sdim_sparse_engines_match_jax(engine):
    """Three fp32 ``gsu_esu`` steps of SDIM with the used-id L2 on (1e-3):
    the loss each step, then the table, its optimizer state and every dense
    parameter; the constants stay as loaded; the CPU takes #9's plain
    version."""
    jcfg, cfg = _configs("sdim", "gsu_esu", engine=engine, used_id_l2=1e-3)
    jinfo, info, first = _data(b=16, seed=20)
    jt, js, pt, ps = pair(jcfg, cfg, jinfo, info, first)
    buffers = {k: v.clone() for k, v in ps.model.named_buffers()}
    before = eu.fused_scatter_add.launches
    for i in range(3):
        js, ps, _ = step_both(jt, js, pt, ps, _data(b=16, seed=21 + i)[2])
    assert_state_matches(js, ps)
    assert eu.fused_scatter_add.launches == before
    assert set(ps.table_opt) == {"emb.embedding"}
    for name, value in ps.model.named_buffers():
        assert torch.equal(value, buffers[name]), name


def test_sdim_constants_survive_checkpoint_export_and_servable(tmp_path):
    """SDIM's projections (distinct values, loaded through the bridge) ride
    through ``save``/``restore`` and ``export`` → ``load_servable`` →
    ``predict``."""
    _, cfg = _configs("sdim", "gsu_esu", checkpoint_dir=str(tmp_path / "ckpt"))
    _, info, data = _data(b=16, seed=50)
    pt = Trainer(cfg, info, device="cpu")
    ps = pt.init_state(data)
    params_from_jax(ps.model, jax.tree.map(np.asarray, _variables("sdim")))
    proj = ps.model.hash_projections.clone()
    ps, _, _ = pt.train_step(ps, pt.device_batch(data), pt.metrics.init())
    pt.save(ps)
    fresh = pt.init_state(data)
    assert not torch.equal(fresh.model.hash_projections, proj)
    assert torch.equal(pt.restore(fresh).model.hash_projections, proj)
    pt.export(ps, str(tmp_path / "export"))
    servable = load_servable(str(tmp_path / "export"), info, device="cpu")
    assert torch.equal(servable.model.hash_projections, proj)
    want = pt.infer(ps, data)
    got = servable.predict(data)
    for key in ("long_term_interest", "output"):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=1e-6, rtol=0, err_msg=key)
