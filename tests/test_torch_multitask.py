"""The port's multi-task and personalization families (``models/multitask.py``:
mmoe, esmm, ple, esm2, escm2, fdn; ``models/poso.py``: poso_mlp, poso_mha,
poso_mmoe, pepnet) against the JAX package on the CPU.

Inputs are made with numpy from a seed (4 fields over 40 ids, D=8, one
continuous column); weights go from the JAX models through
``tpurec_torch.bridge``. Tolerances:

- fp32 modules, models, losses: atol/rtol 1e-5 (``TOL``; the two frameworks
  sum in different orders);
- bf16 compute: each output to 2^-5 of its largest |value|
  (``BF16_SCALED_RTOL``: bf16 roundings, 2^-9 relative each, taken at other
  places by torch and XLA), as ``tests/test_torch_dcn_rest.py``'s modules;
- gradients and one fp32 ``Trainer`` step: ``tests/test_torch_train.py``'s
  limits (loss 1e-5, gradients 1e-4 of their largest value, parameters
  after Adam 2e-6); the metrics of ``evaluate`` to 1e-6;
- the fused and lazy-sparse engines over three steps:
  ``tests/test_torch_engines_fused.py``'s limits;
- the CLI journey: the port's shards equal tpurec's; after one fp32 epoch
  (25 Adam steps at lr 1e-2) from the same weights the eval loss to 1e-3
  relative and the AUCs to 1e-3 (a gradient near Adam's eps turns a
  rounding difference into a step of up to lr, and an AUC moves when two
  scores so moved swap; measured 3e-4 and 4e-4).
"""

import contextlib
import functools
import io
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from test_torch_dcn import BF16_SCALED_RTOL, TOL, _redraw
from test_torch_engines_fused import assert_state_matches, pair, step_both
from test_torch_train import FP32, _assert_grads, _assert_params, _by_torch_name
from tpurec import cli as jcli
from tpurec.config import EmbeddingConfig as JEmbeddingConfig
from tpurec.config import ExperimentConfig as JExperimentConfig
from tpurec.config import ModelConfig as JModelConfig
from tpurec.config import OptimizerConfig as JOptimizerConfig
from tpurec.config import TrainConfig as JTrainConfig
from tpurec.core.mesh import make_mesh
from tpurec.data.loader import ArrayLoader as JArrayLoader
from tpurec.data.loader import load_columnar as jload_columnar
from tpurec.data.schema import DataInfo as JDataInfo
from tpurec.models import build_model as jax_build_model
from tpurec.models.multitask import ExpertBank as JExpertBank
from tpurec.train import Trainer as JTrainer
from tpurec_torch import cli
from tpurec_torch import bridge
from tpurec_torch.bridge import params_from_jax
from tpurec_torch.config import EmbeddingConfig, ExperimentConfig, ModelConfig
from tpurec_torch.data.loader import load_columnar, shard_paths
from tpurec_torch.data.schema import DataInfo
from tpurec_torch.models import build_model
from tpurec_torch.models.multitask import ExpertBank
from tpurec_torch.ops import embedding_update as eu
from tpurec_torch.train.trainer import Trainer

torch.set_num_threads(1)

NAMES, DIMS, CONT = ["uid", "iid", "utag", "itag"], [10, 12, 8, 10], ["c1"]
CHAIN = ("click", "cart", "collect", "none", "order", "pay")
DTYPES = ["float32", "bfloat16"]

MODELS = {
    # case: (registry name, params)
    "mmoe": ("mmoe", {}),
    "esmm": ("esmm", {}),
    "ple": ("ple", {}),
    "esm2": ("esm2", {}),
    "escm2_ips": ("escm2", {}),
    "escm2_dr": ("escm2", {"counterfact_mode": "dr"}),
    "escm2_mmoe": ("escm2", {"trunk": "mmoe"}),
    "fdn": ("fdn", {}),
    "poso_mlp": ("poso_mlp", {}),
    "poso_mha": ("poso_mha", {}),
    "poso_mmoe": ("poso_mmoe", {}),
    "pepnet": ("pepnet", {}),
}


def _infos():
    kw = dict(continuous_names=CONT)
    return JDataInfo.from_dims(NAMES, DIMS, **kw), DataInfo.from_dims(NAMES, DIMS, **kw)


def _batch(b=24, seed=0, chain=False):
    """Ids, one continuous column, a click label ``ctr`` (and ``label``, the
    same), a conversion ``cvr`` only where ``ctr`` = 1, and with ``chain``
    the six chain labels: one of {cart, collect, none} given a click, order
    and pay below them."""
    rng = np.random.default_rng(seed)
    out, off = {}, 0
    for n, d in zip(NAMES, DIMS):
        out[n] = rng.integers(off, off + d, size=(b,))
        off += d
    out["c1"] = rng.normal(size=(b,)).astype(np.float32)
    ctr = (rng.random(b) < 0.5).astype(np.float32)
    out["ctr"] = out["label"] = ctr
    out["cvr"] = ctr * (rng.random(b) < 0.5).astype(np.float32)
    if chain:
        branch = rng.integers(0, 3, size=b)
        out["click"] = ctr
        for i, node in enumerate(("cart", "collect", "none")):
            out[node] = ctr * (branch == i)
        out["order"] = out["cvr"]
        out["pay"] = out["order"] * (rng.random(b) < 0.7)
        for node in CHAIN:
            out[node] = out[node].astype(np.float32)
    return out


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _close(got, want, dtype, key=""):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=key, **TOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_SCALED_RTOL * np.abs(want).max(), rtol=0,
                                   err_msg=key)


@functools.lru_cache(maxsize=None)
def _variables(case, dtype, seed=3):
    """The JAX model's variables for ``case``, every leaf redrawn from
    N(0, 0.3²) so that every bias and gate does work (cached per case)."""
    name, params = MODELS[case]
    jinfo, _ = _infos()
    jm = jax_build_model(JModelConfig(name=name, params=_jparams(params, dtype),
                                      embedding=JEmbeddingConfig(dim=8)), jinfo)
    return _redraw(_shapes(jm, _jbatch(_batch(chain=True))), seed=seed)


def _shapes(module, *args):
    """The variables' tree of ``module`` as shapes only (``jax.eval_shape``:
    no initializer runs), for ``_redraw`` to fill."""
    shapes = fnn.unbox(jax.eval_shape(module.init, jax.random.key(0), *args))
    return {k: v for k, v in shapes.items() if k != "regularization"}


def _jparams(params, dtype):
    return dict(params, **({} if dtype == "float32" else {"dtype": jnp.bfloat16}))


def _models(case, dtype="float32", variables=None, **extra):
    """(JAX model, its variables, the port model with the same weights);
    ``extra`` params on top of the case's."""
    name, params = MODELS[case]
    params = dict(params, **extra)
    jinfo, info = _infos()
    jm = jax_build_model(JModelConfig(name=name, params=_jparams(params, dtype),
                                      embedding=JEmbeddingConfig(dim=8)), jinfo)
    tparams = dict(params, **({} if dtype == "float32" else {"dtype": "bfloat16"}))
    model = build_model(ModelConfig(name=name, params=tparams, embedding=EmbeddingConfig(dim=8)),
                        info, "cpu")
    variables = _variables(case, dtype) if variables is None else variables
    return jm, variables, params_from_jax(model, variables)


# --------------------------------------------------------------------------
# the expert bank
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ndim", [2, 3])
def test_expert_bank_matches_jax(ndim, dtype):
    """A (B, in) input broadcast over the experts, and a (B, E, in) input of
    one stream an expert; the products in the input's dtype."""
    rng = np.random.default_rng(1)
    shape = (37, 13) if ndim == 2 else (37, 3, 13)
    x = np.asarray(jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(dtype)
                   .astype(jnp.float32))
    jm = JExpertBank(3, (16, 8), dtype=None if dtype == "float32" else jnp.bfloat16)
    variables = _redraw(_shapes(jm, jnp.asarray(x)), seed=2)
    want = np.asarray(jm.apply(variables, jnp.asarray(x).astype(dtype)).astype(jnp.float32))
    module = params_from_jax(ExpertBank(13, 3, (16, 8)), variables)
    with torch.no_grad():
        got = module(torch.tensor(x).to(getattr(torch, dtype)))
    assert got.shape == (37, 3, 8) == want.shape and got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), want, dtype)
    assert (want > 0).mean() > 0.2  # the relus pass a share of the outputs


def test_expert_bank_init_uses_receptive_field_fans():
    """glorot uniform over (E, in, out): fan_in = in·E, fan_out = out·E, as
    flax's initializer; zero biases."""
    module = ExpertBank(40, 4, (64,))
    module.init_weights(torch.Generator().manual_seed(0))
    limit = np.sqrt(6.0 / (4 * 40 + 4 * 64))
    w = module.w_0.detach()
    assert float(w.abs().max()) <= limit and float(w.abs().max()) > 0.95 * limit
    want = fnn.unbox(JExpertBank(4, (64,)).init(jax.random.key(0), jnp.zeros((2, 40))))["params"]["w_0"]
    np.testing.assert_allclose(float(w.std()), float(jnp.std(want)), rtol=0.05)
    assert not module.b_0.detach().any()


# --------------------------------------------------------------------------
# the models against the JAX models
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("case", list(MODELS))
def test_model_matches_jax(case, mode, dtype):
    """Every output (and the in-model loss where the batch has labels) in
    eval and train mode; ESM2 on the ctr/cvr aliases."""
    jm, variables, model = _models(case, dtype)
    batch = _batch()
    want = jm.apply(variables, _jbatch(batch), train=mode == "train")
    getattr(model, mode)()
    with torch.no_grad():
        got = model(_tbatch(batch))
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(jnp.asarray(want[key]).astype(jnp.float32))
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype), key
        _close(got[key].float().numpy(), w, dtype, key)
    logits = [k for k in want if k.endswith("logit")]
    assert np.std(np.asarray(want[logits[0]])) > 0.05


@pytest.mark.parametrize("case", list(MODELS))
def test_param_shapes_match_jax(case):
    """Every flax leaf has a port parameter of the shape the bridge gives
    it and nothing is left over; the expert banks' and FDN's raw leaves keep
    their names and shapes."""
    _, variables, model = _models(case)
    want = {}
    for path, value in bridge._flatten(variables["params"]):
        name, arr = bridge._torch_leaf("params", path, value, model)
        want[".".join(path[:-1] + (name,))] = arr.shape
    assert want == {k: tuple(v.shape) for k, v in model.state_dict().items()}
    raw = [k for k in want if k.endswith(("aux_w", "aux_b"))]
    assert len(raw) == (8 if case == "fdn" else 0)


@pytest.mark.parametrize("case", ["esm2_chain", "esm2_alias", "escm2_ips", "escm2_dr", "fdn"])
def test_in_model_losses_match_jax(case):
    """ESM2's per-node BCEs on the full chain and on the ctr/cvr aliases,
    ESCM2's IPS and DR losses, FDN's total and its ``orth_loss_value``."""
    model_case = case if not case.startswith("esm2") else "esm2"
    jm, variables, model = _models(model_case)
    batch = _batch(seed=5, chain=case == "esm2_chain")
    want = jm.apply(variables, _jbatch(batch), train=True)
    with torch.no_grad():
        got = model.train()(_tbatch(batch))
    keys = ["loss"] + (["orth_loss_value"] if case == "fdn" else [])
    for key in keys:
        assert got[key].dtype == torch.float32 and got[key].shape == ()
        np.testing.assert_allclose(float(got[key]), float(want[key]), err_msg=key, **TOL)
    if case.startswith("esm2"):  # the chain changes the loss: the labels are read
        alias = jm.apply(variables, _jbatch(_batch(seed=5)), train=True)["loss"]
        assert (case == "esm2_chain") == (abs(float(alias) - float(want["loss"])) > 1e-3)
    unlabelled = {k: v for k, v in batch.items() if k not in ("ctr", "cvr", "label") + CHAIN}
    with torch.no_grad():
        assert "loss" not in model(_tbatch(unlabelled))


def _scalar(out, weights):
    """A fixed weighted sum of every logit plus the in-model loss."""
    total = 0.0
    for key in sorted(out):
        if key.endswith("logit"):
            total = total + (out[key] * weights[: out[key].shape[0]]).sum()
    return total + out["loss"] if "loss" in out else total


@pytest.mark.parametrize("case", list(MODELS))
def test_gradients_match_jax(case):
    """The gradient of every parameter (the shared table's included: POSO
    sums its two lookups') of a weighted sum of the logits plus the
    in-model loss, fp32."""
    jm, variables, model = _models(case)
    batch = _batch(seed=6, chain=True)
    weights = np.random.default_rng(7).normal(size=64).astype(np.float32)
    jb = _jbatch(batch)

    def loss(params):
        return _scalar(jm.apply({"params": params}, jb, train=True), jnp.asarray(weights))

    want = _by_torch_name(jax.jit(jax.grad(loss))(variables["params"]), model)
    model.train().zero_grad()
    _scalar(model(_tbatch(batch)), torch.from_numpy(weights)).backward()
    _assert_grads(model, want, FP32["grad"])


def test_escm2_propensity_carries_no_gradient():
    """IPS with only the counterfactual CVR term weighted: the propensity
    is detached, so the CTR tower and the last level's CTR experts and gate
    get no gradient, in either package, while the CVR side does."""
    jm, variables, model = _models("escm2_ips", ctr_weight=0.0, ctcvr_weight=0.0)
    jb = _jbatch(_batch(seed=8))
    want = _by_torch_name(
        jax.jit(jax.grad(lambda p: jm.apply({"params": p}, jb, train=True)["loss"]))(variables["params"]), model)
    model.train()(_tbatch(_batch(seed=8)))["loss"].backward()
    ctr_side = ("trunk.ctr_tower.", "trunk.ctr_head.", "trunk.L1_ctr_gate.", "trunk.L1_ctr_experts.")
    for n, p in model.named_parameters():
        if n.startswith(ctr_side):
            assert p.grad is None or not p.grad.any(), n
            assert not want[n].any(), n
    assert model.trunk.cvr_head.weight.grad.abs().sum() > 0
    _assert_grads(model, want, FP32["grad"])


def test_pepnet_ppnet_input_carries_no_gradient():
    """With each head's weights on the base tower zeroed, the logits reach
    the embeddings only through PPNet's towers, whose input is detached:
    the table's gradient is zero but on the gate field's rows (through the
    personalization input), in both packages."""
    variables = jax.tree.map(np.copy, _variables("pepnet", "float32"))
    for task in ("ctr", "cvr"):
        kernel = variables["params"][f"{task}_head"]["kernel"]  # (2·H, 1): [base ∥ ppnet]
        kernel[: kernel.shape[0] // 2] = 0.0
    jm, variables, model = _models("pepnet", variables=variables)
    batch = _batch(seed=9)
    jb = _jbatch(batch)

    def loss(params):
        out = jm.apply({"params": params}, jb, train=True)
        return jnp.sum(out["ctr_logit"]) + jnp.sum(out["cvr_logit"])

    want = _by_torch_name(jax.jit(jax.grad(loss))(variables["params"]), model)
    out = model.train()(_tbatch(batch))
    (out["ctr_logit"].sum() + out["cvr_logit"].sum()).backward()
    grad = model.emb.embedding.grad
    rows = grad.abs().sum(dim=1).nonzero().reshape(-1).numpy()
    assert set(rows) == set(batch["uid"].tolist())  # the gate field's ids only
    np.testing.assert_array_equal(np.abs(want["emb.embedding"]).sum(axis=1) > 0,
                                  grad.abs().sum(dim=1).numpy() > 0)
    _assert_grads(model, want, FP32["grad"])


# --------------------------------------------------------------------------
# the bridge's raw leaves
def test_bridge_loads_fdn_aux_heads_narrowly():
    """FDN's ``L{l}_{t}_aux_w``/``_aux_b`` match none of the earlier keep
    rules, so those raised on them; the rule that loads them holds only
    where the port module at the path owns such a parameter."""
    assert "L0_ctr_aux_w" not in bridge._PARAM_KEEP
    assert not bridge._INDEXED_KEEP.fullmatch("L0_ctr_aux_w")
    assert not bridge._INDEXED_KEEP.fullmatch("L1_cvr_aux_b")
    _, variables, model = _models("fdn")
    np.testing.assert_array_equal(model.L1_cvr_aux_w.detach().numpy(), variables["params"]["L1_cvr_aux_w"])
    np.testing.assert_array_equal(model.L0_ctr_aux_b.detach().numpy(), variables["params"]["L0_ctr_aux_b"])
    params = variables["params"]
    moved = {"params": {**{k: v for k, v in params.items() if k != "L0_ctr_aux_w"},
                        "L0_ctr_experts": {**params["L0_ctr_experts"], "L0_ctr_aux_w": params["L0_ctr_aux_w"]}}}
    with pytest.raises(KeyError, match="unmatched param leaf"):
        params_from_jax(model, moved)
    # a model without aux heads: the leaf is not kept at its root either
    _, mmoe_vars, mmoe = _models("mmoe")
    stray = {"params": {**mmoe_vars["params"], "L0_ctr_aux_w": params["L0_ctr_aux_w"]}}
    with pytest.raises(KeyError, match="unmatched param leaf"):
        params_from_jax(mmoe, stray)


# --------------------------------------------------------------------------
# one dense Trainer step against tpurec's, then evaluate
TRAIN_CASES = {
    "mmoe": ("mmoe", "multi_task"),
    "escm2": ("escm2", "model_loss"),
    "fdn": ("fdn", "model_loss"),
    "poso_mmoe": ("poso_mmoe", "multi_task"),
}


def _configs(name, loss, **train):
    metrics = ("ctr_auc", "cvr_auc") if loss == "model_loss" else ()
    jcfg = JExperimentConfig(
        model=JModelConfig(name=name, embedding=JEmbeddingConfig(dim=8, **train.pop("emb", {}))),
        train=JTrainConfig(compute_dtype="float32", log_every_steps=0, loss=loss, metrics=metrics,
                           **train),
    )
    return jcfg, ExperimentConfig.from_json(jcfg.to_json())


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_step_and_evaluate_match_jax(case):
    """One fp32 dense step: the loss, every parameter after Adam and the
    streaming metrics (the gradients are ``test_gradients_match_jax``'s);
    then ``evaluate`` over two batches (``ctr_auc``/``cvr_auc`` and the
    loss) and the mean-AUC selection."""
    name, loss = TRAIN_CASES[case]
    jinfo, info = _infos()
    data = _batch(b=32, seed=1)
    jcfg, cfg = _configs(name, loss)
    jt = JTrainer(jcfg, jinfo, mesh_ctx=make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    js = jt.init_state(data)
    pt = Trainer(cfg, info, device="cpu")
    ps = pt.init_state(data)
    params_from_jax(ps.model, jax.tree.map(np.asarray, {"params": js.params, **js.model_state}))
    js2, jms, jlogs = jt.train_step(js, jt.device_batch(data), jt.metrics.init())
    ps2, pms, plogs = pt.train_step(ps, pt.device_batch(data), pt.metrics.init())
    np.testing.assert_allclose(float(plogs["loss"]), float(jlogs["loss"]), atol=FP32["loss"], rtol=0)
    _assert_params(ps2.model, _by_torch_name(js2.params, ps2.model), FP32["param"])
    got_m, want_m = pt.metrics.result(pms), jt.metrics.result(jms)
    assert set(got_m) == set(want_m) == {"loss", "ctr_auc", "cvr_auc"}
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), atol=1e-6, err_msg=k)
    evals = [_batch(b=16, seed=10 + i) for i in range(2)]
    got, want = pt.evaluate(ps2, evals), jt.evaluate(js2, evals)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    assert pt._selection_metric(got) == pytest.approx(jt._selection_metric(want), abs=1e-6)


# --------------------------------------------------------------------------
# the fused and lazy-sparse engines against tpurec's
ENGINES = {
    # case: (embedding_optimizer, used_id_l2, optimizer options)
    "fused_permute": ("fused_adam", 0.01, {}),
    "fused_sort_payload": ("fused_adam", 0.01, {"fused_backward": "sort_payload"}),
    "lazy_adam": ("adam", 0.01, {}),
    "lazy_rowwise_adagrad": ("rowwise_adagrad", 0.01, {}),
}


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("name", ["mmoe", "poso_mmoe"])
def test_sparse_engines_match_jax(name, engine):
    """Three fp32 ``multi_task`` steps with the used-id L2 term: the loss
    and the term each step, then the table, its optimizer state and every
    dense parameter. POSO looks the table up twice a forward (the gate
    field again): each lookup's row gradients add, and in the lazy engine
    each lookup's used-id L2 term counts, as in tpurec. The CPU takes #9's
    plain version (no launch counted)."""
    opt, l2, options = ENGINES[engine]
    jinfo, info = _infos()
    jcfg = JExperimentConfig(
        model=JModelConfig(name=name, embedding=JEmbeddingConfig(dim=8, used_id_l2=l2)),
        train=JTrainConfig(compute_dtype="float32", log_every_steps=0, loss="multi_task",
                           sparse_embedding=True,
                           optimizer=JOptimizerConfig(embedding_optimizer=opt, **options)),
    )
    cfg = ExperimentConfig.from_json(jcfg.to_json())
    jt, js, pt, ps = pair(jcfg, cfg, jinfo, info, _batch(b=64, seed=20))
    before = eu.fused_scatter_add.launches
    for i in range(3):
        js, ps, _ = step_both(jt, js, pt, ps, _batch(b=64, seed=21 + i))
    assert_state_matches(jt, js, ps)
    assert eu.fused_scatter_add.launches == before
    assert set(ps.table_opt) == {"emb.embedding"}


def test_poso_lazy_used_id_l2_counts_both_lookups():
    """The lazy engine's used-id L2 term for poso_mmoe is the all-fields
    lookup's plus the gate-field lookup's (the gate field's rows twice),
    not the term over the unique ids of the step."""
    jinfo, info = _infos()
    _, cfg = _configs("poso_mmoe", "multi_task", sparse_embedding=True, emb=dict(used_id_l2=0.01))
    trainer = Trainer(cfg, info, device="cpu")
    data = _batch(b=64, seed=30)
    state = trainer.init_state(data)
    table = state.model.emb.embedding.detach().clone()
    _, _, logs = trainer.train_step(state, trainer.device_batch(data), trainer.metrics.init())

    def term(cols):
        ids = np.unique(np.concatenate([data[c] for c in cols]))
        return 0.5 * float((table[ids] ** 2).sum())

    np.testing.assert_allclose(float(logs["used_id_l2"]), term(NAMES) + term(["uid"]), rtol=1e-5)
    assert term(["uid"]) > 1e-3


# --------------------------------------------------------------------------
# the CLI journey on the impression family
def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _cli_config(path, name, loss):
    # lr 1e-2 at B=64: 25 steps take both AUCs to ~0.85 (at lr 1e-3 they
    # stay near 0.5 after one epoch)
    train = {"batch_size": 64, "epochs": 1, "log_every_steps": 0, "compute_dtype": "float32",
             "loss": loss, "optimizer": {"learning_rate": 1e-2}}
    if loss == "model_loss":
        train["metrics"] = ["ctr_auc", "cvr_auc"]
    with open(path, "w") as f:
        json.dump({"model": {"name": name, "embedding": {"dim": 8}}, "train": train}, f)
    return path


CLI_RUNS = {"mmoe": "multi_task", "escm2": "model_loss"}


def _jax_train(config_path, data_dir):
    """tpurec's ``cli train`` (``tpurec/cli.py:cmd_train``) on one device of
    the CPU mesh: (its report, its initial params)."""
    with open(config_path) as f:
        cfg = JExperimentConfig.from_json(f.read())
    info = JDataInfo.load(data_dir)
    train = jload_columnar(shard_paths(data_dir, "train"))
    test = jload_columnar(shard_paths(data_dir, "test"))
    trainer = JTrainer(cfg, info, mesh_ctx=make_mesh(cfg.mesh, devices=jax.devices()[:1]))
    bs = cfg.train.batch_size
    train_data = lambda: iter(JArrayLoader(train, bs, seed=cfg.train.seed))  # noqa: E731
    state = trainer.init_state(next(train_data()))
    params = jax.tree.map(np.asarray, state.params)
    with contextlib.redirect_stdout(io.StringIO()):
        _, report = trainer.run(
            train_data, lambda: iter(JArrayLoader(test, bs, shuffle=False, pad_final=True)), state=state)
    return json.loads(json.dumps(report, default=float)), params


@pytest.fixture(scope="module")
def impression_runs(tmp_path_factory):
    """``synth``/``datagen --family impression`` at 2,000 events through both
    packages' command lines, then one epoch of mmoe and escm2: the port's
    ``cli train`` against tpurec's training of its own shards, from the
    same initial weights (tpurec's init, bridged into the port's
    ``init_state``)."""
    root = tmp_path_factory.mktemp("impression")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUREC_PLATFORM", "cpu")
        for pkg, main in (("jax", jcli.main), ("port", cli.main)):
            raw, data = str(root / pkg / "raw"), str(root / pkg / "data")
            _run(main, ["synth", "--family", "impression", "--out", raw, "--n-events", "2000"])
            out[f"{pkg}_datagen"] = _run(main, ["datagen", "--family", "impression", "--raw", raw,
                                                "--out", data])
            out[f"{pkg}_data"] = data
        for name, loss in CLI_RUNS.items():
            config = _cli_config(str(root / f"{name}.json"), name, loss)
            out[f"jax_{name}"], params = _jax_train(config, out["jax_data"])
            init = Trainer.init_state

            def bridged(self, *a, **kw):
                state = init(self, *a, **kw)
                params_from_jax(state.model, {"params": params})
                return state

            workdir = str(root / "port" / name)
            with mock.patch.object(Trainer, "init_state", bridged):
                out[f"port_{name}_printed"] = _run(cli.main, [
                    "train", "--config", config, "--data", out["port_data"], "--workdir", workdir])
            with open(os.path.join(workdir, "report.json")) as f:
                out[f"port_{name}"] = json.load(f)
            out[f"port_{name}_workdir"] = workdir
    return out


def test_impression_shards_match_jax(impression_runs):
    r = impression_runs
    assert r["port_datagen"] == r["jax_datagen"].replace(r["jax_data"], r["port_data"])
    for split in ("train", "test"):
        got = load_columnar(shard_paths(r["port_data"], split), cache=False)
        want = jload_columnar(shard_paths(r["jax_data"], split), cache=False)
        assert set(got) == set(want) and {"ctr", "cvr"} <= set(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{split}/{k}")


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_impression_cli_train_matches_jax(impression_runs, name):
    """One fp32 epoch from the same weights: the eval loss and
    ``ctr_auc``/``cvr_auc`` of the port's ``cli train`` against tpurec's,
    both above 0.5, and the export written."""
    r = impression_runs
    got, want = r[f"port_{name}"]["best_eval"], r[f"jax_{name}"]["best_eval"]
    assert set(got) == set(want) == {"loss", "ctr_auc", "cvr_auc"}
    np.testing.assert_allclose(got["loss"], want["loss"], atol=0, rtol=1e-3)
    for k in ("ctr_auc", "cvr_auc"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-3, rtol=0, err_msg=k)
        assert got[k] > 0.5, k
    assert r[f"port_{name}_printed"].splitlines()[-1].startswith("best eval: {")
    export = os.path.join(r[f"port_{name}_workdir"], "export")
    assert sorted(os.listdir(export)) == ["export_meta.json", "params.pt"]
