"""The port's FM family (DSSM single tower, Wide&Deep, FFM, FwFM, PNN inner
and outer, ONN), MatrixCF and NCF, and the field-aware table in every
engine, against the JAX package on the CPU.

Inputs are made with numpy from a seed; weights go from the JAX modules and
models through ``tpurec_torch.bridge``. Tolerances:

- ops, towers, lookups and fp32 models: atol/rtol 1e-5 (the two frameworks
  sum in different orders; values are O(1)-O(10));
- bf16 ops and towers: the JAX result in bf16 to 2^-5 of its largest
  |value| (bf16 roundings, 2^-9 relative each, taken at other places);
- bf16 models: probabilities to 2e-2, as ``tests/test_torch_models.py``;
- one fp32 train step: ``tests/test_torch_train.py``'s limits (loss 1e-5,
  gradients 1e-4 of their largest value, parameters after Adam 2e-6), and
  ``evaluate``'s metrics to 1e-6;
- the sparse and fused engines over three steps:
  ``tests/test_torch_engines_fused.py``'s limits (loss and used-id L2 1e-5,
  tables and parameters 2e-6, moments rtol 1e-4, a bf16 first moment to
  one bf16 step). ``rowwise_adam`` keeps its first moment in bf16, so where
  the two frameworks' fp32 moments fall on either side of a bf16 rounding
  boundary, steps 2 and 3 move a weight by lr·|m̂|/√v̂ computed from moments
  one bf16 step (2^-8 relative) apart: its tables are held to 2e-6 +
  2·lr·2^-8 (measured 2.09e-6 on the order-1 table, D=1, where m̂/√v̂ is
  ±1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from test_torch_engines_fused import (
    LOSS_TOL,
    PARAM_TOL,
    run_both,
    sparse_configs,
    tabular_data,
)
from test_torch_train import FP32, _assert_grads, _assert_params, _by_torch_name
from tpurec.config import EmbeddingConfig as JEmbeddingConfig
from tpurec.config import ExperimentConfig as JExperimentConfig
from tpurec.config import ModelConfig as JModelConfig
from tpurec.config import OptimizerConfig as JOptimizerConfig
from tpurec.config import TrainConfig as JTrainConfig
from tpurec.core.mesh import make_mesh
from tpurec.data.schema import DataInfo as JDataInfo
from tpurec.embedding import modules as jmodules
from tpurec.embedding.ops import contiguous_take as jcontiguous_take
from tpurec.models import build_model as jax_build_model
from tpurec.ops import interactions as ji
from tpurec.ops.pallas.kernels import set_training_phase
from tpurec.train import Trainer as JTrainer
from tpurec.train.losses import add_auxiliary as jadd_auxiliary
from tpurec_torch.bridge import params_from_jax
from tpurec_torch.config import EmbeddingConfig, ExperimentConfig, ModelConfig
from tpurec_torch.data.schema import DataInfo
from tpurec_torch.embedding.modules import (
    FieldAwareEmbedding,
    embedding_tables,
    record_used_id_l2,
    sparse_rows,
)
from tpurec_torch.models import build_model
from tpurec_torch.ops import interactions as ti
from tpurec_torch.train.trainer import Trainer

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_SCALED_RTOL = 2.0**-5
BF16_PROB_ATOL = 2e-2
LR = 1e-3  # the engines' learning rate (OptimizerConfig's default)
ROWWISE_PARAM_TOL = PARAM_TOL + 2 * LR * 2.0**-8

# 5 fields (so P = 10, and D = 10 gives P == D), 2 continuous features
NAMES, DIMS, CONT = ["user_id", "item_id", "f2", "f3", "f4"], [30, 40, 10, 12, 9], ["c1", "c2"]


def _numpy_tree(variables):
    variables = {k: v for k, v in fnn.unbox(variables).items() if k != "regularization"}
    return jax.tree.map(np.asarray, variables)


def _redraw(variables, seed, scale=0.3):
    """Every leaf redrawn from N(0, scale²), so biases and every term do work."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (scale * rng.normal(size=a.shape)).astype(np.float32), variables)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _bf16_close(got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = float(np.abs(want).max())
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= BF16_SCALED_RTOL * scale, f"bf16 err {err} at scale {scale}"


# --------------------------------------------------------------------------
# the pair-product ops and the towers
OPS = ["pairwise_products", "inner_products", "outer_products", "field_aware_products"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", OPS)
def test_product_ops_match_jax(op, dtype):
    rng = np.random.default_rng(0)
    shape = (13, 6, 6, 5) if op == "field_aware_products" else (13, 6, 5)
    x = _normal(rng, *shape)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want, got = getattr(ji, op)(jx), getattr(ti, op)(tx)
    assert tuple(got.shape) == want.shape and got.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    else:
        _bf16_close(got, want)


TOWERS = {
    "fwfm": (lambda f, d: ji.FwFMInteraction(), lambda f, d: ti.FwFMInteraction(f)),
    "inner": (lambda f, d: ji.InnerProductTower(), lambda f, d: ti.InnerProductTower()),
    **{
        f"outer_{k}": (
            lambda f, d, k=k: ji.OuterProductTower(kernel_type=k),
            lambda f, d, k=k: ti.OuterProductTower(f, d, k),
        )
        for k in ("mat", "vec", "num")
    },
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tower", list(TOWERS))
def test_towers_match_jax(tower, dtype):
    """Each tower with its parameter redrawn (so a kernel or pair weight does
    work), the kernel cast to the embedding's dtype."""
    make_jax, make_port = TOWERS[tower]
    rng = np.random.default_rng(1)
    f, d = 6, 5
    x = _normal(rng, 17, f, d)
    jm = make_jax(f, d)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    variables = _numpy_tree(jm.init(jax.random.key(0), jx))
    if variables:
        variables = _redraw(variables, seed=2, scale=0.5)
    module = make_port(f, d)
    if variables:
        params_from_jax(module, variables)
    want = jm.apply(variables, jx)
    with torch.inference_mode():
        got = module(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert tuple(got.shape) == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    else:
        _bf16_close(got, want)


def test_outer_tower_refuses_unknown_kernel_type():
    with pytest.raises(ValueError, match="kernel_type"):
        ti.OuterProductTower(4, 3, "cube")


def test_pair_indices_first_made_in_inference_mode_still_train():
    """The pair indices are made once a field count and device and reused:
    made first under ``inference_mode`` (serving), they must still serve a
    step that autograd records."""
    emb = torch.from_numpy(_normal(np.random.default_rng(5), 2, 11, 3))
    with torch.inference_mode():
        want = ti.inner_products(emb)
    emb.requires_grad_(True)
    got = ti.inner_products(emb)
    got.sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want.numpy())
    assert emb.grad is not None and emb.grad.shape == emb.shape


# --------------------------------------------------------------------------
# the field-aware table's three lookups
def _fa_case(seed=3, b=9, f=4, d=3, vocab=50):
    rng = np.random.default_rng(seed)
    jm = jmodules.FieldAwareEmbedding(vocab, f, d)
    ids = rng.integers(0, vocab, size=(b, f))
    table = _numpy_tree(jm.init(jax.random.key(0), jnp.asarray(ids)))["params"]["embedding"]
    module = FieldAwareEmbedding(vocab, f, d)
    params_from_jax(module, {"params": {"embedding": table}})
    return rng, jm, module, ids, table, _normal(rng, b, f, f, d)


def test_field_aware_dense_lookup_matches_jax():
    """The lookup and the table's gradient; neither side records a used-id
    L2 term for this table."""
    _, jm, module, ids, table, cot = _fa_case()

    def jloss(t):
        out, mut = jm.apply({"params": {"embedding": t}}, jnp.asarray(ids), mutable=["regularization"])
        return jnp.sum(out * cot), (out, mut)

    (_, (want, mut)), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(table))
    assert not jax.tree.leaves(mut)
    with record_used_id_l2(module) as terms:
        out = module(torch.from_numpy(ids))
        (out * torch.from_numpy(cot)).sum().backward()
    assert terms == []
    assert tuple(out.shape) == (9, 4, 4, 3)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(module.embedding.grad.numpy(), np.asarray(jgrad), **TOL)


@pytest.mark.parametrize("layout", ["unique", "direct"])
def test_field_aware_sparse_lookups_match_jax(layout):
    """The lazy engine's ``'unique'`` layout (ids are slots of the unique
    rows) and the fused engine's ``'direct'`` layout (``contiguous_take``:
    column j of the ids is a contiguous run) on (N, F, D) rows: the lookup
    and the rows' gradient."""
    rng, jm, module, ids, table, cot = _fa_case()
    b, f = ids.shape
    if layout == "unique":
        n_rows = 7
        ids = rng.integers(0, n_rows, size=(b, f))
    else:
        n_rows = b * f
        ids = np.arange(n_rows).reshape(f, b).T  # column j = j·B + arange(B)
    rows = _normal(rng, n_rows, f, 3)
    jmodules.set_sparse_mode(True)
    jmodules.set_sparse_layout(layout)
    try:
        def jloss(r):
            out = jm.apply({"tables": {"embedding": jnp.asarray(table)},
                            "sparse_rows": {"embedding": r}}, jnp.asarray(ids))
            return jnp.sum(out * cot), out

        (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(rows))
    finally:
        jmodules.set_sparse_mode(False)
        jmodules.set_sparse_layout("unique")
    r = torch.from_numpy(rows).requires_grad_()
    with sparse_rows(module, [r], layout):
        out = module(torch.from_numpy(ids))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(jgrad), **TOL)
    if layout == "direct":
        np.testing.assert_array_equal(
            np.asarray(jcontiguous_take(jnp.asarray(rows), jnp.asarray(ids))), out.detach().numpy()
        )


# --------------------------------------------------------------------------
# the eight models against apply(train=False)
MODELS = {
    "dssm_single": ("dssm_single", {}),
    "wide_and_deep": ("wide_and_deep", {}),
    "wide_and_deep_no_continuous": ("wide_and_deep", {"continuous_names": []}),
    "ffm": ("ffm", {}),
    "fwfm": ("fwfm", {}),
    "pnn_inner": ("pnn", {}),
    "pnn_outer_mat": ("pnn", {"product_type": "outer"}),
    "pnn_outer_vec": ("pnn", {"product_type": "outer", "kernel_type": "vec"}),
    "pnn_outer_num": ("pnn", {"product_type": "outer", "kernel_type": "num"}),
    "onn": ("onn", {}),
    "matrixcf": ("matrixcf", {}),
    "ncf": ("ncf", {}),
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


def _pair(case, dtype="float32", redraw=True, dim=8, apply=True):
    name, params = MODELS[case]
    jinfo, info = _infos()
    batch = _batch()
    jparams, tparams = dict(params), dict(params)
    if dtype == "bfloat16":
        jparams["dtype"], tparams["dtype"] = jnp.bfloat16, "bfloat16"
    jmodel = jax_build_model(JModelConfig(name=name, params=jparams, embedding=JEmbeddingConfig(dim=dim)), jinfo)
    variables = _numpy_tree(jmodel.init(jax.random.key(0), {k: jnp.asarray(v) for k, v in batch.items()}))
    if redraw:
        variables = _redraw(variables, seed=8)
    model = build_model(ModelConfig(name=name, params=tparams, embedding=EmbeddingConfig(dim=dim)), info, "cpu")
    params_from_jax(model, variables)
    if not apply:
        return variables, model, None, None
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
    assert np.std(np.asarray(want.get("logit", want["output"]))) > 0.05


@pytest.mark.parametrize("case", list(MODELS))
def test_model_matches_jax_bf16_compute(case):
    _, _, got, want = _pair(case, "bfloat16")
    out = got["output"]
    assert out.dtype == torch.float32 and torch.all((out >= 0) & (out <= 1))
    np.testing.assert_allclose(out.numpy(), np.asarray(want["output"]), atol=BF16_PROB_ATOL, rtol=0)


@pytest.mark.parametrize("case", list(MODELS))
def test_param_shapes_match_jax(case):
    """Every flax leaf has a port param of the same shape: a Dense kernel
    transposed, the outer tower's raw kernel and the (V, F, D) tables as
    they are; nothing is left over on either side."""
    variables, model, _, _ = _pair(case, redraw=False, apply=False)
    port = model.state_dict()
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    assert len(flat) == len(port)
    for path, leaf in flat:
        keys = [p.key for p in path]
        dense = keys[-1] == "kernel" and keys[-2] != "product"
        name = "weight" if dense else keys[-1]
        assert tuple(port[".".join(keys[:-1] + [name])].shape) == (leaf.shape[::-1] if dense else leaf.shape)


def test_builders_mirror_jax_embed_dim_handling():
    """``matrixcf`` keeps ``config.embedding.dim``; ``ncf`` always drops
    ``embed_dim`` (its widths are ``mf_dim``/``mlp_dim``); ``wide_and_deep``
    takes the schema's continuous features."""
    _, info = _infos()
    mcf = build_model(ModelConfig(name="matrixcf", embedding=EmbeddingConfig(dim=12)), info, "cpu")
    assert mcf.emb.embedding.shape[1] == 12
    ncf = build_model(ModelConfig(name="ncf", params={"embed_dim": 12}), info, "cpu")
    assert ncf.mf_emb.embedding.shape[1] == ncf.mlp_emb.embedding.shape[1] == 16
    wd = build_model(ModelConfig(name="wide_and_deep"), info, "cpu")
    assert wd.continuous_names == CONT and wd.wide.weight.shape == (1, 2)


# --------------------------------------------------------------------------
# the bridge and the outer tower's raw kernel
def test_bridge_keeps_a_square_vec_kernel_untransposed():
    """PNN outer 'vec' with F=5 and D=10: the kernel is (P, D) = (10, 10),
    which a Dense rule would transpose without any shape error. Loaded
    through the bridge it matches JAX; the same kernel transposed does not."""
    variables, model, got, want = _pair("pnn_outer_vec", dim=10)
    kernel = variables["params"]["product"]["kernel"]
    assert kernel.shape == (10, 10)
    np.testing.assert_array_equal(model.product.kernel.detach().numpy(), kernel)
    np.testing.assert_allclose(got["logit"].numpy(), np.asarray(want["logit"]), **TOL)
    flipped = jax.tree.map(lambda a: a, variables)
    flipped["params"]["product"]["kernel"] = kernel.T
    params_from_jax(model, flipped)
    with torch.inference_mode():
        wrong = model({k: torch.as_tensor(v) for k, v in _batch().items()})["logit"].numpy()
    assert np.abs(wrong - np.asarray(want["logit"])).max() > 100 * TOL["atol"]


def test_bridge_loads_the_mat_kernel_and_refuses_a_wrong_one():
    variables, model, _, _ = _pair("pnn_outer_mat", redraw=False, apply=False)
    np.testing.assert_array_equal(model.product.kernel.detach().numpy(),
                                  variables["params"]["product"]["kernel"])
    wrong = jax.tree.map(lambda a: a, variables)
    wrong["params"]["product"]["kernel"] = np.zeros((10, 8), np.float32)
    with pytest.raises(RuntimeError, match="size mismatch"):
        params_from_jax(model, wrong)
    # a Dense kernel's rule: a 3-D kernel where a Dense is expected raises
    bad = jax.tree.map(lambda a: a, variables)
    bad["params"]["head"]["kernel"] = np.zeros((2, 32, 1), np.float32)
    with pytest.raises(ValueError, match="Dense kernel"):
        params_from_jax(model, bad)


# --------------------------------------------------------------------------
# one dense-engine train step against the JAX Trainer, then evaluate
def _jax_grads(jt, js, jbatch, model):
    l2 = jt.config.model.embedding.used_id_l2

    def loss_fn(params):
        out, mut = jt.model.apply(
            {"params": params, **js.model_state}, jbatch, train=True,
            mutable=["batch_stats", "regularization"], rngs={"dropout": jax.random.key(0)},
        )
        loss, _ = jt.loss_fn(out, jbatch)
        loss, _ = jadd_auxiliary(loss, out)
        if l2 > 0 and "regularization" in mut:
            loss = loss + l2 * sum(jnp.sum(x) for x in jax.tree.leaves(mut["regularization"]))
        return loss

    set_training_phase(True)
    try:
        return _by_torch_name(jax.jit(jax.grad(loss_fn))(js.params), model)
    finally:
        set_training_phase(False)


def _train_pair(name, params, used_id_l2=0.0, embedding_l2=0.0):
    jinfo, info = _infos()
    data = _batch(b=32, seed=1, label=True)
    jcfg = JExperimentConfig(
        model=JModelConfig(name=name, params=params,
                           embedding=JEmbeddingConfig(dim=8, used_id_l2=used_id_l2)),
        train=JTrainConfig(compute_dtype="float32", log_every_steps=0,
                           optimizer=JOptimizerConfig(embedding_l2=embedding_l2)),
    )
    cfg = ExperimentConfig.from_json(jcfg.to_json())
    jt = JTrainer(jcfg, jinfo, mesh_ctx=make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    js = jt.init_state(data)
    pt = Trainer(cfg, info, device="cpu")
    ps = pt.init_state(data)
    params_from_jax(ps.model, jax.tree.map(np.asarray, {"params": js.params, **js.model_state}))
    return jt, js, pt, ps, data


@pytest.mark.parametrize("case", list(MODELS))
def test_train_step_and_evaluate_match_jax(case):
    """One fp32 dense step: the loss, every gradient and every parameter
    after Adam; then ``evaluate`` over two batches."""
    name, params = MODELS[case]
    jt, js, pt, ps, data = _train_pair(name, params)
    jbatch = jt.device_batch(data)
    want_grads = _jax_grads(jt, js, jbatch, ps.model)
    js2, _, jlogs = jt.train_step(js, jbatch, jt.metrics.init())
    ps2, _, plogs = pt.train_step(ps, pt.device_batch(data), pt.metrics.init())
    np.testing.assert_allclose(float(plogs["loss"]), float(jlogs["loss"]), atol=FP32["loss"], rtol=0)
    _assert_grads(ps2.model, want_grads, FP32["grad"])
    _assert_params(ps2.model, _by_torch_name(js2.params, ps2.model), FP32["param"])
    evals = [_batch(b=16, seed=10 + i, label=True) for i in range(2)]
    got, want = pt.evaluate(ps2, evals), jt.evaluate(js2, evals)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


# --------------------------------------------------------------------------
# FFM and ONN's field-aware table in every engine
def test_dense_engine_field_aware_l2_matches_jax():
    """Three fp32 dense steps of FFM and ONN with ``used_id_l2`` and
    ``embedding_l2`` > 0: the used-id term covers only the shared tables
    (none for the field-aware one, as the JAX package sows none), while
    the coupled decay, chosen by parameter name, covers the (V, F, D)
    table too."""
    for name in ("ffm", "onn"):
        jt, js, pt, ps, _ = _train_pair(name, {}, used_id_l2=0.01, embedding_l2=1e-3)
        decayed = set(ps.optimizer.decay)
        fa = "v.embedding" if name == "ffm" else "fa.embedding"
        assert fa in decayed and ps.model.get_parameter(fa).dim() == 3
        for seed in (1, 2, 3):
            data = _batch(b=32, seed=seed, label=True)
            js, _, jlogs = jt.train_step(js, jt.device_batch(data), jt.metrics.init())
            ps, _, plogs = pt.train_step(ps, pt.device_batch(data), pt.metrics.init())
            np.testing.assert_allclose(float(plogs["loss"]), float(jlogs["loss"]), atol=LOSS_TOL, rtol=0)
            np.testing.assert_allclose(float(plogs["used_id_l2"]), float(jlogs["used_id_l2"]),
                                       atol=LOSS_TOL, rtol=1e-5)
        _assert_params(ps.model, _by_torch_name(js.params, ps.model), PARAM_TOL)


ENGINES = [("ffm", "adam"), ("ffm", "rowwise_adam"), ("ffm", "fused_adam"),
           ("onn", "adam"), ("onn", "rowwise_adam"), ("onn", "fused_adam"),
           ("ffm", "rowwise_adagrad"), ("ffm", "host_adam")]


@pytest.mark.parametrize("model,engine", ENGINES)
def test_sparse_engines_field_aware_match_jax(model, engine):
    """Three fp32 steps of the lazy-sparse engines on (U, F, D) rows and the
    fused engine on (N, F, D) rows flattened to F·D columns, with
    ``used_id_l2`` and ``embedding_l2`` > 0: the loss and its used-id term
    (the lazy engines count the shared tables' rows only; the fused
    engine's ``'permute'`` term every table's, the field-aware one
    included, as in the JAX package), then the tables, their optimizer
    state (moments of shape (V, F, D), or a row's scalar) and every dense
    parameter."""
    jcfg, cfg = sparse_configs(model, engine, 0.01, embedding_l2=1e-3)
    assert cfg.train.optimizer.learning_rate == LR
    tol = ROWWISE_PARAM_TOL if engine == "rowwise_adam" else PARAM_TOL
    _, _, _, ps = run_both(model, jcfg, cfg, param_tol=tol)
    fa = "v.embedding" if model == "ffm" else "fa.embedding"
    assert ps.model.get_parameter(fa).dim() == 3 and fa in ps.table_opt
    assert len(embedding_tables(ps.model)) == 2


def test_fused_step_counts_the_field_aware_rows_in_its_l2():
    """The engine difference the JAX package has: one FFM step's used-id L2
    term in the fused engine exceeds the lazy engine's by the field-aware
    rows' 0.5·Σ of squares over the step's unique ids."""
    _, info, data = tabular_data()
    terms = {}
    for engine in ("adam", "fused_adam"):
        _, cfg = sparse_configs("ffm", engine, 0.01)
        trainer = Trainer(cfg, info, device="cpu")
        state = trainer.init_state(data, seed=5)
        fa_table = state.model.v.embedding.detach().clone()
        _, _, logs = trainer.train_step(state, trainer.device_batch(data), trainer.metrics.init())
        terms[engine] = float(logs["used_id_l2"])
    ids = np.unique(np.concatenate([data[n] for n in info.feature_names]))
    extra = 0.5 * float(fa_table[torch.from_numpy(ids)].square().sum())
    np.testing.assert_allclose(terms["fused_adam"] - terms["adam"], extra, rtol=1e-5)
