"""The port's hashing ops (``ops/hashing.py``), its sketch store and the
long-sequence models SIM, CAN and ETA (``models/sim.py``) against the JAX
package on the CPU.

Inputs are made with numpy from a seed (``__graft_entry__._tiny_dataset``'s
schema: two aligned series of L=16, D=8, B ≤ 32), with holes in the
histories, a row with no live step and rows of repeated ids (equal GSU
scores); weights go from the JAX modules through ``tpurec_torch.bridge``,
the ``constants`` collection (ETA's projections) included. Tolerances:

- the hashing ops: bits, bucket ids, Hamming similarities and top-k
  indices exactly; float outputs atol/rtol 1e-5 (``TOL``);
- fp32 models: atol/rtol 1e-5; ``topk_indices`` exactly;
- bf16 compute: each output to 2^-5 of its largest |value|
  (``BF16_SCALED_RTOL``), ``topk_indices`` exactly;
- gradients, one fp32 ``Trainer`` step and ``evaluate``:
  ``tests/test_torch_train.py``'s limits (loss 1e-5, gradients 1e-4 of
  their largest value, parameters after Adam 2e-6, metrics 1e-6);
- the fused and lazy-sparse engines over three steps:
  ``tests/test_torch_engines_fused.py``'s limits.

A SimHash bit is the sign of an fp32 product, and the two packages may sum
that product in different orders: every model test that hashes asserts
that the smallest |x·p| on its own inputs exceeds ``SIGN_MARGIN``, so a
change of data that brings a product within rounding of 0 fails loudly.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from __graft_entry__ import _tiny_dataset
from test_torch_dcn import BF16_SCALED_RTOL, TOL, _redraw
from test_torch_engines_fused import LOSS_TOL, PARAM_TOL, pair, step_both
from test_torch_train import FP32, _assert_grads, _assert_params, _by_torch_name
from tpurec.config import EmbeddingConfig as JEmbeddingConfig
from tpurec.config import ExperimentConfig as JExperimentConfig
from tpurec.config import ModelConfig as JModelConfig
from tpurec.config import OptimizerConfig as JOptimizerConfig
from tpurec.config import TrainConfig as JTrainConfig
from tpurec.core.mesh import make_mesh
from tpurec.models import build_model as jax_build_model
from tpurec.models import registry as jregistry
from tpurec.ops import attention as jattention
from tpurec.ops import hashing as jhashing
from tpurec.serving.sketch_store import SketchStore as JSketchStore
from tpurec.train import Trainer as JTrainer
from tpurec_torch import bridge
from tpurec_torch.bridge import _flatten, params_from_jax
from tpurec_torch.config import EmbeddingConfig, ExperimentConfig, ModelConfig
from tpurec_torch.data.schema import DataInfo
from tpurec_torch.models import build_model
from tpurec_torch.models import registry as tregistry
from tpurec_torch.ops import attention as tattention
from tpurec_torch.ops import embedding_update as eu
from tpurec_torch.ops import hashing as thashing
from tpurec_torch.ops import kernels as tk
from tpurec_torch.serving.export import load_servable
from tpurec_torch.serving.sketch_store import SketchStore
from tpurec_torch.train.trainer import Trainer

torch.set_num_threads(1)

DTYPES = ["float32", "bfloat16"]
SIGN_MARGIN = 1e-5  # |x·p| above fp32 rounding of a D ≤ 16 product of O(1) values (~1e-6)


def _close(got, want, dtype, key=""):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=key, **TOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_SCALED_RTOL * np.abs(want).max(), rtol=0,
                                   err_msg=key)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# --------------------------------------------------------------------------
# the hashing ops
def _codes_inputs(seed=0, b=6, l=9, d=8, n=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, d)).astype(np.float32)
    proj = rng.normal(size=(d, n)).astype(np.float32)
    # an exact-zero product: a step orthogonal to projection column 0 in
    # small integers (exact in fp32 in any order), and a zero step
    proj[:, 0] = 0.0
    proj[:2, 0] = (1.0, 2.0)
    x[0, 0] = 0.0
    x[0, 0, :2] = (2.0, -1.0)
    x[1, 1] = 0.0
    return x, proj


def test_simhash_bits_match_jax_with_an_exact_zero_product():
    x, proj = _codes_inputs()
    want = np.asarray(jhashing.simhash_bits(jnp.asarray(x), jnp.asarray(proj)))
    got = thashing.simhash_bits(torch.tensor(x), torch.tensor(proj))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0, 0] == 0 and not got[1, 1].any()  # 0 is not > 0
    assert float(np.einsum("d,d->", x[0, 0], proj[:, 0])) == 0.0
    products = np.abs(np.einsum("bld,dn->bln", x, proj))
    assert (products[products > 0] > SIGN_MARGIN).all()


@pytest.mark.parametrize("n", [4, 12])
def test_lsh_bucket_ids_and_hamming_match_jax(n):
    x, proj = _codes_inputs(seed=1, n=n)
    want = np.asarray(jhashing.lsh_bucket_ids(jnp.asarray(x), jnp.asarray(proj)))
    got = thashing.lsh_bucket_ids(torch.tensor(x), torch.tensor(proj))
    assert got.dtype == torch.int32 and int(got.max()) < 2**n
    np.testing.assert_array_equal(got.numpy(), want)
    q_bits = jhashing.simhash_bits(jnp.asarray(x[:, 0]), jnp.asarray(proj))
    k_bits = jhashing.simhash_bits(jnp.asarray(x), jnp.asarray(proj))
    want = np.asarray(jhashing.hamming_similarity(q_bits, k_bits))
    got = thashing.hamming_similarity(torch.tensor(np.asarray(q_bits)), torch.tensor(np.asarray(k_bits)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 0] == n).all()  # a code matches itself everywhere


def _tied_scores(seed, b=7, l=12):
    """Integer scores in [0, 4] (ties everywhere), a mask with holes, row 0
    with no valid step and row 1 with fewer valid steps than k."""
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, 5, size=(b, l)).astype(np.float32)
    mask = (rng.random((b, l)) < 0.7).astype(np.float32)
    mask[0] = 0.0
    mask[1] = 0.0
    mask[1, [2, 7]] = 1.0
    return scores, mask


@pytest.mark.parametrize("k", [1, 3, 5, 12])
def test_topk_select_matches_lax_top_k_with_ties_and_empty_rows(k):
    scores, mask = _tied_scores(2)
    want_idx, want_mask = jhashing.topk_select(jnp.asarray(scores), jnp.asarray(mask), k)
    got_idx, got_mask = thashing.topk_select(torch.tensor(scores), torch.tensor(mask), k)
    assert got_idx.dtype == torch.int32 and got_mask.dtype == torch.float32
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    # the empty row: the first k steps, none valid
    np.testing.assert_array_equal(got_idx[0].numpy(), np.arange(k))
    assert not got_mask[0].any()
    assert got_mask[1].sum() == min(k, 2)


def test_torch_topk_order_would_fail_topk_select():
    """The check can tell the tie order: ``torch.topk``'s picks differ from
    ``lax.top_k``'s on these ties (so ``topk_select`` must not use it)."""
    scores, mask = _tied_scores(2)
    neg = torch.where(torch.tensor(mask).bool(), torch.tensor(scores), -torch.inf)
    want, _ = jhashing.topk_select(jnp.asarray(scores), jnp.asarray(mask), 5)
    assert not np.array_equal(torch.topk(neg, 5).indices.numpy(), np.asarray(want))


def test_gather_steps_of_topk_select_match_jax():
    scores, mask = _tied_scores(3)
    seq = np.random.default_rng(4).normal(size=scores.shape + (3,)).astype(np.float32)
    idx, _ = jhashing.topk_select(jnp.asarray(scores), jnp.asarray(mask), 4)
    want = jhashing.gather_steps(jnp.asarray(seq), idx)
    got_idx, _ = thashing.topk_select(torch.tensor(scores), torch.tensor(mask), 4)
    np.testing.assert_array_equal(thashing.gather_steps(torch.tensor(seq), got_idx).numpy(), np.asarray(want))


@pytest.mark.parametrize("masked", [False, True])
def test_lsh_attention_matches_jax(masked):
    rng = np.random.default_rng(5)
    q = rng.normal(size=(4, 10, 8)).astype(np.float32)
    v = rng.normal(size=(4, 10, 6)).astype(np.float32)
    proj = rng.normal(size=(8, 3)).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.random((4, 10)) < 0.6).astype(np.float32)
        mask[0] = 0.0
    want = jhashing.lsh_attention(jnp.asarray(q), jnp.asarray(v), jnp.asarray(proj),
                                  None if mask is None else jnp.asarray(mask))
    got = thashing.lsh_attention(torch.tensor(q), torch.tensor(v), torch.tensor(proj),
                                 None if mask is None else torch.tensor(mask))
    assert np.abs(np.einsum("bld,dn->bln", q, proj)).min() > SIGN_MARGIN
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if masked:  # a row with no valid step: every step attends uniformly
        np.testing.assert_allclose(got[0].numpy(), np.broadcast_to(v[0].mean(0), (10, 6)), **TOL)


def _sketch_inputs(seed=6, b=5, l=12, d=8, g=3, n=2):
    """Few bits, so that buckets collide; row 0 with no valid step."""
    rng = np.random.default_rng(seed)
    seq = rng.normal(size=(b, l, d)).astype(np.float32)
    mask = (rng.random((b, l)) < 0.7).astype(np.float32)
    mask[0] = 0.0
    proj = rng.normal(size=(g, d, n)).astype(np.float32)
    query = rng.normal(size=(b, d)).astype(np.float32)
    for x in (seq, query):
        assert np.abs(np.einsum("...d,gdn->...gn", x, proj)).min() > SIGN_MARGIN
    return seq, mask, proj, query


def test_sketch_pool_matches_jax():
    seq, mask, proj, query = _sketch_inputs()
    want = jhashing.sketch_pool(*map(jnp.asarray, (seq, mask, proj, query)))
    got = thashing.sketch_pool(*map(torch.tensor, (seq, mask, proj, query)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[0].any() and got[1:].abs().sum() > 0


def test_sketch_store_matches_jax_and_sketch_pool():
    """The port's copy of the store against tpurec's, and its query against
    ``sketch_pool`` over each user's valid steps; an unknown user is None."""
    seq, mask, proj, query = _sketch_inputs(seed=7)
    store, jstore = SketchStore(proj), JSketchStore(proj)
    for u in range(seq.shape[0]):
        live = seq[u][mask[u] > 0]
        store.update(f"u{u}", live)
        jstore.update(f"u{u}", live)
    pooled = thashing.sketch_pool(*map(torch.tensor, (seq, mask, proj, query))).numpy()
    for u in range(seq.shape[0]):
        got = store.query(f"u{u}", query[u])
        np.testing.assert_array_equal(got, jstore.query(f"u{u}", query[u]))
        np.testing.assert_allclose(got, pooled[u], **TOL)
        assert f"u{u}" in store
    assert store.query("nobody", query[0]) is None and "nobody" not in store


@pytest.mark.parametrize("seed,shape", [(11, (16, 16)), (3, (8, 16)), (11, (4, 8, 6))])
def test_port_projections_within_4_ulp_of_jax(seed, shape):
    """ETA's ``hash_proj`` (key 3, a single group) and ``lsh_self_proj``
    (key 11) and SDIM's projections (key 11) as ``make_projections`` draws
    them: within 4 ulp of ``jax.random.normal``'s."""
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape, jnp.float32))
    got = thashing.make_projections(seed, *((1,) + shape)[-3:]).numpy().reshape(shape)
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=4)


# --------------------------------------------------------------------------
# MultiHeadAttention's options
MHA_OPTIONS = {
    "default": {},
    "no_residual": dict(use_residual=False),
    "out_dim": dict(out_dim=8),  # not D: the JAX module drops the residual
    "out_dim_d": dict(out_dim=12),  # D: the residual stays
    "no_layer_norm": dict(use_layer_norm=False),
    "dropout_eval": dict(dropout_rate=0.3),  # the identity outside training
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("option", list(MHA_OPTIONS))
def test_multi_head_attention_options_match_jax(option, dtype):
    """A (B, 1, 12) query over (B, 7, 6) keys with a mask (one row empty),
    in eval mode: the output, its shape (B, 1, ``out_dim`` or 12) and
    dtype."""
    kw = MHA_OPTIONS[option]
    jd = None if dtype == "float32" else jnp.bfloat16
    td = None if dtype == "float32" else torch.bfloat16
    rng = np.random.default_rng(8)
    q = _f32(jnp.asarray(rng.normal(size=(5, 1, 12))).astype(dtype))
    kv = rng.normal(size=(5, 7, 6)).astype(np.float32)
    mask = (rng.random((5, 7)) < 0.7).astype(np.float32)
    mask[0] = 0.0
    jm = jattention.MultiHeadAttention(2, 3, dtype=jd, **kw)
    jargs = (jnp.asarray(q).astype(dtype), jnp.asarray(kv), jnp.asarray(mask))
    variables = _redraw(fnn.unbox(jm.init(jax.random.key(0), jargs[0], kv=jargs[1], mask=jargs[2])), seed=9)
    want = jm.apply(variables, jargs[0], kv=jargs[1], mask=jargs[2])
    tm = params_from_jax(tattention.MultiHeadAttention(12, 2, 3, kv_dim=6, dtype=td, **kw), variables)
    with torch.no_grad():
        got = tm.eval()(torch.tensor(q).to(td or torch.float32), kv=torch.tensor(kv),
                        mask=torch.tensor(mask))
    assert tuple(got.shape) == want.shape == (5, 1, kw.get("out_dim") or 12)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _close(got.float().numpy(), _f32(want), dtype)


# --------------------------------------------------------------------------
# the models
MODELS = {
    # case: (registry name, params)
    "sim": ("sim", dict(topk=5)),
    "sim_trunk": ("sim", dict(topk=5, use_dien_trunk=True)),
    "can": ("can", {}),
    "can_trunk": ("can", dict(use_dien_trunk=True)),
    "eta": ("eta", dict(topk=5, short_len=4, n_hash_bits=8)),
    "eta_lsh": ("eta", dict(topk=5, short_len=4, n_hash_bits=8, lsh_self_attention=True, lsh_self_bits=3)),
}
HASHING = ("eta", "eta_lsh")  # the cases whose outputs go through SimHash bits
TOPK = ("sim", "sim_trunk", "eta", "eta_lsh")


def _data(b=24, seed=0):
    """``_tiny_dataset``'s batch with holes in the histories, row 0 with no
    live step, row 1 one repeated item (equal GSU scores at every step) and
    row 2 two items alternating."""
    jinfo, data = _tiny_dataset(batch=b, seq_len=16, seed=seed)
    rng = np.random.default_rng(seed + 100)
    hole = (rng.random((b, 16)) < 0.2) | (np.arange(b) == 0)[:, None]
    for n in ("history", "history_tags"):
        data[n] = np.where(hole, 0, data[n])
    data["history"][1, 1:] = 5
    data["history_tags"][1, 1:] = 75
    data["history"][2] = np.where(np.arange(16) % 2 == 0, 7, 9)
    data["history_tags"][2] = np.where(np.arange(16) % 2 == 0, 74, 80)
    info = DataInfo(**{k: getattr(jinfo, k) for k in DataInfo.__dataclass_fields__})
    return jinfo, info, data


def _jparams(params, dtype):
    return dict(params, **({} if dtype == "float32" else {"dtype": jnp.bfloat16}))


def _variable_shapes(jm, data):
    shapes = fnn.unbox(jax.eval_shape(jm.init, jax.random.key(0), {k: jnp.asarray(v) for k, v in data.items()}))
    return {k: v for k, v in shapes.items() if k != "regularization"}


@functools.lru_cache(maxsize=None)
def _variables(case, seed=3):
    """Every variable redrawn, the ``constants`` too (so only the bridge can
    give the port ETA's projections)."""
    name, params = MODELS[case]
    jinfo, _, data = _data()
    jm = jax_build_model(JModelConfig(name=name, params=params, embedding=JEmbeddingConfig(dim=8)), jinfo)
    return _redraw(_variable_shapes(jm, data), seed=seed)


def _models(case, dtype="float32"):
    """(JAX model, its variables, the port model with the same weights)."""
    name, params = MODELS[case]
    jinfo, info, _ = _data()
    jm = jax_build_model(JModelConfig(name=name, params=_jparams(params, dtype),
                                      embedding=JEmbeddingConfig(dim=8)), jinfo)
    tparams = dict(params, **({} if dtype == "float32" else {"dtype": "bfloat16"}))
    model = build_model(ModelConfig(name=name, params=tparams, embedding=EmbeddingConfig(dim=8)), info, "cpu")
    variables = _variables(case)
    return jm, variables, params_from_jax(model, variables)


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


_SIMHASH = thashing.simhash_bits


def smallest_products(fn):
    """Run ``fn()`` with ``simhash_bits`` recorded where the port calls it
    (the models and ``lsh_bucket_ids``): (its result, the smallest |x·p| of
    each call, fp32 products as the op takes them)."""
    smallest = []

    def recorded(x, projection):
        smallest.append(float(torch.einsum("...d,db->...b", x, projection).abs().min()))
        return _SIMHASH(x, projection)

    with mock.patch.object(thashing, "simhash_bits", recorded), \
            mock.patch("tpurec_torch.models.sim.simhash_bits", recorded):
        out = fn()
    return out, smallest


def _forward(model, batch, hashing):
    """The port model's outputs without grad; with ``hashing``, every SimHash
    product on these inputs is asserted farther than ``SIGN_MARGIN`` from 0."""
    with torch.no_grad():
        out, smallest = smallest_products(lambda: model(_torch_batch(batch)))
    if hashing:
        assert smallest and min(smallest) > SIGN_MARGIN, smallest
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("case", list(MODELS))
def test_model_matches_jax(case, mode, dtype):
    """Every output in eval and train mode, its shape and dtype;
    ``topk_indices`` exactly (the empty row's too, and the tied rows')."""
    jm, variables, model = _models(case, dtype)
    _, _, batch = _data()
    want = jm.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()}, train=mode == "train")
    getattr(model, mode)()
    got = _forward(model, batch, case in HASHING)
    assert set(got) == set(want) == {"gsu_logits", "esu_logits", "output"} | (
        {"topk_indices"} if case in TOPK else set())
    for key in want:
        w = np.asarray(want[key])
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype), key
        if key == "topk_indices":
            np.testing.assert_array_equal(got[key].numpy(), w)
        else:
            _close(got[key].float().numpy(), _f32(w), dtype, key)
    assert np.std(np.asarray(want["esu_logits"])) > 0.05
    if case in TOPK:
        np.testing.assert_array_equal(got["topk_indices"][0].numpy(), np.arange(5))  # no valid step


@pytest.mark.parametrize("case", list(MODELS))
def test_gradients_match_jax(case):
    """fp32: the gradient of every parameter (the tables included) of a
    weighted sum of both heads' logits, in training mode."""
    jm, variables, model = _models(case)
    _, _, batch = _data(seed=6)
    weights = np.random.default_rng(7).normal(size=(2, 24, 2)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    consts = {k: v for k, v in variables.items() if k != "params"}

    def scalar(out, w):
        return (out["gsu_logits"] * w[0]).sum() + (out["esu_logits"] * w[1]).sum()

    want = _by_torch_name(jax.jit(jax.grad(
        lambda p: scalar(jm.apply({"params": p, **consts}, jb, train=True), jnp.asarray(weights))))(
        variables["params"]), model)
    model.train().zero_grad()
    scalar(model(_torch_batch(batch)), torch.from_numpy(weights)).backward()
    _assert_grads(model, want, FP32["grad"])
    assert model.emb.embedding.grad.abs().sum() > 0
    if case.startswith("can"):
        assert model.induction_emb_item_id.embedding.grad.abs().sum() > 0
    if case.endswith("trunk"):
        assert model.trunk.emb.embedding.grad.abs().sum() > 0


@pytest.mark.parametrize("case", list(MODELS))
def test_param_shapes_match_jax(case):
    """Every flax leaf, the ``constants`` included, has a port tensor of the
    shape the bridge gives it, and nothing is left over; the constants are
    buffers, not parameters."""
    _, variables, model = _models(case)
    want = {}
    for path, value in bridge._flatten(variables["params"]):
        name, arr = bridge._torch_leaf("params", path, value, model)
        want[".".join(path[:-1] + (name,))] = arr.shape
    consts = {".".join(p): v.shape for p, v in bridge._flatten(variables.get("constants", {}))}
    assert set(consts) == {"eta": {"hash_proj"}, "eta_lsh": {"hash_proj", "lsh_self_proj"}}.get(case, set())
    assert {**want, **consts} == {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert not set(consts) & {n for n, _ in model.named_parameters()}
    if case.startswith("can"):
        assert want["induction_emb_item_id.embedding"] == (128, 56)
    if case == "eta_lsh":
        assert consts == {"hash_proj": (16, 8), "lsh_self_proj": (16, 3)}


@pytest.mark.parametrize("case", ["eta", "eta_lsh"])
def test_eta_own_projections_give_jax_bits(case):
    """The port's own ``hash_proj``/``lsh_self_proj`` (``jax_normal``) and
    JAX's init (``jax.random.normal``), the same params: the same top-k
    picks and outputs on the tests' inputs."""
    name, params = MODELS[case]
    jinfo, info, batch = _data(seed=4)
    jm = jax_build_model(JModelConfig(name=name, params=params, embedding=JEmbeddingConfig(dim=8)), jinfo)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    real = fnn.unbox(jm.init(jax.random.key(0), jb))
    variables = {"params": _variables(case)["params"], "constants": real["constants"]}
    want = jm.apply(variables, jb)
    model = build_model(ModelConfig(name=name, params=params, embedding=EmbeddingConfig(dim=8)), info, "cpu")
    own = {k: v.numpy() for k, v in model.named_buffers()}  # the port's own draws, kept
    params_from_jax(model, {"params": variables["params"], "constants": own})
    got = _forward(model.eval(), batch, True)
    np.testing.assert_array_equal(got["topk_indices"].numpy(), np.asarray(want["topk_indices"]))
    for key in ("gsu_logits", "esu_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL)


# --------------------------------------------------------------------------
# the Trainer
def _configs(case, loss="gsu_esu", engine=None, used_id_l2=0.0, **train):
    name, params = MODELS[case]
    opt = {} if engine is None else dict(sparse_embedding=True,
                                         optimizer=JOptimizerConfig(embedding_optimizer=engine))
    jcfg = JExperimentConfig(
        model=JModelConfig(name=name, params=params, embedding=JEmbeddingConfig(dim=8, used_id_l2=used_id_l2)),
        train=JTrainConfig(compute_dtype="float32", log_every_steps=0, loss=loss, **opt, **train),
    )
    return jcfg, ExperimentConfig.from_json(jcfg.to_json())


def test_eta_train_step_and_evaluate_match_jax():
    """One fp32 dense ``gsu_esu`` step of ETA with the LSH self-attention
    (its constants from tpurec's init through the bridge): the loss and its
    two terms, every parameter after Adam, the constants untouched; then
    ``evaluate`` over two batches."""
    jcfg, cfg = _configs("eta_lsh")
    jinfo, info, data = _data(b=32, seed=1)
    jt = JTrainer(jcfg, jinfo, mesh_ctx=make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    js = jt.init_state(data)
    pt = Trainer(cfg, info, device="cpu")
    ps = pt.init_state(data)
    params_from_jax(ps.model, jax.tree.map(np.asarray, {"params": js.params, **js.model_state}))
    consts = {k: v.clone() for k, v in ps.model.named_buffers()}
    np.testing.assert_array_equal(consts["hash_proj"].numpy(), np.asarray(js.model_state["constants"]["hash_proj"]))
    js2, _, jlogs = jt.train_step(js, jt.device_batch(data), jt.metrics.init())
    ps2, _, plogs = pt.train_step(ps, pt.device_batch(data), pt.metrics.init())
    for key in ("loss", "gsu_ce", "esu_ce"):
        np.testing.assert_allclose(float(plogs[key]), float(jlogs[key]), atol=FP32["loss"], rtol=0, err_msg=key)
    _assert_params(ps2.model, _by_torch_name(js2.params, ps2.model), FP32["param"])
    for name, value in ps2.model.named_buffers():
        assert torch.equal(value, consts[name]), name
    evals = [_data(b=16, seed=10 + i)[2] for i in range(2)]
    got, want = pt.evaluate(ps2, evals), jt.evaluate(js2, evals)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=1e-6, err_msg=k)


def assert_state_matches(js, ps):
    """``tests/test_torch_engines_fused.py``'s comparison (tables without the
    sacrificial last row, their Adam moments, every dense parameter), with
    each moment's atol at 1e-9 or 2^-21 (4 ulp) of its table's largest
    |moment|, whichever is larger: a row whose gradient is a sum of
    cancelling terms of the table's scale carries their rounding (ETA's
    attention over its picks: 2.7e-9 on an m of 4e-8, its table's m up to
    0.047)."""
    tables = _by_torch_name(js.tables, ps.model)
    dense = _by_torch_name(js.params, ps.model)
    got = {n: p.detach().numpy() for n, p in ps.model.named_parameters()}
    assert set(got) == set(tables) | set(dense)
    for name, want in tables.items():
        np.testing.assert_allclose(got[name][:-1], want[:-1], atol=PARAM_TOL, rtol=0, err_msg=name)
    for name, want in dense.items():
        np.testing.assert_allclose(got[name], want, atol=PARAM_TOL, rtol=0, err_msg=name)
    jopt = {".".join(p): st for p, st in _flatten(js.table_opt)}
    for name, st in ps.table_opt.items():
        for field in st._fields:
            want = np.asarray(getattr(jopt[name], field), np.float32)[:-1]
            atol = max(1e-9, 2.0**-21 * float(np.abs(want).max()))
            np.testing.assert_allclose(getattr(st, field).numpy()[:-1], want, rtol=1e-4, atol=atol,
                                       err_msg=f"{name}.{field}")


@pytest.mark.parametrize("engine", ["fused_adam", "adam"])
@pytest.mark.parametrize("case", ["can", "sim_trunk", "eta"])
def test_sparse_engines_match_jax(case, engine):
    """Three fp32 ``gsu_esu`` steps with the used-id L2 on (1e-3): the loss
    and its L2 term each step, then every table (CAN's induction tables,
    looked up by the query ids only; SIM's nested ``trunk/emb``), its
    optimizer state and every dense parameter. The CPU takes #9's plain
    version (no launch counted); ETA's constants stay as loaded."""
    jcfg, cfg = _configs(case, engine=engine, used_id_l2=1e-3)
    jinfo, info, first = _data(b=16, seed=20)
    jt, js, pt, ps = pair(jcfg, cfg, jinfo, info, first)
    buffers = {k: v.clone() for k, v in ps.model.named_buffers()}
    before = eu.fused_scatter_add.launches
    for i in range(3):
        js, ps, _ = step_both(jt, js, pt, ps, _data(b=16, seed=21 + i)[2])
    assert_state_matches(js, ps)
    assert eu.fused_scatter_add.launches == before
    tables = {"can": {"emb.embedding", "induction_emb_item_id.embedding", "induction_emb_item_tag.embedding"},
              "sim_trunk": {"emb.embedding", "trunk.emb.embedding"}, "eta": {"emb.embedding"}}[case]
    assert set(ps.table_opt) == tables
    for name, value in ps.model.named_buffers():
        assert torch.equal(value, buffers[name]), name


def test_can_induction_rows_move_only_for_query_ids():
    """In the lazy-sparse engine Adam touches each table's rows of the step's
    unique ids: an induction row of an id that is never a query moves only
    through its moments (0 gradient, so it stays put after one step), while
    the query ids' rows move."""
    _, cfg = _configs("can", engine="adam")
    _, info, data = _data(b=16, seed=30)
    pt = Trainer(cfg, info, device="cpu")
    ps = pt.init_state(data)
    table = ps.model.induction_emb_item_id.embedding
    before = table.detach().clone()
    ps, _, _ = pt.train_step(ps, pt.device_batch(data), pt.metrics.init())
    moved = (table.detach() != before).any(dim=-1)
    queried = torch.as_tensor(np.unique(data["item_id"]))
    assert moved[queried].all()
    assert int(moved.sum()) == len(queried)


def _freeze_configs(name, params, loss, freeze=()):
    jcfg = JExperimentConfig(
        model=JModelConfig(name=name, params=params, embedding=JEmbeddingConfig(dim=8)),
        train=JTrainConfig(compute_dtype="float32", log_every_steps=0, loss=loss,
                           freeze_prefixes=freeze),
    )
    return jcfg, ExperimentConfig.from_json(jcfg.to_json())


def _trainers(jcfg, cfg, jinfo, info, data):
    jt = JTrainer(jcfg, jinfo, mesh_ctx=make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    js = jt.init_state(data)
    pt = Trainer(cfg, info, device="cpu")
    ps = pt.init_state(data)
    params_from_jax(ps.model, jax.tree.map(np.asarray, {"params": js.params, **js.model_state}))
    return jt, js, pt, ps


@pytest.mark.parametrize("name", ["sim", "can"])
def test_graft_and_freeze_dien_trunk_matches_jax(name, tmp_path):
    """``tests/test_freeze_compose.py``'s recipe in both packages: DIEN takes
    a step and is exported; SIM (CAN) with ``use_dien_trunk`` grafts the
    export under ``trunk`` (``init_subtree_from_export``) and trains two
    steps with ``freeze_prefixes=('trunk',)``: the port's trunk stays the
    export's bytes and takes no gradient (no backward through it, #5's
    included), the rest moves, and every parameter matches tpurec's."""
    jinfo, info, data = _data(b=16, seed=40)
    jt, js, pt, ps = _trainers(*_freeze_configs("dien", {}, "bce"), jinfo, info, data)
    js, _, _ = jt.train_step(js, jt.device_batch(data), jt.metrics.init())
    ps, _, _ = pt.train_step(ps, pt.device_batch(data), pt.metrics.init())
    jt.export(js, str(tmp_path / "jax_dien"))
    pt.export(ps, str(tmp_path / "port_dien"))
    exported = {k: v.detach().clone() for k, v in ps.model.named_parameters()}

    jt, js, pt, ps = _trainers(*_freeze_configs(name, dict(use_dien_trunk=True), "gsu_esu", ("trunk",)),
                               jinfo, info, data)
    js = jt.init_subtree_from_export(js, str(tmp_path / "jax_dien"), "trunk")
    ps = pt.init_subtree_from_export(ps, str(tmp_path / "port_dien"), "trunk")
    for k, v in ps.model.trunk.named_parameters():
        assert torch.equal(v.detach(), exported[k]), k
    others = {k: v.detach().clone() for k, v in ps.model.named_parameters() if not k.startswith("trunk.")}
    tk.reset_launch_counts()
    for i in range(2):
        batch = _data(b=16, seed=41 + i)[2]
        js, _, jlogs = jt.train_step(js, jt.device_batch(batch), jt.metrics.init())
        ps, _, plogs = pt.train_step(ps, pt.device_batch(batch), pt.metrics.init())
        np.testing.assert_allclose(float(plogs["loss"]), float(jlogs["loss"]), atol=LOSS_TOL, rtol=0)
    for k, v in ps.model.trunk.named_parameters():
        assert torch.equal(v.detach(), exported[k]), f"frozen {k} moved"
        assert v.grad is None, f"frozen {k} took a gradient"
    assert tk.din_attention_fused.launches == tk.din_attention_bwd_fused.launches == 0  # the CPU's plain versions
    assert all(not torch.equal(v.detach(), others[k]) for k, v in ps.model.named_parameters()
               if k in others and k.endswith("head.weight"))
    _assert_params(ps.model, _by_torch_name(js.params, ps.model), FP32["param"])


def test_eta_constants_survive_checkpoint_export_and_servable(tmp_path):
    """ETA's projections (distinct values, loaded through the bridge) ride
    through ``save``/``restore``, ``export`` → ``load_servable`` →
    ``predict``; none of them is a parameter of the optimizer."""
    jcfg, cfg = _configs("eta_lsh", checkpoint_dir=str(tmp_path / "ckpt"))
    _, info, data = _data(b=16, seed=50)
    pt = Trainer(cfg, info, device="cpu")
    ps = pt.init_state(data)
    params_from_jax(ps.model, jax.tree.map(np.asarray, _variables("eta_lsh")))
    consts = {k: v.clone() for k, v in ps.model.named_buffers()}
    assert set(consts) == {"hash_proj", "lsh_self_proj"}
    held = {id(p) for g in ps.optimizer.param_groups for p in g["params"]}
    assert not {id(v) for v in ps.model.buffers()} & held
    ps, _, _ = pt.train_step(ps, pt.device_batch(data), pt.metrics.init())
    pt.save(ps)
    fresh = pt.init_state(data)
    assert not torch.equal(fresh.model.hash_proj, consts["hash_proj"])  # the port's own draw
    restored = pt.restore(fresh)
    for k, v in restored.model.named_buffers():
        assert torch.equal(v, consts[k]), k
    pt.export(ps, str(tmp_path / "export"))
    servable = load_servable(str(tmp_path / "export"), info, device="cpu")
    for k, v in servable.model.named_buffers():
        assert torch.equal(v, consts[k]), k
    want = pt.infer(ps, data)
    got = servable.predict(data)
    np.testing.assert_array_equal(got["topk_indices"].numpy(), want["topk_indices"])
    np.testing.assert_allclose(got["output"].numpy(), want["output"], atol=1e-6, rtol=0)


def test_models_on_cuda_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, info, _ = _data()
    for name in ("sim", "can", "eta"):
        with pytest.raises((RuntimeError, AssertionError)):
            build_model(ModelConfig(name=name, embedding=EmbeddingConfig(dim=8)), info, "cuda")


def test_registry_names_equal_jax():
    from tpurec.models import builders  # noqa: F401  (registers tpurec's builders)
    from tpurec_torch.models import builders as tbuilders  # noqa: F401

    assert set(tregistry.MODEL_REGISTRY) == set(jregistry.MODEL_REGISTRY)
    assert len(tregistry.MODEL_REGISTRY) == 48
