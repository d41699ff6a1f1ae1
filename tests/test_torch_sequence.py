"""The port's recurrent sequence ops (``ops/sequence.py``), ``gather_steps``
and the sequence models DIEN, DSIN and SDM against the JAX package on the
CPU.

Inputs are made with numpy from a seed (``__graft_entry__._tiny_dataset``'s
schema: two aligned series of L=16, D=8, B ≤ 32), with holes in the
histories and a row with no live step; weights go from the JAX modules
through ``tpurec_torch.bridge``. Tolerances:

- fp32 ops and models: atol/rtol 1e-5 (``TOL``; sums in other orders);
- bf16 compute: each output to 2^-5 of its largest |value|
  (``BF16_SCALED_RTOL``), as ``tests/test_torch_dcn_rest.py``'s modules;
- gradients and one fp32 ``Trainer`` step: ``tests/test_torch_train.py``'s
  limits (loss 1e-5, gradients 1e-4 of their largest value, parameters
  after Adam 2e-6), ``evaluate``'s metrics to 1e-6;
- DIEN in the fused and lazy-sparse engines over three steps:
  ``tests/test_torch_engines_fused.py``'s limits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from __graft_entry__ import _tiny_dataset
from test_torch_dcn import BF16_SCALED_RTOL, TOL, _redraw
from test_torch_engines_fused import assert_state_matches, pair, sparse_configs, step_both
from test_torch_train import FP32, _assert_grads, _assert_params, _by_torch_name
from tpurec.config import EmbeddingConfig as JEmbeddingConfig
from tpurec.config import ExperimentConfig as JExperimentConfig
from tpurec.config import ModelConfig as JModelConfig
from tpurec.config import TrainConfig as JTrainConfig
from tpurec.core.mesh import make_mesh
from tpurec.models import build_model as jax_build_model
from tpurec.ops import hashing as jhashing
from tpurec.ops import sequence as jseq
from tpurec.train import Trainer as JTrainer
from tpurec_torch import bridge
from tpurec_torch.bridge import params_from_jax
from tpurec_torch.config import EmbeddingConfig, ExperimentConfig, ModelConfig
from tpurec_torch.data.schema import DataInfo
from tpurec_torch.initializers import init_parameters
from tpurec_torch.models import build_model
from tpurec_torch.ops import embedding_update as eu
from tpurec_torch.ops import hashing as thashing
from tpurec_torch.ops import kernels as tk
from tpurec_torch.ops import sequence as tseq
from tpurec_torch.train.trainer import Trainer

torch.set_num_threads(1)

DTYPES = ["float32", "bfloat16"]
B, L, D, H = 6, 9, 6, 5  # the ops' shapes


def _close(got, want, dtype, key=""):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=key, **TOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_SCALED_RTOL * np.abs(want).max(), rtol=0,
                                   err_msg=key)


def _shapes(module, *args):
    """The variables' tree of ``module`` as shapes only (the embedding's
    ``regularization`` sow left out), for ``_redraw``."""
    shapes = fnn.unbox(jax.eval_shape(module.init, jax.random.key(0), *args))
    return {k: v for k, v in shapes.items() if k != "regularization"}


def _holey_mask(rng, b, l):
    """Random live steps, row 0 with none, row 1 live at its last step only."""
    m = (rng.random((b, l)) < 0.6).astype(np.float32)
    m[0] = 0.0
    m[1] = 0.0
    m[1, -1] = 1.0
    return m


# --------------------------------------------------------------------------
# the recurrent ops
def _op(name, dtype):
    """(JAX module, port module) of the op ``name``."""
    jd = None if dtype == "float32" else jnp.bfloat16
    td = None if dtype == "float32" else torch.bfloat16
    if name == "gru":
        return jseq.MaskedGRU(H, dtype=jd), tseq.MaskedGRU(D, H, td)
    if name == "lstm":
        return jseq.MaskedLSTM(H, num_layers=2, dtype=jd), tseq.MaskedLSTM(D, H, 2, td)
    if name == "bilstm":
        return jseq.MaskedBiLSTM(H, dtype=jd), tseq.MaskedBiLSTM(D, H, td)
    return jseq.AttentionGRU(H, mode=name, dtype=jd), tseq.AttentionGRU(D, H, name, td)


OPS = ["gru", "lstm", "bilstm", "augru", "agru", "aigru"]


def _op_inputs(name, dtype, seed=0, masked=True):
    """(JAX args, port args): x (B, L, D) in ``dtype`` for the masked
    recurrences, in fp32 for the attention GRUs (DIEN feeds them the
    extractor's fp32 states); the attention GRUs also take scores."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(dtype).astype(jnp.float32))  # representable in dtype
    m = _holey_mask(rng, B, L) if masked else None
    attention = name in ("augru", "agru", "aigru")
    xd = "float32" if attention else dtype
    jargs = [jnp.asarray(x).astype(xd)]
    targs = [torch.tensor(x).to(getattr(torch, xd))]
    if attention:
        scores = rng.random((B, L)).astype(np.float32)
        jargs.append(jnp.asarray(scores))
        targs.append(torch.tensor(scores))
    jargs.append(None if m is None else jnp.asarray(m))
    targs.append(None if m is None else torch.tensor(m))
    return jargs, targs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", OPS)
def test_recurrent_op_matches_jax(name, dtype):
    """Each op on a mask with holes, an all-zero row and a row live at its
    last step only: the values and the output dtype (fp32 from a bf16 GRU
    or LSTM: flax's carry is in the parameter dtype)."""
    jm, tm = _op(name, dtype)
    jargs, targs = _op_inputs(name, dtype)
    variables = _redraw(_shapes(jm, *jargs), seed=1)
    want = jm.apply(variables, *jargs)
    params_from_jax(tm, variables)
    with torch.no_grad():
        got = tm(*targs)
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == "float32"
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)
    if name in ("lstm", "bilstm"):  # a padded step outputs 0
        assert not got[0].any()
    if name == "gru":  # a padded step outputs the kept carry: row 0 stays at 0, row 1 until its last step
        assert not got[0].any() and not got[1, :-1].any() and got[1, -1].abs().sum() > 0


@pytest.mark.parametrize("name", ["gru", "lstm", "augru"])
def test_recurrent_op_without_a_mask_matches_jax(name):
    jm, tm = _op(name, "float32")
    jargs, targs = _op_inputs(name, "float32", seed=2, masked=False)
    variables = _redraw(_shapes(jm, *jargs), seed=3)
    want = jm.apply(variables, *jargs)
    with torch.no_grad():
        got = params_from_jax(tm, variables)(*targs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", OPS)
def test_recurrent_op_gradients_match_jax(name):
    """fp32: the gradient of a weighted sum of the outputs with respect to
    every parameter and to x (and the attention GRUs' scores)."""
    jm, tm = _op(name, "float32")
    jargs, targs = _op_inputs(name, "float32", seed=4)
    variables = _redraw(_shapes(jm, *jargs), seed=5)
    weights = np.random.default_rng(6).normal(size=jm.apply(variables, *jargs).shape).astype(np.float32)
    n_diff = 2 if name in ("augru", "agru", "aigru") else 1

    def loss(params, *diff):
        return jnp.sum(jm.apply({"params": params}, *diff, *jargs[n_diff:]) * weights)

    grads = jax.grad(loss, argnums=tuple(range(n_diff + 1)))(variables["params"], *jargs[:n_diff])
    params_from_jax(tm, variables)
    diff = [t.clone().requires_grad_(True) for t in targs[:n_diff]]
    (tm(*diff, *targs[n_diff:]) * torch.from_numpy(weights)).sum().backward()
    _assert_grads(tm, _by_torch_name(grads[0], tm), FP32["grad"])
    for got, want in zip(diff, grads[1:]):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


def _distinct_gate_weights(module, seed):
    """Per-gate weights drawn apart (a different scale a gate), so that a
    swapped pair of gates changes the output."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, module)
    out = {}
    for k, (gate, leaves) in enumerate(sorted(params.items())):
        out[gate] = {n: ((0.2 + 0.15 * k) * rng.normal(size=a.shape)).astype(np.float32)
                     for n, a in leaves.items()}
    return out


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_cell_gate_order_matches_flax_cells(cell):
    """Two steps of flax's own ``GRUCell``/``OptimizedLSTMCell`` from its
    zero carry against the port's recurrence over the same two inputs (the
    second step runs every gate from a nonzero state). Every gate has its
    own weight scale; swapping the weights of two gates of the same kind
    moves the result far beyond the tolerance."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, 2, D)).astype(np.float32)
    flax_cell = fnn.GRUCell(H) if cell == "gru" else fnn.OptimizedLSTMCell(H)
    carry = flax_cell.initialize_carry(jax.random.key(0), (B, D))
    params = _distinct_gate_weights(
        fnn.unbox(flax_cell.init(jax.random.key(1), carry, jnp.asarray(x[:, 0])))["params"], seed=8)
    ys = []
    for t in range(2):
        carry, y = flax_cell.apply({"params": params}, carry, jnp.asarray(x[:, t]))
        ys.append(np.asarray(y))
    want = np.stack(ys, axis=1)
    tcell = tseq.GRUCell(D, H) if cell == "gru" else tseq.LSTMCell(D, H)
    root = {"cell": params} if cell == "gru" else params
    module = tseq.MaskedGRU(D, H) if cell == "gru" else tcell
    params_from_jax(module, {"params": root})
    scan = module.cell.scan if cell == "gru" else module.scan
    with torch.no_grad():
        got = scan(torch.tensor(x), None).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    gates = ("r", "z", "n") if cell == "gru" else ("i", "f", "g", "o")
    for side in ("i", "h"):
        for a, b in ((0, 1), (1, 2)) + (((2, 3),) if cell == "lstm" else ()):
            swapped = jax.tree.map(np.copy, params)
            ga, gb = side + gates[a], side + gates[b]
            if set(params[ga]) != set(params[gb]):
                continue  # gates with and without a bias: no swap to make
            swapped[ga], swapped[gb] = params[gb], params[ga]
            params_from_jax(module, {"params": {"cell": swapped} if cell == "gru" else swapped})
            with torch.no_grad():
                moved = scan(torch.tensor(x), None).numpy()
            assert np.abs(moved - want).max() > 100 * (1e-5 + 1e-5 * np.abs(want).max()), (ga, gb)


def test_cells_init_as_flax():
    """Input kernels lecun normal, hidden-state kernels orthogonal, biases
    zero (flax's ``kernel_init``, ``recurrent_kernel_init``, ``bias_init``)."""
    gru = init_parameters(tseq.MaskedGRU(D, 32), seed=0)
    lstm = init_parameters(tseq.MaskedBiLSTM(D, 32), seed=0)
    for module, hidden, inputs in ((gru.cell, ("hr", "hz", "hn"), ("ir", "iz", "in")),
                                   (lstm.fwd, ("hi", "hf", "hg", "ho"), ("ii", "if", "ig", "io"))):
        for name in hidden:
            w = getattr(module, name).weight.detach()
            np.testing.assert_allclose((w @ w.T).numpy(), np.eye(32), atol=1e-5)
        for name in inputs:
            w = getattr(module, name).weight.detach()
            assert w.abs().max() <= 2 / np.sqrt(D) / 0.8796 + 1e-6
        for name in hidden + inputs:
            bias = getattr(module, name).bias
            assert bias is None or not bias.detach().any()
    assert gru.cell.hr.bias is None and gru.cell.hn.bias is not None
    assert lstm.fwd.ii.bias is None and lstm.fwd.hi.bias is not None


@pytest.mark.parametrize("dtype", DTYPES)
def test_learned_position_embedding_matches_jax(dtype):
    jm = jseq.LearnedPositionEmbedding(12, 4, dtype=None if dtype == "float32" else jnp.bfloat16)
    variables = _redraw(fnn.unbox(jm.init(jax.random.key(0), 7)), seed=9)  # a static length
    want = jm.apply(variables, 7)
    module = params_from_jax(tseq.LearnedPositionEmbedding(12, 4, getattr(torch, dtype)
                                                           if dtype != "float32" else None), variables)
    got = module(7)
    assert tuple(got.shape) == (7, 4) and str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(want.astype(jnp.float32)))
    init_parameters(module, seed=1)
    assert 0.01 < float(module.pos.std()) < 0.03


@pytest.mark.parametrize("trailing", [(), (3,)])
def test_gather_steps_matches_jax(trailing):
    rng = np.random.default_rng(10)
    seq = rng.normal(size=(5, 8) + trailing).astype(np.float32)
    idx = rng.integers(0, 8, size=(5, 4)).astype(np.int32)
    want = jhashing.gather_steps(jnp.asarray(seq), jnp.asarray(idx))
    got = thashing.gather_steps(torch.tensor(seq), torch.tensor(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# the models
MODELS = {
    # case: (registry name, params)
    "dien": ("dien", {}),
    "dien_agru": ("dien", {"gru_mode": "agru"}),
    "dien_aigru": ("dien", {"gru_mode": "aigru"}),
    "dsin": ("dsin", {"num_sessions": 4}),
    "sdm": ("sdm", {"short_len": 5}),
}
NEG = ("dien",)  # the case that also runs with the sampled negative series


def _data(b=24, seed=0, neg=False):
    """``_tiny_dataset``'s batch with holes in the histories (both series),
    row 0 with no live step, and with ``neg`` the sampled negative series
    (``neg_<series>``, 0 where the history is)."""
    jinfo, data = _tiny_dataset(batch=b, seq_len=16, seed=seed)
    rng = np.random.default_rng(seed + 100)
    hole = (rng.random((b, 16)) < 0.2) | (np.arange(b) == 0)[:, None]
    for n in ("history", "history_tags"):
        data[n] = np.where(hole, 0, data[n])
    if neg:
        live = data["history"] != 0
        data["neg_history"] = np.where(live, rng.integers(1, 65, size=(b, 16)), 0)
        data["neg_history_tags"] = np.where(live, rng.integers(73, 85, size=(b, 16)), 0)
    info = DataInfo(**{k: getattr(jinfo, k) for k in DataInfo.__dataclass_fields__})
    return jinfo, info, data


def _jparams(params, dtype):
    return dict(params, **({} if dtype == "float32" else {"dtype": jnp.bfloat16}))


@functools.lru_cache(maxsize=None)
def _variables(case, seed=3):
    name, params = MODELS[case]
    jinfo, _, data = _data()
    jm = jax_build_model(JModelConfig(name=name, params=params, embedding=JEmbeddingConfig(dim=8)), jinfo)
    return _redraw(_shapes(jm, {k: jnp.asarray(v) for k, v in data.items()}), seed=seed)


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


def _cases():
    return [(c, False) for c in MODELS] + [(c, True) for c in NEG]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("case,neg", _cases())
def test_model_matches_jax(case, neg, mode, dtype):
    """Every output in eval and train mode (DIEN's ``trunk_features`` and,
    in training, its ``auxiliary_loss`` with the sampled negatives and with
    the batch-rolled ones), its shape and dtype."""
    jm, variables, model = _models(case, dtype)
    _, _, batch = _data(neg=neg)
    want = jm.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()}, train=mode == "train")
    getattr(model, mode)()
    with torch.no_grad():
        got = model({k: torch.as_tensor(v) for k, v in batch.items()})
    assert set(got) == set(want)
    assert ("auxiliary_loss" in got) == (case.startswith("dien") and mode == "train")
    for key in want:
        w = np.asarray(jnp.asarray(want[key]).astype(jnp.float32))
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype), key
        _close(got[key].float().numpy(), w, dtype, key)
    key = "logit" if "logit" in want else "output"
    assert np.std(np.asarray(want[key])) > 0.05


def test_dien_auxiliary_loss_reads_the_negative_series():
    """The sampled negatives change the auxiliary loss (so the port reads
    them), and with them absent it falls back to the rolled positives."""
    model = _models("dien")[2].train()
    with torch.no_grad():
        with_neg = model({k: torch.as_tensor(v) for k, v in _data(neg=True)[2].items()})
        rolled = model({k: torch.as_tensor(v) for k, v in _data(neg=False)[2].items()})
    assert abs(float(with_neg["auxiliary_loss"]) - float(rolled["auxiliary_loss"])) > 1e-3
    torch.testing.assert_close(with_neg["logit"], rolled["logit"], rtol=0, atol=0)


@pytest.mark.parametrize("case,neg", _cases())
def test_gradients_match_jax(case, neg):
    """fp32: the gradient of every parameter (the shared table's included)
    of a weighted sum of the logits (SDM's scores) plus DIEN's auxiliary
    loss."""
    jm, variables, model = _models(case)
    _, _, batch = _data(seed=6, neg=neg)
    weights = np.random.default_rng(7).normal(size=24).astype(np.float32)
    key = "output" if case == "sdm" else "logit"
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def scalar(out, w):
        total = (out[key] * w).sum()
        return total + out["auxiliary_loss"] if "auxiliary_loss" in out else total

    want = _by_torch_name(jax.jit(jax.grad(
        lambda p: scalar(jm.apply({"params": p}, jb, train=True), jnp.asarray(weights))))(variables["params"]),
        model)
    model.train().zero_grad()
    scalar(model({k: torch.as_tensor(v) for k, v in batch.items()}), torch.from_numpy(weights)).backward()
    _assert_grads(model, want, FP32["grad"])
    assert model.emb.embedding.grad.abs().sum() > 0


@pytest.mark.parametrize("case", list(MODELS))
def test_param_shapes_match_jax(case):
    """Every flax leaf has a port parameter of the shape the bridge gives it,
    and nothing is left over: the cells' per-gate layers (``hr``, ``hz`` and
    ``ii``…``io`` without a bias) and DSIN's raw biases included."""
    _, variables, model = _models(case)
    want = {}
    for path, value in bridge._flatten(variables["params"]):
        name, arr = bridge._torch_leaf("params", path, value, model)
        want[".".join(path[:-1] + (name,))] = arr.shape
    assert want == {k: tuple(v.shape) for k, v in model.state_dict().items()}
    if case == "dsin":
        assert want["bias_pos"] == (1, 4, 1) and want["bias_dim"] == (1, 1, 16)
        assert "bilstm.fwd.hi.bias" in want and "bilstm.fwd.ii.bias" not in want
    if case == "dien":
        assert "extractor.cell.hn.bias" in want and "extractor.cell.hr.bias" not in want


def test_dsin_refuses_a_length_its_sessions_do_not_divide():
    _, info, _ = _data()
    with pytest.raises(ValueError, match="not divisible"):
        build_model(ModelConfig(name="dsin", embedding=EmbeddingConfig(dim=8)), info, "cpu")  # 16 % 5


# --------------------------------------------------------------------------
# one dense Trainer step against tpurec's, then evaluate
TRAIN_CASES = {"dien": "bce", "dsin": "bce", "sdm": "in_batch_softmax"}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_step_and_evaluate_match_jax(case):
    """One fp32 dense step (DIEN with its sampled negatives): the loss, its
    auxiliary term and every parameter after Adam (the gradients are
    ``test_gradients_match_jax``'s); the DIN attention's forward and
    backward run their plain versions on the CPU (no launch counted); then
    ``evaluate`` over two batches."""
    name, params = MODELS[case]
    neg = case == "dien"
    jinfo, info, data = _data(b=32, seed=1, neg=neg)
    jcfg = JExperimentConfig(
        model=JModelConfig(name=name, params=params, embedding=JEmbeddingConfig(dim=8)),
        train=JTrainConfig(compute_dtype="float32", log_every_steps=0, loss=TRAIN_CASES[case]),
    )
    cfg = ExperimentConfig.from_json(jcfg.to_json())
    jt = JTrainer(jcfg, jinfo, mesh_ctx=make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    js = jt.init_state(data)
    pt = Trainer(cfg, info, device="cpu")
    ps = pt.init_state(data)
    params_from_jax(ps.model, jax.tree.map(np.asarray, {"params": js.params, **js.model_state}))
    js2, _, jlogs = jt.train_step(js, jt.device_batch(data), jt.metrics.init())
    tk.reset_launch_counts()
    ps2, _, plogs = pt.train_step(ps, pt.device_batch(data), pt.metrics.init())
    assert tk.din_attention_fused.launches == tk.din_attention_bwd_fused.launches == 0
    np.testing.assert_allclose(float(plogs["loss"]), float(jlogs["loss"]), atol=FP32["loss"], rtol=0)
    if neg:
        np.testing.assert_allclose(float(plogs["auxiliary_loss"]), float(jlogs["auxiliary_loss"]),
                                   atol=FP32["loss"], rtol=0)
    _assert_params(ps2.model, _by_torch_name(js2.params, ps2.model), FP32["param"])
    evals = [_data(b=16, seed=10 + i, neg=neg)[2] for i in range(2)]
    got, want = pt.evaluate(ps2, evals), jt.evaluate(js2, evals)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=1e-6, err_msg=k)


# --------------------------------------------------------------------------
# DIEN in the fused and lazy-sparse engines against tpurec's
@pytest.mark.parametrize("engine,backward", [("fused_adam", "permute"), ("adam", None)])
def test_dien_sparse_engines_match_jax(engine, backward):
    """Three fp32 DIEN steps with the sampled negative series: the step's
    ids are the profile, query, history and ``neg_history`` columns. The
    loss each step, then the table, its optimizer state and every dense
    parameter; the CPU takes #9's plain version (no launch counted)."""
    opt = {} if backward is None else {"fused_backward": backward}
    jcfg, cfg = sparse_configs("dien", engine, **opt)
    jinfo, info, first = _data(b=16, seed=20, neg=True)
    jt, js, pt, ps = pair(jcfg, cfg, jinfo, info, first)
    before = eu.fused_scatter_add.launches
    for i in range(3):
        js, ps, _ = step_both(jt, js, pt, ps, _data(b=16, seed=21 + i, neg=True)[2])
    assert_state_matches(jt, js, ps)
    assert eu.fused_scatter_add.launches == before
    assert set(ps.table_opt) == {"emb.embedding"}
