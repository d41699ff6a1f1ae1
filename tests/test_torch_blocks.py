"""The building blocks' options against the JAX package on the CPU:
dropout (``ops/mlp.py`` ``Dropout``, ``apply_dropout_mask``), in the MLP and
in ``MultiHeadAttention`` in training mode, ``PReLU(init_alpha)``,
``Dice(epsilon)``, the embedding modules' ``init_scale`` and
``param_dtype``, and the bridge's strict load of an MLP's ``bn_{i}`` and
``ln_{i}``.

Tolerances:

- dropout with flax's mask (``jax.random.bernoulli(key, 1 − rate,
  shape)`` fed to ``apply_dropout_mask``): outputs and gradients exactly,
  in fp32 and bf16 (one division by 1 − rate rounded to the input's
  dtype, as JAX divides);
- the MLP and ``MultiHeadAttention`` in training mode with flax's masks
  (each ``nn.Dropout`` call given one key through
  ``flax.linen.intercept_methods``, the port's ``Dropout.keep_mask`` the
  same draw): outputs and input gradients at atol/rtol 1e-5 (``TOL``);
- a draw's keep fraction within 6σ of the binomial's mean;
- ``PReLU``, ``Dice`` and the embedding lookups at ``TOL``, bf16 tables
  and their lookups exactly (the same bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from test_torch_dcn import TOL, _redraw
from tpurec.embedding import modules as jmodules
from tpurec.ops import attention as jattention
from tpurec.ops import mlp as jmlp
from tpurec_torch.bridge import params_from_jax
from tpurec_torch.embedding import modules as tmodules
from tpurec_torch.initializers import init_parameters
from tpurec_torch.ops import attention as tattention
from tpurec_torch.ops import mlp as tmlp

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
DROPOUT_KEY = jax.random.key(11)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _unboxed(variables):
    return jax.tree.map(np.asarray, fnn.unbox(variables))


# --------------------------------------------------------------------------
# dropout
@pytest.mark.parametrize("rate", [0.1, 0.5, 1.0])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dropout_with_flax_mask_matches_flax(dtype, rate):
    """``apply_dropout_mask`` with flax's own mask equals ``nn.Dropout`` in
    training mode, output and ``jax.grad``, bit for bit (at rate 1: zeros
    and a zero gradient)."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = jnp.asarray(3.0 * rng.normal(size=(64, 7, 33))).astype(jd)
    g = jnp.asarray(rng.normal(size=x.shape)).astype(jd)

    def flax_dropout(x):
        return fnn.Dropout(rate).apply({}, x, deterministic=False, rng=DROPOUT_KEY)

    want, vjp = jax.vjp(flax_dropout, x)
    (want_dx,) = vjp(g)
    keep = torch.from_numpy(np.array(jax.random.bernoulli(DROPOUT_KEY, 1.0 - rate, x.shape)))
    tx = torch.tensor(_np(x)).to(td).requires_grad_()
    got = tmlp.apply_dropout_mask(tx, keep, rate)
    got.backward(torch.tensor(_np(g)).to(td))
    assert got.dtype == td
    np.testing.assert_array_equal(got.detach().float().numpy(), _np(want))
    np.testing.assert_array_equal(tx.grad.float().numpy(), _np(want_dx))


def _flax_keys(next_fun, args, kwargs, context):
    """Every ``nn.Dropout`` call draws from ``DROPOUT_KEY``."""
    if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
        kwargs = dict(kwargs, rng=DROPOUT_KEY)
    return next_fun(*args, **kwargs)


def _flax_masks(module, shape, device, columns=None):
    """The port's draw replaced by flax's mask under ``_flax_keys``."""
    assert columns is None
    return torch.from_numpy(np.array(jax.random.bernoulli(DROPOUT_KEY, 1.0 - module.rate, tuple(shape))))


def _train_both(jm, tm, jvars, x, g, **kw):
    """Output and input gradient of the JAX module in training mode (its
    dropout masks from ``DROPOUT_KEY``) and of the port module with the
    same masks."""
    def jax_fn(x):
        with fnn.intercept_methods(_flax_keys):
            out = jm.apply(jvars, x, train=True, mutable=["batch_stats"], **kw)[0]
        return out

    want, vjp = jax.vjp(jax_fn, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmlp.Dropout, "keep_mask", _flax_masks)
        got = tm.train()(tx, **{k: torch.from_numpy(v) for k, v in kw.items()})
    got.backward(torch.from_numpy(g))
    return (got.detach().numpy(), tx.grad.numpy()), (np.asarray(want), np.asarray(want_dx))


@pytest.mark.parametrize("kw", [
    dict(hidden_dims=(12, 6, 3), dropout_rate=0.3),
    dict(hidden_dims=(12, 6, 3), activation="gelu", out_activation="softmax", use_ln=True,
         dropout_rate=0.5),
    dict(hidden_dims=(12, 6), activation="dice", use_bn=True, dropout_rate=0.2),
], ids=["relu", "ln-gelu-softmax", "bn-dice"])
def test_mlp_dropout_in_training_matches_jax(kw):
    """The MLP in training mode: dropout after the activation of every layer
    but the last, after the norms."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(32, 10)).astype(np.float32)
    g = rng.normal(size=(32, kw["hidden_dims"][-1])).astype(np.float32)
    jm = jmlp.MLP(**kw)
    jvars = _redraw(_unboxed(jm.init(jax.random.key(0), jnp.asarray(x), train=False)), seed=2, scale=0.5)
    jvars["batch_stats"] = jax.tree.map(np.abs, jvars.get("batch_stats", {}))
    tm = params_from_jax(tmlp.MLP(10, **kw), jvars)
    got, want = _train_both(jm, tm, jvars, x, g)
    for key, a, b in zip(("output", "dx"), got, want):
        np.testing.assert_allclose(a, b, err_msg=key, **TOL)
    # the masks did work: without dropout the output differs
    tm.dropout = None
    with torch.no_grad():
        assert not np.allclose(tm(torch.from_numpy(x)).numpy(), want[0], **TOL)


@pytest.mark.parametrize("kw", [
    dict(dropout_rate=0.3),
    dict(dropout_rate=0.3, out_dim=8, use_layer_norm=False),
    dict(dropout_rate=0.5, out_dim=12, use_residual=True),
], ids=["residual-ln", "out_dim-no_ln", "out_dim_d"])
def test_multi_head_attention_dropout_in_training_matches_jax(kw):
    """``MultiHeadAttention`` in training mode: dropout after ``out``, then
    the residual (only when ``out_dim`` is D), then ``ln``."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(6, 4, 12)).astype(np.float32)
    mask = (rng.random((6, 4)) < 0.8).astype(np.float32)
    out_dim = kw.get("out_dim") or 12
    g = rng.normal(size=(6, 4, out_dim)).astype(np.float32)
    jm = jattention.MultiHeadAttention(2, 3, **kw)
    jvars = _redraw(_unboxed(jm.init(jax.random.key(0), jnp.asarray(q), mask=jnp.asarray(mask))),
                    seed=4, scale=0.5)
    tm = params_from_jax(tattention.MultiHeadAttention(12, 2, 3, **kw), jvars)
    got, want = _train_both(jm, tm, jvars, q, g, mask=mask)
    assert got[0].shape == want[0].shape == (6, 4, out_dim)
    for key, a, b in zip(("output", "dq"), got, want):
        np.testing.assert_allclose(a, b, err_msg=key, **TOL)


def test_dropout_draw_keep_fraction_and_replay():
    """A draw keeps each element with probability 1 − rate: the kept
    fraction of 10^6 lies within 6σ of the binomial's mean; the same
    generator state gives the same mask, the next state another."""
    n, rate = 1_000_000, 0.1
    drop = tmlp.Dropout(rate)
    gen = torch.Generator().manual_seed(5)
    with tmlp.dropout_generator(drop, gen):
        state = gen.get_state()
        keep = drop.keep_mask((1000, 1000), "cpu")
        gen.set_state(state)
        again = drop.keep_mask((1000, 1000), "cpu")
        other = drop.keep_mask((1000, 1000), "cpu")
    sigma = np.sqrt(n * rate * (1.0 - rate))
    assert keep.dtype == torch.bool
    assert abs(int(keep.sum()) - n * (1.0 - rate)) < 6.0 * sigma
    assert torch.equal(keep, again) and not torch.equal(keep, other)
    assert drop.generator is None  # the context hands the generator back


def test_dropout_training_without_generator_raises():
    """A module training with a dropout rate above 0 and no generator
    raises, never drawing from torch's global generator; in eval mode, at
    rate 0, and with a generator it runs."""
    x = torch.randn(4, 3, 12)
    mlp = init_parameters(tmlp.MLP(12, (8, 4), dropout_rate=0.1))
    mha = init_parameters(tattention.MultiHeadAttention(12, 2, 3, dropout_rate=0.1))
    for module in (mlp, mha):
        with pytest.raises(RuntimeError, match="dropout in training needs a generator"):
            module.train()(x)
        module.eval()(x)
        with tmlp.dropout_generator(module, torch.Generator().manual_seed(0)):
            module.train()(x)
    init_parameters(tmlp.MLP(12, (8, 4))).train()(x)  # rate 0: no draw


def test_trainer_step_draws_dropout_from_its_generator():
    """A ``Trainer`` step hands ``TrainState.generator`` to the model's
    dropout (DIN's ``mlp`` given ``Dropout(0.5)``): two runs from the same
    seed take the same loss, a run without the dropout another; the model
    outside the step has no generator, and ``evaluate`` runs it in eval
    mode."""
    from __graft_entry__ import _tiny_dataset
    from tpurec_torch.config import ExperimentConfig
    from tpurec_torch.data.schema import DataInfo
    from tpurec_torch.train.trainer import Trainer

    jinfo, data = _tiny_dataset(batch=16, seq_len=16, seed=0)
    info = DataInfo(**{k: getattr(jinfo, k) for k in DataInfo.__dataclass_fields__})
    cfg = ExperimentConfig.from_dict(dict(model=dict(name="din", embedding=dict(dim=8)),
                                          train=dict(compute_dtype="float32", log_every_steps=0)))

    def step(rate):
        trainer = Trainer(cfg, info, device="cpu")
        state = trainer.init_state(data)
        if rate:
            state.model.mlp.dropout = tmlp.Dropout(rate)
        batch = trainer.device_batch(data)
        state, _, logs = trainer.train_step(state, batch, trainer.metrics.init())
        return trainer, state, float(logs["loss"])

    trainer, state, loss = step(0.5)
    assert state.model.mlp.dropout.generator is None
    assert step(0.5)[2] == loss and step(0.0)[2] != loss
    with pytest.raises(RuntimeError, match="needs a generator"):
        state.model.train().mlp(torch.randn(4, state.model.mlp.dense_0.weight.shape[1]))
    assert np.isfinite(trainer.evaluate(state, [data])["loss"])


# --------------------------------------------------------------------------
# PReLU and Dice
@pytest.mark.parametrize("init_alpha", [0.25, 0.1, -0.5])
def test_prelu_init_alpha_matches_jax(init_alpha):
    """``PReLU(init_alpha)``: the slope flax draws, and the output."""
    x = np.random.default_rng(6).normal(size=(9, 7)).astype(np.float32)
    jm = jmlp.PReLU(init_alpha=init_alpha)
    jvars = _unboxed(jm.init(jax.random.key(0), jnp.asarray(x)))
    tm = init_parameters(tmlp.PReLU(7, init_alpha=init_alpha))
    np.testing.assert_array_equal(tm.alpha.detach().numpy(), jvars["params"]["alpha"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(jvars, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("epsilon", [1e-9, 1e-4, 1e-2])
def test_dice_epsilon_matches_jax(epsilon):
    """``Dice(epsilon)`` in training mode on near-constant features (a batch
    spread of 1e-2 about 0, variance 1e-4), where epsilon decides the gate:
    the output and the running statistics against flax's, and another
    epsilon gives another output."""
    rng = np.random.default_rng(7)
    x = (1e-2 * rng.normal(size=(64, 5))).astype(np.float32)
    jm = jmlp.Dice(epsilon=epsilon)
    jvars = _unboxed(jm.init(jax.random.key(0), jnp.asarray(x), train=False))
    jvars["params"]["alpha"] = rng.uniform(-1.0, 1.0, size=5).astype(np.float32)
    want, stats = jm.apply(jvars, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tm = params_from_jax(tmlp.Dice(5, epsilon=epsilon), jvars).train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tm.bn.running_var.numpy(), stats["batch_stats"]["bn"]["var"], **TOL)
    other = params_from_jax(tmlp.Dice(5, epsilon=1e-9 if epsilon > 1e-6 else 1e-2), jvars).train()
    with torch.no_grad():
        assert not np.allclose(other(torch.from_numpy(x)).numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------------
# the embedding modules' init_scale and param_dtype
EMBEDDINGS = {
    # case: (JAX module, port module, (ids shape), row shape)
    "shared": (lambda **kw: jmodules.SharedEmbedding(300, 8, **kw),
               lambda **kw: tmodules.SharedEmbedding(300, 8, **kw), (8,)),
    "linear": (lambda **kw: jmodules.LinearEmbedding(300, **kw),
               lambda **kw: tmodules.LinearEmbedding(300, **kw), ()),
    "field_aware": (lambda **kw: jmodules.FieldAwareEmbedding(300, 3, 4, **kw),
                    lambda **kw: tmodules.FieldAwareEmbedding(300, 3, 4, **kw), (3, 4)),
}


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(EMBEDDINGS))
def test_embedding_init_scale_and_param_dtype(case, param_dtype):
    """Each embedding module with ``init_scale`` 0.01 and ``param_dtype``:
    the table is held in ``param_dtype``, drawn within ±0.01 (rounded to
    ``param_dtype``) and spread over it (both packages); through the bridge the port's table takes
    flax's bits without an upcast, and a lookup comes back in the table's
    dtype (``dtype`` None) or in ``dtype``, equal to flax's."""
    jd, td = DTYPES[param_dtype]
    jmake, tmake, row = EMBEDDINGS[case]
    ids = np.random.default_rng(8).integers(0, 300, size=(6, 5)).astype(np.int32)
    for dtype in (None, "float32"):
        jkw = dict(init_scale=0.01, param_dtype=jd, dtype=None if dtype is None else jnp.float32)
        tkw = dict(init_scale=0.01, param_dtype=td, dtype=None if dtype is None else torch.float32)
        jm, tm = jmake(**jkw), tmake(**tkw)
        jvars = fnn.unbox(jm.init(jax.random.key(0), jnp.asarray(ids)))
        jvars = {k: v for k, v in jvars.items() if k != "regularization"}
        init_parameters(tm)
        (name, table), = [(n, p) for n, p in tm.named_parameters()]
        jtable = jax.tree.leaves(jvars["params"])[0]
        assert table.dtype == td and jtable.dtype == jd
        limit = float(torch.tensor(0.01, dtype=td))  # 0.01 rounded to the table's dtype
        for t in (table.detach().float().numpy(), _np(jtable)):
            assert np.abs(t).max() <= limit and np.abs(t).max() > 0.009
            assert abs(t.std() - 0.01 / np.sqrt(3.0)) < 0.1 * 0.01 / np.sqrt(3.0)
        params_from_jax(tm, jax.tree.map(np.asarray, jvars))
        assert table.dtype == td
        np.testing.assert_array_equal(table.detach().float().numpy(), _np(jtable))
        want = jm.apply(jvars, jnp.asarray(ids))
        with torch.no_grad():
            got = tm(torch.from_numpy(ids).long())
        assert str(got.dtype).split(".")[-1] == str(want.dtype) == (dtype or param_dtype)
        assert tuple(got.shape) == want.shape == ids.shape + row
        np.testing.assert_array_equal(got.float().numpy(), _np(want))


# --------------------------------------------------------------------------
# the bridge and an MLP's norms
def test_params_from_jax_round_trip_of_mlp_norms():
    """An MLP with ``bn_{i}`` and ``ln_{i}`` loads flax's ``params`` and
    ``batch_stats`` strictly (every key matched), and the port's state
    maps back onto flax's tree leaf for leaf; a tree without one norm's
    leaves is refused."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(4, 10)).astype(np.float32)
    jm = jmlp.MLP((12, 6, 3), use_bn=True, use_ln=True, activation="prelu")
    jvars = _redraw(_unboxed(jm.init(jax.random.key(0), jnp.asarray(x), train=False)), seed=10)
    tm = params_from_jax(tmlp.MLP(10, (12, 6, 3), use_bn=True, use_ln=True, activation="prelu"), jvars)
    state = tm.state_dict()
    flat = {}
    for collection, tree in jvars.items():
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            keys = [p.key for p in path]
            name = {"kernel": "weight", "mean": "running_mean", "var": "running_var"}.get(keys[-1], keys[-1])
            flat[".".join(keys[:-1] + [name])] = leaf.T if keys[-1] == "kernel" else leaf
    assert set(flat) == set(state)
    assert {k.split(".")[0] for k in state} >= {"bn_0", "bn_1", "ln_0", "ln_1"}
    for key, leaf in flat.items():
        np.testing.assert_array_equal(state[key].numpy(), leaf, err_msg=key)
    lacking = jax.tree.map(lambda a: a, jvars)
    del lacking["params"]["ln_1"]
    with pytest.raises(RuntimeError, match="Missing"):
        params_from_jax(tmlp.MLP(10, (12, 6, 3), use_bn=True, use_ln=True, activation="prelu"), lacking)
