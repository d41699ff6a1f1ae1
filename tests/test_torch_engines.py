"""The port's lazy-sparse embedding engine (``embedding_optimizer`` 'adam',
'rowwise_adam', 'rowwise_adagrad', 'host_adam' with ``sparse_embedding=True``)
and the sparse engines' state handling, against the JAX package on the CPU.

Trainer cases start both trainers from the same weights and table optimizer
state (``tpurec_torch.bridge``) and take three fp32 steps on the same numpy
batches, with the tolerances of ``tests/test_torch_engines_fused.py``. The
ops of ``tpurec_torch.embedding.sparse`` and the host store are held to
their JAX counterparts: positions and unique ids exactly, updated rows and
moments within rtol 1e-6 (the same fp32 expressions; ``rsqrt`` and fused
multiply-adds round differently).
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engines_fused import (
    din_data,
    pair,
    run_both,
    sparse_configs,
    step_both,
    tabular_data,
)
from test_torch_train import _by_torch_name
from tpurec.embedding import host_offload as jhost
from tpurec.embedding import sparse as jsparse
from tpurec_torch.bridge import params_from_jax, table_opt_from_jax
from tpurec_torch.config import ExperimentConfig
from tpurec_torch.embedding import sparse
from tpurec_torch.embedding.host_offload import HostAdamState, HostAdamStore
from tpurec_torch.embedding.ops import contiguous_take
from tpurec_torch.train.trainer import Trainer

torch.set_num_threads(1)

OP_TOL = dict(rtol=1e-6, atol=1e-8)


# --------------------------------------------------------------------------
# the ops
def test_unique_ops_match_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 40, size=(12, 5))
    pad = 63
    np.testing.assert_array_equal(
        sparse.unique_fixed(torch.from_numpy(ids), pad).numpy(),
        np.asarray(jsparse.unique_fixed(jnp.asarray(ids), pad)),
    )
    uniq, pos = sparse.unique_with_positions(torch.from_numpy(ids.reshape(-1)), pad)
    juniq, jpos = jsparse.unique_with_positions(jnp.asarray(ids.reshape(-1)), pad)
    np.testing.assert_array_equal(uniq.numpy(), np.asarray(juniq))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    assert uniq[0] == 0 and torch.equal(uniq[pos], torch.from_numpy(ids.reshape(-1)))
    u = sparse.unique_fixed(torch.from_numpy(ids), pad)
    np.testing.assert_array_equal(
        sparse.lookup_positions(u, torch.from_numpy(ids)).numpy(),
        np.asarray(jsparse.lookup_positions(jnp.asarray(u.numpy()), jnp.asarray(ids))),
    )


def _opt_case(v=40, d=8, u=12, seed=1):
    rng = np.random.default_rng(seed)
    uniq = np.concatenate([np.sort(rng.choice(v - 1, size=u - 3, replace=False)), [v - 1] * 3])
    return (rng.normal(size=(v, d)).astype(np.float32), uniq,
            rng.normal(size=(u, d)).astype(np.float32))


@pytest.mark.parametrize("kind", ["adam", "rowwise_adam", "rowwise_adagrad"])
def test_sparse_optimizers_match_jax(kind):
    """Three updates of the touched rows, with the sacrificial pad row
    repeated (zero gradients there, so every repeat writes the same)."""
    table, uniq, _ = _opt_case()
    jinit, init, jfn, fn = {
        "adam": (jsparse.init_sparse_adam, sparse.init_sparse_adam, jsparse.sparse_adam,
                 sparse.sparse_adam),
        "rowwise_adam": (jsparse.init_sparse_row_adam, sparse.init_sparse_row_adam,
                         jsparse.sparse_rowwise_adam, sparse.sparse_rowwise_adam),
        "rowwise_adagrad": (jsparse.init_sparse_adagrad, sparse.init_sparse_adagrad,
                            jsparse.sparse_rowwise_adagrad, sparse.sparse_rowwise_adagrad),
    }[kind]
    jt, t = jnp.asarray(table), torch.from_numpy(table.copy())
    jst, st = jinit(jt), init(t)
    for step in (1, 2, 3):
        g = _opt_case(seed=step + 10)[2]
        g[-3:] = 0.0
        args = () if kind == "rowwise_adagrad" else (step,)
        jt, jst = jfn(jt, jst, jnp.asarray(uniq), jnp.asarray(g), *(map(jnp.int32, args)), 1e-2)
        t, st = fn(t, st, torch.from_numpy(uniq), torch.from_numpy(g), *args, 1e-2)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), **OP_TOL)
    for f in st._fields:
        got, want = getattr(st, f), np.asarray(getattr(jst, f), np.float32)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.float().numpy(), want, **OP_TOL, err_msg=f)
    if kind == "rowwise_adam":
        assert st.m.dtype == torch.bfloat16 and st.v.shape == (40,)


def test_host_store_matches_jax_store():
    """The host update (the JAX store's callback, fp32 numpy) gives the
    same deltas and moments bit for bit; ``update`` subtracts them from the
    table's touched rows."""
    table, uniq, _ = _opt_case()
    jstore, store = jhost.HostAdamStore(), HostAdamStore()
    jslot, slot = jstore.register(table.shape), store.register(table.shape)
    t, want = torch.from_numpy(table.copy()), table.copy()
    for step in (1, 2):
        g = _opt_case(seed=step + 20)[2]
        delta = jstore._callback(
            np.int32(jslot), uniq, g, np.int32(step), *map(np.float32, (1e-2, 0.9, 0.999, 1e-7))
        )
        want[uniq] = want[uniq] - delta
        store.update(t, HostAdamState(slot), torch.from_numpy(uniq), torch.from_numpy(g), step, 1e-2)
    np.testing.assert_array_equal(t.numpy()[:-1], want[:-1])
    np.testing.assert_array_equal(store._m[slot].numpy(), jstore._m[jslot])
    np.testing.assert_array_equal(store._v[slot].numpy(), jstore._v[jslot])
    assert store.state_dict().keys() == jstore.state_dict().keys() == {"m_0", "v_0"}
    assert store.nbytes() == 2 * table.nbytes and store.num_tables == 1


def test_contiguous_take_backward_writes_each_run_once():
    """Columns of contiguous runs (the FM layout, and a transposed (B, L)
    sequence): the gradient equals the JAX VJP and ``F.embedding``'s."""
    from tpurec.embedding.ops import contiguous_take as jtake

    rng = np.random.default_rng(2)
    rows = rng.normal(size=(40, 3)).astype(np.float32)
    ids = np.arange(8, 32).reshape(4, 6).T  # (B=6, k=4), column j = 8 + 6j + arange(6)
    cot = rng.normal(size=(6, 4, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda r: jtake(r, jnp.asarray(ids)), jnp.asarray(rows))
    x = torch.from_numpy(rows).requires_grad_()
    out = contiguous_take(x, torch.from_numpy(ids))
    np.testing.assert_array_equal(out.detach().numpy(), rows[ids])
    out.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]))


# --------------------------------------------------------------------------
# the lazy-sparse engine against JAX
@pytest.mark.parametrize("model", ["fm", "din"])
@pytest.mark.parametrize("opt", ["adam", "rowwise_adam", "rowwise_adagrad"])
def test_lazy_sparse_engine_matches_jax(opt, model):
    """Three steps with the used-id L2 term on: the loss and its term each
    step, then the tables, their optimizer state and the dense params."""
    run_both(model, *sparse_configs(model, opt, used_id_l2=0.01))


def test_host_adam_engine_matches_jax():
    """host_adam: the same steps, the moments compared in both host stores."""
    _, _, pt, ps = run_both("fm", *sparse_configs("fm", "host_adam"))
    assert all(isinstance(st, HostAdamState) for st in ps.table_opt.values())
    assert ps.host_store.num_tables == 2


def test_host_adam_equals_lazy_adam():
    """host_adam and the lazy 'adam' engine are the same math (the JAX
    package's ``test_host_offload.py:120``), numpy on the host against
    torch: the tables agree to the trainer tolerance, 2e-6."""
    jinfo, info, data = tabular_data()
    tables = []
    for opt in ("adam", "host_adam"):
        trainer = Trainer(sparse_configs("fm", opt)[1], info, device="cpu")
        state = trainer.init_state(data, seed=5)
        for i in range(3):
            batch = trainer.device_batch(tabular_data(seed=30 + i)[2])
            state, _, _ = trainer.train_step(state, batch, trainer.metrics.init())
        tables.append(state.model.v.embedding.detach()[:-1])
    torch.testing.assert_close(tables[0], tables[1], rtol=0, atol=2e-6)


# --------------------------------------------------------------------------
# state handling
def test_bridge_carries_tables_and_table_opt():
    """After JAX steps, its tables and every kind of table optimizer state
    (including a host store's moments) land in the port."""
    jinfo, info, data = tabular_data()
    for opt in ("adam", "rowwise_adam", "rowwise_adagrad", "host_adam"):
        jt, js, pt, ps = pair(*sparse_configs("fm", opt), jinfo, info, data)
        js, _, _ = jt.train_step(js, jt.device_batch(data), jt.metrics.init())
        params_from_jax(ps.model, jax.tree.map(np.asarray, {"params": js.params, "tables": js.tables}))
        table_opt_from_jax(ps.table_opt, js.table_opt, ps.host_store, jt.host_store)
        for name, want in _by_torch_name(js.tables, ps.model).items():
            np.testing.assert_array_equal(ps.model.get_parameter(name).detach().numpy(), want)
        st, jst = ps.table_opt["v.embedding"], js.table_opt["v"]["embedding"]
        if opt == "host_adam":
            jslot = int(jst.slot)
            np.testing.assert_array_equal(ps.host_store._m[st.slot].numpy(), jt.host_store._m[jslot])
            np.testing.assert_array_equal(ps.host_store._v[st.slot].numpy(), jt.host_store._v[jslot])
            assert jt.host_store._v[jslot].any()
        else:
            for f in st._fields:
                np.testing.assert_array_equal(getattr(st, f).float().numpy(),
                                              np.asarray(getattr(jst, f), np.float32))
                assert getattr(st, f).float().abs().sum() > 0


@pytest.mark.parametrize("opt", ["fused_adam", "rowwise_adam", "host_adam"])
def test_checkpoint_round_trip_with_table_opt(opt, tmp_path):
    """``save`` → two more steps → ``restore``: the tables, the table
    optimizer state and (host_adam) the host moments from the step's
    sidecar come back exactly; sidecars of dropped steps are removed."""
    jinfo, info, data = tabular_data()
    _, cfg = sparse_configs("fm", opt)
    cfg = cfg.replace(train=cfg.train.replace(checkpoint_dir=str(tmp_path), max_to_keep=1))
    trainer = Trainer(cfg, info, device="cpu")
    state = trainer.init_state(data)
    batch = trainer.device_batch(data)
    state, _, _ = trainer.train_step(state, batch, trainer.metrics.init())
    trainer.save(state)

    def snapshot(s):
        opt_state = {n: {f: (v.clone() if isinstance(v, torch.Tensor) else v)
                         for f, v in st._asdict().items()} for n, st in s.table_opt.items()}
        host = None if s.host_store is None else [t.clone() for t in s.host_store._m + s.host_store._v]
        return {k: v.clone() for k, v in s.model.state_dict().items()}, opt_state, host

    saved = snapshot(state)
    for _ in range(2):
        state, _, _ = trainer.train_step(state, batch, trainer.metrics.init())
    trainer.save(state)  # step 3; max_to_keep=1 drops step 1 and its sidecar
    sidecars = sorted(f for f in os.listdir(tmp_path) if f.startswith("host_moments_"))
    assert sidecars == (["host_moments_3.npz"] if opt == "host_adam" else [])
    trainer.ckpt.max_to_keep = 3
    fresh = trainer.init_state(data, seed=9)
    fresh, _, _ = trainer.train_step(fresh, batch, trainer.metrics.init())
    assert fresh.step == 1
    trainer.save(fresh)
    trainer.ckpt.max_to_keep = 1
    # back to step 1 from the step-1 checkpoint just written over the old one
    restored = trainer.restore(state, step=1)
    got = snapshot(restored)
    want = snapshot(fresh)
    assert restored.step == 1
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    for n in want[1]:
        for f, v in want[1][n].items():
            assert torch.equal(got[1][n][f], v) if isinstance(v, torch.Tensor) else got[1][n][f] == v
    if opt == "host_adam":
        assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))
        os.remove(tmp_path / "host_moments_1.npz")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer.restore(state, step=1)
        assert any("sidecar missing" in str(w.message) for w in caught)
    assert saved[0].keys() == got[0].keys()


@pytest.mark.parametrize("opt", ["fused_adam", "rowwise_adagrad"])
def test_sparse_trained_state_exports_to_a_servable(opt, tmp_path):
    """``run`` with ``eval`` and ``infer`` in a sparse engine, ``export`` →
    ``load_servable``: the served prediction equals ``Trainer.infer``;
    ``load_from_export`` brings the tables back into a fresh state."""
    from tpurec_torch.serving.export import load_servable

    jinfo, info, _ = din_data()
    train = [din_data(seed=40 + i)[2] for i in range(3)]
    evals = [din_data(seed=50)[2]]
    _, cfg = sparse_configs("din", opt)
    cfg = cfg.replace(train=cfg.train.replace(epochs=2))
    trainer = Trainer(cfg, info, device="cpu")
    state, out = trainer.run(lambda: iter(train), lambda: iter(evals))
    assert state.step == 6 and set(out["best_eval"]) == {"loss", "auc"}
    trainer.export(state, str(tmp_path / "export"))
    meta = json.loads((tmp_path / "export" / "export_meta.json").read_text())
    assert meta["model"] == "din"
    servable = load_servable(str(tmp_path / "export"), info, device="cpu")
    rows = {k: v[:8] for k, v in evals[0].items() if k != "label"}
    np.testing.assert_array_equal(
        servable.predict(rows)["output"].numpy(), trainer.infer(state, rows)["output"]
    )
    back = trainer.load_from_export(trainer.init_state(seed=7), str(tmp_path / "export"))
    assert torch.equal(back.model.emb.embedding, state.model.emb.embedding)


# --------------------------------------------------------------------------
# what the engines refuse
def test_sparse_engines_refuse_what_jax_refuses():
    jinfo, info, _ = din_data()
    tinfo = tabular_data()[1]
    _, cfg = sparse_configs("fm", "fused_adam")
    with pytest.raises(ValueError, match="in_batch_softmax"):
        Trainer(cfg.replace(train=cfg.train.replace(loss="in_batch_softmax")), tinfo, device="cpu")
    padded = info.__class__(**{**info.__dict__, "padding_index": 3})
    with pytest.raises(ValueError, match="padding_index"):
        Trainer(sparse_configs("din", "fused_adam")[1], padded, device="cpu")
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        Trainer(cfg.replace(mesh=cfg.mesh.replace(data=2)), tinfo, device="cpu")
    with pytest.raises(KeyError):
        Trainer(sparse_configs("fm", "lamb")[1], tinfo, device="cpu")
    with pytest.raises(ValueError, match="fused_backward"):
        Trainer(sparse_configs("fm", "fused_adam", fused_backward="scatter")[1], tinfo,
                device="cpu")
    # the lazy engines train in_batch_softmax, as in the JAX package
    lazy = sparse_configs("dssm_double", "rowwise_adam")[1]
    Trainer(lazy.replace(train=lazy.train.replace(loss="in_batch_softmax")), tinfo, device="cpu")
    assert ExperimentConfig().train.sparse_embedding is False


def test_lazy_engine_trains_in_batch_softmax_like_jax():
    jinfo, info, data = tabular_data()
    data["item_id"] = np.random.default_rng(3).integers(0, 6, size=(64,))
    jcfg, cfg = sparse_configs("dssm_double", "adam")
    jcfg = jcfg.replace(train=jcfg.train.replace(loss="in_batch_softmax"))
    cfg = cfg.replace(train=cfg.train.replace(loss="in_batch_softmax"))
    jt, js, pt, ps = pair(jcfg, cfg, jinfo, info, data)
    for _ in range(2):
        js, ps, _ = step_both(jt, js, pt, ps, data)
    np.testing.assert_allclose(
        ps.model.u_tower.emb.embedding.detach().numpy()[:-1],
        _by_torch_name(js.tables, ps.model)["u_tower.emb.embedding"][:-1], atol=2e-6, rtol=0,
    )
