"""The port's fused embedding engine (``embedding_optimizer='fused_adam'``)
against the JAX package's, on the CPU (its Pallas kernels in interpret mode).

The JAX trainer and the port trainer start from the same weights and table
optimizer state (``tpurec_torch.bridge``) and take three fp32 steps on the
same numpy batches. Tolerances:

- the loss of each step, and its used-id L2 term: 1e-5 (fp32 sums in other
  orders);
- the tables and the dense parameters after three Adam steps at lr 1e-3:
  2e-6 (an Adam step moves a weight by up to lr; a gradient near eps turns a
  rounding difference of g into a visible share of lr, measured below 1e-7);
- Adam's moments: rtol 1e-4, atol 1e-9 (they are g and g² scaled by 0.1 and
  0.001, summed in another order); a bf16 first moment (rowwise Adam) to
  one bf16 step, rtol 2^-7.

The sacrificial last row of each table is left out: the lazy engines'
repeated pad writes land there in no fixed order.
"""

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_dataset
from test_torch_train import _by_torch_name
from tpurec.config import EmbeddingConfig as JEmbeddingConfig
from tpurec.config import ExperimentConfig as JExperimentConfig
from tpurec.config import ModelConfig as JModelConfig
from tpurec.config import OptimizerConfig as JOptimizerConfig
from tpurec.config import TrainConfig as JTrainConfig
from tpurec.core.mesh import make_mesh
from tpurec.data.schema import DataInfo as JDataInfo
from tpurec.train import Trainer as JTrainer
from tpurec_torch.bridge import _flatten, params_from_jax, table_opt_from_jax
from tpurec_torch.config import ExperimentConfig
from tpurec_torch.data.schema import DataInfo
from tpurec_torch.embedding.modules import embedding_tables
from tpurec_torch.ops import embedding_update as eu
from tpurec_torch.train.trainer import Trainer

torch.set_num_threads(1)

LOSS_TOL = 1e-5
PARAM_TOL = 2e-6
MOMENT_TOL = dict(rtol=1e-4, atol=1e-9)
BF16_MOMENT_TOL = dict(rtol=2.0**-7, atol=1e-9)


# --------------------------------------------------------------------------
# helpers, shared with tests/test_torch_engines.py
def tabular_data(batch=64, seed=0):
    names = [f"f{i}" for i in range(8)]
    rng = np.random.default_rng(seed)
    data = {n: rng.integers(50 * i, 50 * i + 50, size=(batch,)) for i, n in enumerate(names)}
    data["label"] = rng.integers(0, 2, size=(batch,)).astype(np.float32)
    kw = dict(user_features=names[:4], item_features=names[4:])
    return JDataInfo.from_dims(names, [50] * 8, **kw), DataInfo.from_dims(names, [50] * 8, **kw), data


def din_data(batch=16, seed=0):
    jinfo, data = _tiny_dataset(batch=batch, seq_len=16, seed=seed)
    info = DataInfo(**{k: getattr(jinfo, k) for k in DataInfo.__dataclass_fields__})
    return jinfo, info, data


def batches(model, n=3):
    make = din_data if model == "din" else tabular_data
    return [make(seed=10 + i)[2] for i in range(n)]


def sparse_configs(name, embedding_optimizer, used_id_l2=0.0, sparse=True, **opt):
    jcfg = JExperimentConfig(
        model=JModelConfig(name=name, embedding=JEmbeddingConfig(dim=8, used_id_l2=used_id_l2)),
        train=JTrainConfig(
            compute_dtype="float32", log_every_steps=0, sparse_embedding=sparse,
            optimizer=JOptimizerConfig(embedding_optimizer=embedding_optimizer, **opt),
        ),
    )
    return jcfg, ExperimentConfig.from_json(jcfg.to_json())


def pair(jcfg, cfg, jinfo, info, data):
    """(JAX trainer, its state, port trainer, its state from the same weights
    and table optimizer state)."""
    jt = JTrainer(jcfg, jinfo, mesh_ctx=make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    js = jt.init_state(data)
    pt = Trainer(cfg, info, device="cpu")
    ps = pt.init_state(data)
    variables = {"params": js.params, **js.model_state}
    if js.tables is not None:
        variables["tables"] = js.tables
    params_from_jax(ps.model, jax.tree.map(np.asarray, variables))
    if js.table_opt is not None:
        table_opt_from_jax(ps.table_opt, js.table_opt, ps.host_store, jt.host_store)
    return jt, js, pt, ps


def step_both(jt, js, pt, ps, data):
    js, _, jlogs = jt.train_step(js, jt.device_batch(data), jt.metrics.init())
    ps, _, plogs = pt.train_step(ps, pt.device_batch(data), pt.metrics.init())
    assert ps.step == int(js.step)
    np.testing.assert_allclose(float(plogs["loss"]), float(jlogs["loss"]), atol=LOSS_TOL, rtol=0)
    assert ("used_id_l2" in plogs) == ("used_id_l2" in jlogs)
    if "used_id_l2" in jlogs:
        np.testing.assert_allclose(
            float(plogs["used_id_l2"]), float(jlogs["used_id_l2"]), atol=LOSS_TOL, rtol=1e-5
        )
    return js, ps, float(plogs["loss"])


def assert_state_matches(jt, js, ps, param_tol=PARAM_TOL):
    """Tables and table optimizer state (without the sacrificial last row)
    and every dense parameter, the tables and parameters to ``param_tol``."""
    tables = _by_torch_name(js.tables, ps.model)
    dense = _by_torch_name(js.params, ps.model)
    got = {n: p.detach().numpy() for n, p in ps.model.named_parameters()}
    assert set(got) == set(tables) | set(dense)
    for name, want in tables.items():
        np.testing.assert_allclose(got[name][:-1], want[:-1], atol=param_tol, rtol=0, err_msg=name)
    for name, want in dense.items():
        np.testing.assert_allclose(got[name], want, atol=param_tol, rtol=0, err_msg=name)
    jopt = {".".join(p): st for p, st in _flatten(js.table_opt)}
    for name, st in ps.table_opt.items():
        if type(st).__name__ == "HostAdamState":
            slot = int(jopt[name].slot)
            moments = {"m": (ps.host_store._m[st.slot], jt.host_store._m[slot]),
                       "v": (ps.host_store._v[st.slot], jt.host_store._v[slot])}
        else:
            moments = {f: (getattr(st, f), getattr(jopt[name], f)) for f in st._fields}
        for field, (got_t, want) in moments.items():
            # a bf16 moment may round to the neighbouring bf16 value
            tol = BF16_MOMENT_TOL if got_t.dtype == torch.bfloat16 else MOMENT_TOL
            np.testing.assert_allclose(
                got_t.float().numpy()[:-1], np.asarray(want, np.float32)[:-1], **tol,
                err_msg=f"{name}.{field}",
            )


def run_both(model, jcfg, cfg, steps=3, data=None, param_tol=PARAM_TOL):
    if model == "din":
        jinfo, info, first = din_data()
    else:
        jinfo, info, first = tabular_data()
    jt, js, pt, ps = pair(jcfg, cfg, jinfo, info, first)
    for b in data or batches(model, steps):
        js, ps, _ = step_both(jt, js, pt, ps, b)
    assert_state_matches(jt, js, ps, param_tol)
    return jt, js, pt, ps


# --------------------------------------------------------------------------
@pytest.mark.parametrize("backward", ["permute", "sort_payload", "xla_packed"])
@pytest.mark.parametrize("used_id_l2", [0.0, 0.01])
@pytest.mark.parametrize("model", ["fm", "deepfm"])
def test_fused_engine_matches_jax(model, used_id_l2, backward):
    """Three steps: the loss (and its used-id L2 term) of each, then the
    tables, Adam's moments on every row and the dense parameters."""
    jcfg, cfg = sparse_configs(model, "fused_adam", used_id_l2, fused_backward=backward)
    before = eu.fused_scatter_add.launches
    run_both(model, jcfg, cfg)
    assert eu.fused_scatter_add.launches == before  # the CPU takes the plain version


def test_fused_engine_din_matches_jax():
    """DIN: (B, L) sequences flattened column-major with transposed positions
    and ``__mask__`` overrides, through the attention's plain forward and
    backward."""
    run_both("din", *sparse_configs("din", "fused_adam"))


def test_fused_engine_din_keeps_the_padding_mask():
    """A padded step that holds a valid-looking id (``test_fused_embedding.py:339``):
    the position rewrite makes every position nonzero, so only the shipped
    ``__mask__`` keeps the step masked. The fused step's loss equals the JAX
    fused step's and the port's dense step's."""
    jinfo, info, data = din_data(seed=7)
    hostile = {k: np.array(v) for k, v in data.items()}
    row, col = np.argwhere(hostile["history"] == 0)[0]
    hostile["history"][row, col] = 29
    jt, js, pt, ps = pair(*sparse_configs("din", "fused_adam"), jinfo, info, data)
    weights = {k: v.clone() for k, v in ps.model.state_dict().items()}
    _, _, fused_loss = step_both(jt, js, pt, ps, hostile)
    _, dense_cfg = sparse_configs("din", "fused_adam", sparse=False)
    dense = Trainer(dense_cfg, info, device="cpu")
    ds = dense.init_state(data)
    ds.model.load_state_dict(weights)
    _, _, dlogs = dense.train_step(ds, dense.device_batch(hostile), dense.metrics.init())
    np.testing.assert_allclose(float(dlogs["loss"]), fused_loss, atol=LOSS_TOL, rtol=0)


def test_fused_forward_and_sort_choices_give_the_same_numbers():
    """``fused_forward`` and ``fused_sort`` pick TPU strategies; the port's
    steps are the same whatever they say."""
    jinfo, info, data = tabular_data()
    losses = []
    for forward, sort in (("packed", "auto"), ("concat", "feature"), ("concat", "global")):
        _, cfg = sparse_configs("fm", "fused_adam", fused_forward=forward, fused_sort=sort)
        trainer = Trainer(cfg, info, device="cpu")
        state = trainer.init_state(data, seed=3)
        for b in batches("fm"):
            state, _, logs = trainer.train_step(state, trainer.device_batch(b), trainer.metrics.init())
        losses.append((float(logs["loss"]), state.model.v.embedding.detach().clone()))
    for loss, table in losses[1:]:
        assert loss == losses[0][0] and torch.equal(table, losses[0][1])


def test_fused_engine_tables_leave_the_optimizer_chain():
    jinfo, info, data = tabular_data()
    trainer = Trainer(sparse_configs("deepfm", "fused_adam")[1], info, device="cpu")
    state = trainer.init_state(data)
    names = [g["name"] for g in state.optimizer.param_groups]
    assert "v.embedding" not in names and "w.w.embedding" not in names and "bias" in names
    assert set(state.table_opt) == {"v.embedding", "w.w.embedding"}
    assert len(embedding_tables(state.model)) == 2
