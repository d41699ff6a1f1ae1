"""The port's ``Trainer`` on a mesh, on the CPU: ranks are spawned processes
over gloo (``tests/test_torch_mesh.py``'s ``run_world``), the JAX package's
trainer runs on four of its virtual CPU devices in the pytest process.

Three worlds, each run once for the whole file:

- (2, 2), four ranks: DIN in the dense engine (its top MLP tensor
  parallel) and FM in the fused engine against the JAX package's (2, 2)
  runs, four fp32 steps from the same weights on the same global batches;
  FM fused also against the port's one-device fused step; FM in the three
  lazy-sparse engines and DIN in ``rowwise_adam`` against the JAX
  package's (2, 2) runs; ``evaluate`` over a batch that divides over
  'data' and one that does not, against one device and the JAX package;
  checkpoints moved between (2, 2) and one device both ways; the export;
  ``dryrun_multichip``; the refusals; every other registry model (the
  cases of ``tests/test_torch_mesh_data.py``) one step against one device;
  a tensor-parallel MLP with LayerNorm, BatchNorm, a softmax and dropout,
  one training forward and backward against one device.
- (1, 4), four ranks: din, fm, ffm and mmoe in the dense and the fused
  engine against the one-device step; din, mmoe and autoint (tensor
  parallel) and FM's three lazy-sparse engines against the JAX package's
  (1, 4) runs; the tensor-parallel initialisation against one device.
- a world of one: equal to the trainer without a world.

Tolerances (no looser than the JAX package's own ``test_tp_matches_dp``):
losses rtol 2e-4, atol 2e-5; parameters rtol 5e-3, atol 5e-5, on the rows
both tables have (``pad_vocab`` rounds rows to n_model·128); the used-id
L2 term like the losses; AUC 1e-6 (a sum of histogram counts). The world
of one, and the model-only mesh of the models without tensor-parallel
weights (fm, ffm), are exact: the sum over 'model' adds zeros, and every
other operation is the one-device step's. A tensor-parallel row layer
sums its partial products over 'model' in another order, so din and mmoe
on (1, 4) are held to one device at the losses' and parameters'
tolerances; their initialisation is exact.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from test_torch_mesh import rank_main, run_world, shared_world  # noqa: E402
from tpurec_torch.config import ExperimentConfig, MeshConfig  # noqa: E402
from tpurec_torch.embedding.modules import embedding_tables  # noqa: E402

LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=5e-3, atol=5e-5)
MOMENT_TOL = dict(rtol=5e-3, atol=1e-8)
STEPS = 4
SPARSE_STEPS = 3
EXACT_MODELS = ("din", "fm", "ffm", "mmoe")
TP_MODELS = ("din", "mmoe")  # tensor parallel on (1, 4): held at LOSS_TOL, PARAM_TOL
LAZY_ENGINES = ("adam", "rowwise_adam", "rowwise_adagrad")
JAX14_MODELS = ("din", "mmoe", "autoint")


# --------------------------------------------------------------------------
# shared by both sides
def _tables(model):
    from tpurec_torch.train.trainer import _table_names

    return dict(zip(_table_names(model), embedding_tables(model)))


def _whole_params(model):
    """{name: numpy} of every parameter, tables and tensor-parallel weights
    whole (a collective on a mesh)."""
    from tpurec_torch.train.trainer import whole_tensors

    return {n: t.cpu().numpy() for n, t in whole_tensors(model).items()}


def _whole_moments(state):
    """{table: {field: numpy}} of the table optimizer state, whole, fp32."""
    tables = _tables(state.model)
    return {n: {f: tables[n].whole(v).float().numpy() for f, v in st._asdict().items()}
            for n, st in state.table_opt.items()}


def _shard_shapes(model):
    """{name: local shape} of every tensor-parallel weight."""
    from tpurec_torch.models.registry import sharded_weights

    params = dict(model.named_parameters())
    return {n: tuple(params[n].shape) for n in sharded_weights(model)}


def _run(trainer, state, batches):
    """Steps on ``batches``: (state, losses, used-id L2 terms, metric results)."""
    metric_state = trainer.metrics.init()
    losses, regs = [], []
    for b in batches:
        state, metric_state, logs = trainer.train_step(state, trainer.device_batch(b),
                                                       metric_state)
        losses.append(float(logs["loss"]))
        regs.append(float(logs["used_id_l2"]) if "used_id_l2" in logs else None)
    results = {k: float(v) for k, v in trainer.metrics.result(metric_state).items()}
    return state, losses, regs, results


def _variant(cfg, model=None, embedding_optimizer=None, **train):
    """An ``ExperimentConfig`` (or its JSON) with another model name, table
    optimizer or train fields."""
    cfg = ExperimentConfig.from_json(cfg) if isinstance(cfg, str) else cfg
    if model is not None:
        cfg = cfg.replace(model=cfg.model.replace(name=model))
    tr = cfg.train.replace(**train)
    if embedding_optimizer is not None:
        tr = tr.replace(optimizer=tr.optimizer.replace(embedding_optimizer=embedding_optimizer))
    return cfg.replace(train=tr)


def _trainer(cfg, info, mesh=None, **kw):
    from tpurec_torch.train.trainer import Trainer

    return Trainer(_variant(cfg, **kw), info, device="cpu", mesh_ctx=mesh)


def _refusal(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test reads the type and words
        return type(e).__name__, str(e)
    return None


# --------------------------------------------------------------------------
# the ranks' side
def _mesh22(inputs):
    from tpurec_torch.bridge import params_from_jax
    from tpurec_torch.core.mesh import make_mesh

    out = {}
    for name in ("din", "fm"):
        case = inputs[name]
        t = _trainer(case["cfg"], case["info"], checkpoint_dir=case["ckpt"])
        state = t.init_state()
        if name == "din":
            out["din_shards"] = _shard_shapes(state.model)
        params_from_jax(state.model, case["variables"])
        state, losses, regs, results = _run(t, state, case["batches"])
        out[name] = {"losses": losses, "regs": regs, "results": results,
                     "params": _whole_params(state.model)}
        if state.table_opt is not None:
            out[name]["moments"] = _whole_moments(state)
        t.save(state)
        t.export(state, case["export"])
        out[name]["infer"] = t.infer(state, case["batches"][0])["output"]

    # a one-device checkpoint restored on (2, 2), then one step
    case = inputs["restore"]
    t = _trainer(case["cfg"], case["info"], checkpoint_dir=case["ckpt"])
    state = t.restore(t.init_state())
    state, losses, _, _ = _run(t, state, [case["batch"]])
    out["restore"] = {"step": state.step, "losses": losses, "params": _whole_params(state.model)}

    # evaluate over a batch that divides over 'data' and one that does not
    case = inputs["evaluate"]
    t = _trainer(case["cfg"], case["info"])
    state = t.init_state()
    params_from_jax(state.model, case["variables"])
    out["evaluate"] = {k: t.evaluate(state, batches) for k, batches in case["batches"].items()}

    out["lazy"] = _lazy_runs(inputs["lazy"])

    from tpurec_torch.dryrun import dryrun_multichip

    out["dryrun"] = dryrun_multichip(4, "cpu")

    from test_torch_mesh_data import _case_run

    mesh = make_mesh(MeshConfig(data=2, model=2))
    out["models"] = {key: _case_run(case, mesh) for key, case in inputs["models"].items()}
    out["blocks"] = {key: _block_run(case, mesh) for key, case in inputs["blocks"].items()}

    din, fm = inputs["din"], inputs["fm"]
    mesh14 = make_mesh(MeshConfig(data=1, model=4))
    out["refusals"] = {
        "model": _refusal(lambda: _trainer(fm["cfg"], fm["info"], model="deepfm",
                                           sparse_embedding=False)),
        "loss": _refusal(lambda: _trainer(din["cfg"], din["info"], loss="in_batch_softmax")),
        "host_adam": _refusal(lambda: _trainer(fm["cfg"], fm["info"], mesh14,
                                               embedding_optimizer="host_adam")),
    }
    return out


def _block_run(case, mesh=None):
    """One training forward and backward of a tensor-parallel ``MLP`` (the
    case's options, flax variables, global batch, cotangent and dropout
    seed) on ``mesh`` (None: one device): the output and input gradient of
    this rank's rows over 'data', and the BatchNorms' running statistics."""
    from tpurec_torch.bridge import params_from_jax
    from tpurec_torch.models.registry import place_on_mesh
    from tpurec_torch.ops.mlp import MLP, dropout_generator

    mlp = MLP(case["x"].shape[-1], tp_axis="model", **case["kw"])
    rows = (0, case["x"].shape[0])
    if mesh is not None:
        place_on_mesh(mlp, mesh)
        r = case["x"].shape[0] // mesh.n_data
        rows = (mesh.data_index * r, (mesh.data_index + 1) * r)
    params_from_jax(mlp, case["variables"])
    x = torch.from_numpy(case["x"][rows[0]:rows[1]]).requires_grad_()
    with dropout_generator(mlp, torch.Generator().manual_seed(case["seed"])):
        out = mlp.train()(x)
    out.backward(torch.from_numpy(case["g"][rows[0]:rows[1]]))
    return {"rows": rows, "out": out.detach().numpy(), "dx": x.grad.numpy(),
            "split": {n: m.split for n, m in mlp.named_children() if n.startswith("dense_")},
            "stats": {n: b.numpy().copy() for n, b in mlp.named_buffers()}}


def _lazy_runs(cases, mesh=None):
    """Each lazy-sparse case from the JAX package's initial variables: its
    run, whole tables and table optimizer state."""
    from tpurec_torch.bridge import params_from_jax

    out = {}
    for key, case in cases.items():
        t = _trainer(case["cfg"], case["info"], mesh)
        state = t.init_state()
        params_from_jax(state.model, case["variables"])
        state, losses, regs, results = _run(t, state, case["batches"])
        out[key] = {"losses": losses, "regs": regs, "results": results,
                    "params": _whole_params(state.model), "moments": _whole_moments(state),
                    "rows": {n: tuple(tb.embedding.shape) for n, tb in _tables(state.model).items()},
                    "state_rows": {n: {f: tuple(v.shape) for f, v in st._asdict().items()}
                                   for n, st in state.table_opt.items()}}
    return out


def _mesh14(inputs):
    from tpurec_torch.bridge import params_from_jax
    from tpurec_torch.core.mesh import make_mesh

    mesh = make_mesh(MeshConfig(data=1, model=4))
    out = {"exact": {}, "jax": {}, "init": {}}
    for key, case in inputs["exact"].items():
        t = _trainer(case["cfg"], case["info"], mesh)
        state = t.load_from_export(t.init_state(), case["export"])
        state, losses, regs, results = _run(t, state, case["batches"])
        out["exact"][key] = {"losses": losses, "regs": regs, "results": results,
                             "params": _whole_params(state.model)}
    for key, case in inputs["jax"].items():
        t = _trainer(case["cfg"], case["info"], mesh)
        state = t.init_state()
        params_from_jax(state.model, case["variables"])
        state, losses, regs, results = _run(t, state, case["batches"])
        out["jax"][key] = {"losses": losses, "regs": regs, "results": results,
                           "params": _whole_params(state.model)}
    for key, case in inputs["init"].items():
        model = _trainer(case["cfg"], case["info"], mesh).init_state().model
        out["init"][key] = {"shards": _shard_shapes(model), "params": _whole_params(model)}
    out["lazy"] = _lazy_runs(inputs["lazy"], mesh)
    return out


def _world1(inputs):
    t = _trainer(inputs["cfg"], inputs["info"])
    assert t.mesh_ctx.n_devices == 1 and t.mesh_ctx.data_group is None
    state = t.load_from_export(t.init_state(), inputs["export"])
    state, losses, regs, results = _run(t, state, inputs["batches"])
    return {"losses": losses, "regs": regs, "results": results,
            "params": _whole_params(state.model)}


CASES = {"mesh22": _mesh22, "mesh14": _mesh14, "world1": _world1}


# --------------------------------------------------------------------------
# the pytest side
def _din_data(batch, seed):
    from __graft_entry__ import _tiny_dataset

    return _tiny_dataset(batch=batch, seq_len=16, seed=seed)


def _tab_data(batch, seed):
    from tpurec.data.schema import DataInfo as JDataInfo

    names = [f"f{i}" for i in range(8)]
    rng = np.random.default_rng(seed)
    data = {n: rng.integers(50 * i, 50 * i + 50, size=(batch,)) for i, n in enumerate(names)}
    data["label"] = rng.integers(0, 2, size=(batch,)).astype(np.float32)
    data["ctr"] = data["label"]
    data["cvr"] = (data["label"] * rng.integers(0, 2, size=(batch,))).astype(np.float32)
    kw = dict(user_features=names[:4], item_features=names[4:],
              label_names=["ctr", "cvr"])
    return JDataInfo.from_dims(names, [50] * 8, **kw), data


def _port_info(jinfo):
    from tpurec_torch.data.schema import DataInfo

    return DataInfo(**{k: getattr(jinfo, k) for k in DataInfo.__dataclass_fields__})


def _jcfg(name, mesh, fused=False, used_id_l2=0.01, loss="bce", params=None,
          embedding_optimizer="fused_adam", **opt):
    from tpurec.config import (
        EmbeddingConfig,
        ExperimentConfig as JExperimentConfig,
        MeshConfig as JMeshConfig,
        ModelConfig,
        OptimizerConfig,
        TrainConfig,
    )

    return JExperimentConfig(
        model=ModelConfig(name=name, params=dict(params or {}),
                          embedding=EmbeddingConfig(dim=8, used_id_l2=used_id_l2)),
        train=TrainConfig(
            compute_dtype="float32", log_every_steps=0, seed=7, loss=loss,
            sparse_embedding=fused,
            optimizer=OptimizerConfig(learning_rate=0.01,
                                      embedding_optimizer=embedding_optimizer, **opt),
        ),
        mesh=JMeshConfig(data=mesh[0], model=mesh[1]),
    )


def _jax_run(jcfg, jinfo, batches):
    """The JAX package's trainer on len(mesh) of the CPU devices: (its
    initial variables, losses, used-id L2 terms, metric results, final
    params and tables by torch name, final table moments)."""
    import jax

    from tpurec.core.mesh import make_mesh as jmake_mesh
    from tpurec.train import Trainer as JTrainer

    n = jcfg.mesh.data * jcfg.mesh.model
    jt = JTrainer(jcfg, jinfo, mesh_ctx=jmake_mesh(jcfg.mesh, devices=jax.devices()[:n]))
    js = jt.init_state(batches[0])
    variables = {"params": js.params, **js.model_state}
    if js.tables is not None:
        variables["tables"] = js.tables
    variables = jax.tree.map(np.asarray, variables)
    metric_state = jt.metrics.init()
    losses, regs = [], []
    for b in batches:
        js, metric_state, logs = jt.train_step(js, jt.device_batch(b), metric_state)
        losses.append(float(logs["loss"]))
        regs.append(float(logs["used_id_l2"]) if "used_id_l2" in logs else None)
    results = {k: float(v) for k, v in jt.metrics.result(metric_state).items()}
    return variables, losses, regs, results, js


def _by_name(js, model):
    import jax

    from tpurec_torch.bridge import _flatten, _torch_leaf

    out = {}
    trees = [js.params] + ([js.tables] if js.tables is not None else [])
    for tree in trees:
        for path, value in _flatten(jax.tree.map(np.asarray, tree)):
            name, arr = _torch_leaf("params", path, value, model)
            out[".".join(path[:-1] + (name,))] = arr
    return out


def _one_device(cfg_json, info, variables, batches, **train):
    from tpurec_torch.bridge import params_from_jax

    t = _trainer(cfg_json, info, **train)
    state = t.init_state()
    params_from_jax(state.model, variables)
    return t, state


def _common_rows(variables, model):
    """``variables`` with every table cut to ``model``'s rows (the rows both
    row counts have)."""
    import jax

    rows = {n: t.embedding.shape[0] for n, t in _tables(model).items()}
    out = {}
    for coll, tree in variables.items():
        flat = {}
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            keys = [str(getattr(k, "key", k)) for k in path]
            name = ".".join(keys)
            flat[tuple(keys)] = v[: rows[name]] if name in rows else v
        nested = {}
        for keys, v in flat.items():
            node = nested
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = v
        out[coll] = nested
    return out


def _jax_moments(js):
    from tpurec_torch.bridge import _flatten

    return {".".join(p): {f: np.asarray(getattr(st, f)).astype(np.float32) for f in st._fields}
            for p, st in _flatten(js.table_opt)}


def _jax_evaluate(jcfg, jinfo, runs):
    """The JAX package's ``evaluate`` of each list of batches in ``runs`` on
    its initial state: (variables, {key: results})."""
    import jax

    from tpurec.core.mesh import make_mesh as jmake_mesh
    from tpurec.train import Trainer as JTrainer

    n = jcfg.mesh.data * jcfg.mesh.model
    jt = JTrainer(jcfg, jinfo, mesh_ctx=jmake_mesh(jcfg.mesh, devices=jax.devices()[:n]))
    js = jt.init_state(next(iter(runs.values()))[0])
    variables = jax.tree.map(np.asarray, {"params": js.params, **js.model_state})
    return variables, {k: jt.evaluate(js, batches) for k, batches in runs.items()}


def _lazy_cases(mesh):
    """The lazy-sparse engines' cases on ``mesh`` (FM in each engine; on (2,
    2) DIN in ``rowwise_adam`` too), used-id L2 0.01: (inputs, the JAX
    package's runs)."""
    inputs, want = {}, {}
    names = [("fm", e) for e in LAZY_ENGINES] + ([("din", "rowwise_adam")] if mesh == (2, 2) else [])
    for name, engine in names:
        make = _din_data if name == "din" else _tab_data
        jinfo = make(16, 0)[0]
        batches = [make(16 if name == "din" else 64, 40 + i)[1] for i in range(SPARSE_STEPS)]
        jcfg = _jcfg(name, mesh, fused=True, embedding_optimizer=engine)
        variables, losses, regs, results, js = _jax_run(jcfg, jinfo, batches)
        info = _port_info(jinfo)
        key = f"{name}-{engine}"
        inputs[key] = {"cfg": jcfg.to_json(), "info": info, "variables": variables,
                       "batches": batches}
        model = _trainer(jcfg.replace(mesh=jcfg.mesh.replace(data=1, model=1)).to_json(),
                         info).init_state().model  # names only
        want[key] = {"losses": losses, "regs": regs, "results": results,
                     "params": _by_name(js, model), "moments": _jax_moments(js),
                     "rows": {n: np.asarray(t).shape for n, t in _by_name(js, model).items()
                              if n.endswith("embedding")}}
    return inputs, want


def _assert_lazy(got, want):
    """A lazy-sparse run against the JAX package's: losses, used-id L2,
    metrics, whole tables and dense weights, and the table optimizer state
    (the row-wise (V,) moments included); each rank holds 1/n_model of the
    rows of every table and its state."""
    _assert_run(got, want)
    for k, v in want["results"].items():
        assert got["results"][k] == pytest.approx(v, abs=1e-6 if "auc" in k else 2e-5), k
    _assert_params(got["params"], want["params"], PARAM_TOL, common=False)
    for table, moments in want["moments"].items():
        for f, w in moments.items():
            np.testing.assert_allclose(got["moments"][table][f], w, **MOMENT_TOL,
                                       err_msg=f"{table}.{f}")
    return got


@pytest.fixture(scope="module")
def mesh22(tmp_path_factory):
    def compute(directory):
        from tpurec_torch.bridge import params_from_jax

        inputs, want = {}, {}
        for name, fused in (("din", False), ("fm", True)):
            make = _din_data if name == "din" else _tab_data
            jinfo = make(16, 0)[0]
            batches = [make(16 if name == "din" else 64, 10 + i)[1] for i in range(STEPS)]
            jcfg = _jcfg(name, (2, 2), fused=fused,
                         **({"grad_clip_norm": 0.05} if name == "din" else {}))
            variables, losses, regs, results, js = _jax_run(jcfg, jinfo, batches)
            info = _port_info(jinfo)
            one = jcfg.replace(mesh=jcfg.mesh.replace(data=1, model=1)).to_json()
            model = _trainer(one, info).init_state().model  # names only
            inputs[name] = {
                "cfg": jcfg.to_json(), "info": info, "variables": variables, "batches": batches,
                "ckpt": os.path.join(directory, f"ckpt_{name}"),
                "export": os.path.join(directory, f"export_{name}"),
            }
            want[name] = {"losses": losses, "regs": regs, "results": results,
                          "params": _by_name(js, model)}
            if fused:
                want[name]["moments"] = _jax_moments(js)
                # the port's one-device fused step from the same rows
                t = _trainer(one, info)
                state = t.init_state()
                params_from_jax(state.model, _common_rows(variables, state.model))
                state, losses, regs, results = _run(t, state, batches)
                want[name]["one_device"] = {"losses": losses, "regs": regs, "results": results,
                                            "params": _whole_params(state.model)}

        # a one-device DIN checkpoint after two steps, and the step after it
        din = inputs["din"]
        ckpt = os.path.join(directory, "ckpt_one")
        t = _trainer(_jcfg("din", (1, 1)).to_json(), din["info"], checkpoint_dir=ckpt)
        state = t.init_state()
        params_from_jax(state.model, _common_rows(din["variables"], state.model))
        state, _, _, _ = _run(t, state, din["batches"][:2])
        t.save(state)
        state, losses, _, _ = _run(t, state, din["batches"][2:3])
        inputs["restore"] = {"cfg": _jcfg("din", (2, 2)).to_json(), "info": din["info"],
                             "ckpt": ckpt, "batch": din["batches"][2]}
        want["restore"] = {"losses": losses, "params": _whole_params(state.model)}

        # evaluate over 4 rows (they divide over 'data') then 3 (they do not),
        # unweighted and with uneven row weights, on (2, 2), one device, JAX
        jinfo = _din_data(16, 0)[0]
        rows = [_din_data(4, 60)[1], _din_data(3, 61)[1]]
        weights = [np.array([1.0, 0.0, 2.0, 1.0], np.float32), np.array([0.5, 1.0, 0.0], np.float32)]
        eval_batches = {"unweighted": rows,
                        "weighted": [dict(b, __weight__=w) for b, w in zip(rows, weights)]}
        jcfg = _jcfg("din", (2, 2))
        variables, want["evaluate"] = _jax_evaluate(jcfg, jinfo, eval_batches)
        t = _trainer(_jcfg("din", (1, 1)).to_json(), din["info"])
        state = t.init_state()
        params_from_jax(state.model, _common_rows(variables, state.model))
        want["evaluate_one_device"] = {k: t.evaluate(state, b) for k, b in eval_batches.items()}
        inputs["evaluate"] = {"cfg": jcfg.to_json(), "info": din["info"], "variables": variables,
                              "batches": eval_batches}
        inputs["lazy"], want["lazy"] = _lazy_cases((2, 2))
        inputs["models"], want["models"] = _model_cases((2, 2))
        inputs["blocks"] = _block_cases()
        want["blocks"] = {key: _block_run(case) for key, case in inputs["blocks"].items()}
        results = run_world(os.path.abspath(__file__), "mesh22", 4, directory, inputs)
        return inputs, want, results

    return shared_world(tmp_path_factory, "torch_mesh22", compute)


def _assert_params(got, want, tol, common=True):
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if common and g.ndim:  # tables: the rows both have
            n = min(g.shape[0], w.shape[0])
            g, w = g[:n], w[:n]
        np.testing.assert_allclose(g, w, **tol, err_msg=name)


def _assert_run(got, want, tol=LOSS_TOL):
    np.testing.assert_allclose(got["losses"], want["losses"], **tol)
    assert [r is None for r in got["regs"]] == [r is None for r in want["regs"]]
    if want["regs"][0] is not None:
        np.testing.assert_allclose(got["regs"], want["regs"], **tol)


@pytest.mark.parametrize("name", ["din", "fm"])
def test_mesh_2x2_matches_jax(mesh22, name):
    """DIN dense (global-norm clip at 0.05, used-id L2 0.01) and FM fused
    (used-id L2 0.01) on (2, 2), four fp32 steps, against the JAX package's
    (2, 2) runs: each rank's loss and used-id L2 (the global batch's), the
    AUC and mean loss summed over 'data', the whole tables and dense
    parameters after the steps, and FM's table moments."""
    _, want, results = mesh22
    for rank, res in enumerate(results):
        got = res[name]
        _assert_run(got, want[name])
        for k, v in want[name]["results"].items():
            assert got["results"][k] == pytest.approx(v, abs=1e-6 if k == "auc" else 2e-5), k
        _assert_params(got["params"], want[name]["params"], PARAM_TOL)
        for table, moments in want[name].get("moments", {}).items():
            for f, w in moments.items():
                n = w.shape[0]
                np.testing.assert_allclose(got["moments"][table][f][:n], w, rtol=5e-3,
                                           atol=1e-8, err_msg=f"{table}.{f} rank {rank}")


def test_fm_fused_2x2_matches_one_device(mesh22):
    """FM fused on (2, 2) against the port's one-device fused step from the
    same rows: the same global batch's loss, used-id L2 and tables."""
    _, want, results = mesh22
    one = want["fm"]["one_device"]
    for res in results:
        _assert_run(res["fm"], one)
        _assert_params(res["fm"]["params"], one["params"], PARAM_TOL)


def test_checkpoint_from_2x2_restores_on_one_device(mesh22):
    """Rank 0 of (2, 2) wrote whole tables; one device restores them (its
    rows of them), the dense weights and the step exactly."""
    inputs, _, results = mesh22
    for name in ("din", "fm"):
        case = inputs[name]
        one = _variant(case["cfg"]).replace(mesh=MeshConfig(data=1, model=1))
        t = _trainer(one, case["info"], checkpoint_dir=case["ckpt"])
        state = t.restore(t.init_state())
        assert state.step == STEPS
        _assert_params(_whole_params(state.model), results[0][name]["params"],
                       dict(rtol=0, atol=0))


def test_checkpoint_from_one_device_restores_on_2x2(mesh22):
    """A one-device checkpoint after two steps, restored on (2, 2): the
    next step's loss and parameters equal the one-device trainer's next
    step (moments and step count restored too)."""
    _, want, results = mesh22
    for res in results:
        assert res["restore"]["step"] == 3
        _assert_run(res["restore"] | {"regs": [None]}, want["restore"] | {"regs": [None]})
        _assert_params(res["restore"]["params"], want["restore"]["params"], PARAM_TOL)


def test_export_from_2x2_loads_as_servable(mesh22):
    """The (2, 2) export is the one-device format: ``load_servable`` reads
    it (tables of ``pad_vocab(V)`` rows), and it scores as the mesh's
    ``infer`` did."""
    from tpurec_torch.embedding.ops import pad_vocab
    from tpurec_torch.serving.export import load_servable

    inputs, _, results = mesh22
    for name in ("din", "fm"):
        case = inputs[name]
        servable = load_servable(case["export"], case["info"], device="cpu")
        for t in embedding_tables(servable.model):
            assert t.embedding.shape[0] == pad_vocab(t.vocab_size)
        _assert_params(_whole_params(servable.model), results[0][name]["params"],
                       dict(rtol=0, atol=0))
        servable.model.eval()
        with torch.no_grad():
            out = servable.model({k: torch.as_tensor(v) for k, v in
                                  case["batches"][0].items()})["output"].numpy()
        for res in results:
            np.testing.assert_allclose(res[name]["infer"], out, rtol=1e-6, atol=1e-7)


def test_mesh_refusals(mesh22):
    """On a mesh the port refuses only what the JAX package refuses: on
    (2, 2) deepfm and DIN under the in-batch softmax build (every model and
    loss trains on data > 1), and ``host_adam`` raises the JAX package's
    ``ValueError``, in its words."""
    _, _, results = mesh22
    for res in results:
        r = res["refusals"]
        assert set(r) == {"model", "loss", "host_adam"}
        for key in ("model", "loss"):
            assert r[key] is None, (key, r[key])
        assert r["host_adam"] == (
            "ValueError",
            "embedding_optimizer='host_adam' requires a single device (per-shard host "
            "callbacks are not wired yet)",
        )


@pytest.mark.parametrize("weights", ["unweighted", "weighted"])
def test_evaluate_counts_a_replicated_batch_once(mesh22, weights):
    """``evaluate`` on (2, 2) over 4 rows (each data rank takes 2) then 3
    (they do not divide over 'data', so every rank holds all three): the
    AUC and the loss equal one device's and the JAX package's (2, 2) run,
    unweighted and with uneven ``__weight__`` rows. A replicated batch's
    rows count once, and each batch keeps its weight in the loss ``Mean``
    (unweighted: one per batch)."""
    _, want, results = mesh22
    for res in results:
        got = res["evaluate"][weights]
        for ref in (want["evaluate_one_device"][weights], want["evaluate"][weights]):
            assert set(got) == set(ref)
            for k, v in ref.items():
                assert got[k] == pytest.approx(v, abs=1e-6), (k, got, ref)


@pytest.mark.parametrize("key", [f"fm-{e}" for e in LAZY_ENGINES] + ["din-rowwise_adam"])
def test_lazy_sparse_engines_2x2_match_jax(mesh22, key):
    """The lazy-sparse engines on (2, 2), three fp32 steps (used-id L2
    0.01) from the JAX package's weights, against its (2, 2) runs: losses,
    used-id L2, metrics, tables, dense weights and the table optimizer
    state; tables and state hold half their rows on each rank."""
    _, want, results = mesh22
    for res in results:
        got = _assert_lazy(res["lazy"][key], want["lazy"][key])
        _assert_sharded_rows(got, want["lazy"][key], 2)


def registry_names():
    """Every registry model but din and fm, which the cases of this file
    hold on their own."""
    from tpurec_torch.models import builders  # noqa: F401  (registers the builders)
    from tpurec_torch.models.registry import MODEL_REGISTRY

    return sorted(set(MODEL_REGISTRY) - {"din", "fm"})


def _model_cases(mesh):
    """One fp32 step of every model of ``registry_names`` over 16 rows on
    ``mesh`` (``tests/test_torch_mesh_data.py``'s cases, from the seed's
    weights): (inputs, the one-device runs)."""
    from test_torch_mesh_data import GLOBAL_ROWS, MODELS, _case_run, _cfg, _data

    inputs = {}
    for seed, (name, (schema, params, loss)) in enumerate(MODELS.items()):
        inputs[name] = {"cfg": _cfg(name, params, loss, mesh=mesh),
                        "info": _data(schema, GLOBAL_ROWS, 0)[0],
                        "batches": [_data(schema, GLOBAL_ROWS, 300 + seed)[1]]}
    return inputs, {name: _case_run(case) for name, case in inputs.items()}


@pytest.mark.parametrize("name", registry_names())
def test_every_model_steps_on_2x2(mesh22, name):
    """Every other registry model on (2, 2), its tensor-parallel weights
    split over 'model' and its batch over 'data', one fp32 step over 16
    rows from the seed's weights under its family's loss: the logged loss
    and terms, the metrics and every parameter against one device."""
    from test_torch_mesh_data import MODELS, _assert_one_device

    _, want, results = mesh22
    assert name in MODELS, f"{name}: no case on a mesh"
    for res in results:
        _assert_one_device(res["models"][name], want["models"][name])


BLOCK_CASES = {
    # the norm and the softmax read the whole width: gathered first
    "ln_gelu_softmax": dict(hidden_dims=(12, 8, 6), activation="gelu", out_activation="softmax",
                            use_ln=True, dropout_rate=0.3),
    # dropout on dense_0's column share: its columns of the one-device mask
    "relu": dict(hidden_dims=(12, 8, 6), out_activation="linear", dropout_rate=0.3),
    # BatchNorm's moments over the global batch ('data')
    "bn_tanh": dict(hidden_dims=(12, 8, 6), activation="tanh", use_bn=True, dropout_rate=0.3),
}
BLOCK_TOL = dict(rtol=1e-5, atol=1e-6)


def _block_cases():
    """Each case's flax variables (redrawn N(0, 0.5²), the variances |·|), a
    global batch of 16 rows, a cotangent and a dropout seed."""
    import jax
    from flax import linen as fnn

    from tpurec.ops.mlp import MLP as JMLP

    cases = {}
    for seed, (key, kw) in enumerate(BLOCK_CASES.items()):
        rng = np.random.default_rng(500 + seed)
        x = rng.normal(size=(16, 10)).astype(np.float32)
        variables = fnn.unbox(JMLP(**kw).init(jax.random.key(seed), x, train=False))
        variables = jax.tree.map(lambda a: (0.5 * rng.normal(size=a.shape)).astype(np.float32), variables)
        if "batch_stats" in variables:
            variables["batch_stats"] = jax.tree.map(np.abs, variables["batch_stats"])
        cases[key] = {"kw": kw, "variables": variables, "x": x, "seed": 40 + seed,
                      "g": rng.normal(size=(16, kw["hidden_dims"][-1])).astype(np.float32)}
    return cases


@pytest.mark.parametrize("key", list(BLOCK_CASES))
def test_tensor_parallel_mlp_blocks_2x2_match_one_device(mesh22, key):
    """A tensor-parallel MLP with the building blocks' options (LayerNorm,
    gelu, a softmax output; BatchNorm; dropout, drawn from a seeded
    generator) on (2, 2), one training forward and backward over each data
    rank's half of 16 rows: the output, the input gradient and the running
    statistics against one device's, at ``BLOCK_TOL`` (the row layer sums
    its partial products over 'model' in another order). ``dense_0`` is
    split by columns and ``dense_1`` by rows on every rank."""
    _, want, results = mesh22
    w = want["blocks"][key]
    for res in results:
        got = res["blocks"][key]
        assert got["split"] == {"dense_0": "column", "dense_1": "row", "dense_2": "column"}
        lo, hi = got["rows"]
        assert hi - lo == 8
        np.testing.assert_allclose(got["out"], w["out"][lo:hi], **BLOCK_TOL, err_msg="out")
        np.testing.assert_allclose(got["dx"], w["dx"][lo:hi], **BLOCK_TOL, err_msg="dx")
        assert set(got["stats"]) == set(w["stats"])
        for name, stat in w["stats"].items():
            np.testing.assert_allclose(got["stats"][name], stat, **BLOCK_TOL, err_msg=name)


def _assert_sharded_rows(got, want, n_model):
    for table, shape in want["rows"].items():
        assert got["rows"][table][0] * n_model == shape[0], (table, got["rows"][table], shape)
        for field, st in got["state_rows"][table].items():
            assert st[0] == got["rows"][table][0], (table, field, st)


def test_dryrun_multichip_in_2x2_world(mesh22):
    """``dryrun_multichip(4)`` in the (2, 2) world: one DIN step in each
    engine (its own asserts of the sharded rows and the tensor-parallel
    MLP), a finite loss each, the same on every rank."""
    _, _, results = mesh22
    losses = [res["dryrun"] for res in results]
    assert set(losses[0]) == {"dense", "rowwise_adam", "fused_adam"}
    for got in losses:
        assert all(np.isfinite(v) for v in got.values())
        assert got == losses[0]


def test_din_mlp_is_tensor_parallel_on_2x2(mesh22):
    """DIN's ``mlp`` on (2, 2): ``dense_0`` holds half its output columns
    (its (out, in) weight's rows) and of its bias, ``dense_1`` half its
    input rows; nothing else is split."""
    _, _, results = mesh22
    for res in results:
        assert res["din_shards"] == {"mlp.dense_0.weight": (100, 56), "mlp.dense_0.bias": (100,),
                                     "mlp.dense_1.weight": (80, 100)}


def test_mesh_without_a_world_refuses():
    """Without a world a mesh of more devices raises the JAX package's
    ``make_mesh`` errors."""
    jinfo = _din_data(16, 0)[0]
    for mesh, words in (((2, 1), "mesh 2x1 != 1 devices"), ((1, 2), "1 devices not divisible")):
        with pytest.raises(ValueError, match=words):
            _trainer(_jcfg("din", mesh).to_json(), _port_info(jinfo))


# --------------------------------------------------------------------------
# the model-only mesh and the world of one
def _exact_case(name, fused, directory):
    """The one-device port run of ``name`` (its initial weights exported to
    ``directory``) and the inputs of its mesh run."""
    make = _din_data if name == "din" else _tab_data
    loss = "multi_task" if name == "mmoe" else "bce"
    jinfo = make(16, 0)[0]
    info = _port_info(jinfo)
    batches = [make(16 if name == "din" else 64, 20 + i)[1] for i in range(2)]
    cfg = _jcfg(name, (1, 4), fused=fused, used_id_l2=0.0, loss=loss).to_json()
    t = _trainer(_variant(cfg).replace(mesh=MeshConfig(data=1, model=1)), info)
    state = t.init_state()
    t.export(state, directory)
    state, losses, regs, results = _run(t, state, batches)
    want = {"losses": losses, "regs": regs, "results": results,
            "params": _whole_params(state.model)}
    return {"cfg": cfg, "info": info, "export": directory, "batches": batches}, want


# the (1, 4) cases against the JAX package: (model, params, loss); mmoe with
# three expert layers, so its last layer's share is gathered; autoint's two
# heads of 8 are split within a head over four ranks
JAX14_CASES = {"din": ({}, "bce"), "mmoe": ({"expert_dims": (64, 32, 16)}, "multi_task"),
               "autoint": ({}, "bce")}
# the tensor-parallel initialisation: (model, params) and each rank's shares
INIT_CASES = {
    "din": ("din", {}, {"mlp.dense_0.weight": (50, 56), "mlp.dense_0.bias": (50,),
                        "mlp.dense_1.weight": (80, 50)}),
    # a width of 1 stays whole: dense_2's weight and bias are not split
    "din-narrow": ("din", {"hidden_dims": (200, 80, 1)},
                   {"mlp.dense_0.weight": (50, 56), "mlp.dense_0.bias": (50,),
                    "mlp.dense_1.weight": (80, 50)}),
    "mmoe": ("mmoe", {}, {"experts.w_0": (4, 64, 16), "experts.b_0": (4, 16),
                          "experts.w_1": (4, 16, 32)}),
    "autoint": ("autoint", {}, {f"mha_{i}.{p}.weight": s for i in range(2)
                                for p, s in (("q", (4, 8)), ("k", (4, 8)), ("v", (4, 8)),
                                             ("out", (8, 4)))}),
}


@pytest.fixture(scope="module")
def mesh14(tmp_path_factory):
    def compute(directory):
        inputs = {"exact": {}, "jax": {}, "init": {}}
        want = {"exact": {}, "jax": {}, "init": {}}
        for name in EXACT_MODELS:
            for fused in (False, True):
                key = f"{name}-{'fused' if fused else 'dense'}"
                inputs["exact"][key], want["exact"][key] = _exact_case(
                    name, fused, os.path.join(directory, key))
        for name, (params, loss) in JAX14_CASES.items():
            make = _din_data if name == "din" else _tab_data
            jinfo = make(16, 0)[0]
            batches = [make(16 if name == "din" else 64, 50 + i)[1] for i in range(2)]
            jcfg = _jcfg(name, (1, 4), loss=loss, params=params)
            variables, losses, regs, results, js = _jax_run(jcfg, jinfo, batches)
            info = _port_info(jinfo)
            one = jcfg.replace(mesh=jcfg.mesh.replace(data=1, model=1)).to_json()
            inputs["jax"][name] = {"cfg": jcfg.to_json(), "info": info, "variables": variables,
                                   "batches": batches}
            want["jax"][name] = {"losses": losses, "regs": regs, "results": results,
                                 "params": _by_name(js, _trainer(one, info).init_state().model)}
        for key, (name, params, _) in INIT_CASES.items():
            make = _din_data if name == "din" else _tab_data
            info = _port_info(make(16, 0)[0])
            loss = "multi_task" if name == "mmoe" else "bce"
            cfg = _jcfg(name, (1, 4), loss=loss, params=params).to_json()
            inputs["init"][key] = {"cfg": cfg, "info": info}
            one = _variant(cfg).replace(mesh=MeshConfig(data=1, model=1))
            want["init"][key] = _whole_params(_trainer(one, info).init_state().model)
        inputs["lazy"], want["lazy"] = _lazy_cases((1, 4))
        return want, run_world(os.path.abspath(__file__), "mesh14", 4, directory, inputs)

    return shared_world(tmp_path_factory, "torch_mesh14", compute)


@pytest.mark.parametrize("engine", ["dense", "fused"])
@pytest.mark.parametrize("name", EXACT_MODELS)
def test_model_only_mesh_equals_one_device(mesh14, name, engine):
    """(1, 4): every rank takes the whole batch, its quarter of each table,
    and sums the rows over 'model' (one row and three zeros): two steps
    equal the one-device steps bit for bit (used_id_l2 = 0: the mesh's
    table-space term sums in another order, held by the (2, 2) tests).

    Not bit for bit: ffm's dense (V, F, D) table. Its lookup's backward
    (``index_put_`` with accumulate) sums a row's repeats in another order
    on the CPU once the three quarters of ids a rank does not own are added
    (as zeros to its row 0); its tables are held to 1e-6 after the two Adam
    steps (a gradient near zero turns a rounding difference into a visible
    share of the step), its losses and metrics exactly.

    Nor din and mmoe, whose top MLP and expert bank are tensor parallel:
    a row layer sums its four ranks' partial products over 'model', in
    another order than one device's product, so their losses and metrics
    are held at ``LOSS_TOL`` (AUC 1e-6) and their parameters at
    ``PARAM_TOL`` (the JAX package's (1, 4) runs hold them too:
    ``test_tensor_parallel_1x4_matches_jax``)."""
    want, results = mesh14
    key = f"{name}-{engine}"
    want = want["exact"][key]
    for res in results:
        got = res["exact"][key]
        if name in TP_MODELS:
            _assert_run(got, want)
            for k, v in want["results"].items():
                assert got["results"][k] == pytest.approx(v, abs=1e-6 if "auc" in k else 2e-5), k
            _assert_params(got["params"], want["params"], PARAM_TOL)
            continue
        tol = dict(rtol=0, atol=1e-6 if key == "ffm-dense" else 0)
        assert got["losses"] == want["losses"]
        assert got["results"] == want["results"]
        _assert_params(got["params"], want["params"], tol)


@pytest.mark.parametrize("name", JAX14_MODELS)
def test_tensor_parallel_1x4_matches_jax(mesh14, name):
    """din (its ``mlp``), mmoe (three expert layers) and autoint (two
    ``MultiHeadAttention`` layers, 2 heads of 8: a share cuts a head) on
    (1, 4) with their weights tensor parallel, two fp32 steps (used-id L2
    0.01) from the JAX package's weights, against its (1, 4) runs, which
    partition the same weights: losses, used-id L2, metrics and every
    parameter after the steps."""
    want, results = mesh14
    for res in results:
        got = res["jax"][name]
        _assert_run(got, want["jax"][name])
        for k, v in want["jax"][name]["results"].items():
            assert got["results"][k] == pytest.approx(v, abs=1e-6 if "auc" in k else 2e-5), k
        _assert_params(got["params"], want["jax"][name]["params"], PARAM_TOL)


@pytest.mark.parametrize("key", list(INIT_CASES))
def test_tensor_parallel_init_equals_one_device(mesh14, key):
    """On (1, 4) each rank holds a quarter of every split weight (DIN's
    ``dense_0`` columns and ``dense_1`` rows, mmoe's ``w_0``/``b_0`` and
    ``w_1``, autoint's q, k, v and out; a width of 1 whole), and the
    shares gather to the one-device initialisation from the same seed bit
    for bit."""
    want, results = mesh14
    for res in results:
        got = res["init"][key]
        assert got["shards"] == INIT_CASES[key][2]
        _assert_params(got["params"], want["init"][key], dict(rtol=0, atol=0))


@pytest.mark.parametrize("engine", LAZY_ENGINES)
def test_lazy_sparse_engines_1x4_match_jax(mesh14, engine):
    """FM in each lazy-sparse engine on (1, 4) against the JAX package's
    (1, 4) run (as on (2, 2)); tables and state hold a quarter of their
    rows on each rank."""
    want, results = mesh14
    key = f"fm-{engine}"
    for res in results:
        _assert_sharded_rows(_assert_lazy(res["lazy"][key], want["lazy"][key]),
                             want["lazy"][key], 4)


def test_world_of_one_equals_no_world(tmp_path):
    """A gloo world of one rank is the (1, 1) mesh: DIN dense with the
    used-id L2 steps exactly as the trainer without a world."""
    case, want = _exact_case("din", False, str(tmp_path / "export"))
    case["cfg"] = _variant(case["cfg"]).replace(mesh=MeshConfig()).to_json()
    (got,) = run_world(os.path.abspath(__file__), "world1", 1, str(tmp_path / "world"), case)
    assert got["losses"] == want["losses"] and got["results"] == want["results"]
    _assert_params(got["params"], want["params"], dict(rtol=0, atol=0), common=False)


if __name__ == "__main__":
    rank_main(CASES)
