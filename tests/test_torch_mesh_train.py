"""The port's ``Trainer`` on a mesh, on the CPU: ranks are spawned processes
over gloo (``tests/test_torch_mesh.py``'s ``run_world``), the JAX package's
trainer runs on four of its virtual CPU devices in the pytest process.

Three worlds, each run once for the whole file:

- (2, 2), four ranks: DIN in the dense engine and FM in the fused engine
  against the JAX package's (2, 2) runs, four fp32 steps from the same
  weights on the same global batches; FM fused also against the port's
  one-device fused step; checkpoints moved between (2, 2) and one device
  both ways; the export; the refusals.
- (1, 4), four ranks: din, fm, ffm and mmoe in the dense and the fused
  engine, equal to the one-device step.
- a world of one: equal to the trainer without a world.

Tolerances (no looser than the JAX package's own ``test_tp_matches_dp``):
losses rtol 2e-4, atol 2e-5; parameters rtol 5e-3, atol 5e-5, on the rows
both tables have (``pad_vocab`` rounds rows to n_model·128); the used-id
L2 term like the losses; AUC 1e-6 (a sum of histogram counts). The
model-only mesh and the world of one are exact: the sum over 'model' adds
zeros, and every other operation is the one-device step's.
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
STEPS = 4
EXACT_MODELS = ("din", "fm", "ffm", "mmoe")


# --------------------------------------------------------------------------
# shared by both sides
def _tables(model):
    from tpurec_torch.train.trainer import _table_names

    return dict(zip(_table_names(model), embedding_tables(model)))


def _whole_params(model):
    """{name: numpy} of every parameter, tables whole (a collective on a
    mesh)."""
    tables = _tables(model)
    return {
        n: (tables[n].whole(p) if n in tables else p).detach().cpu().numpy()
        for n, p in model.named_parameters()
    }


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
        params_from_jax(state.model, case["variables"])
        state, losses, regs, results = _run(t, state, case["batches"])
        out[name] = {"losses": losses, "regs": regs, "results": results,
                     "params": _whole_params(state.model)}
        if state.table_opt is not None:
            tables = _tables(state.model)
            out[name]["moments"] = {
                n: {f: tables[n].whole(v).numpy() for f, v in st._asdict().items()}
                for n, st in state.table_opt.items()
            }
        t.save(state)
        t.export(state, case["export"])
        out[name]["infer"] = t.infer(state, case["batches"][0])["output"]

    # a one-device checkpoint restored on (2, 2), then one step
    case = inputs["restore"]
    t = _trainer(case["cfg"], case["info"], checkpoint_dir=case["ckpt"])
    state = t.restore(t.init_state())
    state, losses, _, _ = _run(t, state, [case["batch"]])
    out["restore"] = {"step": state.step, "losses": losses, "params": _whole_params(state.model)}

    din, fm = inputs["din"], inputs["fm"]
    mesh14 = make_mesh(MeshConfig(data=1, model=4))
    out["refusals"] = {
        "model": _refusal(lambda: _trainer(fm["cfg"], fm["info"], model="deepfm",
                                           sparse_embedding=False)),
        "loss": _refusal(lambda: _trainer(din["cfg"], din["info"], loss="in_batch_softmax")),
        "rowwise_adam": _refusal(lambda: _trainer(fm["cfg"], fm["info"],
                                                  embedding_optimizer="rowwise_adam")),
        "adam_model_only": _refusal(lambda: _trainer(fm["cfg"], fm["info"], mesh14,
                                                     embedding_optimizer="adam")),
        "host_adam": _refusal(lambda: _trainer(fm["cfg"], fm["info"], mesh14,
                                               embedding_optimizer="host_adam")),
    }
    return out


def _mesh14(inputs):
    from tpurec_torch.core.mesh import make_mesh

    mesh = make_mesh(MeshConfig(data=1, model=4))
    out = {}
    for key, case in inputs.items():
        t = _trainer(case["cfg"], case["info"], mesh)
        state = t.load_from_export(t.init_state(), case["export"])
        state, losses, regs, results = _run(t, state, case["batches"])
        out[key] = {"losses": losses, "regs": regs, "results": results,
                    "params": _whole_params(state.model)}
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


def _jcfg(name, mesh, fused=False, used_id_l2=0.01, loss="bce", **opt):
    from tpurec.config import (
        EmbeddingConfig,
        ExperimentConfig as JExperimentConfig,
        MeshConfig as JMeshConfig,
        ModelConfig,
        OptimizerConfig,
        TrainConfig,
    )

    return JExperimentConfig(
        model=ModelConfig(name=name, embedding=EmbeddingConfig(dim=8, used_id_l2=used_id_l2)),
        train=TrainConfig(
            compute_dtype="float32", log_every_steps=0, seed=7, loss=loss,
            sparse_embedding=fused,
            optimizer=OptimizerConfig(learning_rate=0.01, embedding_optimizer="fused_adam",
                                      **opt),
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

    return {".".join(p): {f: np.asarray(getattr(st, f)) for f in st._fields}
            for p, st in _flatten(js.table_opt)}


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
    """On a mesh: another model or loss on data > 1 and the lazy-sparse
    engines raise ``NotImplementedError`` naming ROADMAP; ``host_adam``
    raises the JAX package's ``ValueError``, in its words."""
    _, _, results = mesh22
    for res in results:
        r = res["refusals"]
        for key in ("model", "loss", "rowwise_adam", "adam_model_only"):
            assert r[key][0] == "NotImplementedError" and "ROADMAP" in r[key][1], (key, r[key])
        assert r["host_adam"] == (
            "ValueError",
            "embedding_optimizer='host_adam' requires a single device (per-shard host "
            "callbacks are not wired yet)",
        )


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


@pytest.fixture(scope="module")
def mesh14(tmp_path_factory):
    def compute(directory):
        inputs, want = {}, {}
        for name in EXACT_MODELS:
            for fused in (False, True):
                key = f"{name}-{'fused' if fused else 'dense'}"
                inputs[key], want[key] = _exact_case(name, fused, os.path.join(directory, key))
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
    share of the step), its losses and metrics exactly."""
    want, results = mesh14
    key = f"{name}-{engine}"
    tol = dict(rtol=0, atol=1e-6 if key == "ffm-dense" else 0)
    for res in results:
        got = res[key]
        assert got["losses"] == want[key]["losses"]
        assert got["results"] == want[key]["results"]
        _assert_params(got["params"], want[key]["params"], tol)


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
