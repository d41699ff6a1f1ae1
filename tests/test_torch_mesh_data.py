"""Every model and loss on a data axis of four: the port's ``Trainer`` on the
(4, 1) mesh, on the CPU, against its one-device run and, where the batch's
rows meet each other, against the JAX package's (4, 1) run on four of its
virtual CPU devices.

One world of four gloo ranks (``tests/test_torch_mesh.py``'s ``run_world``,
no JAX in them) computes every case once; the one-device runs and the JAX
package's run in the pytest process, once a module:

- every registry model but din and fm (``tests/test_torch_mesh_train.py``
  holds those), under its family's loss: two fp32 dense steps over global
  batches of 16 rows (4 a rank), then one over 6 rows, which do not divide
  over 'data' (every rank holds them whole), from the seed's weights,
  against the one-device run of the same batches. The tabular rows of each
  data rank are drawn from their own windows, so NFM's and FiBiNET++'s
  ``BatchNorm`` moments differ by rank;
- against the JAX package's (4, 1) run, from its weights: dssm_double's
  in-batch softmax with an item id repeated on other ranks; DIEN's
  auxiliary loss rolled across ranks and with ``neg_<series>`` columns;
  DMR's with rows of fewer than two valid steps on ranks 1 and 3 only;
  ESCM2's ``model_loss``; SIM's ``gsu_esu``;
- MIND's sampled negatives against the one-device run from the same
  generator seed (the replicated batch draws the whole batch);
- ``evaluate``'s in-batch accuracy over a batch that divides over 'data'
  and one that does not;
- the engines: dssm_double in ``rowwise_adam`` under the in-batch softmax,
  DIEN, FFM and CAN in the fused engine, against one device;
- the gradient of ``gather_batch``: dssm_double's item tower after one
  step equals one device's (a gather whose backward kept only its own
  block would drop the cotangent of the other ranks' losses).

Four data ranks, not two: on two, a roll that borrows from rank r + 1
instead of r − 1 gives the same rows.

Tolerances: ``tests/test_torch_mesh_train.py``'s, no looser than the JAX
package's own mesh tests: losses and logged terms rtol 2e-4, atol 2e-5;
parameters rtol 5e-3, atol 5e-5; AUC and accuracy 1e-6 (sums of counts);
the first step's gradients rtol 1e-4, atol 1e-7 (sums of the same fp32
products over four ranks in another order).
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from test_torch_mesh import rank_main, run_world, shared_world  # noqa: E402
from test_torch_mesh_train import (  # noqa: E402
    LOSS_TOL, PARAM_TOL, _assert_params, _whole_params, registry_names,
)
from tpurec_torch.config import ExperimentConfig, MeshConfig  # noqa: E402

GRAD_TOL = dict(rtol=1e-4, atol=1e-7)
MESH = (4, 1)
GLOBAL_ROWS, REPLICATED_ROWS = 16, 6
TAB_NAMES = ["user_id", "item_id", "f2", "f3", "f4", "f5"]
TAB_DIMS = [10, 12, 8, 10, 6, 9]
TAB, SEQ = "tabular", "sequence"
# every registry model but din and fm: (schema, params, loss), the params
# and loss its family's tests use
MODELS = {
    "matrixcf": (TAB, {}, "bce"),
    "ncf": (TAB, {}, "bce"),
    "dssm_single": (TAB, {}, "bce"),
    "dssm_double": (TAB, {}, "in_batch_softmax"),
    "deepfm": (TAB, {}, "bce"),
    "wide_and_deep": (TAB, {}, "bce"),
    "ffm": (TAB, {}, "bce"),
    "fwfm": (TAB, {}, "bce"),
    "pnn": (TAB, {"product_type": "outer"}, "bce"),
    "onn": (TAB, {}, "bce"),
    "dcn": (TAB, {}, "bce"),
    "xdeepfm": (TAB, {"cin_layer_sizes": (5, 9, 3)}, "bce"),
    "nfm": (TAB, {}, "bce"),
    "deep_crossing": (TAB, {}, "bce"),
    "fnn": (TAB, {}, "bce"),
    "ccpm": (TAB, {}, "bce"),
    "fgcnn": (TAB, {}, "bce"),
    "afm": (TAB, {}, "bce"),
    "fibinet": (TAB, {}, "bce"),
    "autoint": (TAB, {}, "bce"),
    "mmoe": (TAB, {}, "multi_task"),
    "esmm": (TAB, {}, "multi_task"),
    "ple": (TAB, {}, "multi_task"),
    "esm2": (TAB, {}, "model_loss"),
    "escm2": (TAB, {"counterfact_mode": "dr"}, "model_loss"),
    "fdn": (TAB, {}, "model_loss"),
    "poso_mlp": (TAB, {}, "bce"),
    "poso_mha": (TAB, {}, "bce"),
    "poso_mmoe": (TAB, {}, "multi_task"),
    "pepnet": (TAB, {}, "multi_task"),
    "fibinet_pp": (TAB, {}, "bce"),
    "masknet": (TAB, {}, "bce"),
    "contextnet": (TAB, {}, "bce"),
    "finalmlp": (TAB, {}, "bce"),
    "dien": (SEQ, {}, "bce"),
    "dsin": (SEQ, {"num_sessions": 4}, "bce"),
    "mind": (SEQ, {}, "in_batch_softmax"),
    "sdm": (SEQ, {"short_len": 5}, "in_batch_softmax"),
    "comirec": (SEQ, {}, "in_batch_softmax"),
    "sine": (SEQ, {}, "in_batch_softmax"),
    "sim": (SEQ, {"topk": 5}, "gsu_esu"),
    "can": (SEQ, {}, "gsu_esu"),
    "eta": (SEQ, {"topk": 5, "short_len": 4, "n_hash_bits": 8}, "gsu_esu"),
    "sdim": (SEQ, {"n_hash_bits": 3, "short_len": 5}, "gsu_esu"),
    "dmr": (SEQ, {}, "bce"),
    "dmt": (SEQ, {}, "multi_task"),
}
# held to the JAX package's (4, 1) run: (model, params, loss, negative series)
JAX_CASES = {
    "dssm_double": ("dssm_double", {}, "in_batch_softmax", False),
    "dien_roll": ("dien", {}, "bce", False),
    "dien_neg": ("dien", {}, "bce", True),
    "dmr": ("dmr", {}, "bce", False),
    "escm2": ("escm2", {}, "model_loss", False),
    "sim": ("sim", {"topk": 5}, "gsu_esu", False),
}
# the engines against one device: (model, schema, params, loss, engine)
ENGINE_CASES = {
    "dssm_double-rowwise_adam": ("dssm_double", TAB, {}, "in_batch_softmax", "rowwise_adam"),
    "dien-fused": ("dien", SEQ, {}, "bce", "fused_adam"),
    "ffm-fused": ("ffm", TAB, {}, "bce", "fused_adam"),
    "can-fused": ("can", SEQ, {}, "gsu_esu", "fused_adam"),
}
SAMPLED_NEGATIVES = 4
LEARNING_RATE = 0.01
# a parameter the loss cannot see: the item tower's last bias adds u·b to
# every logit of a row alike, which the softmax cancels, so its exact
# gradient is 0 (``test_item_tower_gradient_sums_every_rank`` holds it
# there) and Adam moves it by at most the learning rate a step, driven by
# rounding; held to within that of one device's
SOFTMAX_INVARIANT = ("i_tower.proj.bias",)


# --------------------------------------------------------------------------
# shared by both sides
def _cfg(name, params=None, loss="bce", engine=None, used_id_l2=0.0, mesh=MESH):
    """The port's config (JSON) of ``name`` on ``mesh``: fp32, Adam at 0.01,
    seed 7, D = 8; ``engine`` a table optimizer of the sparse engines."""
    from tpurec_torch.config import (
        EmbeddingConfig, ModelConfig, OptimizerConfig, TrainConfig,
    )

    metrics = ("ctr_auc", "cvr_auc") if loss == "model_loss" else ()
    return ExperimentConfig(
        model=ModelConfig(name=name, params=dict(params or {}),
                          embedding=EmbeddingConfig(dim=8, used_id_l2=used_id_l2)),
        train=TrainConfig(
            compute_dtype="float32", log_every_steps=0, seed=7, loss=loss, metrics=metrics,
            sparse_embedding=engine is not None,
            optimizer=OptimizerConfig(learning_rate=LEARNING_RATE,
                                      embedding_optimizer=engine or "adam"),
        ),
        mesh=MeshConfig(data=mesh[0], model=mesh[1]),
    ).to_json()


def _case_run(case, mesh=None):
    """``case``'s steps on ``mesh`` (one device when None) from its initial
    weights (the JAX package's ``variables`` when it carries them, else the
    seed's): each step's logged loss and terms, the metric results, the
    parameters after the steps (whole), the first step's gradients when
    ``case["grads"]``, and ``evaluate`` of ``case["evaluate"]``'s batches."""
    from tpurec_torch.bridge import params_from_jax
    from tpurec_torch.train.trainer import Trainer

    cfg = ExperimentConfig.from_json(case["cfg"])
    if mesh is None:
        cfg = cfg.replace(mesh=MeshConfig(data=1, model=1))
    t = Trainer(cfg, case["info"], device="cpu", mesh_ctx=mesh)
    state = t.init_state()
    if "variables" in case:
        params_from_jax(state.model, case["variables"])
    out = {"logs": [], "replicated": []}
    metric_state = t.metrics.init()
    for i, b in enumerate(case["batches"]):
        batch = t.device_batch(b)
        out["replicated"].append(batch.replicated)
        state, metric_state, logs = t.train_step(state, batch, metric_state)
        out["logs"].append({k: float(v) for k, v in logs.items()})
        if i == 0 and case.get("grads"):
            out["grads"] = {n: p.grad.clone().numpy() for n, p in state.model.named_parameters()
                            if p.grad is not None}
    out["results"] = {k: float(v) for k, v in t.metrics.result(metric_state).items()}
    out["params"] = _whole_params(state.model)
    if "evaluate" in case:
        out["evaluate"] = {k: t.evaluate(state, bs) for k, bs in case["evaluate"].items()}
    return out


# --------------------------------------------------------------------------
# the ranks' side
def _mesh41(inputs):
    from tpurec_torch.core.mesh import make_mesh

    mesh = make_mesh(MeshConfig(data=MESH[0], model=MESH[1]))
    assert (mesh.n_data, mesh.n_model) == MESH
    return {group: {key: _case_run(case, mesh) for key, case in cases.items()}
            for group, cases in inputs.items()}


CASES = {"mesh41": _mesh41}


# --------------------------------------------------------------------------
# the pytest side
def _quarters(b):
    """Each row's data rank on (4, 1) when ``b`` rows divide over it."""
    return np.arange(b) * MESH[0] // b


def _tab_data(b, seed):
    """(DataInfo, batch) over six fields (user: user_id, f2, f4; item:
    item_id, f3, f5) and one continuous column: each rank's rows draw their
    ids from the upper part of each range that starts higher the later the
    rank, and its continuous values shifted by the rank, so every rank's
    moments differ. item_id repeats across ranks (rows 0 and 5, 9 and 15)
    and within one (rows 2 and 3); seeded ctr/cvr labels (``label`` the
    ctr)."""
    from tpurec_torch.data.schema import DataInfo

    info = DataInfo.from_dims(
        TAB_NAMES, TAB_DIMS, continuous_names=["c1"], label_names=["ctr", "cvr"],
        user_features=["user_id", "f2", "f4"], item_features=["item_id", "f3", "f5"],
    )
    rng = np.random.default_rng(seed)
    q = _quarters(b)
    data, off = {}, 0
    for n, d in zip(TAB_NAMES, TAB_DIMS):
        lo = off + q * (d // 6)
        data[n] = lo + (rng.random(b) * (off + d - lo)).astype(np.int64)
        off += d
    if b == GLOBAL_ROWS:
        ids = data["item_id"]
        ids[5], ids[15], ids[3] = ids[0], ids[9], ids[2]
    data["c1"] = (rng.normal(size=(b,)) + q).astype(np.float32)
    ctr = (rng.random(b) < 0.5).astype(np.float32)
    data["ctr"] = data["label"] = ctr
    data["cvr"] = ctr * (rng.random(b) < 0.5).astype(np.float32)
    return info, data


def _seq_data(b, seed, neg=False):
    """(DataInfo, batch) of ``tpurec_torch.dryrun.tiny_dataset`` (three
    features, two aligned series of 16 over 85 ids) with holes after the
    first two steps; on 16 rows, rows 4 and 5 (rank 1) hold one valid step
    and row 13 (rank 3) none, so DMR's valid rows differ by rank; seeded
    ctr/cvr labels; with ``neg`` the ``neg_<series>`` columns."""
    from tpurec_torch.dryrun import tiny_dataset

    info, data = tiny_dataset(batch=b, seq_len=16, seed=seed)
    info = dataclasses.replace(info, label_names=["label", "ctr", "cvr"])
    rng = np.random.default_rng(seed + 100)
    hole = (rng.random((b, 16)) < 0.2) & (np.arange(16) >= 2)[None, :]
    if b == GLOBAL_ROWS:
        hole[[4, 5], 1:] = True
        hole[13] = True
    for n in ("history", "history_tags"):
        data[n] = np.where(hole, 0, data[n])
    data["ctr"] = data["label"]
    data["cvr"] = data["label"] * (rng.random(b) < 0.5).astype(np.float32)
    if neg:
        live = data["history"] != 0
        data["neg_history"] = np.where(live, rng.integers(1, 65, size=(b, 16)), 0)
        data["neg_history_tags"] = np.where(live, rng.integers(73, 85, size=(b, 16)), 0)
    return info, data


def _data(schema, b, seed, neg=False):
    return _tab_data(b, seed) if schema == TAB else _seq_data(b, seed, neg)


def _batches(schema, seed, neg=False, replicated=True):
    rows = [GLOBAL_ROWS, GLOBAL_ROWS] + ([REPLICATED_ROWS] if replicated else [])
    return [_data(schema, b, seed + i, neg)[1] for i, b in enumerate(rows)]


def _jax_info(schema):
    from tpurec.data.schema import DataInfo as JDataInfo

    info = _data(schema, GLOBAL_ROWS, 0)[0]
    return JDataInfo(**{k: getattr(info, k) for k in JDataInfo.__dataclass_fields__})


def _jax_case(model, params, loss, neg, seed):
    """The JAX package's (4, 1) run of two fp32 steps (used-id L2 0.01) on
    four of its CPU devices, and the port's case of the same config,
    weights and batches."""
    import jax

    from test_torch_mesh_train import _by_name, _jcfg, _trainer
    from tpurec.core.mesh import make_mesh as jmake_mesh
    from tpurec.train import Trainer as JTrainer

    schema = MODELS[model][0]
    batches = _batches(schema, seed, neg, replicated=False)
    jcfg = _jcfg(model, MESH, loss=loss, params=params)
    if loss == "model_loss":
        jcfg = jcfg.replace(train=jcfg.train.replace(metrics=("ctr_auc", "cvr_auc")))
    jt = JTrainer(jcfg, _jax_info(schema), mesh_ctx=jmake_mesh(jcfg.mesh, devices=jax.devices()[:4]))
    js = jt.init_state(batches[0])
    variables = jax.tree.map(np.asarray, {"params": js.params, **js.model_state})
    metric_state = jt.metrics.init()
    logs = []
    for b in batches:
        js, metric_state, step_logs = jt.train_step(js, jt.device_batch(b), metric_state)
        logs.append({k: float(v) for k, v in step_logs.items()})
    info = _data(schema, GLOBAL_ROWS, 0)[0]
    one = jcfg.replace(mesh=jcfg.mesh.replace(data=1, model=1)).to_json()
    want = {"logs": logs, "results": {k: float(v) for k, v in jt.metrics.result(metric_state).items()},
            "params": _by_name(js, _trainer(one, info).init_state().model)}
    return {"cfg": jcfg.to_json(), "info": info, "variables": variables, "batches": batches}, want


@pytest.fixture(scope="module")
def mesh41(tmp_path_factory):
    def compute(directory):
        inputs = {"models": {}, "jax": {}, "sampled": {}, "evaluate": {}, "engines": {},
                  "grads": {}}
        want = {"jax": {}}
        for seed, (name, (schema, params, loss)) in enumerate(MODELS.items()):
            inputs["models"][name] = {"cfg": _cfg(name, params, loss),
                                      "info": _data(schema, GLOBAL_ROWS, 0)[0],
                                      "batches": _batches(schema, 100 + 10 * seed)}
        for seed, (key, (model, params, loss, neg)) in enumerate(JAX_CASES.items()):
            inputs["jax"][key], want["jax"][key] = _jax_case(model, params, loss, neg,
                                                             600 + 10 * seed)
        inputs["sampled"]["mind"] = {
            "cfg": _cfg("mind", {"num_sampled_negatives": SAMPLED_NEGATIVES}, "in_batch_softmax"),
            "info": _data(SEQ, GLOBAL_ROWS, 0)[0], "batches": _batches(SEQ, 700)}
        for name in ("dssm_double", "mind"):
            schema = MODELS[name][0]
            inputs["evaluate"][name] = {
                "cfg": _cfg(name, loss="in_batch_softmax"), "info": _data(schema, GLOBAL_ROWS, 0)[0],
                "batches": _batches(schema, 710, replicated=False),
                "evaluate": {"divides": [_data(schema, GLOBAL_ROWS, 720)[1]],
                             "replicated": [_data(schema, REPLICATED_ROWS, 721)[1]]}}
        for seed, (key, (model, schema, params, loss, engine)) in enumerate(ENGINE_CASES.items()):
            inputs["engines"][key] = {
                "cfg": _cfg(model, params, loss, engine, used_id_l2=0.01),
                "info": _data(schema, GLOBAL_ROWS, 0)[0],
                "batches": _batches(schema, 800 + 10 * seed)}
        inputs["grads"]["dssm_double"] = {
            "cfg": _cfg("dssm_double", loss="in_batch_softmax"), "info": _data(TAB, GLOBAL_ROWS, 0)[0],
            "batches": _batches(TAB, 900, replicated=False)[:1], "grads": True}
        for group in ("models", "sampled", "evaluate", "engines", "grads"):
            want[group] = {key: _case_run(case) for key, case in inputs[group].items()}
        results = run_world(os.path.abspath(__file__), "mesh41", 4, directory, inputs)
        return want, results

    return shared_world(tmp_path_factory, "torch_mesh41", compute)


def _assert_logs(got, want, tol=LOSS_TOL):
    """Each step's logged loss and terms: the same names, each within
    ``tol``."""
    assert len(got) == len(want)
    for step, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (step, sorted(g), sorted(w))
        for k, v in w.items():
            np.testing.assert_allclose(g[k], v, **tol, err_msg=f"step {step} {k}")


def _assert_results(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-6 if "auc" in k or k == "accuracy" else 2e-5), k


def _assert_one_device(got, want):
    _assert_logs(got["logs"], want["logs"])
    _assert_results(got["results"], want["results"])
    seen = {n: p for n, p in want["params"].items() if n not in SOFTMAX_INVARIANT}
    _assert_params({n: got["params"][n] for n in seen}, seen, PARAM_TOL)
    assert set(got["params"]) == set(want["params"])
    for n in set(want["params"]) - set(seen):
        np.testing.assert_allclose(got["params"][n], want["params"][n], rtol=0,
                                   atol=LEARNING_RATE * len(want["logs"]), err_msg=n)


@pytest.mark.parametrize("name", registry_names())
def test_every_model_on_data_axis_matches_one_device(mesh41, name):
    """Each registry model (a model without a case here fails) on (4, 1)
    under its family's loss: two steps over 16 rows (4 a rank) and one
    over 6 (replicated on every rank), each rank's logged loss and terms
    (the global batch's), the metrics and every parameter after the steps
    against one device."""
    want, results = mesh41
    assert name in MODELS, f"{name}: no case on a data axis"
    for res in results:
        got = res["models"][name]
        assert got["replicated"] == [False, False, True]
        _assert_one_device(got, want["models"][name])


@pytest.mark.parametrize("key", list(JAX_CASES))
def test_coupled_rows_on_data_axis_match_jax(mesh41, key):
    """The terms that couple the batch's rows, on (4, 1) from the JAX
    package's weights, against its (4, 1) run: two fp32 steps (used-id L2
    0.01), each step's loss, used-id L2 and logged terms (DIEN's and DMR's
    ``auxiliary_loss``, the softmax CE, ESCM2's ``model_loss``, the GSU and
    ESU CEs), the metrics and every parameter after the steps."""
    want, results = mesh41
    w = want["jax"][key]
    for res in results:
        got = res["jax"][key]
        _assert_logs(got["logs"], w["logs"])
        _assert_results(got["results"], w["results"])
        _assert_params(got["params"], w["params"], PARAM_TOL)
    aux = [s.get("auxiliary_loss") for s in w["logs"]]
    assert (aux[0] is not None) == key.startswith(("dien", "dmr")), w["logs"]


def test_sampled_negatives_on_data_axis_match_one_device(mesh41):
    """MIND with 4 sampled negatives a row on (4, 1): each rank keeps its
    block of the global batch's draw from the generator every rank seeds
    alike (the replicated step draws the whole batch), so the steps equal
    the one-device run from the same seed."""
    want, results = mesh41
    for res in results:
        _assert_one_device(res["sampled"]["mind"], want["sampled"]["mind"])


@pytest.mark.parametrize("name", ["dssm_double", "mind"])
def test_evaluate_in_batch_accuracy_on_data_axis(mesh41, name):
    """``evaluate`` after two steps on (4, 1) under the in-batch softmax:
    the accuracy (argmax over the global batch's items) and the loss over
    16 rows (4 a rank) and over 6 (every rank holds them whole, counted
    once) equal one device's."""
    want, results = mesh41
    for res in results:
        got = res["evaluate"][name]
        _assert_one_device(got, want["evaluate"][name])
        for k, ref in want["evaluate"][name]["evaluate"].items():
            _assert_results(got["evaluate"][k], ref)


@pytest.mark.parametrize("key", list(ENGINE_CASES))
def test_sparse_engines_on_data_axis_match_one_device(mesh41, key):
    """dssm_double in ``rowwise_adam`` under the in-batch softmax (the ids
    it compares are positions in the global batch's unique list), DIEN,
    FFM (its (V, F·D) view) and CAN (its 152-wide induction table beside
    its 8-wide one) in the fused engine, used-id L2 0.01, on (4, 1) against
    one device: losses, terms, metrics, tables and weights."""
    want, results = mesh41
    for res in results:
        _assert_one_device(res["engines"][key], want["engines"][key])


def test_item_tower_gradient_sums_every_rank(mesh41):
    """dssm_double's gradients after one step over 16 rows on (4, 1) (the
    average over 'data') equal one device's, the item tower's included:
    each item row's embedding meets every rank's users in the softmax, so
    its gradient needs the cotangent of all four ranks' losses."""
    want, results = mesh41
    w = want["grads"]["dssm_double"]["grads"]
    assert any(n.startswith("i_tower.") for n in w)
    for n in SOFTMAX_INVARIANT:
        assert np.abs(w[n]).max() < 1e-5 * max(np.abs(g).max() for g in w.values()), n
    for res in results:
        got = res["grads"]["dssm_double"]["grads"]
        assert set(got) == set(w)
        for n, g in w.items():
            np.testing.assert_allclose(got[n], g, **GRAD_TOL, err_msg=n)


if __name__ == "__main__":
    rank_main(CASES)
