"""The port's training slice against the JAX package on the CPU.

Weights go from the JAX trainer's state through ``tpurec_torch.bridge`` into
the port; both packages then train on the same numpy batch. Tolerances:

- fp32 compute: the loss to 1e-5; gradients to 1e-6 + 1e-4 of the largest
  |g| of the tensor (the two frameworks sum in different orders; measured
  ~1e-5 of it at most); parameters after one Adam step to 2e-6 (Adam's first
  step is ±lr·g/(|g|+eps), lr = 1e-3: a gradient near eps = 1e-7 turns a
  tiny difference in g into a visible share of lr, and measured differences
  stay under 1e-7).
- bf16 compute: the loss to 1e-3; gradients to 2^-6 of the largest |g| (two
  bf16 steps: bias gradients are bf16 sums, rounded at other places by the
  two frameworks); parameters after Adam to 2e-5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_dataset
from tpurec.config import EmbeddingConfig as JEmbeddingConfig
from tpurec.config import ExperimentConfig as JExperimentConfig
from tpurec.config import ModelConfig as JModelConfig
from tpurec.config import OptimizerConfig as JOptimizerConfig
from tpurec.config import TrainConfig as JTrainConfig
from tpurec.core.mesh import make_mesh
from tpurec.data.schema import DataInfo as JDataInfo
from tpurec.ops.pallas.kernels import set_training_phase
from tpurec.train import Trainer as JTrainer
from tpurec.train.losses import add_auxiliary as jadd_auxiliary
from tpurec_torch.bridge import _flatten, _torch_leaf, opt_state_from_jax, params_from_jax
from tpurec_torch.config import ExperimentConfig
from tpurec_torch.data.schema import DataInfo
from tpurec_torch.train.trainer import Trainer

torch.set_num_threads(1)

FP32 = dict(loss=1e-5, grad=1e-4, param=2e-6)
BF16 = dict(loss=1e-3, grad=2.0**-6, param=2e-5)


# --------------------------------------------------------------------------
# helpers
def _din_data(batch=16, seed=0):
    jinfo, data = _tiny_dataset(batch=batch, seq_len=16, seed=seed)
    info = DataInfo(**{k: getattr(jinfo, k) for k in DataInfo.__dataclass_fields__})
    return jinfo, info, data


def _tabular_data(batch=32, seed=0):
    names = [f"f{i}" for i in range(8)]
    kw = dict(user_features=names[:4], item_features=names[4:])
    rng = np.random.default_rng(seed)
    data = {n: rng.integers(50 * i, 50 * i + 50, size=(batch,)) for i, n in enumerate(names)}
    data["label"] = rng.integers(0, 2, size=(batch,)).astype(np.float32)
    # repeated items, so in-batch softmax masks accidental hits
    data["item_id"] = rng.integers(0, 6, size=(batch,))
    return JDataInfo.from_dims(names, [50] * 8, **kw), DataInfo.from_dims(names, [50] * 8, **kw), data


def _configs(name, dtype="float32", used_id_l2=0.0, optimizer=None, **train_kw):
    jcfg = JExperimentConfig(
        model=JModelConfig(name=name, embedding=JEmbeddingConfig(dim=8, used_id_l2=used_id_l2)),
        train=JTrainConfig(
            compute_dtype=dtype, log_every_steps=0, optimizer=JOptimizerConfig(**(optimizer or {})),
            **train_kw,
        ),
    )
    return jcfg, ExperimentConfig.from_json(jcfg.to_json())


def _by_torch_name(tree, model):
    """flax params tree → {torch key: numpy array} over the port ``model``
    (Dense kernels transposed, raw kernels kept)."""
    out = {}
    for path, value in _flatten(jax.tree.map(np.asarray, tree)):
        name, arr = _torch_leaf("params", path, value, model)
        out[".".join(path[:-1] + (name,))] = arr
    return out


def _pair(jcfg, cfg, jinfo, info, data):
    """(JAX trainer, its state, port trainer, its state with the same weights)."""
    jt = JTrainer(jcfg, jinfo, mesh_ctx=make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    js = jt.init_state(data)
    pt = Trainer(cfg, info, device="cpu")
    ps = pt.init_state(data)
    params_from_jax(ps.model, jax.tree.map(np.asarray, {"params": js.params, **js.model_state}))
    return jt, js, pt, ps


def _jax_grads(jt, js, jbatch, model):
    """The JAX dense train step's loss gradient (its compute_loss, with the
    used-id L2 term), which its jitted step does not return."""
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
        return _by_torch_name(jax.grad(loss_fn)(js.params), model)
    finally:
        set_training_phase(False)


def _assert_grads(model, want, rtol):
    """A parameter the loss does not reach has no ``.grad`` in torch and a
    zero gradient in JAX."""
    for name, p in model.named_parameters():
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want[name])
        scale = float(np.abs(want[name]).max())
        err = float(np.abs(got - want[name]).max())
        assert err <= 1e-6 + rtol * scale, f"{name}: grad err {err} at scale {scale}"


def _assert_params(model, want, atol):
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=atol, rtol=0, err_msg=name)


def _assert_metric_state(jms, pms, atol):
    for name in jms:
        for key in jms[name]:
            np.testing.assert_allclose(
                pms[name][key].numpy(), np.asarray(jms[name][key]), atol=atol, rtol=0,
                err_msg=f"{name}/{key}",
            )


def _step_both(jt, js, pt, ps, data, tol, grads=True, frozen=()):
    """One step of both trainers: the loss, the gradients (``grads``) and
    the parameters after it. The ``frozen`` parameters take no gradient in
    the port (as none reaches them in tpurec's compiled step, where XLA
    drops it): their ``.grad`` must stay None, whatever ``jax.grad`` of the
    whole loss gives them."""
    jbatch = jt.device_batch(data)
    want_grads = _jax_grads(jt, js, jbatch, ps.model) if grads else None
    if grads and frozen:
        want_grads = {k: np.zeros_like(v) if k in frozen else v for k, v in want_grads.items()}
    js2, jms, jlogs = jt.train_step(js, jbatch, jt.metrics.init())
    ps2, pms, plogs = pt.train_step(ps, pt.device_batch(data), pt.metrics.init())
    assert ps2.step == int(js2.step)
    np.testing.assert_allclose(float(plogs["loss"]), float(jlogs["loss"]), atol=tol["loss"], rtol=0)
    if grads:
        _assert_grads(ps2.model, want_grads, tol["grad"])
        assert all(ps2.model.get_parameter(n).grad is None for n in frozen)
    _assert_params(ps2.model, _by_torch_name(js2.params, ps2.model), tol["param"])
    return js2, jms, jlogs, ps2, pms, plogs


# --------------------------------------------------------------------------
# one DIN train step
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_din_train_step_matches_jax(dtype):
    """Loss, every gradient, the parameters after Adam and the metric state
    (AUC histograms, loss mean) of one DIN step."""
    jinfo, info, data = _din_data()
    jt, js, pt, ps = _pair(*_configs("din", dtype), jinfo, info, data)
    tol = FP32 if dtype == "float32" else BF16
    _, jms, _, ps2, pms, _ = _step_both(jt, js, pt, ps, data, tol)
    _assert_metric_state(jms, pms, atol=1e-6)
    assert ps2.model.att.w1.grad.abs().max() > 0  # the attention trained


def test_din_step_after_jax_state():
    """Two JAX steps, then the JAX params and Adam state (``count``, ``mu``,
    ``nu``) carried into the port: step 3 agrees."""
    jinfo, info, data = _din_data()
    jcfg, cfg = _configs("din")
    jt, js, pt, ps = _pair(jcfg, cfg, jinfo, info, data)
    jbatch = jt.device_batch(data)
    for _ in range(2):
        js, _, _ = jt.train_step(js, jbatch, jt.metrics.init())
    params_from_jax(ps.model, jax.tree.map(np.asarray, {"params": js.params, **js.model_state}))
    opt_state_from_jax(ps.optimizer, ps.model, js.opt_state)
    ps.step = int(js.step)
    assert ps.optimizer.param_groups[0]["count"] == 2
    _step_both(jt, js, pt, ps, data, FP32)


# --------------------------------------------------------------------------
# the optimizer chain
_CHAIN = {
    "adamw": dict(model="fm", optimizer=dict(name="adamw", weight_decay=0.1)),
    "sgd": dict(model="fm", optimizer=dict(name="sgd", learning_rate=0.5)),
    "clip": dict(model="fm", optimizer=dict(grad_clip_norm=1e-3)),
    "embedding_l2": dict(
        model="fm",
        optimizer=dict(
            embedding_l2=0.5, embedding_l2_order1=0.05,
            embedding_l2_overrides={"f1": 2.0, "f5": 0.0},
        ),
    ),
    "cosine": dict(
        model="fm", optimizer=dict(lr_schedule="cosine", schedule_steps=3, schedule_alpha=0.1)
    ),
    "freeze": dict(model="deepfm", train=dict(freeze_prefixes=("deep",))),
    "used_id_l2": dict(model="din", used_id_l2=0.3),
    # the towers' output-bias gradients are 0 in exact arithmetic (softmax
    # rows sum to one); Adam scales their ~1e-10 rounding noise by lr/eps =
    # 1e4, so those parameters agree to ~5e-6 after three steps
    "dssm_in_batch_softmax": dict(
        model="dssm_double", train=dict(loss="in_batch_softmax"), param_atol=2e-5
    ),
}


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_chain_optimizer_on_cpu_launches_nothing(name):
    """On CPU parameters ``ChainOptimizer`` takes the chain's plain twin (the
    foreach ops) and launches no kernel: the counter stays where it was, and
    the step is the twin's, bit for bit."""
    from tpurec_torch.config import OptimizerConfig
    from tpurec_torch.ops import kernels
    from tpurec_torch.train.trainer import ChainOptimizer

    torch.manual_seed(3)
    net = torch.nn.Linear(6, 4)
    want = [p.detach().clone() for p in net.parameters()]
    grads = [torch.randn_like(p) for p in want]
    for p, g in zip(net.parameters(), grads):
        p.grad = g.clone()
    oc = OptimizerConfig(name=name, weight_decay=0.01, grad_clip_norm=0.1)
    opt = ChainOptimizer(list(net.named_parameters()), oc, {"weight": 0.5}, {})
    before = kernels.adam_update_fused.launches
    opt.step()
    assert kernels.adam_update_fused.launches == before
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    moments = None if name == "sgd" else [[torch.zeros_like(p) for p in want] for _ in range(2)]
    kernels.adam_update_plain(
        want, grads, *(moments or (None, None)), lr=oc.learning_rate, bc1=1.0 - oc.b1,
        bc2=1.0 - oc.b2, b1=oc.b1, b2=oc.b2, eps=oc.eps,
        weight_decay=0.01 if name == "adamw" else 0.0, l2=[0.5, None], norm=norm, clip=0.1,
    )
    for p, w in zip(net.parameters(), want):
        assert torch.equal(p.detach(), w)


@pytest.mark.parametrize("variant", list(_CHAIN))
def test_optimizer_chain_matches_jax(variant):
    """Three steps of each variant: the parameters after every step, the loss
    and (first step) the gradients."""
    spec = _CHAIN[variant]
    if spec["model"] == "din":
        jinfo, info, data = _din_data()
    else:
        jinfo, info, data = _tabular_data()
    jcfg, cfg = _configs(
        spec["model"], used_id_l2=spec.get("used_id_l2", 0.0), optimizer=spec.get("optimizer"),
        **spec.get("train", {}),
    )
    jt, js, pt, ps = _pair(jcfg, cfg, jinfo, info, data)
    frozen = {n: p.detach().clone() for n, p in ps.model.named_parameters() if n.startswith("deep.")}
    tol = dict(FP32, param=spec.get("param_atol", FP32["param"]))
    for i in range(3):
        js, _, jlogs, ps, _, plogs = _step_both(jt, js, pt, ps, data, tol, grads=i == 0, frozen=tuple(frozen))
    if variant == "used_id_l2":
        np.testing.assert_allclose(float(plogs["used_id_l2"]), float(jlogs["used_id_l2"]), rtol=1e-5)
    if variant == "freeze":
        assert frozen and all(torch.equal(p, ps.model.get_parameter(n)) for n, p in frozen.items())
        assert not any(n.startswith("deep.") for n in (g["name"] for g in ps.optimizer.param_groups))


def test_optimizer_refuses_unknown_names():
    jinfo, info, data = _tabular_data()
    for bad in (dict(name="lamb"), dict(lr_schedule="linear"), dict(lr_schedule="cosine")):
        _, cfg = _configs("fm", optimizer=bad)
        with pytest.raises(KeyError):
            Trainer(cfg, info, device="cpu").init_state(data)


# --------------------------------------------------------------------------
# the repairs: FM cross term in training, Dice BatchNorm statistics
def test_deepfm_bf16_train_step_matches_jax():
    """In training the FM cross term is the plain math in the embedding's
    dtype (bf16 here), as the JAX package computes it; the step's loss and
    gradients agree with JAX's at bf16 tolerance."""
    jinfo, info, data = _tabular_data()
    jt, js, pt, ps = _pair(*_configs("deepfm", "bfloat16"), jinfo, info, data)
    _step_both(jt, js, pt, ps, data, BF16)


def test_fm_cross_term_dispatch_by_mode():
    """Training mode: the plain math in bf16; otherwise fp32 and back."""
    from tpurec_torch.ops import kernels
    from tpurec_torch.ops.interactions import fm_second_order

    emb = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 6, 8)).astype(np.float32))
    emb = emb.to(torch.bfloat16)
    train = fm_second_order(emb, training=True)
    infer = fm_second_order(emb)
    assert torch.equal(train, kernels.fm_second_order_plain(emb))
    assert torch.equal(infer, kernels.fm_second_order_plain(emb.float()).to(torch.bfloat16))


@pytest.mark.parametrize("act", ["dice", "dice-prelu"])
def test_dice_batch_stats_after_train_step(act):
    """A Dice tower in training mode: the output, the input gradient and the
    updated running mean/var (flax: biased batch variance, momentum 0.99)."""
    from tpurec.ops.mlp import MLP as JMLP
    from tpurec_torch.ops.mlp import MLP

    kw = dict(hidden_dims=(12, 6), activation="dice")
    if act == "dice-prelu":
        kw["out_activation"] = "prelu"
    rng = np.random.default_rng(4)
    x = (2.0 * rng.normal(size=(16, 5, 10)) + 1.0).astype(np.float32)
    jm = JMLP(**kw)
    variables = jm.init(jax.random.key(1), jnp.asarray(x), train=False)
    variables = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32), variables)
    model = params_from_jax(MLP(10, **kw).train(), variables)

    def f(xx):
        return jm.apply(variables, xx, train=True, mutable=["batch_stats"])

    (want, new_vars), vjp = jax.vjp(f, jnp.asarray(x))
    g = rng.normal(size=want.shape).astype(np.float32)
    (want_dx,) = vjp((jnp.asarray(g), jax.tree.map(jnp.zeros_like, new_vars)))
    xt = torch.from_numpy(x).requires_grad_()
    got = model(xt)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), atol=1e-5, rtol=1e-4)
    for i in range(2):
        stats = new_vars["batch_stats"][f"dice_{i}"]["bn"] if f"dice_{i}" in new_vars["batch_stats"] else None
        if stats is None:
            continue
        bn = getattr(model, f"dice_{i}").bn
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), atol=1e-6, rtol=1e-5)


# --------------------------------------------------------------------------
# embedding term, metrics, losses
def test_used_id_l2_matches_jax():
    from tpurec.embedding.ops import used_id_l2 as jused
    from tpurec_torch.embedding.ops import used_id_l2

    rng = np.random.default_rng(0)
    table = rng.normal(size=(40, 8)).astype(np.float32)
    ids = rng.integers(0, 40, size=(16, 12))
    got = used_id_l2(torch.from_numpy(table), torch.from_numpy(ids))
    want = jused(jnp.asarray(table), jnp.asarray(ids))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    uniq = np.unique(ids)
    np.testing.assert_allclose(float(got), 0.5 * float((table[uniq] ** 2).sum()), rtol=1e-6)


def test_metrics_match_jax():
    from tpurec.core import metrics as jm
    from tpurec_torch.core import metrics as tm

    rng = np.random.default_rng(1)
    y = rng.integers(0, 2, size=(3, 500)).astype(np.float32)
    p = np.clip(0.3 * y + rng.uniform(size=(3, 500)) * 0.7, 0, 1).astype(np.float32)
    p[0, :5] = [0.0, 1.0, 0.5, 1.0 - 1e-9, 2048.5 / 2048]
    w = rng.integers(0, 2, size=(3, 500)).astype(np.float32)
    for cls in ("AUC", "Mean"):
        jmet, tmet = getattr(jm, cls)(), getattr(tm, cls)()
        js, ts = jmet.init(), tmet.init()
        for i in range(3):
            args = (y[i], p[i]) if cls == "AUC" else (p[i],)
            wi = w[i] if i else None
            js = jmet.update(js, *map(jnp.asarray, args), None if wi is None else jnp.asarray(wi))
            ts = tmet.update(ts, *map(torch.from_numpy, args), None if wi is None else torch.from_numpy(wi))
        for k in js:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), atol=1e-6)
        np.testing.assert_allclose(float(tmet.result(ts)), float(jmet.result(js)), atol=1e-6)
    assert tm.exact_auc(y[0], p[0]) == jm.exact_auc(y[0], p[0])
    bundle = tm.MetricBundle({"auc": tm.AUC(), "loss": tm.Mean()})
    state = bundle.update(bundle.init(), auc=(torch.tensor([1.0, 0.0]), torch.tensor([0.9, 0.1])))
    assert float(bundle.result(state)["auc"]) == 1.0


_LOSS_CASES = {
    "bce": ("bce", ["logit"]),
    "bce_from_prob": ("bce", ["output"]),
    "multi_task": ("multi_task", ["ctr_logit", "cvr_output"]),
    "multi_task_ctcvr": ("multi_task", ["ctr_output", "ctcvr_logit", "ctcvr_output"]),
    "in_batch_softmax_towers": ("in_batch_softmax", ["user_embedding", "item_embedding"]),
    "in_batch_softmax_logits": ("in_batch_softmax", ["logits"]),
    "gsu_esu": ("gsu_esu", ["gsu_logits", "esu_logits"]),
    "model_loss": ("model_loss", ["loss", "auxiliary_loss", "orth_loss"]),
}


@pytest.mark.parametrize("case", list(_LOSS_CASES))
def test_losses_match_jax(case):
    from tpurec.train import losses as jl
    from tpurec_torch.train import losses as tl

    name, keys = _LOSS_CASES[case]
    rng = np.random.default_rng(2)
    b = 12
    shapes = {"user_embedding": (b, 4), "item_embedding": (b, 4), "logits": (b, 5),
              "gsu_logits": (b, 2), "esu_logits": (b, 2), "loss": (), "auxiliary_loss": (),
              "orth_loss": ()}
    outputs = {}
    for k in keys:
        if k.endswith("output"):
            outputs[k] = rng.uniform(0, 1, size=(b,)).astype(np.float32)
        else:
            outputs[k] = rng.normal(size=shapes.get(k, (b,))).astype(np.float32)
    batch = {k: rng.integers(0, 2, size=(b,)).astype(np.float32) for k in ("label", "ctr", "cvr")}
    batch["item_id"] = rng.integers(0, 4, size=(b,))
    jl_loss, jlogs = jl.get_loss(name)({k: jnp.asarray(v) for k, v in outputs.items()},
                                       {k: jnp.asarray(v) for k, v in batch.items()})
    jl_loss, jaux = jl.add_auxiliary(jl_loss, {k: jnp.asarray(v) for k, v in outputs.items()})
    tl_loss, tlogs = tl.get_loss(name)({k: torch.from_numpy(v) for k, v in outputs.items()},
                                       {k: torch.from_numpy(v) for k, v in batch.items()})
    tl_loss, taux = tl.add_auxiliary(tl_loss, {k: torch.from_numpy(v) for k, v in outputs.items()})
    np.testing.assert_allclose(float(tl_loss), float(jl_loss), rtol=1e-5, atol=1e-6)
    assert set(tlogs) == set(jlogs) and set(taux) == set(jaux)
    for k in jlogs:
        np.testing.assert_allclose(float(tlogs[k]), float(jlogs[k]), rtol=1e-5, atol=1e-6)
    with pytest.raises(KeyError):
        tl.get_loss("hinge")


# --------------------------------------------------------------------------
# loops, checkpoints, export
def _din_batches(n, seed, batch=16):
    return [_din_data(batch=batch, seed=seed + i)[2] for i in range(n)]


def test_evaluate_matches_jax():
    """``evaluate`` over three batches after a train step, with a
    wrap-padded ``__weight__`` batch among them."""
    jinfo, info, data = _din_data()
    jt, js, pt, ps = _pair(*_configs("din"), jinfo, info, data)
    js, _, _, ps, _, _ = _step_both(jt, js, pt, ps, data, FP32, grads=False)
    batches = _din_batches(3, seed=10)
    batches[2]["__weight__"] = (np.arange(16) < 11).astype(np.float32)
    want = jt.evaluate(js, batches)
    got = pt.evaluate(ps, batches)
    assert set(got) == set(want) == {"loss", "auc"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


def test_run_early_stop_checkpoints_and_export(tmp_path):
    """``run`` with early stopping on the eval AUC, keep-best checkpoints
    (``max_to_keep``), TensorBoard scalars, then ``export`` →
    ``load_servable``: the servable's prediction is ``infer``'s."""
    from tpurec_torch.serving.export import load_servable

    jinfo, info, _ = _din_data()
    train, evals = _din_batches(3, seed=20), _din_batches(2, seed=40)
    cfg = ExperimentConfig.from_dict(dict(
        model=dict(name="din", embedding=dict(dim=8)),
        train=dict(
            epochs=6, compute_dtype="float32", log_every_steps=2, max_to_keep=2,
            checkpoint_dir=str(tmp_path / "ckpt"), tensorboard_dir=str(tmp_path / "tb"),
            early_stop=dict(num_trials=1, criterion="better"),
            optimizer=dict(learning_rate=0.05),
        ),
    ))
    trainer = Trainer(cfg, info, device="cpu")
    state, out = trainer.run(lambda: iter(train), lambda: iter(evals))
    hist = out["metric_history"]
    assert 1 <= len(hist) <= 6 and len(out["history"]) == len(hist)
    assert out["best_epoch"] == int(np.argmax(hist))
    # 'better' with one trial stops at the first epoch that did not improve
    assert len(hist) == 6 or hist[-1] <= hist[-2]
    steps = trainer.ckpt.all_steps()
    assert 1 <= len(steps) <= 2 and steps[-1] == 3 * (out["best_epoch"] + 1)
    assert any(p.name.startswith("events.out.tfevents") for p in (tmp_path / "tb").iterdir())

    trainer.export(state, str(tmp_path / "export"))
    meta = json.loads((tmp_path / "export" / "export_meta.json").read_text())
    assert meta["model"] == "din" and "dtype" not in meta["model_params"]
    servable = load_servable(str(tmp_path / "export"), info, device="cpu")
    rows = {k: v[:8] for k, v in evals[0].items() if k != "label"}
    np.testing.assert_array_equal(servable.predict(rows)["output"].numpy(), trainer.infer(state, rows)["output"])


def test_run_mid_epoch_eval_and_profile(tmp_path):
    """``eval_every_steps`` keeps the best checkpoint at step granularity
    (the first mid-epoch eval is always a new best); ``profile_dir`` writes
    a ``torch.profiler`` trace of the configured steps."""
    jinfo, info, _ = _din_data()
    train, evals = _din_batches(3, seed=50), _din_batches(1, seed=60)
    _, cfg = _configs(
        "din", epochs=1, eval_every_steps=1, checkpoint_dir=str(tmp_path / "ckpt"),
        max_to_keep=5, profile_dir=str(tmp_path / "prof"), profile_start_step=2,
        profile_num_steps=1,
    )
    trainer = Trainer(cfg, info, device="cpu")
    trainer.run(lambda: iter(train), lambda: iter(evals))
    steps = trainer.ckpt.all_steps()
    assert steps[0] == 1 and steps == sorted(set(steps)) and steps[-1] <= 3
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_restore_round_trip(tmp_path):
    """``save`` → more steps → ``restore``: the step, every parameter, the
    optimizer's moments and the generator come back exactly."""
    jinfo, info, data = _din_data()
    _, cfg = _configs("din", checkpoint_dir=str(tmp_path), max_to_keep=1)
    trainer = Trainer(cfg, info, device="cpu")
    state = trainer.init_state(data)
    batch = trainer.device_batch(data)
    state, _, _ = trainer.train_step(state, batch, trainer.metrics.init())
    trainer.save(state)
    saved = {k: v.clone() for k, v in state.model.state_dict().items()}
    saved_mu = {g["name"]: state.optimizer.state[g["params"][0]]["mu"].clone() for g in state.optimizer.param_groups}
    saved_gen = state.generator.get_state()
    for _ in range(2):
        state, _, _ = trainer.train_step(state, batch, trainer.metrics.init())
    torch.rand(3, generator=state.generator)
    trainer.save(state)
    assert trainer.ckpt.all_steps() == [3]  # max_to_keep=1
    restored = trainer.restore(state, step=None)
    assert restored.step == 3
    restored = trainer.restore(state, step=3)
    with pytest.raises(FileNotFoundError):
        trainer.restore(state, step=1)
    # back to step 1 through a fresh manager holding both steps
    trainer.ckpt.max_to_keep = 3
    state1 = trainer.init_state(data)
    state1, _, _ = trainer.train_step(state1, batch, trainer.metrics.init())
    assert state1.step == 1
    trainer.save(state1)
    back = trainer.restore(restored, step=1)
    assert back.step == 1 and back.optimizer.param_groups[0]["count"] == 1
    for k, v in back.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    for g in back.optimizer.param_groups:
        assert torch.equal(back.optimizer.state[g["params"][0]]["mu"], saved_mu[g["name"]])
    assert torch.equal(back.generator.get_state(), saved_gen)


def test_load_from_export_and_init_subtree(tmp_path):
    from tpurec_torch.train.checkpoint import export_params

    jinfo, info, data = _din_data()
    _, cfg = _configs("din")
    trainer = Trainer(cfg, info, device="cpu")
    a = trainer.init_state(data, seed=1)
    b = trainer.init_state(data, seed=2)
    trainer.export(a, str(tmp_path / "a"))
    b = trainer.load_from_export(b, str(tmp_path / "a"))
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    c = trainer.init_state(data, seed=3)
    export_params(str(tmp_path / "mlp"), a.model.mlp.state_dict())
    c = trainer.init_subtree_from_export(c, str(tmp_path / "mlp"), "mlp")
    assert torch.equal(c.model.mlp.dense_0.weight, a.model.mlp.dense_0.weight)
    assert not torch.equal(c.model.att.w1, a.model.att.w1)
    with pytest.raises(KeyError):
        trainer.init_subtree_from_export(c, str(tmp_path / "mlp"), "att")


def test_trainer_refuses_unported_engines():
    """A mesh of more devices than the world has is refused, with the JAX
    package's ``make_mesh`` error; ``'auto'`` resolves to the dense engine; with ``sparse_embedding=False`` a sparse
    ``embedding_optimizer`` is ignored and the step is dense, as in the JAX
    package (``trainer.py:1359-1368``): the tables stay in the optimizer and
    the step equals the JAX dense step."""
    jinfo, info, data = _din_data()
    cfg = ExperimentConfig.from_dict(dict(mesh=dict(data=2)))
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        Trainer(cfg, info, device="cpu")
    auto = ExperimentConfig.from_dict(dict(train=dict(optimizer=dict(embedding_optimizer="auto"))))
    resolved = Trainer(auto, info, device="cpu").config.train
    assert resolved.optimizer.embedding_optimizer == "adam" and not resolved.sparse_embedding
    for opt in ("fused_adam", "rowwise_adam", "host_adam"):
        jcfg, cfg = _configs("din", optimizer=dict(embedding_optimizer=opt))
        jt, js, pt, ps = _pair(jcfg, cfg, jinfo, info, data)
        assert ps.table_opt is None and ps.host_store is None
        assert "emb.embedding" in [g["name"] for g in ps.optimizer.param_groups]
        _step_both(jt, js, pt, ps, data, FP32, grads=False)


def test_config_summary_and_early_stop_copies_match_jax(tmp_path):
    from tpurec.core import summary as jsummary
    from tpurec.core.early_stop import EarlyStopper as JStopper
    from tpurec_torch.core import summary as tsummary
    from tpurec_torch.core.early_stop import EarlyStopper

    jcfg = JExperimentConfig.from_dict(dict(
        model=dict(name="din", params={"hidden_dims": [4, 2]}, embedding=dict(dim=4, used_id_l2=0.1)),
        train=dict(loss="bce", freeze_prefixes=["emb"], optimizer=dict(embedding_l2_overrides={"f1": 1.0})),
        data=dict(max_seq_length=9), mesh=dict(data=1),
    ))
    assert ExperimentConfig.from_json(jcfg.to_json()).to_dict() == jcfg.to_dict()
    assert ExperimentConfig().train.optimizer.eps == 1e-7
    for kw in (dict(step=7, tag="eval/auc", simple_value=0.75), dict(file_version="brain.Event:2")):
        event = tsummary._encode_event(1234.5, **kw)
        assert event == jsummary._encode_event(1234.5, **kw)
        from tpurec.data.recordio import frame_record

        assert tsummary.frame_record(event) == frame_record(event)
    for crit in ("best", "better"):
        a, b = JStopper(2, crit), EarlyStopper(2, crit)
        for m in (0.5, 0.6, 0.55, 0.58, 0.57, 0.4):
            assert a.is_continuable(m) == b.is_continuable(m)
            assert a.is_new_best == b.is_new_best
        assert a.check_record() == b.check_record()
