"""The port's mesh on the CPU: ``core/mesh.py``, ``core/collectives.py``,
``row_sharded_lookup``, ``ops/attention_cp.py``, and the batch moments and
metrics of a data axis, against the JAX package on its virtual CPU devices.

One world of four ranks (spawned processes, gloo over a rendezvous file,
no JAX in them) computes every case of this file once; the tests read its
results. The JAX side runs in the pytest process. This file is also the
ranks' script (``python tests/test_torch_mesh.py <world> <rank> <size>
<dir>``), and ``run_world`` starts a world for ``tests/test_torch_mesh_train.py``
too: it joins the ranks under a time limit and kills them on expiry, so a
hung collective fails one test.

Tolerances: sums of the same fp32 numbers in another order, 1e-6 absolute
and relative; 1e-5 for the attention, whose score MLP sums 4D products and
whose pool sums four ranks' partial sums of terms up to ~35 in size; the
lookup, the psum and the layouts are exact.
"""

from __future__ import annotations

import fcntl
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from tpurec_torch.config import MeshConfig  # noqa: E402
from tpurec_torch.core.mesh import make_mesh  # noqa: E402

WORLD_TIMEOUT = 180  # seconds a world may take, start to end
TOL = dict(atol=1e-6, rtol=1e-6)
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)
MESHES = ((2, 2), (1, 4), (4, 1))


# --------------------------------------------------------------------------
# worlds of spawned ranks
def run_world(script: str, world: str, size: int, directory: str, inputs) -> list:
    """Start ``size`` ranks of ``script`` for ``world`` with ``inputs``
    (pickled to ``directory``), wait for all of them under
    ``WORLD_TIMEOUT``, and return each rank's result. A rank that fails
    (the rest are then killed) or is still running at the limit fails the
    call."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    logs = [os.path.join(directory, f"rank_{rank}.log") for rank in range(size)]
    procs = []
    for rank, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, script, world, str(rank), str(size), directory],
                env=env, stdout=f, stderr=subprocess.STDOUT,
            ))
    deadline = time.monotonic() + WORLD_TIMEOUT
    try:
        # a failed rank leaves the others waiting in a collective: stop then
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, (
            f"world {world!r} rank {rank} exited {p.returncode} (killed if negative: at "
            f"{WORLD_TIMEOUT} s, or after another rank failed):\n{open(log).read()[-4000:]}"
        )
    results = []
    for rank in range(size):
        with open(os.path.join(directory, f"out_{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def shared_world(tmp_path_factory, name: str, compute):
    """``compute()``'s value, computed once per run by whichever pytest
    worker asks first (a file lock in the run's shared temporary
    directory; the others wait and read it)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the run's directory, above the workers' own
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        value = compute(str(root / name))
        with open(path, "wb") as f:
            pickle.dump(value, f)
        return value


def rank_main(cases: dict) -> None:
    """The body of a rank: join the world, run ``cases[world]`` on the
    inputs, write its result."""
    world, rank, size, directory = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(directory, 'rendezvous')}",
        rank=rank, world_size=size,
    )
    with open(os.path.join(directory, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    out = cases[world](inputs)
    with open(os.path.join(directory, f"out_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _np(t):
    return t.detach().cpu().numpy()


# --------------------------------------------------------------------------
# the ranks' side: every case of this file in one world of four
def _ops_world(inputs):
    import torch.distributed as dist

    from tpurec_torch.core.collectives import pmax, psum, replicated_input
    from tpurec_torch.core.metrics import AUC, Mean, MetricBundle
    from tpurec_torch.embedding.ops import local_rows, row_sharded_lookup
    from tpurec_torch.ops.attention_cp import din_attention_cp, softmax_attention_cp
    from tpurec_torch.ops.mlp import BatchNorm, Dice
    from tpurec_torch.train.trainer import whole_tensors

    rank = dist.get_rank()
    out = {"layouts": {}, "lookup": {}}
    meshes = {}
    for d, m in MESHES + ((-1, 2),):
        mesh = make_mesh(MeshConfig(data=d, model=m))
        meshes[(d, m)] = mesh
        out["layouts"][(d, m)] = (mesh.n_data, mesh.n_model, mesh.data_index, mesh.model_index)
    world = dist.new_group(list(range(4)))

    # the psum's identity backward, replicated_input's summed one, pmax
    x = torch.full((3,), float(rank + 1), requires_grad=True)
    c = torch.tensor([1.0, 2.0, 3.0])
    (psum(x, world) * c).sum().backward()
    y = torch.full((3,), 2.0, requires_grad=True)
    (replicated_input(y, world) * (rank + 1)).sum().backward()
    out["psum"] = {
        "value": _np(psum(x, world)), "grad": _np(x.grad), "replicated_grad": _np(y.grad),
        "max": _np(pmax(torch.tensor([float(rank), -float(rank)]), world)),
    }

    # the row-sharded lookup, its gradient summed over 'data'
    for key in ((1, 4), (2, 2)):
        mesh = meshes[key]
        table = torch.tensor(local_rows(torch.from_numpy(inputs["table"]), mesh).numpy(),
                             requires_grad=True)
        ids, cot = torch.from_numpy(inputs["ids"]), torch.from_numpy(inputs["cot"])
        k = ids.shape[0] // mesh.n_data
        block = slice(mesh.data_index * k, (mesh.data_index + 1) * k)
        rows = row_sharded_lookup(table, ids[block], mesh)
        (rows * cot[block]).sum().backward()
        grad = table.grad.clone()
        if mesh.data_group is not None:
            dist.all_reduce(grad, group=mesh.data_group)
        out["lookup"][key] = {"rows": _np(rows), "grad": _np(grad)}
    try:
        local_rows(torch.zeros(10, 2), meshes[(1, 4)])
    except ValueError as e:
        out["uneven"] = str(e)

    # context-parallel attention over model = 4
    mesh = meshes[(1, 4)]
    a = {k: torch.from_numpy(v) for k, v in inputs["cp"].items()}
    lk = a["keys"].shape[1] // 4
    steps = slice(mesh.model_index * lk, (mesh.model_index + 1) * lk)
    leaves = {n: a[n].clone().requires_grad_() for n in ("query", "w1", "b1", "w2", "alpha")}
    keys = a["keys"][:, steps].clone().requires_grad_()
    pooled, scores = din_attention_cp(
        leaves["query"], keys, a["mask"][:, steps], leaves["w1"], leaves["b1"],
        leaves["w2"], leaves["alpha"], mesh,
    )
    ((pooled * a["cot_pooled"]).sum() + (scores * a["cot_scores"][:, steps]).sum()).backward()
    out["din_cp"] = {
        "pooled": _np(pooled), "scores": _np(scores), "dkeys": _np(keys.grad),
        **{f"d{n}": _np(t.grad) for n, t in leaves.items()},
    }
    q = a["query"].clone().requires_grad_()
    keys = a["keys"][:, steps].clone().requires_grad_()
    values = a["values"][:, steps].clone().requires_grad_()
    pooled = softmax_attention_cp(q, keys, values, a["mask"][:, steps], mesh)
    (pooled * a["cot_pooled"]).sum().backward()
    out["softmax_cp"] = {"pooled": _np(pooled), "dquery": _np(q.grad), "dkeys": _np(keys.grad),
                         "dvalues": _np(values.grad)}

    # batch moments and metrics over 'data' (the (4, 1) mesh)
    mesh = meshes[(4, 1)]
    k = inputs["bn_x"].shape[0] // 4
    block = slice(mesh.data_index * k, (mesh.data_index + 1) * k)
    out["norm"] = {}
    for name, module in (("bn", BatchNorm(5)), ("dice", Dice(5))):
        torch.manual_seed(0)
        for p in module.parameters():
            torch.nn.init.uniform_(p, 0.5, 1.5)
        for m in module.modules():
            if isinstance(m, BatchNorm):
                m.data_group = mesh.data_group
        xb = torch.from_numpy(inputs["bn_x"][block]).requires_grad_()
        yb = module.train()(xb)
        (yb * torch.from_numpy(inputs["bn_cot"][block])).sum().backward()
        grads = {n: p.grad.clone() for n, p in module.named_parameters()}
        for g in grads.values():
            dist.all_reduce(g, group=mesh.data_group)
        bn = module if name == "bn" else module.bn
        out["norm"][name] = {
            "y": _np(yb), "dx": _np(xb.grad), "running_mean": _np(bn.running_mean),
            "running_var": _np(bn.running_var), **{f"d{n}": _np(g) for n, g in grads.items()},
        }
    k = inputs["labels"].shape[0] // 4
    block = slice(mesh.data_index * k, (mesh.data_index + 1) * k)
    bundle = MetricBundle({"auc": AUC(), "loss": Mean()}, group=mesh.data_group)
    st = bundle.update(
        bundle.init(),
        auc=(torch.from_numpy(inputs["labels"][block]), torch.from_numpy(inputs["preds"][block])),
        loss=(torch.from_numpy(inputs["preds"][block]),),
    )
    out["metrics"] = {k: float(v) for k, v in bundle.result(st).items()}

    # the tensor-parallel modules over model = 4 against one device
    out["tp"] = {}
    mesh = meshes[(1, 4)]
    for name in TP_MODULES:
        module = _tp_module(name, mesh)
        x = torch.from_numpy(inputs["tp_x"][name]).requires_grad_()
        y = module(x)
        (y * torch.from_numpy(inputs["tp_cot"][name])).sum().backward()
        params = dict(module.named_parameters())
        out["tp"][name] = {
            "y": _np(y), "dx": _np(x.grad),
            "shapes": {n: tuple(p.shape) for n, p in params.items()},
            "params": {n: _np(t) for n, t in whole_tensors(module).items()},
            "grads": {n: _np(t) for n, t in whole_tensors(
                module, {n: p.grad for n, p in params.items()}).items()},
        }
    return out


# name → (class, args): sizes that split (a gather after an odd column layer
# in the MLP and the bank), that do not (the MLP's width 6, so its rows and
# the next layer's stay whole), heads split within a head (2 of 8 over 4)
# and whole heads (4 of 4)
TP_MODULES = {
    "mlp": ("MLP", (12, (16, 8, 4))),
    "mlp_uneven": ("MLP", (12, (6, 8))),
    "experts": ("ExpertBank", (12, 3, (16, 8, 4))),
    "mha_split_heads": ("MultiHeadAttention", (8, 2, 8)),
    "mha_whole_heads": ("MultiHeadAttention", (8, 4, 4)),
}
# input and output shapes
TP_SHAPES = {"mlp": ((6, 12), (6, 4)), "mlp_uneven": ((6, 12), (6, 8)),
             "experts": ((6, 12), (6, 3, 4)), "mha_split_heads": ((3, 5, 8), (3, 5, 8)),
             "mha_whole_heads": ((3, 5, 8), (3, 5, 8))}


def _tp_module(name, mesh=None):
    """The module of ``TP_MODULES[name]`` from seed 0, fp32, placed on
    ``mesh`` (tensor parallel over its 'model' axis) when there is one, its
    biases set to fixed nonzero values."""
    from tpurec_torch.initializers import init_parameters
    from tpurec_torch.models.multitask import ExpertBank
    from tpurec_torch.ops.attention import MultiHeadAttention
    from tpurec_torch.ops.mlp import MLP

    cls, args = TP_MODULES[name]
    kw = {"tp_axis": "model"} if cls == "MLP" else {}
    module = {"MLP": MLP, "ExpertBank": ExpertBank, "MultiHeadAttention": MultiHeadAttention}[cls](
        *args, **kw)
    if mesh is not None:
        module.place(mesh)
    init_parameters(module, 0)
    # nonzero biases (they start at zero), so a bias added on every rank
    # before the sum over 'model' shows
    from tpurec_torch.core.collectives import local_share
    from tpurec_torch.models.registry import sharded_weights

    shards = sharded_weights(module)
    with torch.no_grad():
        for n, p in module.named_parameters():
            if n.split(".")[-1] == "bias" or n.split(".")[-1].startswith("b_"):
                shape = list(p.shape)
                if n in shards:
                    shape[shards[n][0]] *= mesh.n_model
                whole = 0.1 * torch.sin(torch.arange(float(np.prod(shape)))).reshape(shape)
                p.copy_(local_share(whole, shards[n][0], mesh) if n in shards else whole)
    return module


CASES = {"ops": _ops_world}


# --------------------------------------------------------------------------
# the pytest side
def _inputs():
    rng = np.random.default_rng(0)
    b, l, d, h = 8, 16, 8, 6
    mask = (rng.random((b, l)) < 0.7).astype(np.float32)
    mask[3] = 0.0  # a row with no valid step anywhere
    mask[5, 4:] = 0.0  # a row whose steps are all on the first rank
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "table": f32(128, 4),
        "ids": rng.integers(0, 128, size=(8, 3)),
        "cot": f32(8, 3, 4),
        "cp": {
            "query": f32(b, d), "keys": f32(b, l, d), "values": f32(b, l, d), "mask": mask,
            "w1": f32(4 * d, h) * 0.3, "b1": f32(h), "w2": f32(h), "alpha": f32(h),
            "cot_pooled": f32(b, d), "cot_scores": f32(b, l),
        },
        "bn_x": f32(16, 5) * 2.0 + 1.0,
        "bn_cot": f32(16, 5),
        "labels": rng.integers(0, 2, size=(64,)).astype(np.float32),
        "preds": rng.random(64).astype(np.float32),
        "tp_x": {n: f32(*shapes[0]) for n, shapes in TP_SHAPES.items()},
        "tp_cot": {n: f32(*shapes[1]) for n, shapes in TP_SHAPES.items()},
    }


@pytest.fixture(scope="module")
def ops(tmp_path_factory):
    inputs = _inputs()
    results = shared_world(
        tmp_path_factory, "torch_mesh_ops",
        lambda d: run_world(os.path.abspath(__file__), "ops", 4, d, inputs),
    )
    return inputs, results


def test_make_mesh_without_a_world_matches_jax():
    """Without a world the mesh is (1, 1), and a mesh of more ranks than
    the world has raises the JAX package's errors, in its words."""
    import jax

    from tpurec.config import MeshConfig as JMeshConfig
    from tpurec.core.mesh import make_mesh as jmake_mesh

    ctx = make_mesh()
    assert (ctx.n_data, ctx.n_model, ctx.n_devices, ctx.data_group, ctx.model_group) == (
        1, 1, 1, None, None
    )
    for cfg in (dict(model=2), dict(data=2), dict(data=3, model=1)):
        with pytest.raises(ValueError) as want:
            jmake_mesh(JMeshConfig(**cfg), devices=jax.devices()[:1])
        with pytest.raises(ValueError) as got:
            make_mesh(MeshConfig(**cfg))
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("layout", MESHES + ((-1, 2),))
def test_mesh_layout_matches_jax(ops, layout):
    """Rank r sits where device r sits in the JAX package's mesh of four
    devices."""
    import jax

    from tpurec.config import MeshConfig as JMeshConfig
    from tpurec.core.mesh import make_mesh as jmake_mesh

    jmesh = jmake_mesh(JMeshConfig(data=layout[0], model=layout[1]), devices=jax.devices()[:4])
    ids = np.vectorize(lambda dev: dev.id)(jmesh.mesh.devices)
    for rank, res in enumerate(ops[1]):
        n_data, n_model, d, m = res["layouts"][layout]
        assert (n_data, n_model) == ids.shape
        assert ids[d, m] == jax.devices()[rank].id


def test_psum_backward_is_identity(ops):
    """``psum``'s gradient is the rank's own cotangent, not its sum over the
    axis; ``replicated_input``'s is the sum; ``pmax`` is the max."""
    for rank, res in enumerate(ops[1]):
        p = res["psum"]
        np.testing.assert_array_equal(p["value"], np.full(3, 10.0))
        np.testing.assert_array_equal(p["grad"], [1.0, 2.0, 3.0])  # 4x if it all-reduced
        np.testing.assert_array_equal(p["replicated_grad"], np.full(3, 10.0))
        np.testing.assert_array_equal(p["max"], [3.0, 0.0])


@pytest.mark.parametrize("layout", [(1, 4), (2, 2)])
def test_row_sharded_lookup_matches_jax(ops, layout):
    """Rows and the table's gradient against the JAX package's
    ``row_sharded_lookup`` on the same mesh of four CPU devices: exact (a
    sum of one row and zeros)."""
    import jax
    import jax.numpy as jnp

    from tpurec.config import MeshConfig as JMeshConfig
    from tpurec.core.mesh import make_mesh as jmake_mesh
    from tpurec.embedding.ops import row_sharded_lookup as jlookup

    inputs, results = ops
    mesh = jmake_mesh(JMeshConfig(data=layout[0], model=layout[1]), devices=jax.devices()[:4]).mesh
    table, ids, cot = (jnp.asarray(inputs[k]) for k in ("table", "ids", "cot"))
    rows = np.asarray(jlookup(table, ids, mesh))
    grad = np.asarray(jax.grad(lambda t: jnp.sum(jlookup(t, ids, mesh) * cot))(table))
    n_data, n_model = layout
    v_loc = table.shape[0] // n_model
    for rank, res in enumerate(results):
        d, m = rank // n_model, rank % n_model
        k = ids.shape[0] // n_data
        got = res["lookup"][layout]
        np.testing.assert_array_equal(got["rows"], rows[d * k : (d + 1) * k])
        np.testing.assert_array_equal(got["grad"], grad[m * v_loc : (m + 1) * v_loc])


def test_row_sharded_lookup_refuses_uneven_vocab(ops):
    import jax
    import jax.numpy as jnp

    from tpurec.config import MeshConfig as JMeshConfig
    from tpurec.core.mesh import make_mesh as jmake_mesh
    from tpurec.embedding.ops import row_sharded_lookup as jlookup

    mesh = jmake_mesh(JMeshConfig(data=1, model=4), devices=jax.devices()[:4]).mesh
    with pytest.raises(ValueError) as want:
        jlookup(jnp.zeros((10, 2)), jnp.zeros((4,), jnp.int32), mesh)
    for res in ops[1]:
        assert res["uneven"] == str(want.value)


def _jax_cp(inputs):
    import jax
    import jax.numpy as jnp

    from tpurec.config import MeshConfig as JMeshConfig
    from tpurec.core.mesh import make_mesh as jmake_mesh
    from tpurec.ops.attention_cp import din_attention_cp, softmax_attention_cp

    mesh = jmake_mesh(JMeshConfig(data=1, model=4), devices=jax.devices()[:4]).mesh
    a = {k: jnp.asarray(v) for k, v in inputs["cp"].items()}
    names = ("query", "keys", "w1", "b1", "w2", "alpha")

    def din(*args):
        kw = dict(zip(names, args))
        return din_attention_cp(kw["query"], kw["keys"], a["mask"], kw["w1"], kw["b1"],
                                kw["w2"], kw["alpha"], mesh)

    def din_loss(*args):
        pooled, scores = din(*args)
        return jnp.sum(pooled * a["cot_pooled"]) + jnp.sum(scores * a["cot_scores"])

    args = tuple(a[n] for n in names)
    pooled, scores = din(*args)
    grads = jax.grad(din_loss, argnums=tuple(range(len(names))))(*args)

    spooled = softmax_attention_cp(a["query"], a["keys"], a["values"], a["mask"], mesh)

    def soft(q, k, v):
        # the same pooling over the whole sequence on one device: the JAX
        # function's pmax has no differentiation rule
        logits = jnp.einsum("bd,bld->bl", q, k) / float(k.shape[-1]) ** 0.5
        valid = a["mask"].astype(bool)
        logits = jnp.where(valid, logits, -jnp.inf)
        gmax = jax.lax.stop_gradient(jnp.max(logits, axis=-1))
        gmax = jnp.where(jnp.isfinite(gmax), gmax, 0.0)
        w = jnp.where(valid, jnp.exp(logits - gmax[:, None]), 0.0)
        num = jnp.einsum("bl,bld->bd", w, v)
        return num / jnp.maximum(jnp.sum(w, axis=-1), 1e-9)[:, None]

    sgrads = jax.grad(lambda *x: jnp.sum(soft(*x) * a["cot_pooled"]), argnums=(0, 1, 2))(
        a["query"], a["keys"], a["values"]
    )
    din_out = {"pooled": pooled, "scores": scores, **{f"d{n}": g for n, g in zip(names, grads)}}
    soft_out = {"pooled": spooled, "dquery": sgrads[0], "dkeys": sgrads[1], "dvalues": sgrads[2]}
    return (jax.tree.map(np.asarray, din_out), jax.tree.map(np.asarray, soft_out))


@pytest.fixture(scope="module")
def jax_cp(ops):
    """The JAX package's two CP functions and their gradients, once."""
    return _jax_cp(ops[0])


def test_din_attention_cp_matches_jax(ops, jax_cp):
    """Each rank's quarter of the steps through ``DinAttention``, the pool
    summed over 'model': pooled, the rank's scores, and every gradient
    against ``jax.grad`` of the JAX package's ``din_attention_cp`` (row 3
    has no valid step, row 5 only on the first rank)."""
    inputs, results = ops
    want, _ = jax_cp
    lk = inputs["cp"]["keys"].shape[1] // 4
    for m, res in enumerate(results):
        got = res["din_cp"]
        steps = slice(m * lk, (m + 1) * lk)
        np.testing.assert_allclose(got["pooled"], want["pooled"], **GRAD_TOL)
        np.testing.assert_allclose(got["scores"], want["scores"][:, steps], **GRAD_TOL)
        np.testing.assert_allclose(got["dkeys"], want["dkeys"][:, steps], **GRAD_TOL)
        for n in ("query", "w1", "b1", "w2", "alpha"):
            np.testing.assert_allclose(got[f"d{n}"], want[f"d{n}"], **GRAD_TOL,
                                       err_msg=n)
        np.testing.assert_array_equal(got["pooled"][3], 0.0)


def test_softmax_attention_cp_matches_jax(ops, jax_cp):
    """The two-pass softmax pool over four ranks' steps against the JAX
    package's, and its gradients against ``jax.grad`` of the same pool over
    the whole sequence on one device (the JAX function's ``pmax`` has no
    differentiation rule); the row with no valid step gives zeros."""
    inputs, results = ops
    _, want = jax_cp
    lk = inputs["cp"]["keys"].shape[1] // 4
    for m, res in enumerate(results):
        got = res["softmax_cp"]
        steps = slice(m * lk, (m + 1) * lk)
        np.testing.assert_allclose(got["pooled"], want["pooled"], **TOL)
        np.testing.assert_allclose(got["dquery"], want["dquery"], **GRAD_TOL)
        np.testing.assert_allclose(got["dkeys"], want["dkeys"][:, steps], **GRAD_TOL)
        np.testing.assert_allclose(got["dvalues"], want["dvalues"][:, steps], **GRAD_TOL)
        np.testing.assert_array_equal(got["pooled"][3], 0.0)


@pytest.mark.parametrize("name", ["bn", "dice"])
def test_batch_moments_are_global_over_data(ops, name):
    """``BatchNorm`` and ``Dice`` on four data ranks' blocks equal the
    one-device module on the whole batch: outputs, the input's gradient,
    the parameters' gradients summed over 'data', and the running
    statistics (fp32 sums in another order: 1e-6)."""
    from tpurec_torch.ops.mlp import BatchNorm, Dice

    inputs, results = ops
    module = BatchNorm(5) if name == "bn" else Dice(5)
    torch.manual_seed(0)
    for p in module.parameters():
        torch.nn.init.uniform_(p, 0.5, 1.5)
    x = torch.from_numpy(inputs["bn_x"]).requires_grad_()
    y = module.train()(x)
    (y * torch.from_numpy(inputs["bn_cot"])).sum().backward()
    bn = module if name == "bn" else module.bn
    k = x.shape[0] // 4
    for d, res in enumerate(results):
        got = res["norm"][name]
        block = slice(d * k, (d + 1) * k)
        np.testing.assert_allclose(got["y"], _np(y)[block], **TOL)
        np.testing.assert_allclose(got["dx"], _np(x.grad)[block], **TOL)
        np.testing.assert_allclose(got["running_mean"], _np(bn.running_mean), **TOL)
        np.testing.assert_allclose(got["running_var"], _np(bn.running_var), **TOL)
        for n, p in module.named_parameters():
            np.testing.assert_allclose(got[f"d{n}"], _np(p.grad), **GRAD_TOL)


# the parameters each rank holds a quarter of (the rest stay whole)
TP_SPLIT = {
    "mlp": {"dense_0.weight": 0, "dense_0.bias": 0, "dense_1.weight": 1, "dense_2.weight": 0,
            "dense_2.bias": 0},
    "mlp_uneven": {},
    "experts": {"w_0": 2, "b_0": 1, "w_1": 1, "w_2": 2, "b_2": 1},
    "mha_split_heads": {"q.weight": 0, "k.weight": 0, "v.weight": 0, "out.weight": 1},
    "mha_whole_heads": {"q.weight": 0, "k.weight": 0, "v.weight": 0, "out.weight": 1},
}


@pytest.mark.parametrize("name", list(TP_MODULES))
def test_tensor_parallel_modules_equal_one_device(ops, name):
    """An ``MLP`` with ``tp_axis``, an ``ExpertBank`` and a
    ``MultiHeadAttention`` placed over model = 4: each rank holds a quarter
    of each split parameter on its split axis (as the JAX package
    partitions them; a width of 6 stays whole), the shares gather to the
    one-device initialisation from the same seed bit for bit (the biases
    then set alike), and the
    output, the input's gradient and every parameter's gradient (gathered)
    equal the one-device module's (fp32 sums in another order)."""
    inputs, results = ops
    module = _tp_module(name)
    x = torch.from_numpy(inputs["tp_x"][name]).requires_grad_()
    y = module(x)
    (y * torch.from_numpy(inputs["tp_cot"][name])).sum().backward()
    whole = dict(module.named_parameters())
    for res in results:
        got = res["tp"][name]
        for n, p in whole.items():
            shape = list(p.shape)
            if n in TP_SPLIT[name]:
                shape[TP_SPLIT[name][n]] //= 4
            assert got["shapes"][n] == tuple(shape), n
            np.testing.assert_array_equal(got["params"][n], _np(p), err_msg=n)
            np.testing.assert_allclose(got["grads"][n], _np(p.grad), **TOL, err_msg=n)
        np.testing.assert_allclose(got["y"], _np(y), **TOL)
        np.testing.assert_allclose(got["dx"], _np(x.grad), **TOL)


def test_metrics_are_global_over_data(ops):
    """AUC and Mean states updated with each data rank's rows and summed over
    'data' give the whole batch's results."""
    from tpurec_torch.core.metrics import AUC, Mean, MetricBundle

    inputs, results = ops
    bundle = MetricBundle({"auc": AUC(), "loss": Mean()})
    st = bundle.update(
        bundle.init(),
        auc=(torch.from_numpy(inputs["labels"]), torch.from_numpy(inputs["preds"])),
        loss=(torch.from_numpy(inputs["preds"]),),
    )
    want = {k: float(v) for k, v in bundle.result(st).items()}
    for res in results:
        assert res["metrics"]["auc"] == pytest.approx(want["auc"], abs=1e-6)
        assert res["metrics"]["loss"] == pytest.approx(want["loss"], abs=1e-6)


if __name__ == "__main__":
    rank_main(CASES)
