"""The PyTorch port's modules and models against the JAX package on the CPU.

The JAX model is initialised, its variables go through
``tpurec_torch.bridge`` into the port, and both run the same numpy batch.
Tolerances: fp32 outputs agree to atol/rtol 1e-5 (the frameworks sum in
different orders); with bf16 dense compute the probabilities agree to atol
2e-2 (bf16 keeps ~3 significant digits and the two frameworks round at
different points).
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from __graft_entry__ import _tiny_dataset
from tpurec.config import EmbeddingConfig as JEmbeddingConfig
from tpurec.config import ModelConfig as JModelConfig
from tpurec.data.schema import DataInfo as JDataInfo
from tpurec.models import build_model as jax_build_model
from tpurec_torch.bridge import params_from_jax
from tpurec_torch.config import EmbeddingConfig, ModelConfig
from tpurec_torch.data.schema import DataInfo
from tpurec_torch.embedding.ops import pad_vocab
from tpurec_torch.models import build_model

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _numpy_tree(variables):
    """Unboxed numpy variables, without the init-time 'regularization' sow
    (the JAX package never exports it either)."""
    variables = {k: v for k, v in fnn.unbox(variables).items() if k != "regularization"}
    return jax.tree.map(np.asarray, variables)


def _tabular(seed=0, batch=16):
    """4 user + 4 item fields of 50 ids each."""
    names = [f"f{i}" for i in range(8)]
    kw = dict(user_features=names[:4], item_features=names[4:])
    rng = np.random.default_rng(seed)
    data = {n: rng.integers(50 * i, 50 * i + 50, size=(batch,)) for i, n in enumerate(names)}
    return JDataInfo.from_dims(names, [50] * 8, **kw), DataInfo.from_dims(names, [50] * 8, **kw), data


def _schemas(name):
    if name == "din":
        jinfo, batch = _tiny_dataset(batch=16, seq_len=16)
        info = DataInfo(**{k: getattr(jinfo, k) for k in DataInfo.__dataclass_fields__})
        return jinfo, info, {k: v for k, v in batch.items() if k != "label"}
    return _tabular()


def _pair(name, jax_params=None, port_params=None, dim=8):
    """(jax model, its numpy variables, port model with the same weights, batch)."""
    jinfo, info, batch = _schemas(name)
    jmodel = jax_build_model(
        JModelConfig(name=name, params=jax_params or {}, embedding=JEmbeddingConfig(dim=dim)), jinfo
    )
    variables = _numpy_tree(jmodel.init(jax.random.key(0), {k: jnp.asarray(v) for k, v in batch.items()}))
    model = build_model(
        ModelConfig(name=name, params=port_params or {}, embedding=EmbeddingConfig(dim=dim)),
        info, device="cpu",
    )
    params_from_jax(model, variables)
    return jmodel, variables, model.eval(), batch


def _run_both(jmodel, variables, model, batch):
    want = jmodel.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()}, train=False)
    with torch.inference_mode():
        got = model({k: torch.as_tensor(v) for k, v in batch.items()})
    return got, want


MODELS = ["din", "deepfm", "fm", "dssm_double"]


@pytest.mark.parametrize("name", MODELS)
def test_model_matches_jax_fp32(name):
    got, want = _run_both(*_pair(name))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(want[key], np.float32), err_msg=key, **TOL
        )


@pytest.mark.parametrize("name", MODELS)
def test_model_matches_jax_bf16_compute(name):
    got, want = _run_both(
        *_pair(name, jax_params={"dtype": jnp.bfloat16}, port_params={"dtype": "bfloat16"})
    )
    out = got["output"]
    assert out.dtype == torch.float32 and torch.all((out >= 0) & (out <= 1))
    np.testing.assert_allclose(out.numpy(), np.asarray(want["output"]), atol=2e-2, rtol=0)


def test_din_nontrivial_weights_match_jax():
    """DIN with all weights redrawn at scale 0.5, so attention and MLP terms
    are far from the near-zero init."""
    jmodel, variables, _, batch = _pair("din")
    rng = np.random.default_rng(7)
    variables = jax.tree.map(lambda a: (0.5 * rng.normal(size=a.shape)).astype(np.float32), variables)
    _, info, _ = _schemas("din")
    model = build_model(ModelConfig(name="din", embedding=EmbeddingConfig(dim=8)), info, device="cpu")
    params_from_jax(model, variables)
    got, want = _run_both(jmodel, variables, model.eval(), batch)
    np.testing.assert_allclose(got["logit"].numpy(), np.asarray(want["logit"]), **TOL)
    assert np.std(np.asarray(want["logit"])) > 0.1


@pytest.mark.parametrize("vocab", [0, 1, 84, 85, 127, 128, 20_000, 2_080_000])
@pytest.mark.parametrize("n_model", [1, 2])
def test_pad_vocab_matches_jax(vocab, n_model):
    from tpurec.embedding.ops import pad_vocab as jax_pad_vocab

    assert pad_vocab(vocab, n_model) == jax_pad_vocab(vocab, n_model)
    assert pad_vocab(vocab, n_model) > vocab and pad_vocab(vocab, n_model) % (128 * n_model) == 0


@pytest.mark.parametrize("name", MODELS)
def test_param_shapes_match_jax(name):
    """Every flax leaf has a port param of the same shape (Dense kernels
    transposed) and nothing is left over on either side."""
    _, variables, model, _ = _pair(name)
    port = model.state_dict()
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    assert len(flat) == len(port)
    for path, leaf in flat:
        keys = [p.key for p in path]
        name_ = "weight" if keys[-1] == "kernel" else keys[-1]
        shape = leaf.shape[::-1] if keys[-1] == "kernel" else leaf.shape
        assert tuple(port[".".join(keys[:-1] + [name_])].shape) == shape, keys
    assert pad_vocab(_schemas(name)[1].total_dims) in {t.shape[0] for t in port.values() if t.dim() == 2}


def test_bridge_raises_on_unmatched_and_missing():
    _, variables, model, _ = _pair("deepfm")
    _, _, fm_model, _ = _pair("fm")
    with pytest.raises(RuntimeError, match="Unexpected"):
        params_from_jax(fm_model, variables)  # deepfm's deep tower has no home in fm
    extra = {"params": {**variables["params"], "stray": {"kernel": np.zeros((2, 2))}}}
    with pytest.raises(RuntimeError, match="Unexpected"):
        params_from_jax(model, extra)
    lacking = {"params": {k: v for k, v in variables["params"].items() if k != "deep_head"}}
    with pytest.raises(RuntimeError, match="Missing"):
        params_from_jax(model, lacking)
    odd_leaf = {"params": {**variables["params"], "bias": {"odd": np.zeros(())}}}
    with pytest.raises(KeyError, match="unmatched param leaf"):
        params_from_jax(model, odd_leaf)
    with pytest.raises(KeyError, match="collections"):
        params_from_jax(model, {**variables, "cache": {}})
    wrong = jax.tree.map(lambda a: a, variables)
    wrong["params"]["deep_head"]["kernel"] = np.zeros((3, 1), np.float32)
    with pytest.raises(RuntimeError, match="size mismatch"):
        params_from_jax(model, wrong)
    assert params_from_jax(model, variables) is model


@pytest.mark.parametrize(
    "kw",
    [
        dict(hidden_dims=(12, 6), activation="relu"),
        dict(hidden_dims=(12, 6), activation="prelu", out_activation="linear"),
        dict(hidden_dims=(12, 6), activation="dice"),
        dict(hidden_dims=(12, 6, 3), activation="relu", out_activation="linear"),
        dict(hidden_dims=(12, 6), activation="dice", out_activation="prelu"),
    ],
    ids=["relu", "prelu-linear", "dice", "relu-linear", "dice-prelu"],
)
def test_mlp_matches_jax(kw):
    """``ops.mlp.MLP`` with PReLU/Dice in eval mode; the weights and Dice's
    running statistics are redrawn so the normalisation does work."""
    from tpurec.ops.mlp import MLP as JMLP
    from tpurec_torch.ops.mlp import MLP

    rng = np.random.default_rng(4)
    x = rng.normal(size=(16, 5, 10)).astype(np.float32)
    jm = JMLP(**kw)
    variables = _numpy_tree(jm.init(jax.random.key(1), jnp.asarray(x), train=False))
    variables = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32), variables
    )
    model = params_from_jax(MLP(10, **kw).eval(), variables)
    want = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(activation="relu"),
        dict(hidden_dims=(16, 8), activation="dice"),
        dict(hidden_dims=(6,), activation="prelu", use_outer_product=True),
    ],
    ids=["kernel-prelu", "kernel-relu", "mlp-form", "outer-product"],
)
def test_din_target_attention_matches_jax(kw):
    """Both forms of ``DinTargetAttention``; scores stay fp32, pooled keeps the
    keys' dtype."""
    from tpurec.ops.attention import DinTargetAttention as JAtt
    from tpurec_torch.ops.attention import DinTargetAttention

    rng = np.random.default_rng(5)
    q = rng.normal(size=(8, 6)).astype(np.float32)
    k = rng.normal(size=(8, 10, 6)).astype(np.float32)
    m = (rng.random((8, 10)) < 0.7).astype(np.float32)
    ja = JAtt(**kw)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(m))
    variables = _numpy_tree(ja.init(jax.random.key(2), *jargs))
    variables = jax.tree.map(lambda a: (0.5 * rng.normal(size=a.shape)).astype(np.float32), variables)
    att = params_from_jax(DinTargetAttention(6, **kw).eval(), variables)
    want_p, want_s = ja.apply(variables, *jargs)
    with torch.inference_mode():
        got_p, got_s = att(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(m))
    assert got_s.dtype == torch.float32
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


def test_entry_points_refuse_missing_cuda(tmp_path):
    """``cuda`` is the default device and is never replaced by the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal is checked where it has none")
    from tpurec_torch.serving import OfflineIndexer
    from tpurec_torch.config import ExperimentConfig
    from tpurec_torch.serving.server import RecommendService
    from tpurec_torch.train.trainer import Trainer

    _, info, _ = _tabular()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(ModelConfig(name="fm"), info)
    with pytest.raises(RuntimeError, match="CUDA"):
        RecommendService()
    with pytest.raises(RuntimeError, match="CUDA"):
        OfflineIndexer(None, None, {}, {}, [], [])
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(ExperimentConfig(model=ModelConfig(name="fm")), info)
    with pytest.raises(RuntimeError, match="CUDA"):
        RecommendService(item_categories=[0, 1])


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|tpurec)(\.|\s|$)", re.M)


def test_port_never_imports_jax_or_tpurec():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "tpurec_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            assert not _FORBIDDEN.search(f.read()), path
    code = (
        "import sys, tpurec_torch.serving.server, tpurec_torch.serving.export, "
        "tpurec_torch.bridge, tpurec_torch.models.builders, tpurec_torch.train.trainer; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'tpurec')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
