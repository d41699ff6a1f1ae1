"""The port's command line, its result stores and its top-k order, on the CPU.

- The journey of the README through ``tpurec_torch.cli.main``, with
  ``TPUREC_PLATFORM=cpu``: synth → datagen → train (fm and dssm_double,
  dim 4, batch 128, fp32) → index → serve, the server built by
  ``build_server`` on an ephemeral port, one request per path. One
  ``python -m tpurec_torch.cli synth`` runs in a subprocess.
- The index over the tabular data, where items with the same three tags get
  the same embedding and so tie for every user: the port's ``kv_store.json``
  and ``topk_index.npz`` equal the JAX package's ``OfflineIndexer`` over the
  same dssm_double weights (bridged), tie order included, and an index that
  takes ``torch.topk`` fails that comparison.
- ``top_k`` against ``jax.lax.top_k`` on a grid of ties; ``retrieve_online``
  and SINE's prototype pick with tied rows against the JAX package.
- ``RedisKVStore``/``open_kv_store`` over a stub ``redis``, and the refusal
  of unknown ``TPUREC_PLATFORM`` values and of a card that is not there.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import threading
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from tpurec.config import EmbeddingConfig as JEmbeddingConfig
from tpurec.config import ModelConfig as JModelConfig
from tpurec.data import synthetic as jsynth
from tpurec.data.schema import DataInfo as JDataInfo
from tpurec.models import build_model as jax_build_model
from tpurec.serving import DictKVStore as JDictKVStore
from tpurec.serving import OfflineIndexer as JOfflineIndexer
from tpurec.serving import kvstore as jkvstore
from tpurec.serving.server import RecommendService as JRecommendService
from tpurec_torch import cli
from tpurec_torch.bridge import params_from_jax
from tpurec_torch.config import EmbeddingConfig, ModelConfig
from tpurec_torch.data.schema import DataInfo
from tpurec_torch.models import build_model
from tpurec_torch.ops.topk import top_k
from tpurec_torch.serving import indexer as pindexer
from tpurec_torch.serving import kvstore as pkvstore
from tpurec_torch.serving.server import RecommendService
from tpurec_torch.train.checkpoint import export_params

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_ATOL = 2e-6  # KV scores are written with 6 decimals: one rounding apart


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue()


def _train_config(path, name):
    cfg = {
        "model": {"name": name, "embedding": {"dim": 4}},
        "train": {"batch_size": 128, "epochs": 1, "log_every_steps": 0,
                  "compute_dtype": "float32"},
    }
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def journey(tmp_path_factory):
    root = tmp_path_factory.mktemp("journey")
    raw, data = str(root / "raw"), str(root / "data")
    runs = {name: str(root / name) for name in ("fm", "dssm_double")}
    index = str(root / "index")
    printed = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUREC_PLATFORM", "cpu")
        printed["synth"] = _run(["synth", "--family", "tabular", "--out", raw, "--n-events", "3000"])
        printed["datagen"] = _run(["datagen", "--family", "tabular", "--raw", raw, "--out", data])
        for name, workdir in runs.items():
            config = _train_config(str(root / f"{name}.json"), name)
            printed[name] = _run(["train", "--config", config, "--data", data, "--workdir", workdir])
        printed["index"] = _run(["index", "--export", os.path.join(runs["dssm_double"], "export"),
                                 "--data", data, "--out", index, "--topk", "20"])
        # a two-tower export answers every path; a ranker's has no tower
        servers = {
            name: cli.build_server(cli.parse_args([
                "serve", "--export", os.path.join(workdir, "export"), "--data", data,
                "--index", index, "--port", "0",
            ]))
            for name, workdir in runs.items()
        }
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers.values()]
    for t in threads:
        t.start()
    yield dict(raw=raw, data=data, runs=runs, index=index, printed=printed,
               ports={name: s.server_address[1] for name, s in servers.items()})
    for s in servers.values():
        s.shutdown()
        s.server_close()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()


def _post(port, request):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=json.dumps(request).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def test_cli_journey_prints_and_writes_what_tpurec_does(journey):
    p = journey["printed"]
    assert p["synth"] == f"wrote synthetic raw data to {journey['raw']}\n"
    info = DataInfo.load(journey["data"])
    assert p["datagen"] == f"wrote {journey['data']}: {info.total_dims} ids over 5 features\n"
    for name, workdir in journey["runs"].items():
        assert p[name].splitlines()[-1].startswith("best eval: {")
        report = json.load(open(os.path.join(workdir, "report.json")))
        assert np.isfinite(report["history"][0]["eval"]["loss"])
        assert sorted(os.listdir(os.path.join(workdir, "export"))) == ["export_meta.json", "params.pt"]
        assert os.listdir(os.path.join(workdir, "checkpoint"))
    users = json.load(open(os.path.join(journey["data"], "user_profile.json")))
    items = json.load(open(os.path.join(journey["data"], "item_profile.json")))
    assert p["index"] == f"indexed {len(users)} users x {len(items)} items → {journey['index']}\n"
    kv = json.load(open(os.path.join(journey["index"], "kv_store.json")))
    assert len(kv) == len(users)
    assert all(len(v.split("\t")[0].split(",")) == 20 for v in kv.values())


def test_cli_serve_answers_every_path(journey):
    towers, ranker = journey["ports"]["dssm_double"], journey["ports"]["fm"]
    uid = sorted(json.load(open(os.path.join(journey["data"], "user_profile.json"))))[0]
    kv = _post(towers, {"user_id": uid, "type": "retrieve", "source": "kv"})["result"]
    online = _post(towers, {"user_id": uid, "type": "retrieve", "topk": 20})["result"]
    assert len(kv) == len(online) == 20
    assert list(kv) == list(online)  # the same tower, corpus and tie order
    np.testing.assert_allclose(list(kv.values()), list(online.values()), atol=SCORE_ATOL, rtol=0)
    from_retrieval = _post(towers, {"user_id": uid, "type": "rank", "from_retrieval": True})["result"]
    assert set(from_retrieval) == set(online)
    assert _post(ranker, {"user_id": uid, "type": "retrieve", "source": "kv"})["result"] == kv
    for port in (ranker, towers):
        ranked = _post(port, {"user_id": uid, "type": "rank", "item_ids": list(kv)[:7]})["result"]
        assert set(ranked) == set(list(kv)[:7])
        assert list(ranked.values()) == sorted(ranked.values(), reverse=True)


def test_cli_module_runs_in_a_subprocess(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "tpurec_torch.cli", "synth", "--family", "sequence",
         "--out", str(tmp_path / "port"), "--n-events", "400", "--seed", "3"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, check=True,
    )
    assert out.stdout == f"wrote synthetic raw data to {tmp_path / 'port'}\n"
    jsynth.make_behavior_sequence_raw(str(tmp_path / "jax"), n_events=400, seed=3)
    for name in ("events.jsonl", "item_profiles.jsonl"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


@pytest.mark.parametrize("value,device", [(None, "cuda"), ("cuda", "cuda"), ("gpu", "cuda"),
                                          ("cpu", "cpu")])
def test_platform_device(monkeypatch, value, device):
    if value is None:
        monkeypatch.delenv("TPUREC_PLATFORM", raising=False)
    else:
        monkeypatch.setenv("TPUREC_PLATFORM", value)
    assert cli.platform_device() == device


@pytest.mark.parametrize("value", ["tpu", "CPU", "cuda:1", "metal"])
def test_unknown_platform_raises(monkeypatch, journey, value):
    monkeypatch.setenv("TPUREC_PLATFORM", value)
    with pytest.raises(ValueError, match="TPUREC_PLATFORM"):
        cli.platform_device()
    with pytest.raises(ValueError, match="TPUREC_PLATFORM"):
        cli.main(["index", "--export", os.path.join(journey["runs"]["dssm_double"], "export"),
                  "--data", journey["data"], "--out", "unused"])


def test_the_card_by_default_and_no_fallback(monkeypatch, journey, tmp_path):
    monkeypatch.delenv("TPUREC_PLATFORM", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a card is here: the default runs on it")
    export = os.path.join(journey["runs"]["dssm_double"], "export")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["index", "--export", export, "--data", journey["data"], "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["train", "--model", "fm", "--data", journey["data"]])
    assert not os.listdir(tmp_path)


# --------------------------------------------------------------------------
# the index with ties, against the JAX package
def _jax_dssm(info_dir):
    jinfo = JDataInfo.load(info_dir)
    sample = {n: jnp.full((2,), off) for n, off in zip(jinfo.feature_names, jinfo.feature_offsets)}
    jm = jax_build_model(JModelConfig(name="dssm_double", embedding=JEmbeddingConfig(dim=8)), jinfo)
    variables = fnn.unbox(jm.init(jax.random.key(0), sample))
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: (0.5 * rng.normal(size=a.shape)).astype(np.float32),
                          variables["params"])
    return jm, {"params": params}


def _tied_pairs(items, profile):
    seen, tied = {}, set()
    for i in items:
        key = tuple(profile[i])
        if key in seen:
            tied |= {i, seen[key]}
        seen.setdefault(key, i)
    return tied


@pytest.fixture(scope="module")
def tie_index(journey, tmp_path_factory):
    root = tmp_path_factory.mktemp("ties")
    data = journey["data"]
    jm, variables = _jax_dssm(data)
    info = DataInfo.load(data)
    model = build_model(ModelConfig(name="dssm_double", embedding=EmbeddingConfig(dim=8)), info,
                        device="cpu")
    params_from_jax(model, variables)
    export = str(root / "export")
    export_params(export, model.state_dict(),
                  {"model": "dssm_double", "model_params": {}, "embedding": {"dim": 8}})
    users = json.load(open(os.path.join(data, "user_profile.json")))
    items = json.load(open(os.path.join(data, "item_profile.json")))
    jinfo = JDataInfo.load(data)
    j_user = jax.jit(lambda b: jm.apply(variables, b, method=jm.user_embedding))
    j_item = jax.jit(lambda b: jm.apply(variables, b, method=jm.item_embedding))
    j_kv = JDictKVStore(str(root / "jax" / "kv_store.json"))
    JOfflineIndexer(j_user, j_item, users, items, jinfo.user_features, jinfo.item_features).run(
        str(root / "jax"), kv_store=j_kv, topk=20)
    j_kv.save()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUREC_PLATFORM", "cpu")
        _run(["index", "--export", export, "--data", data, "--out", str(root / "port"), "--topk", "20"])
        # the same index with torch.topk's order among equal scores
        mp.setattr(pindexer, "top_k", lambda x, k: torch.topk(x, k, dim=-1))
        _run(["index", "--export", export, "--data", data, "--out", str(root / "topk"), "--topk", "20"])
    return dict(root=root, items=items)


def _kv(path):
    with open(path) as f:
        return {k: (v.split("\t")[0].split(","), [float(s) for s in v.split("\t")[1].split(",")])
                for k, v in json.load(f).items()}


def _kv_mismatches(got, want):
    assert list(got) == list(want)
    bad = [k for k in want if got[k][0] != want[k][0]]
    for k in want:
        np.testing.assert_allclose(got[k][1], want[k][1], atol=SCORE_ATOL, rtol=0, err_msg=k)
    return bad


def test_index_with_ties_matches_jax(tie_index):
    root, items = tie_index["root"], tie_index["items"]
    want = _kv(root / "jax" / "kv_store.json")
    tied = _tied_pairs(list(items), items)
    assert len(tied) > 50  # items that share their three tags
    # some slate holds two tied items: the comparison sees the tie order
    with_ties = [k for k, (slate, _) in want.items() if len(set(slate) & tied) >= 2]
    assert len(with_ties) > 10
    assert _kv_mismatches(_kv(root / "port" / "kv_store.json"), want) == []
    port, jax_ = np.load(root / "port" / "topk_index.npz"), np.load(root / "jax" / "topk_index.npz")
    assert sorted(port.files) == sorted(jax_.files)
    for k in ("user_ids", "item_ids"):
        np.testing.assert_array_equal(port[k], jax_[k])
    for k in ("user_embeddings", "item_embeddings"):
        np.testing.assert_allclose(port[k], jax_[k], atol=1e-5, rtol=1e-5)


def test_index_with_torch_topk_order_fails_the_comparison(tie_index):
    root = tie_index["root"]
    bad = _kv_mismatches(_kv(root / "topk" / "kv_store.json"), _kv(root / "jax" / "kv_store.json"))
    assert len(bad) > 10


# --------------------------------------------------------------------------
# top_k against lax.top_k
TIE_ROW = np.array([1, 3, 3, 2, 3, 0] * 50, np.float32)


@pytest.mark.parametrize("k", range(1, 21))
def test_top_k_matches_lax_top_k_with_ties(k):
    rng = np.random.default_rng(k)
    grid = rng.integers(0, 4, size=(3, 5, 40)).astype(np.float32)  # ties in every row
    for x in (TIE_ROW, grid, np.concatenate([grid, -grid], axis=-1)):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_torch_topk_breaks_ties_otherwise():
    _, want = jax.lax.top_k(jnp.asarray(TIE_ROW), 5)
    assert np.asarray(want).tolist() == [1, 2, 4, 7, 8]
    _, idx = torch.topk(torch.from_numpy(TIE_ROW), 5)
    assert idx.tolist() != [1, 2, 4, 7, 8]


def test_top_k_values_carry_the_gradient():
    x = torch.tensor([[0.5, 2.0, 2.0, -1.0]], requires_grad=True)
    values, idx = top_k(x, 2)
    assert idx.tolist() == [[1, 2]]
    (values * torch.tensor([[3.0, 5.0]])).sum().backward()
    assert x.grad.tolist() == [[0.0, 3.0, 5.0, 0.0]]


def _signs(rng, n, d=8):
    """Rows with four entries of ±1: their norm is 2, so every cosine is a
    sum of ±1/4 and exact in any order, and equal rows tie exactly."""
    x = np.zeros((n, d), np.float32)
    for row in x:
        row[rng.choice(d, 4, replace=False)] = rng.choice([-1.0, 1.0], 4)
    return x


def test_retrieve_online_with_tied_items_matches_jax():
    rng = np.random.default_rng(5)
    users = _signs(rng, 6)
    corpus = _signs(rng, 60)  # nine values a score: ties everywhere
    item_ids = [f"i{j}" for j in range(60)]
    profile = {f"u{j}": [j] for j in range(6)}
    common = dict(user_profile=profile, user_feature_names=["f0"], item_ids=item_ids,
                  item_embeddings=corpus)
    j_svc = JRecommendService(user_tower=lambda b: jnp.asarray(users)[b["f0"]], **common)
    p_svc = RecommendService(user_tower=lambda b: torch.from_numpy(users)[b["f0"]], device="cpu",
                             **common)
    for uid in profile:
        want = j_svc.retrieve_online(uid, topk=20)
        got = p_svc.retrieve_online(uid, topk=20)
        assert list(got) == list(want)
        np.testing.assert_allclose(list(got.values()), list(want.values()), atol=1e-6)


def test_sine_prototype_pick_with_tied_rows_matches_jax(monkeypatch):
    schema = dict(
        feature_names=["item_id", "user_tag", "item_tag"], feature_dims=[100, 10, 12],
        feature_offsets=[1, 101, 111], total_dims=123, sequence_names=["history"],
        max_seq_length=16, padding_index=0, user_features=["user_tag"],
        item_features=["item_id", "item_tag"],
    )
    rng = np.random.default_rng(0)
    seq = rng.integers(1, 101, size=(6, 16))
    batch = {
        "item_id": rng.integers(1, 101, size=(6,)), "user_tag": rng.integers(101, 111, size=(6,)),
        "item_tag": rng.integers(111, 123, size=(6,)),
        "history": np.where(np.arange(16)[None, :] < rng.integers(2, 17, size=(6, 1)), seq, 0),
    }
    cfg = dict(name="sine", params={"pool_size": 12, "num_active": 3})
    jm = jax_build_model(JModelConfig(**cfg, embedding=JEmbeddingConfig(dim=8)), JDataInfo(**schema))
    variables = jax.tree.map(np.asarray, fnn.unbox(jm.init(jax.random.key(0), {
        k: jnp.asarray(v) for k, v in batch.items()})))
    variables = {k: v for k, v in variables.items() if k != "regularization"}
    pool = variables["params"]["interest_pool"]
    variables["params"]["interest_pool"] = np.repeat(pool[::2], 2, axis=0)  # rows tie in pairs
    model = build_model(ModelConfig(**cfg, embedding=EmbeddingConfig(dim=8)), DataInfo(**schema),
                        device="cpu")
    params_from_jax(model, variables)
    picks = {"jax": [], "port": []}
    lax_top_k = jax.lax.top_k

    def jax_pick(x, k):
        out = lax_top_k(x, k)
        picks["jax"].append(np.asarray(out[1]))
        return out

    def port_pick(x, k):
        out = top_k(x, k)
        picks["port"].append(out[1].numpy())
        return out

    monkeypatch.setattr(jax.lax, "top_k", jax_pick)
    monkeypatch.setattr(sys.modules[type(model).__module__], "top_k", port_pick)
    want = jm.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()}, train=False)
    with torch.inference_mode():
        got = model.eval()({k: torch.as_tensor(v) for k, v in batch.items()})
    assert len(picks["jax"]) == len(picks["port"]) == 1
    np.testing.assert_array_equal(picks["port"][0], picks["jax"][0])
    assert (picks["port"][0] % 2 == 0).any() and (picks["port"][0] % 2 == 1).any()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=1e-5,
                                   err_msg=k)


# --------------------------------------------------------------------------
# result stores
class _StubRedis:
    def __init__(self, host, port, db, decode_responses):
        self.where, self.data = (host, port, db, decode_responses), {}

    def set(self, key, value):
        self.data[key] = value

    def get(self, key):
        return self.data.get(key)


@pytest.mark.parametrize("kvstore", [pkvstore, jkvstore], ids=["port", "jax"])
def test_redis_kv_store_over_a_stub(monkeypatch, tmp_path, kvstore):
    monkeypatch.setitem(sys.modules, "redis", types.SimpleNamespace(StrictRedis=_StubRedis))
    store = kvstore.open_kv_store("redis://cache.local:7000")
    assert isinstance(store, kvstore.RedisKVStore)
    assert store._r.where == ("cache.local", 7000, 0, True)
    store.set("DSSM_u1", "i1,i2\t0.5,0.25")
    assert store.get("DSSM_u1") == "i1,i2\t0.5,0.25" and store.get("DSSM_u2") is None
    assert kvstore.open_kv_store("redis://")._r.where == ("localhost", 6379, 0, True)
    assert kvstore.RedisKVStore(db=2)._r.where == ("localhost", 6379, 2, True)
    kv = kvstore.open_kv_store(f"dict://{tmp_path / 'kv.json'}")
    kv.set("a", "b")
    kv.save()
    assert kvstore.open_kv_store(f"dict://{tmp_path / 'kv.json'}").get("a") == "b"
    assert kvstore.open_kv_store().path is None
    with pytest.raises(ValueError, match="unknown kv store"):
        kvstore.open_kv_store("memcached://x")


def test_redis_kv_store_needs_the_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "redis", None)
    with pytest.raises(ImportError):
        pkvstore.RedisKVStore()
