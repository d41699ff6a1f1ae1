"""The port's data package against the JAX package's on the CPU.

Both packages write from the same seed into their own directories, and the
files must be equal byte for byte: the synthetic raw files, the codec's
records and frames, and every generator's output directory (shards,
``data_info.json``, ``schema.json``, ``feature_dict.json`` and the profiles).
The port reads the CSV tables without pandas, so the typing rules pandas
applies on the way to a string key are held on a table made for them. The
loaders must yield the same batches; the native codec (built here from
``cpp/recordio.cc`` into ``build/recordio/``) and the Python codec must give
the same columns and checksums. Last, no module of the port, and not
``chip_smoke.py``, may import pandas, JAX, flax or the JAX package.
"""

import ast
import filecmp
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from tpurec.config import EmbeddingConfig as JEmbeddingConfig
from tpurec.config import ModelConfig as JModelConfig
from tpurec.data import crc32c as jcrc
from tpurec.data import example_proto as jproto
from tpurec.data import generators as jgen
from tpurec.data import inspect as jinspect
from tpurec.data import loader as jloader
from tpurec.data import recordio as jrecordio
from tpurec.data import synthetic as jsynth
from tpurec.data.schema import DataInfo as JDataInfo
from tpurec.data.schema import FeatureEncoder as JFeatureEncoder
from tpurec.models import build_model as jax_build_model
from tpurec.train.checkpoint import export_params as jax_export_params
from tpurec_torch.bridge import params_from_jax
from tpurec_torch.config import EmbeddingConfig, ModelConfig
from tpurec_torch.data import crc32c as pcrc
from tpurec_torch.data import example_proto as pproto
from tpurec_torch.data import generators as pgen
from tpurec_torch.data import inspect as pinspect
from tpurec_torch.data import loader as ploader
from tpurec_torch.data import native as pnative
from tpurec_torch.data import recordio as precordio
from tpurec_torch.data import synthetic as psynth
from tpurec_torch.data.schema import DataInfo, FeatureEncoder
from tpurec_torch.models import build_model
from tpurec_torch.train.checkpoint import export_params

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _same_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert names
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name


@pytest.fixture
def python_codec(monkeypatch):
    """The port with its native library hidden: the Python tiers."""
    monkeypatch.setattr(pcrc, "_load_native", lambda: None)
    monkeypatch.setattr(pnative, "_load_native", lambda: None)


# --------------------------------------------------------------------------
# codec
FEATURES = {
    "ids": np.array([3, -1, 2**40, 0], np.int64),
    "one": np.array([7], np.int64),
    "scores": np.array([0.5, -1.25e-3, 3.0e8], np.float32),
    "names": [b"u17", "it1_3"],
    "grid": np.arange(6, dtype=np.int32).reshape(2, 3),
    "list_ints": [1, 2, 3],
    "list_floats": [0.1, 2.5],
    "empty": [],
}


def test_example_and_sequence_example_bytes_match_jax():
    assert pproto.encode_example(FEATURES) == jproto.encode_example(FEATURES)
    context = {"user": [5], "tag": [b"x"]}
    sequences = {"history": [[1], [2], [3]], "weights": [[0.5, 0.25], [1.0, 2.0]]}
    got = pproto.encode_sequence_example(context, sequences)
    assert got == jproto.encode_sequence_example(context, sequences)
    ctx, seqs = pproto.decode_sequence_example(got)
    np.testing.assert_array_equal(ctx["user"], [5])
    np.testing.assert_array_equal(seqs["weights"][1], np.float32([1.0, 2.0]))
    decoded = pproto.decode_example(pproto.encode_example(FEATURES))
    np.testing.assert_array_equal(decoded["grid"], np.arange(6))
    np.testing.assert_array_equal(decoded["ids"], FEATURES["ids"])
    assert list(decoded["names"]) == [b"u17", b"it1_3"]


MESSAGES = [b"", b"a", b"123456789", bytes(range(256)) * 3, os.urandom(1000)]


@pytest.mark.parametrize("tier", ["native", "python"])
def test_crc32c_matches_jax(tier, request):
    if tier == "python":
        request.getfixturevalue("python_codec")
    else:
        assert pnative.native_available(), "librecordio.so did not build"
    want = [jcrc.crc32c(m) for m in MESSAGES]
    assert [pcrc.crc32c(m) for m in MESSAGES] == want
    assert pcrc.crc32c_batch(MESSAGES) == want
    assert pcrc.crc32c(b"123456789") == 0xE3069283  # the Castagnoli check value
    assert [pcrc.masked_crc32c(m) for m in MESSAGES] == [jcrc.masked_crc32c(m) for m in MESSAGES]
    assert all(pcrc.unmask(pcrc.mask(c)) == c for c in want)
    assert pcrc.crc32c_python(MESSAGES[3]) == want[3]


def test_native_functions_declare_their_signatures():
    """Each function of the library is called with its C signature. Without
    one, ctypes passes every Python int as a C int where the library takes a
    ``long``, and the encoder crashed on the GPU machine."""
    import ctypes

    lib = pnative._native()
    assert lib is not None
    for name in ("tfrecord_index", "tfrecord_decode_columnar", "tfrecord_encode_columnar"):
        fn = getattr(lib, name)
        assert fn.restype is ctypes.c_long and fn.argtypes, name
        assert ctypes.c_long in fn.argtypes, name
    assert lib.crc32c.argtypes == [ctypes.c_char_p, ctypes.c_size_t]


@pytest.mark.parametrize("tier", ["native", "python"])
def test_frames_and_writers_match_jax(tier, tmp_path, request):
    if tier == "python":
        request.getfixturevalue("python_codec")
    records = [pproto.encode_example({"i": [k], "f": [0.5 * k]}) for k in range(7)]
    assert precordio.frame_record(records[3]) == jrecordio.frame_record(records[3])
    for pkg, recordio in (("j", jrecordio), ("p", precordio)):
        with recordio.TFRecordWriter(str(tmp_path / pkg / "one.tfrecord"), flush_every=3) as w:
            for r in records:
                w.write(r)
        with recordio.ShardedTFRecordWriter(str(tmp_path / pkg / "sharded"), records_per_file=3) as w:
            for k, r in enumerate(records):
                w.write(r, "test" if k % 3 == 0 else "train")
        recordio.write_columnar_shards(
            str(tmp_path / pkg / "columnar"), "train",
            {"a": np.arange(5, dtype=np.int64), "b": np.linspace(0, 1, 10, dtype=np.float32).reshape(5, 2)},
            records_per_file=2,
        )
    assert filecmp.cmp(tmp_path / "j" / "one.tfrecord", tmp_path / "p" / "one.tfrecord", shallow=False)
    _same_dirs(tmp_path / "j" / "sharded", tmp_path / "p" / "sharded")
    _same_dirs(tmp_path / "j" / "columnar", tmp_path / "p" / "columnar")
    got = list(precordio.read_tfrecords([str(tmp_path / "p" / "one.tfrecord")], verify=True))
    assert got == records


def test_corrupt_record_is_refused(tmp_path):
    path = tmp_path / "x.tfrecord"
    with precordio.TFRecordWriter(str(path)) as w:
        w.write(b"payload")
    raw = bytearray(path.read_bytes())
    raw[14] ^= 1
    path.write_bytes(bytes(raw))
    with pytest.raises(IOError):
        list(precordio.read_tfrecords([str(path)], verify=True))


# --------------------------------------------------------------------------
# generators
def _tabular(pkg, raw, out):
    gen = jgen if pkg == "j" else pgen
    return gen.TabularDataGenerator(
        output_path=out,
        item_path=os.path.join(raw, "item_feature.dat"),
        user_path=os.path.join(raw, "user_feature.dat"),
        main_path=os.path.join(raw, "shop.dat"),
    ).run_all()


FAMILIES = {
    "tabular": (lambda s, out: s.make_ecommerce_raw(out, n_events=6000, seed=3), _tabular),
    "ranking_crossed": (
        lambda s, out: s.make_dcn_raw(out, n_users=400, n_items=300, n_events=5000, seed=2),
        lambda pkg, raw, out: (jgen if pkg == "j" else pgen).RankingTableGenerator(
            out, os.path.join(raw, "impression.csv"), records_per_file=1500,
            cross_columns=[("utag1", "itag1"), ("uid", "itag2")],
        ).run_all(),
    ),
    "impression": (
        lambda s, out: s.make_impression_log_raw(out, n_events=3000, seed=1),
        lambda pkg, raw, out: (jgen if pkg == "j" else pgen).ImpressionLogGenerator(
            out, os.path.join(raw, "impression_log.jsonl")).run_all(),
    ),
    "impression_chain": (
        lambda s, out: s.make_impression_log_raw(out, n_events=2000, full_chain=True, seed=4),
        lambda pkg, raw, out: (jgen if pkg == "j" else pgen).ImpressionLogGenerator(
            out, os.path.join(raw, "impression_log.jsonl"), seed=5).run_all(),
    ),
    "sequence": (
        lambda s, out: s.make_behavior_sequence_raw(out, n_users=300, n_items=200, n_events=3000, seed=6),
        lambda pkg, raw, out: (jgen if pkg == "j" else pgen).SequenceDataGenerator(
            out, os.path.join(raw, "events.jsonl"), max_seq_length=16).run_all(),
    ),
    "sequence_context": (
        lambda s, out: s.make_behavior_sequence_raw(
            out, n_users=200, n_items=150, n_events=2000, n_positions=5, n_pages=3, seed=7),
        lambda pkg, raw, out: (jgen if pkg == "j" else pgen).SequenceDataGenerator(
            out, os.path.join(raw, "events.jsonl"), max_seq_length=8,
            context_features=["position", "page"], emit_negative_series=False,
            sequence_specs={"history": "item_id"}, records_per_file=700).run_all(),
    ),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_generators_match_jax(family, tmp_path):
    make_raw, generate = FAMILIES[family]
    make_raw(jsynth, str(tmp_path / "raw_j"))
    make_raw(psynth, str(tmp_path / "raw_p"))
    _same_dirs(tmp_path / "raw_j", tmp_path / "raw_p")
    # both generators read the JAX package's raw files
    jinfo = generate("j", str(tmp_path / "raw_j"), str(tmp_path / "out_j"))
    info = generate("p", str(tmp_path / "raw_j"), str(tmp_path / "out_p"))
    _same_dirs(tmp_path / "out_j", tmp_path / "out_p")
    assert info.feature_names == jinfo.feature_names and info.total_dims == jinfo.total_dims
    assert len(os.listdir(tmp_path / "out_p")) >= 5


QUIRKS = {
    # int user ids and tags; u9 has no tags, so its events are dropped and the
    # merge makes user_tag1/2 float64 ("3.0"), while the profile keeps "3"
    "user_feature.dat": "1,3,10\n2,2,7\n3,10,7\n4,3,\n\n5,2,10\n",
    # a missing tag (dropped), a float tag column, a duplicated item id
    "item_feature.dat": "i1,a,0.5,x\ni2,b,1.0,y\ni3,,1.5,x\ni4,a,2.0,z\ni2,c,0.5,x\n",
    "shop.dat": (
        "100,1,i1,1\n101,2,i2,0\n102,9,i1,1\n103,3,i3,0\n104,1,i4,1\n105,5,i9,0\n"
        "106,4,i1,1\n107,2,i4,0\n108,3,i1,1\n109,5,i2,1\n110,1,i2,0\n111,3,i4,1\n"
    ),
}


def test_tabular_keeps_pandas_typing(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    for name, text in QUIRKS.items():
        (raw / name).write_text(text)
    _tabular("j", str(raw), str(tmp_path / "out_j"))
    _tabular("p", str(raw), str(tmp_path / "out_p"))
    _same_dirs(tmp_path / "out_j", tmp_path / "out_p")
    recorder = json.loads((tmp_path / "out_p" / "feature_dict.json").read_text())
    assert list(recorder["user_tag1"]) == ["10.0", "2.0", "3.0"]  # "10" sorts before "2"
    assert "0.5" in recorder["item_tag2"]


def test_feature_encoder_and_schema_match_jax(tmp_path):
    values = {"a": [10, 2, 2, "x"], "b": [0.5, 1.0, 0.5, 3]}
    enc = FeatureEncoder(["a", "b"])
    info = enc.fit(values)
    jinfo = JFeatureEncoder(["a", "b"]).fit(values)
    assert enc.recorder == {"a": {"10": 0, "2": 1, "x": 2}, "b": {"0.5": 3, "1.0": 4, "3": 5}}
    assert (info.feature_dims, info.feature_offsets) == (jinfo.feature_dims, jinfo.feature_offsets)
    assert info.dim_of("b") == jinfo.dim_of("b") == 3
    enc.save(str(tmp_path))
    assert FeatureEncoder.load(str(tmp_path)).encode("b", 3) == 5


# --------------------------------------------------------------------------
# loader
@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    jsynth.make_behavior_sequence_raw(str(root / "raw"), n_users=100, n_items=80, n_events=1500, seed=8)
    jgen.SequenceDataGenerator(
        str(root / "gen"), str(root / "raw" / "events.jsonl"), max_seq_length=12,
        records_per_file=400,
    ).run_all()
    return str(root / "gen")


@pytest.mark.parametrize("tier", ["native", "python"])
def test_decode_columnar_matches_jax(shards, tier, request):
    if tier == "python":
        request.getfixturevalue("python_codec")
    paths = ploader.shard_paths(shards, "train")
    assert paths == jloader.shard_paths(shards, "train") and len(paths) > 1
    want = jloader.decode_columnar(paths)
    got = ploader.decode_columnar(paths)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["history"].shape[1] == 12


def test_decode_columnar_takes_the_python_codec_for_ragged_and_bytes(tmp_path):
    with precordio.TFRecordWriter(str(tmp_path / "train_00000.tfrecord")) as w:
        w.write(pproto.encode_example({"x": [1, 2], "name": [b"a"]}))
        w.write(pproto.encode_example({"x": [3, 4], "name": [b"bc"]}))
    got = ploader.decode_columnar([str(tmp_path / "train_00000.tfrecord")])
    np.testing.assert_array_equal(got["x"], [[1, 2], [3, 4]])
    assert list(got["name"]) == [b"a", b"bc"]


def test_load_columnar_cache(shards, tmp_path):
    for f in os.listdir(shards):
        if f.startswith("test"):
            (tmp_path / f).write_bytes(open(os.path.join(shards, f), "rb").read())
    paths = ploader.shard_paths(str(tmp_path), "test")
    first = ploader.load_columnar(paths)
    assert [f for f in os.listdir(tmp_path) if f.startswith(".columnar_cache_")]
    again = ploader.load_columnar(paths)
    want = jloader.load_columnar(paths, cache=False)
    for k in want:
        np.testing.assert_array_equal(first[k], want[k])
        np.testing.assert_array_equal(again[k], want[k])
    with pytest.raises(ValueError):
        ploader.load_columnar([])


LOADER_CASES = {
    "shuffle_drop": dict(batch_size=96, seed=3),
    "shuffle_keep": dict(batch_size=100, seed=4, drop_remainder=False),
    "eval_pad_final": dict(batch_size=128, shuffle=False, pad_final=True),
    "host0_of_2": dict(batch_size=64, seed=5, host_id=0, num_hosts=2, pad_final=True),
    "host1_of_2": dict(batch_size=64, seed=5, host_id=1, num_hosts=2),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_array_loader_batches_match_jax(shards, case):
    data = jloader.decode_columnar(ploader.shard_paths(shards, "train"))
    kw = LOADER_CASES[case]
    jl, pl = jloader.ArrayLoader(data, **kw), ploader.ArrayLoader(data, **kw)
    assert len(pl) == len(jl)
    for _ in range(2):  # two epochs: the shuffle is reseeded per epoch
        want, got = list(jl), list(pl)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if kw.get("pad_final"):
        assert got[-1]["__weight__"].sum() < kw["batch_size"] or len(data["label"]) % kw["batch_size"] == 0
    with pytest.raises(ValueError):
        ploader.ArrayLoader({"a": np.zeros(3), "b": np.zeros(4)}, 2)


# --------------------------------------------------------------------------
# inspect
def test_inspect_helpers_match_jax(shards, tmp_path):
    path = ploader.shard_paths(shards, "test")[0]
    want, got = jinspect.check_tf_record(path, 2), pinspect.check_tf_record(path, 2)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    assert pinspect.summarize_dataset(shards) == jinspect.summarize_dataset(shards)
    (tmp_path / "kv.json").write_text(json.dumps({"DSSM_u1": "i1,i2\t0.5,0.25"}))
    assert pinspect.get_kv_value(str(tmp_path / "kv.json"), "DSSM_u1") == "i1,i2\t0.5,0.25"
    assert pinspect.get_kv_value(str(tmp_path / "kv.json"), "DSSM_u2") is None


def test_check_inference_matches_jax(tmp_path):
    raw, data = str(tmp_path / "raw"), str(tmp_path / "data")
    psynth.make_ecommerce_raw(raw, n_users=60, n_items=40, n_events=800, seed=9)
    _tabular("p", raw, data)
    jinfo, info = JDataInfo.load(data), DataInfo.load(data)
    sample = {n: jnp.zeros((2,), jnp.int32) + off for n, off in zip(jinfo.feature_names, jinfo.feature_offsets)}
    jmodel = jax_build_model(JModelConfig(name="deepfm", embedding=JEmbeddingConfig(dim=4)), jinfo)
    variables = jax.tree.map(np.asarray, fnn.unbox(jmodel.init(jax.random.key(0), sample)))
    meta = {"model": "deepfm", "model_params": {}, "embedding": {"dim": 4}}
    jax_export_params(str(tmp_path / "jexport"), {"params": variables["params"], "model_state": {}}, meta)
    model = build_model(ModelConfig(name="deepfm", embedding=EmbeddingConfig(dim=4)), info, device="cpu")
    params_from_jax(model, {"params": variables["params"]})
    export_params(str(tmp_path / "export"), model.state_dict(), meta)
    want = jinspect.check_inference(str(tmp_path / "jexport"), data, batch_size=5)
    got = pinspect.check_inference(str(tmp_path / "export"), data, batch_size=5, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    if not torch.cuda.is_available():  # the default device is the card: no fallback
        with pytest.raises(RuntimeError, match="CUDA"):
            pinspect.check_inference(str(tmp_path / "export"), data)


# --------------------------------------------------------------------------
# imports
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tpurec", "pandas", "redis")


def _imported_names(path):
    """(module name, enclosing function) of every import in a source file."""
    tree = ast.parse(path.read_text())
    out = []

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            inner = scope
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                inner = f"{scope}.{child.name}" if scope else child.name
            if isinstance(child, ast.Import):
                out.extend((a.name, scope) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                out.append((child.module, scope))
            visit(child, inner)

    visit(tree, "")
    return out


def test_the_port_imports_no_jax_pandas_or_reference():
    files = sorted((ROOT / "tpurec_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = []
    for path in files:
        for name, scope in _imported_names(path):
            top = name.split(".")[0]
            allowed = top == "redis" and path.name == "kvstore.py" and scope == "RedisKVStore.__init__"
            if top in FORBIDDEN and not allowed:
                bad.append(f"{path.relative_to(ROOT)}: {name} in {scope or 'module'}")
    assert not bad, bad
    # and at run time: importing every module of the port pulls none of them in
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "tpurec_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"print(sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
