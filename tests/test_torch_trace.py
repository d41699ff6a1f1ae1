"""The port's spans and counters (``tpurec_torch/core/trace.py``) and their
sites in the training path, on the CPU with tiny trainers."""

import json
import warnings

import numpy as np
import pytest
import torch

from tpurec_torch.config import (EmbeddingConfig, ExperimentConfig, ModelConfig, OptimizerConfig,
                                 TrainConfig)
from tpurec_torch.core import trace
from tpurec_torch.data.schema import DataInfo
from tpurec_torch.train.trainer import Trainer

torch.set_num_threads(1)

MARKS = ["forward", "backward", "optimizer", "metrics", "end"]
CHILDREN = ["step.forward", "step.backward", "step.optimizer", "step.metrics"]
# the engines' spans in the order they open, and the child of ``step`` each runs in
ENGINE_SPANS = {
    "dense": [],
    "lazy": [("engine.unique", "step.forward"), ("engine.gather", "step.forward"),
             ("engine.update", "step.optimizer")],
    # each table's scatter then its Adam, in turn (``scatter_adam_sorted``)
    "fused": [("engine.plan", "step.forward"), ("engine.gather", "step.forward")]
    + [("engine.scatter", "step.optimizer"), ("engine.adam", "step.optimizer")] * 2,
}


@pytest.fixture(autouse=True)
def tracing_off_after():
    yield
    if trace.recording() is not None:
        trace.stop()


def tiny_trainer(engine, **train):
    names = [f"f{i}" for i in range(4)]
    info = DataInfo.from_dims(names, [20] * 4, user_features=names[:2], item_features=names[2:])
    opt = dict(dense={}, lazy=dict(embedding_optimizer="adam"),
               fused=dict(embedding_optimizer="fused_adam", fused_backward="permute"))[engine]
    cfg = ExperimentConfig(
        model=ModelConfig(name="deepfm", embedding=EmbeddingConfig(dim=4)),
        train=TrainConfig(compute_dtype="float32", log_every_steps=0,
                          sparse_embedding=engine != "dense", optimizer=OptimizerConfig(**opt), **train),
    )
    rng = np.random.default_rng(0)
    batch = {n: rng.integers(20 * i, 20 * i + 20, size=(16,)) for i, n in enumerate(names)}
    batch["label"] = rng.integers(0, 2, size=(16,)).astype(np.float32)
    return Trainer(cfg, info, device="cpu"), batch


def test_off_records_nothing_and_hands_out_one_shared_context():
    assert trace.recording() is None
    a, b = trace.span("feed"), trace.span("step", ends_step=True)
    assert a is b
    with a:
        trace.phase("step.forward")
    trainer, batch = tiny_trainer("dense")
    state = trainer.init_state()
    trainer.train_step(state, trainer.device_batch(batch), trainer.metrics.init())
    assert trace.recording() is None
    with pytest.raises(RuntimeError):
        trace.stop()


def test_spans_nest_with_their_parents_and_step_index():
    rec = trace.start()
    assert trace.recording() is rec
    with pytest.raises(RuntimeError):
        trace.start()
    for _ in range(2):
        with trace.span("feed"):
            with trace.span("feed.pin"):
                pass
        with trace.span("step", ends_step=True):
            trace.phase("step.forward")
            with trace.span("engine.gather"):
                pass
            trace.phase("step.backward")
            trace.phase(None)
            trace.phase("step.metrics")  # left open: the step's end ends it
    assert trace.stop() is rec and trace.recording() is None
    got = [(s.name, s.parent.name if s.parent else None, s.step) for s in rec.spans]
    want = []
    for k in range(2):
        want += [("feed", None, k), ("feed.pin", "feed", k), ("step", None, k),
                 ("step.forward", "step", k), ("engine.gather", "step.forward", k),
                 ("step.backward", "step", k), ("step.metrics", "step", k)]
    assert got == want
    assert rec.step == 2
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns and s.end_ns <= s.parent.end_ns
    forward, backward = rec.named("step.forward")[0], rec.named("step.backward")[0]
    assert forward.end_ns <= backward.start_ns


def test_stop_ends_the_spans_still_open():
    rec = trace.start()
    with trace.span("outer"):
        trace.phase("inner")
        trace.stop()
    assert [s.end_ns is not None for s in rec.spans] == [True, True]


def test_syncs_count_against_the_innermost_span_and_are_swallowed():
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        rec = trace.start()
        warnings.warn(trace.SYNC_WARNING)  # outside every span
        with trace.span("step"):
            trace.phase("step.forward")
            for _ in range(2):
                warnings.warn(trace.SYNC_WARNING)
            trace.phase(None)
            warnings.warn(trace.SYNC_WARNING)
            warnings.warn("something else")
        trace.stop()
    assert [str(w.message) for w in seen] == ["something else"]
    assert rec.loose_syncs == 1
    assert {s.name: s.syncs for s in rec.spans} == {"step": 1, "step.forward": 2}


@pytest.mark.parametrize("engine", ["dense", "lazy", "fused"])
def test_each_engine_emits_its_spans_in_order_inside_step(engine):
    trainer, batch = tiny_trainer(engine)
    state = trainer.init_state()
    metric_state = trainer.metrics.init()
    seen = []
    trainer.step_marks = seen.append
    rec = trace.start()
    for _ in range(2):
        state, metric_state, _ = trainer.train_step(state, trainer.device_batch(batch), metric_state)
    trace.stop()
    trainer.step_marks = None
    assert seen == MARKS * 2
    for k in range(2):
        spans = [s for s in rec.spans if s.step == k]
        names = [s.name for s in spans]
        assert names[:2] == ["feed", "feed.copy"]  # no pinning on the CPU
        assert names[2] == "step"
        assert [n for n in names if n.startswith("step.")] == CHILDREN
        engine_spans = [(s.name, s.parent.name) for s in spans if s.name.startswith("engine.")]
        assert engine_spans == ENGINE_SPANS[engine]
        step = spans[2]
        for s in spans[3:]:
            assert step.start_ns <= s.start_ns and s.end_ns <= step.end_ns
        assert sum(s.syncs for s in spans) == 0


def test_the_operators_profile_holds_the_spans(tmp_path):
    shown = warnings.showwarning
    trainer, batch = tiny_trainer("dense", profile_dir=str(tmp_path), profile_start_step=2,
                                  profile_num_steps=2)
    state = trainer.init_state()
    trainer.train_epoch(state, [batch] * 4)
    assert trace.recording() is None and warnings.showwarning is shown
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    ranges = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    for name in ["feed", "feed.copy", "step"] + CHILDREN:
        assert ranges.count(name) == 2, name


def test_a_step_that_raises_inside_the_profile_leaves_tracing_off(tmp_path):
    trainer, batch = tiny_trainer("dense", profile_dir=str(tmp_path), profile_start_step=2,
                                  profile_num_steps=3)
    state = trainer.init_state()
    broken = dict(batch)
    del broken["label"]
    with pytest.raises(KeyError):
        trainer.train_epoch(state, [batch, batch, broken, batch])
    assert trace.recording() is None
    assert (tmp_path / "trace.json").exists()


def tiny_eta_trainer():
    names = ["user_id", "item_id", "item_cate"]
    info = DataInfo.from_dims(names, [20, 30, 10], sequence_names=["hist_item", "hist_cate"],
                              sequence_query_features=["item_id", "item_cate"], max_seq_length=12,
                              user_features=["user_id"])
    cfg = ExperimentConfig(
        model=ModelConfig(name="eta", params={"topk": 4, "short_len": 3},
                          embedding=EmbeddingConfig(dim=4)),
        train=TrainConfig(compute_dtype="float32", log_every_steps=0, loss="gsu_esu"),
    )
    rng = np.random.default_rng(0)
    lengths = rng.integers(1, 13, size=(16,))
    live = np.arange(12)[None, :] < lengths[:, None]
    batch = {"user_id": rng.integers(0, 20, size=(16,)), "item_id": rng.integers(20, 50, size=(16,)),
             "item_cate": rng.integers(50, 60, size=(16,)),
             "hist_item": np.where(live, rng.integers(20, 50, size=(16, 12)), 0),
             "hist_cate": np.where(live, rng.integers(50, 60, size=(16, 12)), 0),
             "label": rng.integers(0, 2, size=(16,)).astype(np.float32)}
    return Trainer(cfg, info, device="cpu"), batch


def test_eta_opens_its_search_and_attention_once_a_forward_under_step_forward():
    trainer, batch = tiny_eta_trainer()
    state = trainer.init_state()
    metric_state = trainer.metrics.init()
    rec = trace.start()
    for _ in range(2):
        state, metric_state, _ = trainer.train_step(state, trainer.device_batch(batch), metric_state)
    trace.stop()
    for k in range(2):
        spans = [(s.name, s.parent.name) for s in rec.spans if s.step == k and s.name.startswith("eta.")]
        assert spans == [("eta.search", "step.forward"), ("eta.attend", "step.forward")]
        search, attend = [s for s in rec.spans if s.step == k and s.name.startswith("eta.")]
        assert search.end_ns <= attend.start_ns
        assert search.device_ms is None and attend.device_ms is None


class _Event:
    """A stand-in for ``torch.cuda.Event``: counts what is made and
    recorded, and reads 1 ms a pair."""

    made = recorded = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1

    def record(self, stream=None):
        type(self).recorded += 1

    def elapsed_time(self, other):
        return 1.0


@pytest.mark.parametrize("device_events", [False, True])
def test_device_events_only_when_asked(device_events, monkeypatch):
    """With device events off (the default, and always without a CUDA
    device) a span records no CUDA event; with them on, one pair a span,
    the first at its open and the second at its close."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    _Event.made = _Event.recorded = 0
    rec = trace.start(count_syncs=False, device_events=device_events)
    with trace.span("step", ends_step=True):
        assert _Event.recorded == (1 if device_events else 0)
        trace.phase("step.forward")
        with trace.span("eta.search"):
            pass
    trace.stop()
    assert _Event.made == _Event.recorded == (6 if device_events else 0)
    assert [s.device_ms for s in rec.spans] == ([1.0] * 3 if device_events else [None] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rec = trace.start(count_syncs=False, device_events=True)
    with trace.span("step"):
        pass
    trace.stop()
    assert rec.spans[0].device_ms is None
