"""The frozen work counts and the FLOP counters against hand counts at tiny
shapes."""

import pytest

from portbench.lib import peaks, spec

DIN = {"sequences": {"a": "x", "b": "y"}, "embed_dim": 2, "max_seq_length": 4,
       "params": {"attention_hidden_dims": [3], "hidden_dims": [5]},
       "user_features": ["u"], "item_features": []}


def test_attention_forward_least_time_is_bytes_or_operations_by_hand():
    work = spec.load_module("work", "attn_fwd")
    # B=2 rows, L=4, key width D=4, H=3, 5 live steps
    stats = {"rows": 2, "live": 5, "ids": 0}
    nbytes = 4 * (2 * 4 + 5 * 4 + 2 * 4 + 4 * 4 * 3 + 3 * 3 + 2 * 4 + 2 * 4)
    mma = 5 * 2 * 4 * 3
    fma = 5 * (6 * 3 + 1) + 2 * (6 * 4 * 3 + 3) + 2 * 5 * 4
    want = max(nbytes / peaks.HBM_BYTES_PER_S, 3 * mma / peaks.TF32_FLOPS + fma / peaks.FP32_FLOPS)
    assert work.least_s(DIN, stats) == pytest.approx(want, rel=1e-12)
    assert nbytes == 4 * 109


def test_attention_backward_least_time_by_hand():
    work = spec.load_module("work", "attn_bwd")
    stats = {"rows": 2, "live": 5, "ids": 0}
    nbytes = 4 * (3 * 2 * 4 + 5 * 4 + 2 * 4 * 4 + 2 * 4 + 5 + 2 * (4 * 4 * 3 + 3 * 3))
    mma = 2 * 3 * 5 * 4 * 3
    fma = 2 * (6 * 2 * 4 * 3 + 5 * 4) + 8 * 5 * 3
    want = max(nbytes / peaks.HBM_BYTES_PER_S, 3 * mma / peaks.TF32_FLOPS + fma / peaks.FP32_FLOPS)
    assert work.least_s(DIN, stats) == pytest.approx(want, rel=1e-12)


def test_din_flops_by_hand():
    work = spec.load_module("work", "din_amazon")
    # key width 4, H 3: per live step 2*16*3 + 2*3 + 2*4 = 110; MLP in 2 + 8 = 10
    # -> 5 -> 1: per row 2*10*5 + 2*5 = 110
    stats = {"rows": 2, "live": 5, "ids": 0}
    assert work.flops(DIN, stats) == 3 * (5 * 110 + 2 * 110)


def test_deepfm_flops_by_hand():
    work = spec.load_module("work", "deepfm_criteo")
    cfg = {"features": {"a": 3, "b": 4}, "embed_dim": 2, "params": {"hidden_dims": [3]}}
    # cross 2*2*2 + 3*2 = 14; MLP 2*4*3 + 2*3*1 = 30
    stats = {"rows": 5, "live": 0, "ids": 10}
    assert work.flops(cfg, stats) == 3 * 5 * 44


def test_the_configurations_counts_at_their_sizes():
    din = spec.load_cell("din_amazon.train").config
    fm = spec.load_cell("deepfm_criteo.train_dense").config
    f_din = spec.load_module("work", "din_amazon").flops
    f_fm = spec.load_module("work", "deepfm_criteo").flops
    # one example with 40 live steps: 40 * 18,632 + 96,160 forward
    assert f_din(din, {"rows": 1, "live": 40, "ids": 0}) == 3 * (40 * 18_632 + 96_160)
    # 39 fields at D = 10: the cross 2 * 390 + 30, the MLP 390 -> 400 -> 400 -> 400 -> 1
    assert f_fm(fm, {"rows": 1, "live": 0, "ids": 39}) == 3 * (780 + 30 + 952_800)
