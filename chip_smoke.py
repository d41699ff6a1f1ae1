#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``$CUDA_HOME/bin`` or ``PATH``) and ``triton``;
it builds every kernel from the sources in this checkout and exits non-zero
on the first phase that fails. Phases:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels (``tpurec_torch.ops.kernels.build``);
3. each kernel against its plain PyTorch version on the same CUDA tensors at
   the serving shapes, fp32 with TF32 off, tolerance atol = rtol = 1e-4
   (the two sum in different orders); device time per launch (median of 30,
   CUDA events, L2 flushed before each launch), the plain version's time and
   the bound: the larger of the bytes the function must move over 3.35 TB/s
   and the fp32 operations the kernel does over 67 TFLOP/s (H100 SXM data
   sheet);
4. DIN at full width (the ``bench.py`` configuration: 3 profile fields over
   21,500 ids, a 64-step history, D=32, attention H=36, MLP (200, 80), bf16
   dense compute, fp32 params and attention), random seeded weights:
   ``export_params`` → ``load_servable`` → ``Servable.predict`` on a B=8192
   batch. Outputs must be finite probabilities and the DIN kernel must have
   run. The scores and pooled vectors the servable's attention produced must
   match the plain attention on the same inputs (``DIN_ATT_TOL``,
   ``DIN_POOLED_TOL``). The fp32 logit must agree with the same servable run
   through the plain attention (``DIN_LOGIT_TOL``) and with the port on the
   CPU over the first 256 rows (``DIN_LOGIT_TOL_CPU``), while an attention
   that returns pooled = 0 or ignores the mask must miss ``DIN_LOGIT_TOL``:
   the check has to be able to fail;
5. the HTTP server over the FM benchmark schema (26 fields × 80,000 ids =
   2.08M rows, padded to 2,080,128, D=32): a ``dssm_double`` retrieval model
   (user f0-f12, item f13-f25) and a ``deepfm`` ranker, random seeded
   weights; seeded profiles of 5,000 users and 2,500 items; ``OfflineIndexer``
   into a ``DictKVStore``; ``serve_background``; retrieve/kv, retrieve/online
   top-20, rank over 20 and 200 candidates, rank from_retrieval, 200
   sequential requests each (p95 has ten samples beyond it), each checked
   for shape and score order, with its p50 and p95 latency. The FM kernel
   must have run.

6. DIN training at full width (``bench.py:38-64`` with ``bench.py:230-266``'s
   dense trainer: the phase 4 schema and widths, bf16 dense compute, fp32
   params, ``loss='bce'``, Adam lr 1e-3 eps 1e-7, a B=8192 batch made as
   ``bench.py:75-87`` with seed 1), through ``Trainer(cfg, info)`` →
   ``init_state`` → ``device_batch`` → ``train_step``:
   - the DIN backward kernel against ``din_attention_bwd_plain`` at the
     training shape (with and without PReLU slopes) and at ragged shapes,
     each output's error in units of its limit (``bwd_reading``); a backward
     that ignores the mask or drops the slopes must read above the limit;
     its device time, bound and the plain version's time;
   - one fp32 train step from the same weights and batch with the kernels
     against one with the plain attention forward and backward: the loss,
     every gradient and every parameter after Adam (``STEP_*``); a backward
     that ignores the mask must miss the gradient limit;
   - three fp32 steps on the card against the port on the CPU on the first
     256 rows: the loss of each step (``CPU_LOSS_TOL``);
   - 30 steps on the fixed batch: every loss finite, the last below the
     first, each kernel launched once a step; step p50 (host clock,
     synchronised, steps 10-29) and examples/s; a CUDA-event breakdown of
     a step (host→device copy, forward, backward, optimizer, metrics);
   - ``run`` over small batches with a checkpoint directory, ``restore``
     (identical state), ``export`` → ``load_servable`` → ``predict``, which
     must equal ``Trainer.infer`` (fp32 compute, since the export, as the
     JAX package's, drops the compute dtype).

7. the embedding engines at full width (the ``bench.py:230-351`` trainers):
   - kernel #9 (``fused_scatter_add``) against ``scatter_add_plain`` at the
     FM v- and w-table shapes (bench.py's B=8192 batch: N=212,992 ids over
     2,080,128 rows, D=32 and D=1), at DIN's (phase 6's batch: N=548,864
     over 21,504 rows, its id-0 share printed) and at ragged shapes (N=1003,
     V=300, D=8/64/160; every id equal; N=0): each row's error in units of
     its limit (``SUM_RTOL``), two calls the same bits, and versions that
     drop what runs carry across slices or keep only first occurrences
     reading above the limit; device time, bound, plain and ``index_add_``
     times. Kernel #10 (``gather_rows_sorted``) exactly equal to
     ``index_select`` at the FM shape and ragged shapes, with its times;
   - FM (bf16 compute, fp32 params) in the dense, ``fused_adam`` and
     ``rowwise_adam`` engines: 30 steps each (losses finite and falling,
     #9 twice a fused step, no host sync, step p50 and examples/s, peak
     memory, a profiler summary); one fp32 fused step against one fp32
     dense step (``ENGINE_*``), which a #9 that drops carried runs must
     fail; three fp32 steps card against CPU (``fused_adam``,
     ``rowwise_adam``); ``host_adam`` against lazy ``adam`` after 3 steps,
     with both peak memories; ``run`` → ``restore`` (tables and
     ``table_opt`` equal) → ``export`` → ``load_servable`` → ``predict``
     (equal to ``Trainer.infer``) on a fused-trained FM;
   - DIN on the fused engine: the fp32 fused-against-dense step, then 30
     bf16 steps with #4, #5 and #9 each launched once a step.

TF32 is off for the whole run (``allow_tf32 = False`` for matmul and
cuDNN), so every fp32 comparison is fp32 on both sides.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
import warnings
from unittest import mock

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # fp32 outside the tensor cores
KERNEL_TOL = dict(atol=1e-4, rtol=1e-4)
# DIN servable (phase 4). The attention's own outputs at the servable's
# inputs: scores fp32; pooled is rounded to bf16 for the MLP (one bf16 step
# is 2^-8..2^-7 relative). The logit tolerances sit between the sound
# readings and the broken ones (PERF.md, PR 1).
DIN_ATT_TOL = dict(atol=1e-6, rtol=1e-4)
DIN_POOLED_TOL = dict(atol=1e-6, rtol=2.0**-7)
DIN_LOGIT_TOL = 1e-3
DIN_LOGIT_TOL_CPU = 1e-3
# DIN training (phase 6). The backward's parameter gradients are sums over
# B·L terms taken in another order: held at 1e-4 of their largest value.
DIN_BWD_PARAM_RTOL = 1e-4
# One fp32 train step, kernels against the plain attention: the loss, each
# gradient against 1e-3 of its largest value, each parameter after Adam
# (its first step moves a weight by about lr = 1e-3).
STEP_LOSS_TOL = 1e-5
STEP_GRAD_RTOL = 1e-3
STEP_PARAM_TOL = 1e-5
# the loss of each of three fp32 steps, card against CPU (one Adam step
# moves the loss by ~1e-3)
CPU_LOSS_TOL = 2e-5
TRAIN_BATCH = 8192
TRAIN_STEPS = 30
DIN_FEATURES = dict(
    user_features=["user_tag"], item_features=["item_id", "item_tag"],
    sequence_features=["history"],
)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def device_ms(torch, fn, iters: int = 30, warmup: int = 3) -> float:
    """Median device time of one ``fn()`` launch. The L2 cache (50 MB) is
    flushed before each launch. A sleep kernel ahead of the loop holds the
    card while the host queues every launch, so host-side launch overhead
    stays out of the times."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(iters)
    ]
    torch.cuda._sleep(100_000_000)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def max_err(torch, got, want) -> float:
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **KERNEL_TOL)
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def din_inputs(torch, gen, b, l, d, h):
    """DIN attention inputs: query, keys, a mask of lengths L/4..L, w1, b1,
    w2 and PReLU slopes, drawn from ``gen``."""

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=gen)

    lengths = torch.randint(l // 4, l + 1, (b,), device="cuda", generator=gen)
    mask = (torch.arange(l, device="cuda")[None, :] < lengths[:, None]).float()
    return [
        randn(b, d), randn(b, l, d), mask, randn(4 * d, h, scale=0.2), randn(h, scale=0.1),
        randn(h, scale=0.2), torch.rand(h, device="cuda", generator=gen),
    ]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
def check_kernels(torch, kernels):
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=gen)

    records = {}
    # DIN attention at the serving shape
    b, l, d, h = 8192, 64, 32, 36
    args = din_inputs(torch, gen, b, l, d, h)
    err = max_err(torch, kernels.din_attention_fused(*args), kernels.din_attention_plain(*args))
    # what this run's mask needs: keys are read and scored at live steps
    # only (a masked step's score is 0 and adds nothing to pooled)
    live = int(args[2].sum())
    nbytes = 4 * (b * d + live * d + b * l + 4 * d * h + 3 * h + b * d + b * l)
    ops = live * (2 * d * h + 6 * h + 1) + b * (6 * d * h + h) + 2 * live * d
    bound_ms, bound_by = bound(nbytes, ops)
    records["din_attention"] = dict(
        name="din_attention", route="cuda", source="tpurec_torch/csrc/din_attention.cu",
        replaces="tpurec/ops/pallas/kernels.py:350", shape=[b, l, d, h], live_steps=live, max_abs_err=err,
        ms=device_ms(torch, lambda: kernels.din_attention_fused(*args)),
        plain_ms=device_ms(torch, lambda: kernels.din_attention_plain(*args)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
    )
    # FM cross term: the benchmark shape, then the rank path's bucket shapes
    f, d = 26, 32
    for b in (8192, 256, 32):
        emb = randn(b, f, d)
        err = max_err(
            torch, [kernels.fm_second_order_fused(emb)], [kernels.fm_second_order_plain(emb)]
        )
        bound_ms, bound_by = bound(4 * (b * f * d + b), b * f * d * 3 + b * d * 3 + b)
        rec = dict(
            name="fm_second_order", route="triton", source="tpurec_torch/ops/kernels.py",
            replaces="tpurec/ops/pallas/kernels.py:110", shape=[b, f, d], max_abs_err=err,
            ms=device_ms(torch, lambda: kernels.fm_second_order_fused(emb)),
            plain_ms=device_ms(torch, lambda: kernels.fm_second_order_plain(emb)),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        )
        if b == 8192:
            records["fm_second_order"] = rec
        else:
            print("fm_second_order at the rank shape:", json.dumps(rec), flush=True)
    for rec in records.values():
        print("kernel check:", json.dumps(rec), flush=True)
    return records


# ---------------------------------------------------------------------------
# phase 4: DIN Servable at full width
def bench_batch(info, batch_size, seq_len, seed=0):
    """A batch made the way ``bench.py``'s ``_make_batch`` makes it."""
    rng = np.random.default_rng(seed)
    batch = {
        n: rng.integers(off, off + dim, size=(batch_size,))
        for n, off, dim in zip(info.feature_names, info.feature_offsets, info.feature_dims)
    }
    for sname in info.sequence_names:
        seq = rng.integers(1, info.total_dims // 2, size=(batch_size, seq_len))
        lengths = rng.integers(seq_len // 4, seq_len + 1, size=(batch_size,))
        mask = np.arange(seq_len)[None, :] < lengths[:, None]
        batch[sname] = np.where(mask, seq, 0)
    batch["label"] = rng.integers(0, 2, size=(batch_size,)).astype(np.float32)
    return batch


def din_info():
    from tpurec_torch.data.schema import DataInfo

    return DataInfo.from_dims(
        ["user_tag", "item_id", "item_tag"], [1000, 20000, 500],
        sequence_names=["history"], max_seq_length=64, padding_index=0,
    )


def run_din_servable(torch, kernels, workdir, card):
    from tpurec_torch.config import EmbeddingConfig, ModelConfig
    from tpurec_torch.models import build_model
    from tpurec_torch.serving.export import load_servable
    from tpurec_torch.train.checkpoint import export_params

    seq_len, batch_size = 64, 8192
    info = din_info()
    config = ModelConfig(
        name="din", params=dict(DIN_FEATURES, dtype="bfloat16"),
        embedding=EmbeddingConfig(dim=32),
    )
    model = build_model(config, info, device="cuda", seed=0)
    export_dir = os.path.join(workdir, "din_export")
    export_params(
        export_dir, model.state_dict(),
        meta={"model": "din", "model_params": dict(config.params),
              "embedding": config.embedding.to_dict()},
    )
    servable = load_servable(export_dir, info, device="cuda")
    batch = bench_batch(info, batch_size, seq_len)

    att = servable.model.att
    seen = {}
    hook = att.register_forward_hook(lambda mod, args, out: seen.update(args=args, out=out))
    kernels.reset_launch_counts()
    outputs = servable.predict(batch)
    torch.cuda.synchronize()
    launches = kernels.din_attention_fused.launches
    hook.remove()
    out, logit = outputs["output"], outputs["logit"]

    # the attention the servable ran, against the plain version on its inputs
    query, keys, mask = seen["args"]
    pooled, scores = seen["out"]
    with torch.inference_mode():
        want_pooled, want_scores = kernels.din_attention_plain(
            query.float(), keys.float(), mask, att.w1, att.b1, att.w2[:, 0], att.alpha
        )
    att_err = dict(
        scores=float((scores - want_scores).abs().max()),
        pooled=float((pooled.float() - want_pooled).abs().max()),
        scores_max_abs=float(want_scores.abs().max()),
        pooled_max_abs=float(want_pooled.abs().max()),
    )

    # the whole servable's fp32 logit: with the plain attention (sound), with
    # an attention that returns pooled = 0 or ignores the mask (broken: what
    # the check must tell apart from sound), and the port on the CPU
    def logit_with(attention):
        with mock.patch.object(kernels, "din_attention_fused", attention):
            return servable.predict(batch)["logit"]

    def zero_pooled(*args):
        p, s = kernels.din_attention_plain(*args)
        return torch.zeros_like(p), s

    def no_mask(q, k, m, *rest):
        return kernels.din_attention_plain(q, k, torch.ones_like(m), *rest)

    logit_err = {
        name: float((logit - logit_with(fn)).abs().max())
        for name, fn in (("plain", kernels.din_attention_plain), ("broken_zero_pooled", zero_pooled),
                         ("broken_no_mask", no_mask))
    }
    cpu_model = build_model(config, info, device="cpu").eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in servable.model.state_dict().items()})
    with torch.inference_mode():
        cpu_logit = cpu_model({k: torch.as_tensor(v[:256]) for k, v in batch.items()})["logit"]
    logit_err["cpu_256_rows"] = float((logit[:256].cpu() - cpu_logit).abs().max())
    print("din servable checks:", json.dumps(dict(
        attention=att_err, logit=logit_err, logit_max_abs=float(logit.abs().max()),
        logit_tol=DIN_LOGIT_TOL, logit_tol_cpu=DIN_LOGIT_TOL_CPU,
    )), flush=True)

    check(launches > 0, "DIN servable did not launch the DIN attention kernel")
    check(out.shape == (batch_size,) and out.dtype == torch.float32, f"bad output {out.shape}")
    check(bool(torch.isfinite(out).all()), "non-finite DIN outputs")
    check(bool(((out >= 0) & (out <= 1)).all()), "DIN outputs outside [0, 1]")
    torch.testing.assert_close(scores, want_scores, **DIN_ATT_TOL)
    torch.testing.assert_close(pooled.float(), want_pooled, **DIN_POOLED_TOL)
    check(logit_err["plain"] <= DIN_LOGIT_TOL,
          f"DIN servable logit, kernel vs plain attention: {logit_err['plain']}")
    check(logit_err["cpu_256_rows"] <= DIN_LOGIT_TOL_CPU,
          f"DIN servable logit on the card vs on the CPU: {logit_err['cpu_256_rows']}")
    for name in ("broken_zero_pooled", "broken_no_mask"):
        check(logit_err[name] > DIN_LOGIT_TOL,
              f"the logit check cannot tell a {name} attention from a sound one")

    times = []
    for _ in range(12):
        t0 = time.perf_counter()
        servable.predict(batch)["output"].cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    result = dict(
        card=card, batch=batch_size, din_launches=launches, predict_p50_ms=statistics.median(times[2:]),
        examples_per_s=batch_size / (statistics.median(times[2:]) / 1e3),
        mean_prob=float(out.mean()),
    )
    print("din servable:", json.dumps(result), flush=True)
    return launches, result


# ---------------------------------------------------------------------------
# phase 5: HTTP retrieve / rank over the FM schema
def run_http(torch, kernels, workdir, card, n_requests=200):
    from tpurec_torch.config import EmbeddingConfig, ModelConfig
    from tpurec_torch.data.schema import DataInfo
    from tpurec_torch.models import build_model
    from tpurec_torch.serving import DictKVStore, OfflineIndexer
    from tpurec_torch.serving.export import Servable
    from tpurec_torch.serving.server import RecommendService, serve_background

    names = [f"f{i}" for i in range(26)]
    info = DataInfo.from_dims(
        names, [80_000] * 26, user_features=names[:13], item_features=names[13:]
    )
    emb = EmbeddingConfig(dim=32)
    towers = Servable(build_model(ModelConfig(name="dssm_double", embedding=emb), info, "cuda", seed=1))
    ranker = Servable(build_model(ModelConfig(name="deepfm", embedding=emb), info, "cuda", seed=2))
    check(towers.model.u_tower.emb.embedding.shape == (2_080_128, 32), "unexpected table rows")

    rng = np.random.default_rng(0)

    def profiles(prefix, n, fields):
        cols = [info.offset_of(f) + rng.integers(0, 80_000, size=n) for f in fields]
        return {f"{prefix}{j}": [int(c[j]) for c in cols] for j in range(n)}

    user_profile = profiles("u", 5000, info.user_features)
    item_profile = profiles("i", 2500, info.item_features)
    kv = DictKVStore()
    t0 = time.perf_counter()
    index = OfflineIndexer(
        towers.user_tower, towers.item_tower, user_profile, item_profile,
        info.user_features, info.item_features, batch_size=1024, device="cuda",
    ).run(os.path.join(workdir, "index"), kv_store=kv, topk=20)
    index_s = time.perf_counter() - t0
    check(len(kv) == 5000, f"KV store holds {len(kv)} users")
    service = RecommendService(
        user_tower=towers.user_tower, ranker=ranker.rank, user_profile=user_profile,
        item_profile=item_profile, user_feature_names=info.user_features,
        item_feature_names=info.item_features, kv_store=kv, item_ids=index["item_ids"],
        item_embeddings=index["item_embeddings"], device="cuda",
    )
    server = serve_background(service, port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}/predict"

    def post(payload):
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"}
        )
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())
        return body, (time.perf_counter() - t) * 1e3

    uids = rng.choice(list(user_profile), size=n_requests, replace=False).tolist()
    iids = list(item_profile)

    def descending(result):
        scores = list(result.values())
        return scores == sorted(scores, reverse=True)

    def kv_check(uid, r):
        check(len(r["result"]) == 20 and descending(r["result"]), "retrieve/kv shape")

    def online_check(uid, r):
        check(len(r["result"]) == 20 and descending(r["result"]), "retrieve/online shape")
        top_kv = service.retrieve_kv(uid)
        check(abs(max(r["result"].values()) - max(top_kv.values())) < 1e-4,
              "online top-1 score disagrees with the offline index")

    def rank_check(n):
        def f(uid, r):
            check(len(r["result"]) == n and descending(r["result"]), f"rank {n} shape")
        return f

    paths = {
        "retrieve_kv": (lambda u: {"user_id": u, "type": "retrieve", "source": "kv"}, kv_check),
        "retrieve_online_top20": (lambda u: {"user_id": u, "type": "retrieve", "topk": 20}, online_check),
        "rank_20": (lambda u: {"user_id": u, "type": "rank",
                               "item_ids": rng.choice(iids, 20, replace=False).tolist()}, rank_check(20)),
        "rank_200": (lambda u: {"user_id": u, "type": "rank",
                                "item_ids": rng.choice(iids, 200, replace=False).tolist()}, rank_check(200)),
        "rank_from_retrieval": (lambda u: {"user_id": u, "type": "rank", "from_retrieval": True,
                                           "topk": 20}, rank_check(20)),
    }
    kernels.reset_launch_counts()
    latency = {}
    try:
        for name, (make, verify) in paths.items():
            for uid in uids[:5]:  # warm-up: first Triton compile, allocator
                post(make(uid))
            times = []
            for uid in uids:
                body, ms = post(make(uid))
                check("error" not in body, f"{name}: {body}")
                verify(uid, body)
                times.append(ms)
            latency[name] = dict(p50_ms=statistics.median(times), p95_ms=float(np.percentile(times, 95)))
    finally:
        server.shutdown()
        server.server_close()
    torch.cuda.synchronize()
    launches = kernels.fm_second_order_fused.launches
    check(launches > 0, "the rank path did not launch the FM kernel")
    result = dict(card=card, fm_launches=launches, index_build_s=index_s, requests_per_path=n_requests,
                  latency=latency)
    print("http serving:", json.dumps(result), flush=True)
    return launches, result


# ---------------------------------------------------------------------------
# phase 6: DIN training at full width
BWD_NAMES = ("dq", "dkeys", "dw1", "db1", "dw2", "dalpha")


def tol_ratio(got, want, atol, rtol) -> float:
    """max |got − want| / (atol + rtol·|want|): at most 1 passes (the
    elementwise test of ``torch.testing.assert_close``)."""
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def scaled_ratio(got, want, rtol) -> float:
    """max |got − want| / (rtol · max |want|): at most 1 passes."""
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    return err / (rtol * scale) if scale > 0 else (0.0 if err == 0 else float("inf"))


def bwd_reading(got, want) -> dict:
    """Each backward output's error in units of its limit (at most 1
    passes): dq and dkeys elementwise at ``KERNEL_TOL``, the parameter
    gradients at ``DIN_BWD_PARAM_RTOL`` of their largest value."""
    return {
        name: tol_ratio(g, w, **KERNEL_TOL) if name in ("dq", "dkeys")
        else scaled_ratio(g, w, DIN_BWD_PARAM_RTOL)
        for name, g, w in zip(BWD_NAMES, got, want)
    }


def check_din_backward(torch, kernels):
    """The DIN backward kernel against its plain version (phase 6)."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def case(b, l, d, h):
        args = din_inputs(torch, gen, b, l, d, h)
        cot = [torch.randn(b, d, device="cuda", generator=gen),
               torch.randn(b, l, device="cuda", generator=gen)]
        return args, cot

    b, l, d, h = TRAIN_BATCH, 64, 32, 36
    args, cot = case(b, l, d, h)
    relu = args[:6] + [torch.zeros_like(args[6])]
    no_mask = args[:2] + [torch.ones_like(args[2])] + args[3:]
    readings, err = {}, 0.0
    for name, a in (("prelu", args), ("relu", relu)):
        got = kernels.din_attention_bwd_fused(*a, *cot)
        want = kernels.din_attention_bwd_plain(*a, *cot)
        readings[name] = bwd_reading(got, want)
        err = max(err, max(float((g - w).abs().max()) for g, w in zip(got, want)))
    # what a backward that ignores the mask or drops the slopes would read
    want = kernels.din_attention_bwd_plain(*args, *cot)
    readings["broken_mask_ignored"] = bwd_reading(kernels.din_attention_bwd_plain(*no_mask, *cot), want)
    readings["broken_alpha_dropped"] = bwd_reading(kernels.din_attention_bwd_plain(*relu, *cot), want)
    # ragged: B that is no multiple of the grid, L = 1, D = 8/16/64, H that
    # is no multiple of 4
    for shape in ((1003, 64, 32, 36), (37, 1, 32, 36), (300, 64, 8, 36), (300, 64, 16, 36),
                  (300, 48, 64, 36), (257, 33, 16, 7)):
        a, c = case(*shape)
        readings["x".join(map(str, shape))] = bwd_reading(
            kernels.din_attention_bwd_fused(*a, *c), kernels.din_attention_bwd_plain(*a, *c)
        )
    print("din backward readings (error / limit):", json.dumps(readings), flush=True)
    for name, r in readings.items():
        worst = max(r.values())
        if name.startswith("broken"):
            check(worst > 1.0, f"the backward check cannot tell a {name} backward from a sound one")
        else:
            check(worst <= 1.0, f"din backward kernel vs plain at {name}: {r}")

    # What this run's mask needs: a masked step has s = 0 and dlin = 0, so its
    # dkeys row is 0 and it adds nothing to the sums. Bytes: q, mask, w1, b1,
    # w2, alpha, gp read, keys and gs read at live steps, dq, all of dkeys,
    # dw1, db1, dw2, dalpha written. Operations of the fold algorithm: per row
    # the fold (2 D·H FMAs), dq and the running sums (4 D·H); per live step
    # lin, dkeys and M (3 D·H) and gp·k (D), ~8 per column for the activation.
    live = int(args[2].sum())
    nbytes = 4 * (3 * b * d + live * d + b * l * d + b * l + live + 2 * (4 * d * h + 3 * h))
    ops = 2 * (3 * live * d * h + 6 * b * d * h + live * d) + 8 * live * h
    bound_ms, bound_by = bound(nbytes, ops)
    rec = dict(
        name="din_attention_bwd", route="cuda", source="tpurec_torch/csrc/din_attention_bwd.cu",
        replaces="tpurec/ops/pallas/kernels.py:484", shape=[b, l, d, h], live_steps=live, max_abs_err=err,
        ms=device_ms(torch, lambda: kernels.din_attention_bwd_fused(*args, *cot)),
        plain_ms=device_ms(torch, lambda: kernels.din_attention_bwd_plain(*args, *cot)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
    )
    print("kernel check:", json.dumps(rec), flush=True)
    return rec


def din_train_config(dtype, engine="dense", **train):
    """bench.py's DIN trainer; ``engine`` 'dense' or 'fused' (``fused_adam``)."""
    from tpurec_torch.config import (
        EmbeddingConfig, ExperimentConfig, ModelConfig, OptimizerConfig, TrainConfig,
    )

    fused = engine == "fused"
    return ExperimentConfig(
        model=ModelConfig(name="din", params=dict(DIN_FEATURES), embedding=EmbeddingConfig(dim=32)),
        train=TrainConfig(
            batch_size=TRAIN_BATCH, loss="bce", log_every_steps=0, compute_dtype=dtype,
            sparse_embedding=fused,
            optimizer=OptimizerConfig(
                learning_rate=1e-3, embedding_optimizer="fused_adam" if fused else "adam"
            ),
            **train,
        ),
    )


def one_train_step(torch, kernels, trainer, batch, attention=None):
    """One train step from the trainer's seeded weights: (loss, gradients,
    parameters after the update). ``attention`` = (forward, backward) takes
    the kernels' place."""
    with contextlib.ExitStack() as stack:
        if attention is not None:
            stack.enter_context(mock.patch.object(kernels, "din_attention_fused", attention[0]))
            stack.enter_context(mock.patch.object(kernels, "din_attention_bwd_fused", attention[1]))
        state = trainer.init_state(batch)
        state, _, logs = trainer.train_step(state, trainer.device_batch(batch), trainer.metrics.init())
    named = list(state.model.named_parameters())
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone() for n, p in named}
    return float(logs["loss"]), grads, {n: p.detach().clone() for n, p in named}


def step_reading(got, want) -> dict:
    (loss, grads, params), (want_loss, want_grads, want_params) = got, want
    grad = {n: scaled_ratio(grads[n], want_grads[n], 1.0) for n in want_grads}
    param = {n: float((params[n] - want_params[n]).abs().max()) for n in want_params}
    worst_grad, worst_param = max(grad, key=grad.get), max(param, key=param.get)
    return dict(
        loss=abs(loss - want_loss), grad_rel=grad[worst_grad], grad_worst=worst_grad,
        param=param[worst_param], param_worst=worst_param,
    )


def count_syncs(torch, fn) -> list:
    """The host-device synchronisations ``fn()`` makes, as PyTorch's sync
    debug mode reports them (a prototype that may miss some)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [str(w.message)[:200] for w in caught if "synchronizing" in str(w.message)]


def profile_steps(torch, step, steps=5):
    """``torch.profiler`` over ``steps`` calls of ``step()``: the device's
    busy time per step (the sum of its kernels, copies and fills) and the
    eight operators whose kernels take most of it, in ms per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    busy = sum(e.self_device_time_total for e in averages if e.device_type == DeviceType.CUDA)
    ops = sorted(
        (e for e in averages if e.device_type == DeviceType.CPU and e.self_device_time_total > 0),
        key=lambda e: -e.self_device_time_total,
    )
    return busy / steps / 1e3, {e.key: e.self_device_time_total / steps / 1e3 for e in ops[:8]}


def run_din_training(torch, kernels, workdir, card):
    from tpurec_torch.serving.export import load_servable
    from tpurec_torch.train.trainer import Trainer

    info = din_info()
    batch = bench_batch(info, TRAIN_BATCH, 64, seed=1)
    plain = (kernels.din_attention_plain, kernels.din_attention_bwd_plain)

    # one fp32 step: kernels against the plain attention, and a backward
    # that ignores the mask (the check has to be able to fail)
    fp32 = Trainer(din_train_config("float32"), info)
    sound = one_train_step(torch, kernels, fp32, batch)
    want = one_train_step(torch, kernels, fp32, batch, plain)

    def bwd_no_mask(q, k, m, *rest):
        return kernels.din_attention_bwd_plain(q, k, torch.ones_like(m), *rest)

    broken = one_train_step(torch, kernels, fp32, batch, (plain[0], bwd_no_mask))
    step = dict(kernels=step_reading(sound, want), broken_bwd_mask_ignored=step_reading(broken, want))

    # three fp32 steps on the card and on the CPU, first 256 rows
    rows = {k: v[:256] for k, v in batch.items()}
    on_cpu = Trainer(din_train_config("float32"), info, device="cpu")
    card_state, cpu_state = fp32.init_state(rows), on_cpu.init_state(rows)
    cpu_state.model.load_state_dict({k: v.cpu() for k, v in card_state.model.state_dict().items()})
    cpu_losses = []
    for _ in range(3):
        card_state, _, a = fp32.train_step(card_state, fp32.device_batch(rows), fp32.metrics.init())
        cpu_state, _, b = on_cpu.train_step(cpu_state, on_cpu.device_batch(rows), on_cpu.metrics.init())
        cpu_losses.append((float(a["loss"]), float(b["loss"])))
    step["cpu_256_rows_loss"] = max(abs(a - b) for a, b in cpu_losses)
    print("din train step checks:", json.dumps(dict(
        step, limits=dict(loss=STEP_LOSS_TOL, grad_rel=STEP_GRAD_RTOL, param=STEP_PARAM_TOL,
                          cpu_loss=CPU_LOSS_TOL), cpu_losses=cpu_losses,
    )), flush=True)
    sound, broken = step["kernels"], step["broken_bwd_mask_ignored"]
    check(sound["loss"] <= STEP_LOSS_TOL, f"train step loss, kernels vs plain: {sound}")
    check(sound["grad_rel"] <= STEP_GRAD_RTOL, f"train step gradients, kernels vs plain: {sound}")
    check(sound["param"] <= STEP_PARAM_TOL, f"train step parameters, kernels vs plain: {sound}")
    check(broken["grad_rel"] > STEP_GRAD_RTOL,
          "the train step check cannot tell a backward that ignores the mask from a sound one")
    check(step["cpu_256_rows_loss"] <= CPU_LOSS_TOL, f"train losses, card vs CPU: {cpu_losses}")

    # the main path: 30 bf16 steps on the fixed batch, as bench.py times them
    trainer = Trainer(din_train_config("bfloat16"), info)
    state = trainer.init_state(batch)
    dbatch = trainer.device_batch(batch)
    metric_state = trainer.metrics.init()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metric_state, logs = trainer.train_step(state, dbatch, metric_state)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(logs["loss"])
    launches = (kernels.din_attention_fused.launches, kernels.din_attention_bwd_fused.launches)
    losses = [float(x) for x in losses]
    step_ms = statistics.median(times[10:])

    # a CUDA-event breakdown of ten more steps, each copying its batch
    names = ("copy", "forward", "backward", "optimizer", "metrics", "end")
    spans = {n: [] for n in names[:-1]}
    events = {}

    def mark(name):
        events[name] = torch.cuda.Event(enable_timing=True)
        events[name].record()

    trainer.step_marks = mark
    for _ in range(10):
        mark("copy")
        state, metric_state, _ = trainer.train_step(state, trainer.device_batch(batch), metric_state)
        torch.cuda.synchronize()
        for a, b in zip(names, names[1:]):
            spans[a].append(events[a].elapsed_time(events[b]))
    trainer.step_marks = None
    breakdown = {n: statistics.median(v) for n, v in spans.items()}

    # no host sync inside a step; the device's busy time per step
    def step():
        nonlocal state, metric_state
        state, metric_state, _ = trainer.train_step(state, dbatch, metric_state)

    syncs = count_syncs(torch, step)
    check(count_syncs(torch, lambda: torch.ones(1, device="cuda").item()),
          "the sync check does not see the sync of .item()")
    busy_ms, top_ops = profile_steps(torch, step)

    result = dict(
        card=card, batch=TRAIN_BATCH, steps=TRAIN_STEPS, step_p50_ms=step_ms,
        step_ms_min=min(times[10:]), step_ms_max=max(times[10:]),
        examples_per_s=TRAIN_BATCH / (step_ms / 1e3), first_step_ms=times[0],
        breakdown_ms=breakdown, device_busy_ms=busy_ms, device_idle_share=1.0 - busy_ms / step_ms,
        top_ops_ms=top_ops, host_syncs=len(syncs), din_launches=launches[0], din_bwd_launches=launches[1],
        loss_first=losses[0], loss_last=losses[-1],
        train_auc=float(trainer.metrics.result(metric_state)["auc"]),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
    )
    print("din training:", json.dumps(result), flush=True)
    print("din training losses:", json.dumps(losses), flush=True)
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall in {TRAIN_STEPS} steps: {losses}")
    check(not syncs, f"train_step synchronised with the device: {syncs}")
    check(launches == (TRAIN_STEPS, TRAIN_STEPS),
          f"DIN forward/backward kernel launches {launches} in {TRAIN_STEPS} steps")

    # the entry points end to end (fp32: the export drops the compute dtype)
    ckpt_dir, export_dir = os.path.join(workdir, "ckpt"), os.path.join(workdir, "din_trained")
    cfg = din_train_config("float32", epochs=2, checkpoint_dir=ckpt_dir, max_to_keep=2)
    trainer = Trainer(cfg, info)
    train = [bench_batch(info, 1024, 64, seed=10 + i) for i in range(4)]
    evals = [bench_batch(info, 1024, 64, seed=20 + i) for i in range(2)]
    state, report = trainer.run(lambda: iter(train), lambda: iter(evals))
    saved = trainer.ckpt.all_steps()
    check(state.step == 2 * len(train) and 1 <= len(saved) <= 2 and saved[-1] <= state.step,
          f"checkpoints {saved} at step {state.step}")
    trainer.save(state)
    restored = trainer.restore(trainer.init_state(seed=123))
    want_sd = state.model.state_dict()
    check(restored.step == state.step and all(
        torch.equal(v, want_sd[k]) for k, v in restored.model.state_dict().items()
    ), "restore did not give back the saved parameters")
    trainer.export(state, export_dir)
    servable = load_servable(export_dir, info, device="cuda")
    rows = {k: v[:512] for k, v in evals[0].items() if k != "label"}
    served = servable.predict(rows)["output"].cpu().numpy()
    inferred = trainer.infer(state, rows)["output"]
    serve_err = float(np.abs(served - inferred).max())
    print("din train entry points:", json.dumps(dict(
        best_epoch=report["best_epoch"], eval=report["best_eval"], checkpoints=saved,
        served_vs_infer=serve_err,
    )), flush=True)
    check(serve_err <= 1e-6, f"served prediction vs Trainer.infer: {serve_err}")
    return launches, result


# ---------------------------------------------------------------------------
# phase 7: the embedding engines at full width
# Kernel #9 against scatter_add_plain, row by row: within SUM_RTOL (2^-20,
# 16 fp32 ulps) of the sum of the row's |g| plus SUM_ATOL. Both are fp32
# sums of the same terms in other orders (index_add_ on the card adds with
# atomics, in no fixed order); DIN's padding run of ~2e5 rows sums to ~4e2.
SUM_RTOL, SUM_ATOL = 2.0**-20, 1e-7
# One fp32 fused step against one fp32 dense step from the same weights and
# batch: the loss; every parameter and table after Adam (whose first step
# moves a weight by about lr = 1e-3 in the direction of g); each table's
# first moment (0.1·G, G summed in another order) against 1e-4 of its
# largest value.
ENGINE_LOSS_TOL = 1e-5
ENGINE_PARAM_TOL = 1e-5
ENGINE_MOMENT_RTOL = 1e-4
FM_TABLES = ("v.embedding", "w.w.embedding")


def fm_info():
    """``bench.py:_fm_info()``: 26 fields of 80,000 ids (2,080,128 padded rows)."""
    from tpurec_torch.data.schema import DataInfo

    return DataInfo.from_dims([f"f{i}" for i in range(26)], [80_000] * 26)


def fm_train_config(mode, dtype="bfloat16", **train):
    """``bench.py:_mk_trainer("fm", _fm_info(), 8192, mode)``: D=32, bce,
    Adam lr 1e-3 eps 1e-7. ``mode``: 'dense', 'fused' (fused_adam), 'sparse'
    (rowwise_adam), 'host' (host_adam) or 'lazy' (lazy Adam)."""
    from tpurec_torch.config import (
        EmbeddingConfig, ExperimentConfig, ModelConfig, OptimizerConfig, TrainConfig,
    )

    emb_opt = dict(dense="adam", fused="fused_adam", sparse="rowwise_adam", host="host_adam",
                   lazy="adam")[mode]
    return ExperimentConfig(
        model=ModelConfig(name="fm", embedding=EmbeddingConfig(dim=32)),
        train=TrainConfig(
            batch_size=TRAIN_BATCH, loss="bce", log_every_steps=0, compute_dtype=dtype,
            sparse_embedding=mode != "dense",
            optimizer=OptimizerConfig(learning_rate=1e-3, embedding_optimizer=emb_opt), **train,
        ),
    )


def flat_ids(info, batch):
    """The step's ids as the fused engine concatenates them: features in
    order, then each (B, L) sequence column-major."""
    cols = [batch[n] for n in info.feature_names]
    cols += [batch[n].T for n in info.sequence_names]
    return np.concatenate([c.reshape(-1) for c in cols])


def sum_reading(torch, eu, got, plan, grads) -> float:
    """max over rows of |got − plain| / (SUM_ATOL + SUM_RTOL · Σ|g| of the row)."""
    want = eu.scatter_add_plain(plan.num_rows, plan.sids, grads)
    scale = eu.scatter_add_plain(plan.num_rows, plan.sids, grads.abs())
    return float(((got - want).abs() / (SUM_ATOL + SUM_RTOL * scale)).max())


def broken_scatters(torch, eu):
    """Kernel #9 as two broken versions would compute it (plain math): one
    that loses what a run carries past the slice it begins in, one that keeps
    only each id's first occurrence. Each reading must exceed its limit."""
    slice_rows = eu.scatter_slice_rows()

    def drop_carried(table_rows, d, plan, grads_sorted):
        g = grads_sorted.reshape(plan.n, d)
        start = torch.searchsorted(plan.sids, plan.sids)  # where each run begins
        keep = torch.arange(plan.n, device=g.device) // slice_rows == start // slice_rows
        return eu.scatter_add_plain(table_rows, plan.sids[keep], g[keep])

    def first_only(table_rows, d, plan, grads_sorted):
        g = grads_sorted.reshape(plan.n, d)
        keep = torch.ones(plan.n, dtype=torch.bool, device=g.device)
        keep[1:] = plan.sids[1:] != plan.sids[:-1]
        return eu.scatter_add_plain(table_rows, plan.sids[keep], g[keep])

    return dict(broken_drop_carried=drop_carried, broken_first_only=first_only), slice_rows


def check_embedding_kernels(torch, eu):
    """Kernels #9 and #10 against their plain versions (phase 7a, 7b)."""
    from tpurec_torch.embedding.ops import pad_vocab

    gen = torch.Generator(device="cuda").manual_seed(7)
    broken, slice_rows = broken_scatters(torch, eu)
    finfo, dinfo = fm_info(), din_info()
    fm_ids = flat_ids(finfo, bench_batch(finfo, TRAIN_BATCH, 0, seed=1))
    din_ids = flat_ids(dinfo, bench_batch(dinfo, TRAIN_BATCH, 64, seed=1))
    v_fm, v_din = pad_vocab(finfo.total_dims), pad_vocab(dinfo.total_dims)
    ragged = torch.randint(0, 300, (1003,), device="cuda", generator=gen)
    cases = {
        "fm_v": (fm_ids, v_fm, 32), "fm_w": (fm_ids, v_fm, 1), "din": (din_ids, v_din, 32),
        "ragged_d8": (ragged, 300, 8), "ragged_d64": (ragged, 300, 64),
        "ragged_d160": (ragged, 300, 160), "all_equal": (np.full(5000, 150), 300, 4),
        "empty": (np.zeros(0, np.int64), 300, 8),
    }
    readings, records = {}, {}
    for name, (ids, v, d) in cases.items():
        plan = eu.make_scatter_plan(torch.as_tensor(ids, device="cuda"), v)
        grads = torch.randn(plan.n, d, device="cuda", generator=gen)
        got = eu.fused_scatter_add(v, d, plan, grads)
        again = eu.fused_scatter_add(v, d, plan, grads)
        r = dict(n=plan.n, rows=v, d=d, same_bits=bool(torch.equal(got, again)))
        r["kernel"] = sum_reading(torch, eu, got, plan, grads) if plan.n else float(got.abs().max())
        if plan.n:
            s = plan.sids
            start = torch.searchsorted(s, s)
            pos = torch.arange(plan.n, device="cuda")
            r["crossing_rows"] = int((pos // slice_rows != start // slice_rows).sum())
            r["repeated_rows"] = int((s[1:] == s[:-1]).sum())
            for bname, fn in broken.items():
                r[bname] = sum_reading(torch, eu, fn(v, d, plan, grads), plan, grads)
        readings[name] = r
        if name in ("fm_v", "fm_w", "din"):
            # bytes: grads and ids read once, all of G written once; one add
            # a gradient element
            bound_ms, bound_by = bound(4 * (plan.n * d + plan.n + v * d), plan.n * d)
            plain = lambda: eu.scatter_add_plain(v, plan.sids, grads)  # noqa: E731
            rec = dict(
                name="fused_scatter_add", route="cuda", source="tpurec_torch/csrc/embedding_update.cu",
                replaces="tpurec/ops/pallas/embedding_update.py:231", shape=[plan.n, v, d],
                max_abs_err=float((got - plain()).abs().max()),
                ms=device_ms(torch, lambda: eu.fused_scatter_add(v, d, plan, grads)),
                plain_ms=device_ms(torch, plain),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=device_ms(torch, lambda: torch.zeros(v, d, device="cuda").index_add_(
                    0, plan.sids, grads)),
            )
            if name == "din":
                rec["id0_share"] = float((din_ids == 0).mean())
                # the dense engine's table gradient on the same stream, with
                # the padding run and with id 0 replaced by random ids: does
                # the one long segment set its time?
                ids = torch.as_tensor(din_ids, device="cuda")
                spread = torch.where(ids == 0, torch.randint(1, v, ids.shape, device="cuda",
                                                             generator=gen), ids)
                dense_bwd = torch.ops.aten.embedding_dense_backward
                rec["embedding_dense_backward_ms"] = device_ms(
                    torch, lambda: dense_bwd(grads, ids, v, -1, False))
                rec["embedding_dense_backward_no_id0_run_ms"] = device_ms(
                    torch, lambda: dense_bwd(grads, spread, v, -1, False))
            records[name] = rec
            print("kernel check:", json.dumps(rec), flush=True)
    print(f"fused_scatter_add readings (error / limit; limit = {SUM_ATOL} + {SUM_RTOL} · Σ|g| "
          f"of the row, fp32 sums in another order; slices of {slice_rows} rows):",
          json.dumps(readings), flush=True)
    for name, r in readings.items():
        check(r["same_bits"], f"fused_scatter_add at {name}: two calls gave different bits")
        check(r["kernel"] <= 1.0, f"fused_scatter_add vs plain at {name}: {r}")
        if r.get("crossing_rows"):
            check(r["broken_drop_carried"] > 1.0,
                  f"the check cannot tell a #9 that drops carried runs at {name}: {r}")
        if r.get("repeated_rows"):
            check(r["broken_first_only"] > 1.0,
                  f"the check cannot tell a #9 that keeps first occurrences at {name}: {r}")
    check(all(readings[n].get("crossing_rows") for n in ("fm_v", "din", "all_equal")),
          "no run crossed a slice at the FM, DIN or all-equal shape")

    # kernel #10: copies, so exact; a gather of the neighbouring rows must differ
    gather = {}
    for name, (ids, v, d) in dict(
        fm=(fm_ids, v_fm, 32), ragged_d5=(ragged, 300, 5), ragged_d64=(ragged, 300, 64),
        ragged_d160=(ragged, 300, 160), empty=(np.zeros(0, np.int64), 300, 8),
    ).items():
        plan = eu.make_scatter_plan(torch.as_tensor(ids, device="cuda"), v)
        table = torch.randn(v, d, device="cuda", generator=gen)
        rows = eu.gather_rows_sorted(table, plan)
        want = eu.gather_rows_plain(table, plan.sids)
        neighbour = table.index_select(0, (plan.sids ^ 1).clamp_max(v - 1))
        gather[name] = dict(exact=bool(torch.equal(rows, want)), n=plan.n, d=d,
                            broken_neighbour_rows_differ=bool(plan.n == 0 or not torch.equal(
                                neighbour, want)))
        if name == "fm":
            bound_ms, bound_by = bound(4 * (plan.n + 2 * plan.n * d), 0)
            records["gather"] = dict(
                name="gather_rows_sorted", route="cuda", source="tpurec_torch/csrc/embedding_update.cu",
                replaces="tpurec/ops/pallas/embedding_update.py:419", shape=[plan.n, v, d],
                max_abs_err=float((rows - want).abs().max()),
                ms=device_ms(torch, lambda: eu.gather_rows_sorted(table, plan)),
                plain_ms=device_ms(torch, lambda: eu.gather_rows_plain(table, plan.sids)),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=device_ms(torch, lambda: table.index_select(0, plan.sids)),
            )
            print("kernel check:", json.dumps(records["gather"]), flush=True)
    print("gather_rows_sorted readings (exact copies):", json.dumps(gather), flush=True)
    for name, r in gather.items():
        check(r["exact"] and r["broken_neighbour_rows_differ"], f"gather_rows_sorted at {name}: {r}")
    return records


def drive_steps(torch, trainer, state, dbatch, steps=TRAIN_STEPS):
    """``steps`` train steps on one batch, each synchronised: (state, metric
    state, losses, host times in ms)."""
    metric_state = trainer.metrics.init()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metric_state, logs = trainer.train_step(state, dbatch, metric_state)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(logs["loss"])
    return state, metric_state, [float(x) for x in losses], times


def step_breakdown(torch, trainer, step, steps=10) -> dict:
    """Median CUDA-event span, over ``steps`` calls of ``step()``, from each
    of the trainer's step marks to the next (forward, backward, optimizer
    with the table update, metrics); a span holds device idle time too."""
    names = ("forward", "backward", "optimizer", "metrics", "end")
    spans = {n: [] for n in names[:-1]}
    events = {}

    def mark(name):
        events[name] = torch.cuda.Event(enable_timing=True)
        events[name].record()

    trainer.step_marks = mark
    try:
        for _ in range(steps):
            step()
            torch.cuda.synchronize()
            for a, b in zip(names, names[1:]):
                spans[a].append(events[a].elapsed_time(events[b]))
    finally:
        trainer.step_marks = None
    return {n: statistics.median(v) for n, v in spans.items()}


def engine_run(torch, kernels, eu, name, trainer, batch, card):
    """The main path of one engine: 30 steps on the fixed batch with the
    launch counts set to 0 before and read after, then the sync check and a
    profiler summary. Returns (counts, result)."""
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state(batch)
    dbatch = trainer.device_batch(batch)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    state, metric_state, losses, times = drive_steps(torch, trainer, state, dbatch)
    counts = dict(din_attention=kernels.din_attention_fused.launches,
                  din_attention_bwd=kernels.din_attention_bwd_fused.launches,
                  fused_scatter_add=eu.fused_scatter_add.launches,
                  gather_rows_sorted=eu.gather_rows_sorted.launches)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 2**30

    def step():
        nonlocal state, metric_state
        state, metric_state, _ = trainer.train_step(state, dbatch, metric_state)

    breakdown = step_breakdown(torch, trainer, step)
    syncs = count_syncs(torch, step)
    busy_ms, top_ops = profile_steps(torch, step)
    step_ms = statistics.median(times[10:])
    result = dict(
        card=card, engine=name, batch=TRAIN_BATCH, steps=TRAIN_STEPS, step_p50_ms=step_ms,
        step_ms_min=min(times[10:]), step_ms_max=max(times[10:]),
        examples_per_s=TRAIN_BATCH / (step_ms / 1e3), first_step_ms=times[0],
        breakdown_ms=breakdown, device_busy_ms=busy_ms, device_idle_share=1.0 - busy_ms / step_ms,
        top_ops_ms=top_ops, host_syncs=len(syncs), launches=counts, loss_first=losses[0], loss_last=losses[-1],
        peak_mem_gb=peak_gb,
    )
    print(f"{name} training:", json.dumps(result), flush=True)
    check(all(np.isfinite(losses)), f"{name}: non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"{name}: the loss did not fall in {TRAIN_STEPS} steps: {losses}")
    check(not syncs, f"{name}: train_step synchronised with the device: {syncs}")
    return counts, result


def one_step_state(torch, trainer, batch, tables):
    """One step from the trainer's seeded weights: (loss, parameters, first
    moment of each table)."""
    state = trainer.init_state(batch)
    state, _, logs = trainer.train_step(state, trainer.device_batch(batch), trainer.metrics.init())
    named = dict(state.model.named_parameters())
    if state.table_opt is not None:
        moments = {n: state.table_opt[n].m.clone() for n in tables}
    else:
        moments = {n: state.optimizer.state[named[n]]["mu"].clone() for n in tables}
    return float(logs["loss"]), {n: p.detach().clone() for n, p in named.items()}, moments


def engine_reading(got, want) -> dict:
    (loss, params, moments), (want_loss, want_params, want_moments) = got, want
    param = {n: float((params[n] - want_params[n]).abs().max()) for n in want_params}
    moment = {n: scaled_ratio(moments[n], want_moments[n], ENGINE_MOMENT_RTOL) for n in want_moments}
    worst = max(param, key=param.get)
    return dict(loss=abs(loss - want_loss), param=param[worst], param_worst=worst,
                moment_ratio=max(moment.values()), moments=moment)


def fused_vs_dense(torch, eu, config_fn, info, batch, tables, label):
    """One fp32 fused step against one fp32 dense step from the same weights
    and batch, and a fused step built on a #9 that drops carried runs."""
    from tpurec_torch.train.trainer import Trainer

    want = one_step_state(torch, Trainer(config_fn("dense"), info), batch, tables)
    fused = Trainer(config_fn("fused"), info)
    reading = dict(fused=engine_reading(one_step_state(torch, fused, batch, tables), want))
    with mock.patch.object(eu, "fused_scatter_add", broken_scatters(torch, eu)[0]["broken_drop_carried"]):
        reading["broken_drop_carried"] = engine_reading(
            one_step_state(torch, fused, batch, tables), want
        )
    print(f"{label} fp32 fused step vs dense step:", json.dumps(dict(
        reading, limits=dict(loss=ENGINE_LOSS_TOL, param=ENGINE_PARAM_TOL,
                             moment_rtol=ENGINE_MOMENT_RTOL),
    )), flush=True)
    r = reading["fused"]
    check(r["loss"] <= ENGINE_LOSS_TOL and r["param"] <= ENGINE_PARAM_TOL and r["moment_ratio"] <= 1.0,
          f"{label}: fused step vs dense step: {r}")
    check(reading["broken_drop_carried"]["moment_ratio"] > 1.0,
          f"{label}: the step check cannot tell a #9 that drops carried runs")
    return reading


def run_fm_engines(torch, kernels, eu, workdir, card):
    """FM at bench.py's width in the dense, fused and rowwise_adam engines,
    then their checks (phase 7c, 7e, 7f)."""
    from tpurec_torch.serving.export import load_servable
    from tpurec_torch.train.trainer import Trainer

    info = fm_info()
    batch = bench_batch(info, TRAIN_BATCH, 0, seed=1)
    results, counts = {}, {}
    for mode, name in (("dense", "fm_dense"), ("fused", "fm_fused_adam"),
                       ("sparse", "fm_rowwise_adam")):
        counts[name], results[name] = engine_run(
            torch, kernels, eu, name, Trainer(fm_train_config(mode), info), batch, card
        )
    check(counts["fm_fused_adam"]["fused_scatter_add"] == 2 * TRAIN_STEPS,
          f"the fused FM step did not launch #9 twice a step: {counts['fm_fused_adam']}")
    check(counts["fm_dense"]["fused_scatter_add"] == counts["fm_rowwise_adam"]["fused_scatter_add"] == 0,
          "a dense or lazy step launched #9")

    # the fused engine is dense Adam: one fp32 step each from the same weights
    fused_vs_dense(torch, eu, lambda m: fm_train_config(m, "float32"), info, batch, FM_TABLES, "fm")

    # three fp32 steps on 256 rows, card against the port on the CPU
    rows = {k: v[:256] for k, v in batch.items()}
    cpu_losses = {}
    for mode in ("fused", "sparse"):
        card_t = Trainer(fm_train_config(mode, "float32"), info)
        cpu_t = Trainer(fm_train_config(mode, "float32"), info, device="cpu")
        card_s, cpu_s = card_t.init_state(rows), cpu_t.init_state(rows)
        cpu_s.model.load_state_dict({k: v.cpu() for k, v in card_s.model.state_dict().items()})
        pairs = []
        for _ in range(3):
            card_s, _, a = card_t.train_step(card_s, card_t.device_batch(rows), card_t.metrics.init())
            cpu_s, _, b = cpu_t.train_step(cpu_s, cpu_t.device_batch(rows), cpu_t.metrics.init())
            pairs.append((float(a["loss"]), float(b["loss"])))
        cpu_losses[mode] = pairs
        del card_s, cpu_s
    print("fm card vs cpu losses (256 rows):", json.dumps(dict(losses=cpu_losses, limit=CPU_LOSS_TOL)),
          flush=True)
    for mode, pairs in cpu_losses.items():
        check(max(abs(a - b) for a, b in pairs) <= CPU_LOSS_TOL, f"fm {mode}: card vs CPU {pairs}")

    # host_adam: the lazy Adam math with moments on the host (fp32 compute:
    # in bf16 a 1e-8 difference in a table can flip a rounding of the loss
    # and its gradient by 2^-8, which is not what this compares)
    host = {}
    for mode in ("lazy", "host"):
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(fm_train_config(mode, "float32"), info)
        state = trainer.init_state(batch)
        dbatch = trainer.device_batch(batch)
        state, _, losses, times = drive_steps(torch, trainer, state, dbatch, steps=3)
        host[mode] = dict(
            tables={n: state.model.get_parameter(n).detach()[:-1].clone() for n in FM_TABLES},
            peak_mem_gb=(torch.cuda.max_memory_allocated() - base) / 2**30, step_ms=times,
            losses=losses,
            host_moment_gb=None if state.host_store is None else state.host_store.nbytes() / 2**30,
        )
        del trainer, state
    host_err = max(float((host["host"]["tables"][n] - host["lazy"]["tables"][n]).abs().max())
                   for n in FM_TABLES)
    print("fm host_adam vs lazy adam:", json.dumps(dict(
        card=card, table_err=host_err, limit=ENGINE_PARAM_TOL,
        **{m: {k: v for k, v in r.items() if k != "tables"} for m, r in host.items()},
    )), flush=True)
    check(host_err <= ENGINE_PARAM_TOL, f"host_adam vs lazy adam tables: {host_err}")

    # run -> restore -> export -> load_servable -> predict on a fused-trained FM
    ckpt_dir, export_dir = os.path.join(workdir, "fm_ckpt"), os.path.join(workdir, "fm_export")
    cfg = fm_train_config("fused", "float32", epochs=1, checkpoint_dir=ckpt_dir, max_to_keep=1)
    trainer = Trainer(cfg, info)
    train = [bench_batch(info, 1024, 0, seed=30 + i) for i in range(4)]
    evals = [bench_batch(info, 1024, 0, seed=40)]
    state, report = trainer.run(lambda: iter(train), lambda: iter(evals))
    trainer.save(state)
    restored = trainer.restore(trainer.init_state(seed=123))
    same_opt = all(
        torch.equal(getattr(restored.table_opt[n], f), getattr(state.table_opt[n], f))
        for n in FM_TABLES for f in ("m", "v")
    )
    want_sd = state.model.state_dict()
    same_params = all(torch.equal(v, want_sd[k]) for k, v in restored.model.state_dict().items())
    trainer.export(state, export_dir)
    servable = load_servable(export_dir, info, device="cuda")
    rows = {k: v[:512] for k, v in evals[0].items() if k != "label"}
    serve_err = float(np.abs(servable.predict(rows)["output"].cpu().numpy()
                             - trainer.infer(state, rows)["output"]).max())
    print("fm fused entry points:", json.dumps(dict(
        steps=state.step, eval=report["best_eval"], restored_table_opt_equal=same_opt,
        restored_params_equal=same_params, served_vs_infer=serve_err,
    )), flush=True)
    check(state.step == len(train) and restored.step == state.step, "fm fused run/restore steps")
    check(same_opt and same_params, "restore did not give back the saved tables and table_opt")
    check(serve_err <= 1e-6, f"fm served prediction vs Trainer.infer: {serve_err}")
    return counts["fm_fused_adam"]["fused_scatter_add"], results


def run_din_fused(torch, kernels, eu, card):
    """DIN at phase 6's width on the fused engine (phase 7d)."""
    from tpurec_torch.train.trainer import Trainer

    info = din_info()
    batch = bench_batch(info, TRAIN_BATCH, 64, seed=1)
    fused_vs_dense(torch, eu, lambda m: din_train_config("float32", m), info, batch,
                   ("emb.embedding",), "din")
    counts, result = engine_run(torch, kernels, eu, "din_fused_adam",
                                Trainer(din_train_config("bfloat16", "fused"), info), batch, card)
    want = dict(din_attention=TRAIN_STEPS, din_attention_bwd=TRAIN_STEPS,
                fused_scatter_add=TRAIN_STEPS, gather_rows_sorted=0)
    check(counts == want, f"DIN fused launches {counts}, expected {want}")
    return counts, result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from tpurec_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print("torch", torch.__version__, "cuda", torch.version.cuda, "tf32",
          torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, flush=True)

    t0 = time.perf_counter()
    paths = kernels.build()
    print(f"built {sorted(paths)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for path in paths.values():
        log = open(f"{path}.log").read()
        print("\n".join(line for line in log.splitlines() if "Used" in line or "spill" in line))

    from tpurec_torch.ops import embedding_update as eu

    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    records = timed("3_kernels", check_kernels, torch, kernels)
    records["din_attention_bwd"] = timed("6_din_backward", check_din_backward, torch, kernels)
    embedding = timed("7ab_embedding_kernels", check_embedding_kernels, torch, eu)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR.parent) as workdir:
        serve_launches, _ = timed("4_din_servable", run_din_servable, torch, kernels, workdir, smi)
        records["fm_second_order"]["launches"], _ = timed(
            "5_http", run_http, torch, kernels, workdir, smi
        )
        (train_launches, bwd_launches), _ = timed(
            "6_din_training", run_din_training, torch, kernels, workdir, smi
        )
        fm_scatter_launches, _ = timed(
            "7cef_fm_engines", run_fm_engines, torch, kernels, eu, workdir, smi
        )
        din_fused, _ = timed("7d_din_fused", run_din_fused, torch, kernels, eu, smi)
    print("phase seconds:", json.dumps(seconds), flush=True)
    # a kernel on several paths: its launches are their sum
    forward_paths = dict(din_serving=serve_launches, din_training=train_launches,
                         din_fused_training=din_fused["din_attention"])
    records["din_attention"]["launches"] = sum(forward_paths.values())
    records["din_attention"]["launches_by_path"] = forward_paths
    bwd_paths = dict(din_training=bwd_launches, din_fused_training=din_fused["din_attention_bwd"])
    records["din_attention_bwd"]["launches"] = sum(bwd_paths.values())
    records["din_attention_bwd"]["launches_by_path"] = bwd_paths
    scatter_paths = dict(fm_fused_training=fm_scatter_launches,
                         din_fused_training=din_fused["fused_scatter_add"])
    records["fused_scatter_add"] = dict(embedding["fm_v"], launches=sum(scatter_paths.values()),
                                        launches_by_path=scatter_paths)
    # #10 is on no training path, in either package: checked and timed alone
    records["gather_rows_sorted"] = dict(embedding["gather"], launches=0, launches_by_path={})

    print(json.dumps({"card": smi, "kernels": list(records.values())}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
