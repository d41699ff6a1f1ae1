#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --scatter   # kernel #9's D sweep alone (phase 7a's)
    python3 chip_smoke.py --din       # kernel #4's checks alone (phase 3's)
    python3 chip_smoke.py --din-ab DIR  # #4 of the checkout DIR against this one's
    python3 chip_smoke.py --din-bwd   # kernel #5's checks alone (phase 6's)
    python3 chip_smoke.py --capsule   # kernels #7/#8's checks alone (phase 9a's)
    python3 chip_smoke.py --capsule-bwd-ab DIR  # #8 of the checkout DIR against this one's
    python3 chip_smoke.py --cin       # kernel #3's checks alone (phase 8a's)
    python3 chip_smoke.py --fm        # kernel #1's checks alone (phase 3's)
    python3 chip_smoke.py --fm-ab DIR  # #1 of the checkout DIR against this one's
    python3 chip_smoke.py --cross     # kernel #2's checks alone (phase 8a's)
    python3 chip_smoke.py --cross-ab DIR  # #2 of the checkout DIR against this one's

Needs one CUDA card and ``nvcc`` (``$CUDA_HOME/bin`` or ``PATH``); ``triton``
only for ``--fm-ab`` and ``--cross-ab`` against a parent whose #1 and #2
were Triton kernels. It builds every kernel from the sources in this
checkout and exits non-zero on the first phase that fails. Phases:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels (``tpurec_torch.ops.kernels.build``);
3. each kernel against its plain PyTorch version on the same CUDA tensors at
   the serving shapes, fp32 with TF32 off, tolerance atol = rtol = 1e-4
   (the two sum in different orders); device time per launch (median of 30,
   CUDA events, L2 flushed before each launch), the plain version's time and
   the bound: the larger of the bytes the function must move over 3.35 TB/s
   and the fp32 operations the kernel does over 67 TFLOP/s (H100 SXM data
   sheet; #3's products on the tensor cores over 495 TFLOP/s TF32, three
   TF32 multiply-adds per fp32 one, in phase 8a). #4 (DIN attention) at
   the serving shape B=8192, L=64, D=32, H=36 with and without PReLU
   slopes, at ragged shapes (B=1003; L=1 and 33; D=8/16/64; H=7; H=128,
   the tensor-core kernel's widest build, and 129 and 200, which take the
   fp32 kernel) and with a mask with holes (``holey_mask``: random steps,
   an all-zero row, a row live at its last step only), each output's
   error in units of the limit; a forward that ignores the mask, drops the
   slopes or takes lin in single TF32 (``broken_single_tf32``; the kernel
   takes it in 3xTF32) must read above it; two calls the same bits; its
   device time also at B=4096, 1024 and 1; ``--din`` runs this alone and
   adds the launch floor and the launch's blocks, warps and shared memory;
   ``--din-ab DIR`` times the kernel of the checkout DIR against this one's
   (parent, change, change, parent). #1 (the FM cross term) at deepfm's
   F=26, D=32 and B=8192, 256, 32 and 8 (the rank path's buckets), and at
   B=8192 with an input 4 bytes off a 16-byte boundary (4-byte loads); a
   term that drops the last field or squares after summing over columns
   must read above the limit; two calls the same bits; device times beside
   the launch floor (an empty kernel's time); ``--fm`` runs this alone and
   adds the launches' blocks and warps, the registers and spills, the 4-byte
   loads' time and ``flush_times`` (the time with L2 flushed by a read and
   with the input in L2, beside one PyTorch call over the same bytes),
   ``--fm-ab DIR`` as ``--din-ab``;
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
   the check has to be able to fail; predict p50 of 10 after 2 warm-ups and
   a profiler summary of 5 calls (here and in phases 6 and 7 the DIN
   kernels' device time is listed beside the top operators);
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
     training shape (with and without PReLU slopes), at ragged shapes and
     with a mask with holes (an all-zero row, a row live only at its last
     step), each output's error in units of its limit (``bwd_reading``); a
     backward that ignores the mask or drops the slopes, and the kernel's
     unfolded products in single TF32 (``broken_single_tf32``; the kernel
     computes them in 3xTF32), must read above the limit; two calls the
     same bits; its device time at B=8192 and B=1024, the per-launch split
     (``torch.profiler``), the occupancy query's block count, the bound and
     the bytes-only bound (the tensor cores lift the operations limit), and
     the plain version's time (``--din-bwd`` runs this alone);
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
     V=300, D=3/8/33/64/160; every id equal; N=0): each row's error in
     units of its limit (``SUM_RTOL``), two calls the same bits, and
     versions that drop what runs carry past the kernel's tile or slice
     (``scatter_tile_rows``, ``scatter_slice_rows``: some run must cross a
     slice at FM v, DIN and all-equal, and a tile at DIN and all-equal) or
     keep only first occurrences reading above the limit; device time,
     bound, plain and ``index_add_`` times, and the device time of each
     kernel or memset it launches (``torch.profiler``). Then
     its D sweep: FM's stream at D = 1, 4, 8, 16, 32, 64 and DIN's at D=32,
     each checked and timed the same way. Kernel #10
     (``gather_rows_sorted``) exactly equal to ``index_select`` at the FM
     shape and ragged shapes, with its times;
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

8. the DCN family over the phase 5/7 FM schema (2.08M rows), B=8192, bf16
   dense compute, fp32 params, random seeded weights: ``dcn`` (D=16, three
   vector cross layers: #2 at (8192, 416, L=3)), ``xdeepfm`` (D=32, CIN
   (128, 128): #3) and ``fibinet`` (D=32, 'all' mode, reduction 3: #6),
   each with an MLP (64, 32):
   - 8a: #2, #3 and #6 against their plain versions at those shapes, #2
     also at ``evaluate``'s B=1024 and with x0, w and b off a 16-byte
     boundary (4-byte units), #3 also at ``benchmarks/kernel_bench.py``'s
     B=4096, ``evaluate``'s B=1024, the rank path's buckets B=256, 32 and 8
     and B=1 (the first rows of the B=1024 batch, held to that batch's
     column scale), and at ragged shapes
     (#2 at D=429 with L=2 and 6; #3 at F=7, D=8, sizes (5, 9, 3); #6 at
     F=5 and F=2, D=24); #2 and #6 at ``KERNEL_TOL``, #3 at
     ``CIN_COL_RTOL`` of each output column's largest |value|; a cross
     that dots x0, a CIN that pairs maps with maps or takes its products
     in single TF32 (``broken_single_tf32``; the kernel takes them in
     3xTF32) and a SENet-bilinear with (j, i) pairs must read above the
     limit; two calls of #2 and #3 the same bits; device time, bound and
     the plain version's time, #2 and #3 beside the launch floor, #3 beside
     two bounds (its products in 3xTF32 on the tensor cores, and all of it
     in fp32 FMA); ``--cin`` runs #3's part alone with its block's shared
     memory and the blocks an SM holds, ``--cross`` #2's with its route,
     blocks, registers and spills, the 4-byte units' time and
     ``flush_times``, ``--cross-ab DIR`` as ``--din-ab``;
   - 8b: ``export_params`` → ``load_servable`` → ``Servable.predict``:
     finite probabilities, the model's kernel launched once a call and the
     other two not at all; the kernel's call inside the servable against
     the plain version on its own inputs, which the broken version must
     miss; the fp32 logit against the same servable run through the plain
     version and against the port on the CPU over the first 256 rows
     (``DCN_LOGIT_RTOL`` of the largest |logit|); predict p50 of 10 after 2
     warm-ups and a profiler summary of 5 calls;
   - 8c: ``DCN_STEPS`` bf16 ``Trainer.train_step``s on a fixed seed-1
     batch: losses finite and falling, no launch of #2/#3/#6 (training
     takes the plain math, as the JAX package); ``evaluate`` on two batches
     launches the model's kernel once a batch; step p50 (steps 5-19), peak
     memory and a profiler summary of 5 more steps.

9. MIND over the phase 4 id space with two aligned series (``history``,
   ``history_tags``), D=32 (so capsules of 64), K=4, three routing
   iterations, capsule MLP (64,), ``normalize_logits``, bf16 compute, fp32
   params, random seeded weights:
   - 9a: #7 and #8 against their plain versions at (8192, 64, 64, 64, K=4),
     ``benchmarks/kernel_bench.py``'s B=4096 and ragged shapes (1 and 2
     iterations, a row whose mask is all zero), each output's error in
     units of its limit, and two calls of each the same bits; both also
     with a mask with holes (``mask_with_holes``: random steps, an all-zero
     row, a row live at its last step only); a forward that ignores the
     mask, runs one iteration fewer or takes its products in single TF32
     (``broken_single_tf32``; the kernel computes u = x·S in 3xTF32), and
     a backward that differentiates through the stop-gradient iterations,
     gives dlogits0 only the last iteration or takes its tensor-core
     products u = x·S and dz·Sᵀ in single TF32 (``broken_bwd_single_tf32``;
     the kernel takes them in 3xTF32), must read above it; device times,
     bounds, plain times, the
     per-launch split (``torch.profiler``) and the blocks the card holds at
     once; #7 also at the serving paths' B=1 and B=1024 and #8 at B=1024,
     each beside the launch floor (an empty kernel's time in the same
     harness); #8's route (the tensor-core kernel at the slice's shape);
     ``--capsule`` runs this alone and adds #7's time at B=1 and B=1024 for
     1, 2 and 3 iterations and both kernels' registers and spills;
     ``--capsule-bwd-ab DIR`` times #8 of the checkout DIR against this
     one's (parent, change, change, parent at B=8192, 4096 and 1024), #7
     of both (the same bits), and the kernel-pair A/B below through each
     tree's pair;
   - 9b: ``export_params`` → ``load_servable`` → ``predict`` at B=8192 (#7
     once a call; its call held against the plain and broken versions on
     its inputs; the user embedding and capsules card against CPU on 256
     rows; p50 of 10); ``OfflineIndexer`` over 5,000 users and 20,000
     items with the capsule tower, plain and with each item's tag as its
     category and ``diversity_weight`` 10 (20 distinct tags a slate, the
     plain top-1 first); ``serve_background`` and 200 requests each of
     retrieve/kv, retrieve/online and retrieve/online with
     ``diversity_weight``, p50 and p95;
   - 9c: 20 bf16 dense steps (``in_batch_softmax``, Adam lr 2e-3): losses
     finite and falling, neither kernel launched (the module's math, as
     the JAX package); ``evaluate`` on two batches (#7 once a batch); the
     routing's forward and backward through the kernel pair against the
     module's training math; ``run`` → ``restore`` → ``export`` →
     ``load_servable``, whose predict must equal ``Trainer.infer``;
   - 9d: ``comirec`` ('sa', 'dr') and ``sine`` over the same schema: one
     predict and 5 train steps each (no kernel).

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
TF32_FLOPS = 495e12  # TF32 on the tensor cores, dense
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


def device_ms(torch, fn, iters: int = 30, warmup: int = 3, flush: str | None = "write") -> float:
    """Median device time of one ``fn()`` launch. The L2 cache (50 MB) is
    flushed before each launch: by writing 256 MB (``flush="write"``), which
    leaves it full of dirty lines that a launch's reads must first evict, or
    by reading 256 MB (``"read"``), which leaves clean lines; ``None`` keeps
    the inputs in L2 from the warm-up, as a kernel finds them right after
    the op that wrote them. A sleep kernel ahead of the loop holds the card
    while the host queues every launch, so host-side launch overhead stays
    out of the times."""
    buf = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(iters)
    ]
    torch.cuda._sleep(100_000_000)
    for start, end in events:
        if flush == "write":
            buf.zero_()
        elif flush == "read":
            buf.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def flush_times(torch, fn, same_bytes_call, same_bytes_fn) -> dict:
    """``fn``'s device time with L2 flushed by a read and with its input in
    L2, beside one PyTorch call that moves the same bytes
    (``same_bytes_fn``) under both flushes: what the write flush of
    ``device_ms`` costs a streaming launch."""
    return dict(
        read_flush_ms=device_ms(torch, fn, flush="read"),
        warm_ms=device_ms(torch, fn, flush=None),
        same_bytes_call=same_bytes_call,
        same_bytes_ms=device_ms(torch, same_bytes_fn),
        same_bytes_read_flush_ms=device_ms(torch, same_bytes_fn, flush="read"),
    )


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def tc_bound(nbytes: float, fma_ops: float, mma_ops: float):
    """``bound`` of a kernel that takes ``mma_ops`` on the tensor cores in
    3xTF32 (three TF32 multiply-adds per fp32 one at 495 TFLOP/s) and
    ``fma_ops`` in fp32 at 67 TFLOP/s."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 3 * mma_ops / TF32_FLOPS + fma_ops / FP32_FLOPS
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


def din_reading(got, want) -> dict:
    """pooled's and the scores' errors in units of ``KERNEL_TOL`` (at most 1
    passes)."""
    return {name: tol_ratio(g, w, **KERNEL_TOL) for name, g, w in zip(("pooled", "scores"), got, want)}


def din_bound(args):
    """What this run's mask needs (ms, by): keys are read and scored at live
    steps only (a masked step's score is 0 and adds nothing to pooled); q,
    the mask, the weights read and pooled, scores written once; per live
    step the folded product and the activation, per row the fold."""
    b, l, d = args[1].shape
    h = args[3].shape[1]
    live = int(args[2].count_nonzero())
    nbytes = 4 * (b * d + live * d + b * l + 4 * d * h + 3 * h + b * d + b * l)
    ops = live * (2 * d * h + 6 * h + 1) + b * (6 * d * h + h) + 2 * live * d
    return (*bound(nbytes, ops), live)


def check_din_forward(torch, kernels, detail=False):
    """Kernel #4 against its plain version (phase 3): the serving shape with
    and without PReLU slopes, ragged shapes, a mask with holes, both sides of
    the tensor-core kernel's H limit; a forward that ignores the mask, drops
    the slopes or takes lin in single TF32 must read above the limit; two
    calls the same bits; device time at B=8192, 4096, 1024 and 1, the bound
    and the plain version's time. ``detail`` (``--din``) adds the launch
    floor and the blocks, warps and shared memory of the launch."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    lib = kernels._library("din_attention")
    b, l, d, h = 8192, 64, 32, 36
    args = din_inputs(torch, gen, b, l, d, h)
    relu = args[:6] + [None]
    want = kernels.din_attention_plain(*args)
    readings, err = {}, 0.0
    for name, a in (("prelu", args), ("relu", relu)):
        got, ref = kernels.din_attention_fused(*a), kernels.din_attention_plain(*a)
        readings[name] = din_reading(got, ref)
        err = max(err, max(float((g - w).abs().max()) for g, w in zip(got, ref)))
    # what a forward that ignores the mask, drops the slopes or takes lin in
    # single TF32 would read (the kernel takes it in 3xTF32)
    no_mask = args[:2] + [torch.ones_like(args[2])] + args[3:]
    readings["broken_mask_ignored"] = din_reading(kernels.din_attention_plain(*no_mask), want)
    readings["broken_alpha_dropped"] = din_reading(kernels.din_attention_plain(*relu), want)
    readings["broken_single_tf32"] = din_reading(kernels.din_attention_unfolded(*args, products="1xtf32"), want)
    # ragged: B that is no multiple of the grid, L = 1 and 33, D = 8/16/64,
    # H = 7, H = 128 (the widest tensor-core build) and 129, 200 (the fp32
    # kernel)
    for shape in ((1003, 64, 32, 36), (37, 1, 32, 36), (300, 33, 32, 36), (300, 64, 8, 36),
                  (300, 64, 16, 36), (300, 48, 64, 36), (257, 33, 16, 7), (300, 64, 32, 128),
                  (300, 64, 32, 129), (300, 64, 32, 200)):
        a = din_inputs(torch, gen, *shape)
        readings["x".join(map(str, shape))] = din_reading(
            kernels.din_attention_fused(*a), kernels.din_attention_plain(*a)
        )
    # a mask with holes (not a prefix), a row whose only live step is the
    # last, and an all-zero row
    a = din_inputs(torch, gen, 1003, 64, 32, 36)
    a[2] = holey_mask(torch, gen, a[2])
    readings["mask_with_holes"] = din_reading(kernels.din_attention_fused(*a), kernels.din_attention_plain(*a))
    print("din forward readings (error / limit):", json.dumps(readings), flush=True)
    for name, r in readings.items():
        worst = max(r.values())
        if name.startswith("broken"):
            check(worst > 1.0, f"the forward check cannot tell a {name} forward from a sound one")
        else:
            check(worst <= 1.0, f"din forward kernel vs plain at {name}: {r}")
    check(lib.din_attention_route(32, 128) == 1 and lib.din_attention_route(32, 129) == 0,
          "din forward: H = 128 must take the tensor-core kernel, H = 129 the fp32 one")

    bound_ms, bound_by, live = din_bound(args)
    first = kernels.din_attention_fused(*args)
    same = all(torch.equal(x, y) for x, y in zip(first, kernels.din_attention_fused(*args)))
    rec = dict(
        name="din_attention", route="cuda", source="tpurec_torch/csrc/din_attention.cu",
        replaces="tpurec/ops/pallas/kernels.py:350", shape=[b, l, d, h], live_steps=live, max_abs_err=err,
        ms=device_ms(torch, lambda: kernels.din_attention_fused(*args)),
        plain_ms=device_ms(torch, lambda: kernels.din_attention_plain(*args)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None, same_bits=same,
    )
    for rows in (4096, 1024, 1):
        small = [x[:rows] if x.dim() and x.shape[0] == b else x for x in args]
        rec[f"b{rows}_ms"] = device_ms(torch, lambda: kernels.din_attention_fused(*small))
        rec[f"b{rows}_bound_ms"] = din_bound(small)[0]
    if detail:
        rec.update(
            launch_floor_ms=launch_floor_ms(torch), blocks=lib.din_attention_blocks(b, d, h),
            warps=lib.din_attention_warps(d, h), smem_bytes=lib.din_attention_smem_bytes(l, d, h),
        )
    print("kernel check:", json.dumps(rec), flush=True)
    check(same, "din forward kernel: two calls gave different bits")
    return rec


def parent_kernels(parent_dir):
    """``tpurec_torch/ops/kernels.py`` of the checkout at ``parent_dir`` (a
    ``git archive`` of the parent commit), loaded by path: it builds its
    CUDA sources into that checkout's ``build/kernels``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "parent_kernels", os.path.join(parent_dir, "tpurec_torch", "ops", "kernels.py")
    )
    parent = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent)
    return parent


def ab_runs(torch, what, parent, kernels, fn, cases, check_fn):
    """Parent, change, change, parent: each tree's ``fn`` on every case of
    ``cases`` (label → arguments), checked by ``check_fn(got, args)`` and
    timed (``device_ms``)."""
    runs = []
    for label, mod in (("parent", parent), ("change", kernels), ("change", kernels), ("parent", parent)):
        times = {}
        for key, args in cases.items():
            check_fn(getattr(mod, fn)(*args), args)
            times[key] = device_ms(torch, lambda: getattr(mod, fn)(*args))
        runs.append(dict(tree=label, **times))
        print(f"{what} a/b:", json.dumps(runs[-1]), flush=True)
    return runs


def din_ab(torch, kernels, parent_dir):
    """Kernel #4 of the checkout at ``parent_dir`` against this one's, on the
    same inputs in one process: parent, change, change, parent, each at
    B=8192, 4096, 1024 and 1 (the serving shape's rows), held to the plain
    version and timed."""
    parent = parent_kernels(parent_dir)
    parent.build(["din_attention"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    args = din_inputs(torch, gen, 8192, 64, 32, 36)
    cases = {f"b{rows}_ms": [x[:rows] if x.dim() and x.shape[0] == 8192 else x for x in args]
             for rows in (8192, 4096, 1024, 1)}
    return ab_runs(torch, "din", parent, kernels, "din_attention_fused", cases,
                   lambda got, a: max_err(torch, got, kernels.din_attention_plain(*a)))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
FM_SHAPE = (26, 32)  # deepfm's F and D over the FM schema (phase 5)
# the benchmark shape of the kernel table, then the rank path's buckets
# (serving/server.py:126): rank 200, rank 20 and from_retrieval, the smallest
FM_BATCHES = (8192, 256, 32, 8)


def fm_bound(b, f, d):
    """emb read once and the (B,) output written once; 3 flops an element
    and 3 a column."""
    return bound(4 * (b * f * d + b), b * f * d * 3 + b * d * 3 + b)


def fm_square_over_columns(torch, emb):
    """A broken FM cross term: squares after summing over columns too,
    0.5·[(Σ_f Σ_d e)² − Σ_f Σ_d e²], where each column's square is summed."""
    return 0.5 * (torch.square(emb.sum(dim=(1, 2))) - torch.square(emb).sum(dim=(1, 2)))


def unaligned(torch, t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary (the kernels then take 4-byte loads)."""
    buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def ptxas_resources(path, *kernel_names) -> dict:
    """Registers and spill bytes of the named kernels (substrings of their
    mangled names) from the ``-Xptxas -v`` log kept beside the library at
    ``path``."""
    import re

    found, fn = {}, None
    for line in open(f"{path}.log").read().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            found.setdefault(fn, {})["spill_bytes"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            found.setdefault(fn, {})["registers"] = int(m.group(1))
    return {name: next((v for k, v in found.items() if name in k), None) for name in kernel_names}


def check_fm(torch, kernels, detail=False):
    """Kernel #1 against its plain version (phase 3) at deepfm's F=26, D=32
    and B = 8192, 256, 32 and 8 (``FM_BATCHES``), and at B=8192 with an
    input 4 bytes off a 16-byte boundary (4-byte loads), at ``KERNEL_TOL``;
    a term that drops the last field or squares after summing over columns
    must read above it; two calls the same bits. Device time (median of 30,
    L2 flushed), the plain version's and the bound at each B, beside the
    launch floor. ``detail`` (``--fm``) adds each launch's blocks and warps,
    ``flush_times`` (L2 flushed by a read, the input in L2, and one PyTorch
    call reading the same bytes), the 4-byte loads' time and the kernels'
    registers and spills. Returns the B=8192 record with the others under
    ``other_shapes``."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    f, d = FM_SHAPE
    floor_ms = launch_floor_ms(torch)
    readings, other, record = {}, {}, None
    for b in FM_BATCHES:
        emb = torch.randn(b, f, d, device="cuda", generator=gen)
        got, want = kernels.fm_second_order_fused(emb), kernels.fm_second_order_plain(emb)
        readings[f"fm {b}x{f}x{d}"] = dict(
            kernel=tol_ratio(got, want, **KERNEL_TOL),
            same_bits=bool(torch.equal(got, kernels.fm_second_order_fused(emb))),
            broken_last_field_dropped=tol_ratio(kernels.fm_second_order_plain(emb[:, :-1]), want, **KERNEL_TOL),
            broken_squared_over_columns=tol_ratio(fm_square_over_columns(torch, emb), want, **KERNEL_TOL),
        )
        bound_ms, bound_by = fm_bound(b, f, d)
        rec = dict(
            name="fm_second_order", route="cuda", source="tpurec_torch/csrc/fm_second_order.cu",
            replaces="tpurec/ops/pallas/kernels.py:110", shape=[b, f, d],
            max_abs_err=float((got - want).abs().max()),
            ms=device_ms(torch, lambda: kernels.fm_second_order_fused(emb)),
            plain_ms=device_ms(torch, lambda: kernels.fm_second_order_plain(emb)),
            bound_ms=bound_ms, bound_by=bound_by, launch_floor_ms=floor_ms, library_ms=None,
        )
        if detail:
            sms = kernels._sm_count(emb.device)
            warps = kernels._library("fm_second_order").fm_second_order_warps(b, sms)
            rec.update(warps_per_block=warps, blocks=-(-b // warps))
            rec.update(flush_times(torch, lambda: kernels.fm_second_order_fused(emb),
                                   "emb.sum(dim=(1, 2))", lambda: emb.sum(dim=(1, 2))))
        if b == FM_BATCHES[0]:
            record = rec
            odd = unaligned(torch, emb)
            got = kernels.fm_second_order_fused(odd)
            readings[f"fm {b}x{f}x{d} unaligned"] = dict(
                kernel=tol_ratio(got, want, **KERNEL_TOL),
                same_bits=bool(torch.equal(got, kernels.fm_second_order_fused(odd))),
            )
            if detail:
                rec["unaligned_ms"] = device_ms(torch, lambda: kernels.fm_second_order_fused(odd))
        else:
            print(f"fm_second_order at B={b}:", json.dumps(rec), flush=True)
            other[f"b{b}"] = rec
    record["other_shapes"] = other
    if detail:
        path = kernels.library_path("fm_second_order")
        # D=32 in float4 units (8 lanes a field) and in floats (a lane a column)
        record["ptxas"] = ptxas_resources(path, "fm_kernelILi4ELi0E", "fm_kernelILi1ELi0E")
    print(f"fm readings (error / limit, {KERNEL_TOL}):", json.dumps(readings), flush=True)
    check_readings(readings)
    print("kernel check:", json.dumps(record), flush=True)
    return record


def fm_ab(torch, kernels, parent_dir):
    """Kernel #1 of the checkout at ``parent_dir`` (the parent's Triton
    kernel) against this one's, parent, change, change, parent, at
    ``FM_BATCHES``, each call held to the plain version."""
    parent = parent_kernels(parent_dir)
    gen = torch.Generator(device="cuda").manual_seed(0)
    emb = torch.randn(FM_BATCHES[0], *FM_SHAPE, device="cuda", generator=gen)
    cases = {f"b{b}_ms": [emb[:b]] for b in FM_BATCHES}
    return ab_runs(torch, "fm", parent, kernels, "fm_second_order_fused", cases,
                   lambda got, a: max_err(torch, [got], [kernels.fm_second_order_plain(*a)]))


def check_kernels(torch, kernels):
    return {"din_attention": check_din_forward(torch, kernels), "fm_second_order": check_fm(torch, kernels)}


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
    busy_ms, top_ops = profile_steps(torch, lambda: servable.predict(batch))
    result = dict(
        card=card, batch=batch_size, din_launches=launches, predict_p50_ms=statistics.median(times[2:]),
        examples_per_s=batch_size / (statistics.median(times[2:]) / 1e3),
        mean_prob=float(out.mean()), device_busy_ms=busy_ms, top_ops_ms=top_ops,
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
            for uid in uids[:5]:  # warm-up: the first launches, the allocator
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
    # the kernel's unfolded products in single TF32 (3xTF32 is what holds)
    readings["broken_single_tf32"] = bwd_reading(
        kernels.din_attention_bwd_unfolded(*args, *cot, products="1xtf32"), want
    )
    # ragged: B that is no multiple of the grid, L = 1, D = 8/16/64, H that
    # is no multiple of 4
    for shape in ((1003, 64, 32, 36), (37, 1, 32, 36), (300, 64, 8, 36), (300, 64, 16, 36),
                  (300, 48, 64, 36), (257, 33, 16, 7)):
        a, c = case(*shape)
        readings["x".join(map(str, shape))] = bwd_reading(
            kernels.din_attention_bwd_fused(*a, *c), kernels.din_attention_bwd_plain(*a, *c)
        )
    # a mask with holes (not a prefix), a row whose only live step is the
    # last, and an all-zero row
    a, c = case(1003, 64, 32, 36)
    a[2] = (torch.rand(a[2].shape, device="cuda", generator=gen) < 0.5).float()
    a[2][1] = 0.0
    a[2][2] = 0.0
    a[2][2, -1] = 1.0
    readings["mask_with_holes"] = bwd_reading(
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
    # The tensor cores lift the operations limit, so the bytes-only bound is
    # printed beside it.
    live = int(args[2].sum())
    nbytes = 4 * (3 * b * d + live * d + b * l * d + b * l + live + 2 * (4 * d * h + 3 * h))
    ops = 2 * (3 * live * d * h + 6 * b * d * h + live * d) + 8 * live * h
    bound_ms, bound_by = bound(nbytes, ops)
    again = kernels.din_attention_bwd_fused(*args, *cot)
    same = all(torch.equal(x, y) for x, y in zip(kernels.din_attention_bwd_fused(*args, *cot), again))
    small = [x[:1024] if x.dim() and x.shape[0] == b else x for x in args]
    small_cot = [x[:1024] for x in cot]
    rec = dict(
        name="din_attention_bwd", route="cuda", source="tpurec_torch/csrc/din_attention_bwd.cu",
        replaces="tpurec/ops/pallas/kernels.py:484", shape=[b, l, d, h], live_steps=live, max_abs_err=err,
        ms=device_ms(torch, lambda: kernels.din_attention_bwd_fused(*args, *cot)),
        plain_ms=device_ms(torch, lambda: kernels.din_attention_bwd_plain(*args, *cot)),
        bound_ms=bound_ms, bound_by=bound_by, bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        library_ms=None, same_bits=same,
        split_ms=kernel_split(torch, lambda: kernels.din_attention_bwd_fused(*args, *cot)),
        b1024_ms=device_ms(torch, lambda: kernels.din_attention_bwd_fused(*small, *small_cot)),
        blocks=kernels._library("din_attention_bwd").din_attention_bwd_blocks(b, l, d, h),
    )
    print("kernel check:", json.dumps(rec), flush=True)
    check(same, "din backward kernel: two calls gave different bits")
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
    eight operators whose kernels take most of it, in ms per step, with the
    DIN attention kernels (#4, #5) beside them as ``kernel <name>``."""
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
    din = {
        f"kernel {e.key[:60]}": e.self_device_time_total / steps / 1e3
        for e in averages if e.device_type == DeviceType.CUDA and "din_attention" in e.key
    }
    return busy / steps / 1e3, {**{e.key: e.self_device_time_total / steps / 1e3 for e in ops[:8]}, **din}


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
    """Kernel #9 as three broken versions would compute it (plain math): two
    that lose what a run carries past the tile (launch 2's part) or the
    slice (the tile fold's part too) it begins in, at the kernel's units for
    the width (``scatter_tile_rows``, ``scatter_slice_rows``), and one that
    keeps only each id's first occurrence. Each reading must exceed its
    limit."""

    def dropping(unit):
        def drop(table_rows, d, plan, grads_sorted):
            g = grads_sorted.reshape(plan.n, d)
            rows = unit(d)
            start = torch.searchsorted(plan.sids, plan.sids)  # where each run begins
            keep = torch.arange(plan.n, device=g.device) // rows == start // rows
            return eu.scatter_add_plain(table_rows, plan.sids[keep], g[keep])

        return drop

    def first_only(table_rows, d, plan, grads_sorted):
        g = grads_sorted.reshape(plan.n, d)
        keep = torch.ones(plan.n, dtype=torch.bool, device=g.device)
        keep[1:] = plan.sids[1:] != plan.sids[:-1]
        return eu.scatter_add_plain(table_rows, plan.sids[keep], g[keep])

    return dict(broken_drop_carried=dropping(eu.scatter_tile_rows),
                broken_drop_slice_carried=dropping(eu.scatter_slice_rows),
                broken_first_only=first_only)


def kernel_split(torch, fn, calls=10) -> dict:
    """Device ms per call of each kernel (and memset) that ``fn()`` launches,
    from ``torch.profiler`` over ``calls`` calls, the L2 cache flushed before
    each (the flush's own fill kernel is left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return {
        e.key[:60]: e.self_device_time_total / calls / 1e3 for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        and "FillFunctor" not in e.key
    }


def scatter_case(torch, eu, gen, plan, v, d, timing=True):
    """Kernel #9 on one stream: its reading against the plain version, two
    calls the same bits and, with ``timing``, its device time beside
    ``index_add_``'s (torch.zeros + index_add_, the same function in one
    PyTorch call each), the bound and the per-launch split. Returns (reading,
    grads, G)."""
    grads = torch.randn(plan.n, d, device="cuda", generator=gen)
    got = eu.fused_scatter_add(v, d, plan, grads)
    again = eu.fused_scatter_add(v, d, plan, grads)
    r = dict(n=plan.n, rows=v, d=d, same_bits=bool(torch.equal(got, again)))
    r["kernel"] = sum_reading(torch, eu, got, plan, grads) if plan.n else float(got.abs().max())
    if timing:
        # bytes: grads and ids read once, all of G written once; one add a
        # gradient element
        r["bound_ms"], r["bound_by"] = bound(4 * (plan.n * d + plan.n + v * d), plan.n * d)
        r["ms"] = device_ms(torch, lambda: eu.fused_scatter_add(v, d, plan, grads))
        r["library_ms"] = device_ms(torch, lambda: torch.zeros(v, d, device="cuda").index_add_(
            0, plan.sids, grads))
        r["split_ms"] = kernel_split(torch, lambda: eu.fused_scatter_add(v, d, plan, grads))
    return r, grads, got


SCATTER_SWEEP_D = (1, 4, 8, 16, 32, 64)


def scatter_sweep(torch, eu, gen) -> dict:
    """Kernel #9 over the FM stream (bench.py's B=8192 batch: N=212,992 ids
    over 2,080,128 rows) at each D of ``SCATTER_SWEEP_D``, and at DIN's
    stream (phase 6's batch) at D=32: correct and the same bits at each,
    with its time beside ``index_add_`` and the bound."""
    from tpurec_torch.embedding.ops import pad_vocab

    finfo, dinfo = fm_info(), din_info()
    fm_plan = eu.make_scatter_plan(torch.as_tensor(
        flat_ids(finfo, bench_batch(finfo, TRAIN_BATCH, 0, seed=1)), device="cuda"),
        pad_vocab(finfo.total_dims))
    din_plan = eu.make_scatter_plan(torch.as_tensor(
        flat_ids(dinfo, bench_batch(dinfo, TRAIN_BATCH, 64, seed=1)), device="cuda"),
        pad_vocab(dinfo.total_dims))
    rows = {f"fm_d{d}": scatter_case(torch, eu, gen, fm_plan, fm_plan.num_rows, d)[0]
            for d in SCATTER_SWEEP_D}
    rows["din_d32"] = scatter_case(torch, eu, gen, din_plan, din_plan.num_rows, 32)[0]
    for name, r in rows.items():
        print(f"fused_scatter_add sweep {name}:", json.dumps(r), flush=True)
    for name, r in rows.items():
        check(r["same_bits"], f"fused_scatter_add sweep {name}: two calls gave different bits")
        check(r["kernel"] <= 1.0, f"fused_scatter_add sweep {name} vs plain: {r}")
    return rows


def check_embedding_kernels(torch, eu):
    """Kernels #9 and #10 against their plain versions (phase 7a, 7b)."""
    from tpurec_torch.embedding.ops import pad_vocab

    gen = torch.Generator(device="cuda").manual_seed(7)
    broken = broken_scatters(torch, eu)
    finfo, dinfo = fm_info(), din_info()
    fm_ids = flat_ids(finfo, bench_batch(finfo, TRAIN_BATCH, 0, seed=1))
    din_ids = flat_ids(dinfo, bench_batch(dinfo, TRAIN_BATCH, 64, seed=1))
    v_fm, v_din = pad_vocab(finfo.total_dims), pad_vocab(dinfo.total_dims)
    ragged = torch.randint(0, 300, (1003,), device="cuda", generator=gen)
    cases = {
        "fm_v": (fm_ids, v_fm, 32), "fm_w": (fm_ids, v_fm, 1), "din": (din_ids, v_din, 32),
        "ragged_d3": (ragged, 300, 3), "ragged_d8": (ragged, 300, 8),
        "ragged_d33": (ragged, 300, 33), "ragged_d64": (ragged, 300, 64),
        "ragged_d160": (ragged, 300, 160), "all_equal": (np.full(5000, 150), 300, 4),
        "empty": (np.zeros(0, np.int64), 300, 8),
    }
    readings, records = {}, {}
    for name, (ids, v, d) in cases.items():
        plan = eu.make_scatter_plan(torch.as_tensor(ids, device="cuda"), v)
        timing = name in ("fm_v", "fm_w", "din")
        r, grads, got = scatter_case(torch, eu, gen, plan, v, d, timing=timing)
        if plan.n:
            s = plan.sids
            start = torch.searchsorted(s, s)
            pos = torch.arange(plan.n, device="cuda")
            for unit, rows in (("tile", eu.scatter_tile_rows(d)), ("slice", eu.scatter_slice_rows(d))):
                r[f"{unit}_rows"] = rows
                r[f"{unit}_crossing_rows"] = int((pos // rows != start // rows).sum())
            r["repeated_rows"] = int((s[1:] == s[:-1]).sum())
            for bname, fn in broken.items():
                r[bname] = sum_reading(torch, eu, fn(v, d, plan, grads), plan, grads)
        readings[name] = r
        if timing:
            plain = lambda: eu.scatter_add_plain(v, plan.sids, grads)  # noqa: E731
            rec = dict(
                name="fused_scatter_add", route="cuda", source="tpurec_torch/csrc/embedding_update.cu",
                replaces="tpurec/ops/pallas/embedding_update.py:231", shape=[plan.n, v, d],
                max_abs_err=float((got - plain()).abs().max()), ms=r["ms"],
                plain_ms=device_ms(torch, plain), bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=r["library_ms"], split_ms=r["split_ms"],
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
          "of the row, fp32 sums in another order):", json.dumps(readings), flush=True)
    for name, r in readings.items():
        check(r["same_bits"], f"fused_scatter_add at {name}: two calls gave different bits")
        check(r["kernel"] <= 1.0, f"fused_scatter_add vs plain at {name}: {r}")
        for unit, bname in (("tile", "broken_drop_carried"), ("slice", "broken_drop_slice_carried")):
            if r.get(f"{unit}_crossing_rows"):
                check(r[bname] > 1.0,
                      f"the check cannot tell a #9 that drops runs carried past a {unit} at {name}: {r}")
        if r.get("repeated_rows"):
            check(r["broken_first_only"] > 1.0,
                  f"the check cannot tell a #9 that keeps first occurrences at {name}: {r}")
    check(all(readings[n]["slice_crossing_rows"] for n in ("fm_v", "din", "all_equal"))
          and all(readings[n]["tile_crossing_rows"] for n in ("din", "all_equal")),
          "no run crossed a slice at the FM, DIN or all-equal shape, or a tile at DIN or all-equal")
    records["sweep"] = scatter_sweep(torch, eu, gen)

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
    with mock.patch.object(eu, "fused_scatter_add", broken_scatters(torch, eu)["broken_drop_slice_carried"]):
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


# ---------------------------------------------------------------------------
# phase 8: the DCN family (DCN, xDeepFM, FiBiNET)
# CIN against its plain version: each output column's error against 1e-4 of
# the column's largest |value| (a level sums H·F products an element, 3,328
# at the slice's level 2, in another order than the plain einsum).
CIN_COL_RTOL = 1e-4
# The fp32 logit of a bf16 servable, kernel against plain twin and card
# against CPU, against 2^-5 of the batch's largest |logit| (at the seeded
# init FiBiNET's logits are ~1e-3, so an absolute limit says nothing): an
# fp32 difference in a kernel's output, or another summation order on the
# CPU, can flip bf16 roundings (2^-8..2^-7 each) of intermediates as large
# as the logit, as in tests/test_torch_dcn.py. At the seeded init the interaction
# terms are too small a share of the logit for a broken kernel to show
# there; the servable's own kernel call, held against the plain version on
# its inputs (#2, #6 at KERNEL_TOL's rtol of the largest |value|, #3 at
# CIN_COL_RTOL), is where a broken version must read above the limit.
DCN_LOGIT_RTOL = 2.0**-5
DCN_STEPS = 20
DCN_KERNELS = ("cross_network", "cin", "senet_bilinear")
# model: (registry name, params, embedding dim, kernel it runs at inference).
# The JAX builders' defaults at the widths of benchmarks/kernel_bench.py.
DCN_MODELS = {
    "dcn": ("dcn", dict(cross_type="vector", num_cross_layers=3), 16, "cross_network"),
    "xdeepfm": ("xdeepfm", dict(cin_layer_sizes=[128, 128]), 32, "cin"),
    "fibinet": ("fibinet", dict(bilinear_mode="all", reduction=3), 32, "senet_bilinear"),
}


def cross_dots_x0(x0, weights, biases):
    """A broken cross stack: dots x0 where it should dot x_l."""
    x = x0
    for w, b in zip(weights, biases):
        x = x0 * (x0 @ w)[:, None] + b + x
    return x


def cin_fields_from_maps(torch, emb, weights):
    """A broken CIN: pairs each level's maps with the previous level's maps
    (taken cyclically up to F) where it should use the raw fields."""
    b, f, d = emb.shape
    x, outs = emb, []
    for w in weights:
        h = x.shape[1]
        fields = x[:, torch.arange(f, device=x.device) % h]
        z = torch.einsum("bhd,bfd->bhfd", x, fields).reshape(b, h * f, d)
        x = torch.einsum("bpd,ps->bsd", z, w)
        outs.append(x.sum(dim=-1))
    return torch.cat(outs, dim=-1)


def senet_pairs_swapped(torch, emb, w1, w2, wb, b1, b2):
    """A broken SENet-bilinear: pairs taken as (j, i)."""
    a = torch.relu(torch.relu(emb.mean(dim=-1) @ w1 + b1) @ w2 + b2)
    v = emb * a[..., None]
    iu, ju = torch.triu_indices(emb.shape[1], emb.shape[1], offset=1, device=emb.device)
    return (v @ wb)[:, ju] * v[:, iu]


def cin_reading(got, want, scale_from=None) -> float:
    """max |got − want| / (CIN_COL_RTOL · the column's max |want|, or max
    |scale_from| where a batch to take the columns' scale from is given): at
    most 1 passes."""
    scale = (want if scale_from is None else scale_from).abs().amax(dim=0).clamp_min(1e-30)
    return float(((got - want).abs() / scale).max()) / CIN_COL_RTOL


def check_dcn_kernels(torch, kernels):
    """Kernels #2, #3 and #6 against their plain versions at the slice's
    shapes and ragged ones, each with a broken version that must read above
    the limit (phase 8a)."""
    gen = torch.Generator(device="cuda").manual_seed(8)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=gen)

    def record(name, route, source, replaces, shape, fused, plain, nbytes, ops):
        bound_ms, bound_by = bound(nbytes, ops)
        return dict(
            name=name, route=route, source=source, replaces=replaces, shape=shape,
            max_abs_err=float((fused() - plain()).abs().max()),
            ms=device_ms(torch, fused), plain_ms=device_ms(torch, plain),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        )

    readings, records = {}, {}
    cross_readings, records["cross_network"] = check_cross(torch, kernels)
    readings.update(cross_readings)
    # #3 (phase 8a's CIN checks, also run alone by --cin)
    cin_readings, records["cin"] = check_cin(torch, kernels)
    readings.update(cin_readings)
    # #6: emb, the weights and the (B, P, D) output once; the squeeze, the
    # two small layers, v, v·Wb and the pair products
    for b, f, d in ((8192, 26, 32), (1003, 5, 24), (1003, 2, 24)):
        r, p = max(1, f // 3), f * (f - 1) // 2
        # a positive excitation (W2, b2) keeps every field open: at F=2 a
        # closed one zeroes the only pair of every row, and a broken version
        # would read 0
        args = [randn(b, f, d), randn(f, r, scale=0.5), randn(r, f, scale=0.5).abs(), randn(d, d, scale=0.3),
                randn(r, scale=0.3), randn(f, scale=0.3).abs()]
        want = kernels.senet_bilinear_plain(*args)
        readings[f"senet_bilinear {b}x{f}x{d}"] = dict(
            kernel=tol_ratio(kernels.senet_bilinear_fused(*args), want, **KERNEL_TOL),
            broken_pairs_swapped=tol_ratio(senet_pairs_swapped(torch, *args), want, **KERNEL_TOL),
        )
        if b == 8192:
            records["senet_bilinear"] = record(
                "senet_bilinear", "cuda", "tpurec_torch/csrc/senet_bilinear.cu",
                "tpurec/ops/pallas/kernels.py:642", [b, f, d],
                lambda: kernels.senet_bilinear_fused(*args), lambda: kernels.senet_bilinear_plain(*args),
                4 * (b * f * d + 2 * f * r + r + f + d * d + b * p * d),
                b * (2 * f * d + 4 * f * r + 2 * f * d * d + p * d),
            )
    print(f"dcn kernel readings (error / limit; #2 and #6 at {KERNEL_TOL}, #3 at {CIN_COL_RTOL} "
          "of each column's largest |value|):", json.dumps(readings), flush=True)
    check_readings(readings)
    for rec in records.values():
        print("kernel check:", json.dumps(rec), flush=True)
    return records


CROSS_SHAPE = (416, 3)  # DCN's D (26 fields x 16) and cross layers (phase 8)


def cross_bound(b, d, layers):
    """x0 read and x_L written once, w and b read once; the dot and the
    update, 5 flops an element a layer."""
    return bound(4 * (2 * b * d + 2 * layers * d), 5 * b * d * layers)


def check_cross(torch, kernels, detail=False):
    """Kernel #2 against its plain version (phase 8a) at DCN's predict
    shape (B=8192, D=416, L=3), ``evaluate``'s B=1024, ragged shapes (D=429
    with L=2 and 6) and B=8192 with x0, w and b 4 bytes off a 16-byte
    boundary (4-byte units), at ``KERNEL_TOL``; a stack that dots x0 must
    read above it; two calls the same bits. Device time (median of 30, L2
    flushed), the plain version's and the bound at B=8192 and B=1024,
    beside the launch floor. ``detail`` (``--cross``) adds each launch's
    route and blocks, ``flush_times`` (L2 flushed by a read, x0 in L2, and
    a device-to-device copy of x0, the bytes the stack must move), the
    4-byte units' time and blocks, and the kernels' registers and spills.
    Returns the readings and the B=8192 record with B=1024's under
    ``other_shapes``."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    d0, l0 = CROSS_SHAPE
    floor_ms = launch_floor_ms(torch)
    readings, other, record = {}, {}, None
    lib = kernels._library("cross_network")
    device = torch.device("cuda", torch.cuda.current_device())

    def blocks(b, d, layers, vw):
        resident = kernels._cross_resident(lib, device, d, layers, vw)
        return min(-(-b // 8), resident) if resident else b

    for b, d, layers in ((8192, d0, l0), (1024, d0, l0), (1003, 429, 2), (1003, 429, 6)):
        args = [torch.randn(b, d, device="cuda", generator=gen),
                torch.randn(layers, d, device="cuda", generator=gen) * (0.5 / d**0.5),
                torch.randn(layers, d, device="cuda", generator=gen)]
        got, want = kernels.cross_network_fused(*args), kernels.cross_network_plain(*args)
        readings[f"cross_network {b}x{d} L={layers}"] = dict(
            kernel=tol_ratio(got, want, **KERNEL_TOL),
            same_bits=bool(torch.equal(got, kernels.cross_network_fused(*args))),
            broken_dots_x0=tol_ratio(cross_dots_x0(*args), want, **KERNEL_TOL),
        )
        if (d, layers) != CROSS_SHAPE:
            continue
        bound_ms, bound_by = cross_bound(b, d, layers)
        rec = dict(
            name="cross_network", route="cuda", source="tpurec_torch/csrc/cross_network.cu",
            replaces="tpurec/ops/pallas/kernels.py:160", shape=[b, d, layers],
            max_abs_err=float((got - want).abs().max()),
            ms=device_ms(torch, lambda: kernels.cross_network_fused(*args)),
            plain_ms=device_ms(torch, lambda: kernels.cross_network_plain(*args)),
            bound_ms=bound_ms, bound_by=bound_by, launch_floor_ms=floor_ms, library_ms=None,
        )
        if detail:
            rec.update(warp_a_row=bool(lib.cross_network_route(d, layers)), threads_per_block=256,
                       blocks=blocks(b, d, layers, 4))
            rec.update(flush_times(torch, lambda: kernels.cross_network_fused(*args), "out.copy_(x0)",
                                   lambda: torch.empty_like(args[0]).copy_(args[0])))
        if b == TRAIN_BATCH:
            record = rec
            odd = [unaligned(torch, t) for t in args]
            got = kernels.cross_network_fused(*odd)
            readings[f"cross_network {b}x{d} L={layers} unaligned"] = dict(
                kernel=tol_ratio(got, want, **KERNEL_TOL),
                same_bits=bool(torch.equal(got, kernels.cross_network_fused(*odd))),
            )
            if detail:
                rec["unaligned_ms"] = device_ms(torch, lambda: kernels.cross_network_fused(*odd))
                rec["unaligned_blocks"] = blocks(b, d, layers, 1)
        else:
            print(f"cross_network at B={b}:", json.dumps(rec), flush=True)
            other[f"b{b}"] = rec
    record["other_shapes"] = other
    if detail:
        path = kernels.library_path("cross_network")
        # D=416 in float4 units (4 a lane) and in floats (13 a lane)
        record["ptxas"] = ptxas_resources(path, "cross_warp_kernelILi4ELi4E", "cross_warp_kernelILi1ELi13E")
    print(f"cross_network readings (error / limit, {KERNEL_TOL}):", json.dumps(readings), flush=True)
    check_readings(readings)
    return readings, record


def cross_ab(torch, kernels, parent_dir):
    """Kernel #2 of the checkout at ``parent_dir`` (the parent's Triton
    kernel) against this one's, parent, change, change, parent, at DCN's
    predict (B=8192) and ``evaluate`` (B=1024) shapes, each call held to the
    plain version."""
    parent = parent_kernels(parent_dir)
    gen = torch.Generator(device="cuda").manual_seed(8)
    d, layers = CROSS_SHAPE
    args = [torch.randn(TRAIN_BATCH, d, device="cuda", generator=gen),
            torch.randn(layers, d, device="cuda", generator=gen) * (0.5 / d**0.5),
            torch.randn(layers, d, device="cuda", generator=gen)]
    cases = {f"b{b}_ms": [args[0][:b], *args[1:]] for b in (TRAIN_BATCH, 1024)}
    return ab_runs(torch, "cross_network", parent, kernels, "cross_network_fused", cases,
                   lambda got, a: max_err(torch, [got], [kernels.cross_network_plain(*a)]))


def check_readings(readings) -> None:
    for shape, r in readings.items():
        check(r["kernel"] <= 1.0, f"{shape}: kernel vs plain {r}")
        check(r.get("same_bits", True), f"{shape}: two calls gave different bits")
        for name, value in r.items():
            if name.startswith("broken"):
                check(value > 1.0, f"{shape}: the check cannot tell a {name} version: {r}")


def cin_bounds(b, f, d, sizes) -> dict:
    """#3's two bounds. Bytes: emb, the weights and the (B, ΣS) output
    once. Operations, per level and row (b, d): 2·H·F·S for the products
    C_f = x·W, 2·F·S + S for acc += e·C_f and the sums over d. The kernel's
    bound takes the products in 3xTF32 (three TF32 multiply-adds per fp32
    one at 495 TFLOP/s) and the rest at 67 TFLOP/s; beside it, the bound of
    the same work all in fp32 FMA at 67 TFLOP/s."""
    hs = [f, *sizes[:-1]]
    m = b * d
    nbytes = 4 * (b * f * d + sum(h * f * s for h, s in zip(hs, sizes)) + b * sum(sizes))
    mma_ops = sum(2 * m * h * f * s for h, s in zip(hs, sizes))
    fma_ops = sum(m * (2 * f * s + s) for s in sizes)
    bound_ms, bound_by = tc_bound(nbytes, fma_ops, mma_ops)
    fp32_ms, fp32_by = bound(nbytes, mma_ops + fma_ops)
    return dict(bound_ms=bound_ms, bound_by=bound_by,
                bound_units="3xTF32 tensor cores (3 TF32 multiply-adds per fp32 one, 495 TFLOP/s)",
                bound_fp32_ms=fp32_ms, bound_fp32_by=fp32_by)


def cin_weights(torch, gen, f, sizes):
    weights, h = [], f
    for s in sizes:
        weights.append((h * f) ** -0.5 * torch.randn(h * f, s, device="cuda", generator=gen))
        h = s
    return weights


CIN_SHAPE = (26, 32, (128, 128))  # xDeepFM's F, D and CIN levels over the FM schema


def check_cin(torch, kernels, detail=False):
    """Kernel #3 against its plain version at the slice's shape (B=8192),
    ``benchmarks/kernel_bench.py``'s B=4096, ``evaluate``'s B=1024, the
    rank path's buckets B=256, 32 and 8 (``serving/server.py:126``), a
    single row (B=1) and a ragged shape, each column's error in units of
    ``CIN_COL_RTOL`` of its largest |value|; a CIN that pairs maps with maps
    and the kernel's arithmetic in single TF32 (``broken_single_tf32``; the
    kernel takes its products in 3xTF32) must read above it; two calls give
    the same bits. Device time (median of 30, L2 flushed) and the plain
    version's at every B of the slice's shape, beside both bounds and the
    launch floor. ``detail``
    (``--cin``) adds the blocks an SM holds and the shared memory a block
    takes. Returns the readings and the B=8192 record."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    floor_ms = launch_floor_ms(torch)
    f0, d0, sizes0 = CIN_SHAPE
    readings, other, record, batch_1024 = {}, {}, None, None
    shapes = [(b, f0, d0, sizes0) for b in (8192, 4096, 1024, 256, 32, 8, 1)] + [(1003, 7, 8, (5, 9, 3))]
    for b, f, d, sizes in shapes:
        if batch_1024 is not None and b < 1024 and sizes == sizes0:
            # the first b rows of the B=1024 batch, held to that batch's
            # column scale: a one-row column's largest |value| is the value
            # itself, and there fp32 in any order reads up to 7 against
            # float64 (CPU, 8 seeds)
            emb, scale_from = batch_1024[0][:b], batch_1024[1]
        else:
            weights = cin_weights(torch, gen, f, sizes)
            emb = torch.randn(b, f, d, device="cuda", generator=gen)
            scale_from = None
        want = kernels.cin_plain(emb, weights)
        got = kernels.cin_fused(emb, weights)
        if b == 1024:
            batch_1024 = emb, want
        readings[f"cin {b}x{f}x{d} {list(sizes)}"] = dict(
            kernel=cin_reading(got, want, scale_from),
            same_bits=bool(torch.equal(got, kernels.cin_fused(emb, weights))),
            broken_fields_from_maps=cin_reading(cin_fields_from_maps(torch, emb, weights), want, scale_from),
            broken_single_tf32=cin_reading(kernels.cin_products(emb, weights, "1xtf32"), want, scale_from),
        )
        if (f, d, sizes) != CIN_SHAPE:
            continue
        rec = dict(
            name="cin", route="cuda", source="tpurec_torch/csrc/cin.cu",
            replaces="tpurec/ops/pallas/kernels.py:248", shape=[b, f, d, list(sizes)],
            max_abs_err=float((got - want).abs().max()),
            ms=device_ms(torch, lambda: kernels.cin_fused(emb, weights)),
            plain_ms=device_ms(torch, lambda: kernels.cin_plain(emb, weights)),
            **cin_bounds(b, f, d, sizes), launch_floor_ms=floor_ms, library_ms=None,
        )
        if b == TRAIN_BATCH:
            record = rec
        else:  # kernel_bench's B=4096, evaluate's B=1024, the rank buckets, a single row
            print(f"cin at B={b}:", json.dumps(rec), flush=True)
            other[f"b{b}"] = rec
    record["other_shapes"] = other
    if detail:
        lib = kernels._library("cin")
        record["smem_bytes_per_block"] = lib.cin_smem_bytes(f0, d0, max(sizes0))
        record["blocks_per_sm"] = kernels._cin_blocks(lib, torch.device("cuda", 0), f0, d0, sizes0)
    print(f"cin readings (error / limit; {CIN_COL_RTOL} of each column's largest |value|):",
          json.dumps(readings), flush=True)
    check_readings(readings)
    return readings, record


def dcn_counts(kernels) -> dict:
    return {k: getattr(kernels, f"{k}_fused").launches for k in DCN_KERNELS}


def dcn_model_config(name, **params):
    from tpurec_torch.config import EmbeddingConfig, ModelConfig

    registry_name, defaults, dim, _ = DCN_MODELS[name]
    return ModelConfig(name=registry_name, params=dict(defaults, hidden_dims=[64, 32], **params),
                       embedding=EmbeddingConfig(dim=dim))


def run_dcn_servable(torch, kernels, workdir, card, name, seed):
    """One DCN-family model over the FM schema: export → load_servable →
    predict at B=8192, bf16 compute (phase 8b)."""
    from tpurec_torch.models import build_model
    from tpurec_torch.serving.export import load_servable
    from tpurec_torch.train.checkpoint import export_params

    kernel = DCN_MODELS[name][3]
    info = fm_info()
    config = dcn_model_config(name, dtype="bfloat16")
    export_dir = os.path.join(workdir, f"{name}_export")
    export_params(
        export_dir, build_model(config, info, device="cuda", seed=seed).state_dict(),
        meta={"model": config.name, "model_params": dict(config.params),
              "embedding": config.embedding.to_dict()},
    )
    servable = load_servable(export_dir, info, device="cuda")
    batch = {k: v for k, v in bench_batch(info, TRAIN_BATCH, 0, seed=0).items() if k != "label"}
    fused, plain = getattr(kernels, f"{kernel}_fused"), getattr(kernels, f"{kernel}_plain")
    seen = {}

    def recorded(*args):
        seen["args"], seen["out"] = args, fused(*args)
        return seen["out"]

    # the wrapper adds its launch to the count of the name it is bound to in
    # the module, here the recorder's
    recorded.launches = 0
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with mock.patch.object(kernels, f"{kernel}_fused", recorded):
        outputs = servable.predict(batch)
        torch.cuda.synchronize()
        counts = dcn_counts(kernels)
    out, logit = outputs["output"], outputs["logit"]

    # the kernel's own call in the servable against the plain and a broken
    # version on its inputs; the whole servable's logit with the plain
    # version and on the CPU
    broken = dict(cross_network=cross_dots_x0, cin=lambda *a: cin_fields_from_maps(torch, *a),
                  senet_bilinear=lambda *a: senet_pairs_swapped(torch, *a))[kernel]

    def kernel_reading(got, want):
        return cin_reading(got, want) if kernel == "cin" else scaled_ratio(got, want, KERNEL_TOL["rtol"])

    with torch.inference_mode():
        want = plain(*seen["args"])
        readings = dict(kernel=kernel_reading(seen["out"], want),
                        kernel_broken=kernel_reading(broken(*seen["args"]), want))
    scale = DCN_LOGIT_RTOL * float(logit.abs().max())
    with mock.patch.object(kernels, f"{kernel}_fused", plain):
        readings["logit_plain"] = float((logit - servable.predict(batch)["logit"]).abs().max()) / scale
    cpu_logit = load_servable(export_dir, info, device="cpu").predict(
        {k: v[:256] for k, v in batch.items()})["logit"]
    readings["logit_cpu_256_rows"] = float((logit[:256].cpu() - cpu_logit).abs().max()) / scale

    times = []
    for _ in range(12):
        t0 = time.perf_counter()
        servable.predict(batch)["output"].cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    p50 = statistics.median(times[2:])
    busy_ms, top_ops = profile_steps(torch, lambda: servable.predict(batch))
    result = dict(card=card, model=name, batch=TRAIN_BATCH, launches=counts, readings=readings,
                  logit_limit=scale, logit_max_abs=float(logit.abs().max()),
                  logit_std=float(logit.std()), mean_prob=float(out.mean()),
                  predict_p50_ms=p50, examples_per_s=TRAIN_BATCH / (p50 / 1e3),
                  device_busy_ms=busy_ms, device_idle_share=1.0 - busy_ms / p50, top_ops_ms=top_ops)
    print(f"{name} servable (readings: error / limit):", json.dumps(result), flush=True)
    check(counts == {k: int(k == kernel) for k in DCN_KERNELS}, f"{name} predict launches {counts}")
    check(out.shape == (TRAIN_BATCH,) and out.dtype == torch.float32, f"{name}: bad output {out.shape}")
    check(bool(torch.isfinite(out).all()) and bool(((out >= 0) & (out <= 1)).all()),
          f"{name}: outputs are not finite probabilities")
    for key, value in readings.items():
        if key == "kernel_broken":
            check(value > 1.0, f"{name}: the check cannot tell a broken {kernel}: {readings}")
        else:
            check(value <= 1.0, f"{name}: {key} {readings}")
    return counts[kernel]


def run_dcn_training(torch, kernels, card, name):
    """DCN_STEPS bf16 dense-engine steps on a fixed batch (the plain math, no
    kernel), then ``evaluate`` on two batches (the kernel once a batch)
    (phase 8c)."""
    from tpurec_torch.config import ExperimentConfig, OptimizerConfig, TrainConfig
    from tpurec_torch.train.trainer import Trainer

    kernel = DCN_MODELS[name][3]
    info = fm_info()
    cfg = ExperimentConfig(
        model=dcn_model_config(name),
        train=TrainConfig(batch_size=TRAIN_BATCH, loss="bce", log_every_steps=0, compute_dtype="bfloat16",
                          optimizer=OptimizerConfig(learning_rate=1e-3)),
    )
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, info)
    batch = bench_batch(info, TRAIN_BATCH, 0, seed=1)
    state = trainer.init_state(batch)
    dbatch = trainer.device_batch(batch)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    state, metric_state, losses, times = drive_steps(torch, trainer, state, dbatch, steps=DCN_STEPS)
    train_counts = dcn_counts(kernels)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 2**30

    def step():
        nonlocal state, metric_state
        state, metric_state, _ = trainer.train_step(state, dbatch, metric_state)

    busy_ms, top_ops = profile_steps(torch, step)
    kernels.reset_launch_counts()
    report = trainer.evaluate(state, [bench_batch(info, 1024, 0, seed=20 + i) for i in range(2)])
    torch.cuda.synchronize()
    eval_counts = dcn_counts(kernels)
    step_ms = statistics.median(times[5:])
    result = dict(
        card=card, model=name, batch=TRAIN_BATCH, steps=DCN_STEPS, step_p50_ms=step_ms,
        step_ms_min=min(times[5:]), step_ms_max=max(times[5:]), examples_per_s=TRAIN_BATCH / (step_ms / 1e3),
        first_step_ms=times[0], device_busy_ms=busy_ms, device_idle_share=1.0 - busy_ms / step_ms,
        top_ops_ms=top_ops, peak_mem_gb=peak_gb, loss_first=losses[0], loss_last=losses[-1],
        train_launches=train_counts, eval_launches=eval_counts, eval=report,
    )
    print(f"{name} training:", json.dumps(result), flush=True)
    check(all(np.isfinite(losses)), f"{name}: non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"{name}: the loss did not fall in {DCN_STEPS} steps: {losses}")
    check(not any(train_counts.values()), f"{name}: train steps launched {train_counts}")
    check(eval_counts == {k: 2 * int(k == kernel) for k in DCN_KERNELS},
          f"{name}: evaluate on 2 batches launched {eval_counts}")
    return train_counts[kernel], eval_counts[kernel]


def run_dcn_family(torch, kernels, workdir, card):
    """Phase 8b and 8c for each model; returns each kernel's launches by path."""
    launches = {}
    for seed, name in enumerate(DCN_MODELS):
        kernel = DCN_MODELS[name][3]
        predict = run_dcn_servable(torch, kernels, workdir, card, name, seed)
        train, evaluate = run_dcn_training(torch, kernels, card, name)
        launches[kernel] = {f"{name}_predict": predict, f"{name}_train_steps": train,
                            f"{name}_evaluate": evaluate}
    return launches


# ---------------------------------------------------------------------------
# phase 9: MIND multi-interest retrieval (kernels #7 and #8)
# MIND's servable in bf16: its fp32 user embedding and capsules (unit
# vectors times the softplus logit scale) card against CPU at 2^-5 of their
# largest |value| (bf16 roundings of the capsule MLP taken in another
# order, as DCN_LOGIT_RTOL). The routing call inside the servable against
# the plain version on its inputs at KERNEL_TOL's rtol of the largest
# |value|: at the seeded init the capsules are ~1e-2 and an iteration moves
# them by ~1e-5, below KERNEL_TOL's atol.
MIND_EMB_RTOL = 2.0**-5
MIND_STEPS = 20
MIND_PARAMS = dict(num_interests=4, hidden_dims=[64], normalize_logits=True)
# the other multi-interest models over the same schema (no kernel)
RETRIEVAL_MODELS = {
    "comirec_sa": ("comirec", dict(variant="sa")),
    "comirec_dr": ("comirec", dict(variant="dr")),
    "sine": ("sine", dict(normalize_logits=True)),
}
MIND_USERS, MIND_ITEMS, MIND_REQUESTS = 5000, 20000, 200


def mind_info():
    """The phase 4 DIN id space with two aligned series (item ids and their
    tags): 21,500 ids, padded to 21,504 rows."""
    from tpurec_torch.data.schema import DataInfo

    return DataInfo.from_dims(
        ["user_tag", "item_id", "item_tag"], [1000, 20000, 500],
        sequence_names=["history", "history_tags"], sequence_query_features=["item_id", "item_tag"],
        user_features=["user_tag"], item_features=["item_id", "item_tag"],
        max_seq_length=64, padding_index=0,
    )


def mind_batch(info, batch_size, seed=0, seq_len=64):
    """``bench.py:75-87``'s batch over the MIND schema: each feature from its
    own range, the history from item_id's and its tags from item_tag's, one
    tail-padded length L/4..L for both series."""
    rng = np.random.default_rng(seed)
    span = dict(zip(info.feature_names, zip(info.feature_offsets, info.feature_dims)))
    batch = {n: rng.integers(o, o + d, size=(batch_size,)) for n, (o, d) in span.items()}
    lengths = rng.integers(seq_len // 4, seq_len + 1, size=(batch_size,))
    live = np.arange(seq_len)[None, :] < lengths[:, None]
    for sname, query in zip(info.sequence_names, info.sequence_query_features):
        o, d = span[query]
        batch[sname] = np.where(live, rng.integers(o, o + d, size=(batch_size, seq_len)), 0)
    return batch


def mind_train_config(dtype, name="mind", params=None, **train):
    """``benchmarks/parity.py``'s MIND recipe at D=32: in-batch softmax, Adam
    lr 2e-3 eps 1e-7, the dense engine."""
    from tpurec_torch.config import (
        EmbeddingConfig, ExperimentConfig, ModelConfig, OptimizerConfig, TrainConfig,
    )

    return ExperimentConfig(
        model=ModelConfig(name=name, params=dict(MIND_PARAMS if params is None else params),
                          embedding=EmbeddingConfig(dim=32)),
        train=TrainConfig(batch_size=TRAIN_BATCH, loss="in_batch_softmax", log_every_steps=0,
                          compute_dtype=dtype, optimizer=OptimizerConfig(learning_rate=2e-3), **train),
    )


def routing_inputs(torch, gen, b, l, d, e, k, broadcast=True, empty_row=True):
    """behavior, a mask of lengths L/4..L (row b // 2 all zero unless
    ``empty_row`` is False), S at the scale of its glorot init and logits0,
    broadcast from one (K, L) slice as the model passes it, or one slice a
    row."""
    lengths = torch.randint(l // 4, l + 1, (b,), device="cuda", generator=gen)
    if empty_row:
        lengths[b // 2] = 0
    mask = (torch.arange(l, device="cuda")[None, :] < lengths[:, None]).float()
    beh = torch.randn(b, l, d, device="cuda", generator=gen)
    s = torch.randn(d, e, device="cuda", generator=gen) * (2.0 / (d + e)) ** 0.5
    l0 = torch.randn(1 if broadcast else b, k, l, device="cuda", generator=gen).expand(b, k, l)
    return [beh, mask, s, l0]


def routing_variant(torch, beh, mask, s, l0, iters, stop_grad=True, chain=True):
    """The plain routing with two switches that break its gradient on
    purpose: ``stop_grad=False`` differentiates through every iteration's u,
    ``chain=False`` lets only the last iteration's softmax reach logits0."""
    from tpurec_torch.ops.capsule import squash

    u = torch.einsum("bld,de->ble", beh, s)
    live = mask.bool()[:, None, :]
    logits = l0
    for it in range(iters):
        last = it == iters - 1
        lg = logits if (chain or last) else logits.detach()
        w = torch.softmax(torch.where(live, lg, -1e9), dim=1) * mask[:, None, :]
        src = u if (last or not stop_grad) else u.detach()
        caps = squash(torch.einsum("bkl,ble->bke", w, src))
        if not last:
            logits = logits + torch.einsum("bke,ble->bkl", caps, src)
    return caps


def routing_grads(torch, fn, args, g):
    """(dbehavior, dS, dlogits0) of ``fn(behavior, mask, S, logits0)`` at g."""
    leaves = [t.detach().clone().requires_grad_() for t in (args[0], args[2], args[3])]
    with torch.enable_grad():
        return torch.autograd.grad(fn(leaves[0], args[1], leaves[1], leaves[2]), leaves, g)


def routing_bwd_reading(got, want) -> dict:
    """Each backward output's error in units of its limit: dbehavior and
    dlogits0 elementwise at KERNEL_TOL, dS (a sum over B·L rows) at
    DIN_BWD_PARAM_RTOL of its largest value."""
    return dict(dbehavior=tol_ratio(got[0], want[0], **KERNEL_TOL),
                dS=scaled_ratio(got[1], want[1], DIN_BWD_PARAM_RTOL),
                dlogits0=tol_ratio(got[2], want[2], **KERNEL_TOL))


def routing_work(b, live, l, d, e, k, iters):
    """The work this run's mask needs, as ``(bytes, fp32 operations,
    tensor-core operations)`` for the forward and for the backward. A
    masked step has w = 0: it adds nothing to z, and its du, dbehavior row
    and dS terms are 0, so u, z, the logit update and the backward's
    products count live steps only. du = w_lastᵀ dz has rank K, so the
    backward's dbehavior and dS count as the K-deep products the kernel
    computes, w_lastᵀ (dz Sᵀ) and (w_last x)ᵀ dz, not as the L-deep du Sᵀ
    and xᵀ du. The tensor-core operations are the products the kernels
    take in 3xTF32: u = x S in both, dz Sᵀ in the backward; the rest is
    fp32 on the CUDA cores.
    Bytes: behavior read at live steps, the mask, S, one (K, L) logits0
    slice, the capsules written; the backward reads g as well and writes
    all of dbehavior, dS and dlogits0."""
    route = 2 * k * live * e  # one (K, L)·(L, E) or (K, E)·(E, L) product
    u = 2 * live * d * e
    fwd_fma = iters * route + (iters - 1) * route + iters * b * k * (6 * l + 4 * e)
    dz_st = 2 * k * b * d * e
    k_deep = 2 * k * (2 * live * d + b * d * e)  # w x, w (dz Sᵀ); (w x)ᵀ dz
    bwd_fma = fwd_fma + 2 * route + 2 * (iters - 1) * route + k_deep
    fwd_bytes = 4 * (live * d + b * l + d * e + k * l + b * k * e)
    bwd_bytes = fwd_bytes + 4 * (b * l * d + d * e + b * k * l)
    return (fwd_bytes, fwd_fma, u), (bwd_bytes, bwd_fma, u + dz_st)


ROUTING_BOUND_UNITS = ("u = x·S (and the backward's dz·Sᵀ) on the 3xTF32 tensor cores (3 TF32 multiply-adds "
                       "per fp32 one, 495 TFLOP/s), the rest fp32 at 67 TFLOP/s; bound_fp32_ms: all at 67")


def launch_floor_ms(torch) -> float:
    """``device_ms`` of an empty kernel (``torch.cuda._sleep(0)``): the
    least time one launch reads in this harness."""
    return device_ms(torch, lambda: torch.cuda._sleep(0))


def holey_mask(torch, gen, mask):
    """``mask`` with holes: every other row random steps, row 1 all zero,
    row 2 live at its last step only."""
    mask = mask.clone()
    mask[::2] = (torch.rand(mask[::2].shape, device="cuda", generator=gen) < 0.5).float()
    mask[1] = 0.0
    mask[2] = 0.0
    mask[2, -1] = 1.0
    return mask


def check_capsule_kernels(torch, kernels, detail=False):
    """Kernels #7 and #8 against their plain versions at the slice's shape,
    kernel_bench's B=4096 and ragged shapes; broken versions (#8's products
    in single TF32 among them) must read above the limit (phase 9a). Both
    also with a mask with holes, two calls the same bits; #7 at the serving
    shapes B=1 and B=1024, #8 at B=1024, each with the launch floor beside
    its bound; #8's route, blocks and per-launch split. ``detail``
    (``--capsule``) adds #7's time at B=1 for 1 and 2 iterations (what one
    iteration costs a row) and both kernels' registers and spills."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    lib = kernels._library("capsule_routing")
    floor_ms = launch_floor_ms(torch)
    # (B, L, D, E, K, iterations, broadcast logits0)
    shapes = [(TRAIN_BATCH, 64, 64, 64, 4, 3, True), (4096, 64, 64, 64, 4, 3, False),
              (9, 12, 8, 8, 4, 3, True), (33, 50, 48, 40, 3, 3, False), (9, 12, 8, 8, 4, 1, True),
              (33, 50, 48, 40, 3, 2, True)]
    readings, records, other = {}, {}, {}
    for b, l, d, e, k, iters, broadcast in shapes:
        args = routing_inputs(torch, gen, b, l, d, e, k, broadcast)
        g = torch.randn(b, k, e, device="cuda", generator=gen)
        want = kernels.capsule_routing_plain(*args, iters)
        got = kernels.capsule_routing_fused(*args, iters)
        r = dict(kernel=tol_ratio(got, want, **KERNEL_TOL),
                 same_bits=bool(torch.equal(got, kernels.capsule_routing_fused(*args, iters))),
                 broken_mask_ignored=tol_ratio(kernels.capsule_routing_plain(
                     args[0], torch.ones_like(args[1]), *args[2:], iters), want, **KERNEL_TOL),
                 broken_single_tf32=tol_ratio(kernels.capsule_routing_products(
                     *args, iters, products="1xtf32"), want, **KERNEL_TOL))
        if iters > 1:
            r["broken_one_iteration_fewer"] = tol_ratio(
                kernels.capsule_routing_plain(*args, iters - 1), want, **KERNEL_TOL)
        want_bwd = kernels.capsule_routing_bwd_plain(*args, g, iters)
        got_bwd = kernels.capsule_routing_bwd_fused(*args, g, iters)
        again = kernels.capsule_routing_bwd_fused(*args, g, iters)
        r["bwd_same_bits"] = all(torch.equal(x, y) for x, y in zip(got_bwd, again))
        r["bwd"] = routing_bwd_reading(got_bwd, want_bwd)
        # the backward's tensor-core products (u = x·S, dz·Sᵀ) in single
        # TF32 (the kernel takes them in 3xTF32)
        r["broken_bwd_single_tf32"] = routing_bwd_reading(
            kernels.capsule_routing_bwd_products(*args, g, iters, products="1xtf32"), want_bwd)
        if iters > 1:
            for name, kw in (("broken_bwd_through_stop_gradient", dict(stop_grad=False)),
                             ("broken_bwd_dlogits0_last_iteration", dict(chain=False))):
                fn = lambda x, m, s, l0, kw=kw: routing_variant(torch, x, m, s, l0, iters, **kw)  # noqa: E731
                r[name] = routing_bwd_reading(routing_grads(torch, fn, args, g), want_bwd)
        shape = f"{b}x{l}x{d}x{e} K={k} iters={iters}" + ("" if broadcast else " dense logits0")
        readings[shape] = r
        if b in (TRAIN_BATCH, 4096):
            live = int(args[1].sum())
            fwd, bwd = routing_work(b, live, l, d, e, k, iters)
            base = dict(route="cuda", source="tpurec_torch/csrc/capsule_routing.cu",
                        shape=[b, l, d, e, k, iters], live_steps=live, library_ms=None,
                        bound_units=ROUTING_BOUND_UNITS)
            fwd_bound, fwd_by = tc_bound(*fwd)
            bwd_bound, bwd_by = tc_bound(*bwd)
            recs = dict(
                capsule_routing=dict(
                    base, name="capsule_routing", replaces="tpurec/ops/pallas/kernels.py:779",
                    max_abs_err=float((kernels.capsule_routing_fused(*args, iters) - want).abs().max()),
                    ms=device_ms(torch, lambda: kernels.capsule_routing_fused(*args, iters)),
                    plain_ms=device_ms(torch, lambda: kernels.capsule_routing_plain(*args, iters)),
                    bound_ms=fwd_bound, bound_by=fwd_by, bound_fp32_ms=bound(fwd[0], fwd[1] + fwd[2])[0],
                    launch_floor_ms=floor_ms,
                    blocks=kernels._capsule_blocks(kernels._library("capsule_routing"), args[0].device,
                                                   l, d, e, k),
                    split_ms=kernel_split(torch, lambda: kernels.capsule_routing_fused(*args, iters))),
                capsule_routing_bwd=dict(
                    base, name="capsule_routing_bwd", replaces="tpurec/ops/pallas/kernels.py:907",
                    max_abs_err=max(float((x - y).abs().max()) for x, y in zip(got_bwd, want_bwd)),
                    ms=device_ms(torch, lambda: kernels.capsule_routing_bwd_fused(*args, g, iters)),
                    plain_ms=device_ms(torch, lambda: kernels.capsule_routing_bwd_plain(*args, g, iters)),
                    bound_ms=bwd_bound, bound_by=bwd_by, bound_fp32_ms=bound(bwd[0], bwd[1] + bwd[2])[0],
                    bytes_bound_ms=bwd[0] / HBM_BYTES_PER_S * 1e3,
                    launch_floor_ms=floor_ms, tensor_cores=bool(lib.capsule_routing_bwd_route(l, d, e, k, iters)),
                    blocks=kernels._capsule_bwd_blocks(lib, args[0].device, l, d, e, k, iters),
                    split_ms=kernel_split(torch, lambda: kernels.capsule_routing_bwd_fused(*args, g, iters))),
            )
            for name, rec in recs.items():
                if b == TRAIN_BATCH:
                    records[name] = rec
                else:
                    print(f"{name} at kernel_bench's B=4096:", json.dumps(rec), flush=True)
                    other[name, f"b{b}"] = rec
    # a mask with holes: zero steps inside a row's live range go through
    # the math (w = 0 there), only the tail past the last live step is
    # skipped
    args = routing_inputs(torch, gen, 1003, 64, 64, 64, 4)
    args[1] = holey_mask(torch, gen, args[1])
    got = kernels.capsule_routing_fused(*args, 3)
    g = torch.randn(1003, 4, 64, device="cuda", generator=gen)
    got_bwd = kernels.capsule_routing_bwd_fused(*args, g, 3)
    readings["mask_with_holes 1003x64x64x64 K=4 iters=3"] = dict(
        kernel=tol_ratio(got, kernels.capsule_routing_plain(*args, 3), **KERNEL_TOL),
        same_bits=bool(torch.equal(got, kernels.capsule_routing_fused(*args, 3))),
        bwd=routing_bwd_reading(got_bwd, kernels.capsule_routing_bwd_plain(*args, g, 3)),
        bwd_same_bits=all(torch.equal(x, y) for x, y in zip(got_bwd, kernels.capsule_routing_bwd_fused(*args, g, 3))))
    check(not got[1].any(), "capsule_routing: a row whose mask is all zero gave nonzero capsules")
    check(not got_bwd[0][1].any() and not got_bwd[2][1].any(),
          "capsule_routing_bwd: a row whose mask is all zero gave nonzero dbehavior or dlogits0")
    check(lib.capsule_routing_bwd_route(64, 64, 64, 4, 3) == 1,
          "capsule_routing_bwd: the slice's shape must take the tensor-core kernel")
    # #7 at the serving paths' shapes: the HTTP user tower's B=1 and the
    # offline index's and evaluate's B=1024
    for b in (1, 1024):
        args = routing_inputs(torch, gen, b, 64, 64, 64, 4, empty_row=False)
        want = kernels.capsule_routing_plain(*args, 3)
        got = kernels.capsule_routing_fused(*args, 3)
        readings[f"{b}x64x64x64 K=4 iters=3 (serving)"] = dict(
            kernel=tol_ratio(got, want, **KERNEL_TOL),
            same_bits=bool(torch.equal(got, kernels.capsule_routing_fused(*args, 3))))
        bound_ms, bound_by = tc_bound(*routing_work(b, int(args[1].sum()), 64, 64, 64, 4, 3)[0])
        rec = dict(shape=[b, 64, 64, 64, 4, 3], live_steps=int(args[1].sum()),
                   ms=device_ms(torch, lambda: kernels.capsule_routing_fused(*args, 3)),
                   plain_ms=device_ms(torch, lambda: kernels.capsule_routing_plain(*args, 3)),
                   bound_ms=bound_ms, bound_by=bound_by, launch_floor_ms=floor_ms)
        if detail:
            rec["iterations_ms"] = {
                it: device_ms(torch, lambda it=it: kernels.capsule_routing_fused(*args, it))
                for it in (1, 2, 3)}
            rec["split_ms"] = kernel_split(torch, lambda: kernels.capsule_routing_fused(*args, 3))
        print("capsule_routing at a serving shape:", json.dumps(rec), flush=True)
        other["capsule_routing", f"b{b}"] = rec
    # #8 at B=1024, beside the launch floor
    args = routing_inputs(torch, gen, 1024, 64, 64, 64, 4, empty_row=False)
    g = torch.randn(1024, 4, 64, device="cuda", generator=gen)
    got_bwd = kernels.capsule_routing_bwd_fused(*args, g, 3)
    readings["1024x64x64x64 K=4 iters=3 (backward)"] = dict(
        bwd=routing_bwd_reading(got_bwd, kernels.capsule_routing_bwd_plain(*args, g, 3)),
        bwd_same_bits=all(torch.equal(x, y) for x, y in zip(got_bwd, kernels.capsule_routing_bwd_fused(*args, g, 3))))
    bound_ms, bound_by = tc_bound(*routing_work(1024, int(args[1].sum()), 64, 64, 64, 4, 3)[1])
    rec = dict(shape=[1024, 64, 64, 64, 4, 3], live_steps=int(args[1].sum()),
               ms=device_ms(torch, lambda: kernels.capsule_routing_bwd_fused(*args, g, 3)),
               plain_ms=device_ms(torch, lambda: kernels.capsule_routing_bwd_plain(*args, g, 3)),
               bound_ms=bound_ms, bound_by=bound_by, launch_floor_ms=floor_ms,
               split_ms=kernel_split(torch, lambda: kernels.capsule_routing_bwd_fused(*args, g, 3)))
    print("capsule_routing_bwd at B=1024:", json.dumps(rec), flush=True)
    other["capsule_routing_bwd", "b1024"] = rec
    print(f"capsule routing readings (error / limit; {KERNEL_TOL}, dS at {DIN_BWD_PARAM_RTOL} of "
          "its largest value):", json.dumps(readings), flush=True)
    for shape, r in readings.items():
        # a reading of #7 has its error and same bits, one of #8 its errors
        # and same bits; a missing entry fails here
        check("kernel" in r or "bwd" in r, f"capsule routing at {shape}: no reading of either kernel: {r}")
        if "kernel" in r:
            check(r["kernel"] <= 1.0, f"capsule_routing vs plain at {shape}: {r}")
            check(r["same_bits"], f"capsule_routing at {shape}: two calls gave different bits")
        if "bwd" in r:
            check(max(r["bwd"].values()) <= 1.0, f"capsule_routing_bwd vs plain at {shape}: {r}")
            check(r["bwd_same_bits"], f"capsule_routing_bwd at {shape}: two calls gave different bits")
        for name, value in r.items():
            if name.startswith("broken"):
                worst = max(value.values()) if isinstance(value, dict) else value
                check(worst > 1.0, f"{shape}: the check cannot tell a {name} version: {r}")
    for name in ("capsule_routing", "capsule_routing_bwd"):
        records[name]["other_shapes"] = {shape: r for (n, shape), r in other.items() if n == name}
    if detail:
        ptxas = ptxas_resources(kernels.library_path("capsule_routing"), "capsule_routing_kernelILi8E",
                                "capsule_routing_bwd_tc_kernelILi8E", "capsule_routing_bwd_fma_kernel")
        records["capsule_routing"]["ptxas"] = ptxas["capsule_routing_kernelILi8E"]
        records["capsule_routing_bwd"]["ptxas"] = {k: v for k, v in ptxas.items() if "bwd" in k}
    for rec in records.values():
        print("kernel check:", json.dumps(rec), flush=True)
    return records


def routing_pair_ab(torch, kernels, card):
    """The measurement to make before the kernels go into training: one
    forward and backward of MIND's routing at the training shape (B=8192,
    bf16 behavior), through the kernel pair (``CapsuleRouting`` in fp32,
    as outside training) against autograd through the module's training
    math. Both orders, in turns; the dispatch stays as it is."""
    from tpurec_torch.ops.capsule import CapsuleRouting

    gen = torch.Generator(device="cuda").manual_seed(10)
    b, l, d, k = TRAIN_BATCH, 64, 64, 4
    beh, mask, s, _ = routing_inputs(torch, gen, b, l, d, d, k)
    module = CapsuleRouting(d, k, d, dtype=torch.bfloat16).cuda()
    with torch.no_grad():
        module.S.copy_(s)
    beh = (0.05 * beh).to(torch.bfloat16).requires_grad_()
    g = torch.randn(b, k, d, device="cuda", generator=gen).to(torch.bfloat16)

    def pair():
        module.S.grad, beh.grad = None, None
        caps = kernels.CapsuleRouting.apply(beh.float(), mask, module.S, module.routing_init(l).expand(b, k, l),
                                            module.num_iterations)
        caps.to(torch.bfloat16).backward(g)

    def math():
        module.S.grad, beh.grad = None, None
        module.train()(beh, mask)[0].backward(g)

    kernels.reset_launch_counts()
    pair()
    launched = (kernels.capsule_routing_fused.launches, kernels.capsule_routing_bwd_fused.launches)
    ds_pair = module.S.grad.clone()
    math()
    ds_math = module.S.grad.clone()
    times = dict(math=[], pair=[])
    for name in ("math", "pair", "pair", "math"):
        times[name].append(device_ms(torch, dict(pair=pair, math=math)[name], iters=10))
    result = dict(card=card, shape=[b, l, d, d, k, 3], kernel_pair_ms=min(times["pair"]),
                  module_math_ms=min(times["math"]), runs_ms=times, launches_in_one_pair=launched,
                  dS_rel_diff=float((ds_pair - ds_math).abs().max() / ds_math.abs().max()))
    print("routing forward+backward, kernel pair vs module math (training shape, bf16):",
          json.dumps(result), flush=True)
    check(launched == (1, 1), f"the kernel pair launched {launched}")
    return result


def capsule_bwd_ab(torch, kernels, parent_dir, card):
    """Kernel #8 of the checkout at ``parent_dir`` against this one's, on the
    same inputs in one process: parent, change, change, parent at B=8192,
    4096 and 1024 (the slice's widths), each held to the plain version and
    timed; #7 of both trees at B=8192, the same bits and timed the same way;
    then ``routing_pair_ab`` through the parent's kernel pair and this
    tree's, in the same turns."""
    parent = parent_kernels(parent_dir)
    parent.build(["capsule_routing"])
    gen = torch.Generator(device="cuda").manual_seed(9)
    args = routing_inputs(torch, gen, TRAIN_BATCH, 64, 64, 64, 4)
    g = torch.randn(TRAIN_BATCH, 4, 64, device="cuda", generator=gen)
    cases = {f"b{rows}_ms": [args[0][:rows], args[1][:rows], args[2], args[3][:rows], g[:rows], 3]
             for rows in (TRAIN_BATCH, 4096, 1024)}

    def held(got, a):
        r = routing_bwd_reading(got, kernels.capsule_routing_bwd_plain(*a))
        check(max(r.values()) <= 1.0, f"capsule_routing_bwd a/b at B={a[0].shape[0]}: {r}")

    runs = ab_runs(torch, "capsule_routing_bwd", parent, kernels, "capsule_routing_bwd_fused", cases, held)
    same = torch.equal(parent.capsule_routing_fused(*args, 3), kernels.capsule_routing_fused(*args, 3))
    print("capsule_routing (#7), parent and change the same bits:", same, flush=True)
    check(same, "#7 gives other bits than the parent's")
    fwd_runs = ab_runs(torch, "capsule_routing", parent, kernels, "capsule_routing_fused",
                       {"b8192_ms": [*args, 3]}, lambda got, a: None)
    pairs = []
    for label, mod in (("parent", parent), ("change", kernels), ("change", kernels), ("parent", parent)):
        pairs.append(dict(tree=label, **routing_pair_ab(torch, mod, card)))
    return runs, fwd_runs, pairs


def run_mind_serving(torch, kernels, workdir, card):
    """MIND in bf16 through export → load_servable → predict, the offline
    index with and without diversity, and the HTTP server (phase 9b).
    Returns #7's launches on each path."""
    from tpurec_torch.config import EmbeddingConfig, ModelConfig
    from tpurec_torch.models import build_model
    from tpurec_torch.serving import DictKVStore, OfflineIndexer
    from tpurec_torch.serving.export import load_servable
    from tpurec_torch.serving.server import RecommendService, serve_background
    from tpurec_torch.train.checkpoint import export_params

    info = mind_info()
    config = ModelConfig(name="mind", params=dict(MIND_PARAMS, dtype="bfloat16"),
                         embedding=EmbeddingConfig(dim=32))
    export_dir = os.path.join(workdir, "mind_export")
    export_params(
        export_dir, build_model(config, info, device="cuda", seed=0).state_dict(),
        meta={"model": "mind", "model_params": dict(config.params),
              "embedding": config.embedding.to_dict()},
    )
    servable = load_servable(export_dir, info, device="cuda")
    check(servable.model.emb.embedding.shape == (21_504, 32), "unexpected MIND table rows")
    batch = mind_batch(info, TRAIN_BATCH, seed=0)
    fused = kernels.capsule_routing_fused
    seen = {}

    def recorded(*args):
        seen["args"], seen["out"] = args, fused(*args)
        return seen["out"]

    # the wrapper adds its launch to the count of the name it is bound to in
    # the module, here the recorder's
    recorded.launches = 0
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with mock.patch.object(kernels, "capsule_routing_fused", recorded):
        outputs = servable.predict(batch)
        torch.cuda.synchronize()
        predict_launches = (recorded.launches, kernels.capsule_routing_bwd_fused.launches)
    user, caps = outputs["user_embedding"], outputs["interest_capsules"]

    # the routing the servable ran against the plain and broken versions on
    # its inputs; the user tower on the card against the port on the CPU
    beh, mask, s, l0, iters = seen["args"]
    with torch.inference_mode():
        want = kernels.capsule_routing_plain(beh, mask, s, l0, iters)
        rtol = KERNEL_TOL["rtol"]
        readings = dict(
            kernel=scaled_ratio(seen["out"], want, rtol),
            broken_mask_ignored=scaled_ratio(
                kernels.capsule_routing_plain(beh, torch.ones_like(mask), s, l0, iters), want, rtol),
            broken_one_iteration_fewer=scaled_ratio(
                kernels.capsule_routing_plain(beh, mask, s, l0, iters - 1), want, rtol),
        )
    cpu_out = load_servable(export_dir, info, device="cpu").predict(
        {k: v[:256] for k, v in batch.items()})
    for key in ("user_embedding", "interest_capsules"):
        readings[f"{key}_cpu_256_rows"] = scaled_ratio(outputs[key][:256].cpu(), cpu_out[key], MIND_EMB_RTOL)

    times = []
    for _ in range(12):
        t0 = time.perf_counter()
        servable.predict(batch)["user_embedding"].cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    p50 = statistics.median(times[2:])
    busy_ms, top_ops = profile_steps(torch, lambda: servable.predict(batch))
    result = dict(card=card, batch=TRAIN_BATCH, launches=predict_launches, readings=readings,
                  live_steps=int(mask.sum()), capsule_max_abs=float(want.abs().max()),
                  predict_p50_ms=p50, examples_per_s=TRAIN_BATCH / (p50 / 1e3),
                  device_busy_ms=busy_ms, device_idle_share=1.0 - busy_ms / p50, top_ops_ms=top_ops)
    print("mind servable (readings: error / limit):", json.dumps(result), flush=True)
    check(predict_launches == (1, 0), f"MIND predict launched (#7, #8) {predict_launches}")
    check(user.shape == (TRAIN_BATCH, 64) and caps.shape == (TRAIN_BATCH, 4, 64),
          f"bad MIND outputs {user.shape} {caps.shape}")
    check(all(bool(torch.isfinite(outputs[k]).all()) for k in ("user_embedding", "interest_capsules", "output")),
          "non-finite MIND outputs")
    for key, value in readings.items():
        if key.startswith("broken"):
            check(value > 1.0, f"the routing check cannot tell a {key} version: {readings}")
        else:
            check(value <= 1.0, f"MIND servable: {key} {readings}")

    # the offline index over 5,000 seeded users and every item, plain and
    # with ComiRec's diversity slate (categories: each item's tag)
    rng = np.random.default_rng(1)
    ub = mind_batch(info, MIND_USERS, seed=5)
    user_names, item_names = ["user_tag", "history", "history_tags"], ["item_id", "item_tag"]
    user_profile = {f"u{j}": [int(ub["user_tag"][j]), ub["history"][j].tolist(),
                              ub["history_tags"][j].tolist()] for j in range(MIND_USERS)}
    item_off, tag_off = info.offset_of("item_id"), info.offset_of("item_tag")
    item_tags = rng.integers(0, 500, size=MIND_ITEMS)
    item_profile = {f"i{j}": [item_off + j, tag_off + int(item_tags[j])] for j in range(MIND_ITEMS)}

    def filled(batch, extra):
        b = next(iter(batch.values())).shape[0]
        out = dict(batch)
        for name, (value, width) in extra.items():
            out[name] = torch.full((b, width) if width else (b,), value, device="cuda")
        return out

    # MIND has no user_embedding method: its user tower is predict's
    # capsules with a dummy target (tests/test_serving.py:301-309), its item
    # tower predict's item embedding with a dummy history
    def user_tower(batch):
        return servable.predict(filled(batch, dict(item_id=(item_off, 0), item_tag=(tag_off, 0))))[
            "interest_capsules"]

    def item_tower(batch):
        return servable.predict(filled(batch, dict(user_tag=(0, 0), history=(item_off, 64),
                                                   history_tags=(tag_off, 64))))["item_embedding"]

    indexer = OfflineIndexer(user_tower, item_tower, user_profile, item_profile, user_names, item_names,
                             batch_size=1024, device="cuda")
    kernels.reset_launch_counts()
    index, kvs, index_s = {}, {}, {}
    for label, extra in (("plain", {}), ("diverse", dict(item_categories=item_tags, diversity_weight=10.0))):
        kvs[label] = DictKVStore()
        t0 = time.perf_counter()
        index[label] = indexer.run(os.path.join(workdir, f"mind_index_{label}"), kv_store=kvs[label],
                                   topk=20, key_prefix="MIND", **extra)
        index_s[label] = time.perf_counter() - t0
    torch.cuda.synchronize()
    index_launches = kernels.capsule_routing_fused.launches
    tag_of = {f"i{j}": int(t) for j, t in enumerate(item_tags)}
    # the first pick maximises score + 10: scores within an fp32 ulp of 10
    # (2^-20) of the top tie there, and the first of them wins
    distinct, same_top1, ties = [], 0, 0
    for uid in user_profile:
        plain, diverse = (kvs[label].get(f"MIND_{uid}").split("\t") for label in ("plain", "diverse"))
        items = diverse[0].split(",")
        distinct.append(len({tag_of[i] for i in items}))
        same = plain[0].split(",")[0] == items[0]
        tie = abs(float(plain[1].split(",")[0]) - float(diverse[1].split(",")[0])) <= 2.0**-20
        same_top1 += same or tie
        ties += tie and not same
    index_result = dict(seconds=index_s, launches=index_launches, users=len(kvs["plain"]),
                        min_distinct_tags=min(distinct), same_top1=same_top1, top1_ties=ties,
                        user_embeddings=list(index["plain"]["user_embeddings"].shape))
    print("mind offline index:", json.dumps(index_result), flush=True)
    check(len(kvs["plain"]) == len(kvs["diverse"]) == MIND_USERS, "MIND index: KV store size")
    check(index_result["user_embeddings"] == [MIND_USERS, 4, 64], f"MIND index: {index_result}")
    check(min(distinct) == 20 and same_top1 == MIND_USERS, f"MIND diversity slates: {index_result}")

    # HTTP: retrieve/kv, retrieve/online and retrieve/online with diversity
    service = RecommendService(
        user_tower=user_tower, user_profile=user_profile, user_feature_names=user_names,
        kv_store=kvs["plain"], item_ids=index["plain"]["item_ids"],
        item_embeddings=index["plain"]["item_embeddings"], item_categories=item_tags,
        key_prefix="MIND", device="cuda",
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

    def descending(result):
        scores = list(result.values())
        return len(result) == 20 and scores == sorted(scores, reverse=True)

    # the index's user tower ran at B=1024, the server's at B=1: bf16
    # products of other shapes, so the top-1 cosine agrees to 2^-6
    top1_gap = []

    def online_check(uid, r):
        check(descending(r["result"]), "retrieve/online shape")
        top1_gap.append(abs(max(r["result"].values()) - max(service.retrieve_kv(uid).values())))

    def diverse_check(uid, r):
        items = list(r["result"])
        check(len(items) == 20 and len({tag_of[i] for i in items}) == 20,
              f"retrieve/online diverse slate of {uid}: {items}")
        plain = service.retrieve_online(uid, 20)
        first = next(iter(plain))
        check(items[0] == first or abs(r["result"][items[0]] - plain[first]) <= 2.0**-20,
              "the diverse slate's first pick is not the plain top-1")

    paths = {
        "retrieve_kv": (dict(source="kv"), lambda uid, r: check(descending(r["result"]), "retrieve/kv shape")),
        "retrieve_online_top20": (dict(topk=20), online_check),
        "retrieve_online_diverse": (dict(topk=20, diversity_weight=10.0), diverse_check),
    }
    uids = rng.choice(list(user_profile), size=MIND_REQUESTS, replace=False).tolist()
    latency = {}
    kernels.reset_launch_counts()
    try:
        for name, (extra, verify) in paths.items():
            for uid in uids[:5]:
                post(dict(user_id=uid, type="retrieve", **extra))
            times = []
            for uid in uids:
                body, ms = post(dict(user_id=uid, type="retrieve", **extra))
                check("error" not in body, f"{name}: {body}")
                verify(uid, body)
                times.append(ms)
            latency[name] = dict(p50_ms=statistics.median(times), p95_ms=float(np.percentile(times, 95)))
    finally:
        server.shutdown()
        server.server_close()
    torch.cuda.synchronize()
    http_launches = kernels.capsule_routing_fused.launches
    http = dict(card=card, launches=http_launches, requests_per_path=MIND_REQUESTS, latency=latency,
                online_top1_vs_kv_max_gap=max(top1_gap))
    print("mind http serving:", json.dumps(http), flush=True)
    check(max(top1_gap) <= 2.0**-6, f"online top-1 disagrees with the offline index: {max(top1_gap)}")
    check(http_launches > 0, "the HTTP path did not launch #7")
    return dict(mind_predict=predict_launches[0], mind_index=index_launches, mind_http=http_launches)


def run_mind_training(torch, kernels, workdir, card):
    """MIND_STEPS bf16 dense steps (the module's math: neither kernel),
    ``evaluate`` (#7 once a batch), the kernel-pair A/B, and run → restore
    → export → load_servable (phase 9c). Returns #7's launches by path."""
    from tpurec_torch.serving.export import load_servable
    from tpurec_torch.train.trainer import Trainer

    info = mind_info()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(mind_train_config("bfloat16"), info)
    batch = mind_batch(info, TRAIN_BATCH, seed=1)
    state = trainer.init_state(batch)
    dbatch = trainer.device_batch(batch)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    state, metric_state, losses, times = drive_steps(torch, trainer, state, dbatch, steps=MIND_STEPS)
    train_counts = (kernels.capsule_routing_fused.launches, kernels.capsule_routing_bwd_fused.launches)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 2**30

    def step():
        nonlocal state, metric_state
        state, metric_state, _ = trainer.train_step(state, dbatch, metric_state)

    busy_ms, top_ops = profile_steps(torch, step)
    kernels.reset_launch_counts()
    report = trainer.evaluate(state, [mind_batch(info, 1024, seed=20 + i) for i in range(2)])
    torch.cuda.synchronize()
    eval_counts = (kernels.capsule_routing_fused.launches, kernels.capsule_routing_bwd_fused.launches)
    step_ms = statistics.median(times[5:])
    result = dict(
        card=card, model="mind", batch=TRAIN_BATCH, steps=MIND_STEPS, step_p50_ms=step_ms,
        step_ms_min=min(times[5:]), step_ms_max=max(times[5:]), examples_per_s=TRAIN_BATCH / (step_ms / 1e3),
        first_step_ms=times[0], device_busy_ms=busy_ms, device_idle_share=1.0 - busy_ms / step_ms,
        top_ops_ms=top_ops, peak_mem_gb=peak_gb, losses=losses,
        train_accuracy=float(trainer.metrics.result(metric_state)["accuracy"]),
        train_launches=train_counts, eval_launches=eval_counts, eval=report,
    )
    print("mind training:", json.dumps(result), flush=True)
    check(all(np.isfinite(losses)), f"mind: non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"mind: the loss did not fall in {MIND_STEPS} steps: {losses}")
    check(train_counts == (0, 0), f"mind train steps launched (#7, #8) {train_counts}")
    check(eval_counts == (2, 0), f"mind evaluate on 2 batches launched (#7, #8) {eval_counts}")
    del trainer, state, dbatch, metric_state

    ab = routing_pair_ab(torch, kernels, card)

    # the entry points end to end (fp32: the export drops the compute dtype)
    ckpt_dir, export_dir = os.path.join(workdir, "mind_ckpt"), os.path.join(workdir, "mind_trained")
    trainer = Trainer(mind_train_config("float32", epochs=2, checkpoint_dir=ckpt_dir, max_to_keep=2), info)
    train = [mind_batch(info, 1024, seed=30 + i) for i in range(4)]
    evals = [mind_batch(info, 1024, seed=40)]
    state, run_report = trainer.run(lambda: iter(train), lambda: iter(evals))
    trainer.save(state)
    restored = trainer.restore(trainer.init_state(seed=123))
    want_sd = state.model.state_dict()
    same = restored.step == state.step and all(
        torch.equal(v, want_sd[k]) for k, v in restored.model.state_dict().items())
    trainer.export(state, export_dir)
    rows = {k: v[:512] for k, v in evals[0].items()}
    served = load_servable(export_dir, info, device="cuda").predict(rows)
    inferred = trainer.infer(state, rows)
    serve_err = max(float(np.abs(served[k].cpu().numpy() - inferred[k]).max())
                    for k in ("user_embedding", "interest_capsules", "output"))
    print("mind train entry points:", json.dumps(dict(
        steps=state.step, eval=run_report["best_eval"], restored_equal=same, served_vs_infer=serve_err,
    )), flush=True)
    check(state.step == 2 * len(train) and same, "mind run/restore did not give back the saved state")
    check(serve_err <= 1e-6, f"mind served prediction vs Trainer.infer: {serve_err}")
    return dict(mind_evaluate=eval_counts[0], mind_train_steps=train_counts[0]), ab


def run_retrieval_family(torch, kernels, card):
    """ComiRec (sa, dr) and SINE over the MIND schema: one bf16 predict at
    B=8192 and 5 bf16 train steps each (phase 9d). No kernel: they show the
    modules run on the card."""
    from tpurec_torch.serving.export import Servable
    from tpurec_torch.train.trainer import Trainer

    info = mind_info()
    batch = mind_batch(info, TRAIN_BATCH, seed=1)
    results = {}
    for label, (name, params) in RETRIEVAL_MODELS.items():
        trainer = Trainer(mind_train_config("bfloat16", name, params), info)
        state = trainer.init_state(batch)
        kernels.reset_launch_counts()
        with torch.inference_mode():
            out = Servable(state.model).predict(batch)
        finite = all(bool(torch.isfinite(v.float()).all()) for v in out.values())
        state, _, losses, times = drive_steps(torch, trainer, state, trainer.device_batch(batch), steps=5)
        launches = (kernels.capsule_routing_fused.launches, kernels.capsule_routing_bwd_fused.launches)
        results[label] = dict(user_embedding=list(out["user_embedding"].shape), finite=finite,
                              losses=losses, step_ms=statistics.median(times[1:]), launches=launches)
        check(finite and out["user_embedding"].shape == (TRAIN_BATCH, 64), f"{label} predict: {results[label]}")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"{label} training: {losses}")
        check(launches == (0, 0), f"{label} launched (#7, #8) {launches}")
        del trainer, state
    print("multi-interest family:", json.dumps(dict(card=card, batch=TRAIN_BATCH, models=results)), flush=True)
    return results


def run_mind(torch, kernels, workdir, card):
    """Phase 9b-9d; returns #7's launches by path and the kernel-pair A/B."""
    launches = run_mind_serving(torch, kernels, workdir, card)
    train_launches, ab = run_mind_training(torch, kernels, workdir, card)
    launches.update(train_launches)
    run_retrieval_family(torch, kernels, card)
    return launches, ab


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
    if sys.argv[1:] == ["--scatter"]:
        # kernel #9 alone: its D sweep and DIN's stream, with the split
        from tpurec_torch.ops import embedding_update as eu

        scatter_sweep(torch, eu, torch.Generator(device="cuda").manual_seed(7))
        return 0
    if sys.argv[1:] == ["--capsule"]:
        # kernel #7 (and #8, same source) alone: phase 9a's checks, with the
        # split, the launch floor and the serving shapes
        paths = kernels.build(["capsule_routing"])
        print(open(f"{paths['capsule_routing']}.log").read(), flush=True)
        check_capsule_kernels(torch, kernels, detail=True)
        return 0
    if sys.argv[1:2] == ["--capsule-bwd-ab"] and len(sys.argv) == 3:
        # kernel #8 of another checkout (a git archive of the parent commit)
        # against this one's, alternating, and the kernel pair's A/B of each
        kernels.build(["capsule_routing"])
        capsule_bwd_ab(torch, kernels, sys.argv[2], smi)
        return 0
    if sys.argv[1:] == ["--cin"]:
        # kernel #3 alone: phase 8a's CIN checks, with the launch floor and
        # the block's resources
        paths = kernels.build(["cin"])
        print(open(f"{paths['cin']}.log").read(), flush=True)
        _, record = check_cin(torch, kernels, detail=True)
        print("kernel check:", json.dumps(record), flush=True)
        return 0
    if sys.argv[1:] == ["--din"]:
        # kernel #4 alone: phase 3's DIN checks, with the launch floor and the
        # launch's blocks and shared memory
        paths = kernels.build(["din_attention"])
        print(open(f"{paths['din_attention']}.log").read(), flush=True)
        check_din_forward(torch, kernels, detail=True)
        return 0
    if sys.argv[1:2] == ["--din-ab"] and len(sys.argv) == 3:
        # kernel #4 of another checkout (a git archive of the parent commit)
        # against this one's, alternating
        kernels.build(["din_attention"])
        din_ab(torch, kernels, sys.argv[2])
        return 0
    if sys.argv[1:] in (["--fm"], ["--cross"]):
        # kernel #1 (phase 3's FM checks) or #2 (phase 8a's cross checks)
        # alone, with the launch floor, blocks, warps, registers and spills
        name = "fm_second_order" if sys.argv[1] == "--fm" else "cross_network"
        kernels.build([name])
        if name == "fm_second_order":
            check_fm(torch, kernels, detail=True)
        else:
            print("kernel check:", json.dumps(check_cross(torch, kernels, detail=True)[1]), flush=True)
        return 0
    if sys.argv[1:2] in (["--fm-ab"], ["--cross-ab"]) and len(sys.argv) == 3:
        # kernel #1 or #2 of another checkout (a git archive of the parent
        # commit, whose kernels are Triton) against this one's, alternating
        name = "fm_second_order" if sys.argv[1] == "--fm-ab" else "cross_network"
        kernels.build([name])
        (fm_ab if name == "fm_second_order" else cross_ab)(torch, kernels, sys.argv[2])
        return 0
    if sys.argv[1:] == ["--din-bwd"]:
        # kernel #5 alone: phase 6's kernel checks, with the split and B=1024
        paths = kernels.build(["din_attention_bwd"])
        print(open(f"{paths['din_attention_bwd']}.log").read(), flush=True)
        check_din_backward(torch, kernels)
        return 0

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
        dcn_records = timed("8a_dcn_kernels", check_dcn_kernels, torch, kernels)
        dcn_launches = timed("8bc_dcn_family", run_dcn_family, torch, kernels, workdir, smi)
        capsule_records = timed("9a_capsule_kernels", check_capsule_kernels, torch, kernels)
        mind_launches, _ = timed("9bcd_mind", run_mind, torch, kernels, workdir, smi)
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
                                        launches_by_path=scatter_paths,
                                        other_shapes=dict(fm_w=embedding["fm_w"], din=embedding["din"]))
    # #10 is on no training path, in either package: checked and timed alone
    records["gather_rows_sorted"] = dict(embedding["gather"], launches=0, launches_by_path={})
    for name, rec in dcn_records.items():
        records[name] = dict(rec, launches=sum(dcn_launches[name].values()),
                             launches_by_path=dcn_launches[name])
    records["capsule_routing"] = dict(capsule_records["capsule_routing"],
                                      launches=sum(mind_launches.values()), launches_by_path=mind_launches)
    # #8 is the backward of #7's autograd.Function; MIND trains on the
    # module's math, as in the JAX package, so no main path launches it:
    # checked, timed and measured in the A/B alone
    records["capsule_routing_bwd"] = dict(capsule_records["capsule_routing_bwd"], launches=0,
                                          launches_by_path=dict(mind_train_steps=0))

    print(json.dumps({"card": smi, "kernels": list(records.values())}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
