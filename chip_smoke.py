#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --scatter   # kernel #9's D sweep alone (phase 7a's)
    python3 chip_smoke.py --din       # kernel #4's checks alone (phase 3's)
    python3 chip_smoke.py --din-ab DIR  # #4 of the checkout DIR against this one's
    python3 chip_smoke.py --din-bwd   # kernel #5's checks alone (phase 6's)
    python3 chip_smoke.py --din-bwd-ab DIR  # #5 of the checkout DIR against this one's
    python3 chip_smoke.py --capsule   # kernels #7/#8's checks alone (phase 9a's)
    python3 chip_smoke.py --capsule-bwd-ab DIR  # #8 of the checkout DIR against this one's
    python3 chip_smoke.py --cin       # kernel #3's checks alone (phase 8a's)
    python3 chip_smoke.py --fm        # kernel #1's checks alone (phase 3's)
    python3 chip_smoke.py --fm-ab DIR  # #1 of the checkout DIR against this one's
    python3 chip_smoke.py --cross     # kernel #2's checks alone (phase 8a's)
    python3 chip_smoke.py --cross-ab DIR  # #2 of the checkout DIR against this one's
    python3 chip_smoke.py --fm-family # phase 10 alone (the FM family and MatrixCF)
    python3 chip_smoke.py --dcn-rest  # phase 11 alone (the rest of the DCN family)
    python3 chip_smoke.py --cli       # phase 12 alone (raw files to serving through the CLI)
    python3 chip_smoke.py --multitask # phase 13 alone (the multi-task and personalization families)
    python3 chip_smoke.py --sequence  # phase 14 alone (DIEN, DSIN, SDM and the FiBiNET++ family)
    python3 chip_smoke.py --long-seq  # phase 15 alone (SIM, CAN, ETA, DMR, DMT, FinalMLP, SDIM)
    python3 chip_smoke.py --mesh      # phase 16 alone (the mesh: ranks over NCCL and gloo)
    python3 chip_smoke.py --blocks    # phase 17 alone (the building blocks' options)
    python3 chip_smoke.py --adam      # the optimizer chain's kernel on the benchmark's lists

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
   the check has to be able to fail; predict p50 of 10 after 2 warm-ups;
5. the HTTP server over the FM benchmark schema (26 fields × 80,000 ids =
   2.08M rows, padded to 2,080,128, D=32): a ``dssm_double`` retrieval model
   (user f0-f12, item f13-f25) and a ``deepfm`` ranker, random seeded
   weights; seeded profiles of 5,000 users and 2,500 items; ``OfflineIndexer``
   into a ``DictKVStore``; ``serve_background``; retrieve/kv, retrieve/online
   top-20, rank over 20 and 200 candidates, rank from_retrieval, 200
   sequential requests each (p95 has ten samples beyond it), each checked
   for shape and score order, with its p50 and p95 latency. The FM kernel
   must have run. The warm index build and the retrieve/online path are
   then timed in turns with ``top_k`` and with ``torch.topk``
   (``topk_turns``).

6. DIN training at full width (``bench.py:38-64`` with ``bench.py:230-266``'s
   dense trainer: the phase 4 schema and widths, bf16 dense compute, fp32
   params, ``loss='bce'``, Adam lr 1e-3 eps 1e-7, a B=8192 batch made as
   ``bench.py:75-87`` with seed 1), through ``Trainer(cfg, info)`` →
   ``init_state`` → ``device_batch`` → ``train_step``:
   - the DIN backward kernel against ``din_attention_bwd_plain`` in fp64
     rounded to fp32 (``bwd_reference``; the fp32 plain version's readings
     are printed as ``plain_fp32``) at the
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
     first, each kernel launched once a step; then 10 steps, each copying
     its batch from an empty launch queue, through the port's spans
     (``tpurec_torch/core/trace.py``): each span's median host ms and no
     host sync (the counter must see a ``.item()``'s);
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
     #9 twice a fused step, no host sync, peak memory); one fp32 fused
     step against one fp32 dense step (``ENGINE_*``), which a #9 that
     drops carried runs must fail; three fp32 steps card against CPU (``fused_adam``,
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
     warm-ups;
   - 8c: ``DCN_STEPS`` bf16 ``Trainer.train_step``s on a fixed seed-1
     batch: losses finite and falling, no launch of #2/#3/#6 (training
     takes the plain math, as the JAX package); ``evaluate`` on two batches
     launches the model's kernel once a batch; peak memory.

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

10. the FM family and MatrixCF, random seeded weights, B=8192, bf16 dense
    compute, fp32 params, bce, Adam lr 1e-3 eps 1e-7: over the phase 5/7 FM
    schema ``dssm_single`` (D=32, MLP (64, 32)), ``fwfm`` (D=32), ``pnn``
    inner and outer 'mat' (D=32, P=325, kernel 325×32×32), ``ffm`` and
    ``onn`` (k=4, libffm's setting on Criteo: a 2,080,128 × 26 × 4 fp32
    field-aware table, 865 MB) and ``wide_and_deep`` (D=32, on a copy of
    the schema with 13 continuous columns, Criteo's I1-I13, drawn from the
    seed); over MovieLens-1M's id space (6,040 users, 3,706 items)
    ``matrixcf`` (D=16) and ``ncf`` (mf/mlp 16, MLP (64, 32, 16)):
    - 10a: #9 on FFM's stream (N=212,992 over 2,080,128 rows) at the
      field-aware width F·k = 104 and at 4 and 1: phase 7a's readings,
      broken versions, same bits, device time, bound, plain and
      ``index_add_`` times and per-launch split;
    - 10b: each model ``export_params`` → ``load_servable`` → ``predict``:
      finite probabilities, the first 256 rows' logit (MatrixCF's output)
      against the port on the CPU with the same weights
      (``FM_FAMILY_RTOL`` of the largest |value|), p50 of 10 after 2
      warm-ups; ``ffm`` also ``Servable.rank`` at
      the rank buckets 8 to 256 against ``predict``'s rows, with p50s;
    - 10c: each model 10 bf16 dense steps on the seed-1 batch (losses
      finite and falling, peak memory); ``ffm`` and ``onn`` also 10
      ``fused_adam`` steps (#9 once per table a step) and 10
      ``rowwise_adam`` steps (no #9); ``ffm``'s
      fp32 fused step against its dense step (``ENGINE_*``, which a #9
      that drops carried runs must fail) and 3 fp32 fused steps card
      against CPU on 256 rows (``CPU_LOSS_TOL``); ``--fm-family`` runs this
      phase alone.

11. the rest of the DCN family, random seeded weights, B=8192, bf16 dense
    compute, fp32 params, bce, Adam lr 1e-3 eps 1e-7, over phase 10's
    ``wide_and_deep`` schema (26 fields of 80,000 ids, 2,080,128 rows, 13
    continuous columns): ``nfm``, ``fnn``, ``deep_crossing`` (3 blocks,
    residual 64), ``ccpm`` ((4, 4) filters, widths (6, 5)), ``fgcnn``
    (the registry's defaults) and ``afm`` (attention 16) at D=32, MLP
    (64, 32) where the model has one; ``autoint`` at its paper's Criteo
    setting (D=16, 3 layers of 2 heads of 32; Song et al., CIKM 2019):
    - 11a: each model ``export_params`` → ``load_servable`` → ``predict``
      as phase 10b (the first 256 rows against the CPU port); ``autoint``
      also ``Servable.rank`` at the rank buckets 8 to 256;
    - 11b: each model 10 bf16 dense steps as phase 10c; ``nfm`` also 10
      ``fused_adam`` steps (#9 once per table a step, D=32 and D=1);
    - 11c: #9's launches in one NFM fused step recorded and held to the
      plain version on their own stream and gradients (phase 7a's readings,
      broken versions, same bits, timings), then NFM's fp32 fused step
      against its dense step (``fused_vs_dense``); ``--dcn-rest`` runs
      this phase alone.

12. from raw files to serving through ``tpurec_torch.cli.main`` with
    ``TPUREC_PLATFORM`` unset (every model step on the card), in a
    temporary directory; ``--cli`` runs this phase alone:
    - the native recordio codec built (``g++``) and in use; ``synth`` and
      ``datagen`` of the tabular family (1M events), each stage's seconds;
    - ``train`` (B=8192, bf16, D=32, the registry's widths, one epoch,
      with a workdir) of deepfm on the dense and the fused engine (#9 once
      per table a step, so twice; #1 once per ``evaluate`` batch) and
      dssm_double (no kernel), each step counted, and the eval AUC above
      0.6, deepfm's dense and fused eval loss and AUC within
      ``CLI_ENGINE_TOL``; #9 on the fused run's first batch
      (``check_step_scatter``: 5 x 8192 ids, D=1 then D=32), held to the
      plain version with its broken versions and timed; ``index --topk
      20`` of the dssm_double export on the card and on the CPU: the same
      slates, scores within 6-decimal rounding, tied items (the same three
      tags) in ``lax.top_k``'s order; ``top_k`` against ``torch.topk`` in
      the index's top-k over 5,000 x 20,000 (in turns) and alone at each
      caller's shape (phases 5 and 9d time the index build, the online
      path and SINE's step in turns with each);
    - ``serve`` of the deepfm export (retrieve/kv, rank 20, rank 200) and
      of the dssm_double export (retrieve/online, rank from_retrieval;
      a ranker has no tower), both over the index on ``--port 0``, 200
      requests a path after 5 warm-ups, p50/p95; #1 once per deepfm rank
      request; the served ranker on the test shard's first 256 rows
      against ``load_servable(..., device="cpu")`` (``FM_FAMILY_RTOL``);
      #1 held to its plain version at the tabular F=5 (phase 3's checks);
    - the sequence family (100k events, ``--max-seq-length 64``) and DIN
      trained two epochs (two aligned series: #4 and #5 at key width 64):
      #5 once a step, #4 once a step and once an eval batch, the eval loss
      falling; #4 and #5 held to their plain versions at (8192, 64, 64, 36)
      with phase 3's and phase 6's readings, broken versions and times.
    Phase 12's checks sit under ``other_shapes`` of each kernel's entry.

13. the multi-task and personalization families, random seeded weights,
    B=8192, D=32, bf16 dense compute, fp32 params, Adam lr 1e-3 eps 1e-7,
    at the registry's widths (4 experts of (64, 32), towers (32,), PLE and
    FDN 2 levels of 2 experts a task), over phase 10's ``wide_and_deep``
    schema (2,080,128 rows, 13 continuous columns) with multi-task labels
    drawn from the seed (``multitask_batch``); ``--multitask`` runs this
    phase alone:
    - 13a: mmoe, esmm, ple, poso_mmoe, pepnet (``multi_task``), esm2,
      escm2, fdn (``model_loss``) and poso_mlp, poso_mha (``bce``) 10
      dense steps each as phase 10c (no launch of #9), then
      ``Trainer.infer`` at B=8192 (p50 of 20; finite probabilities) and
      ``evaluate`` over two batches;
    - 13b: mmoe and poso_mmoe 10 ``fused_adam`` steps (#9 once a step: one
      table; POSO's second lookup of the gate field adds no ids), #9 on
      each model's own stream (``check_step_scatter``), the fp32 fused step
      against the dense one (``fused_vs_dense``);
    - 13c: ``cli synth``/``datagen --family impression`` (200,000 events),
      ``cli train`` of mmoe and escm2 (lr 1e-2, two epochs) with export:
      both AUCs above 0.5, their gap to ``oracle.npz``'s ceilings and the
      stage seconds recorded.

14. the recurrent sequence models and the FiBiNET++ family, random seeded
    weights, B=8192, bf16 dense compute, fp32 params, Adam lr 1e-3 eps
    1e-7; ``--sequence`` runs this phase alone:
    - 14a: DIEN ('augru') and DSIN (4 sessions of 16 steps: the registry's
      5 does not divide L=64) at phase 6's DIN configuration (21,504 rows,
      L=64, D=32, attention H=36, MLP (200, 80)) on phase 6's batch plus a
      seeded ``neg_history`` (``sequence_batch``): each served as phase 10b
      (#4 once a predict for DIEN, twice for DSIN) and trained
      ``FM_FAMILY_STEPS`` dense steps as phase 10c (#4 and #5 once per
      attention a step), then ``evaluate`` over two batches (#4 once per
      attention a batch);
    - 14b: DIEN in the fused engine (#9 once a step over a stream of B × 131
      ids: the profile, the query, the history and ``neg_history``), #9 on
      that stream (``check_step_scatter``), DIEN's fp32 fused step against
      its dense step (``fused_vs_dense``), and #4 and #5 held to their plain
      versions on DIEN's and DSIN's own inputs and cotangents recorded in
      one bf16 step (``check_step_attention``: phase 3's and 6's readings,
      broken versions and same bits; DIEN's #5 gets gp = 0, DSIN's runs at
      L = 4 sessions, and DSIN's also with a session mask with holes), each
      timed beside its plain version and its bound;
    - 14c: SDM (``short_len`` 10, 2 LSTM layers, 2 heads) over phase 9's
      MIND schema and recipe (``normalize_logits``): ``FM_FAMILY_STEPS``
      bf16 dense steps, ``Servable.predict`` p50 and the offline index over
      5,000 users × 20,000 items; no kernel runs;
    - 14d: fibinet_pp, masknet (serial, parallel) and contextnet
      (pointwise, singlelayer) over phase 10's ``wide_and_deep`` schema at
      the registry's widths, D=32: served as phase 10b and trained as phase
      10c with an ``evaluate`` pass; no kernel runs;
    - 14e: ``cli synth``/``datagen --family sequence`` (100,000 events,
      L=64) and ``cli train`` of DIEN, two epochs with export: #4 and #5 at
      key width 64, the eval AUC above 0.5.
    Phase 14's checks sit under ``other_shapes`` of #4, #5 and #9, its
    launches under their ``launches_by_path``.

15. the long-sequence and DMR families at the registry's widths, random
    seeded weights, B=8192, D=32, bf16 dense compute, fp32 params, Adam lr
    1e-3 eps 1e-7; ``--long-seq`` runs this phase alone:
    - 15a: sim, can, eta (with its LSH self-attention), dmr and sdim over
      phase 6's DIN schema (21,504 rows, L=64, ``bench_batch``'s lengths in
      [L/4, L]) and dmt over phase 9's two aligned series: each served as
      phase 10b, its 256 rows against the CPU through
      ``long_seq_compare`` (the SimHash bits recorded on both devices: a
      flip only within ``SIGN_MARGIN`` of 0, at most ``MAX_FLIPPED_ROWS``
      rows left out; ``topk_indices`` equal, every float output within
      ``FM_FAMILY_RTOL`` of its largest |value|), then ``FM_FAMILY_STEPS``
      dense steps (``gsu_esu``, ``bce``, ``multi_task``) with an
      ``evaluate`` pass; finalmlp the same over phase 10's
      ``wide_and_deep`` schema; no kernel runs;
    - 15b: DIEN 3 steps, exported, grafted under sim's and can's ``trunk``
      (``init_subtree_from_export``) and frozen: #4 once a step, #5 never,
      the trunk unchanged; both served with the trunk (#4 once a predict)
      and trained unfrozen (#4 and #5 once a step, #4 once an eval batch),
      #4 and #5 held on their own recorded inputs and cotangents
      (``check_step_attention``, gp = 0);
    - 15c: can, sim with its trunk and eta in the fused engine (#9 once per
      table a step: CAN's induction table at width 4·D + 24 = 152, SIM's
      nested ``trunk/emb``), #9 on those two streams
      (``check_step_scatter``) and their fp32 fused steps against their
      dense ones (``fused_vs_dense``);
    - 15d: sim, eta (no LSH self-attention: its mask would be 32 GB) and
      sdim over a 1,024-step history: served against the CPU and
      trained as 15a, with peak memory;
    - 15e: a ``SketchStore`` with SDIM's own projections filled with 256
      users' history embeddings from the card: its ``query`` against the
      fp32 model's ``long_term_interest`` (``SKETCH_ATOL``).
    Phase 15's checks sit under ``other_shapes`` of #4, #5 and #9, its
    launches under their ``launches_by_path``.
16. the mesh (``core/mesh.py``, ``core/distributed.py``, the row-sharded
    lookup, the tensor-parallel weights, the lazy-sparse and sharded fused
    steps, ``ops/attention_cp.py``, ``dryrun.py``), with ranks
    that are processes of this script (``--mesh-rank``), started with
    ``spawn`` semantics (a fresh interpreter each) after #4, #5 and #9 are
    built, joined under ``MESH_TIMEOUT``: a rank that fails or hangs fails
    the phase. One card holds every rank, so nothing here measures scaling:
    - 16a: a world of one over NCCL, mesh (1, 1): DIN dense at phase 6's
      width (B=8192, L=64, D=32, bf16) for ``MESH_STEPS`` steps, its losses
      and parameters against the same steps without a world in this
      process; then ``dryrun_multichip(1)``
      (DIN at D=8 in the dense, ``rowwise_adam`` and ``fused_adam``
      engines: #4 and #5 once a step, #9 once in the fused one);
    - 16b: a world of four ranks on ``cuda:0`` over gloo (NCCL allows one
      rank of a communicator on a device; gloo reduces CUDA tensors through
      the host), mesh (2, 2): DIN dense at global B=8192 (4096 a data
      rank; its ``mlp`` (200, 80) tensor parallel: ``dense_0`` holds 100
      output columns a rank, ``dense_1`` 100 input rows),
      ``MESH_FP32_STEPS`` fp32 steps against this process's one-device run
      of the same global batches, then ``MESH_STEPS`` bf16
      steps (#4 and #5 once a step on each rank); #4 and #5 on each rank's
      own recorded inputs against their plain versions
      (``check_step_attention``'s cases, #5 in fp64); FM over the 2.08M-row
      table in the fused engine (each rank ``pad_vocab(V, 2) / 2`` rows):
      ``MESH_STEPS`` bf16 steps (#9 twice a step on each rank), #9 on each
      rank's own stream (ids outside its rows dropped) held by
      ``check_step_scatter`` with its broken versions, and one fp32 fused
      step against one fp32 dense step on the mesh; FM in ``rowwise_adam``
      (each rank half the rows of each table and of its row-wise state):
      ``MESH_FP32_STEPS`` fp32 steps against this process's one-device run
      (losses, AUC, tables, state); ``dryrun_multichip(4)``;
      ``din_attention_cp`` at
      ``CP_SHAPE`` over model = 4 (a (1, 4) mesh of the same world), its
      pooled, its scores and every gradient against the one-device plain
      version in fp64 (``din_reading``, ``bwd_reading``), which a pool
      without the sum over the axis must miss; then mesh (4, 1) of the
      same world (``mesh_data41``): DIEN without ``neg_history`` (its
      auxiliary negatives rolled across ranks), DMR (its auxiliary softmax
      against the global batch) and MIND with ``MESH_SAMPLED`` sampled
      negatives a row, ``MESH_FP32_STEPS`` fp32 steps each at global
      B=8192 (2048 a rank) against this process's one-device run (losses,
      logged auxiliary terms, metrics, parameters); DIEN bf16 for
      ``MESH_STEPS`` dense steps (#4 and #5 once a step on each rank), #4
      and #5 on each rank's own inputs (``check_step_attention``, #5 in
      fp64), ``MESH_FUSED_STEPS`` fused steps (#9 once a step) and #9 on
      each rank's stream (``check_step_scatter``); last, back on (2, 2), a
      tensor-parallel MLP over DIN's tower (200, 80) with LayerNorm, gelu,
      a softmax output and dropout 0.1 (``MESH_BLOCKS``): one fp32
      training forward and backward over each data rank's 4096 rows
      against this process's one-device run at global B=8192, the dropout
      the one-device draw (``BLOCKS_FP32_TOL``).
    Phase 16's launches sit under ``launches_by_path`` of #4, #5 and #9.
17. the building blocks' options, which no registry model sets and which
    run in plain PyTorch in both packages (no kernel, so nothing here adds
    to a launch count); ``--blocks`` runs this phase alone. Each case is
    built on the CPU from a seed, copied to the card, run there over
    B=8192 rows with a random cotangent (its dropout drawn from a CUDA
    generator, each mask recorded) and on the CPU over the first 256 rows
    (a training BatchNorm over all 8192) with the same masks; the output,
    the input gradient and the running statistics on those rows are held
    at ``BLOCKS_FP32_TOL`` (fp32) or ``BLOCKS_BF16_RTOL`` of the largest
    value (bf16), and a mask off by one row, and (fp32) torch's exact gelu
    in place of flax's tanh form, must read above the limit:
    - the MLP over DIN's tower (phase 6's input width → 200 → 80), fp32
      and bf16: sigmoid, tanh, gelu, a softmax output, BatchNorm in
      training (the running statistics too) and in eval mode (redrawn
      running statistics), LayerNorm, dropout 0.1;
    - ``MultiHeadAttention`` at AutoInt's Criteo setting (D=16, 2 heads of
      32) over phase 11's 39 ``wide_and_deep`` fields, ``out_dim=32`` (no
      residual), no LayerNorm, dropout 0.1, fp32 and bf16;
    - dropout's draw at (8192, 200): the keep count within 6σ of the
      binomial's mean, the same generator state the same mask,
      ``apply_dropout_mask`` and its gradient equal to the CPU's;
    - each case's device ms of the forward and of the forward and
      backward, the draw's and the masking's.
18. the optimizer chain's kernel (``csrc/adam_update.cu``, no TPU
    counterpart) on the benchmark's DeepFM and DIN lists
    (``portbench/configs/``): one step against its foreach twin
    ``kernels.adam_update_plain`` (every element within 4 ulps), one launch a
    step, device ms beside the twin's, PyTorch's fused Adam's (timed, never
    called by the port) and the 28 bytes a parameter bound, and each one's
    host time a call (``check_adam``). The kernel's record reads its
    launches in every phase's training steps and in the mesh's ranks
    (``adam_launches``); each phase that trains on the card must launch it.

TF32 is off for the whole run (``allow_tf32 = False`` for matmul and
cuDNN), so every fp32 comparison is fp32 on both sides.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
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


DIN_SHAPE = (8192, 64, 32, 36)  # B, L, D, H of phase 4's servable and phase 6's step


def check_din_forward(torch, kernels, detail=False, shape=DIN_SHAPE):
    """Kernel #4 against its plain version (phase 3): the serving shape with
    and without PReLU slopes, ragged shapes, a mask with holes, both sides of
    the tensor-core kernel's H limit; a forward that ignores the mask, drops
    the slopes or takes lin in single TF32 must read above the limit; two
    calls the same bits; device time at B=8192, 4096, 1024 and 1, the bound
    and the plain version's time. ``detail`` (``--din``) adds the launch
    floor and the blocks, warps and shared memory of the launch. Another
    ``shape`` (phase 12's key width 64) takes the readings, the broken
    versions, the same bits and the times at that shape alone."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    lib = kernels._library("din_attention")
    b, l, d, h = shape
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
    serving = shape == DIN_SHAPE
    # ragged: B that is no multiple of the grid, L = 1 and 33, D = 8/16/64,
    # H = 7, H = 128 (the widest tensor-core build) and 129, 200 (the fp32
    # kernel)
    for other in ((1003, 64, 32, 36), (37, 1, 32, 36), (300, 33, 32, 36), (300, 64, 8, 36),
                  (300, 64, 16, 36), (300, 48, 64, 36), (257, 33, 16, 7), (300, 64, 32, 128),
                  (300, 64, 32, 129), (300, 64, 32, 200)) if serving else ():
        a = din_inputs(torch, gen, *other)
        readings["x".join(map(str, other))] = din_reading(
            kernels.din_attention_fused(*a), kernels.din_attention_plain(*a)
        )
    if serving:
        # a mask with holes (not a prefix), a row whose only live step is
        # the last, and an all-zero row
        a = din_inputs(torch, gen, 1003, 64, 32, 36)
        a[2] = holey_mask(torch, gen, a[2])
        readings["mask_with_holes"] = din_reading(kernels.din_attention_fused(*a), kernels.din_attention_plain(*a))
    print(f"din forward readings at {list(shape)} (error / limit):", json.dumps(readings), flush=True)
    for name, r in readings.items():
        worst = max(r.values())
        if name.startswith("broken"):
            check(worst > 1.0, f"the forward check cannot tell a {name} forward from a sound one")
        else:
            check(worst <= 1.0, f"din forward kernel vs plain at {name} {list(shape)}: {r}")
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
    for rows in (4096, 1024, 1) if serving else ():
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


def din_bwd_ab(torch, kernels, parent_dir):
    """Kernel #5 of the checkout at ``parent_dir`` against this one's on the
    same inputs in one process: parent, change, change, parent, each at
    phase 6's (8192, 64, 32, 36) and phase 12's key width 64, its readings
    against the plain version (printed; this tree's must pass) and its
    device time."""
    parent = parent_kernels(parent_dir)
    parent.build(["din_attention_bwd"])
    cases = {}
    for b, l, d, h in (DIN_SHAPE, (8192, 64, 64, 36)):
        # each case draws as ``check_din_backward`` does at its shape
        gen = torch.Generator(device="cuda").manual_seed(1)
        args = din_inputs(torch, gen, b, l, d, h)
        cot = [torch.randn(b, d, device="cuda", generator=gen), torch.randn(b, l, device="cuda", generator=gen)]
        cases[f"d{d}"] = (args + cot, kernels.din_attention_bwd_plain(*args, *cot))
    runs = []
    for label, mod in (("parent", parent), ("change", kernels), ("change", kernels), ("parent", parent)):
        run = dict(tree=label)
        for key, (a, want) in cases.items():
            reading = bwd_reading(mod.din_attention_bwd_fused(*a), want)
            run[key] = dict(reading=reading, ms=device_ms(torch, lambda: mod.din_attention_bwd_fused(*a)))
            if label == "change":
                check(max(reading.values()) <= 1.0, f"din backward at {key}: {reading}")
        runs.append(run)
        print("din backward a/b:", json.dumps(run), flush=True)
    return runs


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


def check_fm(torch, kernels, detail=False, shape=FM_SHAPE):
    """Kernel #1 against its plain version (phase 3) at deepfm's F=26, D=32
    (or ``shape``: phase 12's F=5 tabular fields)
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
    f, d = shape
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
    result = dict(
        card=card, batch=batch_size, din_launches=launches, predict_p50_ms=statistics.median(times[2:]),
        examples_per_s=batch_size / (statistics.median(times[2:]) / 1e3), mean_prob=float(out.mean()),
    )
    print("din servable:", json.dumps(result), flush=True)
    return launches, result


# ---------------------------------------------------------------------------
# phase 5: HTTP retrieve / rank over the FM schema
def http_latency(port, paths, uids):
    """POST /predict on ``port`` for each of ``paths`` ({name: (the request
    for a user id, a check of (user id, response))}): 5 warm-ups (the first
    launches, the allocator), then one request per user id, each checked;
    {name: p50 and p95 ms}."""
    url = f"http://127.0.0.1:{port}/predict"

    def post(payload):
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"}
        )
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())
        return body, (time.perf_counter() - t) * 1e3

    latency = {}
    for name, (make, verify) in paths.items():
        for uid in uids[:5]:
            post(make(uid))
        times = []
        for uid in uids:
            body, ms = post(make(uid))
            check("error" not in body, f"{name}: {body}")
            verify(uid, body)
            times.append(ms)
        latency[name] = dict(p50_ms=statistics.median(times), p95_ms=float(np.percentile(times, 95)))
    return latency


TOPK_TURNS = ("torch_topk", "top_k", "top_k", "torch_topk")


def topk_turns(torch, modules, fn) -> dict:
    """``fn()`` in turns with ``top_k`` (``lax.top_k``'s order) and with
    ``torch.topk`` (no order among ties, the call before the repair) bound
    as ``top_k`` in each of ``modules``: {"top_k": [...], "torch_topk":
    [...]} of its results in ``TOPK_TURNS`` order."""
    out = dict(top_k=[], torch_topk=[])
    for name in TOPK_TURNS:
        with contextlib.ExitStack() as stack:
            if name == "torch_topk":
                for m in modules:
                    stack.enter_context(mock.patch.object(m, "top_k", lambda x, k: torch.topk(x, k, dim=-1)))
            out[name].append(fn())
    return out


def run_http(torch, kernels, workdir, card, n_requests=200):
    from tpurec_torch.config import EmbeddingConfig, ModelConfig
    from tpurec_torch.data.schema import DataInfo
    from tpurec_torch.models import build_model
    from tpurec_torch.serving import DictKVStore, OfflineIndexer
    from tpurec_torch.serving import indexer, server as server_mod
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
    def build_index(kv, out="index"):
        return OfflineIndexer(
            towers.user_tower, towers.item_tower, user_profile, item_profile,
            info.user_features, info.item_features, batch_size=1024, device="cuda",
        ).run(os.path.join(workdir, out), kv_store=kv, topk=20)

    def build_seconds():
        t = time.perf_counter()
        build_index(DictKVStore(), "index_topk_turns")
        return time.perf_counter() - t

    kv = DictKVStore()
    t0 = time.perf_counter()
    index = build_index(kv)
    index_s = time.perf_counter() - t0
    check(len(kv) == 5000, f"KV store holds {len(kv)} users")
    # the warm build's seconds with the repaired top-k and with torch.topk
    index_turns = topk_turns(torch, (indexer,), build_seconds)
    service = RecommendService(
        user_tower=towers.user_tower, ranker=ranker.rank, user_profile=user_profile,
        item_profile=item_profile, user_feature_names=info.user_features,
        item_feature_names=info.item_features, kv_store=kv, item_ids=index["item_ids"],
        item_embeddings=index["item_embeddings"], device="cuda",
    )
    server = serve_background(service, port=0)
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
    try:
        latency = http_latency(server.server_address[1], paths, uids)
        torch.cuda.synchronize()
        launches = kernels.fm_second_order_fused.launches
        online = {"retrieve_online_top20": paths["retrieve_online_top20"]}
        online_turns = topk_turns(torch, (server_mod,), lambda: http_latency(
            server.server_address[1], online, uids)["retrieve_online_top20"])
    finally:
        server.shutdown()
        server.server_close()
    check(launches > 0, "the rank path did not launch the FM kernel")
    result = dict(card=card, fm_launches=launches, index_build_s=index_s, requests_per_path=n_requests,
                  latency=latency, top_k_against_torch_topk=dict(
                      turns=TOPK_TURNS, index_build_s=index_turns, retrieve_online_top20=online_turns))
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


def din_bwd_bound(args):
    """What this run's mask needs (ms, by, the bytes-only ms, live steps): a
    masked step has s = 0 and dlin = 0, so its dkeys row is 0 and it adds
    nothing to the sums. Bytes: q, mask, w1, b1, w2, alpha, gp read, keys
    and gs read at live steps, dq, all of dkeys, dw1, db1, dw2, dalpha
    written. Operations of the fold algorithm: per row the fold (2 D·H
    FMAs), dq and the running sums (4 D·H); per live step lin, dkeys and M
    (3 D·H) and gp·k (D), ~8 per column for the activation. The tensor
    cores lift the operations limit, so the bytes-only bound is returned
    beside it."""
    b, l, d = args[1].shape
    h = args[3].shape[1]
    live = int(args[2].sum())
    nbytes = 4 * (3 * b * d + live * d + b * l * d + b * l + live + 2 * (4 * d * h + 3 * h))
    ops = 2 * (3 * live * d * h + 6 * b * d * h + live * d) + 8 * live * h
    return (*bound(nbytes, ops), nbytes / HBM_BYTES_PER_S * 1e3, live)


def bwd_reference(kernels, *args):
    """The plain backward of ``args`` (the forward's inputs, then gp and gs)
    in fp64, rounded to fp32: the reference #5 is held to. At a live step
    whose pre-activation lies within fp32's rounding of PReLU's kink the
    fp32 plain version takes the other slope, where the kernel takes such
    lin in fp64."""
    return [w.float() for w in kernels.din_attention_bwd_plain(*[a.double() for a in args])]


def check_din_backward(torch, kernels, shape=DIN_SHAPE):
    """The DIN backward kernel against its plain version in fp64 rounded to
    fp32 (``bwd_reference``; phase 6). The fp32 plain version's readings
    against the same reference are printed under ``plain_fp32``, not
    checked. Another ``shape`` (phase 12's key width 64) takes the
    readings, the broken versions, the same bits and the times at that
    shape alone."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def case(b, l, d, h):
        args = din_inputs(torch, gen, b, l, d, h)
        cot = [torch.randn(b, d, device="cuda", generator=gen),
               torch.randn(b, l, device="cuda", generator=gen)]
        return args, cot

    b, l, d, h = shape
    serving = shape == DIN_SHAPE
    args, cot = case(b, l, d, h)
    relu = args[:6] + [torch.zeros_like(args[6])]
    no_mask = args[:2] + [torch.ones_like(args[2])] + args[3:]
    readings, plain_fp32, err = {}, {}, 0.0
    for name, a in (("prelu", args), ("relu", relu)):
        got = kernels.din_attention_bwd_fused(*a, *cot)
        want = bwd_reference(kernels, *a, *cot)
        readings[name] = bwd_reading(got, want)
        plain_fp32[name] = bwd_reading(kernels.din_attention_bwd_plain(*a, *cot), want)
        err = max(err, max(float((g - w).abs().max()) for g, w in zip(got, want)))
    # what a backward that ignores the mask or drops the slopes would read
    want = bwd_reference(kernels, *args, *cot)
    readings["broken_mask_ignored"] = bwd_reading(kernels.din_attention_bwd_plain(*no_mask, *cot), want)
    readings["broken_alpha_dropped"] = bwd_reading(kernels.din_attention_bwd_plain(*relu, *cot), want)
    # the kernel's unfolded products in single TF32 (3xTF32 is what holds)
    readings["broken_single_tf32"] = bwd_reading(
        kernels.din_attention_bwd_unfolded(*args, *cot, products="1xtf32"), want
    )
    # ragged: B that is no multiple of the grid, L = 1, D = 8/16/64, H that
    # is no multiple of 4
    for other in ((1003, 64, 32, 36), (37, 1, 32, 36), (300, 64, 8, 36), (300, 64, 16, 36),
                  (300, 48, 64, 36), (257, 33, 16, 7)) if serving else ():
        a, c = case(*other)
        key = "x".join(map(str, other))
        want = bwd_reference(kernels, *a, *c)
        readings[key] = bwd_reading(kernels.din_attention_bwd_fused(*a, *c), want)
        plain_fp32[key] = bwd_reading(kernels.din_attention_bwd_plain(*a, *c), want)
    if serving:
        # a mask with holes (not a prefix), a row whose only live step is
        # the last, and an all-zero row
        a, c = case(1003, 64, 32, 36)
        a[2] = (torch.rand(a[2].shape, device="cuda", generator=gen) < 0.5).float()
        a[2][1] = 0.0
        a[2][2] = 0.0
        a[2][2, -1] = 1.0
        want = bwd_reference(kernels, *a, *c)
        readings["mask_with_holes"] = bwd_reading(kernels.din_attention_bwd_fused(*a, *c), want)
        plain_fp32["mask_with_holes"] = bwd_reading(kernels.din_attention_bwd_plain(*a, *c), want)
    print(f"din backward readings at {list(shape)} (error / limit, against the fp64 plain version):",
          json.dumps(dict(readings, plain_fp32=plain_fp32)), flush=True)
    for name, r in readings.items():
        worst = max(r.values())
        if name.startswith("broken"):
            check(worst > 1.0, f"the backward check cannot tell a {name} backward from a sound one")
        else:
            check(worst <= 1.0, f"din backward kernel vs plain at {name} {list(shape)}: {r}")

    bound_ms, bound_by, bytes_ms, live = din_bwd_bound(args)
    again = kernels.din_attention_bwd_fused(*args, *cot)
    same = all(torch.equal(x, y) for x, y in zip(kernels.din_attention_bwd_fused(*args, *cot), again))
    small = [x[:1024] if x.dim() and x.shape[0] == b else x for x in args]
    small_cot = [x[:1024] for x in cot]
    rec = dict(
        name="din_attention_bwd", route="cuda", source="tpurec_torch/csrc/din_attention_bwd.cu",
        replaces="tpurec/ops/pallas/kernels.py:484", shape=[b, l, d, h], live_steps=live, max_abs_err=err,
        ms=device_ms(torch, lambda: kernels.din_attention_bwd_fused(*args, *cot)),
        plain_ms=device_ms(torch, lambda: kernels.din_attention_bwd_plain(*args, *cot)),
        bound_ms=bound_ms, bound_by=bound_by, bytes_bound_ms=bytes_ms,
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


def count_syncs(torch, fn) -> int:
    """The host-device synchronisations ``fn()`` makes, as the port's
    tracing counts them (``tpurec_torch/core/trace.py``: PyTorch's sync debug
    mode, a prototype that may miss some)."""
    from tpurec_torch.core import trace

    torch.cuda.synchronize()
    rec = trace.start()
    try:
        fn()
    finally:
        trace.stop()
    torch.cuda.synchronize()
    return sum(s.syncs for s in rec.spans) + rec.loose_syncs


def traced_steps(torch, trainer, state, metric_state, batch, steps=10):
    """``steps`` calls of ``device_batch`` and ``train_step`` with the port's
    spans on, each from an empty launch queue (a synchronise before and
    after): (state, metric state, each span's median host ms, the syncs
    counted in the spans)."""
    from tpurec_torch.core import trace

    torch.cuda.synchronize()
    rec = trace.start()
    try:
        for _ in range(steps):
            state, metric_state, _ = trainer.train_step(state, trainer.device_batch(batch), metric_state)
            torch.cuda.synchronize()
    finally:
        trace.stop()
    names = dict.fromkeys(s.name for s in rec.spans)
    host_ms = {n: statistics.median(sum(s.ms for s in rec.spans if s.name == n and s.step == k)
                                    for k in range(steps)) for n in names}
    return state, metric_state, host_ms, sum(s.syncs for s in rec.spans)


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

    # the main path: 30 bf16 steps on the fixed batch
    trainer = Trainer(din_train_config("bfloat16"), info)
    state = trainer.init_state(batch)
    dbatch = trainer.device_batch(batch)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    state, metric_state, losses = train_steps(trainer, state, dbatch)
    launches = (kernels.din_attention_fused.launches, kernels.din_attention_bwd_fused.launches)

    # ten more steps, each copying its batch, through the port's spans: the
    # host's ms in each, and no host sync inside a step
    state, metric_state, host_ms, syncs = traced_steps(torch, trainer, state, metric_state, batch)
    check(count_syncs(torch, lambda: torch.ones(1, device="cuda").item()),
          "the sync check does not see the sync of .item()")

    result = dict(
        card=card, batch=TRAIN_BATCH, steps=TRAIN_STEPS, host_span_ms=host_ms, host_syncs=syncs,
        din_launches=launches[0], din_bwd_launches=launches[1], loss_first=losses[0], loss_last=losses[-1],
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


def scatter_case(torch, eu, gen, plan, v, d, timing=True, grads=None):
    """Kernel #9 on one stream: its reading against the plain version, two
    calls the same bits and, with ``timing``, its device time beside
    ``index_add_``'s (torch.zeros + index_add_, the same function in one
    PyTorch call each), the bound and the per-launch split. The gradients
    are ``grads`` (a train step's own) or drawn from ``gen``. Returns
    (reading, grads, G)."""
    if grads is None:
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
        # a sharded step's stream holds ids outside the rank's rows, which
        # #9 drops: index_add_ takes the stream's ids in [0, v)
        keep = (plan.sids >= 0) & (plan.sids < v)
        ids_in, grads_in = plan.sids[keep], grads.reshape(plan.n, d)[keep]
        r["library_ms"] = device_ms(torch, lambda: torch.zeros(v, d, device="cuda").index_add_(
            0, ids_in, grads_in))
        r["split_ms"] = kernel_split(torch, lambda: eu.fused_scatter_add(v, d, plan, grads))
    return r, grads, got


def carry_readings(torch, eu, broken, plan, v, d, grads, r) -> None:
    """Add to ``r`` the stream's rows with a nonzero gradient that a run
    carries past a tile and a slice of the kernel at width ``d``, its
    repeated rows with a nonzero gradient (a row of zeros is the same
    whether it is summed or dropped: CAN's induction table gets gradient
    only at the query ids' positions), and the readings of the ``broken``
    versions (``broken_scatters``) on it."""
    if not plan.n:
        return
    s = plan.sids
    start = torch.searchsorted(s, s)
    pos = torch.arange(plan.n, device="cuda")
    # rows #9 sums: a nonzero gradient at an id in [0, v)
    live = (grads.reshape(plan.n, d) != 0).any(dim=-1) & (s >= 0) & (s < v)
    for unit, rows in (("tile", eu.scatter_tile_rows(d)), ("slice", eu.scatter_slice_rows(d))):
        r[f"{unit}_rows"] = rows
        r[f"{unit}_crossing_rows"] = int(((pos // rows != start // rows) & live).sum())
    r["repeated_rows"] = int(((s[1:] == s[:-1]) & live[1:]).sum())
    for bname, fn in broken.items():
        r[bname] = sum_reading(torch, eu, fn(v, d, plan, grads), plan, grads)


def scatter_record(torch, eu, plan, v, d, grads, got, r) -> dict:
    """#9's entry of the kernels line from a timed ``scatter_case``."""
    plain = lambda: eu.scatter_add_plain(v, plan.sids, grads)  # noqa: E731
    return dict(
        name="fused_scatter_add", route="cuda", source="tpurec_torch/csrc/embedding_update.cu",
        replaces="tpurec/ops/pallas/embedding_update.py:231", shape=[plan.n, v, d],
        max_abs_err=float((got - plain()).abs().max()), ms=r["ms"],
        plain_ms=device_ms(torch, plain), bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r["library_ms"], split_ms=r["split_ms"],
    )


def check_scatter_readings(readings, label="") -> None:
    """Print #9's readings and fail on any that misses: each case within its
    limit and the same bits twice; each broken version above it wherever
    the stream has what it breaks."""
    print(f"fused_scatter_add{label} readings (error / limit; limit = {SUM_ATOL} + {SUM_RTOL} · Σ|g| "
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
        carry_readings(torch, eu, broken, plan, v, d, grads, r)
        readings[name] = r
        if timing:
            rec = scatter_record(torch, eu, plan, v, d, grads, got, r)
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
    check_scatter_readings(readings)
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


def train_steps(trainer, state, dbatch, steps=TRAIN_STEPS):
    """``steps`` train steps on one batch with no sync between them: (state,
    metric state, losses)."""
    metric_state = trainer.metrics.init()
    losses = []
    for _ in range(steps):
        state, metric_state, logs = trainer.train_step(state, dbatch, metric_state)
        losses.append(logs["loss"])
    return state, metric_state, [float(x) for x in losses]


def engine_run(torch, kernels, eu, name, trainer, batch, card):
    """The main path of one engine: 30 steps on the fixed batch with the
    launch counts set to 0 before and read after, then the sync check.
    Returns (counts, result)."""
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state(batch)
    dbatch = trainer.device_batch(batch)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    state, metric_state, losses = train_steps(trainer, state, dbatch)
    counts = dict(din_attention=kernels.din_attention_fused.launches,
                  din_attention_bwd=kernels.din_attention_bwd_fused.launches,
                  fused_scatter_add=eu.fused_scatter_add.launches,
                  gather_rows_sorted=eu.gather_rows_sorted.launches)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 2**30

    def step():
        nonlocal state, metric_state
        state, metric_state, _ = trainer.train_step(state, dbatch, metric_state)

    syncs = count_syncs(torch, step)
    result = dict(
        card=card, engine=name, batch=TRAIN_BATCH, steps=TRAIN_STEPS, host_syncs=syncs, launches=counts,
        loss_first=losses[0], loss_last=losses[-1], peak_mem_gb=peak_gb,
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
        state, _, losses = train_steps(trainer, state, dbatch, steps=3)
        host[mode] = dict(
            tables={n: state.model.get_parameter(n).detach()[:-1].clone() for n in FM_TABLES},
            peak_mem_gb=(torch.cuda.max_memory_allocated() - base) / 2**30, losses=losses,
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
    result = dict(card=card, model=name, batch=TRAIN_BATCH, launches=counts, readings=readings,
                  logit_limit=scale, logit_max_abs=float(logit.abs().max()),
                  logit_std=float(logit.std()), mean_prob=float(out.mean()),
                  predict_p50_ms=p50, examples_per_s=TRAIN_BATCH / (p50 / 1e3))
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
    state, _, losses = train_steps(trainer, state, dbatch, steps=DCN_STEPS)
    train_counts = dcn_counts(kernels)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 2**30
    kernels.reset_launch_counts()
    report = trainer.evaluate(state, [bench_batch(info, 1024, 0, seed=20 + i) for i in range(2)])
    torch.cuda.synchronize()
    eval_counts = dcn_counts(kernels)
    result = dict(
        card=card, model=name, batch=TRAIN_BATCH, steps=DCN_STEPS, peak_mem_gb=peak_gb,
        loss_first=losses[0], loss_last=losses[-1],
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
    result = dict(card=card, batch=TRAIN_BATCH, launches=predict_launches, readings=readings,
                  live_steps=int(mask.sum()), capsule_max_abs=float(want.abs().max()),
                  predict_p50_ms=p50, examples_per_s=TRAIN_BATCH / (p50 / 1e3))
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

    def retrieve(**extra):
        return lambda uid: dict(user_id=uid, type="retrieve", **extra)

    paths = {
        "retrieve_kv": (retrieve(source="kv"),
                        lambda uid, r: check(descending(r["result"]), "retrieve/kv shape")),
        "retrieve_online_top20": (retrieve(topk=20), online_check),
        "retrieve_online_diverse": (retrieve(topk=20, diversity_weight=10.0), diverse_check),
    }
    uids = rng.choice(list(user_profile), size=MIND_REQUESTS, replace=False).tolist()
    kernels.reset_launch_counts()
    try:
        latency = http_latency(server.server_address[1], paths, uids)
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
    state, metric_state, losses = train_steps(trainer, state, dbatch, steps=MIND_STEPS)
    train_counts = (kernels.capsule_routing_fused.launches, kernels.capsule_routing_bwd_fused.launches)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 2**30
    kernels.reset_launch_counts()
    report = trainer.evaluate(state, [mind_batch(info, 1024, seed=20 + i) for i in range(2)])
    torch.cuda.synchronize()
    eval_counts = (kernels.capsule_routing_fused.launches, kernels.capsule_routing_bwd_fused.launches)
    result = dict(
        card=card, model="mind", batch=TRAIN_BATCH, steps=MIND_STEPS, peak_mem_gb=peak_gb, losses=losses,
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
        state, _, losses = train_steps(trainer, state, trainer.device_batch(batch), steps=5)
        launches = (kernels.capsule_routing_fused.launches, kernels.capsule_routing_bwd_fused.launches)
        results[label] = dict(user_embedding=list(out["user_embedding"].shape), finite=finite,
                              losses=losses, launches=launches)
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


# ---------------------------------------------------------------------------
# phase 10: the FM family and MatrixCF
# The bf16 servables' logit (MatrixCF's output: it has no logit) card
# against CPU on 256 rows, and ``Servable.rank`` against ``predict``'s rows,
# at 2^-5 of the largest |value| (bf16 roundings taken in another order, as
# DCN_LOGIT_RTOL).
FM_FAMILY_RTOL = 2.0**-5
FM_FAMILY_STEPS = 10
FM_FAMILY = {
    # case: (registry name, params, embedding dim, schema)
    "dssm_single": ("dssm_single", dict(hidden_dims=[64, 32]), 32, "fm"),
    "fwfm": ("fwfm", {}, 32, "fm"),
    "pnn_inner": ("pnn", dict(hidden_dims=[64, 32]), 32, "fm"),
    "pnn_outer": ("pnn", dict(hidden_dims=[64, 32], product_type="outer", kernel_type="mat"), 32, "fm"),
    # k = 4: libffm's setting on Criteo's fields (Juan et al., RecSys 2016)
    "ffm": ("ffm", {}, 4, "fm"),
    "onn": ("onn", dict(hidden_dims=[64, 32]), 4, "fm"),
    "wide_and_deep": ("wide_and_deep", dict(hidden_dims=[64, 32]), 32, "fm_continuous"),
    "matrixcf": ("matrixcf", {}, 16, "ml1m"),
    "ncf": ("ncf", dict(mf_dim=16, mlp_dim=16, hidden_dims=[64, 32, 16]), 16, "ml1m"),
}
# the field-aware models' tables, the (V, F, D) one first
FA_TABLES = {"ffm": ("v.embedding", "w.w.embedding"), "onn": ("fa.embedding", "emb.embedding")}
RANK_BUCKETS = (8, 16, 32, 64, 128, 256)
FM_FAMILY_SCATTER_D = {"ffm_v": 104, "ffm_d4": 4, "ffm_d1": 1}


def fm_family_info(schema):
    """``'fm'``: ``fm_info()``; ``'fm_continuous'``: the same with 13
    continuous columns (Criteo's I1-I13); ``'ml1m'``: MovieLens-1M's 6,040
    users and 3,706 items (NCF's data, He et al., WWW 2017)."""
    from tpurec_torch.data.schema import DataInfo

    if schema == "ml1m":
        return DataInfo.from_dims(["user_id", "item_id"], [6040, 3706])
    info = fm_info()
    if schema == "fm_continuous":
        info = dataclasses.replace(info, continuous_names=[f"i{k}" for k in range(1, 14)])
    return info


def fm_family_batch(info, batch_size, seed):
    """``bench_batch`` and each continuous column drawn from the seed as
    log(1 + x), x exponential (non-negative, as log-scaled counts are)."""
    batch = bench_batch(info, batch_size, 0, seed=seed)
    rng = np.random.default_rng(seed + 1000)
    for c in info.continuous_names:
        batch[c] = np.log1p(rng.exponential(size=batch_size)).astype(np.float32)
    return batch


def fm_family_config(case, mode="dense", dtype="bfloat16", **train):
    name, params, dim, _ = FM_FAMILY[case]
    return experiment_config(name, params, dim, mode, dtype, **train)


def experiment_config(name, params, dim, mode="dense", dtype="bfloat16", **train):
    """bce (unless ``train`` sets ``loss``), Adam lr 1e-3 eps 1e-7 at
    B=8192; ``mode`` 'dense', 'fused' (fused_adam) or 'sparse'
    (rowwise_adam)."""
    from tpurec_torch.config import (
        EmbeddingConfig, ExperimentConfig, ModelConfig, OptimizerConfig, TrainConfig,
    )

    emb_opt = dict(dense="adam", fused="fused_adam", sparse="rowwise_adam")[mode]
    train.setdefault("loss", "bce")
    return ExperimentConfig(
        model=ModelConfig(name=name, params=dict(params), embedding=EmbeddingConfig(dim=dim)),
        train=TrainConfig(
            batch_size=TRAIN_BATCH, log_every_steps=0, compute_dtype=dtype,
            sparse_embedding=mode != "dense",
            optimizer=OptimizerConfig(learning_rate=1e-3, eps=1e-7, embedding_optimizer=emb_opt),
            **train,
        ),
    )


def check_fm_family_scatter(torch, eu):
    """Kernel #9 on FFM's stream (the FM schema's B=8192 batch: N=212,992
    ids over 2,080,128 rows) at the field-aware table's width F·k = 104 and
    at 4 and 1 (phase 10a): the readings, broken versions and timings of
    phase 7a. Returns {case: record}."""
    from tpurec_torch.embedding.ops import pad_vocab

    gen = torch.Generator(device="cuda").manual_seed(10)
    broken = broken_scatters(torch, eu)
    info = fm_family_info("fm")
    v = pad_vocab(info.total_dims)
    plan = eu.make_scatter_plan(torch.as_tensor(
        flat_ids(info, fm_family_batch(info, TRAIN_BATCH, seed=1)), device="cuda"), v)
    readings, records = {}, {}
    for name, d in FM_FAMILY_SCATTER_D.items():
        r, grads, got = scatter_case(torch, eu, gen, plan, v, d)
        carry_readings(torch, eu, broken, plan, v, d, grads, r)
        readings[name] = r
        records[name] = scatter_record(torch, eu, plan, v, d, grads, got, r)
        print("kernel check:", json.dumps(records[name]), flush=True)
    check_scatter_readings(readings, " (FFM's stream)")
    check(readings["ffm_v"]["slice_crossing_rows"] > 0, "no run of FFM's stream crossed a slice at D=104")
    return records


def run_fm_family_servable(torch, workdir, card, case, seed):
    """export → load_servable → predict at B=8192, bf16 compute (phase
    10b); ffm also ``Servable.rank`` at the rank buckets."""
    config = fm_family_config(case).model
    run_servable(torch, workdir, card, case, config, fm_family_info(FM_FAMILY[case][3]), seed,
                 rank=case == "ffm")


def run_servable(torch, workdir, card, case, config, info, seed, rank=False, batch=None, cpu_check=None):
    """export → load_servable → predict at B=8192, bf16 compute (on the
    seed-0 ``fm_family_batch`` unless ``batch`` is given): finite
    probabilities; the first 256 rows against the port on the CPU with the
    same weights (``cpu_check(card servable, CPU servable, rows, scale)``
    gives (readings, details) in place of the logit's reading when it is
    given); the kernels the first predict launched; predict p50 of 10
    after 2 warm-ups; with ``rank`` also
    ``Servable.rank`` at the rank buckets against ``predict``'s
    probabilities. Returns the result."""
    from tpurec_torch.models import build_model
    from tpurec_torch.ops import embedding_update as eu
    from tpurec_torch.ops import kernels
    from tpurec_torch.serving.export import load_servable
    from tpurec_torch.train.checkpoint import export_params

    config = config.replace(params=dict(config.params, dtype="bfloat16"))
    export_dir = os.path.join(workdir, f"{case}_export")
    export_params(
        export_dir, build_model(config, info, device="cuda", seed=seed).state_dict(),
        meta={"model": config.name, "model_params": dict(config.params),
              "embedding": config.embedding.to_dict()},
    )
    servable = load_servable(export_dir, info, device="cuda")
    if batch is None:
        batch = fm_family_batch(info, TRAIN_BATCH, seed=0)
    batch = {k: v for k, v in batch.items() if k != "label"}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    outputs = servable.predict(batch)
    torch.cuda.synchronize()
    launches = path_launches(kernels, eu)
    # a multi-task model's first task stands for it (``ctr_output``, ``ctr_logit``)
    prob_key = "output" if "output" in outputs else min(k for k in outputs if k.endswith("output"))
    out = outputs[prob_key]
    key = prob_key[: -len("output")] + "logit"
    key = key if key in outputs else prob_key
    ref = outputs[key]
    scale = FM_FAMILY_RTOL * float(ref.abs().max())
    rows = {k: v[:256] for k, v in batch.items()}
    cpu_servable = load_servable(export_dir, info, device="cpu")
    details = {}
    if cpu_check is None:
        cpu = cpu_servable.predict(rows)[key]
        readings = dict(cpu_256_rows=float((ref[:256].cpu() - cpu).abs().max()) / scale)
    else:
        readings, details = cpu_check(servable, cpu_servable, rows, scale)
    ranks = {}
    rank_scale = FM_FAMILY_RTOL * float(out.abs().max())  # rank gives probabilities
    if rank:
        for n in RANK_BUCKETS:
            part = {k: v[:n] for k, v in batch.items()}
            got = servable.rank(part)
            times = []
            for _ in range(6):
                t0 = time.perf_counter()
                servable.rank(part).cpu()
                times.append((time.perf_counter() - t0) * 1e3)
            ranks[n] = dict(p50_ms=statistics.median(times[1:]),
                            reading=float((got - out[:n]).abs().max()) / rank_scale)
            readings[f"rank_{n}"] = ranks[n]["reading"]
    times = []
    for _ in range(12):
        t0 = time.perf_counter()
        servable.predict(batch)[prob_key].cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    p50 = statistics.median(times[2:])
    result = dict(card=card, model=case, batch=TRAIN_BATCH, readings=readings, compared=key,
                  launches=launches, limit=scale, rank_limit=rank_scale, max_abs=float(ref.abs().max()), std=float(ref.float().std()),
                  mean_prob=float(out.mean()), predict_p50_ms=p50,
                  examples_per_s=TRAIN_BATCH / (p50 / 1e3), rank=ranks, cpu_compare=details)
    print(f"{case} servable (readings: error / limit):", json.dumps(result), flush=True)
    check(out.shape == (TRAIN_BATCH,) and out.dtype == torch.float32, f"{case}: bad output {out.shape}")
    check(bool(torch.isfinite(out).all()) and bool(((out >= 0) & (out <= 1)).all()),
          f"{case}: outputs are not finite probabilities")
    for name, value in readings.items():
        check(value <= 1.0, f"{case}: {name} {readings}")
    return result


def run_fm_family_training(torch, eu, card, case, mode="dense"):
    """FM_FAMILY_STEPS bf16 steps of one engine (phase 10c). Returns (#9's
    launches in the steps, result)."""
    return run_training(torch, eu, card, case, fm_family_config(case, mode),
                        fm_family_info(FM_FAMILY[case][3]), mode)


def run_training(torch, eu, card, case, config, info, mode="dense", batch=None, extra=None):
    """FM_FAMILY_STEPS steps of ``config`` on a fixed batch (the seed-1
    ``fm_family_batch`` unless ``batch`` is given): losses finite and
    falling, and the peak memory; ``extra(trainer, state)`` adds its dict to the result; the
    result's ``launches`` holds every counted kernel's launches in the
    steps. Returns (#9's launches in the steps, result)."""
    from tpurec_torch.ops import kernels
    from tpurec_torch.train.trainer import Trainer

    if batch is None:
        batch = fm_family_batch(info, TRAIN_BATCH, seed=1)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(config, info)
    state = trainer.init_state(batch)
    dbatch = trainer.device_batch(batch)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    state, _, losses = train_steps(trainer, state, dbatch, steps=FM_FAMILY_STEPS)
    counts = path_launches(kernels, eu)
    launches = counts["fused_scatter_add"]
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 2**30
    result = dict(card=card, model=case, engine=mode, batch=TRAIN_BATCH, steps=FM_FAMILY_STEPS,
                  peak_mem_gb=peak_gb, loss_first=losses[0], loss_last=losses[-1],
                  fused_scatter_add_launches=launches, launches=counts)
    if extra is not None:
        result.update(extra(trainer, state))
    print(f"{case} {mode} training:", json.dumps(result), flush=True)
    check(all(np.isfinite(losses)), f"{case} {mode}: non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"{case} {mode}: the loss did not fall in {FM_FAMILY_STEPS} steps: {losses}")
    return launches, result


def fm_family_engine_checks(torch, eu):
    """FFM's fp32 fused step against its dense step (``fused_vs_dense``),
    and three fp32 fused steps card against CPU on 256 rows (phase 10c)."""
    from tpurec_torch.train.trainer import Trainer

    info = fm_family_info("fm")
    batch = fm_family_batch(info, TRAIN_BATCH, seed=1)
    fused_vs_dense(torch, eu, lambda m: fm_family_config("ffm", m, "float32"), info, batch,
                   FA_TABLES["ffm"], "ffm")
    gc.collect()
    torch.cuda.empty_cache()
    rows = {k: v[:256] for k, v in batch.items()}
    card_t = Trainer(fm_family_config("ffm", "fused", "float32"), info)
    cpu_t = Trainer(fm_family_config("ffm", "fused", "float32"), info, device="cpu")
    card_s, cpu_s = card_t.init_state(rows), cpu_t.init_state(rows)
    cpu_s.model.load_state_dict({k: v.cpu() for k, v in card_s.model.state_dict().items()})
    pairs = []
    for _ in range(3):
        card_s, _, a = card_t.train_step(card_s, card_t.device_batch(rows), card_t.metrics.init())
        cpu_s, _, b = cpu_t.train_step(cpu_s, cpu_t.device_batch(rows), cpu_t.metrics.init())
        pairs.append((float(a["loss"]), float(b["loss"])))
    print("ffm fused card vs cpu losses (256 rows):", json.dumps(dict(losses=pairs, limit=CPU_LOSS_TOL)),
          flush=True)
    check(max(abs(a - b) for a, b in pairs) <= CPU_LOSS_TOL, f"ffm fused: card vs CPU {pairs}")


def run_fm_family(torch, eu, workdir, card):
    """Phase 10: #9 at FFM's widths, every model served and trained, FFM and
    ONN in the fused and rowwise_adam engines. Returns (#9's records, its
    launches by path)."""
    records = check_fm_family_scatter(torch, eu)
    for seed, case in enumerate(FM_FAMILY):
        run_fm_family_servable(torch, workdir, card, case, seed)
        run_fm_family_training(torch, eu, card, case)
    launches = {}
    for case in FA_TABLES:
        fused, _ = run_fm_family_training(torch, eu, card, case, "fused")
        check(fused == len(FA_TABLES[case]) * FM_FAMILY_STEPS,
              f"the fused {case} step did not launch #9 once per table a step: {fused}")
        launches[f"{case}_fused_training"] = fused
        lazy, _ = run_fm_family_training(torch, eu, card, case, "sparse")
        check(lazy == 0, f"the rowwise_adam {case} step launched #9 {lazy} times")
    fm_family_engine_checks(torch, eu)
    return records, launches


# ---------------------------------------------------------------------------
# phase 11: the rest of the DCN family (NFM, DeepCrossing, FNN, CCPM, FGCNN,
# AFM, AutoInt)
DCN_REST = {
    # case: (registry name, params, embedding dim)
    "nfm": ("nfm", dict(hidden_dims=[64, 32]), 32),
    "fnn": ("fnn", dict(hidden_dims=[64, 32]), 32),
    "deep_crossing": ("deep_crossing", dict(num_blocks=3, residual_dim=64), 32),
    "ccpm": ("ccpm", dict(hidden_dims=[64, 32], num_filters=[4, 4], kernel_widths=[6, 5]), 32),
    "fgcnn": ("fgcnn", dict(hidden_dims=[64, 32]), 32),
    "afm": ("afm", dict(attention_dim=16), 32),
    # AutoInt's Criteo setting (Song et al., CIKM 2019): d=16, 3 interacting
    # layers of 2 heads, attention size 32
    "autoint": ("autoint", dict(num_attention_layers=3, num_heads=2, head_dim=32), 16),
}
NFM_TABLES = ("emb.embedding", "w.w.embedding")


def dcn_rest_config(case, mode="dense", dtype="bfloat16"):
    name, params, dim = DCN_REST[case]
    return experiment_config(name, params, dim, mode, dtype)


def check_step_scatter(torch, eu, trainer, batch, tables, widths, carried=()):
    """Kernel #9 on a model's own stream: one fused step of ``trainer`` on
    ``batch`` with each launch's inputs and output recorded, then each held
    to the plain version (``check_scatter_readings``' limits, broken
    versions above them, the same bits twice) and timed beside
    ``index_add_`` and its bound. ``tables`` names the launches in their
    order, ``widths`` their D; each table in ``carried`` must have rows
    with a nonzero gradient carried past a slice and repeated, so that
    the broken versions are held there. Returns {table: record}."""
    calls = []
    fused = eu.fused_scatter_add

    def recorded(table_rows, d, plan, grads_sorted):
        out = fused(table_rows, d, plan, grads_sorted)
        calls.append((table_rows, d, plan, grads_sorted.reshape(plan.n, d).clone(), out.clone()))
        return out

    # the wrapper adds its launch to the count of the name it is bound to in
    # the module, here the recorder's
    recorded.launches = 0
    state = trainer.init_state(batch)
    with mock.patch.object(eu, "fused_scatter_add", recorded):
        trainer.train_step(state, trainer.device_batch(batch), trainer.metrics.init())
        torch.cuda.synchronize()
    check(len(calls) == len(tables), f"{tables}: the fused step called #9 {len(calls)} times, "
                                     "not once per table")
    broken = broken_scatters(torch, eu)
    readings, records = {}, {}
    for table, (v, d, plan, grads, got) in zip(tables, calls):
        r, _, again = scatter_case(torch, eu, None, plan, v, d, grads=grads)
        r["same_bits_as_step"] = bool(torch.equal(got, again))
        r["same_bits"] = r["same_bits"] and r["same_bits_as_step"]
        carry_readings(torch, eu, broken, plan, v, d, grads, r)
        readings[table] = r
        records[table] = scatter_record(torch, eu, plan, v, d, grads, got, r)
        print("kernel check:", json.dumps(records[table]), flush=True)
    check_scatter_readings(readings, f" ({', '.join(tables)})")
    check([r["d"] for r in readings.values()] == list(widths), f"#9's widths on {tables}: {readings}")
    for table in carried:
        r = readings[table]
        check(r["slice_crossing_rows"] > 0 and r["repeated_rows"] > 0,
              f"no run with a nonzero gradient crossed a slice or repeated on {table}: {r}")
    return records


def check_nfm_scatter(torch, eu, info):
    """Kernel #9 on NFM's own stream (phase 11c): ``check_step_scatter`` of
    one bf16 fused step. Returns {table: record}."""
    from tpurec_torch.train.trainer import Trainer

    batch = fm_family_batch(info, TRAIN_BATCH, seed=1)
    trainer = Trainer(dcn_rest_config("nfm", "fused"), info)
    return check_step_scatter(torch, eu, trainer, batch, ("nfm_emb", "nfm_w"), (32, 1))


def run_dcn_rest(torch, eu, workdir, card):
    """Phase 11: each model served and trained dense over the FM schema with
    13 continuous columns; autoint also ranked; NFM in the fused engine
    (#9 twice a step), #9 on its stream, its fp32 fused step against its
    dense step. Returns (#9's records on NFM's stream, its launches)."""
    info = fm_family_info("fm_continuous")
    for seed, case in enumerate(DCN_REST):
        run_servable(torch, workdir, card, case, dcn_rest_config(case).model, info, seed,
                     rank=case == "autoint")
        run_training(torch, eu, card, case, dcn_rest_config(case), info)
    fused, _ = run_training(torch, eu, card, "nfm", dcn_rest_config("nfm", "fused"), info, "fused")
    check(fused == len(NFM_TABLES) * FM_FAMILY_STEPS,
          f"the fused nfm step did not launch #9 once per table a step: {fused}")
    records = check_nfm_scatter(torch, eu, info)
    gc.collect()
    torch.cuda.empty_cache()
    fused_vs_dense(torch, eu, lambda m: dcn_rest_config("nfm", m, "float32"), info,
                   fm_family_batch(info, TRAIN_BATCH, seed=1), NFM_TABLES, "nfm")
    return records, {"nfm_fused_training": fused}


# ---------------------------------------------------------------------------
# phase 12: from raw files to serving through the port's own command line
CLI_TABULAR_EVENTS = 1_000_000
CLI_SEQUENCE_EVENTS = 100_000
CLI_SEQ_LEN = 64
CLI_REQUESTS = 200
CLI_KV_TOL = 2e-6  # the KV store's scores carry 6 decimals: one rounding apart
# deepfm dense against fused after one bf16 epoch: the two engines take the
# same Adam, so eval loss and AUC end within this of each other
CLI_ENGINE_TOL = 1e-3
TOPK_SHAPE = (5000, 20000, 32)  # phase 9's index: users, items, D


def cli_config(path, name, fused=False, epochs=1):
    """An ``ExperimentConfig`` file for ``cli train``: the registry's widths
    at D=32, B=8192, bf16 compute, fp32 params, bce, Adam lr 1e-3 eps 1e-7;
    ``fused`` takes the fused engine (``fused_adam``)."""
    cfg = {
        "model": {"name": name, "embedding": {"dim": 32}},
        "train": {"batch_size": TRAIN_BATCH, "epochs": epochs, "loss": "bce",
                  "compute_dtype": "bfloat16", "log_every_steps": 0, "sparse_embedding": fused,
                  "optimizer": {"learning_rate": 1e-3, "eps": 1e-7,
                                "embedding_optimizer": "fused_adam" if fused else "adam"}},
    }
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


@contextlib.contextmanager
def trainer_calls():
    """While ``cli train`` runs: the ``Trainer.train_step`` and
    ``eval_step`` calls, counted."""
    from tpurec_torch.train.trainer import Trainer

    record = dict(eval_batches=0, steps=0)
    train_step, eval_step = Trainer.train_step, Trainer.eval_step

    def stepped(self, *args, **kw):
        record["steps"] += 1
        return train_step(self, *args, **kw)

    def counted(self, *args, **kw):
        record["eval_batches"] += 1
        return eval_step(self, *args, **kw)

    with mock.patch.object(Trainer, "train_step", stepped), mock.patch.object(Trainer, "eval_step", counted):
        yield record


def path_launches(kernels, eu) -> dict:
    """The launches of the kernels on the CLI's and the mesh's paths since
    the last reset."""
    return dict(fm_second_order=kernels.fm_second_order_fused.launches,
                din_attention=kernels.din_attention_fused.launches,
                din_attention_bwd=kernels.din_attention_bwd_fused.launches,
                fused_scatter_add=eu.fused_scatter_add.launches)


def cli_train(torch, kernels, eu, card, label, argv):
    """``cli train`` with the launches counted from 0. Returns the result:
    steps, eval batches, the command's seconds, the last epoch's train and
    eval metrics and the launches."""
    from tpurec_torch import cli

    workdir = argv[argv.index("--workdir") + 1]
    kernels.reset_launch_counts()
    t = time.perf_counter()
    with trainer_calls() as record:
        cli.main(argv)
    seconds = time.perf_counter() - t
    torch.cuda.synchronize()
    launches = path_launches(kernels, eu)
    with open(os.path.join(workdir, "report.json")) as f:
        history = json.load(f)["history"]
    last = history[-1]
    result = dict(card=card, run=label, seconds=seconds, steps=record["steps"],
                  eval_batches=record["eval_batches"], train=last["train"], eval=last["eval"],
                  eval_loss_by_epoch=[h["eval"]["loss"] for h in history], launches=launches)
    print(f"cli train {label}:", json.dumps(result), flush=True)
    check(all(np.isfinite(v) for h in history for v in h["eval"].values()), f"{label}: {history}")
    return result


def read_slates(path):
    with open(path) as f:
        return {k: (v.split("\t")[0].split(","), np.asarray(v.split("\t")[1].split(","), float))
                for k, v in json.load(f).items()}


def compare_slates(card_kv, cpu_kv, item_profile) -> dict:
    """The card's index against the CPU's: the same users, each slate's
    scores within ``CLI_KV_TOL`` position by position; in both, items with
    the same features (exact ties) in ascending item order, as
    ``lax.top_k`` orders them; and the same items but where two distinct
    items' scores lie within the rounding of the two devices."""
    order = {iid: j for j, iid in enumerate(item_profile)}
    feats = {iid: tuple(f) for iid, f in item_profile.items()}
    check(list(card_kv) == list(cpu_kv), "the card's and the CPU's index hold other users")
    tied = near = 0
    worst = 0.0
    for key, (pi, ps) in cpu_kv.items():
        ci, cs = card_kv[key]
        worst = max(worst, float(np.abs(cs - ps).max()))
        for items in (ci, pi):
            for a, b in zip(items, items[1:]):
                if feats[a] == feats[b]:
                    check(order[a] < order[b], f"{key}: tied items {a}, {b} out of lax.top_k's order")
        tied += sum(feats[a] == feats[b] for a, b in zip(ci, ci[1:]))
        for p, (a, b) in enumerate(zip(ci, pi)):
            if a == b:
                continue
            check(feats[a] != feats[b], f"{key}: tied items {a}, {b} in another order")
            if b in ci:
                gap = abs(cs[p] - cs[ci.index(b)])
            else:  # the CPU's last item is the card's 21st
                gap = 0.0 if p == len(ci) - 1 else np.inf
            check(gap <= CLI_KV_TOL, f"{key}: {a} against {b} at {p}, {gap} apart on the card")
            near += 1
    check(worst <= CLI_KV_TOL, f"index scores card against CPU: {worst} > {CLI_KV_TOL}")
    check(tied > 0, "no slate holds two tied items: the tie order went unchecked")
    return dict(users=len(cpu_kv), max_abs_score_diff=worst, tied_adjacent_pairs=tied,
                near_tie_positions=near)


def topk_ab(torch, card) -> dict:
    """The index's top-k: ``exact_topk`` over phase 9's 5,000 users x 20,000
    items (D=32, random seeded embeddings) with ``top_k`` (``lax.top_k``'s
    order) and with ``torch.topk``: one warm-up call each, then in turns
    (``TOPK_TURNS``); and the device time of each op alone at each caller's
    shape: the indexer's (4096, 20000) batch, ``retrieve_online``'s one
    row over phase 9's 20,000 and phase 5's 2,500 items, and SINE's
    prototype pick (B=8192 over its 32 prototypes, k=4)."""
    from tpurec_torch.ops.topk import top_k
    from tpurec_torch.serving import indexer

    u, n, d = TOPK_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(13)
    users = torch.randn(u, d, generator=gen, device="cuda").cpu().numpy()
    items = torch.randn(n, d, generator=gen, device="cuda").cpu().numpy()
    scores = indexer.l2_normalize(torch.as_tensor(users[:4096], device="cuda")) @ \
        indexer.l2_normalize(torch.as_tensor(items, device="cuda")).T
    callers = {"index_4096x20000_k20": (scores, 20), "online_20000_k20": (scores[0], 20),
               "online_2500_k20": (scores[0, :2500], 20),
               "sine_pick_8192x32_k4": (torch.randn(TRAIN_BATCH, 32, generator=gen, device="cuda"), 4)}
    ms = {name: dict(top_k=device_ms(torch, lambda: top_k(x, k)),
                     torch_topk=device_ms(torch, lambda: torch.topk(x, k)))
          for name, (x, k) in callers.items()}
    outs = {}

    def timed():
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = indexer.exact_topk(users, items, 20, device="cuda")
        outs.setdefault("top_k" if indexer.top_k is top_k else "torch_topk", out)
        return time.perf_counter() - t

    topk_turns(torch, (indexer,), timed)  # warms both up
    seconds = topk_turns(torch, (indexer,), timed)
    # random scores barely tie: the two give the same slates
    check(np.array_equal(outs["top_k"][1], outs["torch_topk"][1]), "top_k and torch.topk disagree")
    result = dict(card=card, shape=dict(users=u, items=n, dim=d, k=20, batch=4096),
                  device_ms=ms, exact_topk_s=seconds, turns=TOPK_TURNS)
    print("index top-k (lax.top_k's order against torch.topk):", json.dumps(result), flush=True)
    return result


def run_cli(torch, kernels, eu, workdir, card):
    """Phase 12: ``tpurec_torch.cli.main`` from raw files to serving, with
    ``TPUREC_PLATFORM`` unset (everything on the card). Each kernel of the
    path is held to its plain version at the path's shapes: #9 on the first
    batch of the fused deepfm run (its own step's stream and gradients), #1
    at the tabular F, #4 and #5 at DIN's key width over the two series.
    Returns each kernel's launches by path, those checks' records by kernel
    and the top-k timings."""
    from tpurec_torch import cli
    from tpurec_torch.config import ExperimentConfig
    from tpurec_torch.data import crc32c, native
    from tpurec_torch.data.loader import ArrayLoader, decode_columnar, load_columnar, shard_paths
    from tpurec_torch.data.schema import DataInfo
    from tpurec_torch.serving.export import load_servable
    from tpurec_torch.train.trainer import Trainer

    with mock.patch.dict(os.environ):
        os.environ.pop("TPUREC_PLATFORM", None)
        check(cli.platform_device() == "cuda", "TPUREC_PLATFORM unset must mean the card")
        t = time.perf_counter()
        crc32c.build_library()  # raises with the compiler's output if it cannot build
        build_s = time.perf_counter() - t
        check(native.native_available(), "the native recordio codec is not in use")
        sizes = dict(tabular_events=CLI_TABULAR_EVENTS, sequence_events=CLI_SEQUENCE_EVENTS,
                     seq_len=CLI_SEQ_LEN, batch=TRAIN_BATCH, dim=32, requests_per_path=CLI_REQUESTS)
        print("cli sizes:", json.dumps(sizes), f"(native codec in use; librecordio built in "
              f"{build_s:.2f} s)", flush=True)
        d = {k: os.path.join(workdir, f"cli_{k}") for k in (
            "raw", "data", "deepfm", "deepfm_fused", "dssm", "index", "index_cpu", "seq_raw",
            "seq_data", "din")}
        stages = {}

        def stage(name, argv):
            t = time.perf_counter()
            cli.main(argv)
            stages[name] = time.perf_counter() - t

        stage("synth_tabular", ["synth", "--family", "tabular", "--out", d["raw"],
                                "--n-events", str(CLI_TABULAR_EVENTS)])
        stage("datagen_tabular", ["datagen", "--family", "tabular", "--raw", d["raw"], "--out", d["data"]])
        info = DataInfo.load(d["data"])
        runs, configs = {}, {}
        for label, name, fused in (("deepfm", "deepfm", False), ("deepfm_fused", "deepfm", True),
                                   ("dssm", "dssm_double", False)):
            configs[label] = cli_config(os.path.join(workdir, f"cli_{label}.json"), name, fused=fused)
            runs[label] = cli_train(torch, kernels, eu, card, label, [
                "train", "--config", configs[label], "--data", d["data"], "--workdir", d[label]])
            stages[f"train_{label}"] = runs[label]["seconds"]
            check(runs[label]["eval"]["auc"] > 0.6, f"{label}: eval AUC {runs[label]['eval']} after an epoch")
        for label in ("deepfm", "deepfm_fused"):
            r = runs[label]
            check(r["launches"]["fused_scatter_add"] == (2 * r["steps"] if label == "deepfm_fused" else 0),
                  f"{label}: #9 launched {r['launches']['fused_scatter_add']} times in {r['steps']} steps")
            check(r["launches"]["fm_second_order"] == r["eval_batches"],
                  f"{label}: #1 launched {r['launches']['fm_second_order']} times in "
                  f"{r['eval_batches']} eval batches (and none in training)")
        check(not any(runs["dssm"]["launches"].values()), f"dssm_double: {runs['dssm']['launches']}")
        engines = {k: abs(runs["deepfm"]["eval"][k] - runs["deepfm_fused"]["eval"][k]) for k in ("loss", "auc")}
        print("cli deepfm dense against fused, eval:", json.dumps(dict(engines, limit=CLI_ENGINE_TOL)), flush=True)
        check(max(engines.values()) <= CLI_ENGINE_TOL, f"deepfm dense and fused end apart: {engines}")
        # #9 on the fused run's own stream: its first batch, a fresh state
        with open(configs["deepfm_fused"]) as f:
            cfg = ExperimentConfig.from_json(f.read())
        first = next(iter(ArrayLoader(load_columnar(shard_paths(d["data"], "train")), TRAIN_BATCH,
                                      seed=cfg.train.seed)))
        scatter = check_step_scatter(torch, eu, Trainer(cfg, info, device="cuda"), first,
                                     ("cli_deepfm_w", "cli_deepfm_v"), (1, 32))
        dssm_export, deepfm_export = (os.path.join(d[k], "export") for k in ("dssm", "deepfm"))
        kernels.reset_launch_counts()
        stage("index", ["index", "--export", dssm_export, "--data", d["data"], "--out", d["index"],
                        "--topk", "20"])
        with mock.patch.dict(os.environ, {"TPUREC_PLATFORM": "cpu"}):
            stage("index_cpu", ["index", "--export", dssm_export, "--data", d["data"],
                                "--out", d["index_cpu"], "--topk", "20"])
        with open(os.path.join(d["data"], "item_profile.json")) as f:
            item_profile = json.load(f)
        with open(os.path.join(d["data"], "user_profile.json")) as f:
            user_profile = json.load(f)
        slates = compare_slates(read_slates(os.path.join(d["index"], "kv_store.json")),
                                read_slates(os.path.join(d["index_cpu"], "kv_store.json")), item_profile)
        print("cli index, card against CPU:", json.dumps(dict(card=card, **slates)), flush=True)
        topk = topk_ab(torch, card)

        # serving: the deepfm ranker and the dssm_double towers, each an export
        # served by ``cli serve`` over the same index (a ranker has no tower
        # for online retrieval, in either package)
        servers = {}
        for label, export in (("deepfm", deepfm_export), ("dssm", dssm_export)):
            servers[label] = cli.build_server(cli.parse_args([
                "serve", "--export", export, "--data", d["data"], "--index", d["index"], "--port", "0"]))
        threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers.values()]
        for th in threads:
            th.start()
        rng = np.random.default_rng(0)
        uids = rng.choice(list(user_profile), size=CLI_REQUESTS, replace=False).tolist()
        iids = list(item_profile)

        def descending(n):
            def verify(uid, body):
                scores = list(body["result"].values())
                check(len(scores) == n and scores == sorted(scores, reverse=True), f"{uid}: {body}")
            return verify

        kernels.reset_launch_counts()
        t = time.perf_counter()
        try:
            latency = http_latency(servers["deepfm"].server_address[1], {
                "retrieve_kv": (lambda u: {"user_id": u, "type": "retrieve", "source": "kv"},
                                descending(20)),
                "rank_20": (lambda u: {"user_id": u, "type": "rank",
                                       "item_ids": rng.choice(iids, 20, replace=False).tolist()},
                            descending(20)),
                "rank_200": (lambda u: {"user_id": u, "type": "rank",
                                        "item_ids": rng.choice(iids, 200, replace=False).tolist()},
                             descending(200)),
            }, uids)
            torch.cuda.synchronize()
            rank_launches = kernels.fm_second_order_fused.launches
            latency.update(http_latency(servers["dssm"].server_address[1], {
                "retrieve_online_top20": (lambda u: {"user_id": u, "type": "retrieve", "topk": 20},
                                          descending(20)),
                "rank_from_retrieval": (lambda u: {"user_id": u, "type": "rank", "from_retrieval": True,
                                                   "topk": 20}, descending(20)),
            }, uids))
            stages["serve_requests"] = time.perf_counter() - t
            torch.cuda.synchronize()
            serve_launches = path_launches(kernels, eu)
            # card against CPU: the served ranker on the test shard's first 256 rows
            test = decode_columnar(shard_paths(d["data"], "test")[:1])
            rows = {n: test[n][:256] for n in info.feature_names}
            got = servers["deepfm"].RequestHandlerClass.service.ranker(rows).float().cpu()
            want = load_servable(deepfm_export, info, device="cpu").rank(rows).float()
        finally:
            for s in servers.values():
                s.shutdown()
                s.server_close()
            for th in threads:
                th.join(timeout=30)
        n_rank = 2 * (CLI_REQUESTS + 5)
        check(rank_launches == n_rank == serve_launches["fm_second_order"],
              f"#1 launched {rank_launches} times for {n_rank} deepfm rank requests "
              f"({serve_launches['fm_second_order']} after the dssm_double requests)")
        rank_limit = FM_FAMILY_RTOL * float(got.abs().max())
        rank_reading = float((got - want).abs().max()) / rank_limit
        serving = dict(card=card, latency=latency, launches=serve_launches, rank_requests=n_rank,
                       rank_cpu_256_rows=rank_reading, rank_limit=rank_limit)
        print("cli serve (reading: error / limit):", json.dumps(serving), flush=True)
        check(rank_reading <= 1.0, f"served deepfm rank card against CPU: {rank_reading}")
        fm = check_fm(torch, kernels, shape=(len(info.feature_names), 32))

        stage("synth_sequence", ["synth", "--family", "sequence", "--out", d["seq_raw"],
                                 "--n-events", str(CLI_SEQUENCE_EVENTS)])
        stage("datagen_sequence", ["datagen", "--family", "sequence", "--raw", d["seq_raw"],
                                   "--out", d["seq_data"], "--max-seq-length", str(CLI_SEQ_LEN)])
        config = cli_config(os.path.join(workdir, "cli_din.json"), "din", epochs=2)
        din = cli_train(torch, kernels, eu, card, "din", [
            "train", "--config", config, "--data", d["seq_data"], "--workdir", d["din"]])
        stages["train_din"] = din["seconds"]
        losses = din["eval_loss_by_epoch"]
        check(losses[-1] < losses[0], f"din: the eval loss did not fall over two epochs: {losses}")
        check(din["launches"]["din_attention_bwd"] == din["steps"],
              f"din: #5 launched {din['launches']['din_attention_bwd']} times in {din['steps']} steps")
        check(din["launches"]["din_attention"] == din["steps"] + din["eval_batches"],
              f"din: #4 launched {din['launches']['din_attention']} times in {din['steps']} steps "
              f"and {din['eval_batches']} eval batches")
        # DIN's keys are its series' embeddings side by side
        din_shape = (TRAIN_BATCH, CLI_SEQ_LEN, 32 * len(DataInfo.load(d["seq_data"]).sequence_names), 36)
        din_fwd = check_din_forward(torch, kernels, shape=din_shape)
        din_bwd = check_din_backward(torch, kernels, shape=din_shape)
    print("cli stage seconds:", json.dumps(dict(card=card, **stages)), flush=True)
    launches = dict(
        fm_second_order=dict(cli_deepfm_evaluate=runs["deepfm"]["launches"]["fm_second_order"]
                             + runs["deepfm_fused"]["launches"]["fm_second_order"],
                             cli_serve_rank=serve_launches["fm_second_order"]),
        din_attention=dict(cli_din_training=din["launches"]["din_attention"]),
        din_attention_bwd=dict(cli_din_training=din["launches"]["din_attention_bwd"]),
        fused_scatter_add=dict(cli_deepfm_fused_training=runs["deepfm_fused"]["launches"]["fused_scatter_add"]),
    )
    key = "x".join(map(str, din_shape))
    checks = dict(fm_second_order={f"cli_f{len(info.feature_names)}": fm},
                  din_attention={f"cli_din_{key}": din_fwd}, din_attention_bwd={f"cli_din_{key}": din_bwd},
                  fused_scatter_add=scatter)
    return launches, checks, topk


# ---------------------------------------------------------------------------
# phase 13: the multi-task and personalization families
MULTITASK = {
    # case: (registry name, loss); the registry's widths at D=32: 4 experts
    # of (64, 32), towers (32,), PLE and FDN 2 levels of 2 experts a task
    "mmoe": ("mmoe", "multi_task"),
    "esmm": ("esmm", "multi_task"),
    "ple": ("ple", "multi_task"),
    "esm2": ("esm2", "model_loss"),
    "escm2": ("escm2", "model_loss"),
    "fdn": ("fdn", "model_loss"),
    "poso_mlp": ("poso_mlp", "bce"),
    "poso_mha": ("poso_mha", "bce"),
    "poso_mmoe": ("poso_mmoe", "multi_task"),
    "pepnet": ("pepnet", "multi_task"),
}
MT_FUSED = ("mmoe", "poso_mmoe")
MT_TABLES = ("emb.embedding",)
MT_INFER_RUNS = 22  # Trainer.infer p50 over the last 20
MT_CLI_EVENTS = 200_000
# the impression runs of ``cli train``: at lr 1e-3 an epoch of ~20 B=8192
# steps leaves both AUCs near 0.5, so lr 1e-2 over two epochs
MT_CLI_EPOCHS = 2
MT_CLI_RUNS = {"mmoe": "multi_task", "escm2": "model_loss"}


def multitask_config(case, mode="dense", dtype="bfloat16"):
    """The case's registry model at D=32 with its loss; ``model_loss``
    models report ``ctr_auc``/``cvr_auc``."""
    name, loss = MULTITASK[case]
    metrics = ("ctr_auc", "cvr_auc") if loss == "model_loss" else ()
    return experiment_config(name, {}, 32, mode, dtype, loss=loss, metrics=metrics)


def multitask_batch(info, batch_size, seed):
    """``fm_family_batch`` with the multi-task labels drawn from the seed: a
    click ``ctr`` (p 0.3), a conversion ``cvr`` only where ``ctr`` = 1
    (p 0.3), and the chain as ``make_impression_log_raw(full_chain=True)``
    labels it: given a click exactly one of {cart, collect, none}, the
    order (= ``cvr``) below it and the payment below the order (p 0.7)."""
    batch = fm_family_batch(info, batch_size, seed)
    rng = np.random.default_rng(seed + 2000)
    click = rng.random(batch_size) < 0.3
    branch = rng.integers(0, 3, size=batch_size)
    order = click & (rng.random(batch_size) < 0.3)
    pay = order & (rng.random(batch_size) < 0.7)
    labels = dict(ctr=click, cvr=order, click=click, cart=click & (branch == 0),
                  collect=click & (branch == 1), none=click & (branch == 2), order=order, pay=pay)
    batch.update({k: v.astype(np.float32) for k, v in labels.items()})
    return batch


def multitask_extra(case, batch, eval_batches):
    """After a model's training steps: ``Trainer.infer`` at B=8192 (eval
    mode; p50 of the last 20 of ``MT_INFER_RUNS``, host clock, the copy to
    the card and back included) with every ``*_output`` a finite
    probability, and ``evaluate`` over ``eval_batches`` with finite metrics
    and its selection metric (mean AUC for two tasks)."""

    def extra(trainer, state):
        times = []
        for _ in range(MT_INFER_RUNS):
            t0 = time.perf_counter()
            outputs = trainer.infer(state, batch)
            times.append((time.perf_counter() - t0) * 1e3)
        probs = {k: v for k, v in outputs.items() if k.endswith("output")}
        check(bool(probs) and all(v.shape == (TRAIN_BATCH,) and bool(np.isfinite(v).all())
                                  and bool(((v >= 0) & (v <= 1)).all()) for v in probs.values()),
              f"{case}: infer outputs are not finite probabilities: {sorted(probs)}")
        evaluation = trainer.evaluate(state, eval_batches)
        check(all(np.isfinite(v) for v in evaluation.values()), f"{case}: evaluate {evaluation}")
        p50 = statistics.median(times[2:])
        return dict(infer_p50_ms=p50, infer_examples_per_s=TRAIN_BATCH / (p50 / 1e3),
                    infer_outputs=sorted(probs), evaluate=evaluation,
                    selection_metric=trainer._selection_metric(evaluation))

    return extra


def run_multitask_fused(torch, eu, card, info, batch):
    """Phase 13b: mmoe and poso_mmoe ``FM_FAMILY_STEPS`` bf16 steps on the
    fused engine (#9 once per table a step), #9 on each model's own stream
    (``check_step_scatter``), and each model's fp32 fused step against its
    dense step (``fused_vs_dense``). Returns (#9's records, launches by
    path)."""
    from tpurec_torch.train.trainer import Trainer

    records, launches = {}, {}
    for case in MT_FUSED:
        fused, _ = run_training(torch, eu, card, case, multitask_config(case, "fused"), info, "fused",
                                batch=batch)
        check(fused == len(MT_TABLES) * FM_FAMILY_STEPS,
              f"the fused {case} step did not launch #9 once per table a step: {fused}")
        launches[f"{case}_fused_training"] = fused
        records.update(check_step_scatter(torch, eu, Trainer(multitask_config(case, "fused"), info), batch,
                                          (f"{case}_emb",), (32,)))
        gc.collect()
        torch.cuda.empty_cache()
        fused_vs_dense(torch, eu, lambda m, c=case: multitask_config(c, m, "float32"), info, batch,
                       MT_TABLES, case)
    return records, launches


def multitask_cli_config(path, name, loss):
    """An ``ExperimentConfig`` file for the impression runs: the registry's
    widths at D=32, B=8192, bf16 compute, fp32 params, Adam lr 1e-2 eps
    1e-7, ``MT_CLI_EPOCHS`` epochs; ``model_loss`` reports the two AUCs."""
    train = {"batch_size": TRAIN_BATCH, "epochs": MT_CLI_EPOCHS, "loss": loss,
             "compute_dtype": "bfloat16", "log_every_steps": 0,
             "optimizer": {"learning_rate": 1e-2, "eps": 1e-7}}
    if loss == "model_loss":
        train["metrics"] = ["ctr_auc", "cvr_auc"]
    with open(path, "w") as f:
        json.dump({"model": {"name": name, "embedding": {"dim": 32}}, "train": train}, f)
    return path


def run_multitask_cli(torch, kernels, eu, workdir, card):
    """Phase 13c: ``cli synth`` and ``datagen`` of the impression family
    (``MT_CLI_EVENTS`` events), then ``cli train`` of mmoe (multi_task) and
    escm2 (model_loss) with export, every step on the card: both AUCs above
    0.5, no kernel launched (the dense engine), each AUC's gap to the
    generator's Bayes ceiling (``oracle.npz``) and the stage seconds
    recorded. Returns the stage seconds."""
    from tpurec_torch import cli

    with mock.patch.dict(os.environ):
        os.environ.pop("TPUREC_PLATFORM", None)
        raw, data = os.path.join(workdir, "mt_raw"), os.path.join(workdir, "mt_data")
        stages, runs = {}, {}
        for name, argv in (
            ("synth_impression", ["synth", "--family", "impression", "--out", raw,
                                  "--n-events", str(MT_CLI_EVENTS)]),
            ("datagen_impression", ["datagen", "--family", "impression", "--raw", raw, "--out", data]),
        ):
            t = time.perf_counter()
            cli.main(argv)
            stages[name] = time.perf_counter() - t
        oracle = {k: float(v) for k, v in np.load(os.path.join(raw, "oracle.npz")).items()}
        for name, loss in MT_CLI_RUNS.items():
            config = multitask_cli_config(os.path.join(workdir, f"mt_{name}.json"), name, loss)
            run_dir = os.path.join(workdir, f"mt_{name}")
            r = cli_train(torch, kernels, eu, card, f"impression_{name}",
                          ["train", "--config", config, "--data", data, "--workdir", run_dir])
            stages[f"train_{name}"] = r["seconds"]
            check(os.path.exists(os.path.join(run_dir, "export", "params.pt")), f"{name}: no export")
            check(not any(r["launches"].values()), f"{name}: dense impression run launched {r['launches']}")
            for k in ("ctr_auc", "cvr_auc"):
                check(r["eval"][k] > 0.5, f"impression {name}: eval {k} {r['eval'][k]}")
            runs[name] = dict(eval=r["eval"], gap_to_oracle={
                k: oracle[f"oracle_{k}"] - r["eval"][k] for k in ("ctr_auc", "cvr_auc")})
    print("cli impression:", json.dumps(dict(card=card, events=MT_CLI_EVENTS, epochs=MT_CLI_EPOCHS,
                                             oracle=oracle, runs=runs, stages=stages)), flush=True)
    return stages


def run_multitask(torch, kernels, eu, workdir, card):
    """Phase 13: the ten models dense over the FM schema with 13 continuous
    columns (``FM_FAMILY_STEPS`` bf16 steps each, then ``Trainer.infer`` and
    ``evaluate``), mmoe and poso_mmoe fused (#9), and the impression
    family's CLI journey. Returns (#9's records on the two streams, its
    launches by path)."""
    info = fm_family_info("fm_continuous")
    batch = multitask_batch(info, TRAIN_BATCH, seed=1)
    evals = [multitask_batch(info, TRAIN_BATCH, seed=2 + i) for i in range(2)]
    for case in MULTITASK:
        launches, _ = run_training(torch, eu, card, case, multitask_config(case), info, batch=batch,
                                   extra=multitask_extra(case, batch, evals))
        check(launches == 0, f"the dense {case} step launched #9 {launches} times")
    records, launches = run_multitask_fused(torch, eu, card, info, batch)
    run_multitask_cli(torch, kernels, eu, workdir, card)
    return records, launches


# ---------------------------------------------------------------------------
# phase 14: the recurrent sequence models (DIEN, DSIN, SDM) and the FiBiNET++
# family (FiBiNET++, MaskNet, ContextNet)
SEQUENCE = {
    # case: (registry name, params); DIN's widths (attention H=36, MLP
    # (200, 80)); DSIN at 4 sessions of 16 steps (the registry's 5 does not
    # divide L=64)
    "dien": ("dien", dict(DIN_FEATURES)),
    "dsin": ("dsin", dict(DIN_FEATURES, num_sessions=4)),
}
# DIN attentions a forward runs: #4 launches a forward, #5 a backward
SEQ_ATTENTIONS = {"dien": 1, "dsin": 2}
SDM_PARAMS = dict(short_len=10, lstm_layers=2, num_heads=2, normalize_logits=True)
FIBINETPP = {
    # case: (registry name, params); the registry's widths at D=32
    "fibinet_pp": ("fibinet_pp", {}),
    "masknet_serial": ("masknet", dict(mode="serial")),
    "masknet_parallel": ("masknet", dict(mode="parallel")),
    "contextnet_pointwise": ("contextnet", dict(block_mode="pointwise")),
    "contextnet_singlelayer": ("contextnet", dict(block_mode="singlelayer")),
}
SEQ_EVAL_BATCHES = 2


def sequence_batch(info, batch_size, seed):
    """``bench_batch`` (``bench.py:75-87``) plus ``neg_history``, DIEN's
    sampled negative series, drawn the same way from its own seed and 0
    where the history is padded."""
    batch = bench_batch(info, batch_size, 64, seed=seed)
    rng = np.random.default_rng(seed + 3000)
    neg = rng.integers(1, info.total_dims // 2, size=batch["history"].shape)
    batch["neg_history"] = np.where(batch["history"] != 0, neg, 0)
    return batch


def sequence_config(case, mode="dense", dtype="bfloat16"):
    name, params = SEQUENCE[case]
    return experiment_config(name, params, 32, mode, dtype)


def evaluate_extra(torch, case, eval_batches):
    """After a model's training steps: ``evaluate`` over ``eval_batches``,
    every metric finite, and the kernels it launched."""
    from tpurec_torch.ops import embedding_update as eu
    from tpurec_torch.ops import kernels

    def extra(trainer, state):
        kernels.reset_launch_counts()
        evaluation = trainer.evaluate(state, eval_batches)
        torch.cuda.synchronize()
        check(all(np.isfinite(v) for v in evaluation.values()), f"{case}: evaluate {evaluation}")
        return dict(evaluate=evaluation, evaluate_launches=path_launches(kernels, eu))

    return extra


def recorded_attention(kernels):
    """Recorders for #4 and #5 bound in their module's place: each call's
    inputs (and cotangents) and outputs, copied, in two lists."""
    fwd, bwd = kernels.din_attention_fused, kernels.din_attention_bwd_fused
    calls = dict(fwd=[], bwd=[])

    def copies(ts):
        return [None if t is None else t.detach().clone() for t in ts]

    def fwd_rec(*args):
        out = fwd(*args)
        calls["fwd"].append((copies(args), copies(out)))
        return out

    def bwd_rec(*args):
        out = bwd(*args)
        calls["bwd"].append((copies(args), copies(out)))
        return out

    # the wrappers add their launches to the count of the names they are
    # bound to in the module, here the recorders'
    fwd_rec.launches = bwd_rec.launches = 0
    return fwd_rec, bwd_rec, calls


def attention_fwd_case(torch, kernels, args, out=None) -> tuple:
    """#4 on ``args`` against its plain version: (readings, record). The
    readings are phase 3's (error / limit), with the broken versions (mask
    ignored, slopes dropped, lin in single TF32) and the same bits twice (and
    as ``out``, the launch recorded on the path, when given)."""
    b, l, d = args[1].shape
    h = args[3].shape[1]
    got = kernels.din_attention_fused(*args)
    want = kernels.din_attention_plain(*args)
    relu = args[:6] + [None]
    no_mask = args[:2] + [torch.ones_like(args[2])] + args[3:]
    r = dict(kernel=max(din_reading(got, want).values()),
             broken_mask_ignored=max(din_reading(kernels.din_attention_plain(*no_mask), want).values()),
             broken_alpha_dropped=max(din_reading(kernels.din_attention_plain(*relu), want).values()),
             broken_single_tf32=max(din_reading(
                 kernels.din_attention_unfolded(*args, products="1xtf32"), want).values()))
    again = kernels.din_attention_fused(*args)
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    if out is not None:
        same = same and all(torch.equal(x, y) for x, y in zip(got, out))
    r["same_bits"] = same
    bound_ms, bound_by, live = din_bound(args)
    rec = dict(name="din_attention", shape=[b, l, d, h], live_steps=live,
               max_abs_err=max(float((g - w).abs().max()) for g, w in zip(got, want)),
               ms=device_ms(torch, lambda: kernels.din_attention_fused(*args)),
               plain_ms=device_ms(torch, lambda: kernels.din_attention_plain(*args)),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None, readings=r)
    return r, rec


def attention_bwd_case(torch, kernels, args, out=None) -> tuple:
    """#5 on ``args`` (the forward's inputs, then gp and gs) against its
    plain version: (readings, record), phase 6's readings, broken versions
    and same bits (on ``args``, and against ``out``, the launch recorded on
    the path, when given).

    A model's cotangents are those of a mean over B rows, ~1e-5 and below,
    where ``KERNEL_TOL``'s atol would pass anything for dq and dkeys. The
    backward is linear in (gp, gs), so the readings take both scaled by one
    power of two (exact in floating point) to a largest |value| in [0.5, 1),
    as phase 6's random ones are: the scaled launch's errors are the
    recorded launch's, relative to its scale. ``mask_can_matter`` says
    whether a backward that ignores the mask could differ here at all: with
    gp = 0 and gs = 0 at every masked step (DIEN's: its scores go through a
    softmax over the live steps) it computes the same gradients.

    The reference is ``bwd_reference`` (|lin| ~1e-9 at the kink: one such
    element in ~10^7 is a few in a model's step). ``plain_fp32`` reads the
    fp32 plain version against the same reference."""
    b, l, d = args[1].shape
    h = args[3].shape[1]
    gp, gs = args[7], args[8]
    top = max(float(gp.abs().max()), float(gs.abs().max()))
    scale = 2.0 ** -(np.frexp(top)[1]) if top > 0 else 1.0
    scaled = args[:7] + [gp * scale, gs * scale]
    q, k, m, w1, b1, w2, alpha, sgp, sgs = scaled
    got = kernels.din_attention_bwd_fused(*scaled)
    want = bwd_reference(kernels, *scaled)
    worst = lambda x: max(bwd_reading(x, want).values())  # noqa: E731
    r = dict(kernel=worst(got), plain_fp32=worst(kernels.din_attention_bwd_plain(*scaled)),
             broken_mask_ignored=worst(kernels.din_attention_bwd_plain(q, k, torch.ones_like(m), *scaled[3:])),
             broken_alpha_dropped=worst(kernels.din_attention_bwd_plain(*scaled[:6], torch.zeros_like(alpha),
                                                                        sgp, sgs)),
             broken_single_tf32=worst(kernels.din_attention_bwd_unfolded(*scaled, products="1xtf32")))
    r["cotangent_scale"] = scale
    r["mask_can_matter"] = bool(gp.any()) or bool((gs * (1 - m)).any())
    r["gp_zero"], r["gs_zero"] = not bool(gp.any()), not bool(gs.any())
    first = kernels.din_attention_bwd_fused(*args)
    same = all(torch.equal(x, y) for x, y in zip(first, kernels.din_attention_bwd_fused(*args)))
    if out is not None:
        same = same and all(torch.equal(x, y) for x, y in zip(first, out))
    r["same_bits"] = same
    want = bwd_reference(kernels, *args)
    bound_ms, bound_by, bytes_ms, live = din_bwd_bound(args)
    rec = dict(name="din_attention_bwd", shape=[b, l, d, h], live_steps=live,
               max_abs_err=max(float((g - w).abs().max()) for g, w in zip(first, want)),
               ms=device_ms(torch, lambda: kernels.din_attention_bwd_fused(*args)),
               plain_ms=device_ms(torch, lambda: kernels.din_attention_bwd_plain(*args)),
               bound_ms=bound_ms, bound_by=bound_by, bytes_bound_ms=bytes_ms, library_ms=None, readings=r)
    return r, rec


def check_attention_readings(readings, label) -> None:
    """Every case within its limit and the same bits; the versions that
    ignore the mask (where the mask can matter) or drop the slopes above
    it, and the backward's single-TF32 products too. The forward's
    single-TF32 lin is printed, not required: a model's keys are small
    (DIEN's are GRU states in (-1, 1)), and lin's single-TF32 error there
    can lie within ``KERNEL_TOL``."""
    print(f"din attention on {label}'s own inputs (error / limit):", json.dumps(readings), flush=True)
    for name, r in readings.items():
        check(r["kernel"] <= 1.0, f"{label}: #4/#5 against the plain version at {name}: {r}")
        check(r["same_bits"], f"{label}: #4/#5 at {name}: two calls gave different bits")
        broken = ["broken_alpha_dropped"]
        if r.get("mask_can_matter", True):
            broken.append("broken_mask_ignored")
        if name.endswith("_bwd"):
            broken.append("broken_single_tf32")
        for version in broken:
            check(r[version] > 1.0, f"{label}: the check cannot tell a {version} version at {name}: {r}")


def check_step_attention(torch, kernels, info, case, batch, config=None, names=None):
    """Kernels #4 and #5 on a model's own inputs and cotangents (phase 14b):
    one bf16 dense step of ``case`` (``sequence_config(case)`` unless
    ``config`` is given; its DIN attentions ``names`` in launch order) with
    each launch recorded, then each launch held to its plain version
    (``attention_*_case``); DSIN's also with a session mask with holes, an
    all-zero row and a row live at its last session only. A DIEN
    attention (its scores only, so #5 gets gp = 0) is one named ``att``.
    Returns {name: record}."""
    from tpurec_torch.train.trainer import Trainer

    if names is None:
        names = ["att"] if case == "dien" else ["att_interest", "att_evolved"]
    trainer = Trainer(config or sequence_config(case), info)
    state = trainer.init_state(batch)
    fwd_rec, bwd_rec, calls = recorded_attention(kernels)
    with mock.patch.object(kernels, "din_attention_fused", fwd_rec), \
            mock.patch.object(kernels, "din_attention_bwd_fused", bwd_rec):
        trainer.train_step(state, trainer.device_batch(batch), trainer.metrics.init())
        torch.cuda.synchronize()
    del trainer, state
    n = len(names)
    check(len(calls["fwd"]) == len(calls["bwd"]) == n,
          f"{case}: the step launched #4 {len(calls['fwd'])} and #5 {len(calls['bwd'])} times, not {n}")
    gen = torch.Generator(device="cuda").manual_seed(14)
    readings, records = {}, {}
    for name, (args, out) in zip(names, calls["fwd"]):
        key = f"{case}_{name}"
        readings[key], records[key] = attention_fwd_case(torch, kernels, args, out)
        # the backward of this attention: the call whose keys are its keys
        bwd = [c for c in calls["bwd"] if torch.equal(c[0][1], args[1])]
        check(len(bwd) == 1, f"{key}: {len(bwd)} backward launches on its keys")
        bargs, bout = bwd[0]
        readings[f"{key}_bwd"], records[f"{key}_bwd"] = attention_bwd_case(torch, kernels, bargs, bout)
        if case == "dsin":
            holes = holey_mask(torch, gen, args[2])
            readings[f"{key}_holes"], _ = attention_fwd_case(torch, kernels, args[:2] + [holes] + args[3:])
            readings[f"{key}_holes_bwd"], _ = attention_bwd_case(torch, kernels,
                                                                 bargs[:2] + [holes] + bargs[3:])
        for k in (key, f"{key}_bwd"):
            print("kernel check:", json.dumps(records[k]), flush=True)
    check_attention_readings(readings, case)
    if names[-1].split(".")[-1] == "att":
        r = readings[f"{case}_{names[-1]}_bwd"]
        check(r["gp_zero"] and not r["gs_zero"], f"{case}: #5 did not get gp = 0 and a nonzero gs: {r}")
    return records


def run_sequence_models(torch, kernels, eu, workdir, card):
    """Phase 14a/14b: DIEN and DSIN served and trained dense at DIN's width,
    DIEN in the fused engine, #9 on its stream, the fp32 fused step against
    the dense one, #4 and #5 on both models' own inputs. Returns (records by
    kernel, launches by kernel and path)."""
    from tpurec_torch.train.trainer import Trainer

    info = din_info()
    batch = sequence_batch(info, TRAIN_BATCH, seed=1)
    evals = [sequence_batch(info, TRAIN_BATCH, seed=2 + i) for i in range(SEQ_EVAL_BATCHES)]
    launches = dict(din_attention={}, din_attention_bwd={}, fused_scatter_add={})
    for seed, case in enumerate(SEQUENCE):
        n = SEQ_ATTENTIONS[case]
        served = run_servable(torch, workdir, card, case, sequence_config(case).model, info, seed,
                              batch=sequence_batch(info, TRAIN_BATCH, seed=0))
        check(served["launches"]["din_attention"] == n, f"{case} predict launched {served['launches']}")
        launches["din_attention"][f"{case}_serving"] = served["launches"]["din_attention"]
        _, trained = run_training(torch, eu, card, case, sequence_config(case), info, batch=batch,
                                  extra=evaluate_extra(torch, case, evals))
        counts, ev = trained["launches"], trained["evaluate_launches"]
        want = dict(din_attention=n * FM_FAMILY_STEPS, din_attention_bwd=n * FM_FAMILY_STEPS)
        check(all(counts[k] == v for k, v in want.items()) and counts["fused_scatter_add"] == 0,
              f"{case} dense steps launched {counts}, expected {want}")
        check(ev["din_attention"] == n * SEQ_EVAL_BATCHES, f"{case} evaluate launched {ev}")
        launches["din_attention"][f"{case}_training"] = counts["din_attention"]
        launches["din_attention"][f"{case}_evaluate"] = ev["din_attention"]
        launches["din_attention_bwd"][f"{case}_training"] = counts["din_attention_bwd"]
    # DIEN in the fused engine: #9 once a step over its one table
    fused, trained = run_training(torch, eu, card, "dien", sequence_config("dien", "fused"), info, "fused",
                                  batch=batch)
    counts = trained["launches"]
    check(counts["fused_scatter_add"] == FM_FAMILY_STEPS and counts["din_attention"] == FM_FAMILY_STEPS
          and counts["din_attention_bwd"] == FM_FAMILY_STEPS, f"the fused dien steps launched {counts}")
    for name in launches:
        launches[name]["dien_fused_training"] = counts[name]
    records = dict(fused_scatter_add=check_step_scatter(
        torch, eu, Trainer(sequence_config("dien", "fused"), info), batch, ("dien_emb",), (32,)))
    gc.collect()
    torch.cuda.empty_cache()
    fused_vs_dense(torch, eu, lambda m: sequence_config("dien", m, "float32"), info, batch,
                   ("emb.embedding",), "dien")
    gc.collect()
    torch.cuda.empty_cache()
    attention = {}
    for case in SEQUENCE:
        attention.update(check_step_attention(torch, kernels, info, case, batch))
    records["din_attention"] = {k: v for k, v in attention.items() if v["name"] == "din_attention"}
    records["din_attention_bwd"] = {k: v for k, v in attention.items() if v["name"] == "din_attention_bwd"}
    return records, launches


def run_sdm(torch, kernels, eu, workdir, card):
    """Phase 14c: SDM over phase 9's MIND schema (two series, D=32, so
    behavior steps of 64; ``normalize_logits``), ``short_len`` 10, 2 LSTM
    layers, 2 heads: ``FM_FAMILY_STEPS`` bf16 dense in-batch-softmax steps,
    ``Servable.predict`` p50 at B=8192, and the offline index over phase 9's
    5,000 users and 20,000 items with SDM's user and item towers. No kernel
    runs: SDM has no DIN attention, capsule routing or fused lookup."""
    from tpurec_torch.serving import DictKVStore, OfflineIndexer
    from tpurec_torch.serving.export import Servable

    info = mind_info()
    batch = mind_batch(info, TRAIN_BATCH, seed=1)
    config = mind_train_config("bfloat16", "sdm", SDM_PARAMS)
    item_off, tag_off = info.offset_of("item_id"), info.offset_of("item_tag")

    def extra(trainer, state):
        servable = Servable(state.model)
        kernels.reset_launch_counts()
        outputs = servable.predict(batch)
        check(outputs["user_embedding"].shape == (TRAIN_BATCH, 64)
              and all(bool(torch.isfinite(v.float()).all()) for v in outputs.values()),
              f"sdm predict: {[(k, tuple(v.shape)) for k, v in outputs.items()]}")
        times = []
        for _ in range(12):
            t0 = time.perf_counter()
            servable.predict(batch)["user_embedding"].cpu()
            times.append((time.perf_counter() - t0) * 1e3)
        p50 = statistics.median(times[2:])
        ub = mind_batch(info, MIND_USERS, seed=5)
        user_profile = {f"u{j}": [int(ub["user_tag"][j]), ub["history"][j].tolist(),
                                  ub["history_tags"][j].tolist()] for j in range(MIND_USERS)}
        tags = np.random.default_rng(1).integers(0, 500, size=MIND_ITEMS)
        item_profile = {f"i{j}": [item_off + j, tag_off + int(tags[j])] for j in range(MIND_ITEMS)}

        def filled(part, extra_cols):
            b = next(iter(part.values())).shape[0]
            out = dict(part)
            for name, (value, width) in extra_cols.items():
                out[name] = torch.full((b, width) if width else (b,), value, device="cuda")
            return out

        # the user tower is predict's user embedding with a dummy target, the
        # item tower predict's item embedding with a dummy history
        def user_tower(part):
            return servable.predict(filled(part, dict(item_id=(item_off, 0), item_tag=(tag_off, 0))))[
                "user_embedding"]

        def item_tower(part):
            return servable.predict(filled(part, dict(user_tag=(0, 0), history=(item_off, 64),
                                                      history_tags=(tag_off, 64))))["item_embedding"]

        indexer = OfflineIndexer(user_tower, item_tower, user_profile, item_profile,
                                 ["user_tag", "history", "history_tags"], ["item_id", "item_tag"],
                                 batch_size=1024, device="cuda")
        kv = DictKVStore()
        t0 = time.perf_counter()
        indexer.run(os.path.join(workdir, "sdm_index"), kv_store=kv, topk=20, key_prefix="SDM")
        index_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        slate = kv.get("SDM_u0").split("\t")[0].split(",")
        check(len(kv) == MIND_USERS and len(slate) == 20, f"sdm index: {len(kv)} users, slate {slate}")
        return dict(predict_p50_ms=p50, predict_examples_per_s=TRAIN_BATCH / (p50 / 1e3),
                    index_seconds=index_s, index_users=len(kv), index_items=MIND_ITEMS,
                    predict_and_index_launches=path_launches(kernels, eu))

    _, result = run_training(torch, eu, card, "sdm", config, info, batch=batch, extra=extra)
    counts = {**result["launches"], **result["predict_and_index_launches"]}
    check(not any(result["launches"].values()) and not any(result["predict_and_index_launches"].values()),
          f"sdm launched {counts}")
    return result


def run_fibinetpp(torch, eu, workdir, card):
    """Phase 14d: FiBiNET++, MaskNet (serial, parallel) and ContextNet
    (pointwise, singlelayer) over phase 10's ``wide_and_deep`` schema
    (2,080,128 rows, 13 continuous columns) at the registry's widths, D=32:
    each served (export → load_servable → predict, the first 256 rows
    against the CPU, p50) and trained ``FM_FAMILY_STEPS`` bf16 dense steps
    with an ``evaluate`` pass. No kernel runs."""
    info = fm_family_info("fm_continuous")
    evals = [fm_family_batch(info, TRAIN_BATCH, seed=2 + i) for i in range(SEQ_EVAL_BATCHES)]
    for seed, (case, (name, params)) in enumerate(FIBINETPP.items()):
        served = run_servable(torch, workdir, card, case, experiment_config(name, params, 32).model, info, seed)
        _, trained = run_training(torch, eu, card, case, experiment_config(name, params, 32), info,
                                  extra=evaluate_extra(torch, case, evals))
        counts = dict(serving=served["launches"], training=trained["launches"],
                      evaluate=trained["evaluate_launches"])
        check(not any(v for c in counts.values() for v in c.values()), f"{case} launched {counts}")


def run_sequence_cli(torch, kernels, eu, workdir, card):
    """Phase 14e: ``cli synth``/``datagen --family sequence`` (phase 12's
    100,000 events, L=64; ``datagen`` writes each series' ``neg_<series>``)
    and ``cli train`` of DIEN for two epochs with export (bf16, D=32, the
    registry's widths): #4 and #5 at the key width of the two series side by
    side (64), #5 once a step, #4 once a step and once an eval batch, the
    eval AUC above 0.5. Returns (its launches by kernel, its result)."""
    from tpurec_torch import cli

    with mock.patch.dict(os.environ):
        os.environ.pop("TPUREC_PLATFORM", None)
        raw, data = os.path.join(workdir, "dien_raw"), os.path.join(workdir, "dien_data")
        stages = {}
        for name, argv in (
            ("synth_sequence", ["synth", "--family", "sequence", "--out", raw,
                                "--n-events", str(CLI_SEQUENCE_EVENTS)]),
            ("datagen_sequence", ["datagen", "--family", "sequence", "--raw", raw, "--out", data,
                                  "--max-seq-length", str(CLI_SEQ_LEN)]),
        ):
            t = time.perf_counter()
            cli.main(argv)
            stages[name] = time.perf_counter() - t
        config = cli_config(os.path.join(workdir, "cli_dien.json"), "dien", epochs=2)
        run_dir = os.path.join(workdir, "cli_dien")
        r = cli_train(torch, kernels, eu, card, "dien",
                      ["train", "--config", config, "--data", data, "--workdir", run_dir])
    stages["train_dien"] = r["seconds"]
    print("cli dien stage seconds:", json.dumps(dict(card=card, **stages)), flush=True)
    check(os.path.exists(os.path.join(run_dir, "export", "params.pt")), "dien: no export")
    check(r["eval"]["auc"] > 0.5, f"dien through the CLI: eval AUC {r['eval']}")
    check(r["launches"]["din_attention_bwd"] == r["steps"],
          f"dien: #5 launched {r['launches']['din_attention_bwd']} times in {r['steps']} steps")
    check(r["launches"]["din_attention"] == r["steps"] + r["eval_batches"],
          f"dien: #4 launched {r['launches']['din_attention']} times in {r['steps']} steps "
          f"and {r['eval_batches']} eval batches")
    check(r["launches"]["fused_scatter_add"] == 0, f"dien dense run launched {r['launches']}")
    return dict(din_attention=dict(cli_dien_training=r["launches"]["din_attention"]),
                din_attention_bwd=dict(cli_dien_training=r["launches"]["din_attention_bwd"])), r


def run_sequence(torch, kernels, eu, workdir, card):
    """Phase 14: DIEN and DSIN (with #4, #5 and, fused, #9 on their own
    inputs), SDM, the FiBiNET++ family and DIEN through the CLI. Returns
    (records by kernel and shape, launches by kernel and path, seconds by
    part)."""
    seconds = {}
    t = time.perf_counter()
    records, launches = run_sequence_models(torch, kernels, eu, workdir, card)
    seconds["14ab_dien_dsin"] = time.perf_counter() - t
    t = time.perf_counter()
    run_sdm(torch, kernels, eu, workdir, card)
    seconds["14c_sdm"] = time.perf_counter() - t
    t = time.perf_counter()
    run_fibinetpp(torch, eu, workdir, card)
    seconds["14d_fibinetpp"] = time.perf_counter() - t
    t = time.perf_counter()
    cli_launches, _ = run_sequence_cli(torch, kernels, eu, workdir, card)
    seconds["14e_cli_dien"] = time.perf_counter() - t
    for name, paths in cli_launches.items():
        launches[name].update(paths)
    print("phase 14 seconds:", json.dumps(seconds), flush=True)
    return records, launches, seconds


# ---------------------------------------------------------------------------
# phase 15: the long-sequence and DMR families (SIM, CAN, ETA, DMR, DMT,
# FinalMLP, SDIM)
LONG_SEQ = {
    # case: (registry name, params, loss); the registry's widths over phase
    # 6's DIN schema, DMT over phase 9's two aligned series; ETA with its LSH
    # self-attention (at L = 64 only: its (B, L, L) mask is 32 GB at 1,024)
    "sim": ("sim", dict(DIN_FEATURES), "gsu_esu"),
    "can": ("can", dict(DIN_FEATURES), "gsu_esu"),
    "eta": ("eta", dict(DIN_FEATURES, lsh_self_attention=True), "gsu_esu"),
    "dmr": ("dmr", dict(DIN_FEATURES), "bce"),
    "sdim": ("sdim", dict(DIN_FEATURES), "gsu_esu"),
    "dmt": ("dmt", {}, "multi_task"),
}
# the fused engine's cases: (model params, #9's launches in a step by table,
# their widths, the tables ``check_step_scatter`` and ``fused_vs_dense``
# read, or None for neither, the launches whose broken versions must be held)
LONG_SEQ_FUSED = {
    "can": ({}, ("can_emb", "can_induction"), (32, 152), ("emb.embedding", "induction_emb_item_id.embedding"),
            ("can_induction",)),
    "sim_trunk": (dict(use_dien_trunk=True), ("sim_emb", "sim_trunk_emb"), (32, 32),
                  ("emb.embedding", "trunk.emb.embedding"), ()),
    "eta": ({}, ("eta_emb",), (32,), None, ()),
}
LONG_HISTORY = 1024  # top-16 of 1,024 steps, what the search stages are for
LONG_HISTORY_CASES = {"sim": {}, "eta": dict(lsh_self_attention=False), "sdim": {}}
# a SimHash bit may differ card against CPU only where its product lies this
# close to 0 on the CPU (fp32 sums in two orders); rows with such a flip are
# left out of the comparison, at most MAX_FLIPPED_ROWS of the 256
SIGN_MARGIN = 1e-5
MAX_FLIPPED_ROWS = 2
SKETCH_USERS = 256
SKETCH_ATOL = 1e-6  # the store's fp32 sum-then-divide against the pool's weighted sum


def long_seq_config(case, mode="dense", dtype="bfloat16", freeze=(), **params):
    name, base, loss = LONG_SEQ[case]
    return experiment_config(name, dict(base, **params), 32, mode, dtype, loss=loss,
                             freeze_prefixes=tuple(freeze))


def long_seq_data(case, seq_len=64):
    """(schema, batch maker ``make(size, seed)``): DIN's schema with a
    ``seq_len``-step history and ``bench_batch``'s lengths in [L/4, L], or
    for DMT phase 9's MIND schema and batch with seeded ``ctr``/``cvr``."""
    if case != "dmt":
        info = dataclasses.replace(din_info(), max_seq_length=seq_len)
        return info, lambda size, seed: bench_batch(info, size, seq_len, seed=seed)
    info = mind_info()

    def make(size, seed):
        batch = mind_batch(info, size, seed)
        rng = np.random.default_rng(seed + 4000)
        batch["ctr"] = (rng.random(size) < 0.3).astype(np.float32)
        batch["cvr"] = (batch["ctr"] * (rng.random(size) < 0.3)).astype(np.float32)
        return batch

    return info, make


def recorded_bits(fn):
    """Run ``fn()`` with the port's ``simhash_bits`` recorded where the
    models call it: (its result, each call's (x, projection, bits))."""
    from tpurec_torch.ops import hashing

    simhash = hashing.simhash_bits
    calls = []

    def recorded(x, projection):
        bits = simhash(x, projection)
        calls.append((x, projection, bits))
        return bits

    with mock.patch.object(hashing, "simhash_bits", recorded), \
            mock.patch("tpurec_torch.models.sim.simhash_bits", recorded):
        return fn(), calls


def bit_flips(torch, card_calls, cpu_calls) -> dict:
    """One forward's SimHash bits on the card against the CPU's: the flips,
    each of which must be a product within ``SIGN_MARGIN`` of 0 on the CPU
    (in fp64), the batch rows they touch, the smallest |x·p| on the CPU."""
    check(len(card_calls) == len(cpu_calls), f"{len(card_calls)} SimHash calls on the card, "
                                             f"{len(cpu_calls)} on the CPU")
    flips, rows, smallest, widest = 0, set(), None, 0.0
    for (_, _, got), (x, proj, want) in zip(card_calls, cpu_calls):
        products = torch.einsum("...d,db->...b", x.double(), proj.double()).abs()
        low = float(products.min())
        smallest = low if smallest is None else min(smallest, low)
        flipped = got.cpu() != want
        if flipped.any():
            flips += int(flipped.sum())
            widest = max(widest, float(products[flipped].max()))
            rows |= set(flipped.reshape(flipped.shape[0], -1).any(dim=-1).nonzero()[:, 0].tolist())
    out = dict(calls=len(cpu_calls), bits=sum(c[2].numel() for c in cpu_calls), flips=flips,
               flipped_rows=sorted(rows), smallest_cpu_product=smallest, widest_flipped_product=widest,
               margin=SIGN_MARGIN)
    check(widest < SIGN_MARGIN, f"a SimHash bit flipped card against CPU beyond the margin: {out}")
    check(len(rows) <= MAX_FLIPPED_ROWS, f"SimHash flips on more than {MAX_FLIPPED_ROWS} rows: {out}")
    return out


def long_seq_compare(torch):
    """``run_servable``'s ``cpu_check`` for this phase: the 256 rows'
    predict on the card and on the CPU with their SimHash bits recorded
    (``bit_flips``); on the rows without a flip every float output within
    ``FM_FAMILY_RTOL`` of its largest |value| and ``topk_indices`` equal."""

    def compare(servable, cpu_servable, rows, _scale):
        card_out, card_calls = recorded_bits(lambda: servable.predict(rows))
        cpu_out, cpu_calls = recorded_bits(lambda: cpu_servable.predict(rows))
        flips = bit_flips(torch, card_calls, cpu_calls)
        keep = torch.ones(next(iter(rows.values())).shape[0], dtype=torch.bool)
        keep[flips["flipped_rows"]] = False
        readings = {}
        for key, want in cpu_out.items():
            got, want = card_out[key].cpu()[keep], want[keep]
            if key == "topk_indices":
                readings[key] = 0.0 if torch.equal(got, want) else float("inf")
            else:
                limit = FM_FAMILY_RTOL * max(float(want.float().abs().max()), 1e-30)
                readings[key] = float((got.float() - want.float()).abs().max()) / limit
        return readings, dict(simhash=flips, rows_compared=int(keep.sum()))

    return compare


def run_long_seq_models(torch, eu, workdir, card):
    """Phase 15a: sim, can, eta, dmr, sdim and dmt served (export →
    load_servable → predict, the 256 rows against the CPU with
    ``long_seq_compare``, p50) and trained ``FM_FAMILY_STEPS`` bf16 dense
    steps with an ``evaluate`` pass; finalmlp over phase 10's
    ``wide_and_deep`` schema the same way (its logit against the CPU). No
    kernel runs: without the DIEN trunk these models have no DIN attention,
    and the dense engine no #9."""
    for seed, case in enumerate(LONG_SEQ):
        info, make = long_seq_data(case)
        served = run_servable(torch, workdir, card, case, long_seq_config(case).model, info, seed,
                              batch=make(TRAIN_BATCH, 0), cpu_check=long_seq_compare(torch))
        evals = [make(TRAIN_BATCH, 2 + i) for i in range(SEQ_EVAL_BATCHES)]
        _, trained = run_training(torch, eu, card, case, long_seq_config(case), info, batch=make(TRAIN_BATCH, 1),
                                  extra=evaluate_extra(torch, case, evals))
        counts = dict(serving=served["launches"], training=trained["launches"],
                      evaluate=trained["evaluate_launches"])
        check(not any(v for c in counts.values() for v in c.values()), f"{case} launched {counts}")
    info = fm_family_info("fm_continuous")
    config = experiment_config("finalmlp", {}, 32)
    served = run_servable(torch, workdir, card, "finalmlp", config.model, info, len(LONG_SEQ))
    evals = [fm_family_batch(info, TRAIN_BATCH, seed=2 + i) for i in range(SEQ_EVAL_BATCHES)]
    _, trained = run_training(torch, eu, card, "finalmlp", config, info, extra=evaluate_extra(torch, "finalmlp", evals))
    counts = dict(serving=served["launches"], training=trained["launches"], evaluate=trained["evaluate_launches"])
    check(not any(v for c in counts.values() for v in c.values()), f"finalmlp launched {counts}")


def run_dien_trunk(torch, kernels, eu, workdir, card):
    """Phase 15b, ``tests/test_freeze_compose.py``'s recipe at DIN's width:
    DIEN takes 3 bf16 steps and is exported; sim and can with
    ``use_dien_trunk`` graft it under ``trunk`` (``init_subtree_from_export``)
    and take ``FM_FAMILY_STEPS`` steps with ``freeze_prefixes=('trunk',)``:
    #4 once a step, #5 never, the trunk's parameters the export's bytes.
    Then both served with the trunk (#4 once a predict) and trained
    unfrozen (#4 and #5 once a step, #4 once an eval batch), and #4 and #5
    held to their plain versions on each model's own recorded inputs and
    cotangents (``check_step_attention``; #5 gets gp = 0). Returns
    (records by kernel, launches by kernel and path)."""
    from tpurec_torch.train.trainer import Trainer

    info, make = long_seq_data("sim")
    batch = make(TRAIN_BATCH, 1)
    dien = Trainer(sequence_config("dien"), info)
    state = dien.init_state(batch)
    dbatch = dien.device_batch(batch)
    for _ in range(3):
        state, _, _ = dien.train_step(state, dbatch, dien.metrics.init())
    export_dir = os.path.join(workdir, "dien_trunk_export")
    dien.export(state, export_dir)
    exported = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    del dien, state, dbatch
    launches = dict(din_attention={}, din_attention_bwd={})
    for case in ("sim", "can"):
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(long_seq_config(case, freeze=("trunk",), use_dien_trunk=True), info)
        state = trainer.init_subtree_from_export(trainer.init_state(batch), export_dir, "trunk")
        check(all(torch.equal(v, exported[k]) for k, v in state.model.trunk.named_parameters()),
              f"{case}: the grafted trunk is not the export")
        dbatch = trainer.device_batch(batch)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        state, _, losses = train_steps(trainer, state, dbatch, steps=FM_FAMILY_STEPS)
        counts = path_launches(kernels, eu)
        moved = [k for k, v in state.model.trunk.named_parameters() if not torch.equal(v, exported[k])]
        print(f"{case} frozen dien trunk training:", json.dumps(dict(
            card=card, model=case, batch=TRAIN_BATCH, steps=FM_FAMILY_STEPS,
            peak_mem_gb=(torch.cuda.max_memory_allocated() - base) / 2**30, loss_first=losses[0], loss_last=losses[-1],
            launches=counts, trunk_moved=moved)), flush=True)
        check(counts["din_attention"] == FM_FAMILY_STEPS and counts["din_attention_bwd"] == 0
              and counts["fused_scatter_add"] == 0, f"{case} with the frozen trunk launched {counts}")
        check(not moved, f"{case}: frozen trunk parameters moved: {moved}")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"{case} frozen trunk losses {losses}")
        for name in launches:
            launches[name][f"{case}_frozen_trunk_training"] = counts[name]
        del trainer, state, dbatch
    evals = [make(TRAIN_BATCH, 2 + i) for i in range(SEQ_EVAL_BATCHES)]
    records = {}
    for seed, case in enumerate(("sim", "can")):
        config = long_seq_config(case, use_dien_trunk=True)
        served = run_servable(torch, workdir, card, f"{case}_trunk", config.model, info, 30 + seed,
                              batch=make(TRAIN_BATCH, 0), cpu_check=long_seq_compare(torch))
        check(served["launches"]["din_attention"] == 1, f"{case} with the trunk: predict launched {served['launches']}")
        _, trained = run_training(torch, eu, card, f"{case}_trunk", config, info, batch=batch,
                                  extra=evaluate_extra(torch, f"{case}_trunk", evals))
        counts, ev = trained["launches"], trained["evaluate_launches"]
        check(counts["din_attention"] == counts["din_attention_bwd"] == FM_FAMILY_STEPS
              and counts["fused_scatter_add"] == 0, f"{case} with the trunk: dense steps launched {counts}")
        check(ev["din_attention"] == SEQ_EVAL_BATCHES, f"{case} with the trunk: evaluate launched {ev}")
        launches["din_attention"].update({f"{case}_trunk_serving": 1, f"{case}_trunk_training": FM_FAMILY_STEPS,
                                          f"{case}_trunk_evaluate": ev["din_attention"]})
        launches["din_attention_bwd"][f"{case}_trunk_training"] = FM_FAMILY_STEPS
        gc.collect()
        torch.cuda.empty_cache()
        records.update(check_step_attention(torch, kernels, info, case, batch, config=config, names=["trunk.att"]))
    by_kernel = {name: {k: v for k, v in records.items() if v["name"] == name}
                 for name in ("din_attention", "din_attention_bwd")}
    return by_kernel, launches


def run_long_seq_fused(torch, kernels, eu, card):
    """Phase 15c: can, sim with its DIEN trunk and eta ``FM_FAMILY_STEPS``
    bf16 steps in the fused engine (#9 once per table a step: CAN's
    induction table is 152 wide, SIM's trunk has a table of its own; the
    trunk's #4 and #5 once a step); #9 held to its plain version on CAN's
    and SIM's own streams (``check_step_scatter``), and their fp32 fused
    steps against their dense ones (``fused_vs_dense``). Returns (#9's
    records, launches by kernel and path)."""
    from tpurec_torch.train.trainer import Trainer

    info, make = long_seq_data("sim")
    batch = make(TRAIN_BATCH, 1)
    records = {}
    launches = dict(din_attention={}, din_attention_bwd={}, fused_scatter_add={})
    for case, (params, tables, widths, checked, carried) in LONG_SEQ_FUSED.items():
        base = case.split("_")[0]
        config = long_seq_config(base, "fused", **params)
        fused, trained = run_training(torch, eu, card, case, config, info, "fused", batch=batch)
        counts = trained["launches"]
        attentions = FM_FAMILY_STEPS if params.get("use_dien_trunk") else 0
        check(fused == len(tables) * FM_FAMILY_STEPS and counts["din_attention"] == attentions
              and counts["din_attention_bwd"] == attentions, f"the fused {case} steps launched {counts}")
        launches["fused_scatter_add"][f"{case}_fused_training"] = fused
        if attentions:
            for name in ("din_attention", "din_attention_bwd"):
                launches[name][f"{case}_fused_training"] = counts[name]
        if checked:
            records.update(check_step_scatter(torch, eu, Trainer(config, info), batch, tables, widths, carried))
            gc.collect()
            torch.cuda.empty_cache()
            fused_vs_dense(torch, eu, lambda m, b=base, p=params: long_seq_config(b, m, "float32", **p), info,
                           batch, checked, case)
        gc.collect()
        torch.cuda.empty_cache()
    return records, launches


def run_long_history(torch, eu, workdir, card):
    """Phase 15d: sim, eta (no LSH self-attention) and sdim over a
    ``LONG_HISTORY``-step history: served as 15a (the 256 rows against the
    CPU), ``FM_FAMILY_STEPS`` bf16 dense steps with their peak memory. No
    kernel runs."""
    for seed, (case, params) in enumerate(LONG_HISTORY_CASES.items()):
        info, make = long_seq_data(case, LONG_HISTORY)
        config = long_seq_config(case, **params)
        label = f"{case}_l{LONG_HISTORY}"
        served = run_servable(torch, workdir, card, label, config.model, info, 40 + seed,
                              batch=make(TRAIN_BATCH, 0), cpu_check=long_seq_compare(torch))
        _, trained = run_training(torch, eu, card, label, config, info, batch=make(TRAIN_BATCH, 1))
        counts = dict(serving=served["launches"], training=trained["launches"])
        check(not any(v for c in counts.values() for v in c.values()), f"{label} launched {counts}")
        gc.collect()
        torch.cuda.empty_cache()


def check_sketch_store(torch, card):
    """Phase 15e: a ``SketchStore`` with SDIM's own projections, filled with
    the card's history embeddings of ``SKETCH_USERS`` users (their valid
    steps) of an fp32 SDIM at DIN's width; its ``query`` with each user's
    target embedding against the model's ``long_term_interest`` for those
    rows (``SKETCH_ATOL``). The store takes its buckets in numpy: a user
    whose bits there differ from the card's forward is left out and
    counted, each such bit a product within ``SIGN_MARGIN`` of 0."""
    from tpurec_torch.models import build_model
    from tpurec_torch.serving.sketch_store import SketchStore

    info, make = long_seq_data("sdim")
    model = build_model(long_seq_config("sdim").model, info, device="cuda", seed=5).eval()
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in make(SKETCH_USERS, 6).items() if k != "label"}
    with torch.inference_mode():
        out, calls = recorded_bits(lambda: model(batch))
        keys = model.emb(batch["history"]).float().cpu().numpy()
        query = model.emb(batch["item_id"]).float().cpu().numpy()
    want = out["long_term_interest"].cpu().numpy()
    live = batch["history"].cpu().numpy() != 0
    proj = model.hash_projections.cpu().numpy()
    # the forward hashes the keys, then the query, in each group in turn
    check(len(calls) == 2 * proj.shape[0], f"sdim: {len(calls)} SimHash calls for {proj.shape[0]} groups")
    flipped, widest = set(), 0.0
    for g in range(proj.shape[0]):
        for x, (_, _, card_bits) in ((keys, calls[2 * g]), (query, calls[2 * g + 1])):
            products = x.astype(np.float64) @ proj[g].astype(np.float64)
            differ = ((x @ proj[g] > 0) != card_bits.cpu().numpy().astype(bool))
            if x.ndim == 3:
                differ &= live[..., None]
            if differ.any():
                widest = max(widest, float(np.abs(products[differ]).max()))
                flipped |= set(np.nonzero(differ.reshape(SKETCH_USERS, -1).any(axis=-1))[0].tolist())
    store = SketchStore(proj)
    errs = []
    for u in range(SKETCH_USERS):
        if u in flipped:
            continue
        store.update(f"u{u}", keys[u][live[u]])
        errs.append(float(np.abs(store.query(f"u{u}", query[u]) - want[u]).max()))
    result = dict(card=card, users=SKETCH_USERS, groups=proj.shape[0], bits=proj.shape[2],
                  flipped_users=sorted(flipped), widest_flipped_product=widest, margin=SIGN_MARGIN,
                  compared=len(errs), max_abs_err=max(errs), limit=SKETCH_ATOL,
                  mean_abs_interest=float(np.abs(want).mean()))
    print("sdim sketch store against long_term_interest:", json.dumps(result), flush=True)
    check(widest < SIGN_MARGIN and len(flipped) <= MAX_FLIPPED_ROWS and max(errs) <= SKETCH_ATOL,
          f"sketch store: {result}")
    return result


def run_long_seq(torch, kernels, eu, workdir, card):
    """Phase 15: the seven models served and trained (15a), the DIEN trunk
    grafted, frozen and unfrozen with #4 and #5 on its own inputs (15b), the
    fused engine with #9 on CAN's and SIM's streams (15c), a 1,024-step
    history (15d) and the sketch store (15e). Returns (records by kernel
    and shape, launches by kernel and path, seconds by part)."""
    seconds = {}
    records = dict(din_attention={}, din_attention_bwd={}, fused_scatter_add={})
    launches = dict(din_attention={}, din_attention_bwd={}, fused_scatter_add={})

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    part("15a_models", run_long_seq_models, torch, eu, workdir, card)
    trunk_records, trunk_launches = part("15b_dien_trunk", run_dien_trunk, torch, kernels, eu, workdir, card)
    fused_records, fused_launches = part("15c_fused", run_long_seq_fused, torch, kernels, eu, card)
    part("15d_long_history", run_long_history, torch, eu, workdir, card)
    part("15e_sketch_store", check_sketch_store, torch, card)
    for name in ("din_attention", "din_attention_bwd"):
        records[name].update(trunk_records[name])
    records["fused_scatter_add"].update(fused_records)
    for source in (trunk_launches, fused_launches):
        for name, paths in source.items():
            launches[name].update(paths)
    print("phase 15 seconds:", json.dumps(seconds), flush=True)
    return records, launches, seconds


# ---------------------------------------------------------------------------
# phase 16: the mesh, its ranks processes of this script on the one card
MESH_STEPS = 10  # timed bf16 steps of each mesh run
MESH_FP32_STEPS = 4  # fp32 steps held against the one-device run
MESH_TIMEOUT = 420  # seconds a world may take, from its start to its last rank's end
MESH_LOSS_TOL = dict(rtol=2e-4, atol=2e-5)  # the CPU mesh tests' (tests/test_torch_mesh_train.py)
MESH_PARAM_TOL = dict(rtol=5e-3, atol=5e-5)
MESH_GROUPLESS_TOL = 1e-6  # world of one against no world: the same launches on the same card
CP_SHAPE = (8192, 1024, 32, 36)  # B, L, D, H of din_attention_cp over model = 4
CP_CHUNK = 512  # rows of the fp64 plain reference at a time
MESH_2X2 = dict(data=2, model=2)
MESH_4X1 = dict(data=4, model=1)
MESH_SAMPLED = 64  # MIND's sampled negatives a row on (4, 1)
MESH_FUSED_STEPS = 4  # DIEN's bf16 fused steps on (4, 1)


def mesh_batches(info, n, seq_len=64, seed=160):
    return [bench_batch(info, TRAIN_BATCH, seq_len, seed=seed + i) for i in range(n)]


def on_mesh(config, **mesh):
    from tpurec_torch.config import MeshConfig

    return config.replace(mesh=MeshConfig(**mesh))


def mesh_steps(trainer, state, batches, terms=None):
    """One step per batch: (state, losses, metric results); each step's
    logged terms appended to ``terms`` when it is a list."""
    metric_state = trainer.metrics.init()
    losses = []
    for b in batches:
        state, metric_state, logs = trainer.train_step(state, trainer.device_batch(b), metric_state)
        losses.append(float(logs["loss"]))
        if terms is not None:
            terms.append({k: float(v) for k, v in logs.items()})
    results = {k: float(v) for k, v in trainer.metrics.result(metric_state).items()}
    return state, losses, results


def whole_params(model) -> dict:
    """Every parameter on the CPU, tables and tensor-parallel weights whole
    (gathered over 'model')."""
    from tpurec_torch.train.trainer import whole_tensors

    return {n: t.cpu() for n, t in whole_tensors(model).items()}


def param_reading(torch, got, want, tol) -> dict:
    """Worst parameter over the rows both have, in units of ``tol``
    (|got − want| / (atol + rtol·|want|); at most 1 passes)."""
    worst, name = 0.0, None
    for n, w in want.items():
        g = got[n]
        if g.dim():
            rows = min(g.shape[0], w.shape[0])
            g, w = g[:rows], w[:rows]
        r = tol_ratio(g.double(), w.double(), **tol)
        if r >= worst:
            worst, name = r, n
    return dict(param=worst, param_worst=name)


def mesh_world(torch, world, size, directory) -> list:
    """Start ``size`` ranks of this script (``--mesh-rank``), each a fresh
    interpreter, and wait for them under ``MESH_TIMEOUT``. A rank that
    fails (the others then wait in a collective: they are killed at once)
    or is still running at the limit fails the phase. Returns each rank's
    result."""
    logs = [os.path.join(directory, f"{world}_{rank}.log") for rank in range(size)]
    procs = []
    for rank, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-rank", world, str(rank),
                 str(size), directory], stdout=f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + MESH_TIMEOUT
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            print(f"world {world} rank {rank} (exit {p.returncode}) output:\n"
                  f"{open(log).read()[-6000:]}", flush=True)
    for rank, p in enumerate(procs):
        check(p.returncode == 0, f"world {world}: rank {rank} exited {p.returncode} "
                                 f"(killed if negative: at {MESH_TIMEOUT} s, or after another rank failed)")
    out = []
    for rank in range(size):
        with open(os.path.join(directory, f"{world}_{rank}.json")) as f:
            out.append(json.load(f))
    return out


def mesh_dryrun(torch, kernels, eu, n) -> dict:
    """``dryrun_multichip(n)`` in this rank's world: one DIN step (D=8) in
    the dense (its MLP tensor parallel on model = 2), ``rowwise_adam`` and
    ``fused_adam`` engines, each with its own asserts; #4 and #5 once in
    each step, #9 once in the fused one."""
    from tpurec_torch.dryrun import dryrun_multichip

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = dryrun_multichip(n, "cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = path_launches(kernels, eu)
    check(counts["din_attention"] == counts["din_attention_bwd"] == 3
          and counts["fused_scatter_add"] == 1,
          f"dryrun_multichip({n}): #4/#5 not once a step or #9 not once in the fused step: {counts}")
    check(all(np.isfinite(v) for v in losses.values()), f"dryrun_multichip({n}): {losses}")
    return dict(losses=losses, launches=counts, seconds=seconds)


def mesh_world_one(torch, kernels, eu, directory) -> dict:
    """16a, in the one rank of an NCCL world: DIN dense bf16 over the (1, 1)
    mesh its config gives, then ``dryrun_multichip(1)``."""
    import torch.distributed as dist

    from tpurec_torch.train.trainer import Trainer

    x = torch.ones(4, device="cuda")
    dist.all_reduce(x)  # the communicator carries a sum
    check(float(x.sum()) == 4.0, f"NCCL world of one: all_reduce gave {x.tolist()}")
    info = din_info()
    batches = mesh_batches(info, MESH_STEPS)
    trainer = Trainer(din_train_config("bfloat16"), info)
    check(trainer.mesh_ctx.n_devices == 1, f"world of one: mesh {trainer.mesh_ctx}")
    state = trainer.init_state(batches[0])
    kernels.reset_launch_counts()
    state, losses, results = mesh_steps(trainer, state, batches)
    counts = path_launches(kernels, eu)
    torch.save(whole_params(state.model), os.path.join(directory, "nccl1_params.pt"))
    del trainer, state
    return dict(losses=losses, results=results, launches=counts,
                dryrun=mesh_dryrun(torch, kernels, eu, 1))


def mesh_din(torch, kernels, eu, directory) -> dict:
    """16b's DIN: fp32 steps against the one-device run, then timed bf16
    steps, then #4 and #5 on the rank's own inputs."""
    from tpurec_torch.train.trainer import Trainer

    info = din_info()
    batches = mesh_batches(info, MESH_STEPS)
    trainer = Trainer(on_mesh(din_train_config("float32"), **MESH_2X2), info)
    state = trainer.init_state(batches[0])
    # the top MLP (200, 80) tensor parallel over model = 2
    mlp = state.model.mlp
    tp = {n: list(p.shape) for n, p in mlp.named_parameters()}
    width_in = tp["dense_0.weight"][1]
    check(mlp.dense_0.split == "column" and mlp.dense_1.split == "row"
          and tp == {"dense_0.weight": [100, width_in], "dense_0.bias": [100],
                     "dense_1.weight": [80, 100], "dense_1.bias": [80]},
          f"DIN's mlp on (2, 2) not tensor parallel: {tp}")
    state, losses, results = mesh_steps(trainer, state, batches[:MESH_FP32_STEPS])
    ref = torch.load(os.path.join(directory, "din_fp32_ref.pt"))
    loss_err = max(tol_ratio(torch.tensor(losses, dtype=torch.float64),
                             torch.tensor(ref["losses"], dtype=torch.float64), **MESH_LOSS_TOL),
                   tol_ratio(torch.tensor(results["auc"]), torch.tensor(ref["results"]["auc"]),
                             atol=1e-6, rtol=0))
    reading = dict(loss=loss_err, **param_reading(torch, whole_params(state.model), ref["params"],
                                                  MESH_PARAM_TOL))
    check(reading["loss"] <= 1.0 and reading["param"] <= 1.0,
          f"DIN on (2, 2) against one device, fp32: {reading} (losses {losses} vs {ref['losses']})")
    del trainer, state
    trainer = Trainer(on_mesh(din_train_config("bfloat16"), **MESH_2X2), info)
    state = trainer.init_state(batches[0])
    kernels.reset_launch_counts()
    state, bf16_losses, _ = mesh_steps(trainer, state, batches)
    counts = path_launches(kernels, eu)
    check(counts["din_attention"] == counts["din_attention_bwd"] == MESH_STEPS,
          f"DIN on (2, 2): #4/#5 not once a step on this rank: {counts}")
    check(all(np.isfinite(bf16_losses)), f"DIN on (2, 2): non-finite losses {bf16_losses}")
    # #4 and #5 on this rank's own inputs of one bf16 step
    fwd_rec, bwd_rec, calls = recorded_attention(kernels)
    with mock.patch.object(kernels, "din_attention_fused", fwd_rec), \
            mock.patch.object(kernels, "din_attention_bwd_fused", bwd_rec):
        trainer.train_step(state, trainer.device_batch(batches[0]), trainer.metrics.init())
        torch.cuda.synchronize()
    check(len(calls["fwd"]) == len(calls["bwd"]) == 1, "DIN on (2, 2): one #4 and one #5 a step")
    (args, out), (bargs, bout) = calls["fwd"][0], calls["bwd"][0]
    check(args[1].shape[0] == TRAIN_BATCH // 2, f"#4 on a data rank's {args[1].shape[0]} rows")
    readings, records = {}, {}
    readings["din_2x2"], records["din_2x2"] = attention_fwd_case(torch, kernels, args, out)
    readings["din_2x2_bwd"], records["din_2x2_bwd"] = attention_bwd_case(torch, kernels, bargs, bout)
    check_attention_readings(readings, "din on (2, 2)")
    return dict(fp32_losses=losses, fp32_reading=reading, bf16_losses=bf16_losses,
                launches=counts, attention=records, mlp_shares=tp)


def mesh_fm(torch, kernels, eu) -> dict:
    """16b's FM over the 2.08M-row table in the fused engine on (2, 2)."""
    from tpurec_torch.train.trainer import Trainer

    info = fm_info()
    batches = [bench_batch(info, TRAIN_BATCH, 0, seed=161 + i) for i in range(MESH_STEPS)]
    from tpurec_torch.embedding.modules import embedding_tables

    trainer = Trainer(on_mesh(fm_train_config("fused"), **MESH_2X2), info)
    state = trainer.init_state(batches[0])
    rows = [t.embedding.shape[0] for t in embedding_tables(state.model)]
    kernels.reset_launch_counts()
    state, losses, _ = mesh_steps(trainer, state, batches)
    counts = path_launches(kernels, eu)
    check(counts["fused_scatter_add"] == 2 * MESH_STEPS,
          f"FM fused on (2, 2): #9 not twice a step on this rank: {counts}")
    check(all(np.isfinite(losses)), f"FM fused on (2, 2): non-finite losses {losses}")
    del trainer, state
    scatter = check_step_scatter(torch, eu, Trainer(on_mesh(fm_train_config("fused"), **MESH_2X2), info),
                                 batches[0], ("fm_w_2x2", "fm_v_2x2"), (1, 32))
    reading = fused_vs_dense(torch, eu, lambda m: on_mesh(fm_train_config(m, "float32"), **MESH_2X2),
                             info, batches[0], FM_TABLES, "fm on (2, 2)")
    return dict(rows_per_rank=rows, losses=losses, launches=counts, scatter=scatter,
                fused_vs_dense=reading)


def fm_rowwise_batches():
    return [bench_batch(fm_info(), TRAIN_BATCH, 0, seed=171 + i) for i in range(MESH_FP32_STEPS)]


def fm_rowwise_state(state) -> dict:
    """FM's tables and their row-wise Adam state, whole, on the CPU."""
    from tpurec_torch.embedding.modules import embedding_tables
    from tpurec_torch.train.trainer import _table_names

    tables = dict(zip(_table_names(state.model), embedding_tables(state.model)))
    return {f"{n}.{f}": tables[n].whole(v).cpu() for n, st in state.table_opt.items()
            for f, v in st._asdict().items()}


def mesh_fm_rowwise(torch, directory) -> dict:
    """16b's FM over the 2.08M-row table in ``rowwise_adam`` on (2, 2):
    each rank holds half the rows of each table and of its state;
    ``MESH_FP32_STEPS`` fp32 steps against this process's one-device run
    of the same global batches."""
    from tpurec_torch.embedding.modules import embedding_tables
    from tpurec_torch.train.trainer import Trainer

    info = fm_info()
    trainer = Trainer(on_mesh(fm_train_config("sparse", "float32"), **MESH_2X2), info)
    state = trainer.init_state()
    rows = {n: [list(t.embedding.shape), {f: list(v.shape) for f, v in st._asdict().items()}]
            for t, (n, st) in zip(embedding_tables(state.model), state.table_opt.items())}
    whole = {n: t.whole(t.embedding).shape[0] for n, t in
             zip(state.table_opt, embedding_tables(state.model))}
    check(all(r[0][0] * 2 == whole[n] and all(s[0] == r[0][0] for s in r[1].values())
              for n, r in rows.items()), f"FM rowwise_adam on (2, 2): rows not split: {rows}")
    state, losses, results = mesh_steps(trainer, state, fm_rowwise_batches())
    ref = torch.load(os.path.join(directory, "fm_rowwise_ref.pt"))
    loss_err = max(tol_ratio(torch.tensor(losses, dtype=torch.float64),
                             torch.tensor(ref["losses"], dtype=torch.float64), **MESH_LOSS_TOL),
                   tol_ratio(torch.tensor(results["auc"]), torch.tensor(ref["results"]["auc"]),
                             atol=1e-6, rtol=0))
    reading = dict(loss=loss_err,
                   **param_reading(torch, whole_params(state.model), ref["params"], MESH_PARAM_TOL),
                   **{f"state_{k}": v for k, v in param_reading(
                       torch, fm_rowwise_state(state), ref["state"], MESH_PARAM_TOL).items()})
    check(max(reading["loss"], reading["param"], reading["state_param"]) <= 1.0,
          f"FM rowwise_adam on (2, 2) against one device, fp32: {reading} "
          f"(losses {losses} vs {ref['losses']})")
    return dict(rows_per_rank=rows, losses=losses, reading=reading)


def mesh_cp(torch, kernels, eu) -> dict:
    """16b's ``din_attention_cp`` at ``CP_SHAPE`` over model = 4 against the
    one-device plain version in fp64, a chunk of rows at a time."""
    from tpurec_torch.config import MeshConfig
    from tpurec_torch.core.mesh import make_mesh
    from tpurec_torch.ops.attention_cp import din_attention_cp

    mesh = make_mesh(MeshConfig(data=1, model=4))
    b, l, d, h = CP_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(16)
    q, keys, mask, w1, b1, w2, alpha = din_inputs(torch, gen, b, l, d, h)
    cot_p = torch.randn(b, d, device="cuda", generator=gen)
    cot_s = torch.randn(b, l, device="cuda", generator=gen)
    lk = l // mesh.n_model
    steps = slice(mesh.model_index * lk, (mesh.model_index + 1) * lk)
    leaves = [t.clone().requires_grad_() for t in (q, w1, b1, w2, alpha)]
    k_loc = keys[:, steps].contiguous().requires_grad_()
    m_loc = mask[:, steps].contiguous()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    pooled, scores = din_attention_cp(leaves[0], k_loc, m_loc, *leaves[1:], mesh)
    ((pooled * cot_p).sum() + (scores * cot_s[:, steps]).sum()).backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = path_launches(kernels, eu)
    local_pooled = kernels.din_attention_plain(q, k_loc.detach(), m_loc, w1, b1, w2, alpha)[0]
    # the one-device plain version in fp64
    want = dict(pooled=[], scores=[], dq=[], dkeys=[])
    wts = [t.double().requires_grad_() for t in (w1, b1, w2, alpha)]
    wsum = [torch.zeros_like(t) for t in wts]
    for r in range(0, b, CP_CHUNK):
        rows = slice(r, r + CP_CHUNK)
        qc = q[rows].double().requires_grad_()
        kc = keys[rows].double().requires_grad_()
        p, s = kernels.din_attention_plain(qc, kc, mask[rows].double(), *wts)
        loss = (p * cot_p[rows].double()).sum() + (s * cot_s[rows].double()).sum()
        grads = torch.autograd.grad(loss, [qc, kc] + wts)
        want["pooled"].append(p.detach().float())
        want["scores"].append(s.detach()[:, steps].float())
        want["dq"].append(grads[0].float())
        want["dkeys"].append(grads[1][:, steps].float())
        for acc, g in zip(wsum, grads[2:]):
            acc += g
    want = {k: torch.cat(v) for k, v in want.items()}
    fwd = din_reading((pooled.detach(), scores.detach()), (want["pooled"], want["scores"]))
    bwd = bwd_reading([leaves[0].grad, k_loc.grad] + [t.grad for t in leaves[1:]],
                      [want["dq"], want["dkeys"]] + [w.float() for w in wsum])
    broken = din_reading((local_pooled, scores.detach()), (want["pooled"], want["scores"]))["pooled"]
    reading = dict(forward=fwd, backward=bwd, broken_no_sum=broken)
    if max(bwd.values()) > 1.0:  # where the backward misses: the worst step's pre-activations
        for name, got, w in (("dq", leaves[0].grad, want["dq"]), ("dkeys", k_loc.grad, want["dkeys"])):
            ratio = (got - w).abs() / (KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * w.abs())
            idx = np.unravel_index(int(ratio.argmax()), tuple(ratio.shape))
            info = dict(n_over=int((ratio > 1).sum()), max_abs_err=float((got - w).abs().max()),
                        worst=list(map(int, idx)), got=float(got[idx]), want=float(w[idx]),
                        max_abs_want=float(w.abs().max()))
            row = idx[0]
            qd, kd = q[row].double(), keys[row, steps].double()
            feats = torch.cat([qd.expand_as(kd), qd - kd, kd, qd * kd], dim=-1)
            lin = (feats @ w1.double() + b1.double()).abs()  # (L/n, H)
            live = m_loc[row] != 0
            info["row_min_abs_lin_live"] = float(lin[live].min()) if bool(live.any()) else None
            if name == "dkeys":
                info["step_live"] = bool(live[idx[1]])
                info["step_min_abs_lin"] = float(lin[idx[1]].min())
            reading[f"{name}_worst"] = info
        bargs = [q, k_loc.detach(), m_loc, w1, b1, w2, alpha, cot_p, cot_s[:, steps].contiguous()]
        reading["local_bwd_case"] = attention_bwd_case(torch, kernels, bargs)[0]
    check(max(fwd.values()) <= 1.0 and max(bwd.values()) <= 1.0,
          f"din_attention_cp against the plain version: {reading}")
    check(broken > 1.0, f"the check cannot tell a pool without the sum over the axis: {reading}")
    check(counts["din_attention"] == counts["din_attention_bwd"] == 1,
          f"din_attention_cp: #4/#5 not once on this rank: {counts}")
    return dict(shape=list(CP_SHAPE), local_steps=lk, reading=reading, host_ms=ms, launches=counts)


def data41_cases() -> dict:
    """16b's (4, 1) cases at full width, fp32, ``MESH_FP32_STEPS`` global
    batches of ``TRAIN_BATCH`` rows each: {case: (config, schema,
    batches)}. DIEN over DIN's schema without ``neg_history`` (its
    auxiliary negatives are the global batch's positives rolled by a row,
    across ranks), DMR (its auxiliary softmax against the global batch's
    last steps), MIND over phase 9's schema with ``MESH_SAMPLED`` sampled
    negatives a row (each rank its block of the global draw)."""
    din = din_info()
    dmr, make = long_seq_data("dmr")
    mind = mind_info()
    return {
        "dien": (sequence_config("dien", "dense", "float32"), din, mesh_batches(din, MESH_FP32_STEPS)),
        "dmr": (long_seq_config("dmr", "dense", "float32"), dmr,
                [make(TRAIN_BATCH, 165 + i) for i in range(MESH_FP32_STEPS)]),
        "mind_sampled": (mind_train_config("float32", params=dict(MIND_PARAMS,
                                                                  num_sampled_negatives=MESH_SAMPLED)),
                         mind, [mind_batch(mind, TRAIN_BATCH, seed=168 + i) for i in range(MESH_FP32_STEPS)]),
    }


def data41_reference(torch, directory) -> None:
    """16b's (4, 1) references in this process: each case of
    ``data41_cases`` on one device, saved for the ranks."""
    from tpurec_torch.train.trainer import Trainer

    for case, (config, info, batches) in data41_cases().items():
        trainer = Trainer(config, info)
        state = trainer.init_state(batches[0])
        terms = []
        state, _, results = mesh_steps(trainer, state, batches, terms)
        torch.save(dict(terms=terms, results=results, params=whole_params(state.model)),
                   os.path.join(directory, f"{case}_4x1_ref.pt"))
        del trainer, state
        gc.collect()
        torch.cuda.empty_cache()


def mesh_data41(torch, kernels, eu, directory) -> dict:
    """16b's (4, 1) mesh of the world of four: each case of
    ``data41_cases`` against this process's one-device run (losses, the
    logged auxiliary terms, the metrics, every parameter), then DIEN in
    bf16 (``mesh_dien41``)."""
    from tpurec_torch.train.trainer import Trainer

    out = {}
    for case, (config, info, batches) in data41_cases().items():
        trainer = Trainer(on_mesh(config, **MESH_4X1), info)
        state = trainer.init_state(batches[0])
        terms = []
        state, _, results = mesh_steps(trainer, state, batches, terms)
        ref = torch.load(os.path.join(directory, f"{case}_4x1_ref.pt"))
        names = sorted(k for k in ref["terms"][0] if k != "loss")
        check(all(sorted(k for k in t if k != "loss") == names for t in terms),
              f"{case} on (4, 1): logged {sorted(terms[0])}, one device {sorted(ref['terms'][0])}")
        got = torch.tensor([[t[k] for k in ["loss"] + names] for t in terms], dtype=torch.float64)
        want = torch.tensor([[t[k] for k in ["loss"] + names] for t in ref["terms"]], dtype=torch.float64)
        reading = dict(loss=tol_ratio(got, want, **MESH_LOSS_TOL), terms=names,
                       metrics=max(tol_ratio(torch.tensor(results[k]), torch.tensor(v), atol=1e-6, rtol=0)
                                   for k, v in ref["results"].items()),
                       **param_reading(torch, whole_params(state.model), ref["params"], MESH_PARAM_TOL))
        check(max(reading["loss"], reading["metrics"], reading["param"]) <= 1.0,
              f"{case} on (4, 1) against one device, fp32: {reading} (terms {terms} vs {ref['terms']})")
        out[case] = dict(terms=terms, reading=reading)
        del trainer, state
        gc.collect()
        torch.cuda.empty_cache()
    out["dien_bf16"] = mesh_dien41(torch, kernels, eu)
    return out


def mesh_dien41(torch, kernels, eu) -> dict:
    """DIEN on (4, 1) at full width (2048 rows a rank), bf16:
    ``MESH_STEPS`` dense steps (#4 and #5 once a step on each rank), #4
    and #5 on the rank's own recorded inputs and cotangents
    (``check_step_attention``, #5 in fp64), ``MESH_FUSED_STEPS`` fused
    steps (#9 once a step on the rank's stream) and #9 on that stream held
    by ``check_step_scatter`` with its broken versions."""
    from tpurec_torch.train.trainer import Trainer

    info = din_info()
    batches = mesh_batches(info, MESH_STEPS, seed=175)
    config = on_mesh(sequence_config("dien"), **MESH_4X1)
    trainer = Trainer(config, info)
    state = trainer.init_state(batches[0])
    kernels.reset_launch_counts()
    state, losses, _ = mesh_steps(trainer, state, batches)
    counts = path_launches(kernels, eu)
    check(counts["din_attention"] == counts["din_attention_bwd"] == MESH_STEPS
          and counts["fused_scatter_add"] == 0, f"DIEN on (4, 1): #4/#5 not once a step: {counts}")
    check(all(np.isfinite(losses)), f"DIEN on (4, 1): non-finite losses {losses}")
    del trainer, state
    attention = check_step_attention(torch, kernels, info, "dien", batches[0], config=config)
    check(all(r["shape"][0] == TRAIN_BATCH // 4 for r in attention.values()),
          f"#4/#5 of DIEN on (4, 1) not on a data rank's rows: {[r['shape'] for r in attention.values()]}")
    fused = on_mesh(sequence_config("dien", "fused"), **MESH_4X1)
    trainer = Trainer(fused, info)
    state = trainer.init_state(batches[0])
    kernels.reset_launch_counts()
    state, fused_losses, _ = mesh_steps(trainer, state, batches[:MESH_FUSED_STEPS])
    fused_counts = path_launches(kernels, eu)
    check(fused_counts["fused_scatter_add"] == fused_counts["din_attention"]
          == fused_counts["din_attention_bwd"] == MESH_FUSED_STEPS,
          f"DIEN fused on (4, 1): #4/#5/#9 not once a step: {fused_counts}")
    check(all(np.isfinite(fused_losses)), f"DIEN fused on (4, 1): non-finite losses {fused_losses}")
    del trainer, state
    scatter = check_step_scatter(torch, eu, Trainer(fused, info), batches[0], ("dien_emb_4x1",), (32,))
    return dict(losses=losses, launches=counts, attention=attention,
                fused_losses=fused_losses, fused_launches=fused_counts,
                scatter=scatter)


def mesh_world_four(torch, kernels, eu, directory) -> dict:
    """16b, in each rank of a gloo world of four on ``cuda:0``."""
    out = dict(din=mesh_din(torch, kernels, eu, directory))
    gc.collect()
    torch.cuda.empty_cache()
    out["fm"] = mesh_fm(torch, kernels, eu)
    gc.collect()
    torch.cuda.empty_cache()
    out["fm_rowwise"] = mesh_fm_rowwise(torch, directory)
    gc.collect()
    torch.cuda.empty_cache()
    out["cp"] = mesh_cp(torch, kernels, eu)
    out["dryrun"] = mesh_dryrun(torch, kernels, eu, 4)
    gc.collect()
    torch.cuda.empty_cache()
    out["data41"] = mesh_data41(torch, kernels, eu, directory)
    out["blocks"] = mesh_blocks(torch, directory)
    return out


def mesh_rank(argv) -> int:
    """A rank of phase 16: ``--mesh-rank WORLD RANK SIZE DIR``."""
    import torch
    import torch.distributed as dist

    from tpurec_torch.core.distributed import initialize
    from tpurec_torch.ops import embedding_update as eu
    from tpurec_torch.ops import kernels

    world, rank, size, directory = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    backend = "nccl" if world == "nccl1" else "gloo"
    t0 = time.perf_counter()
    topology = initialize(f"file://{os.path.join(directory, world + '.rendezvous')}", size, rank,
                          backend)
    out = dict(world=world, backend=backend, topology=topology, rank=rank,
               init_s=time.perf_counter() - t0)
    run = mesh_world_one if world == "nccl1" else mesh_world_four
    with adam_launches(kernels) as adam:
        out.update(run(torch, kernels, eu, directory))
    out["adam_update_launches"] = adam["n"]
    out["seconds"] = time.perf_counter() - t0
    with open(os.path.join(directory, f"{world}_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def mesh41_summary(r) -> dict:
    """A rank's (4, 1) results as phase 16b prints them: each fp32 case's
    reading, DIEN's bf16 dense and fused launches and the readings of #4,
    #5 and #9 on its inputs."""
    dien = r["dien_bf16"]
    out = {case: dict(reading=v["reading"]) for case, v in r.items() if case != "dien_bf16"}
    out["dien_bf16"] = dict(
        launches=dien["launches"], fused_launches=dien["fused_launches"],
        attention={k: dict(readings=v["readings"], shape=v["shape"], ms=v["ms"], bound_ms=v["bound_ms"],
                           plain_ms=v["plain_ms"]) for k, v in dien["attention"].items()},
        scatter={k: dict(n=v["shape"][0], rows=v["shape"][1], d=v["shape"][2], max_abs_err=v["max_abs_err"],
                         ms=v["ms"], bound_ms=v["bound_ms"], plain_ms=v["plain_ms"],
                         library_ms=v["library_ms"]) for k, v in dien["scatter"].items()})
    return out


def run_mesh(torch, kernels, eu, workdir, card):
    """Phase 16: returns ({kernel: {path: launches}}, summary)."""
    from tpurec_torch.train.trainer import Trainer

    info = din_info()
    batches = mesh_batches(info, MESH_STEPS)
    # 16a's reference: the same steps without a world
    trainer = Trainer(din_train_config("bfloat16"), info)
    state = trainer.init_state(batches[0])
    state, losses, results = mesh_steps(trainer, state, batches)
    groupless = dict(losses=losses, params=whole_params(state.model))
    # 16b's reference: the one-device fp32 steps on the same global batches
    trainer = Trainer(din_train_config("float32"), info)
    state = trainer.init_state(batches[0])
    state, losses, results = mesh_steps(trainer, state, batches[:MESH_FP32_STEPS])
    torch.save(dict(losses=losses, results=results, params=whole_params(state.model)),
               os.path.join(workdir, "din_fp32_ref.pt"))
    del trainer, state
    # 16b's FM rowwise_adam reference: one device, fp32
    trainer = Trainer(fm_train_config("sparse", "float32"), fm_info())
    state = trainer.init_state()
    state, losses, results = mesh_steps(trainer, state, fm_rowwise_batches())
    torch.save(dict(losses=losses, results=results, params=whole_params(state.model),
                    state=fm_rowwise_state(state)), os.path.join(workdir, "fm_rowwise_ref.pt"))
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    # 16b's (4, 1) references: DIEN, DMR and MIND sampled on one device, fp32
    data41_reference(torch, workdir)
    # 16b's tensor-parallel MLP with LayerNorm, a softmax and dropout
    mesh_blocks_reference(torch, workdir)

    t0 = time.perf_counter()
    (one,) = mesh_world(torch, "nccl1", 1, workdir)
    nccl_s = time.perf_counter() - t0
    params = torch.load(os.path.join(workdir, "nccl1_params.pt"))
    loss_err = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(one["losses"], groupless["losses"]))
    param_err = max(float((params[n] - w).abs().max()) for n, w in groupless["params"].items())
    same_bits = one["losses"] == groupless["losses"] and all(
        torch.equal(params[n], w) for n, w in groupless["params"].items())
    world_one = dict(card=card, backend="nccl", mesh=[1, 1], batch=TRAIN_BATCH, steps=MESH_STEPS,
                     loss_rel_err=loss_err, param_abs_err=param_err, same_bits=same_bits,
                     launches=one["launches"], init_s=one["init_s"], world_s=nccl_s,
                     dryrun=one["dryrun"])
    print("phase 16a, DIN dense in a world of one over NCCL against no world:", json.dumps(world_one),
          flush=True)
    check(loss_err <= MESH_GROUPLESS_TOL and param_err <= MESH_GROUPLESS_TOL,
          f"world of one against no world: {world_one}")
    check(one["launches"]["din_attention"] == one["launches"]["din_attention_bwd"] == MESH_STEPS,
          f"world of one: #4/#5 not once a step: {one['launches']}")

    t0 = time.perf_counter()
    four = mesh_world(torch, "gloo4", 4, workdir)
    gloo_s = time.perf_counter() - t0
    summary = dict(card=card, backend="gloo (4 ranks share cuda:0: a check of correctness, no scaling)",
                   world_s=gloo_s, ranks=[])
    for r in four:
        summary["ranks"].append(dict(
            rank=r["rank"], init_s=r["init_s"], seconds=r["seconds"],
            din=dict(fp32_reading=r["din"]["fp32_reading"], launches=r["din"]["launches"],
                attention={k: v["readings"] for k, v in r["din"]["attention"].items()}),
            fm=dict(rows_per_rank=r["fm"]["rows_per_rank"], launches=r["fm"]["launches"],
                scatter={k: dict(n=v["shape"][0], rows=v["shape"][1], d=v["shape"][2],
                                 max_abs_err=v["max_abs_err"], ms=v["ms"], bound_ms=v["bound_ms"],
                                 plain_ms=v["plain_ms"], library_ms=v["library_ms"])
                         for k, v in r["fm"]["scatter"].items()},
                fused_vs_dense=r["fm"]["fused_vs_dense"]["fused"]),
            din_mlp_shares=r["din"]["mlp_shares"],
            fm_rowwise=dict(rows_per_rank=r["fm_rowwise"]["rows_per_rank"],
                            reading=r["fm_rowwise"]["reading"]),
            dryrun=r["dryrun"],
            cp=dict(reading=r["cp"]["reading"], launches=r["cp"]["launches"], host_ms=r["cp"]["host_ms"]),
            data41=mesh41_summary(r["data41"]), blocks=r["blocks"]))
    print("phase 16b, a world of four ranks on one card over gloo, mesh (2, 2), (1, 4) and (4, 1):",
          json.dumps(summary), flush=True)
    launches = {
        name: dict(mesh_din_nccl1=one["launches"][name],
                   mesh_din_2x2=sum(r["din"]["launches"][name] for r in four),
                   mesh_din_attention_cp=sum(r["cp"]["launches"][name] for r in four),
                   mesh_dryrun_nccl1=one["dryrun"]["launches"][name],
                   mesh_dryrun_2x2=sum(r["dryrun"]["launches"][name] for r in four),
                   mesh_dien_4x1=sum(r["data41"]["dien_bf16"]["launches"][name] for r in four),
                   mesh_dien_fused_4x1=sum(r["data41"]["dien_bf16"]["fused_launches"][name] for r in four))
        for name in ("din_attention", "din_attention_bwd")
    }
    launches["fused_scatter_add"] = dict(
        mesh_fm_fused_2x2=sum(r["fm"]["launches"]["fused_scatter_add"] for r in four),
        mesh_dryrun_nccl1=one["dryrun"]["launches"]["fused_scatter_add"],
        mesh_dryrun_2x2=sum(r["dryrun"]["launches"]["fused_scatter_add"] for r in four),
        mesh_dien_fused_4x1=sum(r["data41"]["dien_bf16"]["fused_launches"]["fused_scatter_add"]
                                for r in four))
    launches["adam_update"] = dict(mesh_nccl1=one["adam_update_launches"],
                                   mesh_gloo4=sum(r["adam_update_launches"] for r in four))
    print("phase 16 launches (all ranks):", json.dumps(launches), flush=True)
    return launches, dict(world_one=world_one, world_four=summary)


# ---------------------------------------------------------------------------
# phase 17: the building blocks' options (plain PyTorch in both packages: no
# kernel of either is on this path)
BLOCKS_ROWS = 256  # rows held against the CPU port
BLOCKS_FP32_TOL = dict(atol=1e-5, rtol=1e-4)  # card against CPU, TF32 off: sums in other orders
BLOCKS_BF16_RTOL = 2.0**-5  # of each output's largest |value|, as FM_FAMILY_RTOL
BLOCKS_DROPOUT = 0.1
BLOCKS_SIGMAS = 6.0  # a draw's keep count against the binomial's mean
BLOCKS_MLP = {
    # case: the options of an MLP over DIN's tower (``din_mlp_width()`` →
    # 200 → 80), with whether it runs in training mode
    "sigmoid": (dict(activation="sigmoid"), True),
    "tanh": (dict(activation="tanh"), True),
    "gelu": (dict(activation="gelu"), True),
    "softmax": (dict(out_activation="softmax"), True),
    "bn_train": (dict(use_bn=True), True),
    "bn_eval": (dict(use_bn=True), False),
    "ln": (dict(use_ln=True), True),
    "dropout": (dict(dropout_rate=BLOCKS_DROPOUT), True),
}
DIN_MLP = (200, 80)
# AutoInt's Criteo setting (phase 11: D=16, 2 heads of 32) over the
# ``wide_and_deep`` schema's 26 + 13 fields, projected to 32, no LayerNorm
BLOCKS_MHA = dict(out_dim=32, use_layer_norm=False, dropout_rate=BLOCKS_DROPOUT)
BLOCKS_FIELDS = 39
# phase 16b's tensor-parallel MLP on (2, 2)
MESH_BLOCKS = dict(hidden_dims=DIN_MLP, activation="gelu", out_activation="softmax", use_ln=True,
                   dropout_rate=BLOCKS_DROPOUT)


def din_mlp_width() -> int:
    """The input width of DIN's ``mlp`` at phase 6's configuration."""
    from tpurec_torch.models import build_model

    model = build_model(din_train_config("float32").model, din_info(), device="cpu")
    return model.mlp.dense_0.weight.shape[1]


@contextlib.contextmanager
def recorded_masks(masks):
    """Every dropout draw in the body appended to ``masks``."""
    from tpurec_torch.ops.mlp import Dropout

    draw = Dropout.keep_mask

    def record(self, *args, **kwargs):
        keep = draw(self, *args, **kwargs)
        masks.append(keep)
        return keep

    with mock.patch.object(Dropout, "keep_mask", record):
        yield


@contextlib.contextmanager
def replayed_masks(masks, rows, shift=0):
    """The body's dropout draws are ``masks`` in order, their first ``rows``
    rows (rolled by ``shift`` rows: a wrong mask)."""
    from tpurec_torch.ops.mlp import Dropout

    queue = list(masks)

    def replay(self, shape, device, columns=None):
        keep = queue.pop(0)[:rows].roll(shift, 0).to(device)
        check(tuple(keep.shape) == tuple(shape), f"a replayed mask {tuple(keep.shape)} for {tuple(shape)}")
        return keep

    with mock.patch.object(Dropout, "keep_mask", replay):
        yield
    check(not queue, f"{len(queue)} dropout masks drawn on the card were not drawn on the CPU")


def blocks_reading(torch, got, want, bf16) -> float:
    """Error over limit (at most 1 passes): fp32 elementwise at
    ``BLOCKS_FP32_TOL``, bf16 at ``BLOCKS_BF16_RTOL`` of the largest |want|."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    if bf16:
        return scaled_ratio(got, want, BLOCKS_BF16_RTOL)
    return tol_ratio(got, want, **BLOCKS_FP32_TOL)


def blocks_case(torch, module, x, g, train, cpu_rows=BLOCKS_ROWS, gelu_exact=False):
    """``module`` (built on the CPU, its weights seeded) copied to the card
    and run there over ``x`` (on the card) with cotangent ``g``, its dropout
    masks drawn from a CUDA generator and recorded; then on the CPU over
    the first ``cpu_rows`` rows with the same masks. Returns the readings
    of the output and the input gradient on the first ``BLOCKS_ROWS`` rows
    (and of the running statistics), with the broken versions (a mask off
    by one row; with ``gelu_exact``, torch's exact gelu on the card: an
    fp32 check only, bf16's limit lies above their difference),
    the device ms of the forward and of the forward and backward, and
    whether the card's output is finite."""
    from tpurec_torch.ops import mlp as tmlp

    bf16 = x.dtype == torch.bfloat16
    card = copy.deepcopy(module).to("cuda").train(train)
    module.train(train)
    gen = torch.Generator(device="cuda").manual_seed(17)
    masks = []
    xc = x.detach().clone().requires_grad_()
    with tmlp.dropout_generator(card, gen), recorded_masks(masks):
        out = card(xc)
    out.backward(g)
    xh = x[:cpu_rows].detach().cpu().requires_grad_()
    with replayed_masks(masks, cpu_rows):
        want = module(xh)
    want.backward(g[:cpu_rows].cpu())
    n = BLOCKS_ROWS
    r = dict(out=blocks_reading(torch, out[:n], want[:n], bf16),
             dx=blocks_reading(torch, xc.grad[:n], xh.grad[:n], bf16))
    for (name, a), b in zip(card.named_buffers(), module.buffers()):
        r[name] = blocks_reading(torch, a, b, bf16)
    if masks:
        with torch.no_grad(), replayed_masks(masks, cpu_rows, shift=1):
            r["broken_mask_shifted"] = blocks_reading(torch, out[:n], module(xh)[:n], bf16)
    if gelu_exact:
        with torch.no_grad(), mock.patch.dict(tmlp._SIMPLE_ACTS, gelu=torch.nn.functional.gelu), \
                tmlp.dropout_generator(card, gen):
            r["broken_gelu_exact"] = blocks_reading(torch, card(xc)[:n], want[:n], bf16)
    with tmlp.dropout_generator(card, gen):
        fwd_ms = device_ms(torch, lambda: card(xc))
        step_ms = device_ms(torch, lambda: card(xc).backward(g))
    finite = bool(torch.isfinite(out).all()) and bool(torch.isfinite(xc.grad).all())
    return dict(readings=r, fwd_ms=fwd_ms, fwd_bwd_ms=step_ms, finite=finite, shape=list(out.shape),
                masks=len(masks))


def check_dropout_draw(torch, shape) -> dict:
    """``Dropout``'s draw on the card at ``shape``: the keep count within
    ``BLOCKS_SIGMAS`` of the binomial's mean, the same generator state the
    same mask, and ``apply_dropout_mask`` with that mask (and its
    gradient) equal to the CPU's in fp32 and bf16; device ms of a draw and
    of the masking."""
    from tpurec_torch.ops.mlp import Dropout, apply_dropout_mask, dropout_generator

    drop = Dropout(BLOCKS_DROPOUT)
    gen = torch.Generator(device="cuda").manual_seed(170)
    with dropout_generator(drop, gen):
        state = gen.get_state()
        keep = drop.keep_mask(shape, "cuda")
        gen.set_state(state)
        again = drop.keep_mask(shape, "cuda")
        draw_ms = device_ms(torch, lambda: drop.keep_mask(shape, "cuda"))
    n, p = keep.numel(), 1.0 - BLOCKS_DROPOUT
    z = (int(keep.sum()) - n * p) / float(np.sqrt(n * p * (1.0 - p)))
    x = torch.randn(shape, device="cuda", generator=gen)
    g = torch.randn(shape, device="cuda", generator=gen)
    same = {}
    for dtype in (torch.float32, torch.bfloat16):
        xc = x.to(dtype).clone().requires_grad_()
        y = apply_dropout_mask(xc, keep, BLOCKS_DROPOUT)
        y.backward(g.to(dtype))
        xh = x.to(dtype).cpu().clone().requires_grad_()
        yh = apply_dropout_mask(xh, keep.cpu(), BLOCKS_DROPOUT)
        yh.backward(g.to(dtype).cpu())
        same[str(dtype).split(".")[-1]] = torch.equal(y.detach().cpu(), yh.detach()) and torch.equal(
            xc.grad.cpu(), xh.grad)
    apply_ms = device_ms(torch, lambda: apply_dropout_mask(x, keep, BLOCKS_DROPOUT))
    out = dict(shape=list(shape), keep_fraction=int(keep.sum()) / n, z=z, replay_same=torch.equal(keep, again),
               equal_to_cpu=same, draw_ms=draw_ms, apply_ms=apply_ms)
    print("phase 17, dropout's draw on the card:", json.dumps(out), flush=True)
    check(abs(z) <= BLOCKS_SIGMAS, f"dropout keeps {out['keep_fraction']} of {n} at rate {BLOCKS_DROPOUT}: "
                                   f"{z:.2f} sigmas off")
    check(out["replay_same"], "dropout: the same generator state drew another mask")
    check(all(same.values()), f"apply_dropout_mask on the card differs from the CPU: {same}")
    return out


def run_blocks(torch, card):
    """Phase 17: the MLP's activations, BatchNorm (training and eval),
    LayerNorm and dropout at DIN's tower and B=8192, and
    ``MultiHeadAttention`` with ``out_dim``, no LayerNorm and dropout at
    AutoInt's setting, in fp32 and bf16, on the card against the CPU port;
    dropout's draw. Returns the summary."""
    from tpurec_torch.initializers import init_parameters
    from tpurec_torch.ops.attention import MultiHeadAttention
    from tpurec_torch.ops.mlp import MLP

    width = din_mlp_width()
    gen = torch.Generator(device="cuda").manual_seed(171)
    cases = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        x = torch.randn(TRAIN_BATCH, width, device="cuda", generator=gen).to(dt)
        g = torch.randn(TRAIN_BATCH, DIN_MLP[-1], device="cuda", generator=gen).to(dt)
        for seed, (case, (kw, train)) in enumerate(BLOCKS_MLP.items()):
            mlp = init_parameters(MLP(width, DIN_MLP, dtype=dt, **kw), seed=seed)
            cpu_rows = BLOCKS_ROWS
            if kw.get("use_bn"):
                bn = mlp.bn_0  # running statistics that do work in eval mode
                bn.running_mean.normal_(0.0, 0.5, generator=torch.Generator().manual_seed(seed))
                bn.running_var.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(seed))
                if train:
                    cpu_rows = TRAIN_BATCH  # the batch's moments are the whole batch's
            cases[f"mlp_{case}_{dtype}"] = blocks_case(torch, mlp, x, g, train, cpu_rows,
                                                        gelu_exact=case == "gelu" and dtype == "float32")
        q = torch.randn(TRAIN_BATCH, BLOCKS_FIELDS, 16, device="cuda", generator=gen).to(dt)
        gq = torch.randn(TRAIN_BATCH, BLOCKS_FIELDS, BLOCKS_MHA["out_dim"], device="cuda",
                         generator=gen).to(dt)
        mha = init_parameters(MultiHeadAttention(16, 2, 32, dtype=dt, **BLOCKS_MHA), seed=99)
        cases[f"mha_{dtype}"] = blocks_case(torch, mha, q, gq, True)
    draw = check_dropout_draw(torch, (TRAIN_BATCH, DIN_MLP[0]))
    summary = dict(card=card, batch=TRAIN_BATCH, din_mlp=[width, *DIN_MLP], rows_held=BLOCKS_ROWS,
                   limits=dict(fp32=BLOCKS_FP32_TOL, bf16_of_max=BLOCKS_BF16_RTOL), cases=cases, dropout=draw)
    print("phase 17, the building blocks' options on the card against the CPU (error / limit):",
          json.dumps(summary), flush=True)
    for name, c in cases.items():
        check(c["finite"], f"phase 17 {name}: non-finite output or gradient")
        for key, r in c["readings"].items():
            if key.startswith("broken"):
                check(r > 1.0, f"phase 17 {name}: the check cannot tell a {key} version: {r}")
            else:
                check(r <= 1.0, f"phase 17 {name}: {key} on the card against the CPU: {r}")
        want_masks = 1 if "dropout" in name or name.startswith("mha") else 0
        check(c["masks"] == want_masks, f"phase 17 {name}: {c['masks']} dropout draws, not {want_masks}")
    return summary


def mesh_blocks_reference(torch, directory) -> None:
    """16b's tensor-parallel MLP (``MESH_BLOCKS`` over DIN's tower) on one
    device: one fp32 training forward and backward at B=8192 with its
    dropout drawn from a seeded CUDA generator, saved with its weights and
    inputs for the ranks."""
    from tpurec_torch.initializers import init_parameters
    from tpurec_torch.ops.mlp import MLP, dropout_generator

    width = din_mlp_width()
    mlp = init_parameters(MLP(width, tp_axis="model", **MESH_BLOCKS).cuda(), seed=16)
    gen = torch.Generator(device="cuda").manual_seed(160)
    x = torch.randn(TRAIN_BATCH, width, device="cuda", generator=gen).requires_grad_()
    g = torch.randn(TRAIN_BATCH, DIN_MLP[-1], device="cuda", generator=gen)
    with dropout_generator(mlp, torch.Generator(device="cuda").manual_seed(161)):
        out = mlp.train()(x)
    out.backward(g)
    torch.save(dict(state={k: v.cpu() for k, v in mlp.state_dict().items()}, x=x.detach().cpu(), g=g.cpu(),
                    out=out.detach().cpu(), dx=x.grad.cpu()), os.path.join(directory, "mesh_blocks_ref.pt"))


def mesh_blocks(torch, directory) -> dict:
    """16b's tensor-parallel MLP on (2, 2): this rank's share of the
    one-device weights, one fp32 training forward and backward over its
    data block of the same batch, its dropout the one-device draw: the
    output and the input gradient against the one-device run's rows."""
    from tpurec_torch.config import MeshConfig
    from tpurec_torch.core.collectives import local_share
    from tpurec_torch.core.mesh import make_mesh
    from tpurec_torch.models.registry import place_on_mesh, sharded_weights
    from tpurec_torch.ops.mlp import MLP, dropout_generator

    ref = torch.load(os.path.join(directory, "mesh_blocks_ref.pt"))
    mesh = make_mesh(MeshConfig(**MESH_2X2))
    mlp = MLP(ref["x"].shape[1], tp_axis="model", **MESH_BLOCKS).cuda()
    place_on_mesh(mlp, mesh)
    state = dict(ref["state"])
    for key, (dim, m) in sharded_weights(mlp).items():
        state[key] = local_share(state[key], dim, m)
    mlp.load_state_dict(state)
    rows = TRAIN_BATCH // mesh.n_data
    lo = mesh.data_index * rows
    x = ref["x"][lo:lo + rows].cuda().requires_grad_()
    with dropout_generator(mlp, torch.Generator(device="cuda").manual_seed(161)):
        out = mlp.train()(x)
    out.backward(ref["g"][lo:lo + rows].cuda())
    reading = dict(out=tol_ratio(out.detach().double().cpu(), ref["out"][lo:lo + rows].double(), **BLOCKS_FP32_TOL),
                   dx=tol_ratio(x.grad.double().cpu(), ref["dx"][lo:lo + rows].double(), **BLOCKS_FP32_TOL))
    shares = {n: list(p.shape) for n, p in mlp.named_parameters()}
    check(mlp.dense_0.split == "column" and mlp.dense_1.split == "row",
          f"the blocks' MLP on (2, 2) is not tensor parallel: {shares}")
    check(max(reading.values()) <= 1.0, f"the blocks' MLP on (2, 2) against one device: {reading}")
    return dict(reading=reading, shares=shares, rows=[lo, lo + rows])


# --------------------------------------------------------------------------
# the optimizer chain's kernel (csrc/adam_update.cu) on the benchmark's lists
ADAM_BYTES = 28  # a parameter: p, g, m and v read, p, m and v written, fp32
ADAM_CONFIGS = ("deepfm_criteo", "din_amazon")
# the full run's phases that train on the card through ``ChainOptimizer``
# (each must launch the chain's kernel), and the mesh's two worlds
ADAM_TRAINING_PHASES = ("6_din_training", "7cef_fm_engines", "7d_din_fused", "8bc_dcn_family",
                        "9bcd_mind", "10_fm_family", "11_dcn_rest", "12_cli", "13_multitask",
                        "14_sequence", "15_long_seq", "16_mesh", "mesh_nccl1", "mesh_gloo4")


def adam_chain_lists(torch, name):
    """The dense engine's optimizer list of the benchmark's configuration
    ``name`` (``portbench/configs/<name>.json``, built as the benchmark
    builds it), with gradients and moments drawn from a fixed seed."""
    from portbench.lib import program

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "portbench", "configs",
                           f"{name}.json")) as f:
        cfg = json.load(f)
    trainer = program.trainer(cfg, {"engine": "auto", "batch": TRAIN_BATCH}, "cuda")
    opt = trainer.init_state().optimizer
    params = [g["params"][0].detach() for g in opt.param_groups]
    gen = torch.Generator(device="cuda").manual_seed(27)

    def draw(p, scale):
        return scale * torch.randn(p.shape, device="cuda", generator=gen)

    grads = [draw(p, 1e-3) for p in params]
    mus = [draw(p, 1e-4) for p in params]
    nus = [draw(p, 1e-4).square_() for p in params]
    return opt.config, params, grads, mus, nus


def check_adam(torch, kernels) -> dict:
    """The chain's kernel against its foreach twin on DeepFM's and DIN's
    lists: one step of each from the same state (every element of p, m and v
    within 4 ulps), then device ms of a step (L2 flushed by a read) beside
    the 28 bytes a parameter over 3.35 TB/s and PyTorch's fused Adam
    (``torch._fused_adam_``, a library kernel the port never calls, timed
    as ``library_ms``: the same plain Adam, no clip, L2 or decay), and each
    one's host time a call with the card held busy, the kernel's with the
    descriptor table kept as ``ChainOptimizer`` keeps it and without (the
    median of single calls queued behind a sleep kernel)."""
    out = {}
    for name in ADAM_CONFIGS:
        oc, params, grads, mus, nus = adam_chain_lists(torch, name)
        n = sum(p.numel() for p in params)
        hp = dict(lr=oc.learning_rate, bc1=1.0 - oc.b1**3, bc2=1.0 - oc.b2**3, b1=oc.b1, b2=oc.b2,
                  eps=oc.eps)
        copies = [[t.clone() for t in ts] for ts in (params, mus, nus)]
        before = kernels.adam_update_fused.launches
        kernels.adam_update_fused(params, grads, mus, nus, **hp)
        launches = kernels.adam_update_fused.launches - before
        kernels.adam_update_plain(copies[0], grads, copies[1], copies[2], **hp)
        torch.cuda.synchronize()
        ulps = 0
        for got, want in zip((params, mus, nus), copies):
            for g, w in zip(got, want):
                i, j = (x.view(torch.int32).to(torch.int64) for x in (g, w))
                i, j = (torch.where(x < 0, -(2**31) - x, x) for x in (i, j))
                ulps = max(ulps, int((i - j).abs().max()))
        del copies
        check(ulps <= 4, f"{name}: the chain's kernel is {ulps} ulps from its foreach twin")
        check(launches == 1, f"{name}: the chain's kernel took {launches} launches for one step")
        cache = {}
        steps = [torch.full((), 3.0, device="cuda") for _ in params]
        kept = lambda: kernels.adam_update_fused(params, grads, mus, nus, **hp, cache=cache)  # noqa: E731
        kernel = lambda: kernels.adam_update_fused(params, grads, mus, nus, **hp)  # noqa: E731
        plain = lambda: kernels.adam_update_plain(params, grads, mus, nus, **hp)  # noqa: E731
        library = lambda: torch._fused_adam_(  # noqa: E731
            params, grads, mus, nus, [], steps, lr=oc.learning_rate, beta1=oc.b1, beta2=oc.b2,
            weight_decay=0.0, eps=oc.eps, amsgrad=False, maximize=False)
        ms = device_ms(torch, kernel, iters=20, flush="read")
        plain_ms = device_ms(torch, plain, iters=10, flush="read")
        library_ms = device_ms(torch, library, iters=20, flush="read")
        bound_ms = ADAM_BYTES * n / HBM_BYTES_PER_S * 1e3
        host_us = {}
        # the plain chain's ~18 launches a tensor fill the launch queue in a
        # few calls: it is timed over 4, the kernel over 200
        for label, fn, calls in (("kernel_kept_table", kept, 200), ("kernel", kernel, 200),
                                 ("plain", plain, 4)):
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(2_000_000_000)
            times = []
            for _ in range(calls):
                t = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t)
            host_us[label] = statistics.median(times) * 1e6
            torch.cuda.synchronize()
        out[name] = dict(tensors=len(params), parameters=n, ulps=ulps, launches_a_step=launches,
                         ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                         bound_by="bytes", share_of_bound=bound_ms / ms,
                         plain_share_of_bound=bound_ms / plain_ms,
                         library_share_of_bound=bound_ms / library_ms, host_us_a_call=host_us)
        print("adam chain:", name, json.dumps(out[name]), flush=True)
        del params, grads, mus, nus, steps, cache
        gc.collect()
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def adam_launches(kernels):
    """Counts the chain kernel's launches inside the block from 0, across the
    block's own ``reset_launch_counts`` calls (each adds what it clears);
    the yielded dict holds the count in ``"n"`` once the block ends."""
    counted = dict(n=0)
    reset = kernels.reset_launch_counts

    def counting_reset():
        counted["n"] += kernels.adam_update_fused.launches
        reset()

    kernels.adam_update_fused.launches = 0
    with mock.patch.object(kernels, "reset_launch_counts", counting_reset):
        yield counted
    counted["n"] += kernels.adam_update_fused.launches


def ok_line(torch) -> dict:
    return {"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank(sys.argv[2:])
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
    if sys.argv[1:] == ["--fm-family"]:
        # phase 10 alone: the FM family and MatrixCF (their one kernel is #9)
        from tpurec_torch.ops import embedding_update as eu

        kernels.build(["embedding_update"])
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR.parent) as workdir:
            run_fm_family(torch, eu, workdir, smi)
        print("phase seconds:", json.dumps({"10_fm_family": time.perf_counter() - t}), flush=True)
        return 0
    if sys.argv[1:] == ["--dcn-rest"]:
        # phase 11 alone: the rest of the DCN family (its one kernel is #9)
        from tpurec_torch.ops import embedding_update as eu

        kernels.build(["embedding_update"])
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR.parent) as workdir:
            run_dcn_rest(torch, eu, workdir, smi)
        print("phase seconds:", json.dumps({"11_dcn_rest": time.perf_counter() - t}), flush=True)
        return 0
    if sys.argv[1:] == ["--cli"]:
        # phase 12 alone: the CLI journey (its kernels are #1, #4, #5 and #9)
        from tpurec_torch.ops import embedding_update as eu

        t = time.perf_counter()
        kernels.build(["fm_second_order", "din_attention", "din_attention_bwd", "embedding_update"])
        print(f"built in {time.perf_counter() - t:.1f} s", flush=True)
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR.parent) as workdir:
            cli_launches, cli_checks, _ = run_cli(torch, kernels, eu, workdir, smi)
        print("phase seconds:", json.dumps({"12_cli": time.perf_counter() - t}), flush=True)
        print(json.dumps({"card": smi, "cli_launches_by_path": cli_launches, "cli_checks": cli_checks}),
              flush=True)
        print(json.dumps(ok_line(torch)), flush=True)
        return 0
    if sys.argv[1:] == ["--multitask"]:
        # phase 13 alone: the multi-task and personalization families (their
        # one kernel is #9)
        from tpurec_torch.ops import embedding_update as eu

        t = time.perf_counter()
        kernels.build(["embedding_update"])
        print(f"built in {time.perf_counter() - t:.1f} s", flush=True)
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR.parent) as workdir:
            mt_scatter, mt_launches = run_multitask(torch, kernels, eu, workdir, smi)
        print("phase seconds:", json.dumps({"13_multitask": time.perf_counter() - t}), flush=True)
        print(json.dumps({"card": smi, "fused_scatter_add_launches_by_path": mt_launches,
                          "fused_scatter_add_checks": mt_scatter}), flush=True)
        print(json.dumps(ok_line(torch)), flush=True)
        return 0
    if sys.argv[1:] == ["--sequence"]:
        # phase 14 alone: the recurrent sequence models and the FiBiNET++
        # family (their kernels are #4, #5 and #9)
        from tpurec_torch.ops import embedding_update as eu

        t = time.perf_counter()
        kernels.build(["din_attention", "din_attention_bwd", "embedding_update"])
        print(f"built in {time.perf_counter() - t:.1f} s", flush=True)
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR.parent) as workdir:
            seq_records, seq_launches, _ = run_sequence(torch, kernels, eu, workdir, smi)
        print("phase seconds:", json.dumps({"14_sequence": time.perf_counter() - t}), flush=True)
        print(json.dumps({"card": smi, "sequence_launches_by_path": seq_launches,
                          "sequence_checks": seq_records}), flush=True)
        print(json.dumps(ok_line(torch)), flush=True)
        return 0
    if sys.argv[1:] == ["--long-seq"]:
        # phase 15 alone: the long-sequence and DMR families (their kernels
        # are #4, #5 and #9)
        from tpurec_torch.ops import embedding_update as eu

        t = time.perf_counter()
        kernels.build(["din_attention", "din_attention_bwd", "embedding_update"])
        print(f"built in {time.perf_counter() - t:.1f} s", flush=True)
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR.parent) as workdir:
            ls_records, ls_launches, _ = run_long_seq(torch, kernels, eu, workdir, smi)
        print("phase seconds:", json.dumps({"15_long_seq": time.perf_counter() - t}), flush=True)
        print(json.dumps({"card": smi, "long_seq_launches_by_path": ls_launches,
                          "long_seq_checks": ls_records}), flush=True)
        print(json.dumps(ok_line(torch)), flush=True)
        return 0
    if sys.argv[1:] == ["--mesh"]:
        # phase 16 alone: the mesh (its kernels are #4, #5 and #9), built
        # here before any rank starts
        from tpurec_torch.ops import embedding_update as eu

        t = time.perf_counter()
        kernels.build(["din_attention", "din_attention_bwd", "embedding_update"])
        print(f"built in {time.perf_counter() - t:.1f} s", flush=True)
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR.parent) as workdir:
            mesh_launches, _ = run_mesh(torch, kernels, eu, workdir, smi)
        print("phase seconds:", json.dumps({"16_mesh": time.perf_counter() - t}), flush=True)
        print(json.dumps({"card": smi, "mesh_launches_by_path": mesh_launches}), flush=True)
        print(json.dumps(ok_line(torch)), flush=True)
        return 0
    if sys.argv[1:] == ["--blocks"]:
        # phase 17 alone: the building blocks' options (no kernel)
        t = time.perf_counter()
        run_blocks(torch, smi)
        print("phase seconds:", json.dumps({"17_blocks": time.perf_counter() - t}), flush=True)
        print(json.dumps(ok_line(torch)), flush=True)
        return 0
    if sys.argv[1:2] == ["--din-bwd-ab"] and len(sys.argv) == 3:
        # kernel #5 of another checkout (a git archive of the parent commit)
        # against this one's, alternating
        kernels.build(["din_attention_bwd"])
        din_bwd_ab(torch, kernels, sys.argv[2])
        return 0
    if sys.argv[1:] == ["--adam"]:
        # the optimizer chain's kernel alone, on the benchmark's lists
        paths = kernels.build(["adam_update"])
        print(open(f"{paths['adam_update']}.log").read(), flush=True)
        print(json.dumps({"card": smi, "adam_update": check_adam(torch, kernels)}), flush=True)
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
    adam_paths = {}  # the chain kernel's launches in each phase

    def timed(name, fn, *args):
        t = time.perf_counter()
        with adam_launches(kernels) as adam:
            out = fn(*args)
        seconds[name] = time.perf_counter() - t
        adam_paths[name] = adam["n"]
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
        fm_family_scatter, fm_family_launches = timed("10_fm_family", run_fm_family, torch, eu,
                                                      workdir, smi)
        nfm_scatter, dcn_rest_launches = timed("11_dcn_rest", run_dcn_rest, torch, eu, workdir, smi)
        cli_launches, cli_checks, _ = timed("12_cli", run_cli, torch, kernels, eu, workdir, smi)
        mt_scatter, mt_launches = timed("13_multitask", run_multitask, torch, kernels, eu, workdir, smi)
        seq_records, seq_launches, _ = timed("14_sequence", run_sequence, torch, kernels, eu, workdir, smi)
        ls_records, ls_launches, _ = timed("15_long_seq", run_long_seq, torch, kernels, eu, workdir, smi)
        mesh_launches, _ = timed("16_mesh", run_mesh, torch, kernels, eu, workdir, smi)
    timed("17_blocks", run_blocks, torch, smi)
    adam_checks = timed("18_adam", check_adam, torch, kernels)
    print("phase seconds:", json.dumps(seconds), flush=True)
    # the chain kernel: every phase's training steps (phase 18's own step is
    # its check, not a main path) and the mesh's ranks
    del adam_paths["18_adam"]
    adam_paths.update(mesh_launches["adam_update"])
    print("adam_update launches by phase:", json.dumps(adam_paths), flush=True)
    for phase in ADAM_TRAINING_PHASES:
        check(adam_paths[phase] > 0, f"phase {phase} trained without the chain's kernel: {adam_paths}")
    records["adam_update"] = dict(
        adam_checks["deepfm_criteo"], name="adam_update", route="cuda",
        source="tpurec_torch/csrc/adam_update.cu", replaces=None,
        other_shapes=dict(din_amazon=adam_checks["din_amazon"]),
        launches=sum(adam_paths.values()), launches_by_path=adam_paths,
    )
    # a kernel on several paths: its launches are their sum
    fm_paths = dict(http_rank=records["fm_second_order"]["launches"], **cli_launches["fm_second_order"])
    records["fm_second_order"]["launches"] = sum(fm_paths.values())
    records["fm_second_order"]["launches_by_path"] = fm_paths
    # phase 12's, 14's and 15's checks at their own shapes sit beside each kernel's others
    for name in ("fm_second_order", "din_attention", "din_attention_bwd"):
        records[name].setdefault("other_shapes", {}).update(cli_checks[name])
    for name in ("din_attention", "din_attention_bwd"):
        records[name]["other_shapes"].update(seq_records[name])
        records[name]["other_shapes"].update(ls_records[name])
    forward_paths = dict(din_serving=serve_launches, din_training=train_launches,
                         din_fused_training=din_fused["din_attention"], **cli_launches["din_attention"],
                         **seq_launches["din_attention"], **ls_launches["din_attention"],
                         **mesh_launches["din_attention"])
    records["din_attention"]["launches"] = sum(forward_paths.values())
    records["din_attention"]["launches_by_path"] = forward_paths
    bwd_paths = dict(din_training=bwd_launches, din_fused_training=din_fused["din_attention_bwd"],
                     **cli_launches["din_attention_bwd"], **seq_launches["din_attention_bwd"],
                     **ls_launches["din_attention_bwd"], **mesh_launches["din_attention_bwd"])
    records["din_attention_bwd"]["launches"] = sum(bwd_paths.values())
    records["din_attention_bwd"]["launches_by_path"] = bwd_paths
    scatter_paths = dict(fm_fused_training=fm_scatter_launches,
                         din_fused_training=din_fused["fused_scatter_add"], **fm_family_launches,
                         **dcn_rest_launches, **cli_launches["fused_scatter_add"], **mt_launches,
                         **seq_launches["fused_scatter_add"], **ls_launches["fused_scatter_add"],
                         **mesh_launches["fused_scatter_add"])
    records["fused_scatter_add"] = dict(embedding["fm_v"], launches=sum(scatter_paths.values()),
                                        launches_by_path=scatter_paths,
                                        other_shapes=dict(fm_w=embedding["fm_w"], din=embedding["din"],
                                                          **fm_family_scatter, **nfm_scatter,
                                                          **cli_checks["fused_scatter_add"],
                                                          **mt_scatter, **seq_records["fused_scatter_add"],
                                                          **ls_records["fused_scatter_add"]))
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
    print(json.dumps(ok_line(torch)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
