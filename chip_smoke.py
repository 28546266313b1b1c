#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--out results.json]

Needs one CUDA device (an H100 for the ``sm_90a`` kernels) and ``nvcc``; it
builds the kernels from ``src/repro_torch/kernels/csrc`` at first use.
Phases, each of which fails the run by raising:

1. device: the card's name and power limit, the kernels' build time and
   ``ptxas`` lines (the bfloat16 SSD kernel's registers and spills printed
   again), and the count of tensor-core instructions (``HMMA`` / ``HGMMA``)
   in the SASS of the three bfloat16 tensor-core kernels, flash attention,
   cross-entropy and SSD (from ``cuobjdump -sass`` of the built library;
   "not available" without it); a kernel without one fails the phase;
2. the Parzen kernel against its plain PyTorch version on numpy-seeded
   inputs, first at the main path's own shape (24 candidates against the
   estimators of phase 3's and phase 4's final histories, unpadded), then
   at the reference's shapes; a second call on the same inputs must give
   the same bits; times from CUDA events around eager calls, and around a
   CUDA graph of the calls (the card's time, without the host's);
3. the main path as a user calls it: ``create_study(engine="cuda",
   pruner=MedianPruner())`` and ``study.optimize(objective, n_trials=4096,
   ask_batch=32)`` with Optuna's default sampler settings.  With those
   defaults almost every trial is pruned and pruned trials stay out of the
   TPE history, so the phase prints the history sizes and the pruned share;
4. the same search run as a fleet of 32 workers would run it, with pruned
   trials kept in the history (``consider_pruned_trials=True``): each wave
   of 32 trials is asked, sampled and evaluated against one history
   version, then told together.  This is the traffic that builds the
   4096-point score table, the kernel's large shape.
   In phases 3 and 4 the kernels' launch counts are set to 0 just before
   the study and read just after, and held against the ``tpe.score``
   spans; each kernel is then timed at the shapes the study's final
   history gives it;
5. engine agreement: a seeded 14-trial study on ``engine="numpy"`` and on
   ``engine="cuda"`` picks the same parameters;
6. the Monte-Carlo hypervolume counting kernel against its plain PyTorch
   version, exactly (integer counts), at the reference's test shapes, NaN
   point rows, exact ties, one point, the estimator's 25 x 8192 x 5 and a
   4096 x 65536 x 8 shape that needs several staged point tiles; then (6b)
   the batched kernel, one launch a greedy step of ``solve_hssp``, at
   MOTPE's boundary-rank shape (60 points of DTLZ2's front, 25 picks): the
   samples its threads make equal the host's float32 draw bit for bit for
   every set, its picks equal the ``"torch"`` engine's, and its counts the
   plain version's at the singletons, a middle step and the last step;
7. the multi-objective main path: MOTPE (``TPESampler(multi_objective=True,
   engine="cuda")``) on 5-objective DTLZ2 with 14 variables, 512 trials as
   waves of 32 (half of a 1024-trial study, which ran 303 s on an H100).
   The kernels' launch counts are set to 0 just before the study and read
   just after: the per-call counting kernel's must equal the estimator's
   per-call counts, the batched kernel's the batches made and at most k a
   ``solve_hssp`` call (the singletons, then one a greedy step); the trials'
   SHA-256 is printed (``scripts/kernel_baseline.py --only motpe`` compares
   it with another commit's); the final split is held identical between the
   ``"cuda"`` and ``"torch"`` engines on the card, and both counting kernels
   are checked at the shapes the study gave them (the below set and front 0
   for the per-call one, the largest greedy step for the batched one);
8. NSGA-II (``engine="cuda"``) on the same DTLZ2, 1024 trials as waves of
   24, and ``study.best_trials`` on the card against the pairwise loop;
9. the flash-attention kernels against their plain PyTorch version (atol /
   rtol 1e-4 in float32, the CUDA-core kernel; 2e-2 in bfloat16, the
   tensor-core kernel; each at most a tenth of the reference output's root
   mean square) at the reference's test shapes, window, softcap and
   non-causal cases in both dtypes, every head width in bfloat16 at a
   served group's length (1895, GQA 8x), a ``q_offset`` / ``kv_len`` shape
   and the main path's prefill shapes (tinyllama-1.1b, gemma2-9b windowed
   and global), each with its time, TFLOP/s and share of the bound, the
   plain version's time, ``scaled_dot_product_attention``'s where it
   computes the same function, and the kernel's ``ptxas`` build;
10. the serving main path at tinyllama-1.1b's full width (22 layers,
    random weights from a seeded generator): (a) ``repro_torch.launch.
    serve.main`` with its defaults; (b) the ``Engine`` with 16 requests of
    512-2048 tokens, 8 slots, capacity 4096, 64 new tokens each; (c) the
    first group's prefill and 64 teacher-forced decode steps on the
    ``"cuda"`` and ``"torch"`` attention engines, held to each other.
    The flash-attention launch count is set to 0 just before (a) and (b)
    and must equal 22 layers x the prefill groups just after.  Between
    (b) and (c) a ``torch.profiler`` trace of 16 decode steps of the first
    group gives the card's idle share during decode;
11. the same at gemma2-9b's full width cut to 2 superblocks (4 layers: two
    sliding-window layers on ring caches, two global, softcap 50): two
    requests of 4608 and 8192 tokens, capacity 8224, 16 new tokens;
12. the fused cross-entropy kernels against their plain PyTorch version
    (atol 1e-4, rtol 1e-5; a bfloat16 x's tensor-core kernel against the
    plain version run in float64 on the same bf16-rounded operands, the
    float32 plain version's own distance printed beside) at the tune
    study's shapes, ragged edges in float32 and bfloat16 with and without
    softcap 30 and each W layout, and the training shapes of
    tinyllama-1.1b (T 16384, D 2048, V 32000) and gemma2-9b (T 8192, D 3584,
    V 256000, softcap 30, the tied head as a transposed view), each with
    its time, TFLOP/s and share of the bound, the plain version's time and
    ``F.cross_entropy(x @ W)``'s where it computes the same function; the
    kernels' ``ptxas`` lines; then the Function's dx / dW against autograd
    through the plain version;
13. the flash-attention Function's dq / dk / dv against autograd through
    the plain version: tinyllama's heads at B 2, S 2048 in bf16 and f32,
    gemma2's (window 4096, softcap 50, D 256) at B 1, S 8192;
14. training tinyllama-1.1b at full size through ``repro_torch.launch.
    train.main``: 8 steps of batch 8 x 2048 tokens, bf16 compute, AdamW,
    each step synchronized and timed, the two kernels' launch counts set to
    0 just before and held to 1 and 2 x 22 a step just after, falling
    finite losses; then one batch's loss on the ``cuda`` and ``torch``
    engines, and a ``torch.profiler`` trace of one step (the card's idle
    share, kernel time by kind, ``build/train_trace_tinyllama.json``);
15. the same through ``Trainer`` at gemma2-9b's full width cut to 4 layers:
    3 steps of 1 x 8192 tokens (window, softcaps, D 256, the tied 256k
    head);
16. a dense tune study, ``make_lm_objective(LMTuneSpec(families=
    ("dense",)))`` with ``TPESampler(seed=0, engine="cuda")`` and
    ``SuccessiveHalvingPruner(min_resource=10, reduction_factor=2)``, 16
    trials: the Parzen, cross-entropy and flash-attention launch counts all
    above 0, the best trial deployed through ``FixedTrial``;
17. the SSD chunk-scan kernels against their plain PyTorch version run in
    float64 (y and the final state within atol 2e-3 and a tenth of the
    exact output's rms) at the reference's test sweep, 4 groups with an
    initial state, an odd and a prime S, the smoke and tune widths and
    zamba2's prefill (with the cache's initial state) and training shapes
    (B 8, S 2048, 64 heads, P = N = 64, L 128, bf16 x / B / C read as
    strided slices of the conv output): bf16 rows run the tensor-core
    kernel, float32 rows (zamba2's prefill among them) the CUDA-core one;
    each with its time (eager, and the card's in a CUDA graph), the plain version's and
    the bound (and the bytes' bound alone); the kernels' ``ptxas``
    registers and spills; the Function's gradients against autograd
    through the plain version at two shapes;
18. the serving main path at zamba2-1.2b's full size (38 mamba2 blocks and
    6 applications of the shared attention / SwiGLU block, random weights
    from a seeded generator): (a) ``launch.serve.main`` on the arch, (b)
    the ``Engine`` with phase 10(b)'s traffic, (c) the first group on the
    ``"cuda"`` and ``"torch"`` engines in float32 compute (last-token
    logits within 1e-3, then the teacher-forced decode), the bfloat16 gap
    measured beside it; the SSD launches must equal 38 and the flash
    launches 6 x the prefill groups in (a) and (b);
19. training zamba2-1.2b at full size through ``launch.train.main``: 8
    steps of 8 x 2048 tokens, bf16, AdamW, remat; 1 cross-entropy, 2 x 6
    flash and 2 x 36 + 2 SSD launches a step (the two tail blocks are
    outside the recomputed stack), a falling finite loss (and the first
    batch's loss lower at the trained weights than at the initial ones), the ``cuda`` and
    ``torch`` engine losses within 1e-3, a traced step, and the SSD
    kernel's and its written-out backward's share of the step;
20. phase 16's study over ``families=("dense", "mamba2")``: trials of both
    families complete or are pruned, none raises, every kernel of the path
    launched;
21. the sLSTM recurrence kernels against their plain PyTorch version run in
    float64 (every step's h, c, n, m within 1e-5 + 1e-5 |x| of one float64
    step from the kernel's own entering state; the whole run's h_seq and
    final state within a tenth of the exact output's rms, the float32
    plain version's own distance printed beside) at the reference's test
    sweep, an initial state, S = 1, an odd S, the smoke width and
    xlstm-1.3b's prefill / training shape (B 8, S 2048, 4 heads of 512,
    bf16 pre-activations read as a slice of a wider tensor), its decode
    shapes (B 8 and 4, S 1: the decode kernel, its card time from a CUDA
    graph beside the eager one) and phase 22(b)'s prefill groups, each with
    its time, the plain version's, the bound, the kernels' ``ptxas``
    registers and spills and the blocks launched; two calls at the
    prefill / training shape must give equal bits; the Function's
    gradients against autograd through the plain version at two shapes;
22. the serving main path at xlstm-1.3b's full size (42 mLSTM and 6 sLSTM
    blocks, random weights from a seeded generator): (a) ``launch.serve.
    main`` on the arch, (b) the ``Engine`` with phase 10(b)'s traffic, (c)
    the first group on the ``"cuda"`` and ``"torch"`` engines in float32
    compute (last-token logits within 2.5e-2: the two sLSTM runs drift
    apart over the prompt's steps, see XLSTM_F32_LOGITS_TOL; then the
    teacher-forced decode), the bfloat16 gap measured beside it; the sLSTM
    launches must equal 6 x (prefill groups + decode steps): a decode step
    runs the block's full form on one token;
23. training xlstm-1.3b at full size through ``launch.train.main``: 3 steps
    of 8 x 2048 tokens, bf16, AdamW, remat; 1 cross-entropy and 2 x 6 sLSTM
    launches a step, finite losses, the ``cuda`` engine's loss within 3e-3
    of the ``torch`` engine's on one batch of 8 x 256 tokens and of the
    plain version summing in the kernel's order on one of 8 x 2048 (the
    ``torch`` engine, the plain version in float64 and in a second float32
    order recorded beside it), a traced step, the loss of one batch of 8 x 256 tokens
    falling over 8 AdamW steps on that batch (XLSTM_DESCENT_SEQ), and the
    sLSTM kernel's and its written-out backward's share of the step;
24. phase 16's study over ``families=("dense", "mlstm", "mamba2")``;
25. the serving main path at deepseek-v2-lite-16b's full width (MLA with
    kv_lora 512 and one shared rope key head of 64; 64 routed experts top-6
    of 1408 and 2 shared, the einsum dispatch; vocab 102400) cut in depth to
    the dense head layer and 7 MLA/MoE layers (DEEPSEEK_SERVE_SUPERBLOCKS),
    random weights from a seeded generator: (a) ``launch.serve.main`` on
    the smoke config, (b) the ``Engine`` with phase 10(b)'s traffic (no
    kernel runs there: MLA and MoE are plain products, so every launch
    count must stay 0), a ``torch.profiler`` trace of 16 decode steps (idle
    share) and of one prefill group, its device time split by the span that
    launched it (MoE one-hot dispatch / combine, MoE expert GEMMs, the MLA
    chunk loop, other GEMMs and kernels), (c) the first group's prompts cut
    to 512 tokens in float32 compute at ``moe_capacity`` 8 through the
    einsum and the sort dispatch, every position's logits within 1e-4, each
    dispatch's two calls equal bit for bit;
26. training deepseek-v2-lite-16b at full width cut to 1 + 3 layers
    through ``Trainer``: 3 steps of 8 x 2048 tokens, bf16, AdamW, remat; 1
    cross-entropy launch a step, finite losses, the ``cuda`` and ``torch``
    engine losses within 3e-3, a traced step (device time also by span),
    and phase 23's descent check on one batch of 8 x 256 tokens;
27. qwen3-moe-235b-a22b at full width (64 / 4 heads of 128: GQA 16x; 128
    experts top-8 of 1536; vocab 151936): the flash kernel held to its
    plain version at the two served groups' prefill shapes (phase 9's
    bounds), ``launch.serve.main`` on the smoke config, the ``Engine``
    with phase 10(b)'s traffic at 2 of 94 layers (the flash launches must
    equal 2 x the prefill groups) and a traced prefill group, then 3
    ``Trainer`` steps of 8 x 2048 tokens at 1 layer with the config's
    Adafactor and 8 microbatches (8 cross-entropy and 8 x 2 flash launches
    a step);
28. phase 16's study over the default families, ``("dense", "mlstm",
    "mamba2", "moe")``: at least one ``moe`` trial completes or is pruned,
    none fails.
29. the storage stack and distributed workers: (a) phase 3's objective,
    ``TPESampler(seed=0, engine="cuda")`` and ``MedianPruner``, 256 trials
    on in-memory, ``sqlite:///`` and ``journal://`` files, ``remote://`` to a
    ``StorageServer`` in this process on protocol 1, the same on protocol 2
    with ``cache=True``, and two shards: every backend's trials (number,
    state, params, values, intermediate values) hash alike and launch the
    Parzen kernel as often, none is left RUNNING; (b) ``run_workers`` with
    4 spawned workers x 256 trials over a served sqlite file (v2 and the
    cache), each sampling on the card and recording its pid, its Parzen
    launches and its card as user attrs: all 1024 trials finished, numbered
    0-1023, four pids each with launches; (c) 2 spawned workers x 64 trials
    on a journal file, no server (the file lock across processes); (d) in
    this process, which has used the card, ``start_method="fork"`` is
    refused before any process starts.
30. trial-parallel tuning under a live dashboard: phase 28's study on a
    ``sqlite:///`` file under ``build/``, its 16 trials cut to 20 train
    steps (4 threads on one card run slower than one) run by
    ``TrialSliceScheduler`` on 4 slices that all name the one card (the
    opening wave enqueued one trial a family), while a ``DashboardService``
    on the same URL (a second reader of the file) is polled for
    ``/delta`` every 0.25 s: no trial FAILs (a kernel that does not build or
    launch inside a trial stops the run), every family trains and reports,
    every slice runs a trial and trials overlap, the launch counts follow
    phase 28's rules, the polls ship every finished trial's row exactly
    once, 5 idle polls after the study stops read no trial data, and
    ``/views``, ``/importance``, ``/metrics``, the index page and
    ``save_dashboard`` (``build/phase30_dashboard.html``) answer.
31. the multi-GPU path: tinyllama-1.1b at full width (d_model 2048, 32 / 4
    heads, d_ff 5632, vocab 32000) cut to 2 layers through
    ``launch.specs.build_step`` on a ``DeviceMesh``, in the world of a fixed
    rule (``sharded_worlds``, printed): 4 NCCL ranks, one a card, in a
    (2, 2) ("data", "model") mesh when the machine has 4 cards, else one
    NCCL rank on cuda:0 in a (1, 1) mesh.  In float32 (TF32 off): gathered
    ``make_sharded_init`` bit for bit ``init_model_params``; 2 sharded
    train steps of 4 x 512 tokens against the unsharded step on the same
    card (loss and every parameter within atol 1e-5 / rtol 1e-4); the
    prefill and decode cells' first logits and 8 greedy tokens of 4 prompts
    against the unsharded ``Engine``.  In bfloat16: 2 steps of
    ``build_step``'s own step (AdamW as shipped) against the unsharded
    one, the losses and gradient norms within 4 bf16 roundings, at most 1%
    of the parameter entries an AdamW step apart (``SHARDED_BF16_*`` says
    why).  The flash and cross-entropy launch counts of each rank's sharded
    steps must be 2 x 2 layers and 1 a step (the kernels ran on the
    shards); ``compressed_psum`` over tinyllama's gradients within its int8
    bound; ``pipelined_apply`` over the world's ranks against the
    sequential composition.  Prints the sharded and unsharded step times
    (3 more steps each after the checked ones), each rank's resident bytes
    and step peak.
32. the launch analysis tooling: (a) phase 31's model (tinyllama-1.1b at
    full width, 2 layers) in bf16, a 4 x 512 train step and a prefill
    through ``build_step`` on a (1, 1) mesh, counted by
    ``launch.op_analysis.analyze_step`` once on real CUDA tensors (a world
    of one NCCL rank: the kernels launch through their custom ops) and once
    on fake CUDA tensors (a world of one fake rank: nothing runs): equal
    FLOPs, bytes and per-op counts, each kernel op's count equal to its
    wrapper's launch count, the fake train step's peak memory
    (``MemTracker``) within 10% of the real step's
    ``max_memory_allocated``; the measured step seconds beside the three
    roofline terms, and the flash and cross-entropy kernels' share of the
    bound their registered formulas give at the step's shapes; (d) what the
    op dispatch costs a call (the op against its own function, in turns) at
    the score table's Parzen shape and tinyllama's prefill flash shape; (b)
    ``launch.dryrun.run_cell("smollm-135m", "decode_32k", multi_pod=True)``
    on 512 fake ranks and fake CUDA tensors (the reference's dry-run cell:
    512 chips, under 80 GB a card, FLOPs counted); (c) tinyllama-1.1b's
    ``train_4k`` cell at full width cut to 6 layers on the 256-rank
    single-pod world, its flash and cross-entropy op counts and FLOP shares.
33. the sharded serving caches: (a) ``launch.dryrun.run_cell`` on fake CUDA
    tensors at full width cut to 2 layers (``two_layers``) of gemma2-9b's
    ``long_500k`` and deepseek-v2-lite-16b's ``prefill_32k`` on 512 ranks
    and zamba2-1.2b's and musicgen-medium's ``decode_32k`` on 256: memory a
    card under 80 GB, the flash and SSD op counts (none: decode and MLA
    blocks launch no kernel), collectives by mesh dim (gemma2's sequence
    combine on "pod" and "data", zamba2's conv gather on "model"); (b) in
    phase 31's world, a (1, 2, 2) ("pod", "data", "model") mesh over 4
    NCCL ranks with 4 cards (batch 1 splits every KV cache's rows over
    "data"), else a (1, 1, 1) mesh over one (which says that no split path
    ran), gemma2-9b (one window and one global layer) and zamba2-1.2b (one
    mamba2 block and the shared attention block) at full width in float32
    with a float32 cache of ``long_500k``'s 524288 slots: a 4101-token
    prompt (it crosses the window ring's shard boundary and wraps it) and 4
    decode steps through ``build_step``'s serving cells, every logit within
    atol 1e-5 / rtol 1e-4 of the unsharded ``Engine`` on the plain PyTorch
    versions of the kernels on the same card (so the float32 flash kernel
    is held to its plain version at head width 256, window 4096 and softcap
    50, and the SSD kernel from a cached state); the sharded prefill
    counted by ``op_analysis.analyze_step``: each rank's flash and SSD
    launches equal to its ops' counts (2 / 0 and 1 / 1), none in the decode
    steps.
34. the xLSTM blocks under a mesh: (a) ``launch.dryrun.run_cell`` of
    xlstm-1.3b's 8 cells (4 shapes on 256 and 512 fake ranks) at full
    width cut to one superblock (7 mLSTM + 1 sLSTM), on fake CUDA tensors
    in two worker processes started after the build (host-bound, no card):
    memory a card under 80 GB, the roofline's terms and the
    ``repro_torch::slstm`` op's count (1 a serving step, 2 a train step);
    (b) in phase 31's world, a (2, 2) ("data", "model") mesh over 4 NCCL
    ranks with 4 cards (2 of the 4 heads a rank), else a (1, 1) mesh over
    one, xlstm-1.3b at full width and one superblock in float32 with its
    float32 caches through ``build_step``'s serving cells: a prefill of 2
    prompts of 320 tokens and 4 teacher-forced decode steps, every logit
    within atol 1e-5 / rtol 1e-4 of the unsharded steps, their prefill on
    the sLSTM kernel and on its plain version (on 4 ranks plus 4 x the
    model's own float32 sensitivity, ``two_part_sums``: split over "model"
    the sums run in another order, which the exponential gates amplify),
    each step counted by ``analyze_step``: one sLSTM launch a prefill and
    a decode step, each its op's count, every cache leaf over heads; (c) 2
    sharded float32 train steps of 2 x 512 tokens against the unsharded
    step on the same card (phase 31's bound), 2 sLSTM and 1 CE launches a
    step, both step times.
35. MoE training under a mesh at qwen3-moe-235b-a22b's full width: (a) the
    born-sharded init's peak over the resident shards; (b) the sort
    dispatch at capacity 0.5, one layer, float32, 2 SGD steps of 8 x 512 in
    8 microbatches, each step's gradients held leaf by leaf against the
    unsharded step's (within 1e-5 of the leaf's largest on one card, within
    4 x the model's own float32 sensitivity, ``moe_two_part_sums``, on
    several; that sensitivity under a fixed ceiling), and served; (c) with 4 cards thin microbatches side by side;
    (d) ``train_4k`` on 512 fake ranks at 6 layers.
36. a prefill's rows in chunks by the memory rule of ``launch.specs.
    build_step``: (a) llava-next-34b's ``prefill_32k`` on 512 fake ranks at
    full width and depth in a worker process started after the build: the
    row chunks, memory a card under 80 GB, the rule's estimate no lower than
    the measured peak and at most 1.5 x it, one flash op a layer a chunk;
    (b) in phase 31's world ((1, 2, 2) over 4 NCCL ranks with 4 cards, else
    (1, 1, 1)), llava at full width, 2 layers, float32, 4 rows of 1152 image
    embeddings and 2944 tokens through the flash kernel with each rank's
    rows in one chunk and in two: logits and KV cache within atol 1e-5 /
    rtol 1e-4 of the unsharded ``Engine`` on the plain versions plus 4 x
    the unsharded model's own distance between the kernel and the plain
    versions (that distance under a fixed ceiling), on one rank within the
    bound of the ``Engine`` on the kernel, one flash launch a layer a
    chunk, each its op's count, ``max_memory_allocated`` of both; (c) with
    4 cards, xlstm-1.3b's regime (B) on 3 ranks ((1, 3): 4 heads do not
    divide 3) served and trained as phase 34(b), (c), and gemma2-9b at 2
    layers with a 524288-row cache of seeded values split over "data": 8
    tokens prefilled from cache index 262136, then 16 decode steps across
    row 262144, each step's logits within phase 33's bound of the unsharded
    ``Engine``'s model on the plain versions plus 4 x that step's own such
    distance (under a fixed ceiling), and the KV rows written, each rank's
    shard of them on both sides of the boundary, within the bound of the
    plain ``Engine``'s cache.

Each phase's wall seconds are printed after it and in a line before the
total.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits with status 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import logging
import math
import re
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: tolerance of the reference's own engine parity (tests/test_engine.py)
ATOL, RTOL = 2e-4, 1e-4
#: H100 SXM rates from NVIDIA's data sheet: HBM3 bytes/s and FP32 FLOP/s
#: outside the tensor cores; the exp rate is the special-function units'
#: 16 results per clock per SM (CUDA programming guide, compute 9.0)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: FP64 FLOP/s outside the tensor cores (the same data sheet)
FP64_OPS_PER_S = 34e12
EXP_PER_CLOCK_PER_SM = 16
#: FP32 operations per (candidate, component) besides the exp
PARZEN_OPS_PER_PAIR = 8
#: DTLZ2 (Deb, Thiele, Laumanns, Zitzler 2005): objectives and distance
#: variables (the authors' k = 10), so 14 variables in [0, 1]
DTLZ2_M, DTLZ2_K = 5, 10
#: the hypervolume estimator's default sample count
MC_SAMPLES = 8192
#: H100 SXM dense tensor-core bf16 rate (NVIDIA's data sheet); float32
#: inputs use FP32_OPS_PER_S
BF16_TC_OPS_PER_S = 989e12
#: flash attention against its plain version: the reference's kernel
#: tolerances (tests/test_kernels.py), and the prefill logits of the two
#: attention engines: the reference's prefill / decode bound
#: (tests/test_models_smoke.py)
FA_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LOGITS_TOL = 8e-2
#: the cross-entropy kernel against its plain version: the same float32
#: products (W rounded to x's type in both) summed in another order, and an
#: online logsumexp against torch.logsumexp, on NLLs of order 10-15
CE_ATOL, CE_RTOL = 1e-4, 1e-5
#: written-out backwards against autograd through the plain versions, as a
#: fraction of the largest |gradient|: float32 sums in another order; in
#: bfloat16 one bfloat16 rounding (a relative step of 2**-8) of each side
#: (GRAD_TOL: flash attention's and the SSD scan's, whose float32 sums run
#: longer than cross-entropy's; in bfloat16 the SSD's dx, dB and dC)
CE_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-7}
#: the training loss of one batch on the cuda and torch engines (bf16
#: compute), about 1e-4 of a loss near ln(32000) = 10.4.  The engines differ
#: by one bf16 rounding of each attention output (phase 9's 2e-2 on outputs
#: of order 1) and by the float32 order of the cross-entropy sums, and the
#: per-token differences average over the batch's tokens: on the H100 the
#: gaps were 4.5e-5 (tinyllama) and 1.0e-4 (gemma2, 4 layers), so 1e-3
#: leaves ten times the larger and still fails a path off by 1e-4 of the loss
TRAIN_LOSS_TOL = 1e-3
#: zamba2's last-token prefill logits on the cuda and torch engines in
#: float32 compute with a float32 cache: the SSD kernel and its plain
#: version sum in another order (and over other chunk lengths), flash
#: attention likewise; on the H100 the gap was 2.8e-5 on logits of rms 0.91
#: through 44 blocks, so 1e-3 leaves 30 times that
HYBRID_F32_LOGITS_TOL = 1e-3
#: the same in bfloat16 compute and cache, on the same (bf16-rounded)
#: weights.  On the H100 each engine lay about 0.2 from the float32 plain
#: engine's logits (max |d|: cuda 0.206, torch 0.193), so bf16 rounding
#: through 44 blocks moves a logit by 0.2 on either path; the engines lay
#: 0.154 apart.  The gap is held to 0.25, and the kernels' engine to 1.5x
#: the plain engine's distance from float32 (it was 1.07x)
HYBRID_BF16_LOGITS_TOL = 0.25
HYBRID_BF16_RATIO = 1.5
#: xlstm's last-token prefill logits on the two engines in float32 compute
#: (a float32 cache): the sLSTM kernel and its plain version each stay
#: within float32 rounding of every step (phase 21), but the recurrence
#: amplifies that rounding over the steps, and the two runs of the 6 sLSTM
#: blocks drift apart: on the H100 the logits (rms 1.0) lay 9.5e-4 apart
#: after 256 prompt tokens and 8.0e-3 after 2022, so 2.5e-2, three times
#: that, stands where zamba2's 1e-3 does
XLSTM_F32_LOGITS_TOL = 2.5e-2
#: the same in bfloat16 compute.  Rounding to bfloat16 in 48 blocks moves
#: xlstm's logits by order 1 at these random weights, on both engines and
#: in the reference alike (on the CPU, at full width cut to 8 blocks and 128
#: tokens, the reference's bfloat16 logits lay 2.13 from its float32 ones,
#: rms 1.0; the port's 1.57): on the H100 the two engines lay 6.34 (cuda) and
#: 5.69 (torch) from the float32 logits and 2.68 apart.  The gap is held to
#: 4.0 and the kernels' engine to HYBRID_BF16_RATIO x the plain engine's
#: distance from float32 (it was 1.11x)
XLSTM_BF16_LOGITS_TOL = 4.0
#: one batch's training loss on the ``cuda`` engine against the plain
#: version: the ``torch`` engine at XLSTM_DESCENT_SEQ tokens, and the plain
#: version summing h @ R in the kernel's order (slstm_kernel_order) at the
#: training length, 8 x 2048.  There the float32 runs of the recurrence lie
#: above the float64 plain version by amounts that follow the summation
#: order: on the H100, at the same weights (losses near 11.32), the plain
#: version with the dims reversed +1.6e-4, in its einsum order +2.9e-3, in
#: the kernel's order +5.7e-3, the kernel +6.9e-3.  The kernel lies 1.2e-3
#: from the plain version in its own order and 3.9e-3 from the einsum order
#: (7.4e-4 with its earlier grid-barrier design, which summed otherwise)
XLSTM_TRAIN_LOSS_TOL = 3e-3
#: phase 23's descent check: AdamW at the launcher's lr (3e-4) on one batch
#: of 8 x 256 tokens, 8 steps, at full width and depth in bfloat16.  At 2048
#: tokens xlstm-1.3b's loss at random weights is too rough for a few steps
#: to show a descent (scripts/xlstm_descent_probe.py, on the H100): in
#: float32, |grad| was 4.2e5, and steps along -grad / |grad| of every length
#: from 1e-9 to 1e-6 moved the loss by 2e-4 to 5e-3 with either sign; 6
#: AdamW steps moved it by -0.015 and, with the lr's sign flipped, +0.001.
#: At 256 tokens 8 steps lowered the loss by 0.099 to 0.144 on three batches
#: and the flipped updates raised it by 0.069 to 0.124
XLSTM_DESCENT_SEQ, XLSTM_DESCENT_STEPS = 256, 8


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, from CUDA
    events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int, reps: int) -> float:
    """Device milliseconds per call of ``fn``: ``calls`` calls captured in one
    CUDA graph, replayed ``reps`` times between CUDA events, after a warm-up
    call.  The host's time per call (the wrapper's checks, allocation and
    launch) is left out, which events around eager calls count whenever the
    host is slower than the card."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * calls)


def parzen_bound_ms(n_cands: int, n_l: int, n_g: int, sm_clock_hz: float) -> tuple[float, str]:
    """Least time the card could take for one Parzen score: the larger of
    the exps over the SFU rate, the other FP32 operations over the FP32
    peak, and the bytes (each input read once, the output written once)
    over the memory rate."""
    pairs = n_cands * (n_l + n_g)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    exp_s = pairs / (EXP_PER_CLOCK_PER_SM * sm * sm_clock_hz)
    ops_s = pairs * PARZEN_OPS_PER_PAIR / FP32_OPS_PER_S
    bytes_s = 4 * (2 * n_cands + 3 * (n_l + n_g)) / HBM_BYTES_PER_S
    bound = max(exp_s, ops_s, bytes_s)
    return bound * 1e3, ("bytes" if bound == bytes_s else "operations")


def synthetic_mixture(rng: np.random.RandomState, k: int, n_pad: int):
    """A realistic fitted mixture of ``k - n_pad`` components plus ``n_pad``
    inert padding components (``log_norm = -inf``)."""
    from repro_torch.core.samplers.tpe import _ParzenEstimator

    real = k - n_pad
    obs = rng.uniform(-3.0, 3.0, real - 1)
    est = _ParzenEstimator(obs, -3.0, 3.0, rng.uniform(0.5, 1.0, real - 1))
    mus = np.concatenate([est.mus, np.zeros(n_pad)])
    sigmas = np.concatenate([est.sigmas, np.ones(n_pad)])
    ln = np.concatenate([est._log_norm, np.full(n_pad, -np.inf)])
    return mus, sigmas, ln


def check_parzen(args, label: str, reps: int, sm_clock_hz: float) -> dict:
    """The kernel against its plain version (ATOL / RTOL), and a second call
    on the same inputs equal to the first bit for bit; ``ms`` is CUDA events
    around eager calls, which the host bounds at small shapes, ``card_ms``
    the card's time a call (a CUDA graph of the calls)."""
    from repro_torch.kernels.parzen import parzen_score
    from repro_torch.kernels.ref import parzen_score_ref

    out = parzen_score(*args)
    again = parzen_score(*args)
    ref = parzen_score_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
    assert torch.equal(out, again), (label, "two calls on the same inputs differ")
    err = float((out - ref).abs().max())
    n_cands, n_l, n_g = len(args[0]), len(args[1]), len(args[4])
    # the bound counts the components the data holds; padding (log_norm =
    # -inf) is work the kernel does but the function does not need
    real_l = int(torch.isfinite(args[3]).sum())
    real_g = int(torch.isfinite(args[6]).sum())
    ms = time_ms(lambda: parzen_score(*args), reps)
    card_ms = graph_ms(lambda: parzen_score(*args), 20, max(1, reps // 10))
    plain_ms = time_ms(lambda: parzen_score_ref(*args), reps)
    bound_ms, bound_by = parzen_bound_ms(n_cands, real_l, real_g, sm_clock_hz)
    row = {
        "label": label, "C": n_cands, "Kl": n_l, "Kg": n_g,
        "Kl_real": real_l, "Kg_real": real_g, "max_abs_err": err, "bitwise_repeat": True,
        "ms": ms, "card_ms": card_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    print(
        f"  parzen {label:<22} C={n_cands:<5} Kl={n_l:<5} ({real_l:<5} real) "
        f"Kg={n_g:<5} ({real_g:<5} real) max_abs_err={err:.3e} repeat bit-equal; "
        f"kernel={ms:.4f} ms (card {card_ms:.5f}) plain={plain_ms:.4f} ms "
        f"bound={bound_ms:.6f} ms ({bound_by})"
    )
    return row


#: the estimators' component counts (observations + the prior) at phase 3's
#: and phase 4's final histories (x0: 1 below + 9 above, 25 + 4071, the same
#: in every run: the studies are seeded), which the main path scores its 24
#: EI candidates against
MAIN_PATH_COMPONENTS = ((2, 10), (26, 4072))


def phase_kernels(sm_clock_hz: float) -> list[dict]:
    """Phase 2: the Parzen kernel against its plain version."""
    print("phase 2: parzen_score kernel vs plain PyTorch version; "
          f"{nvidia_smi('name,power.limit')}")
    rng = np.random.RandomState(0)
    rows = []
    for n_l, n_g in MAIN_PATH_COMPONENTS:  # the main path's own shape: C = 24, unpadded
        args = [torch.from_numpy(np.asarray(a, np.float32)).cuda()
                for a in (rng.uniform(-3.5, 3.5, 24), *synthetic_mixture(rng, n_l, 0),
                          *synthetic_mixture(rng, n_g, 0))]
        rows.append(check_parzen(args, "main path C=24", 100, sm_clock_hz))
    for n_l, n_g in ((32, 4096), (26, 2023), (8, 8)):
        for padded in (False, True):
            l_side = synthetic_mixture(rng, n_l, n_l // 4 if padded else 0)
            g_side = synthetic_mixture(rng, n_g, n_g // 4 if padded else 0)
            for n_cands in (24, 4096, 1000):
                cands = rng.uniform(-3.5, 3.5, n_cands)
                args = [
                    torch.from_numpy(np.asarray(a, np.float32)).cuda()
                    for a in (cands, *l_side, *g_side)
                ]
                label = "-inf padded" if padded else "no padding"
                rows.append(check_parzen(args, label, 20, sm_clock_hz))
    return rows


def objective(trial) -> float:
    """Eight parameters of a typical model-tuning search space, four
    intermediate reports and a prune check per trial."""
    import repro_torch.core as hpo

    xs = [trial.suggest_float(f"x{i}", -5.0, 5.0) for i in range(4)]
    lr = trial.suggest_float("lr", 1e-5, 1e-1, log=True)
    width = trial.suggest_int("width", 1, 128, log=True)
    depth = trial.suggest_int("depth", 1, 8)
    act = trial.suggest_categorical("activation", ["relu", "tanh", "gelu"])
    loss = sum((x - 1.0) ** 2 for x in xs)
    loss += (math.log10(lr) + 3.0) ** 2 + 0.1 * abs(math.log2(width) - 5.0)
    loss += 0.2 * abs(depth - 3) + 0.3 * (act != "relu")
    for step in range(4):
        trial.report(loss * (1.0 + 1.0 / (step + 1)), step)
        if trial.should_prune():
            raise hpo.TrialPruned()
    return loss


def run_wave(study, n: int) -> None:
    """One wave of a fleet of ``n`` workers: every trial samples against the
    same finished history, and the wave's results are told together.  (The
    score table of ``TPESampler`` is built on the second score of one
    parameter at one history version, so this is the pattern that reaches
    the kernel's large shape.)"""
    import repro_torch.core as hpo

    results = []
    for trial in study.ask(n):
        try:
            results.append((trial, objective(trial)))
        except hpo.TrialPruned:
            _, value = trial.last_reported
            results.append((trial, value, hpo.TrialState.PRUNED))
    study.tell_batch(results)


def final_estimators(study, param: str = "x0"):
    """The Parzen estimators of ``param`` at the study's final history, and
    the sizes of the history's below and above sets."""
    from repro_torch.core.samplers.tpe import _ParzenEstimator

    fit = study.sampler._trial_fit(study, None)
    _, below, above, w_below, w_above = fit.split(param)
    low, high = -5.0, 5.0
    l_est = _ParzenEstimator(below, low, high, w_below)
    g_est = _ParzenEstimator(above, low, high, w_above)
    return l_est, g_est, len(below), len(above)


def drive_main_path(label: str, study, run) -> dict:
    """Run ``run()`` (which drives ``study``) with every launch count set to
    0 just before and read just after, under telemetry; check its result
    and print where the time went."""
    from repro_torch.core import telemetry
    from repro_torch.kernels import parzen

    telemetry.reset()
    telemetry.enable()
    parzen.reset_launches()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = parzen.launches()
    telemetry.disable()
    hists = telemetry.snapshot()["histograms"]

    trials = study.trials
    n_trials = len(trials)
    n_score = hists["tpe.score"]["count"]
    assert launches > 0, f"{label}: the study never launched the Parzen kernel"
    assert launches == n_score, (label, launches, n_score)
    for t in trials:
        for name, v in t.params.items():
            if name != "activation":
                assert math.isfinite(v), (label, t.number, name, v)
    assert math.isfinite(study.best_value), (label, study.best_value)
    states = {}
    for t in trials:
        states[t.state.name] = states.get(t.state.name, 0) + 1
    pruned_share = states.get("PRUNED", 0) / n_trials
    l_est, g_est, n_below, n_above = final_estimators(study)
    kl, kg = len(l_est.mus), len(g_est.mus)
    spans = {
        name: {"count": hists[name]["count"], "total_s": hists[name]["sum"],
               "mean_ms": 1e3 * hists[name]["mean"], "p99_ms": 1e3 * hists[name]["p99"]}
        for name in ("study.ask", "study.tell", "study.tell_batch", "tpe.fit",
                     "tpe.score", "storage.report_and_prune")
        if name in hists
    }
    result = {
        "label": label, "n_trials": n_trials, "seconds": seconds,
        "trials_per_s": n_trials / seconds, "parzen_launches": launches,
        "tpe_score_spans": n_score, "states": states, "pruned_share": pruned_share,
        "history_below": n_below, "history_above": n_above,
        "kernel_Kl": kl, "kernel_Kg": kg,
        "best_value": study.best_value, "spans": spans,
    }
    print(f"  {n_trials} trials in {seconds:.3f} s = {n_trials / seconds:.2f} trials/s; "
          f"states {states} (pruned share {pruned_share:.4f}); "
          f"best value {study.best_value:.6f}")
    print(f"  final TPE history of x0: {n_below} below + {n_above} above; "
          f"kernel components Kl={kl} Kg={kg} (unpadded)")
    print(f"  parzen_score launches {launches} == tpe.score spans {n_score}")
    for name, s in spans.items():
        print(f"  span {name:<26} count={s['count']:<7} total={s['total_s']:.4f} s "
              f"mean={s['mean_ms']:.4f} ms p99={s['p99_ms']:.4f} ms")
    return result


def kernel_at_history(study, tables: bool, sm_clock_hz: float) -> list[dict]:
    """The kernel at the shapes the study's final history gives it: direct
    scoring of the 24 EI candidates and, where the traffic builds it, the
    score table."""
    from repro_torch.core.samplers.tpe import _to_device, _triple
    from repro_torch.kernels import ops

    l_est, g_est, _, _ = final_estimators(study)
    rng = np.random.RandomState(1)
    runs = [(l_est.sample(rng, 24), "direct")]
    if tables:
        runs.append((np.linspace(-5.0, 5.0, ops.SCORE_TABLE_SIZE), "table"))
    rows = []
    for cands, label in runs:
        args = [_to_device(a, torch.device("cuda"))
                for a in (cands, *_triple(l_est), *_triple(g_est))]
        rows.append(check_parzen(args, label, 100, sm_clock_hz))
    return rows


def phase_optimize(sm_clock_hz: float) -> tuple[dict, list[dict]]:
    """Phase 3: the main path through ``Study.optimize`` with the defaults."""
    import repro_torch.core as hpo

    n_trials, ask_batch = 4096, 32
    print(f"phase 3: {n_trials}-trial study.optimize, engine='cuda', "
          f"MedianPruner, ask_batch={ask_batch}")
    study = hpo.create_study(engine="cuda", pruner=hpo.MedianPruner())
    study.sampler.reseed_rng(0)
    result = drive_main_path(
        "optimize", study,
        lambda: study.optimize(objective, n_trials=n_trials, ask_batch=ask_batch),
    )
    assert result["n_trials"] == n_trials, result["n_trials"]
    rows = kernel_at_history(study, False, sm_clock_hz)
    for r in rows:
        r["label"] = "optimize, " + r["label"]
    return result, rows


def phase_waves(sm_clock_hz: float) -> tuple[dict, list[dict]]:
    """Phase 4: the same search as waves of a 32-worker fleet."""
    import repro_torch.core as hpo

    n_trials, ask_batch = 4096, 32
    print(f"phase 4: {n_trials}-trial study in waves of {ask_batch}, engine='cuda', "
          f"MedianPruner, consider_pruned_trials=True")
    sampler = hpo.TPESampler(seed=0, engine="cuda", consider_pruned_trials=True)
    study = hpo.create_study(sampler=sampler, pruner=hpo.MedianPruner())

    def run():
        for _ in range(n_trials // ask_batch):
            run_wave(study, ask_batch)

    result = drive_main_path("waves", study, run)
    assert result["n_trials"] == n_trials, result["n_trials"]
    rows = kernel_at_history(study, True, sm_clock_hz)
    for r in rows:
        r["label"] = "waves, " + r["label"]
    return result, rows


def phase_agreement() -> None:
    """Phase 5: the reference's 14-trial engine-agreement study."""
    import repro_torch.core as hpo

    print("phase 5: 14-trial study, engine='numpy' vs engine='cuda'")
    params = {}
    for engine in ("numpy", "cuda"):
        s = hpo.create_study(sampler=hpo.TPESampler(seed=11, engine=engine))
        s.optimize(lambda t: t.suggest_float("x", -4, 4) ** 2, n_trials=14)
        params[engine] = np.array([t.params["x"] for t in s.trials])
    np.testing.assert_allclose(params["cuda"], params["numpy"], rtol=1e-5)
    err = float(np.max(np.abs(params["cuda"] - params["numpy"])))
    print(f"  params agree: max abs difference {err:.3e} (rtol 1e-5)")


# -- multi-objective slice ---------------------------------------------------------


def dtlz2(x: np.ndarray, m: int = DTLZ2_M) -> list[float]:
    """DTLZ2's objective vector of ``x`` in [0, 1]^(m - 1 + k)."""
    g = float(np.sum((x[m - 1:] - 0.5) ** 2))
    out = []
    for i in range(m):
        v = 1.0 + g
        for j in range(m - 1 - i):
            v *= math.cos(x[j] * math.pi / 2)
        if i > 0:
            v *= math.sin(x[m - 1 - i] * math.pi / 2)
        out.append(v)
    return out


def run_dtlz2_wave(study, n: int) -> None:
    """One wave of ``n`` DTLZ2 evaluations, asked together and told together."""
    results = []
    for trial in study.ask(n):
        x = np.array([trial.suggest_float(f"x{i}", 0.0, 1.0)
                      for i in range(DTLZ2_M - 1 + DTLZ2_K)])
        results.append((trial, dtlz2(x)))
    study.tell_batch(results)


def mc_compares(pts: torch.Tensor, smp: torch.Tensor) -> int:
    """Compares this data needs: each sample scans the points in order up to
    its second dominator (all of them when it has fewer), m compares each."""
    n, m = pts.shape
    scanned = 0
    chunk = max(1, (1 << 27) // (n * m))
    for start in range(0, len(smp), chunk):
        dom = (pts[None] <= smp[start:start + chunk, None]).all(dim=2)
        reached = dom.cumsum(dim=1) >= 2
        first = reached.to(torch.int8).argmax(dim=1) + 1
        scanned += int(torch.where(reached.any(dim=1), first, n).sum())
    return scanned * m


def raw_mc_launch(pts: torch.Tensor, smp: torch.Tensor):
    """A call of the counting kernel alone, into a buffer allocated once
    (the counts pile up across calls, which the timing does not read): the
    wrapper's allocation and float32 cast left out."""
    from repro_torch.kernels import _build

    lib = _build.load()
    n, m = pts.shape
    counts = torch.zeros(n + 1, dtype=torch.int32, device=pts.device)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = lib.mc_hv_counts_launch(pts.data_ptr(), n, smp.data_ptr(), len(smp), m,
                                      counts.data_ptr(), counts[n:].data_ptr(), stream)
        assert err == 0, err

    return launch


def check_mc(pts: torch.Tensor, smp: torch.Tensor, label: str, reps: int) -> dict:
    """The counting kernel against its plain version, exactly, with times
    from CUDA events and the bound from the real sizes."""
    from repro_torch.kernels.hypervolume import mc_hv_counts
    from repro_torch.kernels.ref import mc_hv_counts_ref

    excl, total = mc_hv_counts(pts, smp)
    excl_r, total_r = mc_hv_counts_ref(pts, smp)
    torch.cuda.synchronize()
    mismatches = int((excl != excl_r).sum()) + int(total != total_r)
    err = max(float((excl - excl_r).abs().max()) if len(excl) else 0.0,
              float((total - total_r).abs()))
    assert mismatches == 0, (label, mismatches, err)
    n, m = pts.shape
    s = len(smp)
    ms = time_ms(lambda: mc_hv_counts(pts, smp), reps)
    kernel_ms = time_ms(raw_mc_launch(pts, smp), reps)
    plain_ms = time_ms(lambda: mc_hv_counts_ref(pts, smp), max(3, reps // 10))
    compares = mc_compares(pts, smp)
    ops_s = compares / FP32_OPS_PER_S
    bytes_s = (4 * (n + s) * m + 4 * (n + 1)) / HBM_BYTES_PER_S
    bound_ms = 1e3 * max(ops_s, bytes_s)
    bound_by = "bytes" if bytes_s >= ops_s else "operations"
    row = {
        "label": label, "n": n, "s": s, "m": m, "mismatches": mismatches,
        "max_abs_err": err, "total": float(total), "compares": compares,
        "compares_all": s * n * m, "ms": ms, "kernel_only_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    print(f"  mc_hv {label:<22} n={n:<5} s={s:<6} m={m} mismatches={mismatches} "
          f"total={int(total):<6} wrapper={ms:.4f} ms (kernel alone {kernel_ms:.4f}) "
          f"plain={plain_ms:.4f} ms "
          f"bound={bound_ms:.6f} ms ({bound_by}; {compares} of {s * n * m} compares)")
    return row


def estimator_samples(pts: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """The estimator's own draw for ``pts``: uniform in ``[min(pts),
    reference]`` from a fresh ``RandomState(0)``, rounded once to float32."""
    rng = np.random.RandomState(0)
    smp = rng.uniform(pts.min(axis=0), reference, size=(MC_SAMPLES, pts.shape[1]))
    return smp.astype(np.float32)


def phase_mc_kernel() -> list[dict]:
    """Phase 6: the counting kernel against its plain version."""
    print("phase 6: mc_hv_counts kernel vs plain PyTorch version (exact)")
    rng = np.random.RandomState(0)
    dev = torch.device("cuda")
    cases = []
    # the reference kernel's own test shapes (n, m, s)
    for n, m, s in ((8, 3, 256), (20, 4, 1000), (64, 6, 2048), (3, 2, 100)):
        cases.append((f"reference {n}x{m}x{s}", rng.uniform(0, 1, (n, m)),
                      rng.uniform(0, 1.1, (s, m)), 100))
    pts = rng.uniform(0, 1, (30, 5))
    pts[::7, 1] = np.nan
    pts[11] = np.nan
    cases.append(("NaN point rows", pts, rng.uniform(0, 1.1, (3000, 5)), 100))
    pts = rng.randint(0, 4, size=(40, 3)).astype(float)
    pts[7] = pts[3]
    smp = rng.randint(0, 5, size=(2000, 3)).astype(float)
    smp[:40] = pts
    cases.append(("exact ties", pts, smp, 100))
    pts = rng.uniform(0, 1, (1, 5))
    cases.append(("one point", pts, estimator_samples(pts, np.ones(5) * 1.1), 100))
    pts = rng.uniform(0, 1, (25, 5))
    cases.append(("estimator 25x8192x5", pts, estimator_samples(pts, np.ones(5) * 1.1), 100))
    cases.append(("large 4096x65536x8", rng.uniform(0, 1, (4096, 8)),
                  rng.uniform(0, 1.1, (65536, 8)), 10))
    rows = []
    for label, pts, smp, reps in cases:
        P = torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(dev)
        S = torch.from_numpy(np.ascontiguousarray(smp, np.float32)).to(dev)
        rows.append(check_mc(P, S, label, reps))
    return rows


def dtlz2_front(rng: np.random.RandomState, n: int) -> np.ndarray:
    """``n`` objective vectors of DTLZ2 near its front (g in [0, 0.05]): the
    shape of MOTPE's boundary rank on phase 7's study."""
    return np.array([dtlz2(np.concatenate([rng.uniform(size=DTLZ2_M - 1),
                                           0.5 + rng.uniform(-0.05, 0.05, DTLZ2_K)]))
                     for _ in range(n)])


def _work(args: tuple) -> int:
    """Point-sample pairs of one ``mc_hv_counts_sets`` call."""
    return args[0].shape[0] * args[4].shape[0]


def mc_sets_compares(P, off, lo, span, u) -> tuple[int, int]:
    """(compares this data needs, float64 operations of the samples): each
    set's samples made by the plain version, then :func:`mc_compares`."""
    from repro_torch.kernels.ref import mc_hv_samples_ref

    bounds = off.tolist()
    compares = 0
    for g, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        if b > a:
            compares += mc_compares(P[a:b], mc_hv_samples_ref(lo[g:g + 1], span[g:g + 1], u)[0])
    return compares, 2 * lo.shape[0] * u.numel()


def check_mc_sets(args: tuple, label: str, reps: int) -> dict:
    """The batched counting kernel against its plain version, exactly, with
    times from CUDA events around eager calls (``ms``) and around a CUDA
    graph of the calls (``card_ms``), and the bound from this data."""
    from repro_torch.kernels.hypervolume import mc_hv_counts_sets
    from repro_torch.kernels.ref import mc_hv_counts_sets_ref

    P, off, lo, span, u = args
    excl, total = mc_hv_counts_sets(*args)
    excl_r, total_r = mc_hv_counts_sets_ref(*args)
    torch.cuda.synchronize()
    mismatches = int((excl != excl_r).sum()) + int((total != total_r).sum())
    err = max(float((excl - excl_r).abs().max()) if len(excl) else 0.0,
              float((total - total_r).abs().max()))
    assert mismatches == 0, (label, mismatches, err)
    G, m = lo.shape
    N, s = P.shape[0], u.shape[0]
    ms = time_ms(lambda: mc_hv_counts_sets(*args), reps)
    card_ms = graph_ms(lambda: mc_hv_counts_sets(*args), 10, max(1, reps // 10))
    plain_ms = time_ms(lambda: mc_hv_counts_sets_ref(*args), 3, 1)
    compares, f64_ops = mc_sets_compares(*args)
    ops_s = compares / FP32_OPS_PER_S + f64_ops / FP64_OPS_PER_S
    nbytes = 4 * N * m + 4 * (G + 1) + 2 * 8 * G * m + 8 * s * m + 4 * (N + G)
    bytes_s = nbytes / HBM_BYTES_PER_S
    bound_ms = 1e3 * max(ops_s, bytes_s)
    bound_by = "bytes" if bytes_s >= ops_s else "operations"
    row = {"label": label, "sets": G, "points": N, "s": s, "m": m, "mismatches": mismatches,
           "max_abs_err": err, "compares": compares, "ms": ms, "card_ms": card_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"  mc_hv_sets {label:<26} G={G:<3} points={N:<5} s={s} m={m} mismatches={mismatches} "
          f"eager={ms:.4f} ms card={card_ms:.4f} ms plain={plain_ms:.4f} ms "
          f"bound={bound_ms:.6f} ms ({bound_by}; {compares} compares)")
    return row


def phase_mc_sets() -> list[dict]:
    """Phase 6 (batched): ``solve_hssp`` at MOTPE's boundary-rank shape (60
    points of DTLZ2's front, 25 picks) on the ``"cuda"`` engine, each
    launch's samples held to the host's draw bit for bit, its picks to the
    ``"torch"`` engine's on the card, and the batched kernel to its plain
    version at the singletons, a middle step and the last step."""
    from repro_torch.core import moo
    from repro_torch.kernels import hypervolume

    print("phase 6b: mc_hv_counts_sets kernel (one launch a greedy step) vs plain version")
    pts = dtlz2_front(np.random.RandomState(6), 60)
    ref = moo.default_reference_point(pts)
    hypervolume.reset_launches()
    with StageTimer([(moo, "mc_hv_counts_sets", "sets", positional)]) as rec:
        sel = moo.solve_hssp(pts, 25, ref, estimator=moo.HypervolumeEstimator(engine="cuda"))
    torch.cuda.synchronize()
    launched, calls = hypervolume.set_launches(), rec.args["sets"]
    assert launched == len(calls) == 25 and hypervolume.launches() == 0, (launched, len(calls))
    sel_t = moo.solve_hssp(pts, 25, ref, estimator=moo.HypervolumeEstimator(engine="torch"))
    assert np.array_equal(sel, sel_t), (sel, sel_t)
    print(f"  solve_hssp(60 points, k=25): {launched} batched launches, picks equal the "
          f"'torch' engine's on the card")
    # the samples each set's threads build against the host's per-call draw,
    # numpy's uniform in [lo, ref] rounded to float32
    bad = 0
    for args in calls:
        _, _, lo, span, u = args
        smp = hypervolume.mc_hv_samples(lo, span, u).cpu().numpy()
        for g, l in enumerate(lo.cpu().numpy()):
            host = np.random.RandomState(0).uniform(l, ref, size=u.shape).astype(np.float32)
            bad += int(not np.array_equal(host.view(np.uint32), smp[g].view(np.uint32)))
    n_sets = sum(a[2].shape[0] for a in calls)
    assert bad == 0, f"{bad} of {n_sets} sets' card samples differ from the host's"
    print(f"  samples of all {n_sets} sets built on the card == the host's float32 draw, "
          f"bit for bit")
    return [check_mc_sets(calls[0], "singletons", 100),
            check_mc_sets(calls[len(calls) // 2], f"greedy step {len(calls) // 2}", 100),
            check_mc_sets(calls[-1], f"greedy step {len(calls) - 1}", 100)]


class StageTimer:
    """Wall seconds and calls of a few functions of the multi-objective
    engine, wrapped for one phase and put back after it.  A target
    ``(owner, attribute name, label[, record])`` with ``record`` keeps
    ``record(args, kwargs)`` of every call in ``args[label]`` (tensors by
    reference: nothing is copied while the phase runs)."""

    def __init__(self, targets):
        self.targets = [tuple(t) + (None,) * (4 - len(t)) for t in targets]
        self.seconds = {t[2]: 0.0 for t in self.targets}
        self.calls = {t[2]: 0 for t in self.targets}
        self.args = {t[2]: [] for t in self.targets}
        self._saved = []

    def __enter__(self):
        for owner, name, label, record in self.targets:
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, self._wrap(fn, label, record))
        return self

    def _wrap(self, fn, label, record):
        def timed(*args, **kwargs):
            if record is not None:
                self.args[label].append(record(args, kwargs))
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[label] += time.perf_counter() - t0
                self.calls[label] += 1
        return timed

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved = []


def positional(args, kwargs):
    """A ``record`` for :class:`StageTimer`: the call's positional arguments."""
    return args


def trials_hash(study) -> str:
    """SHA-256 over every trial's number, parameters (name and float64 bits)
    and objective values: two studies that made the same trials agree."""
    h = hashlib.sha256()
    for t in study.trials:
        h.update(str(t.number).encode())
        for name, value in sorted(t.params.items()):
            h.update(name.encode())
            h.update(np.float64(value).tobytes())
        h.update(np.asarray(t.values, dtype=np.float64).tobytes())
    return h.hexdigest()


def motpe_study(hpo, n_trials: int, wave: int):
    """The MOTPE study of phase 7 on ``hpo`` (a ``repro_torch.core``, this
    checkout's or another's): ``(sampler, study, seconds)`` after
    ``n_trials`` DTLZ2 trials as waves of ``wave``, synchronized."""
    sampler = hpo.TPESampler(seed=0, multi_objective=True, engine="cuda")
    study = hpo.create_study(directions=["minimize"] * DTLZ2_M, sampler=sampler)
    t0 = time.perf_counter()
    for _ in range(n_trials // wave):
        run_dtlz2_wave(study, wave)
    torch.cuda.synchronize()
    return sampler, study, time.perf_counter() - t0


def phase_motpe() -> tuple[dict, list[dict], dict]:
    """Phase 7: MOTPE on 5-objective DTLZ2 as waves of 32 on the card."""
    import repro_torch.core as hpo
    from repro_torch.core import moo, telemetry
    from repro_torch.core.samplers.tpe import _motpe_split
    from repro_torch.kernels import hypervolume, parzen

    n_trials, wave = 512, 32
    print(f"phase 7: MOTPE on DTLZ2 ({DTLZ2_M} objectives, {DTLZ2_M - 1 + DTLZ2_K} "
          f"variables), {n_trials} trials in waves of {wave}, engine='cuda'")
    est = moo.HypervolumeEstimator
    stages = StageTimer([
        (est, "_mc_stats", "mc_call"), (est, "_counts", "mc_counts"),
        (est, "_hypervolumes", "mc_batches"),
        (moo, "solve_hssp", "hssp", lambda a, kw: (len(a[0]), int(a[1]))),  # (points, k)
        (moo, "mc_hv_counts_sets", "sets", positional),
        (moo, "nondomination_ranks", "ranks"),
    ])
    telemetry.reset()
    telemetry.enable()
    with stages:
        parzen.reset_launches()
        hypervolume.reset_launches()
        sampler, study, seconds = motpe_study(hpo, n_trials, wave)
        mc_launches = hypervolume.launches()
        set_launches = hypervolume.set_launches()
        parzen_launches = parzen.launches()
    telemetry.disable()
    hists = telemetry.snapshot()["histograms"]
    assert mc_launches > 0, "the MOTPE study never launched the counting kernel"
    assert set_launches > 0, "the MOTPE study never launched the batched counting kernel"
    assert parzen_launches > 0, "the MOTPE study never launched the Parzen kernel"
    assert parzen_launches == hists["tpe.score"]["count"], (parzen_launches, hists["tpe.score"])
    # every per-call count (the below set's contributions) is one launch, and
    # every batch of subset evaluations one batched launch
    assert stages.calls["mc_counts"] == mc_launches, (stages.calls, mc_launches)
    assert stages.calls["sets"] == set_launches, (stages.calls["sets"], set_launches)
    # at most one batched launch for the singletons and one a greedy step
    # after the first pick: k a call
    greedy_bound = sum(min(k, n) for n, k in stages.args["hssp"])
    assert set_launches <= greedy_bound, (set_launches, greedy_bound)
    digest = trials_hash(study)
    trials = study.trials
    assert len(trials) == n_trials
    V = np.array([t.values for t in trials])
    assert V.shape == (n_trials, DTLZ2_M) and np.isfinite(V).all()
    for t in trials:
        assert all(0.0 <= v <= 1.0 for v in t.params.values()), t.params
    L = moo.loss_matrix(V, study.directions)
    front0 = moo.pareto_front_mask(L, engine="cuda")
    assert np.array_equal(front0, moo.pareto_front_mask(L, engine="numpy"))
    n_below = sampler._gamma(len(L))
    split = {eng: _motpe_split(L, n_below, engine=eng, device="cuda")
             for eng in ("cuda", "torch")}
    (b_c, a_c, w_c), (b_t, a_t, w_t) = split["cuda"], split["torch"]
    assert np.array_equal(b_c, b_t) and np.array_equal(a_c, a_t), "final split differs"
    np.testing.assert_allclose(w_c, w_t, atol=1e-12, rtol=0)
    # DTLZ2's Pareto-optimal front is the unit sphere: every objective vector
    # has norm 1 + g >= 1, so the smallest norm on front 0 says how close the
    # search came
    g_min = float(np.min(np.linalg.norm(L[front0], axis=1)))
    assert g_min >= 1.0 - 1e-9, g_min

    spans = {
        name: {"count": hists[name]["count"], "total_s": hists[name]["sum"],
               "mean_ms": 1e3 * hists[name]["mean"], "p99_ms": 1e3 * hists[name]["p99"]}
        for name in ("study.ask", "study.tell_batch", "tpe.fit", "tpe.score")
        if name in hists
    }
    breakdown = {
        "mc_calls": stages.calls["mc_call"],
        "mc_call_s": stages.seconds["mc_call"],
        "mc_host_draw_s": stages.seconds["mc_call"] - stages.seconds["mc_counts"],
        "mc_counts_s": stages.seconds["mc_counts"],
        "mc_batches": stages.calls["mc_batches"],
        "mc_batches_s": stages.seconds["mc_batches"],
        "hssp_s": stages.seconds["hssp"],
        "hssp_calls": stages.calls["hssp"],
        "ranks_s": stages.seconds["ranks"],
        "tpe_fit_s": spans.get("tpe.fit", {}).get("total_s", 0.0),
        "tpe_score_s": spans.get("tpe.score", {}).get("total_s", 0.0),
    }
    result = {
        "n_trials": n_trials, "wave": wave, "seconds": seconds,
        "trials_per_s": n_trials / seconds, "mc_hv_launches": mc_launches,
        "mc_hv_set_launches": set_launches, "greedy_bound": greedy_bound,
        "trials_sha256": digest,
        "parzen_launches": parzen_launches, "front0": int(front0.sum()),
        "n_below": int(len(b_c)), "min_front_norm": g_min,
        "spans": spans, "breakdown": breakdown,
    }
    print(f"  {n_trials} trials in {seconds:.3f} s = {n_trials / seconds:.2f} trials/s; "
          f"front 0 holds {int(front0.sum())} trials (closest to the unit sphere: "
          f"norm {g_min:.4f}); below set {len(b_c)}")
    print(f"  launches: mc_hv_counts {mc_launches} (the below sets' contributions), "
          f"mc_hv_counts_sets {set_launches} (<= {greedy_bound}: one a greedy step of "
          f"{stages.calls['hssp']} solve_hssp calls), parzen_score {parzen_launches} "
          f"(== tpe.score spans)")
    print(f"  trials sha256 {digest}")
    print(f"  final split identical on 'cuda' and 'torch' (max |dw| "
          f"{float(np.max(np.abs(w_c - w_t))):.3e})")
    for name, sp in spans.items():
        print(f"  span {name:<26} count={sp['count']:<7} total={sp['total_s']:.4f} s "
              f"mean={sp['mean_ms']:.4f} ms p99={sp['p99_ms']:.4f} ms")
    print("  where the time goes: " + ", ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in breakdown.items()))

    rows = []
    dev = torch.device("cuda")
    for label, pts in (("MOTPE below set", L[b_c]), ("MOTPE front 0", L[front0])):
        ref = moo.default_reference_point(pts)
        P = torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(dev)
        S = torch.from_numpy(estimator_samples(pts, ref)).to(dev)
        rows.append(check_mc(P, S, label, 100))
    largest = max(stages.args["sets"], key=_work)  # one of the largest greedy steps
    set_row = check_mc_sets(largest, "MOTPE largest greedy step", 100)
    return result, rows, set_row


def phase_nsga2() -> dict:
    """Phase 8: NSGA-II on the same DTLZ2, then the front on the card."""
    import repro_torch.core as hpo
    from repro_torch.core.study import _pairwise_best_trials

    n_trials = 1024
    sampler = hpo.NSGAIISampler(seed=0, engine="cuda")
    study = hpo.create_study(directions=["minimize"] * DTLZ2_M, sampler=sampler, engine="cuda")
    wave = sampler.joint_wave_size(study, 1 << 30)
    print(f"phase 8: NSGA-II on DTLZ2, {n_trials} trials in waves of {wave}, engine='cuda'")
    t0 = time.perf_counter()
    while len(study.trials) < n_trials:
        run_dtlz2_wave(study, min(wave, n_trials - len(study.trials)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    t1 = time.perf_counter()
    best = study.best_trials
    best_s = time.perf_counter() - t1
    completed = study.get_trials(deepcopy=False, states=(hpo.TrialState.COMPLETE,))
    pairwise = _pairwise_best_trials(completed, study.directions)
    assert [t.number for t in best] == [t.number for t in pairwise], "best_trials differs"
    assert [t.values for t in best] == [t.values for t in pairwise]
    assert len(study.trials) == n_trials and len(best) > 0
    print(f"  {n_trials} trials in {seconds:.3f} s = {n_trials / seconds:.2f} trials/s; "
          f"best_trials on the card: {len(best)} trials in {1e3 * best_s:.3f} ms "
          f"== the pairwise loop")
    return {"n_trials": n_trials, "wave": wave, "seconds": seconds,
            "trials_per_s": n_trials / seconds, "front0": len(best),
            "best_trials_ms": 1e3 * best_s}


# -- serving slice -----------------------------------------------------------------


def kernel_ptxas(build_log: str, kernel: str) -> dict:
    """``ptxas`` lines (registers, shared memory, spills) of each template
    instance of ``kernel`` in this process's build log, keyed by mangled
    name (``kernel`` is matched whole: its length prefix and template
    arguments around it)."""
    out: dict = {}
    key = None
    for line in build_log.splitlines():
        m = re.search(r"entry function '(\S*)'", line)
        if m:
            key = m.group(1) if re.search(rf"\d{kernel}[IE]", m.group(1)) else None
            if key:
                out[key] = []
        elif key and ("Used" in line or "spill" in line):
            out[key].append(line.strip().removeprefix("ptxas info    : "))
    return out


def flash_ptxas(build_log: str) -> dict:
    """``ptxas`` lines of each flash-attention kernel instance, keyed by
    (dtype name, head dim): bfloat16 the tensor-core kernel (its softcap
    and plain instances), float32 the CUDA-core one."""
    out: dict = {}
    for dtype, kernel in (("bfloat16", "flash_attention_tc_kernel"),
                          ("float32", "flash_attention_kernel")):
        for name, lines in kernel_ptxas(build_log, kernel).items():
            key = (dtype, int(re.search(r"Li(\d+)E", name).group(1)))
            cap = "" if dtype == "float32" else ("softcap: " if "Lb1E" in name else "no softcap: ")
            out.setdefault(key, []).extend(cap + line for line in lines)
    return out


def ce_ptxas(build_log: str) -> dict:
    """``ptxas`` lines of each cross-entropy kernel instance, keyed by the
    operand types."""
    out: dict = {}
    for name, lines in kernel_ptxas(build_log, "crossentropy_tc_kernel").items():
        out[f"bfloat16 x, K-major bf16 W, {'softcap' if 'ILb1E' in name else 'no softcap'}"] = lines
    for name, lines in kernel_ptxas(build_log, "crossentropy_kernel").items():
        out[f"float32 x, {'bfloat16' if 'bfloat16' in name else 'float32'} W"] = lines
    return out


def cuobjdump() -> "str | None":
    """``cuobjdump`` from the CUDA toolkit, else the copy Triton ships, else
    None."""
    import importlib.util
    import shutil

    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump"),
             shutil.which("cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec and spec.origin:
        cands.append(os.path.join(os.path.dirname(spec.origin), "backends", "nvidia", "bin",
                                  "cuobjdump"))
    return next((c for c in cands if c and os.path.exists(c)), None)


def tensor_core_sass(kernels=("flash_attention_tc_kernel", "crossentropy_tc_kernel",
                              "ssd_tc_kernel")) -> dict:
    """Tensor-core instructions (``HMMA``, ``HGMMA``) in the SASS of each
    instance of ``kernels`` in the built library, by mangled name, from
    ``cuobjdump -sass``; ``{"not available": reason}`` without the tool."""
    from repro_torch.kernels import _build

    tool = cuobjdump()
    if tool is None:
        return {"not available": "no cuobjdump in the CUDA toolkit or Triton's package"}
    sass = subprocess.run([tool, "-sass", str(_build.library_path())], capture_output=True,
                          text=True)
    if sass.returncode:
        return {"not available": f"cuobjdump exited {sass.returncode}: {sass.stderr[-200:]}"}
    out: dict = {}
    name = None
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = (m.group(1) if any(re.search(rf"\d{k}[IE]", m.group(1)) for k in kernels)
                    else None)
            if name:
                out[name] = 0
        elif name and re.search(r"\bH(G)?MMA\b", line):
            out[name] += 1
    return out


def attention_pairs(Sq: int, kw: dict, Skv: int) -> int:
    """(query, key) pairs the function needs per (batch, head): each query
    row's keys inside the causal / window band and below ``kv_len``."""
    q_offset = kw.get("q_offset", 0)
    kv_len = kw.get("kv_len") or Skv
    window = kw.get("window", -1)
    qp = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(kv_len - 1, qp) if kw.get("causal", True) else np.full(Sq, kv_len - 1)
    lo = np.maximum(0, qp - window + 1) if window > 0 else np.zeros(Sq, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_bound_ms(B, Hq, Hkv, Sq, Skv, D, dtype, kw) -> tuple[float, str, int]:
    """Least time for one call: the larger of the QK^T and PV FLOPs this
    data needs (4 D per visible pair) over the dtype's peak and the q/k/v/o
    bytes (keys and values up to kv_len) over the memory rate."""
    flops = 4 * D * B * Hq * attention_pairs(Sq, kw, Skv)
    peak = BF16_TC_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
    elem = torch.finfo(dtype).bits // 8
    kv_used = min(Skv, kw.get("kv_len") or Skv)
    nbytes = elem * (2 * B * Hq * Sq * D + 2 * B * Hkv * kv_used * D)
    ops_s, bytes_s = flops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s else "bytes"), flops


def flash_inputs(gen, B, Hq, Hkv, Sq, Skv, D, dtype, model_layout, qk_scale=1.0):
    """Random q, k, v as [B, H, S, D]; with ``model_layout`` they are views
    of the model's [B, S, H, D] memory.  ``qk_scale`` multiplies q and k:
    at 3 the scores have a standard deviation near 9, so a row's softmax
    weight lies on a few keys and the output is of order 1 (at 1 and
    thousands of keys it is a mean of near-uniform weights, of order
    sqrt(e / keys), no larger than the bfloat16 tolerance)."""
    def make(H, S, scale):
        shape = (B, S, H, D) if model_layout else (B, H, S, D)
        t = (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)
        return t.transpose(1, 2) if model_layout else t

    return make(Hq, Sq, qk_scale), make(Hkv, Skv, qk_scale), make(Hkv, Skv, 1.0)


def check_flash(gen, label, B, Hq, Hkv, Sq, Skv, D, dtype, kw, model_layout, reps, ptxas,
                qk_scale=1.0) -> dict:
    """The kernel against its plain version on one shape, with times from
    CUDA events, SDPA where it computes the same function, and the bound.
    The tolerance is held to be small against the reference output: its
    root mean square must be at least ten times the tolerance."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    q, k, v = flash_inputs(gen, B, Hq, Hkv, Sq, Skv, D, dtype, model_layout, qk_scale)
    out = flash_attention(q, k, v, **kw)
    ref = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = FA_TOL[dtype]
    ref_rms = float(ref.float().pow(2).mean().sqrt())
    assert ref_rms >= 10 * tol, (label, ref_rms, tol)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol, msg=label)
    err = float((out.float() - ref.float()).abs().max())
    del out, ref
    ms = time_ms(lambda: flash_attention(q, k, v, **kw), reps)
    plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, **kw), max(1, reps // 2))
    # the yardstick: SDPA where one call computes the same function (no
    # window, softcap or offset); its own distance from the plain version
    # is recorded, not held to the kernel's tolerance
    library_ms = library_err = None
    same_function = (kw.get("window", -1) <= 0 and not kw.get("softcap") and
                     kw.get("q_offset", 0) == 0 and (kw.get("kv_len") or Skv) == Skv and Sq == Skv)
    if same_function:
        F = torch.nn.functional
        causal = kw.get("causal", True)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=causal, enable_gqa=Hq != Hkv)
        library_err = float((sdpa().float() - flash_attention_ref(q, k, v, **kw).float())
                            .abs().max())
        library_ms = time_ms(sdpa, reps)
    bound_ms, bound_by, flops = flash_bound_ms(B, Hq, Hkv, Sq, Skv, D, dtype, kw)
    dname = "bfloat16" if dtype == torch.bfloat16 else "float32"
    build = ptxas.get((dname, D), ["not in this process's build log"])
    from repro_torch.kernels import _build

    # dynamic: ptxas does not see it
    smem = _build.load().flash_attention_smem_bytes(D, int(dtype == torch.bfloat16))
    row = {
        "label": label, "B": B, "Hq": Hq, "Hkv": Hkv, "Sq": Sq, "Skv": Skv, "D": D,
        "dtype": dname, "layout": "bshd" if model_layout else "bhsd", "qk_scale": qk_scale,
        **{k_: v_ for k_, v_ in kw.items()}, "max_abs_err": err, "ref_rms": ref_rms, "tol": tol, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_max_abs_err": library_err,
        "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
        "tflops": flops / (ms * 1e9), "share_of_bound": bound_ms / ms, "ptxas": build,
        "dynamic_smem_bytes": smem,
    }
    lib = (f"{library_ms:.4f} ms (max_abs_err {library_err:.3e})" if library_ms is not None
           else "none")
    print(f"  flash {label:<26} B={B} H={Hq}/{Hkv} S={Sq}/{Skv} D={D} {dname} {kw} "
          f"max_abs_err={err:.3e} rms(ref)={ref_rms:.3e} kernel={ms:.4f} ms ({row['tflops']:.2f} TFLOP/s, "
          f"{row['share_of_bound']:.1%} of the bound) plain={plain_ms:.4f} ms sdpa={lib} "
          f"bound={bound_ms:.4f} ms ({bound_by})")
    print(f"    ptxas ({dname}, D={D}): {'; '.join(build)}; {smem} bytes of dynamic "
          f"shared memory a block")
    return row


def phase_flash(build_log: str) -> list[dict]:
    """Phase 9: the flash-attention kernel against its plain version."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    print(f"phase 9: flash_attention kernels vs plain PyTorch version; "
          f"{nvidia_smi('name,power.limit')}")
    gen = torch.Generator(device="cuda").manual_seed(9)
    ptxas = flash_ptxas(build_log)
    rows = []
    f32, bf16 = torch.float32, torch.bfloat16
    for dtype in (f32, bf16):
        # the reference's own sweep (tests/test_kernels.py)
        for B, Hq, Hkv, S, D in ((1, 2, 2, 64, 32), (2, 4, 2, 128, 32), (1, 8, 1, 96, 16),
                                 (1, 2, 2, 128, 128)):
            rows.append(check_flash(gen, "reference sweep", B, Hq, Hkv, S, S, D, dtype, {},
                                    False, 20, ptxas))
    for window in (8, 32, 100):
        rows.append(check_flash(gen, f"window {window}", 1, 2, 2, 64, 64, 16, f32,
                                {"window": window}, False, 20, ptxas))
    for cap in (10.0, 50.0):
        rows.append(check_flash(gen, f"softcap {cap:g}", 1, 2, 2, 64, 64, 16, f32,
                                {"softcap": cap}, False, 20, ptxas, qk_scale=3.0))
    rows.append(check_flash(gen, "non-causal", 1, 2, 2, 48, 48, 16, f32, {"causal": False},
                            False, 20, ptxas))
    # the same cases in bfloat16, the tensor-core kernel (q / k at 3, so the
    # outputs are of order 1 against the bfloat16 tolerance), and every head
    # width it is built for at a served group's odd length with eight query
    # heads a kv head, in the model's layout
    for window in (8, 32, 100):
        rows.append(check_flash(gen, f"window {window}", 1, 2, 2, 64, 64, 16, bf16,
                                {"window": window}, False, 20, ptxas, qk_scale=3.0))
    for cap in (10.0, 50.0):
        rows.append(check_flash(gen, f"softcap {cap:g}", 1, 2, 2, 64, 64, 16, bf16,
                                {"softcap": cap}, False, 20, ptxas, qk_scale=3.0))
    rows.append(check_flash(gen, "non-causal", 1, 2, 2, 48, 48, 16, bf16, {"causal": False},
                            False, 20, ptxas, qk_scale=3.0))
    for D in HEAD_DIMS:
        rows.append(check_flash(gen, f"head width {D}", 1, 8, 1, 1895, 1895, D, bf16, {}, True, 5,
                                ptxas, qk_scale=3.0))
    # the model's layout, and q / k at 3 so the outputs are of order 1 (at 1
    # they would be no larger than the tolerance) and softcap 50 bends the
    # scores at D = 256
    rows.append(check_flash(gen, "q_offset / kv_len", 2, 32, 4, 512, 4096, 64, bf16,
                            {"q_offset": 1536, "kv_len": 2048}, True, 10, ptxas, qk_scale=3.0))
    rows.append(check_flash(gen, "tinyllama prefill", 8, 32, 4, 2048, 2048, 64, bf16, {},
                            True, 10, ptxas, qk_scale=3.0))
    rows.append(check_flash(gen, "gemma2 prefill, window", 2, 16, 8, 8192, 8192, 256, bf16,
                            {"window": 4096, "softcap": 50.0}, True, 3, ptxas, qk_scale=3.0))
    rows.append(check_flash(gen, "gemma2 prefill, global", 2, 16, 8, 8192, 8192, 256, bf16,
                            {"softcap": 50.0}, True, 3, ptxas, qk_scale=3.0))
    return rows


class StepTimer:
    """Wall seconds of each call of a step function, synchronized with the
    card on both sides, and the shape of its token input."""

    def __init__(self, fn):
        self.fn = fn
        self.seconds: list[float] = []
        self.shapes: list[tuple] = []

    def __call__(self, model, tokens, *args):
        tok = tokens["tokens"] if isinstance(tokens, dict) else tokens
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(model, tokens, *args)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        self.shapes.append(tuple(tok.shape))
        return out


def model_blocks(cfg) -> list[tuple[str, object]]:
    """``(segment, bdef)`` of every block in execution order, a shared stack
    position as ``cfg.shared_block``."""
    blocks = [("head", b) for b in cfg.head_blocks]
    for _ in range(cfg.n_superblocks):
        blocks += [("stack", cfg.shared_block if b.shared else b) for b in cfg.superblock]
    return blocks + [("tail", b) for b in cfg.tail_blocks]


#: the kernel each block kind launches once per prefill (an mLSTM or MLA block
#: none: plain products)
BLOCK_KERNELS = {"mamba2": "ssd", "slstm": "slstm", "mlstm": None, "mla": None}


def launches_per_call(cfg, train: bool = False) -> dict:
    """Flash-attention, SSD and sLSTM launches of one prefill (or, with
    ``train``, one train step's forward and backward): one per attention /
    mamba2 / sLSTM block, twice for a stacked block under remat (the
    backward recomputes each superblock's forward); an mLSTM block runs in
    torch ops."""
    n = {"flash_attention": 0, "ssd": 0, "slstm": 0}
    for seg, b in model_blocks(cfg):
        kernel = BLOCK_KERNELS.get(b.kind, "flash_attention")
        if kernel:
            n[kernel] += 2 if train and seg == "stack" and cfg.remat != "none" else 1
    return n


def launches_per_decode(cfg) -> dict:
    """Kernel launches of one decode step: an sLSTM block runs its full form
    on the one token (the sLSTM kernel at S = 1); attention and mamba2
    blocks decode in torch ops."""
    n = launches_per_call(cfg)
    return {k: (v if k == "slstm" else 0) for k, v in n.items()}


def prefill_attention_calls(cfg, B: int, S: int, capacity: int) -> list[tuple[int, tuple, dict]]:
    """The flash-attention calls of one prefill, grouped: (count, (Skv,
    kv heads), kwargs).  A ring-cache (window) layer attends over its fresh
    k/v; any other layer over its cache with ``kv_len = S``."""
    calls: dict = {}
    for _, b in model_blocks(cfg):
        if b.kind in BLOCK_KERNELS:
            continue
        kw = {"window": b.window, "softcap": cfg.attn_softcap or 0.0}
        if b.window > 0:  # the cache of a window layer is a ring of min(capacity, window)
            key = (S, tuple(sorted(kw.items())))
        else:
            kw["kv_len"] = S
            key = (capacity, tuple(sorted(kw.items())))
        calls[key] = calls.get(key, 0) + 1
    return [(n, skv, dict(kw)) for (skv, kw), n in calls.items()]


def ssd_model_inputs(gen, cfg, B: int, S: int, dtype=torch.bfloat16, init: bool = True):
    """The SSD scan's inputs as a mamba2 block hands them over: x, B and C
    strided slices of one [B, S, conv channels] tensor, dt = |N(0, 1)| / 2
    and A = -|N(0, 1)| in float32, and (``init``) a float32 initial state."""
    H, P = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    return ssd_inputs(gen, B, S, H, P, G, N, dtype, init, True)


def kernel_seconds_of_prefills(cfg, shapes: list[tuple], capacity: int) -> tuple[float, list]:
    """Kernel time of every flash-attention, SSD and sLSTM launch the
    prefills made, timed again at each call's shape (bf16 inputs from a
    seeded generator)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.slstm import slstm_forward
    from repro_torch.kernels.ssd import kernel_chunk_len, ssd_forward

    gen = torch.Generator(device="cuda").manual_seed(10)
    total, rows = 0.0, []
    n_ssd = launches_per_call(cfg)["ssd"]
    n_slstm = launches_per_call(cfg)["slstm"]
    for B, S in shapes:
        if n_slstm:
            H, D = cfg.n_heads, cfg.d_model // cfg.n_heads
            args = slstm_inputs(gen, B, S, H, D, torch.bfloat16, False, True)
            ms = time_ms(lambda: slstm_forward(*args), 3)
            bound, by, _ = slstm_bound_ms(B, S, H, D, torch.bfloat16)
            rows.append({"kernel": "slstm", "B": B, "S": S, "launches": n_slstm, "ms": ms,
                         "bound_ms": bound, "bound_by": by})
            total += n_slstm * ms / 1e3
            del args
        if n_ssd:
            args = ssd_model_inputs(gen, cfg, B, S)
            ms = time_ms(lambda: ssd_forward(*args[:5], cfg.ssm_chunk, args[5]), 3)
            bound, by, _, _ = ssd_bound_ms(*ssd_dims(args), cfg.ssm_chunk, args[0].dtype, True)
            rows.append({"kernel": "ssd", "B": B, "S": S, "L": kernel_chunk_len(S, cfg.ssm_chunk),
                         "launches": n_ssd, "ms": ms, "bound_ms": bound, "bound_by": by})
            total += n_ssd * ms / 1e3
            del args
        for n, Skv, kw in prefill_attention_calls(cfg, B, S, capacity):
            q, k, v = flash_inputs(gen, B, cfg.n_heads, cfg.n_kv_heads, S, Skv, cfg.head_dim,
                                   torch.bfloat16, True)
            ms = time_ms(lambda: flash_attention(q, k, v, **kw), 3)
            bound, by, _ = flash_bound_ms(B, cfg.n_heads, cfg.n_kv_heads, S, Skv, cfg.head_dim,
                                          torch.bfloat16, kw)
            rows.append({"kernel": "flash_attention", "B": B, "S": S, "Skv": Skv, **kw,
                         "launches": n, "ms": ms, "bound_ms": bound, "bound_by": by})
            total += n * ms / 1e3
            del q, k, v
    return total, rows


def serve_engine(label: str, cfg, model, prompts, slots: int, capacity: int, max_new: int) -> dict:
    """Greedy generation through ``Engine(engine="cuda")`` with the launch
    counts set to 0 just before and read just after (one flash-attention
    launch per attention block and prefill, one SSD launch per mamba2 block
    and prefill, one sLSTM launch per sLSTM block and prefill or decode
    step); prefill and decode steps timed; the kernels' share of the wall
    time."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import slstm, ssd
    from repro_torch.serve import Engine

    engine = Engine(cfg, model, capacity=capacity, slots=slots, device="cuda", engine="cuda")
    engine._prefill = prefill = StepTimer(engine._prefill)
    engine._decode = decode = StepTimer(engine._decode)
    per_prefill = launches_per_call(cfg)
    per_decode = launches_per_decode(cfg)
    torch.cuda.reset_peak_memory_stats()
    for kernel in (fa, ssd, slstm):
        kernel.reset_launches()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new=max_new)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fa.launches()
    ssd_launches = ssd.launches()
    slstm_launches = slstm.launches()
    groups = len(prefill.seconds)
    steps = len(decode.seconds)
    got = {"flash_attention": launches, "ssd": ssd_launches, "slstm": slstm_launches}
    want = {k: n * groups + per_decode[k] * steps for k, n in per_prefill.items()}
    assert got == want, (label, got, want, groups, steps)
    assert [len(o) for o in outs] == [max_new] * len(prompts)
    assert all(0 <= t < cfg.vocab for o in outs for t in o)
    n_tokens = sum(len(o) for o in outs)
    kernel_s, kernel_rows = kernel_seconds_of_prefills(cfg, prefill.shapes, capacity)
    decode_ms = [1e3 * s for s in decode.seconds]
    result = {
        "label": label, "requests": len(prompts), "prompt_lens": [len(p) for p in prompts],
        "slots": slots, "capacity": capacity, "max_new": max_new, "groups": groups,
        "seconds": seconds, "tokens": n_tokens, "tokens_per_s": n_tokens / seconds,
        "prefill_s": prefill.seconds, "prefill_shapes": prefill.shapes,
        "decode_steps": len(decode_ms), "decode_ms_mean": float(np.mean(decode_ms)),
        "decode_ms_p50": float(np.median(decode_ms)), "decode_s_total": sum(decode.seconds),
        "flash_launches": launches, "ssd_launches": ssd_launches,
        "slstm_launches": slstm_launches, "kernel_s": kernel_s,
        "kernel_share": kernel_s / seconds,
        "kernel_calls": kernel_rows, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    print(f"  {label}: {len(prompts)} requests in {groups} groups, {n_tokens} tokens in "
          f"{seconds:.3f} s = {n_tokens / seconds:.2f} tokens/s; peak memory "
          f"{result['peak_mem_gib']:.2f} GiB")
    for (B, S), s in zip(prefill.shapes, prefill.seconds):
        print(f"    prefill group B={B} S={S}: {s:.4f} s")
    print(f"    decode: {len(decode_ms)} steps, mean {result['decode_ms_mean']:.3f} ms, "
          f"median {result['decode_ms_p50']:.3f} ms a step ({sum(decode.seconds):.3f} s)")
    print(f"    flash_attention launches {launches} == {per_prefill['flash_attention']} "
          f"attention blocks x {groups} prefills; ssd launches {ssd_launches} == "
          f"{per_prefill['ssd']} mamba2 blocks x {groups} prefills; slstm launches "
          f"{slstm_launches} == {per_prefill['slstm']} slstm blocks x ({groups} prefills + "
          f"{steps} decode steps); prefill kernels {kernel_s:.4f} s = "
          f"{100 * kernel_s / seconds:.2f}% of the wall time")
    for r in kernel_rows:
        where = (f"Skv={r['Skv']} window={r['window']} kv_len={r.get('kv_len')}"
                 if r["kernel"] == "flash_attention" else
                 f"L={r['L']}" if r["kernel"] == "ssd" else "")
        print(f"      {r['kernel']} at B={r['B']} S={r['S']} {where}: {r['ms']:.4f} ms x "
              f"{r['launches']} (bound {r['bound_ms']:.4f} ms, {r['bound_by']})")
    return result


def decode_idle_share(cfg, model, prompts, capacity: int, steps: int) -> dict:
    """The card's idle share during ``steps`` decode steps of one group
    through ``Engine(engine="cuda")``, from a ``torch.profiler`` trace: each
    step is synchronized on both sides as in phase 10(b), and the union of
    the card's kernel, copy and memset intervals inside each step's span is
    its busy time.  The trace is written to ``build/decode_trace.json``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.serve import Engine

    engine = Engine(cfg, model, capacity=capacity, slots=len(prompts), device="cuda",
                    engine="cuda")
    step = engine._decode

    def traced(*args):
        torch.cuda.synchronize()
        with record_function("decode_step"):
            out = step(*args)
            torch.cuda.synchronize()
        return out

    engine._decode = traced
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.generate(prompts, max_new=steps + 1)
    path = os.path.join(ROOT, "build", "decode_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation" and e["name"] == "decode_step")
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    assert len(spans) == steps, (len(spans), steps)
    busy = wall = 0.0
    kernels = 0
    for lo, hi in spans:
        wall += hi - lo
        inside = [(max(a, lo), min(b, hi)) for a, b in device if a < hi and b > lo]
        kernels += len(inside)
        end = lo
        for a, b in inside:  # union of the sorted intervals
            if b > end:
                busy += b - max(a, end)
                end = b
    result = {"steps": steps, "B": len(prompts), "traced_ms_per_step": wall / steps / 1e3,
              "device_ops_per_step": kernels / steps,
              "busy_ms_per_step": busy / steps / 1e3 if device else None,
              "idle_share": 1.0 - busy / wall if device else None}
    if device:
        print(f"  decode trace (torch.profiler, {steps} steps, B={len(prompts)}): "
              f"{result['traced_ms_per_step']:.3f} ms a step traced, the card busy "
              f"{result['busy_ms_per_step']:.3f} ms of it in "
              f"{result['device_ops_per_step']:.1f} kernels / copies: idle share "
              f"{result['idle_share']:.4f}")
    else:
        print(f"  decode trace (torch.profiler, {steps} steps): the trace holds no device "
              f"activity; idle share not measured")
    return result


def left_padded(prompts) -> torch.Tensor:
    """One group's prompts left-padded with token 0 on the card, as the
    ``Engine`` pads them."""
    S = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), S), np.int64)
    for j, p in enumerate(prompts):
        toks[j, S - len(p):] = p
    return torch.from_numpy(toks).cuda()


def prefill_last_logits(cfg, model, tokens, capacity: int, engine: str,
                        cache_dtype=torch.bfloat16) -> tuple:
    """One group's prefill on ``engine``: its last-token logits and cache."""
    from repro_torch.models import init_cache
    from repro_torch.serve import make_prefill_step

    cache = init_cache(cfg, tokens.shape[0], capacity, dtype=cache_dtype, device="cuda")
    return make_prefill_step(cfg, engine)(model, {"tokens": tokens}, cache)


def engines_agree(label: str, cfg, model, prompts, capacity: int, max_new: int,
                  tol: float = LOGITS_TOL, cache_dtype=torch.bfloat16, reference=None) -> dict:
    """One group's prefill on the ``"cuda"`` and ``"torch"`` engines (the
    kernels, their plain versions): last-token logits within ``tol``, then ``max_new`` greedy
    steps teacher-forced with the ``"torch"`` engine's tokens.  At every
    (sequence, step) whose top-2 logit gap on ``"torch"`` exceeds twice the
    largest |logit difference| of the two, their tokens must agree; the
    others are counted.  With ``reference``, the group's last-token logits
    in float32 compute on the same weights, each engine's max |d| from it is
    recorded and the ``"cuda"`` engine's must be within HYBRID_BF16_RATIO x
    the ``"torch"`` engine's."""
    from repro_torch.serve import make_decode_step

    tokens = left_padded(prompts)
    B, S = tokens.shape
    decode = make_decode_step(cfg)
    logits, caches = {}, {}
    for eng in ("cuda", "torch"):
        logits[eng], caches[eng] = prefill_last_logits(cfg, model, tokens, capacity, eng,
                                                       cache_dtype)
    prefill_err = float((logits["cuda"] - logits["torch"]).abs().max())
    logits_rms = float(logits["torch"].float().pow(2).mean().sqrt())
    from_ref = None
    if reference is not None:
        from_ref = {eng: float((lg.float() - reference).abs().max()) for eng, lg in logits.items()}
        print(f"  {label} ({cfg.compute_dtype}): last-token logits max |d| from float32 compute "
              f"on the same weights: cuda {from_ref['cuda']:.4e}, torch {from_ref['torch']:.4e}; "
              f"cuda vs torch {prefill_err:.4e} (rms {logits_rms:.4f})")
        assert from_ref["cuda"] <= HYBRID_BF16_RATIO * from_ref["torch"], (label, from_ref)
    assert prefill_err <= tol, (label, prefill_err, logits_rms)
    decided = under_gap = mismatches = 0
    max_err = 0.0
    for step in range(max_new):
        lt, lc = logits["torch"][:, 0].float(), logits["cuda"][:, 0].float()
        diff = (lc - lt).abs().amax(dim=-1)
        top2 = lt.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * diff
        tok_t, tok_c = lt.argmax(dim=-1), lc.argmax(dim=-1)
        mismatches += int(((tok_t != tok_c) & sure).sum())
        decided += int(sure.sum())
        under_gap += int((~sure).sum())
        max_err = max(max_err, float(diff.max()))
        if step + 1 < max_new:
            tok = tok_t[:, None].to(torch.int32)
            for eng in ("cuda", "torch"):
                logits[eng], caches[eng] = decode(model, tok, caches[eng], S + step)
    assert mismatches == 0, (label, mismatches)
    result = {"label": label, "B": B, "S": S, "compute_dtype": cfg.compute_dtype,
              "prefill_logits_max_abs_err": prefill_err, "logits_rms": logits_rms, "tol": tol,
              "from_float32": from_ref,
              "steps": max_new, "decided": decided, "under_gap": under_gap,
              "mismatches": mismatches, "max_logit_err": max_err}
    print(f"  {label} ({cfg.compute_dtype}): cuda vs torch prefill last-token logits max |d| "
          f"{prefill_err:.4e} (<= {tol}; rms {logits_rms:.4f}); {max_new} teacher-forced steps x {B} sequences: {decided} "
          f"decided, all equal; {under_gap} under the 2x|d| gap; max |d logit| {max_err:.4e}")
    return result


def phase_tinyllama() -> dict:
    """Phase 10: tinyllama-1.1b at full width, served on the card."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import init_model_params

    print("phase 10: tinyllama-1.1b (22 layers, d_model 2048, 32 heads / 4 kv, head_dim 64) "
          "served on the card")
    fa.reset_launches()
    entry = launch_serve.main([])  # the defaults: --arch tinyllama-1.1b --requests 8 --max-new 32
    torch.cuda.synchronize()
    entry_launches = fa.launches()
    assert entry_launches == 22 * 2, entry_launches  # 8 requests in 2 groups of 4
    assert [len(o) for o in entry["outputs"]] == [32] * 8
    print(f"  (a) launch.serve.main(): {entry['tokens']} tokens in {entry['seconds']:.3f} s; "
          f"flash_attention launches {entry_launches} == 22 layers x 2 prefills")

    cfg = configs.get_config("tinyllama-1.1b")
    t0 = time.perf_counter()
    model = init_model_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    lens = rng.randint(512, 2049, size=16)
    prompts = [rng.randint(0, cfg.vocab, size=n) for n in lens]
    result = serve_engine("(b) Engine", cfg, model, prompts, slots=8, capacity=4096, max_new=64)
    result["init_s"] = init_s
    result["entry"] = {"tokens": entry["tokens"], "seconds": entry["seconds"],
                       "flash_launches": entry_launches}
    result["decode_trace"] = decode_idle_share(cfg, model, prompts[:8], 4096, steps=16)
    result["agreement"] = engines_agree("(c) first group", cfg, model, prompts[:8], 4096, 64)
    del model
    torch.cuda.empty_cache()
    return result


def phase_gemma2() -> dict:
    """Phase 11: gemma2-9b at full width, cut to 2 superblocks."""
    from repro_torch import configs
    from repro_torch.models import init_model_params

    full = configs.get_config("gemma2-9b")
    cfg = dataclasses.replace(full, n_superblocks=2, n_layers=4)
    print(f"phase 11: gemma2-9b at full width (d_model 3584, 16 heads / 8 kv, head_dim 256, "
          f"vocab 256000), depth cut from {full.n_layers} to {cfg.n_layers} layers "
          f"(2 superblocks: window 4096 + global), softcap 50")
    t0 = time.perf_counter()
    model = init_model_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab, size=n) for n in (4608, 8192)]
    result = serve_engine("Engine", cfg, model, prompts, slots=2, capacity=8224, max_new=16)
    result["init_s"] = init_s
    result["depth_cut"] = {"n_layers": [full.n_layers, cfg.n_layers],
                           "n_superblocks": [full.n_superblocks, cfg.n_superblocks]}
    result["agreement"] = engines_agree("cuda vs torch", cfg, model, prompts, 8224, 16)
    del model
    torch.cuda.empty_cache()
    return result


# -- training slice ------------------------------------------------------------------


def ce_bound_ms(T: int, D: int, V: int, x_dtype, w_dtype, label_dtype) -> tuple[float, str, int]:
    """Least time for one fused cross-entropy call: the larger of its 2 T D V
    FLOPs over the rate of x's type (bf16 tensor cores, else the float32
    CUDA cores) and its bytes (x, W and the labels read once, the NLL and lse
    written once) over the memory rate."""
    flops = 2 * T * D * V
    peak = BF16_TC_OPS_PER_S if x_dtype == torch.bfloat16 else FP32_OPS_PER_S
    nbytes = (T * D * (torch.finfo(x_dtype).bits // 8) + D * V * (torch.finfo(w_dtype).bits // 8)
              + T * (torch.iinfo(label_dtype).bits // 8) + 2 * 4 * T)
    ops_s, bytes_s = flops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s else "bytes"), flops


def ce_inputs(gen, T, D, V, x_dtype, w_dtype, tied):
    """x ~ N(0, 1) and W ~ N(0, 9 / D): logits of standard deviation near 3.
    ``tied``: W is the transposed view of a [V, D] embedding (gemma2's head)."""
    x = torch.randn(T, D, generator=gen, device="cuda").to(x_dtype)
    scale = 3.0 / math.sqrt(D)
    if tied:
        w = (torch.randn(V, D, generator=gen, device="cuda") * scale).to(w_dtype).T
    else:
        w = (torch.randn(D, V, generator=gen, device="cuda") * scale).to(w_dtype)
    labels = torch.randint(0, V, (T,), generator=gen, device="cuda", dtype=torch.int32)
    return x, w, labels


def check_ce(gen, label, T, D, V, x_dtype, w_dtype, softcap, tied, reps, bad_label=False) -> dict:
    """The cross-entropy kernel against its plain version on one shape, with
    CUDA-event times, the yardstick ``F.cross_entropy(x @ W)`` where it
    computes the same function (no softcap), and the bound."""
    from repro_torch.kernels.crossentropy import crossentropy_forward
    from repro_torch.kernels.ref import crossentropy_lse_ref

    x, w, labels = ce_inputs(gen, T, D, V, x_dtype, w_dtype, tied)
    if bad_label:
        labels[0] = -1  # no label logit for this row
    nll, lse = crossentropy_forward(x, w, labels, softcap)
    ref_nll, ref_lse = crossentropy_lse_ref(x, w, labels, softcap)
    torch.cuda.synchronize()
    dist = lambda a, b: max(float((a[0].double() - b[0].double()).abs().max()),  # noqa: E731
                            float((a[1].double() - b[1].double()).abs().max()))
    plain_err = None
    if x_dtype == torch.bfloat16:
        # the tensor-core kernel sums exact bf16 products in another order
        # than the float32 plain version: both are held to the truth, the
        # plain version in float64 on the same bf16-rounded operands
        want = crossentropy_lse_ref(x, w, labels, softcap, compute_dtype=torch.float64)
        plain_err = dist((ref_nll, ref_lse), want)
    else:
        want = (ref_nll, ref_lse)
    for got, exp in zip((nll, lse), want):
        torch.testing.assert_close(got.double(), exp.double(), atol=CE_ATOL, rtol=CE_RTOL,
                                   msg=label)
    err = dist((nll, lse), want)
    err_f32 = dist((nll, lse), (ref_nll, ref_lse))
    ref_rms = float(ref_nll.pow(2).mean().sqrt())
    del nll, lse, ref_nll, ref_lse, want
    big = T * V >= 1 << 28
    ms = time_ms(lambda: crossentropy_forward(x, w, labels, softcap), reps, 1 if big else 3)
    plain_ms = time_ms(lambda: crossentropy_lse_ref(x, w, labels, softcap), max(1, reps // 2),
                       1 if big else 3)
    library_ms = None
    if not softcap:  # one library call computes the same function (W pre-cast to x's type)
        F = torch.nn.functional
        w_x, lab = w.to(x_dtype), labels.long().clamp(0, V - 1)
        library_ms = time_ms(lambda: F.cross_entropy(torch.matmul(x, w_x).float(), lab,
                                                     reduction="none"), reps, 1 if big else 3)
        del w_x
    bound_ms, bound_by, flops = ce_bound_ms(T, D, V, x_dtype, w.dtype, labels.dtype)
    name = lambda d: "bfloat16" if d == torch.bfloat16 else "float32"  # noqa: E731
    row = {"label": label, "T": T, "D": D, "V": V, "x_dtype": name(x_dtype),
           "w_dtype": name(w_dtype), "softcap": softcap, "tied": tied, "max_abs_err": err,
           "held_to": "float64 plain" if plain_err is not None else "float32 plain",
           "max_abs_err_vs_float32_plain": err_f32, "float32_plain_max_abs_err": plain_err,
           "ref_rms": ref_rms, "atol": CE_ATOL, "rtol": CE_RTOL, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
           "tflops": flops / (ms * 1e9), "share_of_bound": bound_ms / ms}
    lib = f"{library_ms:.4f} ms" if library_ms is not None else "none (softcap)"
    yard = (f"max_abs_err={err:.3e} vs float64 (float32 plain's own {plain_err:.3e}; "
            f"kernel vs float32 plain {err_f32:.3e})" if plain_err is not None
            else f"max_abs_err={err:.3e}")
    print(f"  crossentropy {label:<22} T={T} D={D} V={V} x {name(x_dtype)} W {name(w_dtype)}"
          f"{' tied' if tied else ''} softcap={softcap:g} {yard} "
          f"rms(ref)={ref_rms:.3f} kernel={ms:.4f} ms ({row['tflops']:.2f} TFLOP/s, "
          f"{row['share_of_bound']:.1%} of the bound) plain={plain_ms:.4f} ms library={lib} "
          f"bound={bound_ms:.4f} ms ({bound_by})")
    return row


def check_ce_grad(gen, label, T, D, V, x_dtype, softcap, tied=True) -> dict:
    """dx / dW of ``fused_crossentropy`` (the kernel forward, the written-out
    backward) against autograd through the plain version, per-token weights
    g ~ N(0, 1), W a float32 [D, V] head or, ``tied``, the transposed view
    of a float32 embedding.  Held to
    CE_GRAD_TOL x max |reference| per tensor: float32 sums in another order,
    and with bfloat16 x one bfloat16 rounding of dx (both) and of dW (the
    plain version's gradient crosses W's cast to bfloat16; the Function
    keeps dW in float32)."""
    from repro_torch.kernels.crossentropy import fused_crossentropy
    from repro_torch.kernels.ref import crossentropy_ref

    x, w, labels = ce_inputs(gen, T, D, V, x_dtype, torch.float32, tied)
    g = torch.randn(T, generator=gen, device="cuda")
    grads = []
    for fn in (lambda a, b: fused_crossentropy(a, b, labels, softcap=softcap),
               lambda a, b: crossentropy_ref(a, b, labels, softcap)):
        xr = x.detach().requires_grad_()
        leaf = (w.T if tied else w).detach().requires_grad_()
        grads.append(torch.autograd.grad((fn(xr, leaf.T if tied else leaf) * g).sum(),
                                         (xr, leaf)))
    torch.cuda.synchronize()
    tol = CE_GRAD_TOL[x_dtype]
    out = {"label": label, "T": T, "D": D, "V": V, "softcap": softcap,
           "x_dtype": "bfloat16" if x_dtype == torch.bfloat16 else "float32", "tol": tol}
    for name, got, want in zip(("dx", "dW"), *grads):
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        assert err <= tol * scale, (label, name, err, scale)
        out[name] = {"max_abs_err": err, "max_abs_ref": scale}
    print(f"  crossentropy grad {label:<18} {out['x_dtype']} softcap={softcap:g}: "
          f"dx max_abs_err {out['dx']['max_abs_err']:.3e} (max |ref| {out['dx']['max_abs_ref']:.3e}), "
          f"dW {out['dW']['max_abs_err']:.3e} (max |ref| {out['dW']['max_abs_ref']:.3e}); "
          f"tolerance {tol:g} x max |ref|")
    return out


def phase_crossentropy() -> tuple[list[dict], list[dict]]:
    """Phase 12: the cross-entropy kernel against its plain version, and the
    Function's gradients against autograd through the plain version."""
    print(f"phase 12: crossentropy kernels vs plain PyTorch version; "
          f"{nvidia_smi('name,power.limit')}")
    from repro_torch.kernels import _build

    for key, lines in ce_ptxas(_build.build_log()).items():
        print(f"  ptxas crossentropy ({key}): {'; '.join(lines)}")
    gen = torch.Generator(device="cuda").manual_seed(12)
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    for D in (32, 64, 128):  # the tune study's shapes
        rows.append(check_ce(gen, f"tune D={D}", 512, D, 256, bf16, f32, 0.0, False, 20))
    for x_dtype in (f32, bf16):  # ragged edges: T and V not multiples of the tiles
        for cap in (0.0, 30.0):
            rows.append(check_ce(gen, "ragged", 1000, 48, 1000, x_dtype, f32, cap, False, 20,
                                 bad_label=True))
    rows.append(check_ce(gen, "ragged, tied bf16 W", 1000, 48, 1000, bf16, bf16, 30.0, True, 20))
    rows.append(check_ce(gen, "ragged, tied f32 W", 1000, 48, 1000, bf16, f32, 30.0, True, 20,
                         bad_label=True))
    rows.append(check_ce(gen, "ragged, untied bf16 W", 1000, 48, 1000, bf16, bf16, 0.0, False, 20,
                         bad_label=True))
    rows.append(check_ce(gen, "tinyllama training", 16384, 2048, 32000, bf16, f32, 0.0, False, 5))
    rows.append(check_ce(gen, "gemma2 training", 8192, 3584, 256000, bf16, f32, 30.0, True, 2))
    grads = [check_ce_grad(gen, "ragged", 1000, 48, 1000, f32, 0.0),
             check_ce_grad(gen, "ragged", 1000, 48, 1000, f32, 30.0),
             check_ce_grad(gen, "ragged", 1000, 48, 1000, bf16, 30.0),
             check_ce_grad(gen, "tinyllama, T=2048", 2048, 2048, 32000, bf16, 0.0)]
    return rows, grads


def check_flash_grad(gen, label, B, Hq, Hkv, S, D, dtype, kw, chunk) -> dict:
    """dq / dk / dv of ``FlashAttentionFunction`` against autograd through
    the plain version (q and k scaled by 3, as in phase 9), each held to
    GRAD_TOL x max |reference|; the written-out backward's time."""
    from repro_torch.kernels.flash_attention import (
        FlashAttentionFunction,
        flash_attention_backward,
    )
    from repro_torch.kernels.ref import flash_attention_ref

    q, k, v = flash_inputs(gen, B, Hq, Hkv, S, S, D, dtype, True, 3.0)
    do = torch.randn(B, S, Hq, D, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    args = (True, kw.get("window", -1), kw.get("softcap", 0.0), 0, None, chunk)
    grads = []
    for fn in (lambda a, b, c: FlashAttentionFunction.apply(a, b, c, *args),
               lambda a, b, c: flash_attention_ref(a, b, c, **kw)):
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*ins), ins, do))
        del ins
    torch.cuda.synchronize()
    tol = GRAD_TOL[dtype]
    row = {"label": label, "B": B, "Hq": Hq, "Hkv": Hkv, "S": S, "D": D,
           "dtype": "bfloat16" if dtype == torch.bfloat16 else "float32", **kw, "tol": tol}
    for name, got, want in zip(("dq", "dk", "dv"), *grads):
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        assert err <= tol * scale, (label, name, err, scale)
        row[name] = {"max_abs_err": err, "max_abs_ref": scale}
    del grads
    bw = dict(causal=True, window=args[1], softcap=args[2], chunk=chunk)
    row["backward_ms"] = time_ms(lambda: flash_attention_backward(q, k, v, do, **bw), 2, 1)
    print(f"  flash grad {label:<24} B={B} H={Hq}/{Hkv} S={S} D={D} {row['dtype']} {kw}: "
          + ", ".join(f"{n} {row[n]['max_abs_err']:.3e} (max |ref| {row[n]['max_abs_ref']:.3e})"
                      for n in ("dq", "dk", "dv"))
          + f"; tolerance {tol:g} x max |ref|; backward {row['backward_ms']:.2f} ms")
    return row


def phase_flash_grad() -> list[dict]:
    """Phase 13: the flash-attention gradient against autograd through the
    plain version."""
    print(f"phase 13: flash_attention gradient (written-out backward) vs autograd of the plain "
          f"version; {nvidia_smi('name,power.limit')}")
    gen = torch.Generator(device="cuda").manual_seed(13)
    return [check_flash_grad(gen, "tinyllama heads", 2, 32, 4, 2048, 64, dtype, {}, 256)
            for dtype in (torch.bfloat16, torch.float32)] + [
        check_flash_grad(gen, "gemma2 heads, window", 1, 16, 8, 8192, 256, torch.bfloat16,
                         {"window": 4096, "softcap": 50.0}, 256)]


class TrainStepTimer:
    """Wraps ``make_train_step`` so that every step is synchronized with the
    card on both sides and timed on the host clock."""

    def __init__(self):
        self.seconds: list[float] = []

    def wrap(self, make):
        def make_timed(*args, **kwargs):
            step = make(*args, **kwargs)

            def timed(*a):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(*a)
                torch.cuda.synchronize()
                self.seconds.append(time.perf_counter() - t0)
                return out

            return timed

        return make_timed


def run_training(label: str, cfg, run, tokens_per_step: int, falling: bool = True,
                 microbatch: int = 1) -> dict:
    """Runs ``run()`` (a launcher or a Trainer) with every train step timed
    and the kernels' launch counts set to 0 just before and read just
    after; asserts one cross-entropy launch a step and the flash-attention,
    SSD and sLSTM launches of ``launches_per_call(cfg, train=True)`` a step
    (the remat recomputes each superblock's forward in the backward pass),
    each ``microbatch`` times a step under gradient accumulation, and, with
    ``falling``, a last loss below the first (each step's loss is on a new
    batch)."""
    from repro_torch.kernels import crossentropy as ce
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import slstm, ssd
    from repro_torch.train import train_loop

    timer = TrainStepTimer()
    real = train_loop.make_train_step
    train_loop.make_train_step = timer.wrap(real)
    try:
        torch.cuda.reset_peak_memory_stats()
        for kernel in (ce, fa, ssd, slstm):
            kernel.reset_launches()
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"crossentropy": ce.launches(), "flash_attention": fa.launches(),
                    "ssd": ssd.launches(), "slstm": slstm.launches()}
    finally:
        train_loop.make_train_step = real
    steps = len(timer.seconds)
    per_step = {k: microbatch * n for k, n in
                {"crossentropy": 1, **launches_per_call(cfg, train=True)}.items()}
    assert launches == {k: n * steps for k, n in per_step.items()}, (launches, per_step, steps)
    losses = result["losses"]
    assert len(losses) == steps and all(math.isfinite(l) for l in losses), losses
    assert not falling or losses[-1] < losses[0], losses
    out = {"label": label, "steps": steps, "seconds": seconds, "step_s": timer.seconds,
           "tokens_per_step": tokens_per_step,
           "tokens_per_s": [tokens_per_step / s for s in timer.seconds], "losses": losses,
           "launches": launches, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    for i, (s, loss) in enumerate(zip(timer.seconds, losses)):
        print(f"    step {i}: {s:.4f} s, {tokens_per_step / s:.1f} tokens/s, loss {loss:.4f}")
    print(f"  {label}: {steps} steps in {seconds:.2f} s; peak memory {out['peak_mem_gib']:.2f} GiB; "
          f"launches: crossentropy {launches['crossentropy']} == {per_step['crossentropy']} x "
          f"{steps} steps, flash_attention "
          f"{launches['flash_attention']} == {per_step['flash_attention']} x {steps} steps, ssd "
          f"{launches['ssd']} == {per_step['ssd']} x {steps} steps, slstm {launches['slstm']} == "
          f"{per_step['slstm']} x {steps} steps")
    return result, out


def engines_loss(cfg, model, batch, tol: float = TRAIN_LOSS_TOL) -> dict:
    """The loss of one batch at the same weights on the ``cuda`` engine (the
    kernels) and the ``torch`` engine (their plain versions), within
    ``tol``."""
    from repro_torch.models import loss_fn

    with torch.no_grad():
        losses = {e: float(loss_fn(model, batch, engine=e)[0]) for e in ("cuda", "torch")}
    gap = abs(losses["cuda"] - losses["torch"])
    assert gap <= tol, (losses, gap)
    print(f"  cuda vs torch engine, one batch at the same weights: loss {losses['cuda']:.6f} vs "
          f"{losses['torch']:.6f}, |d| {gap:.3e} (<= {tol})")
    return {**losses, "abs_diff": gap, "tol": tol}


@contextlib.contextmanager
def plain_slstm_as(scan):
    """The ``torch`` engine's sLSTM scan (the plain version) replaced by
    ``scan(plain, *args, **kwargs)`` inside the block."""
    from repro_torch.models import ssm_xlstm

    plain = ssm_xlstm.slstm_scan_ref
    ssm_xlstm.slstm_scan_ref = lambda *args, **kwargs: scan(plain, *args, **kwargs)
    try:
        yield
    finally:
        ssm_xlstm.slstm_scan_ref = plain


def slstm_float64(plain, *args, **kwargs):
    """The plain scan in float64, its outputs rounded to float32: a yardstick
    of float32's rounding through the recurrence."""
    hs, final = plain(*args, compute_dtype=torch.float64, **kwargs)
    return hs.float(), tuple(t.float() for t in final)


def slstm_dims_reversed(plain, u, R, c0, n0, h0, m0, **kwargs):
    """The plain float32 scan with each head's dims relabelled in reverse: the
    same recurrence, its h @ R summed over k in the other order (another
    float32 rounding of the same function)."""
    B, S, d4 = u.shape
    H, D = R.shape[1], R.shape[2]
    u = u.reshape(B, S, 4, H, D).flip(-1).reshape(B, S, d4)
    hs, final = plain(u, R.flip(2, 3), *(t.flip(-1) for t in (c0, n0, h0, m0)), **kwargs)
    return (hs.reshape(B, S, H, D).flip(-1).reshape(B, S, H * D),
            tuple(t.flip(-1) for t in final))


def slstm_kernel_order(plain, u, R, c0, n0, h0, m0):
    """The plain float32 scan with ``h @ R`` summed as the sLSTM kernel
    (``csrc/slstm.cu``) sums it: per column the plan's ``parts`` ranges of
    consecutive k, each a chain of FMAs from zero (a float64 product, exact
    for float32 operands, plus the running sum, rounded to float32), the
    parts added in order from zero, u added last; the gates as the plain
    version computes them (``plain`` is not called)."""
    from repro_torch.kernels import slstm

    B, S, d4 = u.shape
    H, D = R.shape[1], R.shape[2]
    parts = slstm.slstm_plan(B, H, D, u.dtype)["parts"]
    kp = D // parts
    assert kp * parts == D, (D, parts)
    f32 = torch.float32
    Rk = R.double().reshape(4, H, parts, kp, D).permute(3, 0, 1, 2, 4)[:, :, None]
    c, n, h, m = (t.to(f32) for t in (c0, n0, h0, m0))
    hs = []
    for t in range(S):
        hk = h.double().reshape(B, H, parts, kp).permute(3, 0, 1, 2)[..., None]
        acc = torch.zeros((4, B, H, parts, D), dtype=f32, device=u.device)
        for i in range(kp):
            acc = torch.addcmul(acc, hk[i], Rk[i]).to(f32)
        rec = torch.zeros((4, B, H, D), dtype=f32, device=u.device)
        for q in range(parts):
            rec = rec + acc[:, :, :, q]
        a = u[:, t].to(f32).reshape(B, 4, H, D).transpose(0, 1) + rec
        z, i_, f, o = torch.tanh(a[0]), a[1], a[2], torch.sigmoid(a[3])
        m_new = torch.maximum(f + m, i_)
        ig, fg = torch.exp(i_ - m_new), torch.exp(f + m - m_new)
        c = fg * c + ig * z
        n = torch.maximum(fg * n + ig, torch.exp(-m_new))
        h = o * c / n
        m = m_new
        hs.append(h.reshape(B, d4 // 4))
    return torch.stack(hs, dim=1), (c, n, h, m)


def xlstm_engines_loss(cfg, model, batch, short_batch) -> dict:
    """xlstm's loss on the ``cuda`` engine at the same weights, held within
    XLSTM_TRAIN_LOSS_TOL of the plain version: the ``torch`` engine at
    ``short_batch``'s length, and at ``batch``'s (the training length) the
    plain version summing ``h @ R`` in the kernel's order
    (:func:`slstm_kernel_order`).  Recorded beside them: the ``torch``
    engine, the plain version with the dims in reverse order and in float64
    (see XLSTM_TRAIN_LOSS_TOL)."""
    from repro_torch.models import loss_fn

    short = engines_loss(cfg, model, short_batch, tol=XLSTM_TRAIN_LOSS_TOL)
    B = batch["tokens"].shape[0]
    with torch.no_grad():
        losses = {e: float(loss_fn(model, batch, engine=e)[0]) for e in ("cuda", "torch")}
        for name, scan in (("kernel_order", slstm_kernel_order),
                           ("torch_dims_reversed", slstm_dims_reversed),
                           ("float64", slstm_float64)):
            with plain_slstm_as(scan):
                losses[name] = float(loss_fn(model, batch, engine="torch")[0])
    gap = abs(losses["cuda"] - losses["kernel_order"])
    from_f64 = {k: v - losses["float64"] for k, v in losses.items() if k != "float64"}
    print(f"  at {B} x {batch['tokens'].shape[1]} tokens: loss cuda {losses['cuda']:.6f} vs the "
          f"plain version in the kernel's order {losses['kernel_order']:.6f}, "
          f"|d| {gap:.3e} (<= {XLSTM_TRAIN_LOSS_TOL}); recorded: torch "
          f"{losses['torch']:.6f}, torch with the dims reversed "
          f"{losses['torch_dims_reversed']:.6f}, float64 sLSTM {losses['float64']:.6f}; from "
          f"float64: " + ", ".join(f"{k} {v:+.3e}" for k, v in from_f64.items()))
    assert gap <= XLSTM_TRAIN_LOSS_TOL, (losses, gap)
    return {"short": short, "long": {**losses, "from_float64": from_f64, "abs_diff": gap,
                                      "tol": XLSTM_TRAIN_LOSS_TOL}}


#: the record_function spans of :func:`moe_mla_spans`, and the kind of
#: device time each one's launches make
SPAN_KINDS = {"moe dispatch / combine": "MoE one-hot dispatch / combine",
              "moe experts": "MoE expert GEMMs", "mla chunk": "MLA chunk loop"}


@contextlib.contextmanager
def moe_mla_spans():
    """The MoE dispatch (``_moe_einsum`` / ``_moe_sort``), its experts and the
    MLA chunk body, each wrapped in a ``record_function`` span while the
    block runs, so a trace can tell their device time apart."""
    from torch.profiler import record_function

    from repro_torch.models import attention as attn
    from repro_torch.models import moe

    sites = [(moe, "_moe_einsum", "moe dispatch / combine"),
             (moe, "_moe_sort", "moe dispatch / combine"),
             (moe, "_experts", "moe experts"), (attn, "_mla_chunk", "mla chunk")]
    real = [getattr(mod, attr) for mod, attr, _ in sites]

    def spanned(fn, name):
        def run(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return run

    for (mod, attr, name), fn in zip(sites, real):
        setattr(mod, attr, spanned(fn, name))
    try:
        yield
    finally:
        for (mod, attr, _), fn in zip(sites, real):
            setattr(mod, attr, fn)


def device_time(events, lo: float, hi: float) -> dict:
    """The card's busy time inside [lo, hi] (trace microseconds), its idle
    share, and its device time by kind: the innermost :data:`SPAN_KINDS`
    span around the host call that launched each kernel (matched through the
    trace's correlation ids), else the kernel's name.  A backward kernel that
    autograd launches outside the spans counts by its name."""
    launched = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr is not None:
            launched[corr] = e["ts"]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] in SPAN_KINDS]
    device = sorted((e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                     and e["ts"] < hi and e["ts"] + e["dur"] > lo), key=lambda e: e["ts"])
    kinds = {**{k: 0.0 for k in SPAN_KINDS.values()}, "crossentropy kernel": 0.0,
             "flash_attention kernel": 0.0, "ssd kernel": 0.0, "slstm kernel": 0.0,
             "GEMM (cuBLAS)": 0.0, "other kernels, copies": 0.0}
    busy, end = 0.0, lo
    for e in device:
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b > end:
            busy += b - max(a, end)
            end = b
        t = launched.get(e.get("args", {}).get("correlation"))
        around = [sp for sp in spans if t is not None and sp[0] <= t <= sp[1]]
        low = e["name"].lower()
        kind = (SPAN_KINDS[min(around, key=lambda sp: sp[1] - sp[0])[2]] if around else
                "crossentropy kernel" if "crossentropy" in low else
                "flash_attention kernel" if "flash_attention" in low else
                "ssd kernel" if "ssd_kernel" in low or "ssd_tc_kernel" in low else
                "slstm kernel" if "slstm_kernel" in low else
                "GEMM (cuBLAS)" if any(w in low for w in ("gemm", "xmma", "cutlass", "cublas"))
                else "other kernels, copies")
        kinds[kind] += (b - a) / 1e3
    return {"traced_ms": (hi - lo) / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / (hi - lo) if device else None,
            "device_ops": len(device), "kernel_ms_by_kind": kinds}


def trace_train_step(cfg, model, batch, name: str) -> dict:
    """One synchronized train step (after a warm one) under
    ``torch.profiler``, with the MoE and MLA spans of :func:`moe_mla_spans`
    on: the card's busy time, idle share and device time by kind
    (:func:`device_time`).  The trace is written to ``build/<name>.json``.
    The optimizer update alone is timed with CUDA events after it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.train_loop import make_optimizer_for

    opt = make_optimizer_for(cfg, TrainConfig(lr=3e-4, warmup_steps=1, total_steps=8))
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(cfg, opt)
    step(model, state, 0, batch)
    torch.cuda.synchronize()
    with moe_mla_spans(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        with record_function("train_step"):
            step(model, state, 1, batch)
            torch.cuda.synchronize()
    path = os.path.join(ROOT, "build", f"{name}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    span = next(e for e in events if e.get("cat") == "user_annotation"
                and e["name"] == "train_step")
    out = device_time(events, span["ts"], span["ts"] + span["dur"])
    grads = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    out["optimizer_update_ms"] = time_ms(
        lambda: opt.update(grads, state, dict(model.named_parameters()), 2), 2, 1)
    if out["device_ops"]:
        print(f"  trace of one step (torch.profiler, build/{name}.json): {out['traced_ms']:.1f} ms "
              f"traced, the card busy {out['busy_ms']:.1f} ms in {out['device_ops']} kernels / "
              f"copies: idle share {out['idle_share']:.4f}; by kind: "
              + ", ".join(f"{k} {v:.1f} ms" for k, v in out["kernel_ms_by_kind"].items())
              + f"; optimizer update alone {out['optimizer_update_ms']:.1f} ms (CUDA events)")
    else:
        print("  trace of one step: the trace holds no device activity; idle share not measured")
    return out


def kernel_share(label, train, ce_ms, flash_ms_by_call, bw_ms_by_call) -> dict:
    """The kernels' share of the training wall time: kernel time (CUDA
    events at the step's shapes) x launches over the summed step time."""
    wall = sum(train["step_s"])
    ce_s = train["launches"]["crossentropy"] * ce_ms / 1e3
    fa_s = sum(flash_ms_by_call) / 1e3 * 2 * train["steps"]  # each call twice a step
    bw_s = sum(bw_ms_by_call) / 1e3 * train["steps"]
    out = {"wall_s": wall, "crossentropy_s": ce_s, "flash_s": fa_s,
           "crossentropy_share": ce_s / wall, "flash_share": fa_s / wall,
           "attention_backward_s": bw_s, "attention_backward_share": bw_s / wall}
    print(f"  {label} kernel share of {wall:.3f} s of steps: crossentropy {ce_s:.3f} s "
          f"({100 * out['crossentropy_share']:.2f}%), flash_attention {fa_s:.3f} s "
          f"({100 * out['flash_share']:.2f}%); the written-out attention backward (CUDA events) "
          f"{bw_s:.3f} s ({100 * out['attention_backward_share']:.2f}%)")
    return out


def phase_train_tinyllama(ce_rows, flash_rows) -> dict:
    """Phase 14: train tinyllama-1.1b at full size through the launcher."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention_backward
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_model_params
    from repro_torch.train import SyntheticLM

    B, S, steps = 8, 2048, 8
    print(f"phase 14: train tinyllama-1.1b (22 layers, d_model 2048, vocab 32000) at full size: "
          f"launch.train.main, {steps} steps, batch {B}, seq {S}, bf16 compute, adamw; "
          f"{nvidia_smi('name,power.limit')}")
    cfg = configs.get_config("tinyllama-1.1b")
    argv = ["--arch", "tinyllama-1.1b", "--steps", str(steps), "--batch", str(B),
            "--seq", str(S)]
    result, train = run_training("launch.train.main", cfg, lambda: launch_train.main(argv),
                                 B * S)
    del result
    torch.cuda.empty_cache()
    model = init_model_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = SyntheticLM(cfg, B, S, device="cuda").batch_at(0)
    train["engines"] = engines_loss(cfg, model, batch)
    train["trace"] = trace_train_step(cfg, model, batch, "train_trace_tinyllama")
    del model
    torch.cuda.empty_cache()
    ce_ms = next(r["ms"] for r in ce_rows if r["label"] == "tinyllama training")
    fa_ms = next(r["ms"] for r in flash_rows if r["label"] == "tinyllama prefill")
    gen = torch.Generator(device="cuda").manual_seed(14)
    q, k, v = flash_inputs(gen, B, 32, 4, S, S, 64, torch.bfloat16, True, 3.0)
    bw_ms = time_ms(lambda: flash_attention_backward(q, k, v, q, chunk=cfg.q_chunk), 2, 1)
    del q, k, v
    train["flash_backward_ms"] = bw_ms
    train["share"] = kernel_share("tinyllama", train, ce_ms, [fa_ms] * 22, [bw_ms] * 22)
    return train


def phase_train_gemma2(ce_rows) -> dict:
    """Phase 15: train gemma2-9b at full width, cut to 2 superblocks."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_backward
    from repro_torch.models import init_model_params
    from repro_torch.train import SyntheticLM, TrainConfig, Trainer

    B, S, steps = 1, 8192, 3
    full = configs.get_config("gemma2-9b")
    cfg = dataclasses.replace(full, n_superblocks=2, n_layers=4)
    print(f"phase 15: train gemma2-9b at full width (d_model 3584, head_dim 256, vocab 256000, "
          f"tied head, final softcap 30), depth cut from {full.n_layers} to {cfg.n_layers} "
          f"layers: Trainer, {steps} steps, batch {B}, seq {S}; {nvidia_smi('name,power.limit')}")
    tcfg = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=steps, eval_every=1,
                       checkpoint_every=10**9)
    result, train = run_training(
        "Trainer", cfg, lambda: Trainer(cfg, tcfg, SyntheticLM(cfg, B, S)).run(), B * S)
    del result
    torch.cuda.empty_cache()
    model = init_model_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = SyntheticLM(cfg, B, S, device="cuda").batch_at(0)
    train["engines"] = engines_loss(cfg, model, batch)
    train["trace"] = trace_train_step(cfg, model, batch, "train_trace_gemma2")
    del model
    torch.cuda.empty_cache()
    ce_ms = next(r["ms"] for r in ce_rows if r["label"] == "gemma2 training")
    gen = torch.Generator(device="cuda").manual_seed(15)
    q, k, v = flash_inputs(gen, B, 16, 8, S, S, 256, torch.bfloat16, True, 3.0)
    fwd, bwd = [], []
    for b in cfg.superblock:
        kw = {"window": b.window, "softcap": cfg.attn_softcap}
        fwd.append(time_ms(lambda: flash_attention(q, k, v, **kw), 2, 1))
        bwd.append(time_ms(lambda: flash_attention_backward(q, k, v, q, chunk=cfg.q_chunk, **kw),
                           1, 1))
    del q, k, v
    train["flash_ms"], train["flash_backward_ms"] = fwd, bwd
    train["share"] = kernel_share("gemma2", train, ce_ms, fwd * cfg.n_superblocks,
                                  bwd * cfg.n_superblocks)
    train["depth_cut"] = {"n_layers": [full.n_layers, cfg.n_layers],
                          "n_superblocks": [full.n_superblocks, cfg.n_superblocks]}
    return train


def phase_tune(phase: int, families: tuple) -> dict:
    """Phases 16, 20 and 24: a tune study over ``families`` on the card (the
    tune space's ``mlstm`` family is mLSTM blocks alone: torch ops, no
    sLSTM launch)."""
    import repro_torch.core as hpo
    from repro_torch.core.frozen import TrialState
    from repro_torch.kernels import crossentropy as ce
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import parzen, slstm, ssd
    from repro_torch.tune import LMTuneSpec, make_lm_objective

    n_trials = 16
    spec = LMTuneSpec(families=families)
    # Successive halving prunes most trials, and with Optuna's defaults (10
    # startup trials, pruned trials left out of the history) the sampler
    # would still be drawing at random after 16 trials, never scoring
    print(f"phase {phase}: tune {' + '.join(families)} LMs ({spec}), {n_trials} trials, "
          f"TPESampler(seed=0, engine='cuda', n_startup_trials=4, consider_pruned_trials=True), "
          f"SuccessiveHalvingPruner(min_resource=10, reduction_factor=2); "
          f"{nvidia_smi('name,power.limit')}")
    sampler = hpo.TPESampler(seed=0, engine="cuda", n_startup_trials=4,
                             consider_pruned_trials=True)
    study = hpo.create_study(sampler=sampler,
                             pruner=hpo.SuccessiveHalvingPruner(min_resource=10,
                                                                reduction_factor=2))
    objective = make_lm_objective(spec)
    for kernel in (ce, fa, parzen, ssd, slstm):
        kernel.reset_launches()
    t0 = time.perf_counter()
    study.optimize(objective, n_trials=n_trials)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"parzen_score": parzen.launches(), "crossentropy": ce.launches(),
                "flash_attention": fa.launches(), "ssd": ssd.launches(),
                "slstm": slstm.launches()}
    states = [t.state for t in study.trials]
    complete, pruned = states.count(TrialState.COMPLETE), states.count(TrialState.PRUNED)
    assert complete + pruned == n_trials and complete >= 1, states
    by_family = {f: [t.state.name for t in study.trials if t.params["family"] == f]
                 for f in families}
    assert all(by_family.values()), by_family  # every family trained and reported
    expected = {"parzen_score": True, "crossentropy": True,
                "flash_attention": "dense" in families, "ssd": "mamba2" in families,
                "slstm": False}
    assert all((launches[k] > 0) == v for k, v in expected.items()), launches
    steps = sum(len(t.intermediate_values) * spec.eval_every for t in study.trials)
    assert launches["crossentropy"] == steps, (launches, steps)
    best = study.best_trial
    deployed = objective(hpo.FixedTrial(best.params))
    assert math.isfinite(deployed)
    out = {"trials": n_trials, "seconds": seconds, "trials_per_s": n_trials / seconds,
           "complete": complete, "pruned": pruned, "train_steps": steps,
           "states_by_family": by_family, "best_value": study.best_value,
           "best_params": best.params, "deployed_value": deployed, "launches": launches}
    print(f"  {n_trials} trials in {seconds:.2f} s = {out['trials_per_s']:.3f} trials/s: "
          f"{complete} complete, {pruned} pruned, {steps} train steps; by family {by_family}; "
          f"best value {study.best_value:.4f} ({best.params}); deployed through FixedTrial: "
          f"{deployed:.4f}")
    print(f"  launches: parzen_score {launches['parzen_score']}, crossentropy "
          f"{launches['crossentropy']} == {steps} train steps, flash_attention "
          f"{launches['flash_attention']}, ssd {launches['ssd']}, slstm {launches['slstm']}")
    return out


# -- mamba2 slice ----------------------------------------------------------------------

#: the SSD kernel against its plain version run in float64 (the exact
#: function, to float32's rounding of the inputs): the reference's kernel
#: tolerance (tests/test_kernels.py).  The plain version's own float32
#: rounding is recorded beside it: at L = 1 (the halving rule on S = 1895) a
#: head of A = -0.001 carries its state through 1895 sequential float32
#: steps, and the float32 plain version lands 8.1e-3 from float64 on y of
#: |y| up to 605 where the kernel's L = 128 chunks land 2.2e-4 from it
SSD_TOL = 2e-3


def ssd_inputs(gen, B, S, H, P, G, N, dtype, init, model_layout):
    """x [B, S, H, P], dt [B, S, H] = |N(0, 1)| / 2, A [H] = -|N(0, 1)|, B
    and C [B, S, G, N] (the reference's test distributions), and a float32
    initial state when ``init``.  With ``model_layout`` x, B and C are
    strided slices of one [B, S, H P + 2 G N] tensor, as a mamba2 block's
    conv output hands them to the kernel."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    if model_layout:
        conv = randn(B, S, H * P + 2 * G * N).to(dtype)
        x = conv[..., :H * P].reshape(B, S, H, P)
        Bm = conv[..., H * P:H * P + G * N].reshape(B, S, G, N)
        Cm = conv[..., H * P + G * N:].reshape(B, S, G, N)
    else:
        x, Bm, Cm = randn(B, S, H, P).to(dtype), randn(B, S, G, N).to(dtype), randn(
            B, S, G, N).to(dtype)
    dt = randn(B, S, H).abs_().mul_(0.5)
    A = -randn(H).abs_()
    return x, dt, A, Bm, Cm, (randn(B, H, P, N) if init else None)


def ssd_dims(args) -> tuple:
    B, S, H, P = args[0].shape
    return B, S, H, P, args[3].shape[2], args[3].shape[3]


def ssd_bound_ms(B, S, H, P, G, N, chunk, dtype, init) -> tuple[float, str, int, float]:
    """Least time for one SSD scan: the larger of the chunk contractions'
    FLOPs this data needs over the float32 rate (the reference scans in
    float32) and the bytes (x, dt, A, B, C and the initial state read once,
    y and the final state written once) over the memory rate; also the
    bytes' time alone, which a tensor-core kernel is read against.  Per chunk of
    l steps (the kernel's chunks) and per batch and head, the l (l + 1) / 2
    pairs s <= t take 2 N for C_t . B_s and 2 P for M u, as flash_bound_ms
    counts only the pairs a query sees; the state's read into y and its
    update take 4 l P N."""
    from repro_torch.kernels.ssd import kernel_chunk_len

    L = kernel_chunk_len(S, chunk)
    lens = [L] * (S // L) + ([S % L] if S % L else [])
    flops = B * H * sum(l * (l + 1) // 2 * (2 * N + 2 * P) + 4 * l * P * N for l in lens)
    elem = torch.finfo(dtype).bits // 8
    nbytes = (elem * (B * S * H * P + 2 * B * S * G * N) + 4 * (B * S * H + H)
              + 4 * B * S * H * P + 4 * B * H * P * N * (2 if init else 1))
    ops_s, bytes_s = flops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s else "bytes"), flops,
            1e3 * bytes_s)


def ssd_ptxas(build_log: str) -> dict:
    """``ptxas`` lines of each SSD kernel instance: the bfloat16 tensor-core
    kernel, and the float32 CUDA-core kernel keyed by its register tiles."""
    out = {"bfloat16 (tensor cores)": lines
           for lines in kernel_ptxas(build_log, "ssd_tc_kernel").values()}
    for name, lines in kernel_ptxas(build_log, "ssd_kernel").items():
        tiles = re.search(r"Li(\d+)E", name).group(1)
        out[f"float32, MT={tiles}"] = lines
    return out


def ssd_float64(args, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version in float64 on :func:`ssd_inputs`' tensors, one batch
    row at a time (at L = 1 its per-chunk states take 4 GB a row at zamba2's
    widths)."""
    from repro_torch.kernels.ref import ssd_chunked_ref

    x, dt, A, Bm, Cm, init = args
    outs = [ssd_chunked_ref(x[b:b + 1], dt[b:b + 1], A, Bm[b:b + 1], Cm[b:b + 1], chunk,
                            None if init is None else init[b:b + 1],
                            compute_dtype=torch.float64) for b in range(x.shape[0])]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def check_ssd(gen, label, B, S, H, P, G, N, chunk, dtype, init, model_layout, reps) -> dict:
    """The SSD kernel against its plain version run in float64: y and the
    final state within SSD_TOL and a tenth of the exact output's rms (which
    must be at least 10x the tolerance); the float32 plain version's own
    distance from float64 recorded; CUDA-event times and the bound."""
    from repro_torch.kernels.ref import ssd_chunk_len, ssd_chunked_ref
    from repro_torch.kernels.ssd import kernel_chunk_len, ssd_forward

    args = ssd_inputs(gen, B, S, H, P, G, N, dtype, init, model_layout)
    y, f = ssd_forward(*args[:5], chunk, args[5])
    ry, rf = ssd_chunked_ref(*args[:5], chunk, args[5])
    ey, ef = ssd_float64(args, chunk)
    torch.cuda.synchronize()
    errs, plain_errs, rms = {}, {}, {}
    for name, got, plain, want in (("y", y, ry, ey), ("final", f, rf, ef)):
        errs[name] = float((got.double() - want).abs().max())
        plain_errs[name] = float((plain.double() - want).abs().max())
        rms[name] = float(want.pow(2).mean().sqrt())
        assert rms[name] >= 10 * SSD_TOL, (label, name, rms[name])
        assert errs[name] <= min(SSD_TOL, rms[name] / 10), (label, name, errs[name], rms[name])
    del y, f, ry, rf, ey, ef
    ms = time_ms(lambda: ssd_forward(*args[:5], chunk, args[5]), reps)
    card_ms = graph_ms(lambda: ssd_forward(*args[:5], chunk, args[5]), 5, max(1, reps // 3))
    plain_ms = time_ms(lambda: ssd_chunked_ref(*args[:5], chunk, args[5]), max(1, reps // 3), 1)
    bound_ms, bound_by, flops, bytes_ms = ssd_bound_ms(B, S, H, P, G, N, chunk, dtype, init)
    dname = "bfloat16" if dtype == torch.bfloat16 else "float32"
    row = {"label": label, "B": B, "S": S, "H": H, "P": P, "G": G, "N": N, "chunk": chunk,
           "kernel_L": kernel_chunk_len(S, chunk), "plain_L": ssd_chunk_len(S, chunk),
           "dtype": dname, "init": init, "layout": "model" if model_layout else "contiguous",
           "max_abs_err": max(errs.values()), "errs": errs, "plain_f32_errs": plain_errs,
           "ref_rms": rms, "tol": SSD_TOL,
           "ms": ms, "card_ms": card_ms, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": bound_ms, "bytes_bound_ms": bytes_ms,
           "bound_by": bound_by, "flops": flops, "tflops": flops / (ms * 1e9)}
    print(f"  ssd {label:<24} B={B} S={S} H={H} P={P} G={G} N={N} L={row['kernel_L']} "
          f"(plain {row['plain_L']}) {dname}{' init' if init else ''}: from float64, max_abs_err y "
          f"{errs['y']:.3e} (rms {rms['y']:.3f}; float32 plain {plain_errs['y']:.3e}) final "
          f"{errs['final']:.3e} (rms {rms['final']:.3f}; float32 plain "
          f"{plain_errs['final']:.3e}); kernel={ms:.4f} ms (card {card_ms:.4f}; "
          f"{row['tflops']:.2f} TFLOP/s) plain={plain_ms:.4f} ms bound={bound_ms:.4g} ms "
          f"({bound_by}; bytes {bytes_ms:.4g} ms)")
    return row


def check_ssd_grad(gen, label, B, S, H, P, G, N, chunk, dtype, init) -> dict:
    """``SSDFunction``'s gradients (the kernel forward, the written-out
    backward) against autograd through the plain version, each within
    GRAD_TOL x its largest |reference|; the backward's time."""
    from repro_torch.kernels.ref import ssd_chunked_ref
    from repro_torch.kernels.ssd import SSDFunction, ssd_backward

    args = ssd_inputs(gen, B, S, H, P, G, N, dtype, init, dtype == torch.bfloat16)
    gy = torch.randn(B, S, H, P, generator=gen, device="cuda")
    gf = torch.randn(B, H, P, N, generator=gen, device="cuda")
    grads = []
    for fn in (SSDFunction.apply, ssd_chunked_ref):
        ins = [a.detach().clone().requires_grad_() if a is not None else None for a in args]
        y, f = fn(*ins[:5], chunk, ins[5])
        leaves = [t for t in ins if t is not None]
        grads.append(torch.autograd.grad((y * gy).sum() + (f * gf).sum(), leaves))
        del ins, y, f, leaves
    torch.cuda.synchronize()
    tol = GRAD_TOL[dtype]
    row = {"label": label, "B": B, "S": S, "H": H, "P": P, "G": G, "N": N, "chunk": chunk,
           "dtype": "bfloat16" if dtype == torch.bfloat16 else "float32", "init": init,
           "tol": tol}
    names = ["dx", "ddt", "dA", "dB", "dC", "dinit"]
    for name, got, want in zip(names, *grads):
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        assert err <= tol * scale, (label, name, err, scale)
        row[name] = {"max_abs_err": err, "max_abs_ref": scale}
    del grads
    row["backward_ms"] = time_ms(lambda: ssd_backward(*args[:5], gy, gf, chunk, args[5]), 2, 1)
    print(f"  ssd grad {label:<20} B={B} S={S} H={H} P={P} G={G} N={N} {row['dtype']}: "
          + ", ".join(f"{n} {row[n]['max_abs_err']:.3e} (max |ref| {row[n]['max_abs_ref']:.3e})"
                      for n in names if n in row)
          + f"; tolerance {tol:g} x max |ref|; backward {row['backward_ms']:.2f} ms")
    return row


def phase_ssd(build_log: str) -> tuple[list[dict], list[dict], dict]:
    """Phase 17: the SSD kernel against its plain version, and the
    Function's gradients against autograd through the plain version."""
    print(f"phase 17: ssd kernel vs plain PyTorch version; {nvidia_smi('name,power.limit')}")
    gen = torch.Generator(device="cuda").manual_seed(17)
    ptxas = ssd_ptxas(build_log)
    for key, lines in ptxas.items():
        print(f"  ptxas ssd ({key}): {'; '.join(lines)}")
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    # the reference's own sweep (tests/test_kernels.py): 3 folded (batch, head) rows
    for S, P, N, chunk in ((64, 16, 8, 16), (128, 32, 16, 32), (32, 8, 8, 32)):
        rows.append(check_ssd(gen, "reference sweep", 3, S, 1, P, 1, N, chunk, f32, False,
                              False, 20))
    rows.append(check_ssd(gen, "4 groups, initial state", 2, 256, 8, 32, 4, 16, 64, f32, True,
                          False, 20))
    rows.append(check_ssd(gen, "odd S", 2, 1001, 8, 16, 1, 16, 128, bf16, True, True, 10))
    rows.append(check_ssd(gen, "prime S", 2, 2039, 8, 64, 1, 64, 128, f32, False, False, 10))
    rows.append(check_ssd(gen, "zamba2 smoke", 2, 64, 8, 16, 1, 16, 16, f32, False, True, 20))
    for N in (8, 16):  # the tune study's widest mamba2 trial
        rows.append(check_ssd(gen, f"tune N={N}", 8, 64, 16, 16, 1, N, 16, f32, False, True, 20))
    rows.append(check_ssd(gen, "zamba2 prefill", 8, 2048, 64, 64, 1, 64, 128, bf16, True, True,
                          10))
    rows.append(check_ssd(gen, "zamba2 training", 8, 2048, 64, 64, 1, 64, 128, bf16, False,
                          True, 10))
    rows.append(check_ssd(gen, "zamba2 prefill float32", 8, 2048, 64, 64, 1, 64, 128, f32, True,
                          True, 10))  # the CUDA-core kernel at the main path's shape
    rows.append(check_ssd(gen, "zamba2 heads, L=64", 2, 2048, 64, 64, 1, 64, 64, bf16, True,
                          True, 10))  # chunks of 4 strips: each strip taken by one warp pair
    for B, S in zamba2_groups():  # phase 18(b)'s prefills: ragged last chunks, the cache's state
        rows.append(check_ssd(gen, "zamba2 serve group", B, S, 64, 64, 1, 64, 128, bf16, True,
                              True, 10))
    grads = [check_ssd_grad(gen, "tune", 8, 64, 16, 16, 1, 16, 16, f32, False),
             check_ssd_grad(gen, "zamba2 heads", 2, 2048, 64, 64, 1, 64, 128, bf16, True)]
    return rows, grads, ptxas


#: phase 18(b)'s and 22(b)'s traffic: 16 requests of 512-2048 tokens in groups of 8 slots
ZAMBA2_SLOTS = 8


def zamba2_prompts(vocab: int) -> list[np.ndarray]:
    """Phase 18(b)'s 16 prompts of 512-2048 tokens, as phase 10(b)'s."""
    rng = np.random.RandomState(0)
    lens = rng.randint(512, 2049, size=16)
    return [rng.randint(0, vocab, size=n) for n in lens]


def zamba2_groups() -> list[tuple[int, int]]:
    """(B, S) of each prefill the Engine makes of :func:`zamba2_prompts`:
    ``ZAMBA2_SLOTS`` prompts a group, left-padded to the longest."""
    prompts = zamba2_prompts(2)
    return [(len(g), max(len(p) for p in g))
            for g in (prompts[i:i + ZAMBA2_SLOTS] for i in range(0, len(prompts), ZAMBA2_SLOTS))]


def phase_serve_zamba2(ssd_rows) -> dict:
    """Phase 18: zamba2-1.2b at full size, served on the card."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import slstm, ssd
    from repro_torch.kernels.ref import ssd_chunk_len
    from repro_torch.kernels.ssd import kernel_chunk_len
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import Transformer, count_params, init_model_params

    cfg = configs.get_config("zamba2-1.2b")
    per_prefill = launches_per_call(cfg)
    print(f"phase 18: zamba2-1.2b ({per_prefill['ssd']} mamba2 blocks + {per_prefill['flash_attention']} "
          f"applications of the shared attention / SwiGLU block, d_model 2048, "
          f"{count_params(cfg) / 1e9:.3f} B parameters) served on the card; "
          f"{nvidia_smi('name,power.limit')}")
    for kernel in (fa, ssd, slstm):
        kernel.reset_launches()
    entry = launch_serve.main(["--arch", "zamba2-1.2b"])  # 8 requests, 2 groups of 4
    torch.cuda.synchronize()
    entry_launches = {"flash_attention": fa.launches(), "ssd": ssd.launches(),
                      "slstm": slstm.launches()}
    assert entry_launches == {k: 2 * n for k, n in per_prefill.items()}, entry_launches
    assert [len(o) for o in entry["outputs"]] == [32] * 8
    print(f"  (a) launch.serve.main(['--arch', 'zamba2-1.2b']): {entry['tokens']} tokens in "
          f"{entry['seconds']:.3f} s; launches {entry_launches} == {per_prefill} x 2 prefills")
    t0 = time.perf_counter()
    model = init_model_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = zamba2_prompts(cfg.vocab)
    result = serve_engine("(b) Engine", cfg, model, prompts, slots=ZAMBA2_SLOTS, capacity=4096,
                          max_new=64)
    checked = {(r["B"], r["S"]) for r in ssd_rows if r["init"] and r["dtype"] == "bfloat16"}
    assert set(result["prefill_shapes"]) <= checked, (result["prefill_shapes"], checked)
    result["chunk_len"] = [{"B": B, "S": S, "kernel_L": kernel_chunk_len(S, cfg.ssm_chunk),
                            "reference_L": ssd_chunk_len(S, cfg.ssm_chunk)}
                           for B, S in result["prefill_shapes"]]
    print(f"    chunk length of each prefill group (each group's SSD shape held to the plain "
          f"version in phase 17): {result['chunk_len']}")
    result["init_s"] = init_s
    result["entry"] = {"tokens": entry["tokens"], "seconds": entry["seconds"],
                       "launches": entry_launches}
    result["decode_trace"] = decode_idle_share(cfg, model, prompts[:8], 4096, steps=16)
    # (c) the first group on both engines, first in float32 compute with a
    # float32 cache, where they differ by float32 summation order alone; the
    # weights are the served model's (rounded to bfloat16 by the Engine), so
    # the float32 plain engine's logits also measure both engines' bfloat16
    # rounding error on the same weights
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model32 = Transformer(cfg32, device="cuda")
    model32.load_state_dict(model.state_dict())
    result["agreement"] = engines_agree("(c) first group", cfg32, model32, prompts[:8], 4096, 64,
                                        tol=HYBRID_F32_LOGITS_TOL, cache_dtype=torch.float32)
    reference = prefill_last_logits(cfg32, model32, left_padded(prompts[:8]), 4096, "torch",
                                    torch.float32)[0].float()
    del model32
    torch.cuda.empty_cache()
    result["agreement_bf16"] = engines_agree("(c) first group", cfg, model, prompts[:8], 4096, 16,
                                             tol=HYBRID_BF16_LOGITS_TOL, reference=reference)
    del model, reference
    torch.cuda.empty_cache()
    return result


def phase_train_zamba2(ssd_rows) -> dict:
    """Phase 19: train zamba2-1.2b at full size through the launcher."""
    from repro_torch import configs
    from repro_torch.kernels.ssd import ssd_backward
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_model_params, loss_fn
    from repro_torch.train import SyntheticLM

    B, S, steps = 8, 2048, 8
    cfg = configs.get_config("zamba2-1.2b")
    print(f"phase 19: train zamba2-1.2b at full size: launch.train.main, {steps} steps, batch "
          f"{B}, seq {S}, bf16 compute, adamw, remat; {nvidia_smi('name,power.limit')}")
    argv = ["--arch", "zamba2-1.2b", "--steps", str(steps), "--batch", str(B), "--seq", str(S)]
    result, train = run_training("launch.train.main", cfg, lambda: launch_train.main(argv),
                                 B * S)
    # each step's loss is on a new batch, whose spread (about 0.02 here) is
    # as large as 8 steps' progress: hold the first batch's loss at the
    # trained weights to its loss at the initial ones (step 0's loss)
    batch = SyntheticLM(cfg, B, S, device="cuda").batch_at(0)
    with torch.no_grad():
        trained = float(loss_fn(result["model"], batch)[0])
    initial = train["losses"][0]
    assert math.isfinite(trained) and trained < initial, (initial, trained)
    train["batch0_loss"] = {"initial": initial, "trained": trained}
    print(f"  the first batch's loss: {initial:.6f} at the initial weights, {trained:.6f} after "
          f"{steps} steps")
    del result
    torch.cuda.empty_cache()
    model = init_model_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    train["engines"] = engines_loss(cfg, model, batch)
    train["trace"] = trace_train_step(cfg, model, batch, "train_trace_zamba2")
    del model, batch
    torch.cuda.empty_cache()
    # the kernels' share: SSD forward at the step's shape x its launches, the
    # written-out SSD backward once per mamba2 block (CUDA events)
    ssd_ms = next(r["ms"] for r in ssd_rows if r["label"] == "zamba2 training")
    gen = torch.Generator(device="cuda").manual_seed(19)
    args = ssd_model_inputs(gen, cfg, B, S, init=False)
    dy = torch.randn(args[0].shape, generator=gen, device="cuda")
    bw_ms = time_ms(lambda: ssd_backward(*args[:5], dy, None, cfg.ssm_chunk), 2, 1)
    del args, dy
    torch.cuda.empty_cache()
    wall = sum(train["step_s"])
    ssd_s = train["launches"]["ssd"] * ssd_ms / 1e3
    bw_s = launches_per_call(cfg)["ssd"] * train["steps"] * bw_ms / 1e3
    train["share"] = {"wall_s": wall, "ssd_s": ssd_s, "ssd_share": ssd_s / wall,
                      "ssd_backward_ms": bw_ms, "ssd_backward_s": bw_s,
                      "ssd_backward_share": bw_s / wall}
    print(f"  zamba2 kernel share of {wall:.3f} s of steps: ssd {ssd_s:.3f} s "
          f"({100 * ssd_s / wall:.2f}%: {ssd_ms:.3f} ms x {train['launches']['ssd']} launches); the "
          f"written-out ssd backward {bw_ms:.2f} ms a block (CUDA events), {bw_s:.3f} s "
          f"({100 * bw_s / wall:.2f}%)")
    return train


# -- xlstm slice -----------------------------------------------------------------------

#: the sLSTM kernel against its plain version run in float64.  Each step is
#: held to one float64 step from the kernel's own entering state (the
#: previous step's h, c, n, m): within SLSTM_STEP_TOL (atol and rtol), a few
#: float32 roundings of the step.  The whole run from the initial state is
#: held to a tenth of each exact tensor's rms, with the float32 plain
#: version's own distance printed beside it: the recurrence amplifies each
#: step's rounding, and over 2048 steps float32 itself drifts past the SSD's
#: 2e-3 (on the H100 at B 8 x S 2048 x 4 heads of 512 from the empty state
#: the float32 plain version lay 0.037 from float64 on the state's n, of rms
#: 4.8, and the kernel 0.100; from a non-empty state 2.7e-3 on h_seq, the
#: kernel 1.6e-3).  h_seq's rms must be at least 10 x SLSTM_TOL
SLSTM_TOL = 2e-3
SLSTM_STEP_TOL = 1e-5


def slstm_inputs(gen, B, S, H, D, dtype, init, model_layout, u_std=1.0, r_std=None):
    """u [B, S, 4 H D] ~ N(0, u_std^2) (the model's normed input times
    ``w_zifo`` has unit scale), R [4, H, D, D] ~ N(0, r_std^2) (default the
    model's init, 1 / sqrt(D)), and a float32 state: with ``init`` c ~
    N(0, 1), n = 1 + |N(0, 1)|, h ~ N(0, 0.1^2), m ~ N(0, 1), else the empty
    cache's (zeros, m = -1e30).  With ``model_layout`` u is a slice of a
    wider [B, S, 4 H D + 64] tensor, read through its strides."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    d4 = 4 * H * D
    if model_layout:
        u = (randn(B, S, d4 + 64) * u_std).to(dtype)[..., 32:32 + d4]
    else:
        u = (randn(B, S, d4) * u_std).to(dtype)
    R = randn(4, H, D, D) * (r_std if r_std is not None else 1.0 / math.sqrt(D))
    if init:
        state = (randn(B, H, D), 1.0 + randn(B, H, D).abs(), 0.1 * randn(B, H, D),
                 randn(B, H, D))
    else:
        zeros = torch.zeros((B, H, D), device="cuda")
        state = (zeros, zeros, zeros, torch.full((B, H, D), -1e30, device="cuda"))
    return (u, R, *state)


def slstm_bound_ms(B, S, H, D, dtype) -> tuple[float, str, int]:
    """Least time for one sLSTM scan: the larger of the recurrent products'
    2 S B 4 H D^2 float32 FLOPs over the float32 rate (the reference keeps
    them in float32) and the bytes (u, R and the initial state read once,
    h_seq and the final state written once) over the memory rate."""
    flops = 2 * S * B * 4 * H * D * D
    elem = torch.finfo(dtype).bits // 8
    nbytes = (elem * B * S * 4 * H * D + 4 * B * S * H * D + 4 * 4 * H * D * D
              + 2 * 4 * 4 * B * H * D)
    ops_s, bytes_s = flops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s else "bytes"), flops


def slstm_ptxas(build_log: str) -> dict:
    """``ptxas`` lines of each sLSTM kernel instance, keyed by dtype and kind
    (the scan, ``...Lb1E``, and the decode kernel, ``...Lb0E``)."""
    out: dict = {}
    key = None
    for line in build_log.splitlines():
        m = re.search(r"entry function '(\S*slstm_kernel\S*)'", line)
        if m:
            key = ("bfloat16" if "bfloat16" in m.group(1) else "float32") + (
                " scan" if "Lb1E" in m.group(1) else " decode")
            out[key] = []
            continue
        if "entry function" in line:
            key = None
        elif key and ("Used" in line or "spill" in line):
            out[key].append(line.strip().removeprefix("ptxas info    : "))
    return out


def slstm_steps_f64(u, R, c0, n0, h0, m0, h_seq, c_seq, n_seq, m_seq) -> tuple:
    """One float64 step of the recurrence from every step's entering state
    (the initial state, then the given per-step h, c, n, m [B, S, d]): the
    (h, c, n, m) each step would reach, as [B, S, d] float64."""
    B, S, d4 = u.shape
    H, D = R.shape[1], R.shape[2]
    d = d4 // 4
    f64 = torch.float64

    def entering(first, seq):
        return torch.cat([first.reshape(B, 1, d), seq[:, :-1]], dim=1).to(f64)

    hp, cp, np_, mp = (entering(a, b) for a, b in ((h0, h_seq), (c0, c_seq), (n0, n_seq),
                                                    (m0, m_seq)))
    rec = torch.einsum("bshd,ghde->bsghe", hp.reshape(B, S, H, D), R.to(f64))
    a = u.to(f64).reshape(B, S, 4, d) + rec.reshape(B, S, 4, d)
    del rec
    z, i, f, o = torch.tanh(a[:, :, 0]), a[:, :, 1], a[:, :, 2], torch.sigmoid(a[:, :, 3])
    m = torch.maximum(f + mp, i)
    ig, fg = torch.exp(i - m), torch.exp(f + mp - m)
    c = fg * cp + ig * z
    n = torch.maximum(fg * np_ + ig, torch.exp(-m))
    return o * c / n, c, n, m


def check_slstm(gen, label, B, S, H, D, dtype, init, model_layout, reps, **dist) -> dict:
    """The sLSTM kernel against its plain version run in float64 (see
    SLSTM_TOL): every step's h, c, n, m within SLSTM_STEP_TOL of one
    float64 step from the kernel's own entering state, and h_seq and the
    final state within a tenth of the exact tensor's rms, the float32 plain
    version's distances printed beside; CUDA-event times, the bound and the
    launch plan."""
    from repro_torch.kernels.ref import slstm_scan_ref
    from repro_torch.kernels.slstm import slstm_forward, slstm_plan

    args = slstm_inputs(gen, B, S, H, D, dtype, init, model_layout, **dist)
    hs, fin, seqs = slstm_forward(*args, save_states=True)
    step_errs = {}
    for name, got, want in zip(("h", "c", "n", "m"), (hs, *seqs),
                               slstm_steps_f64(*args, hs, *seqs)):
        excess = (got.double() - want).abs() - SLSTM_STEP_TOL * want.abs()
        step_errs[name] = float((got.double() - want).abs().max())
        assert float(excess.max()) <= SLSTM_STEP_TOL, (label, name, step_errs[name])
    del seqs
    phs, pfin = slstm_scan_ref(*args)
    ehs, efin = slstm_scan_ref(*args, compute_dtype=torch.float64)
    torch.cuda.synchronize()
    errs, plain_errs, rms = {}, {}, {}
    for name, got, plain, want in zip(("h_seq", "c", "n", "h", "m"), (hs, *fin), (phs, *pfin),
                                      (ehs, *efin)):
        errs[name] = float((got.double() - want).abs().max())
        plain_errs[name] = float((plain.double() - want).abs().max())
        rms[name] = float(want.pow(2).mean().sqrt())
        assert errs[name] <= rms[name] / 10, (label, name, errs[name], plain_errs[name], rms[name])
    assert rms["h_seq"] >= 10 * SLSTM_TOL, (label, rms)
    del hs, fin, phs, pfin, ehs, efin
    ms = time_ms(lambda: slstm_forward(*args), reps)
    # the decode kernel's time on the card alone (a CUDA graph of the calls)
    card_ms = graph_ms(lambda: slstm_forward(*args), 20, 10) if S == 1 else None
    plain_ms = time_ms(lambda: slstm_scan_ref(*args), max(1, reps // 5), 1)
    bound_ms, bound_by, flops = slstm_bound_ms(B, S, H, D, dtype)
    plan = slstm_plan(B, H, D, dtype)
    dname = "bfloat16" if dtype == torch.bfloat16 else "float32"
    row = {"label": label, "B": B, "S": S, "H": H, "D": D, "dtype": dname, "init": init,
           "layout": "model" if model_layout else "contiguous", "plan": plan,
           "max_abs_err": max(errs.values()), "errs": errs, "plain_f32_errs": plain_errs,
           "ref_rms": rms, "step_errs": step_errs, "step_tol": SLSTM_STEP_TOL, "ms": ms,
           "card_ms": card_ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
           "bound_by": bound_by,
           "flops": flops, "tflops": flops / (ms * 1e9)}
    print(f"  slstm {label:<28} B={B} S={S} H={H} D={D} {dname}{' init' if init else ''}: "
          f"each step from float64 "
          + ", ".join(f"{n} {e:.3e}" for n, e in step_errs.items())
          + f" (tolerance {SLSTM_STEP_TOL:g} + {SLSTM_STEP_TOL:g} |x|); the run from float64, "
          f"max_abs_err "
          + ", ".join(f"{n} {errs[n]:.3e} (float32 plain {plain_errs[n]:.3e}, rms {rms[n]:.3g})"
                      for n in errs)
          + f"; {plan['blocks']} blocks of E={plan['E']} dims, {plan['smem_bytes']} B smem; "
          f"kernel={ms:.4f} ms ({row['tflops']:.2f} TFLOP/s"
          + (f"; card {card_ms:.5f} ms" if card_ms is not None else "")
          + f") plain={plain_ms:.4f} ms "
          f"bound={bound_ms:.4g} ms ({bound_by})")
    return row


def check_slstm_repeat(gen, label, B, S, H, D, dtype) -> dict:
    """Two calls of the kernel on the same inputs (from the empty cache,
    with the per-step states) give equal bits in every output: the partial
    sums go together in a fixed order."""
    from repro_torch.kernels.slstm import slstm_forward

    args = slstm_inputs(gen, B, S, H, D, dtype, False, True)
    runs = []
    for _ in range(2):
        hs, fin, seqs = slstm_forward(*args, save_states=True)
        runs.append((hs, *fin, *seqs))
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(*runs))
    assert equal, f"slstm {label}: two calls on the same inputs differ"
    print(f"  slstm {label:<28} B={B} S={S} H={H} D={D}: two calls, equal bits in h_seq, the "
          f"final state and every step's c, n, m")
    return {"label": label, "B": B, "S": S, "H": H, "D": D, "equal_bits": equal}


def check_slstm_grad(gen, label, B, S, H, D, dtype) -> dict:
    """``SLSTMFunction``'s gradients (the kernel forward, the written-out
    backward) against autograd through the float32 plain version, each
    within GRAD_TOL x its largest |reference|, from a non-empty state with
    gradients on the final state; the backward's time."""
    from repro_torch.kernels.ref import slstm_scan_ref
    from repro_torch.kernels.slstm import SLSTMFunction, slstm_backward, slstm_forward

    args = slstm_inputs(gen, B, S, H, D, dtype, True, dtype == torch.bfloat16)
    gh = torch.randn(B, S, H * D, generator=gen, device="cuda")
    gfin = [torch.randn(B, H, D, generator=gen, device="cuda") for _ in range(4)]
    grads = []
    for fn in (SLSTMFunction.apply, lambda *a: (lambda h, f: (h, *f))(*slstm_scan_ref(*a))):
        ins = [a.detach().clone().requires_grad_() for a in args]
        hs, *fin = fn(*ins)
        loss = (hs * gh).sum() + sum((f * g).sum() for f, g in zip(fin, gfin))
        grads.append(torch.autograd.grad(loss, ins))
        del ins, hs, fin, loss
    torch.cuda.synchronize()
    tol = GRAD_TOL[dtype]
    row = {"label": label, "B": B, "S": S, "H": H, "D": D,
           "dtype": "bfloat16" if dtype == torch.bfloat16 else "float32", "tol": tol}
    names = ["du", "dR", "dc0", "dn0", "dh0", "dm0"]
    for name, got, want in zip(names, *grads):
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        assert err <= tol * scale, (label, name, err, scale)
        row[name] = {"max_abs_err": err, "max_abs_ref": scale}
    del grads
    hs, fin, seqs = slstm_forward(*args, save_states=True)
    row["backward_ms"] = time_ms(lambda: slstm_backward(*args, hs, *seqs, gh, gfin), 1, 1)
    print(f"  slstm grad {label:<18} B={B} S={S} H={H} D={D} {row['dtype']}: "
          + ", ".join(f"{n} {row[n]['max_abs_err']:.3e} (max |ref| {row[n]['max_abs_ref']:.3e})"
                      for n in names)
          + f"; tolerance {tol:g} x max |ref|; backward {row['backward_ms']:.2f} ms")
    return row


def phase_slstm(build_log: str) -> tuple[list[dict], list[dict], dict, dict]:
    """Phase 21: the sLSTM kernel against its plain version, and the
    Function's gradients against autograd through the plain version."""
    print(f"phase 21: slstm kernel vs plain PyTorch version; {nvidia_smi('name,power.limit')}")
    gen = torch.Generator(device="cuda").manual_seed(21)
    ptxas = slstm_ptxas(build_log)
    for key, lines in ptxas.items():
        print(f"  ptxas slstm_kernel ({key}): {'; '.join(lines)}")
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    # the reference's own sweep (tests/test_kernels.py) and its distributions
    for B, S, H, D in ((4, 24, 2, 8), (2, 16, 4, 16), (8, 8, 2, 8)):
        rows.append(check_slstm(gen, "reference sweep", B, S, H, D, f32, False, False, 20,
                                u_std=0.5, r_std=0.2))
    rows.append(check_slstm(gen, "initial state", 3, 20, 2, 16, f32, True, False, 20))
    rows.append(check_slstm(gen, "S = 1", 5, 1, 2, 32, bf16, True, True, 20))
    rows.append(check_slstm(gen, "odd S", 2, 1001, 4, 64, bf16, True, True, 5))
    rows.append(check_slstm(gen, "xlstm smoke", 2, 64, 2, 32, f32, False, True, 20))
    rows.append(check_slstm(gen, "xlstm-1.3b prefill / training", 8, 2048, 4, 512, bf16, False,
                            True, 5))
    rows.append(check_slstm(gen, "xlstm-1.3b decode", 8, 1, 4, 512, bf16, True, True, 20))
    for B, S in zamba2_groups():  # phase 22(b)'s prefills, from the empty cache
        rows.append(check_slstm(gen, "xlstm-1.3b serve group", B, S, 4, 512, bf16, False,
                                True, 5))
    # decode (the kernel of its own at S = 1) at phase 22(c)'s slots and the
    # entry point's groups of 4
    rows.append(check_slstm(gen, "xlstm-1.3b decode B=4", 4, 1, 4, 512, bf16, True, True, 20))
    rows.append(check_slstm(gen, "xlstm-1.3b decode, empty", 8, 1, 4, 512, bf16, False, True,
                            20))
    repeat = check_slstm_repeat(gen, "xlstm-1.3b prefill / training", 8, 2048, 4, 512, bf16)
    grads = [check_slstm_grad(gen, "smoke", 2, 64, 2, 32, f32),
             check_slstm_grad(gen, "xlstm heads", 2, 256, 4, 512, bf16)]
    return rows, grads, ptxas, repeat


def phase_serve_xlstm(slstm_rows) -> dict:
    """Phase 22: xlstm-1.3b at full size, served on the card."""
    from repro_torch import configs
    from repro_torch.kernels import slstm
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import Transformer, count_params, init_model_params

    cfg = configs.get_config("xlstm-1.3b")
    per_prefill = launches_per_call(cfg)
    n_mlstm = sum(b.kind == "mlstm" for _, b in model_blocks(cfg))
    print(f"phase 22: xlstm-1.3b ({n_mlstm} mLSTM + {per_prefill['slstm']} sLSTM blocks, "
          f"d_model 2048, 4 heads, {count_params(cfg) / 1e9:.3f} B parameters) served on the "
          f"card; {nvidia_smi('name,power.limit')}")
    slstm.reset_launches()
    entry = launch_serve.main(["--arch", "xlstm-1.3b"])  # 8 requests, 2 groups of 4, 32 new
    torch.cuda.synchronize()
    entry_launches = slstm.launches()
    assert entry_launches == per_prefill["slstm"] * (2 + 2 * 31), entry_launches
    assert [len(o) for o in entry["outputs"]] == [32] * 8
    print(f"  (a) launch.serve.main(['--arch', 'xlstm-1.3b']): {entry['tokens']} tokens in "
          f"{entry['seconds']:.3f} s; slstm launches {entry_launches} == "
          f"{per_prefill['slstm']} x (2 prefills + 62 decode steps)")
    t0 = time.perf_counter()
    model = init_model_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = zamba2_prompts(cfg.vocab)
    result = serve_engine("(b) Engine", cfg, model, prompts, slots=ZAMBA2_SLOTS, capacity=4096,
                          max_new=64)
    checked = {(r["B"], r["S"]) for r in slstm_rows if r["label"] == "xlstm-1.3b serve group"}
    assert set(result["prefill_shapes"]) <= checked, (result["prefill_shapes"], checked)
    result["init_s"] = init_s
    result["entry"] = {"tokens": entry["tokens"], "seconds": entry["seconds"],
                       "slstm_launches": entry_launches}
    result["decode_trace"] = decode_idle_share(cfg, model, prompts[:8], 4096, steps=16)
    # (c) as phase 18(c): float32 compute with a float32 cache first (the
    # weights the served model's, rounded to bfloat16 by the Engine but for
    # the sLSTM's float32 r_zifo), then bfloat16 beside the float32 logits
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model32 = Transformer(cfg32, device="cuda")
    model32.load_state_dict(model.state_dict())
    result["agreement"] = engines_agree("(c) first group", cfg32, model32, prompts[:8], 4096, 64,
                                        tol=XLSTM_F32_LOGITS_TOL, cache_dtype=torch.float32)
    reference = prefill_last_logits(cfg32, model32, left_padded(prompts[:8]), 4096, "torch",
                                    torch.float32)[0].float()
    del model32
    torch.cuda.empty_cache()
    result["agreement_bf16"] = engines_agree("(c) first group", cfg, model, prompts[:8], 4096, 16,
                                             tol=XLSTM_BF16_LOGITS_TOL, reference=reference)
    del model, reference
    torch.cuda.empty_cache()
    return result


def descent_on_one_batch(cfg, B: int, S: int, steps: int) -> dict:
    """From the initial weights, ``steps`` train steps (AdamW at the
    launcher's lr, built as ``launch.train`` builds them) on one batch of
    B x S tokens; asserts that the batch's loss at the trained weights is
    below its loss at the initial ones."""
    from repro_torch.models import init_model_params, loss_fn
    from repro_torch.train import SyntheticLM, TrainConfig, make_train_step
    from repro_torch.train.train_loop import make_optimizer_for

    model = init_model_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = SyntheticLM(cfg, B, S, device="cuda").batch_at(0)
    opt = make_optimizer_for(cfg, TrainConfig(lr=3e-4, warmup_steps=1, total_steps=steps))
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(cfg, opt)
    losses = [float(step(model, state, i, batch)[2]["loss"]) for i in range(steps)]
    with torch.no_grad():
        losses.append(float(loss_fn(model, batch)[0]))
    del model, state, batch
    torch.cuda.empty_cache()
    assert all(math.isfinite(l) for l in losses) and losses[-1] < losses[0], losses
    print(f"  one batch of {B} x {S} tokens, {steps} AdamW steps on it at lr 3e-4: loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f} ({losses[-1] - losses[0]:+.6f}); each step: "
          + " ".join(f"{l:.4f}" for l in losses))
    return {"B": B, "S": S, "steps": steps, "losses": losses}


def phase_train_xlstm(slstm_rows) -> dict:
    """Phase 23: train xlstm-1.3b at full size through the launcher."""
    from repro_torch import configs
    from repro_torch.kernels.slstm import slstm_backward, slstm_forward
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_model_params, loss_fn
    from repro_torch.train import SyntheticLM

    B, S, steps = 8, 2048, 3
    cfg = configs.get_config("xlstm-1.3b")
    print(f"phase 23: train xlstm-1.3b at full size: launch.train.main, {steps} steps, batch "
          f"{B}, seq {S}, bf16 compute, adamw, remat; {nvidia_smi('name,power.limit')}")
    argv = ["--arch", "xlstm-1.3b", "--steps", str(steps), "--batch", str(B), "--seq", str(S)]
    result, train = run_training("launch.train.main", cfg, lambda: launch_train.main(argv),
                                 B * S, falling=False)
    # each step's loss is on a new batch: the first batch's loss at the
    # trained weights beside its loss at the initial ones (step 0's loss), a
    # record only (see XLSTM_DESCENT_SEQ); the descent is checked below
    batch = SyntheticLM(cfg, B, S, device="cuda").batch_at(0)
    with torch.no_grad():
        trained = float(loss_fn(result["model"], batch)[0])
    initial = train["losses"][0]
    assert math.isfinite(trained), (initial, trained)
    train["batch0_loss"] = {"initial": initial, "trained": trained}
    print(f"  the first batch's loss: {initial:.6f} at the initial weights, {trained:.6f} after "
          f"{steps} steps ({trained - initial:+.6f})")
    del result
    torch.cuda.empty_cache()
    model = init_model_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    short_batch = SyntheticLM(cfg, B, XLSTM_DESCENT_SEQ, device="cuda").batch_at(0)
    train["engines"] = xlstm_engines_loss(cfg, model, batch, short_batch)
    del short_batch
    train["trace"] = trace_train_step(cfg, model, batch, "train_trace_xlstm")
    del model, batch
    torch.cuda.empty_cache()
    train["descent"] = descent_on_one_batch(cfg, B, XLSTM_DESCENT_SEQ, XLSTM_DESCENT_STEPS)
    # the kernels' share: the sLSTM forward at the step's shape x its
    # launches, its written-out backward once per sLSTM block (CUDA events)
    slstm_ms = next(r["ms"] for r in slstm_rows if r["label"] == "xlstm-1.3b prefill / training")
    gen = torch.Generator(device="cuda").manual_seed(23)
    H, D = cfg.n_heads, cfg.d_model // cfg.n_heads
    args = slstm_inputs(gen, B, S, H, D, torch.bfloat16, False, True)
    hs, _, seqs = slstm_forward(*args, save_states=True)
    dh = torch.randn(hs.shape, generator=gen, device="cuda")
    bw_ms = time_ms(lambda: slstm_backward(*args, hs, *seqs, dh, None), 1, 1)
    del args, hs, seqs, dh
    torch.cuda.empty_cache()
    wall = sum(train["step_s"])
    slstm_s = train["launches"]["slstm"] * slstm_ms / 1e3
    bw_s = launches_per_call(cfg)["slstm"] * train["steps"] * bw_ms / 1e3
    train["share"] = {"wall_s": wall, "slstm_s": slstm_s, "slstm_share": slstm_s / wall,
                      "slstm_backward_ms": bw_ms, "slstm_backward_s": bw_s,
                      "slstm_backward_share": bw_s / wall}
    print(f"  xlstm kernel share of {wall:.3f} s of steps: slstm {slstm_s:.3f} s "
          f"({100 * slstm_s / wall:.2f}%: {slstm_ms:.3f} ms x {train['launches']['slstm']} "
          f"launches); the written-out slstm backward {bw_ms:.2f} ms a block (CUDA events), "
          f"{bw_s:.3f} s ({100 * bw_s / wall:.2f}%)")
    return train


# -- MLA / MoE slice -------------------------------------------------------------------

#: depth cuts of the two MoE configs at full width: deepseek-v2-lite's 26
#: MLA/MoE layers hold 15.7e9 parameters, 62.8 GB of float32 masters, and
#: ``init_model_params`` draws a stacked leaf whole (``moe.w1`` alone 19.2 GB
#: at full depth), so serving keeps the dense head layer and 7 MLA/MoE
#: layers (4.59e9 parameters) and training 3 (2.25e9: masters, AdamW
#: moments and gradients about 36 GB); qwen3-moe serves 2 of its 94 layers
#: (6.22e9 parameters, 24.9 GB) and trains 1 (3.73e9) with its Adafactor
DEEPSEEK_SERVE_SUPERBLOCKS, DEEPSEEK_TRAIN_SUPERBLOCKS = 7, 3
QWEN3_SERVE_SUPERBLOCKS, QWEN3_TRAIN_SUPERBLOCKS = 2, 1
#: phase 25(c): the einsum and sort dispatches at capacity 8 (no drop) in
#: float32 compute on the first group's prompts cut to this many tokens
#: (at 8 x 512 tokens a group's C is 3072 and the one-hot dispatch and
#: combine tensors 3.2 GB each in float32), logits within MOE_DISPATCH_TOL
MOE_COMPARE_SEQ, MOE_DISPATCH_TOL = 512, 1e-4
#: phases 26 and 27: the ``cuda`` engine's loss against the ``torch``
#: engine's on one batch (deepseek 8 x 2048 tokens, qwen3-moe one 1 x 2048
#: microbatch).  MLA and MoE have no kernel, so the two engines differ only
#: in the cross-entropy and, at qwen3-moe, the flash attention (bf16
#: tensor-core kernels against their plain versions, float32 sums in
#: another order); held to xlstm's bound
MOE_TRAIN_LOSS_TOL = 3e-3


def cut_depth(full, n_superblocks: int):
    """``full`` at its own widths with ``n_superblocks`` stacked superblocks."""
    return dataclasses.replace(
        full, n_superblocks=n_superblocks,
        n_layers=len(full.head_blocks) + n_superblocks * len(full.superblock)
        + len(full.tail_blocks))


def trace_prefill(cfg, model, prompts, capacity: int, name: str) -> dict:
    """One group's prefill (after a warm one) under ``torch.profiler`` with
    the MoE / MLA spans on: the card's busy time, idle share and device
    time by kind (:func:`device_time`); the trace is written to
    ``build/<name>.json``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tokens = left_padded(prompts)
    prefill_last_logits(cfg, model, tokens, capacity, "cuda")
    torch.cuda.synchronize()
    with moe_mla_spans(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        with record_function("prefill"):
            prefill_last_logits(cfg, model, tokens, capacity, "cuda")
            torch.cuda.synchronize()
    path = os.path.join(ROOT, "build", f"{name}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    span = next(e for e in events if e.get("cat") == "user_annotation" and e["name"] == "prefill")
    out = {"B": tokens.shape[0], "S": tokens.shape[1],
           **device_time(events, span["ts"], span["ts"] + span["dur"])}
    if out["device_ops"]:
        print(f"  trace of one prefill group B={out['B']} S={out['S']} (torch.profiler, "
              f"build/{name}.json): {out['traced_ms']:.1f} ms traced, the card busy "
              f"{out['busy_ms']:.1f} ms in {out['device_ops']} kernels / copies: idle share "
              f"{out['idle_share']:.4f}; by kind: "
              + ", ".join(f"{k} {v:.1f} ms" for k, v in out["kernel_ms_by_kind"].items()))
    else:
        print("  trace of one prefill: the trace holds no device activity; idle share not "
              "measured")
    return out


def dispatch_modes_agree(cfg, model, prompts) -> dict:
    """Phase 25(c): one group's logits in float32 compute (the served
    model's weights, as the ``Engine`` rounded them) at ``moe_capacity`` 8,
    where no assignment drops, through the einsum and the sort dispatch,
    within MOE_DISPATCH_TOL; each dispatch twice, the two calls' logits equal
    bit for bit."""
    from repro_torch.models import Transformer, forward, logits_from_hidden

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32", moe_capacity=8.0)
    model32 = Transformer(cfg32, device="cuda")
    model32.load_state_dict(model.state_dict())
    tokens = left_padded([p[:MOE_COMPARE_SEQ] for p in prompts])
    logits, seconds = {}, {}
    with torch.no_grad():
        for mode in ("einsum", "sort"):
            model32.cfg = dataclasses.replace(cfg32, moe_dispatch=mode)
            runs = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x, _, _ = forward(model32, {"tokens": tokens}, mode="train")
                runs.append(logits_from_hidden(model32, x))
                torch.cuda.synchronize()
                seconds.setdefault(mode, []).append(time.perf_counter() - t0)
                del x
            assert torch.equal(runs[0], runs[1]), mode
            logits[mode] = runs[0]
            del runs
    err = float((logits["einsum"] - logits["sort"]).abs().max())
    rms = float(logits["sort"].pow(2).mean().sqrt())
    assert torch.isfinite(logits["sort"]).all() and err <= MOE_DISPATCH_TOL, (err, rms)
    del model32, logits
    torch.cuda.empty_cache()
    B, S = tokens.shape
    print(f"  (c) float32 compute, moe_capacity 8: einsum vs sort dispatch on {B} x {S} tokens, "
          f"every position's logits max |d| {err:.3e} (<= {MOE_DISPATCH_TOL}; rms {rms:.4f}); "
          f"each dispatch's two calls equal bit for bit; s a forward: "
          + ", ".join(f"{m} {min(t):.3f}" for m, t in seconds.items()))
    return {"B": B, "S": S, "max_abs_err": err, "logits_rms": rms, "tol": MOE_DISPATCH_TOL,
            "repeatable": True, "forward_s": seconds}


def phase_serve_deepseek() -> dict:
    """Phase 25: deepseek-v2-lite-16b at full width (cut in depth), served."""
    from repro_torch import configs
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import count_params, init_model_params

    full = configs.get_config("deepseek-v2-lite-16b")
    cfg = cut_depth(full, DEEPSEEK_SERVE_SUPERBLOCKS)
    print(f"phase 25: deepseek-v2-lite-16b at full width (d_model 2048, 16 heads, kv_lora 512, "
          f"rope 64, {cfg.moe_experts} routed experts top-{cfg.moe_top_k} of {cfg.moe_d_ff} + "
          f"shared {cfg.moe_shared_d_ff}, vocab {cfg.vocab}, moe_dispatch {cfg.moe_dispatch!r}), "
          f"depth cut from {full.n_layers} to {cfg.n_layers} layers "
          f"({count_params(cfg) / 1e9:.3f} B parameters), served on the card; "
          f"{nvidia_smi('name,power.limit')}")
    entry = launch_serve.main(["--arch", "deepseek-v2-lite-16b", "--smoke"])
    torch.cuda.synchronize()
    assert [len(o) for o in entry["outputs"]] == [32] * 8 and entry["device"] == "cuda", entry
    print(f"  (a) launch.serve.main(['--arch', 'deepseek-v2-lite-16b', '--smoke']): "
          f"{entry['tokens']} tokens in {entry['seconds']:.3f} s")
    t0 = time.perf_counter()
    model = init_model_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = zamba2_prompts(cfg.vocab)
    result = serve_engine("(b) Engine", cfg, model, prompts, slots=ZAMBA2_SLOTS, capacity=4096,
                          max_new=64)
    result["init_s"] = init_s
    result["params"] = count_params(cfg)
    result["entry"] = {"tokens": entry["tokens"], "seconds": entry["seconds"]}
    result["depth_cut"] = {"n_layers": [full.n_layers, cfg.n_layers],
                           "n_superblocks": [full.n_superblocks, cfg.n_superblocks]}
    result["decode_trace"] = decode_idle_share(cfg, model, prompts[:8], 4096, steps=16)
    result["prefill_trace"] = trace_prefill(cfg, model, prompts[:8], 4096,
                                            "prefill_trace_deepseek")
    result["dispatch_modes"] = dispatch_modes_agree(cfg, model, prompts[:8])
    del model
    torch.cuda.empty_cache()
    return result


def phase_train_deepseek() -> dict:
    """Phase 26: train deepseek-v2-lite-16b at full width (cut in depth)."""
    from repro_torch import configs
    from repro_torch.models import count_params, init_model_params
    from repro_torch.train import SyntheticLM, TrainConfig, Trainer

    B, S, steps = 8, 2048, 3
    full = configs.get_config("deepseek-v2-lite-16b")
    cfg = cut_depth(full, DEEPSEEK_TRAIN_SUPERBLOCKS)
    print(f"phase 26: train deepseek-v2-lite-16b at full width, depth cut from {full.n_layers} to "
          f"{cfg.n_layers} layers ({count_params(cfg) / 1e9:.3f} B parameters): Trainer, {steps} "
          f"steps, batch {B}, seq {S}, bf16 compute, adamw, remat; "
          f"{nvidia_smi('name,power.limit')}")
    tcfg = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=steps, eval_every=1,
                       checkpoint_every=10**9)
    result, train = run_training(
        "Trainer", cfg, lambda: Trainer(cfg, tcfg, SyntheticLM(cfg, B, S)).run(), B * S,
        falling=False)
    del result
    torch.cuda.empty_cache()
    model = init_model_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = SyntheticLM(cfg, B, S, device="cuda").batch_at(0)
    train["engines"] = engines_loss(cfg, model, batch, tol=MOE_TRAIN_LOSS_TOL)
    train["trace"] = trace_train_step(cfg, model, batch, "train_trace_deepseek")
    del model, batch
    torch.cuda.empty_cache()
    train["descent"] = descent_on_one_batch(cfg, B, XLSTM_DESCENT_SEQ, XLSTM_DESCENT_STEPS)
    train["params"] = count_params(cfg)
    train["depth_cut"] = {"n_layers": [full.n_layers, cfg.n_layers],
                          "n_superblocks": [full.n_superblocks, cfg.n_superblocks]}
    return train


def phase_qwen3_moe(build_log: str) -> dict:
    """Phase 27: qwen3-moe-235b-a22b at full width (cut in depth): its GQA
    16x prefill shapes held on the flash kernel, then served, then
    trained with its Adafactor and microbatches."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import count_params, init_model_params
    from repro_torch.train import SyntheticLM, TrainConfig, Trainer

    full = configs.get_config("qwen3-moe-235b-a22b")
    cfg = cut_depth(full, QWEN3_SERVE_SUPERBLOCKS)
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    print(f"phase 27: qwen3-moe-235b-a22b at full width (d_model {cfg.d_model}, {H} heads / {KV} "
          f"kv of {D}, {cfg.moe_experts} experts top-{cfg.moe_top_k} of {cfg.moe_d_ff}, vocab "
          f"{cfg.vocab}); {nvidia_smi('name,power.limit')}")
    gen = torch.Generator(device="cuda").manual_seed(27)
    ptxas = flash_ptxas(build_log)
    flash_rows = []
    for B, S in zamba2_groups():
        flash_rows.append(check_flash(gen, "qwen3-moe prefill", B, H, KV, S, 4096, D,
                                      torch.bfloat16, {"kv_len": S}, True, 5, ptxas,
                                      qk_scale=3.0))
    # the training shapes of (c): one microbatch of 1 x 2048 tokens, the
    # flash forward and its written-out backward over q_chunk rows, and the
    # loss head (bf16 x, the untied head's float32 master)
    B, S, steps = 8, 2048, 3
    micro = full.train_microbatch
    T = B // micro * S
    train_checks = {
        "flash": check_flash(gen, "qwen3-moe training", B // micro, H, KV, S, S, D,
                             torch.bfloat16, {}, True, 5, ptxas, qk_scale=3.0),
        "flash_grad": check_flash_grad(gen, "qwen3-moe training", B // micro, H, KV, S, D,
                                       torch.bfloat16, {}, full.q_chunk),
        "ce": check_ce(gen, "qwen3-moe training", T, cfg.d_model, cfg.vocab, torch.bfloat16,
                       torch.float32, 0.0, False, 5),
        "ce_grad": check_ce_grad(gen, f"qwen3-moe, T={T}", T, cfg.d_model, cfg.vocab,
                                 torch.bfloat16, 0.0, tied=False)}
    fa.reset_launches()
    entry = launch_serve.main(["--arch", "qwen3-moe-235b-a22b", "--smoke"])
    torch.cuda.synchronize()
    entry_launches = fa.launches()
    smoke = configs.get_smoke_config("qwen3-moe-235b-a22b")
    assert entry_launches == smoke.n_superblocks * 2, entry_launches  # 8 requests, 2 groups
    assert [len(o) for o in entry["outputs"]] == [32] * 8
    print(f"  (a) launch.serve.main(['--arch', 'qwen3-moe-235b-a22b', '--smoke']): "
          f"{entry['tokens']} tokens in {entry['seconds']:.3f} s; flash_attention launches "
          f"{entry_launches} == {smoke.n_superblocks} layers x 2 prefills")
    print(f"  (b) served at depth {cfg.n_layers} of {full.n_layers} layers "
          f"({count_params(cfg) / 1e9:.3f} B parameters)")
    t0 = time.perf_counter()
    model = init_model_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = zamba2_prompts(cfg.vocab)
    serve = serve_engine("(b) Engine", cfg, model, prompts, slots=ZAMBA2_SLOTS, capacity=4096,
                         max_new=64)
    assert serve["flash_launches"] == cfg.n_layers * serve["groups"], serve["flash_launches"]
    serve["init_s"] = init_s
    serve["params"] = count_params(cfg)
    serve["entry"] = {"tokens": entry["tokens"], "seconds": entry["seconds"],
                      "flash_launches": entry_launches}
    serve["prefill_trace"] = trace_prefill(cfg, model, prompts[:8], 4096, "prefill_trace_qwen3")
    del model
    torch.cuda.empty_cache()

    tcfg_cut = cut_depth(full, QWEN3_TRAIN_SUPERBLOCKS)
    print(f"  (c) train at depth {tcfg_cut.n_layers} ({count_params(tcfg_cut) / 1e9:.3f} B "
          f"parameters): Trainer, {steps} steps, batch {B}, seq {S}, bf16, "
          f"{tcfg_cut.optimizer}, microbatch {micro}, remat")
    tcfg = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=steps, eval_every=1,
                       checkpoint_every=10**9, microbatch=micro)
    result, train = run_training(
        "Trainer", tcfg_cut, lambda: Trainer(tcfg_cut, tcfg, SyntheticLM(tcfg_cut, B, S)).run(),
        B * S, falling=False, microbatch=micro)
    del result
    torch.cuda.empty_cache()
    model = init_model_params(tcfg_cut, torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = SyntheticLM(tcfg_cut, B // micro, S, device="cuda").batch_at(0)
    train["engines"] = engines_loss(tcfg_cut, model, batch, tol=MOE_TRAIN_LOSS_TOL)
    del model, batch
    torch.cuda.empty_cache()
    train["params"] = count_params(tcfg_cut)
    return {"flash_rows": flash_rows, "train_checks": train_checks, "serve": serve, "train": train,
            "depth_cut": {"serve": cfg.n_layers, "train": tcfg_cut.n_layers,
                          "full": full.n_layers}}


# -- storage and distributed slice ---------------------------------------------------

#: phase 29: the trials of each backend's study, of each spawned worker over
#: the served sqlite file, and of each worker over the journal file
STORAGE_TRIALS = 256
SERVED_WORKERS, SERVED_WORKER_TRIALS = 4, 256
JOURNAL_WORKERS, JOURNAL_WORKER_TRIALS = 2, 64


def study_fingerprint(trials) -> str:
    """SHA-256 over every trial's number, state, parameters (float64 bits;
    a categorical's repr), objective values and intermediate values (step
    and float64 bits).  ``trials_hash`` stays as it is: phase 7's hash is
    compared with other commits' (``scripts/kernel_baseline.py``)."""
    h = hashlib.sha256()
    for t in trials:
        h.update(f"{t.number}:{t.state.name}".encode())
        for name, value in sorted(t.params.items()):
            h.update(name.encode())
            h.update(repr(value).encode() if isinstance(value, str) else
                     np.float64(value).tobytes())
        h.update(np.asarray(t.values or [], dtype=np.float64).tobytes())
        for step, value in sorted(t.intermediate_values.items()):
            h.update(np.int64(step).tobytes() + np.float64(value).tobytes())
    return h.hexdigest()


def cuda_tpe():
    """A spawned worker's sampler: TPE with the Parzen kernel on the card
    (``engine="auto"`` may keep small fits on the host)."""
    import repro_torch.core as hpo

    return hpo.TPESampler(engine="cuda")


def worker_objective(trial) -> float:
    """Phase 3's objective in a spawned worker, recording as user attrs the
    worker's pid, its cumulative Parzen launches and its card."""
    from repro_torch.kernels import parzen

    try:
        return objective(trial)
    finally:
        trial.set_user_attr("pid", os.getpid())
        trial.set_user_attr("parzen_launches", parzen.launches())
        trial.set_user_attr("device", torch.cuda.get_device_name())


def storage_backends(stack, tmp: str) -> list:
    """Phase 29(a)'s backends, each a fresh storage; the servers run in
    this process over in-memory storage."""
    from repro_torch.core.storage import InMemoryStorage, StorageServer, get_storage

    v1 = stack.enter_context(StorageServer(InMemoryStorage(), max_protocol=1))
    v2 = stack.enter_context(StorageServer(InMemoryStorage()))
    shards = [stack.enter_context(StorageServer(InMemoryStorage())) for _ in range(2)]
    remote_v1 = get_storage(v1.url)
    cached_v2 = get_storage(v2.url, cache=True)
    assert remote_v1.protocol == 1 and cached_v2.supports_block_fetch
    return [
        ("memory", get_storage(None)),
        ("sqlite", get_storage(f"sqlite:///{tmp}/study.db")),
        ("journal", get_storage(f"journal://{tmp}/study.journal")),
        ("remote v1", remote_v1),
        ("remote v2 + cache", cached_v2),
        ("remote x2 shards", get_storage("remote://" + ",".join(
            s.url.split("://")[1] for s in shards))),
    ]


def check_workers(label: str, study, n_workers: int, n_trials: int, card: str,
                  launches_each: bool) -> dict:
    """The trials of a ``run_workers`` study: all finished (COMPLETE or
    PRUNED), numbered densely, from ``n_workers`` pids on ``card``, with
    each worker's Parzen launches (the largest count its trials recorded)."""
    trials = study.trials
    states = {}
    for t in trials:
        states[t.state.name] = states.get(t.state.name, 0) + 1
    assert set(states) <= {"COMPLETE", "PRUNED"}, (label, states)
    assert sorted(t.number for t in trials) == list(range(n_trials)), (label, len(trials))
    launches: dict[int, int] = {}
    for t in trials:
        pid = t.user_attrs["pid"]
        launches[pid] = max(launches.get(pid, 0), t.user_attrs["parzen_launches"])
        assert t.user_attrs["device"] == card, (label, t.user_attrs["device"], card)
    assert len(launches) == n_workers and os.getpid() not in launches, (label, launches)
    if launches_each:
        assert all(n > 0 for n in launches.values()), (label, launches)
    assert sum(launches.values()) > 0, (label, launches)
    first = min(t.datetime_start for t in trials)
    last = max(t.datetime_complete for t in trials)
    return {"states": states, "launches_by_pid": launches,
            "launches": sum(launches.values()),
            "sampling_seconds": (last - first).total_seconds()}


def phase_storage() -> dict:
    """Phase 29: the storage stack and distributed workers on the card."""
    import multiprocessing
    import shutil
    import tempfile

    import repro_torch.core as hpo
    from repro_torch.kernels import parzen

    card = torch.cuda.get_device_name(0)
    print(f"phase 29: the storage stack and distributed workers, TPESampler(engine='cuda'), "
          f"MedianPruner, phase 3's objective; {nvidia_smi('name,power.limit')}")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase29-", dir=os.path.join(ROOT, "build"))
    out: dict = {"card": card}
    try:
        # (a) one seeded study on every backend: the same trials, the same launches
        runs = []
        with contextlib.ExitStack() as stack:
            for label, storage in storage_backends(stack, tmp):
                study = hpo.create_study(storage=storage, study_name="storage",
                                         sampler=hpo.TPESampler(seed=0, engine="cuda"),
                                         pruner=hpo.MedianPruner())
                parzen.reset_launches()
                t0 = time.perf_counter()
                study.optimize(objective, n_trials=STORAGE_TRIALS)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = parzen.launches()
                trials = study.get_trials()
                states = [t.state.name for t in trials]
                run = {"backend": label, "seconds": seconds,
                       "trials_per_s": len(trials) / seconds, "launches": launches,
                       "pruned": states.count("PRUNED"), "complete": states.count("COMPLETE"),
                       "sha256": study_fingerprint(trials)}
                runs.append(run)
                print(f"  (a) {label:<18} {len(trials)} trials in {seconds:.3f} s = "
                      f"{run['trials_per_s']:.2f} trials/s; {run['complete']} complete, "
                      f"{run['pruned']} pruned; parzen launches {launches}; "
                      f"sha256 {run['sha256'][:16]}")
                assert len(trials) == STORAGE_TRIALS and "RUNNING" not in states, (label, states)
                storage.close()
        assert len({r["sha256"] for r in runs}) == 1, [(r["backend"], r["sha256"]) for r in runs]
        assert len({r["launches"] for r in runs}) == 1 and runs[0]["launches"] > 0, runs
        out["backends"] = runs

        # (b) four spawned workers over a served sqlite file (protocol v2, cached)
        url = f"sqlite:///{tmp}/workers.db"
        hpo.create_study(study_name="workers", storage=url, engine="numpy")
        wall = hpo.run_workers(SERVED_WORKERS, url, "workers", worker_objective,
                               SERVED_WORKER_TRIALS, sampler_factory=cuda_tpe,
                               pruner_factory=hpo.MedianPruner, serve_storage=True,
                               start_method="spawn")
        n = SERVED_WORKERS * SERVED_WORKER_TRIALS
        served = check_workers("served", hpo.load_study("workers", url, engine="numpy"),
                               SERVED_WORKERS, n, card, launches_each=True)
        served.update(wall_seconds=wall, trials_per_s=n / wall,
                      sampling_trials_per_s=n / served["sampling_seconds"])
        out["served"] = served
        print(f"  (b) {SERVED_WORKERS} spawned workers x {SERVED_WORKER_TRIALS} trials over "
              f"the served sqlite file (v2 + cache): {n} trials in {wall:.3f} s wall = "
              f"{served['trials_per_s']:.2f} trials/s ({served['sampling_trials_per_s']:.2f} "
              f"trials/s from the first trial's start to the last's end, "
              f"{served['sampling_seconds']:.3f} s); states {served['states']}; parzen "
              f"launches by worker {list(served['launches_by_pid'].values())} = "
              f"{served['launches']}")

        # (c) two spawned workers on a journal file, no server: the file lock
        url = f"journal://{tmp}/workers.journal"
        hpo.create_study(study_name="journal", storage=url, engine="numpy")
        wall = hpo.run_workers(JOURNAL_WORKERS, url, "journal", worker_objective,
                               JOURNAL_WORKER_TRIALS, sampler_factory=cuda_tpe,
                               pruner_factory=hpo.MedianPruner, start_method="spawn")
        n = JOURNAL_WORKERS * JOURNAL_WORKER_TRIALS
        journal = check_workers("journal", hpo.load_study("journal", url, engine="numpy"),
                                JOURNAL_WORKERS, n, card, launches_each=False)
        journal.update(wall_seconds=wall, trials_per_s=n / wall)
        out["journal"] = journal
        print(f"  (c) {JOURNAL_WORKERS} spawned workers x {JOURNAL_WORKER_TRIALS} trials on "
              f"the journal file: {n} trials in {wall:.3f} s wall; states "
              f"{journal['states']}; parzen launches by worker "
              f"{list(journal['launches_by_pid'].values())}")

        # (d) this process has used the card: forking workers is refused
        assert torch.cuda.is_initialized()
        url = f"sqlite:///{tmp}/fork.db"
        hpo.create_study(study_name="fork", storage=url, engine="numpy")
        try:
            hpo.run_workers(2, url, "fork", worker_objective, 1, sampler_factory=cuda_tpe,
                            start_method="fork")
        except ValueError as e:
            refusal = str(e)
        else:
            raise AssertionError("run_workers forked a process that has used the card")
        assert "spawn" in refusal and not multiprocessing.active_children()
        assert hpo.load_study("fork", url, engine="numpy").trials == []
        out["fork_refusal"] = refusal
        print(f"  (d) fork refused: {refusal}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# -- trial-slice scheduler and live dashboard slice -----------------------------------

#: phase 30: phase 28's study, its trials run by the scheduler on slices that
#: all name the one card, while the dashboard service polls its file.  Cut in
#: depth from phase 28's 60 train steps a trial to 20 (the pruner's rungs at
#: 10 and 20 steps stay): 4 slice threads of one process train slower on one
#: card than one thread does.  On an NVIDIA H100 80GB HBM3 at 700 W the phase
#: took 46.3-46.8 s at 60 steps, and 23.9-65.4 s at 40, against its 45-s
#: budget.
SLICE_TRIALS, SLICES, SLICE_STEPS = 16, 4, 20
#: the live dashboard's delta poll period, seconds, and the idle polls made
#: once the study has stopped
POLL_SECONDS, IDLE_POLLS = 0.25, 5


def max_overlap(events) -> int:
    """The most trials running at once in the scheduler's event log."""
    running, most = set(), 0
    for kind, _slice, number in events:
        if kind == "start":
            running.add(number)
            most = max(most, len(running))
        else:
            running.discard(number)
    return most


def slice_study(storage, spec):
    """Phase 28's sampler and pruner on ``storage``, with the opening wave,
    one trial a slice, taking one family each: with trials told in thread
    order the families drawn are not fixed, and every family must train."""
    import repro_torch.core as hpo

    study = hpo.create_study(
        study_name="slices", storage=storage,
        sampler=hpo.TPESampler(seed=0, engine="cuda", n_startup_trials=4,
                               consider_pruned_trials=True),
        pruner=hpo.SuccessiveHalvingPruner(min_resource=10, reduction_factor=2))
    for family in spec.families:
        study.enqueue_trial({"family": family})
    return study


def phase_tune_slices(sequential: dict) -> dict:
    """Phase 30: concurrent tune trials on one card under the live dashboard;
    ``sequential`` is phase 28's result, the same study run one by one."""
    import shutil
    import tempfile
    import threading
    import traceback
    import urllib.request

    import repro_torch.core as hpo
    from repro_torch.core import telemetry
    from repro_torch.core.frozen import TrialState
    from repro_torch.kernels import crossentropy as ce
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import parzen, slstm, ssd
    from repro_torch.serve.dashboard_service import DashboardService
    from repro_torch.tune import LMTuneSpec, TrialSliceScheduler, make_lm_objective

    spec = dataclasses.replace(LMTuneSpec(), total_steps=SLICE_STEPS)
    smi = nvidia_smi("name,power.limit")
    print(f"phase 30: phase 28's study ({' + '.join(spec.families)}, {SLICE_TRIALS} trials of "
          f"up to {spec.total_steps} steps, "
          f"TPESampler(seed=0, engine='cuda', n_startup_trials=4, consider_pruned_trials=True), "
          f"SuccessiveHalvingPruner(min_resource=10, reduction_factor=2)) on a sqlite file, "
          f"run by TrialSliceScheduler on {SLICES} slices of the one card, the dashboard "
          f"service on the same URL polled every {POLL_SECONDS} s; {smi}")
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase30-", dir=build)
    url = f"sqlite:///{tmp}/tune.db"
    study = slice_study(url, spec)
    failures: list[str] = []

    def run_trial(trial, devices):
        try:
            return make_lm_objective(spec, device=devices[0])(trial)
        except hpo.TrialPruned:
            raise
        except Exception:  # the scheduler tells it FAIL; the phase prints it and fails
            failures.append(f"trial {trial.number}: {traceback.format_exc()}")
            raise

    sched = TrialSliceScheduler(study, [[torch.device("cuda", 0)]] * SLICES, run_trial)
    telemetry.reset()
    telemetry.enable()
    svc = DashboardService(url).start()
    base = f"{svc.url}/api/study/slices"
    cursor = {"rev": -1, "num": -1, "pending": ""}  # as the live page keeps it
    shipped: list[int] = []
    polls: list[tuple[float, bool]] = []  # (seconds, idle)

    def get(path: str):
        with urllib.request.urlopen(path, timeout=60) as r:
            return r.status, r.read()

    def poll() -> dict:
        t0 = time.perf_counter()
        status, body = get(f"{base}/delta?since_rev={cursor['rev']}&since_num={cursor['num']}"
                           + (f"&pending={cursor['pending']}" if cursor["pending"] else ""))
        d = json.loads(body)
        polls.append((time.perf_counter() - t0, d["idle"]))
        assert status == 200, status
        if not d["idle"]:
            shipped.extend(r["number"] for r in d["rows"])
            cursor.update(rev=d["rev"], num=d["last_number"],
                          pending=",".join(map(str, d.get("pending", []))))
        return d

    stop, errors = threading.Event(), []

    def poller() -> None:
        try:
            while True:
                poll()
                if stop.wait(POLL_SECONDS):
                    return
        except Exception as e:  # re-raised below, in the phase's thread
            errors.append(e)

    out: dict = {"nvidia_smi": smi}
    thread = threading.Thread(target=poller, name="phase30-poller")
    try:
        for kernel in (ce, fa, parzen, ssd, slstm):
            kernel.reset_launches()
        thread.start()
        t0 = time.perf_counter()
        try:
            sched.run(n_trials=SLICE_TRIALS)
            torch.cuda.synchronize()
        finally:
            seconds = time.perf_counter() - t0
            stop.set()
            thread.join()
        launches = {"parzen_score": parzen.launches(), "crossentropy": ce.launches(),
                    "flash_attention": fa.launches(), "ssd": ssd.launches(),
                    "slstm": slstm.launches()}
        if errors:
            raise errors[0]
        for failure in failures:
            print(f"  FAILED {failure}")
        trials = study.get_trials()
        states = [t.state for t in trials]
        complete, pruned = states.count(TrialState.COMPLETE), states.count(TrialState.PRUNED)
        # a trial whose kernel did not build or launch is told FAIL by the
        # scheduler: none may be
        assert len(trials) == SLICE_TRIALS and complete + pruned == SLICE_TRIALS, states
        assert complete >= 1, states
        by_family = {f: [t.state.name for t in trials if t.params["family"] == f]
                     for f in spec.families}
        assert all(by_family.values()), by_family
        assert all(t.intermediate_values for t in trials), "a trial never reported"
        events = sched.events
        slices_used = sorted({e[1] for e in events})
        assert slices_used == list(range(SLICES)), slices_used
        overlap = max_overlap(events)
        assert overlap >= 2, events
        steps = sum(len(t.intermediate_values) * spec.eval_every for t in trials)
        mamba2 = bool(by_family.get("mamba2"))
        assert launches["parzen_score"] > 0 and launches["flash_attention"] > 0, launches
        assert launches["crossentropy"] == steps, (launches, steps)
        assert (launches["ssd"] > 0) == mamba2 and launches["slstm"] == 0, launches
        out.update(trials=SLICE_TRIALS, slices=SLICES, seconds=seconds,
                   trials_per_s=SLICE_TRIALS / seconds,
                   sequential_trials_per_s=sequential["trials_per_s"],
                   complete=complete, pruned=pruned, train_steps=steps,
                   states_by_family=by_family, max_overlap=overlap, launches=launches,
                   best_value=study.best_value)
        print(f"  {SLICE_TRIALS} trials on {SLICES} slices in {seconds:.3f} s = "
              f"{out['trials_per_s']:.3f} trials/s (phase 28, one by one: "
              f"{sequential['trials']} trials in {sequential['seconds']:.3f} s = "
              f"{sequential['trials_per_s']:.3f} trials/s); "
              f"{smi}")
        print(f"  {complete} complete, {pruned} pruned, {steps} train steps, up to {overlap} "
              f"trials at once; by family {by_family}")
        print(f"  launches: parzen_score {launches['parzen_score']}, crossentropy "
              f"{launches['crossentropy']} == {steps} train steps, flash_attention "
              f"{launches['flash_attention']}, ssd {launches['ssd']}, slstm {launches['slstm']}")

        # the study has stopped: the last rows, then idle polls that read no trial data
        poll()
        finished = sorted(t.number for t in trials)
        assert sorted(shipped) == finished and len(shipped) == len(set(shipped)), shipped
        assert cursor["pending"] == "", cursor
        during = list(polls)
        before = telemetry.snapshot()["counters"]
        for _ in range(IDLE_POLLS):
            assert poll() == {"rev": cursor["rev"], "idle": True}
        after = telemetry.snapshot()["counters"]
        assert after.get("dashboard.delta.idle", 0) == \
            before.get("dashboard.delta.idle", 0) + IDLE_POLLS, (before, after)
        moved = {k: (before.get(k, 0), v) for k, v in after.items()
                 if ".refresh." in k and v != before.get(k, 0)}
        assert not moved, moved
        latencies = sorted(1e3 * dt for dt, _ in during)
        out["polls"] = {"during": len(during), "changed": sum(not idle for _, idle in during),
                        "median_ms": latencies[len(latencies) // 2],
                        "max_ms": latencies[-1], "rows": len(shipped)}
        print(f"  dashboard: {len(during)} delta polls while the scheduler ran, "
              f"{out['polls']['changed']} changed, median {out['polls']['median_ms']:.3f} ms, "
              f"max {out['polls']['max_ms']:.3f} ms; {len(shipped)} rows, each finished trial "
              f"once; {IDLE_POLLS} idle polls after, no refetch")

        status, body = get(f"{base}/views")
        views = json.loads(body)
        assert status == 200 and views["n_finished"] == SLICE_TRIALS, views["n_finished"]
        assert views["history"][0]["numbers"] and views["contour"] is not None
        assert views["slices"] and views["curves"]["objectives"][0]["numbers"], views.keys()
        status, body = get(f"{base}/importance")
        importance = json.loads(body)
        params = set().union(*(t.params for t in trials))
        for kind in ("fanova", "spearman"):
            scores = importance[kind]["0"]
            assert status == 200 and set(scores) <= params, (kind, scores)
            assert all(v is not None and math.isfinite(v) for v in scores.values()), scores
            # both rank COMPLETE trials and answer {} below two of them
            assert bool(scores) == (complete >= 2), (kind, complete, scores)
        status, body = get(f"{svc.url}/metrics")
        assert status == 200 and b"repro_dashboard_delta_idle_total" in body
        status, body = get(f"{svc.url}/")
        assert status == 200 and b"/study/slices" in body
        html_path = os.path.join(build, "phase30_dashboard.html")
        hpo.save_dashboard(hpo.load_study("slices", url, engine="numpy"), html_path)
        with open(html_path) as f:
            page = f.read()
        assert "Optimization history" in page and "Parameter importances" in page
        assert "importances unavailable" not in page and page.count("<svg") >= 4, len(page)
        out["importance"] = importance
        out["dashboard_html"] = os.path.relpath(html_path, ROOT)
        print(f"  /views, /importance (fanova {importance['fanova']['0']}), /metrics and / "
              f"answer 200; save_dashboard wrote {out['dashboard_html']} ({len(page)} bytes)")
    finally:
        svc.stop()
        telemetry.disable()
        telemetry.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


#: phase 31: tinyllama-1.1b at full width, depth cut to 2 layers; 4 x 512 tokens a step
SHARDED_LAYERS = 2
SHARDED_B, SHARDED_S = 4, 512
SHARDED_STEPS = 2
#: steps timed after the checked ones, each path alone (the first step warms up)
SHARDED_TIMED_STEPS = 3
#: float32 (TF32 off): the tolerance of the CPU tests (tests/test_torch_parallel.py)
SHARDED_ATOL, SHARDED_RTOL = 1e-5, 1e-4
#: bf16: partial sums over heads / FFN width / the vocabulary rounded to bf16
#: on each shard before the all-reduce move the residual stream by about one
#: bf16 rounding (2^-8 relative) against one bf16 product over all heads; the
#: losses and the gradients' global norms must agree within 4 such roundings.
#: The parameters are no measure of it: AdamW (eps 1e-8, as shipped) moves an
#: entry by about lr whatever its gradient's size, so an entry whose gradient
#: is near 0 can step either way on a rounding.  Those flips are counted (an
#: entry more than half the steps' summed lr apart) and may be at most 1% of
#: the entries.  A world of one computes the same operations.
SHARDED_BF16_RTOL = 4 * 2.0**-8
SHARDED_BF16_FLIPPED_SHARE = 0.01


def sharded_world() -> tuple:
    """Phase 31's world, ``(ranks, mesh shape)``, by a fixed rule: 4 NCCL
    ranks, one a card, in a (2, 2) ("data", "model") mesh when the machine
    has 4 cards; else 1 NCCL rank on cuda:0, a (1, 1) mesh.  NCCL refuses
    two ranks on one card, and gloo, which takes CUDA tensors in c10d's own
    collectives there, crashed (SIGSEGV in ``wait_tensor``) in the
    functional all-gather DTensor runs on them."""
    return (4, (2, 2)) if torch.cuda.device_count() >= 4 else (1, (1, 1))


def _resident_bytes(tensors) -> int:
    """Bytes this rank holds of ``tensors`` (a DTensor's local shard)."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in tensors:
        t = t.to_local() if isinstance(t, DTensor) else t
        total += t.numel() * t.element_size()
    return total


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    else:
        yield tree


def _scalar(v) -> float:
    from torch.distributed.tensor import DTensor

    return float(v.full_tensor() if isinstance(v, DTensor) else v)


def _synced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _sharded_train(cfg, mesh, opt, batches, seed: int,
                   kernels=("flash_attention", "crossentropy")) -> dict:
    """``SHARDED_STEPS`` steps of the unsharded step and of ``build_step``'s
    sharded step from the same weights (the sharded ones from
    ``make_sharded_init``, the unsharded ones from ``init_model_params``,
    one seed): losses, times, the launches of the ``kernels`` (modules of
    ``repro_torch.kernels``) during the sharded steps, resident bytes and
    the steps' peak increment of this rank."""
    import importlib

    from repro_torch.launch.specs import build_step
    from repro_torch.models import init_model_params
    from repro_torch.models.sharding import TRAIN_RULES
    from repro_torch.train import make_train_step
    from repro_torch.train.train_loop import make_sharded_init

    out: dict = {}
    plain = init_model_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    start = {n: p.detach().clone() for n, p in plain.named_parameters()}
    init, _, _ = make_sharded_init(cfg, opt, mesh, TRAIN_RULES)
    (smodel, sstate), out["sharded_init_s"] = _synced(
        lambda: init(torch.Generator(device="cuda").manual_seed(seed)))
    # every rank gathers every parameter (a short-circuit would leave the others waiting)
    out["init_bitwise"] = all([torch.equal(p.full_tensor(), start[n])
                               for n, p in smodel.named_parameters()])
    plain_state = opt.init(dict(plain.named_parameters()))
    plain_step = make_train_step(cfg, opt)
    cell = build_step(cfg, "train_4k", mesh, opt=opt)
    out["plain_resident"] = _resident_bytes(list(plain.parameters())
                                            + list(_tree_leaves(plain_state)))
    out["sharded_resident"] = _resident_bytes(list(smodel.parameters())
                                              + list(_tree_leaves(sstate)))
    plain_losses, plain_s, plain_norms, lr_sum = [], [], [], 0.0
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for i, batch in enumerate(batches):
        (plain, plain_state, m), s = _synced(lambda: plain_step(plain, plain_state, i, batch))
        plain_losses.append(float(m["loss"]))
        plain_norms.append(_scalar(m["grad_norm"]))
        lr_sum += float(m["lr"])
        plain_s.append(s)
    out["plain_peak_increment"] = torch.cuda.max_memory_allocated() - base
    sharded_losses, sharded_s, sharded_norms = [], [], []
    sbatches = [cell.shard(None, None, None, b)[3] for b in batches]
    counters = {k: importlib.import_module(f"repro_torch.kernels.{k}") for k in kernels}
    for counter in counters.values():
        counter.reset_launches()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for i, sb in enumerate(sbatches):
        (smodel, sstate, m), s = _synced(lambda: cell.step(smodel, sstate, i, sb))
        sharded_losses.append(float(m["loss"]))
        sharded_norms.append(_scalar(m["grad_norm"]))
        sharded_s.append(s)
    out["sharded_peak_increment"] = torch.cuda.max_memory_allocated() - base
    out["launches"] = {k: counter.launches() for k, counter in counters.items()}
    out.update(plain_losses=plain_losses, sharded_losses=sharded_losses,
               plain_grad_norms=plain_norms, sharded_grad_norms=sharded_norms,
               plain_step_s=plain_s, sharded_step_s=sharded_s)
    worst, bad, upd_num, upd_den, flipped, total = -1.0, [], 0.0, 0.0, 0, 0
    with torch.no_grad():
        for name, p in plain.named_parameters():
            got = smodel.get_parameter(name).full_tensor()
            excess = float(((got - p).abs() - (SHARDED_ATOL + SHARDED_RTOL * p.abs())).max())
            worst = max(worst, excess)
            if excess > 0:
                bad.append(name)
            upd_num += float(((got - p) ** 2).sum())
            upd_den += float(((p - start[name]) ** 2).sum())
            flipped += int(((got - p).abs() > 0.5 * lr_sum).sum())
            total += p.numel()
    out.update(param_excess=worst, params_outside=bad,
               update_rel=math.sqrt(upd_num / max(upd_den, 1e-30)), flipped_share=flipped / total)
    # steady step times: SHARDED_TIMED_STEPS more of each, on the last batch
    for key, run in (("plain_steady_s", lambda i: plain_step(plain, plain_state, i, batches[-1])),
                     ("sharded_steady_s", lambda i: cell.step(smodel, sstate, i, sbatches[-1]))):
        out[key] = [_synced(lambda: run(SHARDED_STEPS + j))[1] for j in range(SHARDED_TIMED_STEPS)]
    del smodel, sstate, plain, plain_state, start
    torch.cuda.empty_cache()
    return out


def _sharded_serve(cfg, mesh, seed: int, max_new: int = 8) -> dict:
    """The prefill and decode cells against the unsharded path: the first
    logits with a float32 cache against the unsharded prefill step's
    (atol / rtol as the train steps), and ``max_new`` greedy tokens of 4
    prompts of 128 tokens with the ``Engine``'s bfloat16 cache against the
    ``Engine``'s.  A bf16 cache is no measure of float32 agreement: a k / v
    entry a float32 rounding from a bf16 boundary rounds to the other
    neighbour (2^-8 relative), and the logits move by about 1e-3 (on 4
    H100s, 5.5e-4 past the tolerance)."""
    from repro_torch.launch.specs import build_step
    from repro_torch.models import init_cache, init_model_params
    from repro_torch.serve import Engine

    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab, size=128) for _ in range(SHARDED_B)]
    capacity = 128 + max_new
    gen = lambda: torch.Generator(device="cuda").manual_seed(seed)  # noqa: E731
    engine = Engine(cfg, init_model_params(cfg, gen(), "cuda"), capacity=capacity,
                    slots=SHARDED_B, engine="cuda")
    want = engine.generate(prompts, max_new=max_new)
    tokens = torch.from_numpy(np.stack(prompts)).long().cuda()
    f32_cache = lambda: init_cache(cfg, SHARDED_B, capacity, torch.float32, device="cuda")  # noqa: E731
    want_logits = engine._prefill(engine.model, {"tokens": tokens}, f32_cache())[0]
    del engine
    prefill = build_step(cfg, "prefill_32k", mesh)
    decode = build_step(cfg, "decode_32k", mesh)
    smodel, sbatch, cache = prefill.shard(init_model_params(cfg, gen(), "cuda"),
                                          {"tokens": tokens}, f32_cache())
    (logits, _), prefill_s = _synced(lambda: prefill.step(smodel, sbatch, cache))
    first = logits.full_tensor()
    excess = float(((first - want_logits).abs()
                    - (SHARDED_ATOL + SHARDED_RTOL * want_logits.abs())).max())
    cache = prefill.shard(None, None, init_cache(cfg, SHARDED_B, capacity, device="cuda"))[2]
    logits, cache = prefill.step(smodel, sbatch, cache)
    got = [[] for _ in prompts]
    index = tokens.shape[1]
    for i in range(max_new):
        tok = torch.argmax(logits.full_tensor(), dim=-1)
        for j, t in enumerate(tok[:, 0].tolist()):
            got[j].append(t)
        if i + 1 < max_new:
            logits, cache = decode.step(smodel, decode.shard(None, tok[:, :1])[1], cache, index)
            index += 1
    return {"logits_excess": excess, "tokens_equal": got == want, "prefill_s": prefill_s,
            "cache_placements": str(cache["stack"]["0"]["k"].placements)}


def _sharded_compression(cfg, mesh, batch) -> dict:
    """``compressed_psum`` over the "data" ranks of tinyllama's gradients
    (one unsharded step's, each rank on its own batch): every element
    within the int8 bound, n ranks x scale / 2, of the exact float32 sum
    (plus n float32 roundings of the largest gradient, 2^-23 x max |g|
    each)."""
    import torch.distributed as dist

    from repro_torch.models import init_model_params, loss_fn
    from repro_torch.train.compression import compressed_psum

    group = mesh.get_group(mesh.mesh_dim_names.index("data"))
    n = dist.get_world_size(group)
    model = init_model_params(cfg, torch.Generator(device="cuda").manual_seed(7), "cuda")
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    loss, _ = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(named.values()))
    worst, elems = 0.0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for g in grads:
        red = compressed_psum(g, group)
        exact = g.clone()
        dist.all_reduce(exact, group=group)
        gmax = g.abs().max().reshape(1)
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
        bound = n * ((gmax[0] / 127.0 + 1e-12) / 2 + 2.0**-23 * gmax[0])
        worst = max(worst, float(((red - exact).abs() / bound).max()))
        elems += g.numel()
    torch.cuda.synchronize()
    return {"ranks": n, "elements": elems, "worst_over_bound": worst,
            "seconds": time.perf_counter() - t0}


def _sharded_pipeline(world: int, d: int) -> dict:
    """``pipelined_apply`` over the world's ranks (one stage a rank), M = 8
    microbatches of 4 x ``d``: outputs and gradients against the sequential
    composition."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.train.pipeline_parallel import pipelined_apply

    mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("stage",))
    g = torch.Generator(device="cuda").manual_seed(31)
    params = torch.randn(world, d, d, device="cuda", generator=g) / math.sqrt(d)
    x = torch.randn(8, 4, d, device="cuda", generator=g)

    def stage_fn(w, h):
        return torch.tanh(h @ w)

    p1, x1 = params.clone().requires_grad_(True), x.clone().requires_grad_(True)
    out, seconds = _synced(lambda: pipelined_apply(stage_fn, p1, x1, mesh))
    gp, gx = torch.autograd.grad((out ** 2).sum(), [p1, x1])
    dist.all_reduce(gp)  # each rank holds its stage's rows
    p2, x2 = params.clone().requires_grad_(True), x.clone().requires_grad_(True)
    ref = x2
    for i in range(world):
        ref = stage_fn(p2[i], ref)
    gp2, gx2 = torch.autograd.grad((ref ** 2).sum(), [p2, x2])
    return {"stages": world, "out": float((out - ref).abs().max()),
            "grad_params": float((gp - gp2).abs().max()),
            "grad_x": float((gx - gx2).abs().max()), "seconds": seconds}


def sharded_rank(rank: int, world: int, store: str, out_path: str) -> dict:
    """Phase 31 on one rank (``rank`` uses ``cuda:rank``); rank 0 writes the
    result to ``out_path``.  Every check raises on this rank."""
    import torch.distributed as dist

    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import SyntheticLM, TrainConfig, adamw, warmup_cosine
    from repro_torch.train.train_loop import make_optimizer_for

    import faulthandler

    faulthandler.enable(all_threads=True)  # a crash in native code prints each rank's stack
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    dist.init_process_group("nccl", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        from repro_torch import configs

        shape = (2, 2) if world == 4 else (1, 1)
        mesh = make_host_mesh(shape, ("data", "model"), device_type="cuda")
        full = configs.get_config("tinyllama-1.1b")
        cfg32 = dataclasses.replace(full, n_layers=SHARDED_LAYERS, n_superblocks=SHARDED_LAYERS,
                                    compute_dtype="float32", serve_param_dtype="float32")
        cfg16 = dataclasses.replace(cfg32, compute_dtype="bfloat16",
                                    serve_param_dtype="bfloat16")
        data = SyntheticLM(cfg32, SHARDED_B, SHARDED_S, seed=31)
        batches = [{k: v.cuda() for k, v in data.batch_at(i).items()}
                   for i in range(SHARDED_STEPS)]
        # AdamW with eps 1e-4 in float32 (tests/test_torch_train_step.py says why); bf16 as shipped
        opt32 = adamw(warmup_cosine(3e-4, 100, 1000), eps=1e-4)
        res = {"rank": rank, "world": world, "mesh": list(shape)}
        mark = (lambda what: print(f"  rank {rank}: {what}", flush=True)) if world > 1 else (
            lambda what: None)
        mark("mesh up")
        res["f32"] = _sharded_train(cfg32, mesh, opt32, batches, 31)
        mark("float32 steps")
        res["bf16"] = _sharded_train(cfg16, mesh, make_optimizer_for(cfg16, TrainConfig()),
                                     batches, 31)
        mark("bf16 steps")
        res["serve"] = _sharded_serve(cfg32, mesh, 31)
        mark("serving")
        local = SyntheticLM(cfg32, SHARDED_B, SHARDED_S, seed=31 + mesh.get_coordinate()[0])
        res["compression"] = _sharded_compression(cfg32, mesh,
                                                  {k: v.cuda() for k, v in
                                                   local.batch_at(0).items()})
        mark("compression")
        res["pipeline"] = _sharded_pipeline(world, cfg32.d_model)
        mark("pipeline")
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
        every = [None] * world
        dist.all_gather_object(every, [res["f32"]["sharded_resident"],
                                       res["f32"]["sharded_peak_increment"]])
        res["ranks"] = every
        if rank == 0:  # before the checks, so that a failing run shows its numbers
            _print_world(res)
        check_sharded(res)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    return res


def check_sharded(res: dict) -> None:
    """Phase 31's assertions on one rank's result."""
    layers = SHARDED_LAYERS
    for key in ("f32", "bf16"):
        r = res[key]
        assert r["init_bitwise"], f"{key}: gathered make_sharded_init differs from init_model_params"
        # 2 flash launches a layer a step (remat reruns each superblock's forward), 1 CE a step
        assert r["launches"] == {"flash_attention": 2 * layers * SHARDED_STEPS,
                                 "crossentropy": SHARDED_STEPS}, (key, r["launches"])
        assert all(math.isfinite(x) for x in r["sharded_losses"] + r["plain_losses"]), r
    f32 = res["f32"]
    for got, want in zip(f32["sharded_losses"], f32["plain_losses"]):
        assert abs(got - want) <= SHARDED_ATOL + SHARDED_RTOL * abs(want), f32
    assert not f32["params_outside"], (f32["params_outside"][:8], f32["param_excess"])
    bf16 = res["bf16"]
    for got, want in zip(bf16["sharded_losses"] + bf16["sharded_grad_norms"],
                         bf16["plain_losses"] + bf16["plain_grad_norms"]):
        assert abs(got - want) <= SHARDED_BF16_RTOL * abs(want), bf16
    assert bf16["flipped_share"] <= SHARDED_BF16_FLIPPED_SHARE, bf16["flipped_share"]
    serve = res["serve"]
    assert serve["logits_excess"] <= 0.0 and serve["tokens_equal"], serve
    assert res["compression"]["worst_over_bound"] <= 1.0, res["compression"]
    pp = res["pipeline"]
    assert max(pp["out"], pp["grad_params"], pp["grad_x"]) <= 1e-5, pp


def _run_world(world: int, tmp: str, rank_fn) -> dict:
    """``rank_fn(rank, world, store, out_path)`` on every rank of a world of
    ``world`` (in this process for one, else spawned); rank 0's result."""
    store, out_path = os.path.join(tmp, "store"), os.path.join(tmp, "rank0.json")
    if world == 1:
        return rank_fn(0, 1, store, out_path)
    import torch.multiprocessing as mp

    mp.start_processes(rank_fn, args=(world, store, out_path), nprocs=world,
                       start_method="spawn", join=True)
    with open(out_path) as f:
        return json.load(f)


def _print_world(res: dict) -> None:
    gib = 2.0**30
    for key in ("f32", "bf16"):
        r = res[key]
        print(f"  {key}: losses sharded {r['sharded_losses']} unsharded {r['plain_losses']}; "
              f"steady step s sharded {[round(s, 4) for s in r['sharded_steady_s']]} unsharded "
              f"{[round(s, 4) for s in r['plain_steady_s']]} (first steps "
              f"{[round(s, 4) for s in r['sharded_step_s']]} / "
              f"{[round(s, 4) for s in r['plain_step_s']]}); launches {r['launches']}; rank 0 "
              f"resident {r['sharded_resident'] / gib:.3f} GiB sharded, "
              f"{r['plain_resident'] / gib:.3f} GiB unsharded; step peak increment "
              f"{r['sharded_peak_increment'] / gib:.3f} / {r['plain_peak_increment'] / gib:.3f} "
              f"GiB; init bitwise {r['init_bitwise']} ({r['sharded_init_s']:.2f} s); params "
              f"worst excess over atol+rtol {r['param_excess']:.3g}; update rel "
              f"{r['update_rel']:.3g}, flipped share {r['flipped_share']:.3g}; grad norms "
              f"{r['sharded_grad_norms']} / {r['plain_grad_norms']}")
    print(f"  serve: {res['serve']}")
    print(f"  compression: {res['compression']}")
    print(f"  pipeline: {res['pipeline']}")
    print(f"  per rank [f32 sharded resident, step peak increment] bytes: {res['ranks']}; "
          f"rank 0 peak allocated {res['peak_bytes'] / gib:.2f} GiB")


def phase_sharded() -> dict:
    """Phase 31: the multi-GPU path (``launch.specs.build_step`` on a
    ``DeviceMesh``) at tinyllama-1.1b's full width cut to 2 layers."""
    import shutil
    import tempfile

    world, shape = sharded_world()
    print(f"phase 31: tinyllama-1.1b (d_model 2048, 32 / 4 heads, d_ff 5632, vocab 32000) cut "
          f"to {SHARDED_LAYERS} layers through build_step on a DeviceMesh, "
          f"{SHARDED_STEPS} checked steps of {SHARDED_B} x {SHARDED_S}; world {world} in a "
          f"{shape} ('data', 'model') mesh over NCCL ({torch.cuda.device_count()} card(s); the "
          f"rule: 4 ranks, one a card, with 4 cards, else 1); {nvidia_smi('name,power.limit')}")
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase31-", dir=build)
    try:
        res = _run_world(world, tmp, sharded_rank)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  {nvidia_smi('name,power.limit')}")
    return res


#: phase 32(a): phase 31's model and step (tinyllama-1.1b at full width, 2 layers, 4 x 512)
#: in bf16, counted on real and on fake CUDA tensors; the fake step's peak
#: memory within this share of the real step's ``max_memory_allocated``
OPS_PEAK_RTOL = 0.10
#: phase 32(c): tinyllama-1.1b's train_4k cell on the single-pod fake world,
#: depth cut to this many layers (full width) to keep the phase inside 60 s
OPS_DRYRUN_LAYERS = 6
#: phase 32(d): calls a dispatch-cost timing averages
OPS_DISPATCH_REPS = 200


def _zeros_tree(tree, device):
    """``tree``'s meta tensors as zeros on ``device`` (fake ones under a
    ``FakeTensorMode``)."""
    if isinstance(tree, dict):
        return {k: _zeros_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=tree.dtype, device=device)
    return tree


def _count_cells(cfg, batch: dict, fake: bool) -> dict:
    """``op_analysis.analyze_step`` of the train and prefill cells of
    ``build_step`` on a (1, 1) mesh, on real CUDA tensors (a world of one
    NCCL rank: the kernels launch, their counts and the step's peak memory
    are read, the steps timed without the analysis) or on fake ones (a
    world of one fake rank: nothing runs on the card)."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import crossentropy as ce
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.op_analysis import analyze_step
    from repro_torch.launch.specs import build_step
    from repro_torch.models import Transformer, init_cache, init_model_params

    B, S = batch["tokens"].shape
    out: dict = {}
    with contextlib.ExitStack() as stack:
        if fake:
            stack.enter_context(fake_world(1))
        else:
            tmp = stack.enter_context(_tempdir())
            dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                    rank=0, world_size=1)
            stack.callback(dist.destroy_process_group)
        mesh = make_host_mesh((1, 1), ("data", "model"), device_type="cuda")
        for name in ("train", "prefill"):
            cell = build_step(cfg, "train_4k" if name == "train" else "prefill_32k", mesh)
            with contextlib.ExitStack() as inner:
                if fake:
                    inner.enter_context(FakeTensorMode())
                    model = Transformer(cfg, device="cuda")
                    data = {k: torch.empty(v.shape, dtype=v.dtype, device="cuda")
                            for k, v in batch.items()}
                else:
                    torch.cuda.empty_cache()
                    other = torch.cuda.memory_allocated()
                    model = init_model_params(cfg, torch.Generator(device="cuda").manual_seed(32),
                                              "cuda")
                    data = batch
                if name == "train":
                    args = cell.shard(model, _zeros_tree(cell.args[1], "cuda"), 0, data)
                else:
                    args = cell.shard(model, {"tokens": data["tokens"]},
                                      init_cache(cfg, B, S, torch.bfloat16, device="cuda"))
                if not fake:
                    fa.reset_launches()
                    ce.reset_launches()
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                stats = analyze_step(cell.step, *args, mesh=mesh)
                row = {"stats": stats.asdict()}
                if not fake:
                    torch.cuda.synchronize()
                    row["real_peak"] = torch.cuda.max_memory_allocated() - other
                    row["launches"] = {"flash_attention": fa.launches(),
                                       "crossentropy": ce.launches()}
                    if name == "train":  # two more steps, the last one timed
                        _synced(lambda: cell.step(args[0], args[1], 1, args[3]))
                        row["step_s"] = _synced(lambda: cell.step(args[0], args[1], 2, args[3]))[1]
                    else:
                        row["step_s"] = _synced(lambda: cell.step(*args))[1]
                out[name] = row
                del args, model
    return out


@contextlib.contextmanager
def _tempdir():
    import shutil
    import tempfile

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase32-", dir=build)
    try:
        yield tmp
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _kernel_bound_ms(op: dict, dtype_peak: float) -> float:
    """A kernel op's least time a call from its registered FLOPs and its
    bytes (inputs read once, outputs written once)."""
    n = op["count"]
    return 1e3 * max(op["flops"] / n / dtype_peak, op["bytes"] / n / HBM_BYTES_PER_S)


def _dispatch_costs() -> dict:
    """Milliseconds a call through the wrapper (as the main path calls it:
    its checks, then the op), through the kernel's op, and through the op's
    own function (the launch without the dispatcher), in turns in one
    process, at the score table's Parzen shape (C 4096 against 26 / 4072
    components) and tinyllama's prefill flash shape (B 8, S 2048, 32 / 4
    heads of 64, bf16)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import parzen

    rng = np.random.RandomState(32)
    cands = torch.tensor(rng.uniform(-3, 3, 4096), dtype=torch.float32, device="cuda")
    comps = [torch.tensor(a, dtype=torch.float32, device="cuda")
             for k in MAIN_PATH_COMPONENTS[1] for a in synthetic_mixture(rng, k, 0)]
    gen = torch.Generator(device="cuda").manual_seed(32)
    q, k, v = flash_inputs(gen, 8, 32, 4, 2048, 2048, 64, torch.bfloat16, True, qk_scale=3.0)
    kv_len = k.shape[2]
    out = {}
    flash_args = (q, k, v, True, -1, 0.0, 0, kv_len)
    for name, wrapper, op, raw in (
            ("parzen_score", lambda: parzen.parzen_score(cands, *comps),
             lambda: parzen._parzen_op(cands, *comps),
             lambda: parzen._parzen_op._init_fn(cands, *comps)),
            ("flash_attention", lambda: fa.flash_attention(q, k, v),
             lambda: fa._flash_op(*flash_args), lambda: fa._flash_op._init_fn(*flash_args))):
        # in turns: raw, op, wrapper, wrapper, op, raw
        times = [time_ms(fn, OPS_DISPATCH_REPS) for fn in (raw, op, wrapper, wrapper, op, raw)]
        out[name] = {"wrapper_ms": (times[2] + times[3]) / 2, "op_ms": (times[1] + times[4]) / 2,
                     "raw_ms": (times[0] + times[5]) / 2, "runs_ms": times}
        out[name]["dispatch_ms"] = out[name]["op_ms"] - out[name]["raw_ms"]
    return out


def phase_op_analysis() -> dict:
    """Phase 32: the launch analysis tooling (``launch/op_analysis.py``,
    ``launch/dryrun.py``, ``launch/roofline.py``) on the card's build."""
    from repro_torch import configs
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.op_analysis import kernel_ops
    from repro_torch.launch.roofline import HBM_BW, HBM_BYTES, PEAK_FLOPS, collective_seconds
    from repro_torch.train import SyntheticLM

    # DTensor warns at every redistribution it splits into one collective a mesh dim
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    full = configs.get_config("tinyllama-1.1b")
    cfg = dataclasses.replace(full, n_layers=SHARDED_LAYERS, n_superblocks=SHARDED_LAYERS)
    print(f"phase 32: (a) tinyllama-1.1b at full width cut to {SHARDED_LAYERS} layers, a "
          f"{SHARDED_B} x {SHARDED_S} bf16 train step and a prefill through build_step on a "
          f"(1, 1) mesh, counted by op_analysis.analyze_step on real CUDA tensors (1 NCCL rank) "
          f"and on fake ones (1 fake rank); {nvidia_smi('name,power.limit')}")
    data = SyntheticLM(cfg, SHARDED_B, SHARDED_S, seed=32)
    batch = {k: v.cuda() for k, v in data.batch_at(0).items()}
    real = _count_cells(cfg, batch, fake=False)
    fake = _count_cells(cfg, batch, fake=True)
    out: dict = {"real": {}, "fake": {}}
    for name in ("train", "prefill"):
        r, f = real[name]["stats"], fake[name]["stats"]
        counts = {k: v["count"] for k, v in r["ops"].items()}
        kops = kernel_ops(r)
        launches = real[name]["launches"]
        fake_peak = f["memory"]["per_device_total"]
        real_peak = real[name]["real_peak"]
        terms = {"compute": r["flops"] / PEAK_FLOPS, "memory": r["bytes_accessed"] / HBM_BW,
                 "collective": collective_seconds(r["collectives_by_dim"])}
        print(f"  (a) {name}: flops real {r['flops']:.6e} fake {f['flops']:.6e}; bytes real "
              f"{r['bytes_accessed']:.6e} fake {f['bytes_accessed']:.6e}; {sum(counts.values())} "
              f"ops of {len(counts)} kinds; kernel ops {kops}; launches {launches}; peak fake "
              f"{fake_peak / 2**30:.4f} GiB (MemTracker) real {real_peak / 2**30:.4f} GiB "
              f"(max_memory_allocated); step {real[name]['step_s']:.4f} s measured, roofline "
              f"terms compute {terms['compute']:.6f} memory {terms['memory']:.6f} collective "
              f"{terms['collective']:.6f} s")
        assert r["flops"] == f["flops"] and r["bytes_accessed"] == f["bytes_accessed"], name
        assert counts == {k: v["count"] for k, v in f["ops"].items()}, name
        for op, n in launches.items():
            assert kops.get(op, {"count": 0})["count"] == n, (name, op, kops, launches)
        assert launches["flash_attention"] > 0, launches
        if name == "train":
            assert launches["crossentropy"] == 1, launches
            assert abs(fake_peak - real_peak) <= OPS_PEAK_RTOL * real_peak, (fake_peak, real_peak)
        out["real"][name] = {**real[name], "terms": terms}
        out["fake"][name] = fake[name]
    # each kernel's share of its bound at the step's shapes (CUDA events)
    from repro_torch.kernels import crossentropy as ce
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(33)
    q, k, v = flash_inputs(gen, SHARDED_B, 32, 4, SHARDED_S, SHARDED_S, 64, torch.bfloat16,
                           True, qk_scale=3.0)
    x = torch.randn(SHARDED_B * SHARDED_S, cfg.d_model, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    w = torch.randn(cfg.d_model, cfg.vocab, device="cuda", generator=gen) / math.sqrt(cfg.d_model)
    labels = torch.randint(0, cfg.vocab, (SHARDED_B * SHARDED_S,), device="cuda", generator=gen)
    kops = kernel_ops(out["real"]["train"]["stats"])
    shares = {}
    for op, fn in (("flash_attention", lambda: fa.flash_attention(q, k, v)),
                   ("crossentropy", lambda: ce.crossentropy_forward(x, w, labels))):
        ms = time_ms(fn, 20)
        bound = _kernel_bound_ms(kops[op], BF16_TC_OPS_PER_S)
        shares[op] = {"ms": ms, "bound_ms": bound, "share": bound / ms}
        print(f"  (a) {op} at the step's shapes: {ms:.4f} ms, bound {bound:.4f} ms from its "
              f"registered formula and bytes, {bound / ms:.3f} of the bound")
    out["bound_shares"] = shares
    out["dispatch"] = _dispatch_costs()
    for op, d in out["dispatch"].items():
        print(f"  (d) {op}: {d['wrapper_ms']:.5f} ms a call through the wrapper (its checks "
              f"and the op), {d['op_ms']:.5f} ms through the op, {d['raw_ms']:.5f} ms through "
              f"the op's own function; dispatch {d['dispatch_ms'] * 1e3:.2f} us a call (runs "
              f"raw / op / wrapper / wrapper / op / raw "
              f"{[round(t, 5) for t in d['runs_ms']]})")
    # (b) the reference's dry-run cell, (c) a training cell, on fake CUDA tensors
    out_dir = os.path.join(ROOT, "build", "phase32_dryrun")
    t0 = time.perf_counter()
    rec = run_cell("smollm-135m", "decode_32k", multi_pod=True, out_dir=out_dir, device="cuda")
    out["dryrun_smollm"] = {k: rec[k] for k in ("n_chips", "memory", "build_s", "run_s")}
    out["dryrun_smollm"].update(flops=rec["op_stats"]["flops"],
                                collectives_by_dim=rec["op_stats"]["collectives_by_dim"],
                                seconds=time.perf_counter() - t0)
    print(f"  (b) smollm-135m decode_32k on 512 fake ranks: {out['dryrun_smollm']}")
    assert rec["n_chips"] == 512, rec["n_chips"]
    assert rec["memory"]["per_device_total"] < HBM_BYTES, rec["memory"]
    assert rec["op_stats"]["flops"] > 0
    cut = dataclasses.replace(full, n_layers=OPS_DRYRUN_LAYERS, n_superblocks=OPS_DRYRUN_LAYERS)
    t0 = time.perf_counter()
    rec = run_cell("tinyllama-1.1b", "train_4k", multi_pod=False, out_dir=out_dir, device="cuda",
                   cfg=cut)
    kops = kernel_ops(rec["op_stats"])
    flops = rec["op_stats"]["flops"]
    out["dryrun_tinyllama"] = {"layers": OPS_DRYRUN_LAYERS, "memory": rec["memory"],
                               "flops": flops, "kernel_ops": kops,
                               "flop_shares": {op: v["flops"] / flops for op, v in kops.items()},
                               "seconds": time.perf_counter() - t0}
    print(f"  (c) tinyllama-1.1b train_4k cut to {OPS_DRYRUN_LAYERS} layers on 256 fake ranks: "
          f"{rec['memory']['per_device_total'] / 2**30:.3f} GiB a card, {flops:.4e} FLOPs a "
          f"card; kernel ops {kops}; FLOP shares {out['dryrun_tinyllama']['flop_shares']}")
    assert kops["flash_attention"]["count"] == 2 * OPS_DRYRUN_LAYERS, kops
    assert kops["crossentropy"]["count"] == 1, kops
    print(f"  {nvidia_smi('name,power.limit')}")
    return out


#: phase 33(a): one dry-run cell for each mechanism of the sharded serving caches, on fake
#: CUDA tensors at full width, depth cut to 2 layers (``two_layers``)
SERVE_CACHE_CELLS = (("gemma2-9b", "long_500k", True),
                     ("deepseek-v2-lite-16b", "prefill_32k", True),
                     ("zamba2-1.2b", "decode_32k", False),
                     ("musicgen-medium", "decode_32k", False))
#: phase 33(b): a batch-1 prompt against a cache of long_500k's capacity that crosses the shard
#: boundary of gemma2's window ring (4096 slots, 2048 a shard over "data") and wraps it, then
#: decode steps, float32 with a float32 cache
SERVE_CACHE_PROMPT, SERVE_CACHE_STEPS = 4101, 4


def two_layers(full):
    """``full`` at its own widths cut to 2 layers: zamba2 to one mamba2
    block and its shared attention block, deepseek to its dense head block
    and one MLA / MoE block, gemma2 to one window and one global layer, the
    others to their first 2 stacked blocks."""
    if full.has_shared_block:
        return dataclasses.replace(full, superblock=(full.superblock[0], full.superblock[-1]),
                                   n_superblocks=1, tail_blocks=(), n_layers=2)
    return cut_depth(full, 2 // (len(full.head_blocks) + len(full.superblock)))


def _serve_cache_cells() -> dict:
    """Phase 33(a): ``launch.dryrun.run_cell`` of ``SERVE_CACHE_CELLS`` on
    fake CUDA tensors (the kernels' ops counted): memory a card, the flash
    and SSD op counts, collectives by mesh dim."""
    from repro_torch import configs
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.op_analysis import kernel_ops
    from repro_torch.launch.roofline import HBM_BYTES

    out_dir = os.path.join(ROOT, "build", "phase33_dryrun")
    out = {}
    for arch, shape, multi in SERVE_CACHE_CELLS:
        t0 = time.perf_counter()
        rec = run_cell(arch, shape, multi, out_dir=out_dir, verbose=False, device="cuda",
                       cfg=two_layers(configs.get_config(arch)))
        kops = kernel_ops(rec["op_stats"])
        row = {"n_chips": rec["n_chips"], "memory": rec["memory"]["per_device_total"],
               "flash_ops": kops.get("flash_attention", {}).get("count", 0),
               "ssd_ops": kops.get("ssd", {}).get("count", 0),
               "collectives_by_dim": rec["op_stats"]["collectives_by_dim"],
               "seconds": time.perf_counter() - t0}
        print(f"  (a) {arch} {shape} on {rec['n_chips']} fake ranks, 2 layers: "
              f"{row['memory'] / 2**30:.3f} GiB a card; flash ops {row['flash_ops']}, SSD ops "
              f"{row['ssd_ops']} (decode and MLA blocks launch no kernel); collectives "
              f"{row['collectives_by_dim']}; {row['seconds']:.1f} s")
        assert row["memory"] < HBM_BYTES, row
        assert row["flash_ops"] == row["ssd_ops"] == 0, row
        out[f"{arch}:{shape}:{rec['mesh']}"] = row
    # batch 1 on 512 cards leaves "pod" x "data" to the rows: the sequence combine over both
    by_dim = out["gemma2-9b:long_500k:2x32x8"]["collectives_by_dim"]
    assert by_dim["pod"]["all-reduce"] > 0 and by_dim["data"]["all-reduce"] > 0, by_dim
    assert "all-gather" in out["zamba2-1.2b:decode_32k:32x8"]["collectives_by_dim"]["model"]
    return out


def _serve_cache_arch(arch: str, mesh) -> dict:
    """Phase 33(b) for one arch on this rank: the unsharded ``Engine``'s
    prefill and decode steps on the plain PyTorch versions of the kernels
    (``engine="torch"``) against ``build_step``'s serving cells on ``mesh``,
    whose prefill runs the flash and SSD kernels at this path's shapes
    (gemma2's head width 256, window 4096 and softcap 50 over a 4101-token
    prompt; zamba2's SSD from the local state shard and its shared
    attention), float32 with a float32 cache of long_500k's capacity; the
    sharded prefill counted by ``analyze_step`` (the kernels' ops) with the
    launch counters set to 0 just before it, the decode steps' launches."""
    from torch.distributed.tensor import Shard

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    from repro_torch.launch.op_analysis import analyze_step, kernel_ops
    from repro_torch.launch.specs import build_step
    from repro_torch.models import SHAPES, init_cache, init_model_params
    from repro_torch.serve import Engine

    cfg = dataclasses.replace(two_layers(configs.get_config(arch)), compute_dtype="float32",
                              serve_param_dtype="float32")
    capacity = SHAPES["long_500k"].seq_len
    rng = np.random.RandomState(33)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab, (1, SERVE_CACHE_PROMPT))).cuda()
    fed = [torch.from_numpy(rng.randint(0, cfg.vocab, (1, 1))).cuda()
           for _ in range(SERVE_CACHE_STEPS)]
    gen = lambda: torch.Generator(device="cuda").manual_seed(33)  # noqa: E731
    f32_cache = lambda: init_cache(cfg, 1, capacity, torch.float32, device="cuda")  # noqa: E731
    engine = Engine(cfg, init_model_params(cfg, gen(), "cuda"), capacity=capacity, slots=1,
                    engine="torch")
    logits, cache = engine._prefill(engine.model, {"tokens": prompt}, f32_cache())
    want = [logits]
    for i, tok in enumerate(fed):
        logits, cache = engine._decode(engine.model, tok, cache, SERVE_CACHE_PROMPT + i)
        want.append(logits)
    del engine, cache
    torch.cuda.empty_cache()
    prefill = build_step(cfg, "prefill_32k", mesh)
    decode = build_step(cfg, "decode_32k", mesh)
    smodel, sbatch, scache = prefill.shard(init_model_params(cfg, gen(), "cuda"),
                                           {"tokens": prompt}, f32_cache())
    torch.cuda.empty_cache()
    held = {}
    fa.reset_launches()
    ssd.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = analyze_step(lambda *a: held.setdefault("out", prefill.step(*a)), smodel, sbatch,
                         scache, mesh=mesh, memory=False)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches(), "ssd": ssd.launches()}
    kops = kernel_ops(stats)
    ops = {k: kops.get(k, {"count": 0})["count"] for k in launches}
    logits, scache = held["out"]
    got = [logits.full_tensor()]
    fa.reset_launches()
    ssd.reset_launches()
    t0 = time.perf_counter()
    for i, tok in enumerate(fed):
        logits, scache = decode.step(smodel, decode.shard(None, tok)[1], scache,
                                     SERVE_CACHE_PROMPT + i)
        got.append(logits.full_tensor())
    torch.cuda.synchronize()
    decode_s = (time.perf_counter() - t0) / SERVE_CACHE_STEPS
    decode_launches = {"flash_attention": fa.launches(), "ssd": ssd.launches()}
    excess = max(float(((g - w).abs() - (SHARDED_ATOL + SHARDED_RTOL * w.abs())).max())
                 for g, w in zip(got, want))
    worst = max(float((g - w).abs().max()) for g, w in zip(got, want))
    kv = {pos: c for pos, c in scache["stack"].items() if "k" in c}
    data = mesh.mesh_dim_names.index("data")
    split = {pos: c["k"].placements[data] == Shard(2) and mesh.size(data) > 1
             for pos, c in kv.items()}
    rows = {pos: c["k"].to_local().shape[2] for pos, c in kv.items()}
    del smodel, scache, held
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "capacity": capacity, "prompt": SERVE_CACHE_PROMPT,
            "excess": excess, "worst_abs": worst, "launches": launches, "ops": ops,
            "decode_launches": decode_launches, "prefill_s": prefill_s, "decode_s": decode_s,
            "seq_split": split, "local_rows": rows,
            "placements": {pos: str(c["k"].placements) for pos, c in kv.items()}}


def serve_cache_rank(rank: int, world: int, store: str, out_path: str) -> dict:
    """Phase 33(b) on one rank (``cuda:rank``), in phase 31's world: a (1, 2,
    2) ("pod", "data", "model") mesh over 4 NCCL ranks, where batch 1 leaves
    "data" to the caches' rows, else a (1, 1, 1) mesh over one; rank 0 writes
    the result to ``out_path``.  Every check raises on this rank."""
    import torch.distributed as dist

    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    _build.load()
    dist.init_process_group("nccl", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        shape = (1, 2, 2) if world == 4 else (1, 1, 1)
        mesh = make_host_mesh(shape, ("pod", "data", "model"), device_type="cuda")
        res = {"rank": rank, "world": world, "mesh": list(shape)}
        for arch in ("gemma2-9b", "zamba2-1.2b"):
            res[arch] = _serve_cache_arch(arch, mesh)
        every = [None] * world
        dist.all_gather_object(every, {a: res[a]["launches"] for a in ("gemma2-9b", "zamba2-1.2b")})
        res["ranks"] = every
        if rank == 0:  # before the checks, so that a failing run shows its numbers
            for arch in ("gemma2-9b", "zamba2-1.2b"):
                print(f"  (b) {arch}: {res[arch]}")
            print(f"  (b) flash / SSD launches a rank in the sharded prefill: {every}")
            if world == 1:
                print("  (b) a world of one: batch 1 takes the size-1 batch axes, so no cache "
                      "was split along its sequence or over cards; the split paths did not run "
                      "here (tests/test_torch_serve_sharded.py runs them on 4 CPU ranks)")
        check_serve_cache(res)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    return res


def check_serve_cache(res: dict) -> None:
    """Phase 33(b)'s assertions on one rank's result: the float32 bound of
    phase 31 against the unsharded ``Engine`` on the plain versions; one
    flash launch an attention block and one SSD launch a mamba2 block in
    the prefill, each its op's count, none in decode; on 4 ranks every KV
    cache split along its sequence over "data"."""
    for arch, flash, ssd_n in (("gemma2-9b", 2, 0), ("zamba2-1.2b", 1, 1)):
        r = res[arch]
        assert r["excess"] <= 0.0, (arch, r["excess"], r["worst_abs"])
        assert r["launches"] == r["ops"] == {"flash_attention": flash, "ssd": ssd_n}, (arch, r)
        assert r["decode_launches"] == {"flash_attention": 0, "ssd": 0}, (arch, r)
        assert all(r["seq_split"].values()) == (res["world"] == 4), (arch, r["seq_split"])


def phase_serve_cache() -> dict:
    """Phase 33: the sharded serving caches: (a) their dry-run cells on fake
    CUDA tensors, (b) gemma2 and zamba2 served on phase 31's world through
    the kernels against the unsharded ``Engine`` on their plain versions."""
    import shutil
    import tempfile

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    world, _ = sharded_world()
    print(f"phase 33: the sharded serving caches; (a) {len(SERVE_CACHE_CELLS)} dry-run cells at "
          f"full width, 2 layers; (b) gemma2-9b (one window, one global layer) and zamba2-1.2b "
          f"(one mamba2 and the shared attention block) at full width, a batch-1 prompt of "
          f"{SERVE_CACHE_PROMPT} tokens and {SERVE_CACHE_STEPS} decode steps against a cache of "
          f"long_500k's capacity, world {world} ({torch.cuda.device_count()} card(s)); "
          f"{nvidia_smi('name,power.limit')}")
    out = {"cells": _serve_cache_cells()}
    tmp = tempfile.mkdtemp(prefix="phase33-", dir=os.path.join(ROOT, "build"))
    try:
        out["served"] = _run_world(world, tmp, serve_cache_rank)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  {nvidia_smi('name,power.limit')}")
    return out


#: phase 34(a): xlstm-1.3b's dry-run cells at full width cut to one superblock (7 mLSTM + 1
#: sLSTM), on fake CUDA tensors in worker processes started after the build (host-bound: no
#: card is used), read in phase 34
XLSTM_CELLS = tuple((shape, multi) for shape in ("train_4k", "prefill_32k", "decode_32k",
                                                 "long_500k") for multi in (False, True))
XLSTM_CELL_JOBS = 2
#: phase 34(b): a batch of 2 prompts, then teacher-forced decode steps, float32 with float32 caches
XLSTM_SERVE_B, XLSTM_SERVE_S, XLSTM_SERVE_STEPS = 2, 320, 4
#: phase 34(c): 2 float32 train steps of 2 x 512 tokens
XLSTM_TRAIN_B, XLSTM_TRAIN_S = 2, 512


def xlstm_cell(shape: str, multi: bool) -> dict:
    """Phase 34(a), one cell in a worker process: ``launch.dryrun.run_cell``
    of xlstm-1.3b cut to one superblock on fake CUDA tensors; memory a
    card, the roofline's terms and the ``repro_torch::slstm`` op's count."""
    from repro_torch import configs
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.op_analysis import kernel_ops
    from repro_torch.launch.roofline import roofline_row

    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    t0 = time.perf_counter()
    rec = run_cell("xlstm-1.3b", shape, multi, verbose=False, device="cuda",
                   out_dir=os.path.join(ROOT, "build", "phase34_dryrun"),
                   cfg=cut_depth(configs.get_config("xlstm-1.3b"), 1))
    row = roofline_row(rec)
    terms = {k: row[f"t_{k}_s"] for k in ("compute", "memory", "collective")}
    return {"shape": shape, "mesh": rec["mesh"], "n_chips": rec["n_chips"],
            "memory": rec["memory"]["per_device_total"], "terms_s": terms,
            "largest": row["bottleneck"],
            "slstm_ops": kernel_ops(rec["op_stats"]).get("slstm", {}).get("count", 0),
            "collectives_by_dim": rec["op_stats"]["collectives_by_dim"],
            "seconds": time.perf_counter() - t0}


def start_xlstm_cells():
    """Phase 34(a)'s cells in ``XLSTM_CELL_JOBS`` spawned processes: ``(pool,
    pending results)``.  The pool takes no more work, so its processes exit
    once the cells are done; it is terminated at exit if a phase fails
    before phase 34 reads it."""
    import atexit
    import multiprocessing as mp

    pool = mp.get_context("spawn").Pool(XLSTM_CELL_JOBS)
    atexit.register(pool.terminate)
    pending = [pool.apply_async(xlstm_cell, cell) for cell in XLSTM_CELLS]
    pool.close()
    return pool, pending


def _xlstm_cells(pool, pending) -> dict:
    """Phase 34(a): the cells' results, each printed."""
    from repro_torch.launch.roofline import HBM_BYTES

    t0 = time.perf_counter()
    out = {}
    for job in pending:
        row = job.get()
        out[f"{row['shape']}:{row['mesh']}"] = row
        terms = ", ".join(f"{k} {v:.4g} s" for k, v in row["terms_s"].items())
        over = "" if row["memory"] <= HBM_BYTES else " (over 80 GB)"
        print(f"  (a) xlstm-1.3b {row['shape']} on {row['n_chips']} fake ranks, one superblock: "
              f"{row['memory'] / 2**30:.3f} GiB a card{over}; largest term {row['largest']} "
              f"({terms}); slstm ops {row['slstm_ops']}; collectives "
              f"{row['collectives_by_dim']}; {row['seconds']:.1f} s in its worker")
    pool.join()
    print(f"  (a) waited {time.perf_counter() - t0:.1f} s in phase 34 for the cells' workers")
    for key, row in out.items():
        assert row["memory"] <= HBM_BYTES, (key, row)
        # one sLSTM block: a launch a prefill or decode step, two a train step (remat)
        assert row["slstm_ops"] == (2 if row["shape"] == "train_4k" else 1), (key, row)
    return out


#: phase 34(b) on several ranks: the sharded logits may lie this many times the model's own
#: float32 sensitivity (``two_part_sums``) beyond atol + rtol from the unsharded steps
XLSTM_REORDER_FACTOR = 4.0


@contextlib.contextmanager
def two_part_sums():
    """The one-device mLSTM blocks with their gate and output products each
    summed in two halves of the inner width, the order in which two
    model-axis ranks sum them: a float32 reordering whose effect on the
    logits measures how far the model itself amplifies such a change (the
    exponential gates over a few hundred steps)."""
    import torch.nn.functional as F

    from repro_torch.models import ssm_xlstm as xl
    from repro_torch.models.layers import rms_norm

    qkvif, out = xl._mlstm_qkvif, xl._mlstm_out

    def halves(a, w):
        k = a.shape[-1] // 2
        return a[..., :k] @ w[:k] + a[..., k:] @ w[k:]

    def split_qkvif(p, x, cfg, gate_sum=None):
        xc = (x @ p.w_up.to(x.dtype))[..., :p.wq.shape[0] * p.wq.shape[1]]
        gates = halves(xc, p.w_if.to(x.dtype))
        return qkvif(p, x, cfg, gate_sum=lambda _: gates)

    def split_out(p, h, z, cfg, x_dtype):
        B, S, H, D = h.shape
        gated = rms_norm(h.reshape(B, S, H * D), p.out_norm, cfg.norm_eps) * F.silu(z)
        return halves(gated, p.w_down.to(x_dtype))

    xl._mlstm_qkvif, xl._mlstm_out = split_qkvif, split_out
    try:
        yield
    finally:
        xl._mlstm_qkvif, xl._mlstm_out = qkvif, out


def _xlstm_serve(cfg, mesh) -> dict:
    """Phase 34(b) on this rank: the unsharded prefill on the sLSTM scan's
    plain PyTorch version (``engine="torch"``) and on the kernel (``"cuda"``)
    and the unsharded decode steps (the kernel's decode launch, as the
    ``Engine``'s), once more on the kernel with ``two_part_sums``, then
    ``build_step``'s serving cells on ``mesh`` through the kernel, each step
    counted by ``analyze_step`` (the kernel's op) with the launch counter set
    to 0 just before it."""
    from repro_torch.kernels import slstm
    from repro_torch.launch.op_analysis import analyze_step, kernel_ops
    from repro_torch.launch.specs import build_step
    from repro_torch.models import init_cache, init_model_params
    from repro_torch.serve import make_decode_step, make_prefill_step

    B, S, steps = XLSTM_SERVE_B, XLSTM_SERVE_S, XLSTM_SERVE_STEPS
    rng = np.random.RandomState(34)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab, (B, S))).cuda()
    fed = [torch.from_numpy(rng.randint(0, cfg.vocab, (B, 1))).cuda() for _ in range(steps)]
    gen = lambda: torch.Generator(device="cuda").manual_seed(34)  # noqa: E731
    f32_cache = lambda: init_cache(cfg, B, S + steps, torch.float32, device="cuda")  # noqa: E731
    model = init_model_params(cfg, gen(), "cuda")
    want = {}
    for key, eng in (("plain", "torch"), ("kernel", "cuda"), ("two_part", "cuda")):
        prefill, decode = make_prefill_step(cfg, eng), make_decode_step(cfg)
        with two_part_sums() if key == "two_part" else contextlib.nullcontext():
            logits, cache = prefill(model, {"tokens": prompt}, f32_cache())
            want[key] = [logits]
            for i, tok in enumerate(fed):
                logits, cache = decode(model, tok, cache, S + i)
                want[key].append(logits)
    del model, cache
    torch.cuda.empty_cache()
    prefill = build_step(cfg, "prefill_32k", mesh)
    decode = build_step(cfg, "decode_32k", mesh)
    smodel, sbatch, scache = prefill.shard(init_model_params(cfg, gen(), "cuda"),
                                           {"tokens": prompt}, f32_cache())
    got, launches, ops, seconds = [], [], [], []
    for i in range(1 + steps):
        if i == 0:
            step, args = prefill.step, (smodel, sbatch, scache)
        else:
            step, args = decode.step, (smodel, decode.shard(None, fed[i - 1])[1], scache, S + i - 1)
        held = {}
        slstm.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = analyze_step(lambda *a: held.setdefault("out", step(*a)), *args, mesh=mesh,
                             memory=False)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches.append(slstm.launches())
        ops.append(kernel_ops(stats).get("slstm", {"count": 0})["count"])
        logits, scache = held["out"]
        got.append(logits.full_tensor())

    def excess(ref):
        return max(float(((g - w).abs() - (SHARDED_ATOL + SHARDED_RTOL * w.abs())).max())
                   for g, w in zip(got, ref))

    def worst(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    model_dim = mesh.mesh_dim_names.index("model")
    out = {"prompt": [B, S], "decode_steps": steps, "layers": cfg.n_layers,
           "excess_plain": excess(want["plain"]), "excess_kernel": excess(want["kernel"]),
           "worst_abs_plain": worst(got, want["plain"]),
           "worst_abs_kernel": worst(got, want["kernel"]),
           "unsharded_kernel_vs_plain": worst(want["kernel"], want["plain"]),
           "reorder_sensitivity": worst(want["two_part"], want["kernel"]),
           "finite": all(bool(torch.isfinite(g).all()) for g in got),
           "launches": launches, "ops": ops,
           "prefill_s_counted": seconds[0], "decode_s_counted": seconds[1:],
           "placements": {f"{pos}.{k}": str(t.placements[model_dim])
                          for pos, c in scache["stack"].items() for k, t in c.items()}}
    del smodel, scache, got, want
    torch.cuda.empty_cache()
    return out


#: phase 34's ("data", "model") mesh by the world's ranks: 2 of the 4 heads a rank on 4 (regime
#: A); on 3 (phase 36(c)) the heads do not divide "model" (regime B: each block whole on every
#: rank, the dims that do not divide 3 left whole, as logical_to_spec leaves them)
XLSTM_MESHES = {4: (2, 2), 3: (1, 3), 1: (1, 1)}


def xlstm_rank(rank: int, world: int, store: str, out_path: str) -> dict:
    """Phase 34(b) and (c) on one rank (``cuda:rank``), in phase 31's world:
    a (2, 2) ("data", "model") mesh over 4 NCCL ranks with 4 cards (each
    rank 2 of the 4 heads), else a (1, 1) mesh over one; on 3 ranks (phase
    36(c)) a (1, 3) mesh.  Rank 0 writes the result to ``out_path``.  Every
    check raises on this rank."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import SyntheticLM, adamw, warmup_cosine

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    _build.load()
    dist.init_process_group("nccl", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        shape = XLSTM_MESHES[world]
        mesh = make_host_mesh(shape, ("data", "model"), device_type="cuda")
        cfg = dataclasses.replace(cut_depth(configs.get_config("xlstm-1.3b"), 1),
                                  compute_dtype="float32", serve_param_dtype="float32")
        res = {"rank": rank, "world": world, "mesh": list(shape)}
        res["serve"] = _xlstm_serve(cfg, mesh)
        data = SyntheticLM(cfg, XLSTM_TRAIN_B, XLSTM_TRAIN_S, seed=34)
        batches = [{k: v.cuda() for k, v in data.batch_at(i).items()}
                   for i in range(SHARDED_STEPS)]
        # AdamW with eps 1e-4 in float32, as phase 31
        res["train"] = _sharded_train(cfg, mesh, adamw(warmup_cosine(3e-4, 100, 1000), eps=1e-4),
                                      batches, 34, kernels=("slstm", "crossentropy"))
        every = [None] * world
        dist.all_gather_object(every, {"serve": res["serve"]["launches"],
                                       "train": res["train"]["launches"]})
        res["ranks"] = every
        if rank == 0:  # before the checks, so that a failing run shows its numbers
            print(f"  (b) {res['serve']}")
            t = res["train"]
            print(f"  (c) losses sharded {t['sharded_losses']} unsharded {t['plain_losses']}; "
                  f"params worst excess over atol+rtol {t['param_excess']:.3g} (outside: "
                  f"{t['params_outside'][:8]}); step s sharded {t['sharded_step_s']} unsharded "
                  f"{t['plain_step_s']}; steady sharded {t['sharded_steady_s']} unsharded "
                  f"{t['plain_steady_s']}; launches {t['launches']}; init bitwise "
                  f"{t['init_bitwise']}")
            print(f"  (b, c) sLSTM launches of each rank: {every}")
        check_xlstm(res)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    return res


def check_xlstm(res: dict) -> None:
    """Phase 34(b) and (c)'s assertions on one rank's result."""
    serve = res["serve"]
    assert serve["finite"], serve
    # a world of one computes the unsharded operations; split over "model" the float32 sums
    # run in another order, which the model amplifies (PERF.md, phase 34)
    allowance = 0.0 if res["world"] == 1 else XLSTM_REORDER_FACTOR * serve["reorder_sensitivity"]
    assert serve["excess_plain"] <= allowance, (serve["excess_plain"], allowance)
    assert serve["excess_kernel"] <= allowance, (serve["excess_kernel"], allowance)
    # one sLSTM block: one launch a prefill and one a decode step, each its op's count
    assert serve["launches"] == serve["ops"] == [1] * (1 + serve["decode_steps"]), serve
    # over heads where the 4 heads divide "model" (regime A), else never (regime B)
    heads = 4 % res["mesh"][1] == 0
    assert all((p == "S(2)") == heads for p in serve["placements"].values()), serve["placements"]
    train = res["train"]
    assert train["init_bitwise"], "gathered make_sharded_init differs from init_model_params"
    # remat reruns the superblock's forward: 2 sLSTM launches a step, 1 cross-entropy
    assert train["launches"] == {"slstm": 2 * SHARDED_STEPS, "crossentropy": SHARDED_STEPS}, train
    for got, want in zip(train["sharded_losses"], train["plain_losses"]):
        assert abs(got - want) <= SHARDED_ATOL + SHARDED_RTOL * abs(want), train
    assert not train["params_outside"], (train["params_outside"][:8], train["param_excess"])


def phase_xlstm_sharded(pool, pending) -> dict:
    """Phase 34: the xLSTM blocks under a mesh: (a) xlstm-1.3b's dry-run
    cells, (b) served and (c) trained on phase 31's world through the sLSTM
    kernel against the unsharded steps."""
    import shutil
    import tempfile

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    world, shape = sharded_world()
    print(f"phase 34: the xLSTM blocks under a mesh; (a) xlstm-1.3b's {len(XLSTM_CELLS)} dry-run "
          f"cells at full width, one superblock (7 mLSTM + 1 sLSTM); (b) served and (c) trained "
          f"at full width, one superblock, float32, world {world} in a {shape} ('data', 'model') "
          f"mesh ({torch.cuda.device_count()} card(s)); {nvidia_smi('name,power.limit')}")
    out = {"cells": _xlstm_cells(pool, pending)}
    tmp = tempfile.mkdtemp(prefix="phase34-", dir=os.path.join(ROOT, "build"))
    try:
        out["sharded"] = _run_world(world, tmp, xlstm_rank)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  {nvidia_smi('name,power.limit')}")
    return out


#: phase 35: qwen3-moe-235b-a22b at full width under phase 31's world.  (a) the sharded init at
#: this depth: its peak over the resident parameters and state within one layer slice of the
#: largest leaf (128 x 4096 x 1536 float32, 3.22 GB) plus this share
MOE_INIT_LAYERS = 4
MOE_INIT_SLACK = 0.10
#: (b) the sort dispatch, float32, one layer: 8 x 512 tokens in 8 microbatches of one row, at a
#: capacity factor of 0.5: a microbatch's 4096 (token, choice) pairs meet 128 experts x 16
#: slots, so at least half of them drop
MOE_SORT_B, MOE_SORT_S, MOE_SORT_M, MOE_SORT_CAPACITY = 8, 512, 8, 0.5
#: (b), (c): SGD without momentum or clipping at this constant rate, so that each step moves
#: the parameters by the rate times that step's gradients.  What changes is held leaf by leaf:
#: each step's gradients, over the leaf's largest |gradient| (the second step's at the weights
#: the first one wrote), within MOE_GRAD_TOL on one card; on several, within MOE_REORDER_FACTOR
#: times the model's own float32 sensitivity at that step (``moe_two_part_sums``: the unsharded
#: step with the sums that two model-axis ranks split taken in two parts and its microbatches in
#: reverse order, leaf by leaf against the unsharded gradients; the same factor as phase 34's).  With
#: Adafactor (qwen3-moe's own) on four cards (c)'s first gradients agreed within 7.9e-6 of each
#: leaf's largest, but at step 2 one token of 2048 chose another expert and five parameters
#: ended past atol + rtol (PERF.md; scripts/phase35_world.py --adafactor)
MOE_SGD_LR = 1e-2
MOE_GRAD_TOL = 1e-5
MOE_REORDER_FACTOR = XLSTM_REORDER_FACTOR
#: the measured sensitivity may not pass this, twice the largest of (b)'s readings on an H100
#: (9.223e-6 at step 2): a drift in the step fails the check instead of widening its bound
MOE_SENSITIVITY_CEILING = 2 * 9.223e-6
#: (c) with 4 cards: 4 rows in 4 microbatches, one row each; the two "data" shards run two of
#: them side by side, 2 iterations a step
MOE_THIN_B, MOE_THIN_M = 4, 4
#: (b) served: 2 prompts, then teacher-forced decode steps, float32 with float32 caches
MOE_SERVE_B, MOE_SERVE_S, MOE_SERVE_STEPS = 2, 256, 2
#: the checksum's chunk of elements, and the gradient check's
CHECKSUM_CHUNK = 1 << 26


def moe_thin_cell() -> dict:
    """Phase 35(d) in a worker process: qwen3-moe's ``train_4k`` on the
    multi-pod fake world ((2, 32, 8), 512 ranks; 8 microbatches of 32 rows,
    two side by side) at ``OPS_DRYRUN_LAYERS`` layers on fake CUDA tensors:
    memory a card, the roofline's terms, the kernels' op counts."""
    from repro_torch import configs
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.op_analysis import kernel_ops
    from repro_torch.launch.roofline import roofline_row

    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    t0 = time.perf_counter()
    rec = run_cell("qwen3-moe-235b-a22b", "train_4k", True, verbose=False, device="cuda",
                   out_dir=os.path.join(ROOT, "build", "phase35_dryrun"),
                   cfg=cut_depth(configs.get_config("qwen3-moe-235b-a22b"), OPS_DRYRUN_LAYERS))
    row = roofline_row(rec)
    kops = kernel_ops(rec["op_stats"])
    return {"n_chips": rec["n_chips"], "layers": OPS_DRYRUN_LAYERS,
            "memory": rec["memory"]["per_device_total"],
            "terms_s": {k: row[f"t_{k}_s"] for k in ("compute", "memory", "collective")},
            "largest": row["bottleneck"],
            "ops": {k: kops.get(k, {}).get("count", 0) for k in ("flash_attention", "crossentropy")},
            "collectives_by_dim": rec["op_stats"]["collectives_by_dim"],
            "seconds": time.perf_counter() - t0}


def start_moe_cell():
    """Phase 35(d)'s cell in a spawned process: ``(pool, pending result)``;
    the pool is terminated at exit if a phase fails before phase 35."""
    import atexit
    import multiprocessing as mp

    pool = mp.get_context("spawn").Pool(1)
    atexit.register(pool.terminate)
    pending = pool.apply_async(moe_thin_cell)
    pool.close()
    return pool, pending


def _bits_checksum(t: torch.Tensor) -> tuple:
    """Two 64-bit sums of a float32 tensor's bits, the second weighting
    element ``i`` by the odd ``2 i K + 1``: equal bits give equal sums, and
    a single element's change changes the second.  Two models of 45 GB do
    not fit one card together, so phase 35(a) compares these."""
    bits = t.detach().reshape(-1).view(torch.int32)
    total = weighted = 0
    for i in range(0, bits.numel(), CHECKSUM_CHUNK):
        b = bits[i:i + CHECKSUM_CHUNK].to(torch.int64)
        pos = torch.arange(i, i + b.numel(), dtype=torch.int64, device=b.device)
        total += int(b.sum())
        weighted += int((b * (pos * 5283711997 + 1)).sum())
    return total % 2**64, weighted % 2**64


def _moe_init(full, mesh, layers: int, bitwise: bool) -> dict:
    """Phase 35(a) on this rank: ``make_sharded_init`` of ``full`` at
    ``layers`` layers; its peak over the resident shards, and with
    ``bitwise`` the gathered parameters' checksums against
    ``init_model_params``' with the same seed."""
    from repro_torch.models import init_model_params
    from repro_torch.models.sharding import TRAIN_RULES
    from repro_torch.train import TrainConfig
    from repro_torch.train.train_loop import make_optimizer_for, make_sharded_init

    cfg = cut_depth(full, layers)
    opt = make_optimizer_for(cfg, TrainConfig())
    init, _, _ = make_sharded_init(cfg, opt, mesh, TRAIN_RULES)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (model, state), seconds = _synced(lambda: init(torch.Generator(device="cuda").manual_seed(35)))
    resident = _resident_bytes(list(model.parameters()) + list(_tree_leaves(state)))
    peak = torch.cuda.max_memory_allocated() - base
    slice_bytes = cfg.moe_experts * cfg.d_model * cfg.moe_d_ff * 4
    out = {"layers": layers, "seconds": seconds, "resident": resident, "peak": peak,
           "over_resident": peak - resident, "slice_bytes": slice_bytes,
           "leaf_bytes": slice_bytes * layers,
           "card_bytes": torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory}
    if bitwise:
        sums = {n: _bits_checksum(p.full_tensor()) for n, p in model.named_parameters()}
    del model, state
    torch.cuda.empty_cache()
    if bitwise:
        plain = init_model_params(cfg, torch.Generator(device="cuda").manual_seed(35), "cuda")
        out["init_bitwise"] = all([sums[n] == _bits_checksum(p)
                                   for n, p in plain.named_parameters()])
        del plain
        torch.cuda.empty_cache()
    return out


class _HalvesCE(torch.autograd.Function):
    """Per-token NLL over two halves of the vocabulary: the cross-entropy
    kernel on each half, the halves' ``lse`` combined by max and sum of
    exponentials and the label's logit taken from its half, the backward
    the written-out one of each half with the combined ``lse`` (dx summed,
    dW joined): the arithmetic of two model-axis ranks
    (``tensor_parallel._VocabParallelCE``) on one device."""

    @staticmethod
    def _halves(w, labels):
        V = w.shape[1]
        for lo, hi in ((0, V // 2), (V // 2, V)):
            lab = labels - lo
            yield w[:, lo:hi], torch.where((lab >= 0) & (lab < hi - lo), lab,
                                           torch.full_like(lab, -1))

    @staticmethod
    def forward(ctx, x, w, labels, cap):
        from repro_torch.kernels.crossentropy import crossentropy_forward

        nll, lse = zip(*(crossentropy_forward(x, wh, lab, cap)
                         for wh, lab in _HalvesCE._halves(w, labels)))
        m = torch.maximum(*lse)
        total = m + torch.log(torch.exp(lse[0] - m) + torch.exp(lse[1] - m))
        ctx.save_for_backward(x, w, labels, total)
        ctx.cap = cap
        return total - ((lse[0] - nll[0]) + (lse[1] - nll[1]))

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.crossentropy import crossentropy_backward

        x, w, labels, total = ctx.saved_tensors
        dx, dw = zip(*(crossentropy_backward(x, wh, lab, total, g, ctx.cap)
                       for wh, lab in _HalvesCE._halves(w, labels)))
        return dx[0] + dx[1], torch.cat(dw, dim=1), None, None


@contextlib.contextmanager
def moe_two_part_sums():
    """The one-device train step of a GQA + MoE model (qwen3-moe) with the
    sums that two model-axis ranks split taken in two parts: each attention
    block as two blocks over halves of its heads (q / k / v, flash and the
    output projection on each half, the outputs added), the MoE output over
    two halves of the experts (each half combined in ascending expert order,
    as a rank combines its experts), and the loss over two halves of the
    vocabulary (:class:`_HalvesCE`); their gradients follow by autograd.  A
    float32 reordering whose effect on the gradients measures how far the
    model itself amplifies such a change."""
    from types import SimpleNamespace

    from repro_torch.models import attention, moe, transformer

    block, sort, ce = attention.attn_block_full, moe._moe_sort, transformer.cross_entropy_chunked

    # halves by ``chunk``: its backward joins the halves' gradients in one buffer
    def split_attn(p, h, cfg, bdef, positions, cache=None, cache_index=None, engine="auto"):
        heads = zip(p.wq.chunk(2, 1), p.wk.chunk(2, 1), p.wv.chunk(2, 1), p.wo.chunk(2))
        return sum(block(SimpleNamespace(wq=q, wk=k, wv=v, wo=o), h, cfg, bdef, positions,
                         cache=cache, cache_index=cache_index, engine=engine)[0]
                   for q, k, v, o in heads), cache

    def split_sort(p, xt, w, idx, c, **kw):
        half = c.moe_experts // 2
        spans = ((0, half), (half, c.moe_experts))
        experts = zip(p.w1.chunk(2), p.w3.chunk(2), p.w2.chunk(2), spans)
        return sum(sort(SimpleNamespace(w1=w1, w3=w3, w2=w2), xt, w, idx, c, experts=span, **kw)
                   for w1, w3, w2, span in experts)

    def split_ce(x, w_out, labels, *, chunk=256, final_softcap=None, mask=None, engine="auto"):
        B, S, D = x.shape
        nll = _HalvesCE.apply(x.reshape(B * S, D), w_out, labels.reshape(B * S),
                              float(final_softcap or 0.0))
        if mask is None:
            return nll.sum() / max(B * S, 1)
        m = mask.reshape(B * S).to(torch.float32)
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)

    attention.attn_block_full, moe._moe_sort, transformer.cross_entropy_chunked = (
        split_attn, split_sort, split_ce)
    try:
        yield
    finally:
        attention.attn_block_full, moe._moe_sort, transformer.cross_entropy_chunked = block, sort, ce


def _reversed_microbatches(batch: dict, m: int) -> dict:
    """``batch`` with its ``m`` microbatches (contiguous rows) in reverse
    order: the same step, its microbatches' gradients summed the other way."""
    return {k: v.reshape(m, -1, *v.shape[1:]).flip(0).reshape(v.shape) for k, v in batch.items()}


def _with_grads(opt, hook):
    """``opt`` whose update first hands the step's gradients (before any
    clipping) to ``hook(step, grads)``."""
    def update(grads, state, params, step):
        hook(step, grads)
        return opt.update(grads, state, params, step)

    return dataclasses.replace(opt, update=update)


def _moe_train(cfg, mesh, B: int, m: int, opt=None, keep: bool = False) -> dict:
    """Phase 35(b) / (c) on this rank: ``SHARDED_STEPS`` float32 steps of
    the unsharded step, then of ``build_step``'s sharded step from the same
    weights (``make_sharded_init``), with ``m`` microbatches of ``B`` x
    ``MOE_SORT_S``, by default SGD at ``MOE_SGD_LR``.  The unsharded step's
    parameters and gradients wait on the host (the two models and their
    steps' gradients do not fit one card together); the sharded step's
    gradients are gathered a leaf at a time and held to them (``grads``:
    each step's worst ``|difference| / the leaf's largest |gradient|``, the
    leaves past ``MOE_GRAD_TOL``; the copies and checks are not in the step
    times).  The first
    sharded step is counted by ``analyze_step`` with the launch counters set
    to 0 just before it.  With ``keep``, ``"kept"`` also holds the unsharded
    gradients, the differences and the masks of the parameters' entries past
    atol + rtol (host tensors, not JSON).  Between the two, the unsharded
    step once more under ``moe_two_part_sums`` with its microbatches in
    reverse order, its gradients held to the first run's the same way:
    ``sensitivity``, each step's worst over the leaves."""
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels import crossentropy as ce
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.op_analysis import analyze_step, kernel_ops
    from repro_torch.launch.specs import build_step
    from repro_torch.models import init_model_params
    from repro_torch.models.sharding import TRAIN_RULES
    from repro_torch.train import SyntheticLM, constant_schedule, make_train_step, sgd
    from repro_torch.train.train_loop import make_sharded_init

    cfg = dataclasses.replace(cfg, train_microbatch=m)
    data = SyntheticLM(cfg, B, MOE_SORT_S, seed=35)
    batches = [{k: v.cuda() for k, v in data.batch_at(i).items()} for i in range(SHARDED_STEPS)]
    opt = opt or sgd(constant_schedule(MOE_SGD_LR), momentum=0.0, clip_norm=math.inf)
    plain_grads, diffs = [], []
    grads = {"rel": [], "check_s": [], "host_s": []}
    reordered = []

    def to_host(step, g):
        t0 = time.perf_counter()
        plain_grads.append({n: t.detach().to("cpu", copy=True) for n, t in g.items()})
        grads["host_s"].append(time.perf_counter() - t0)

    def relative(step, g, kept: bool) -> tuple:
        """``({leaf: max |g - unsharded| / max |unsharded|}, {leaf: difference} with kept)``."""
        rel, diff = {}, {}
        for n, t in g.items():
            got = (t.full_tensor() if isinstance(t, DTensor) else t).reshape(-1)
            want = plain_grads[step][n].reshape(-1)
            err = top = 0.0
            parts = []
            for a in range(0, want.numel(), CHECKSUM_CHUNK):  # a chunk on the card at a time
                w = want[a:a + CHECKSUM_CHUNK].cuda()
                d = got[a:a + CHECKSUM_CHUNK] - w
                err = max(err, float(torch.linalg.vector_norm(d, math.inf)))
                top = max(top, float(torch.linalg.vector_norm(w, math.inf)))
                if kept:
                    parts.append(d.cpu())
            rel[n] = err / top if top else (0.0 if err == 0 else math.inf)
            if kept:
                diff[n] = torch.cat(parts).view(t.shape)
            del got, want, parts
        return rel, diff

    def check(step, g):
        t0 = time.perf_counter()
        rel, diff = relative(step, g, keep)
        diffs.append(diff)
        grads["rel"].append(rel)
        grads["check_s"].append(time.perf_counter() - t0)

    def reorder(step, g):
        reordered.append(relative(step, g, False)[0])

    gen = lambda: torch.Generator(device="cuda").manual_seed(35)  # noqa: E731
    plain = init_model_params(cfg, gen(), "cuda")
    plain_opt = _with_grads(opt, to_host)
    plain_state = plain_opt.init(dict(plain.named_parameters()))
    plain_step = make_train_step(cfg, plain_opt, m)
    plain_losses, plain_norms, plain_s = [], [], []
    for i, batch in enumerate(batches):
        (plain, plain_state, met), s = _synced(lambda: plain_step(plain, plain_state, i, batch))
        plain_losses.append(float(met["loss"]))
        plain_norms.append(_scalar(met["grad_norm"]))
        plain_s.append(s - grads["host_s"][i])
    want = {n: p.detach().cpu() for n, p in plain.named_parameters()}
    del plain, plain_state
    torch.cuda.empty_cache()
    other = init_model_params(cfg, gen(), "cuda")
    other_opt = _with_grads(opt, reorder)
    other_state = other_opt.init(dict(other.named_parameters()))
    other_step = make_train_step(cfg, other_opt, m)
    t0 = time.perf_counter()
    with moe_two_part_sums():
        for i, batch in enumerate(batches):
            other, other_state, _ = other_step(other, other_state, i,
                                               _reversed_microbatches(batch, m))
    reorder_s = time.perf_counter() - t0
    del other, other_state
    torch.cuda.empty_cache()
    sopt = _with_grads(opt, check)
    init, _, _ = make_sharded_init(cfg, sopt, mesh, TRAIN_RULES)
    smodel, sstate = init(gen())
    cell = build_step(cfg, "train_4k", mesh, opt=sopt)
    sbatches = [cell.shard(None, None, None, b)[3] for b in batches]
    losses, norms, seconds = [], [], []
    for i, sb in enumerate(sbatches):
        held = {}
        fa.reset_launches()
        ce.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            stats = analyze_step(lambda *a: held.setdefault("out", cell.step(*a)), smodel, sstate,
                                 i, sb, mesh=mesh, memory=False)
            launches = {"flash_attention": fa.launches(), "crossentropy": ce.launches()}
            kops = kernel_ops(stats)
            ops = {k: kops.get(k, {"count": 0})["count"] for k in launches}
            smodel, sstate, met = held["out"]
        else:
            smodel, sstate, met = cell.step(smodel, sstate, i, sb)
        losses.append(float(met["loss"]))
        norms.append(_scalar(met["grad_norm"]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0 - grads["check_s"][i])
    worst, bad, masks = -1.0, [], {}
    with torch.no_grad():
        for name, p in smodel.named_parameters():
            got, w = p.full_tensor(), want[name].cuda()
            past = (got - w).abs() - (SHARDED_ATOL + SHARDED_RTOL * w.abs())
            excess = float(past.max())
            worst = max(worst, excess)
            if excess > 0:
                bad.append(name)
                if keep:
                    masks[name] = (past > 0).cpu()
    del smodel, sstate, want
    torch.cuda.empty_cache()
    out = {"B": B, "S": MOE_SORT_S, "microbatch": m, "optimizer": opt.name,
           "plain_losses": plain_losses, "sharded_losses": losses,
           "plain_grad_norms": plain_norms, "sharded_grad_norms": norms,
           "grad_rel": grads["rel"], "grad_worst_rel": [max(r.values()) for r in grads["rel"]],
           "sensitivity": [max(r.values()) for r in reordered], "sensitivity_rel": reordered,
           "sensitivity_s": reorder_s,
           "grad_check_s": grads["check_s"], "grad_to_host_s": grads["host_s"],
           "plain_step_s": plain_s, "sharded_step_s": seconds,
           "launches": launches, "ops": ops, "param_excess": worst, "params_outside": bad}
    if keep:
        out["kept"] = {"plain_grads": plain_grads, "diffs": diffs, "outside": masks}
    return out


def _moe_serve(cfg, mesh) -> dict:
    """Phase 35(b) served on this rank: the unsharded ``Engine``'s prefill
    and decode steps on the plain versions (``engine="torch"``) against
    ``build_step``'s serving cells on ``mesh`` through the flash kernel,
    float32 with float32 caches; the sharded prefill counted by
    ``analyze_step`` with the launch counter set to 0 just before it."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.op_analysis import analyze_step, kernel_ops
    from repro_torch.launch.specs import build_step
    from repro_torch.models import init_cache, init_model_params
    from repro_torch.serve import Engine

    B, S, steps = MOE_SERVE_B, MOE_SERVE_S, MOE_SERVE_STEPS
    rng = np.random.RandomState(35)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab, (B, S))).cuda()
    fed = [torch.from_numpy(rng.randint(0, cfg.vocab, (B, 1))).cuda() for _ in range(steps)]
    gen = lambda: torch.Generator(device="cuda").manual_seed(35)  # noqa: E731
    f32_cache = lambda: init_cache(cfg, B, S + steps, torch.float32, device="cuda")  # noqa: E731
    engine = Engine(cfg, init_model_params(cfg, gen(), "cuda"), capacity=S + steps, slots=B,
                    engine="torch")
    logits, cache = engine._prefill(engine.model, {"tokens": prompt}, f32_cache())
    want = [logits]
    for i, tok in enumerate(fed):
        logits, cache = engine._decode(engine.model, tok, cache, S + i)
        want.append(logits)
    del engine, cache
    torch.cuda.empty_cache()
    prefill = build_step(cfg, "prefill_32k", mesh)
    decode = build_step(cfg, "decode_32k", mesh)
    smodel, sbatch, scache = prefill.shard(init_model_params(cfg, gen(), "cuda"),
                                           {"tokens": prompt}, f32_cache())
    held = {}
    fa.reset_launches()
    stats = analyze_step(lambda *a: held.setdefault("out", prefill.step(*a)), smodel, sbatch,
                         scache, mesh=mesh, memory=False)
    launches = fa.launches()
    ops = kernel_ops(stats).get("flash_attention", {"count": 0})["count"]
    logits, scache = held["out"]
    again = prefill.step(smodel, sbatch, prefill.shard(None, None, f32_cache())[2])[0]
    got = [logits.full_tensor()]
    same_bits = torch.equal(got[0], again.full_tensor())
    for i, tok in enumerate(fed):
        logits, scache = decode.step(smodel, decode.shard(None, tok)[1], scache, S + i)
        got.append(logits.full_tensor())
    excess = max(float(((g - w).abs() - (SHARDED_ATOL + SHARDED_RTOL * w.abs())).max())
                 for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    del smodel, scache, held, again
    torch.cuda.empty_cache()
    return {"prompt": [B, S], "decode_steps": steps, "excess": excess, "finite": finite,
            "same_bits": same_bits, "launches": launches, "ops": ops}


def moe_rank(rank: int, world: int, store: str, out_path: str) -> dict:
    """Phase 35(a)-(c) on one rank (``cuda:rank``), in phase 31's world: a
    (2, 2) ("data", "model") mesh over 4 NCCL ranks with 4 cards (the batch
    over "data", 64 experts a rank), else a (1, 1) mesh over one; rank 0
    writes the result to ``out_path``.  Every check raises on this rank."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    _build.load()
    dist.init_process_group("nccl", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        shape = (2, 2) if world == 4 else (1, 1)
        mesh = make_host_mesh(shape, ("data", "model"), device_type="cuda")
        full = configs.get_config("qwen3-moe-235b-a22b")
        res = {"rank": rank, "world": world, "mesh": list(shape)}
        res["init"] = _moe_init(full, mesh, MOE_INIT_LAYERS, bitwise=True)
        if world == 4:  # the least depth at which one stacked expert leaf outgrows a card
            card = res["init"]["card_bytes"]
            res["init_large"] = _moe_init(full, mesh, card // res["init"]["slice_bytes"] + 1,
                                          bitwise=False)
        cfg = dataclasses.replace(cut_depth(full, 1), compute_dtype="float32",
                                  serve_param_dtype="float32", moe_dispatch="sort",
                                  moe_capacity=MOE_SORT_CAPACITY)
        res["train"] = _moe_train(cfg, mesh, MOE_SORT_B, MOE_SORT_M)
        if world == 4:
            res["thin"] = _moe_train(cfg, mesh, MOE_THIN_B, MOE_THIN_M)
        res["serve"] = _moe_serve(cfg, mesh)
        every = [None] * world
        dist.all_gather_object(every, {"train": res["train"]["launches"],
                                       "serve": res["serve"]["launches"]})
        res["ranks"] = every
        if rank == 0:  # before the checks, so that a failing run shows its numbers
            gib = 2.0**30
            for key in ("init", "init_large"):
                if key in res:
                    r = res[key]
                    print(f"  (a) {r['layers']} layers: make_sharded_init {r['seconds']:.2f} s; "
                          f"rank 0 resident {r['resident'] / gib:.3f} GiB, peak "
                          f"{r['peak'] / gib:.3f} GiB, over the resident "
                          f"{r['over_resident'] / gib:.3f} GiB against one layer slice "
                          f"{r['slice_bytes'] / gib:.3f} GiB (a stacked expert leaf "
                          f"{r['leaf_bytes'] / gib:.3f} GiB, the card "
                          f"{r['card_bytes'] / gib:.3f} GiB); gathered checksums equal "
                          f"init_model_params': {r.get('init_bitwise', 'not checked')}")
            for key in ("train", "thin"):
                if key in res:
                    print(f"  ({'b' if key == 'train' else 'c'}) {res[key]}")
            print(f"  (b) served: {res['serve']}")
            print(f"  (b) flash / CE launches a rank: {every}")
        check_moe(res)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    return res


def grad_bounds(r: dict, world: int) -> list:
    """Each step's bound on a leaf's gradient gap over its largest
    |gradient|: ``MOE_GRAD_TOL`` in a world of one (the same operations
    in another order), else ``MOE_REORDER_FACTOR`` x the step's measured
    sensitivity.  A sensitivity past ``MOE_SENSITIVITY_CEILING`` fails."""
    assert max(r["sensitivity"]) <= MOE_SENSITIVITY_CEILING, (r["sensitivity"],
                                                              MOE_SENSITIVITY_CEILING)
    if world == 1:
        return [MOE_GRAD_TOL] * len(r["grad_rel"])
    return [MOE_REORDER_FACTOR * s for s in r["sensitivity"]]


def grads_outside(r: dict, world: int) -> list:
    """Each step's leaves whose gradient gap is past :func:`grad_bounds`."""
    return [sorted(n for n, v in rel.items() if v > bound)
            for rel, bound in zip(r["grad_rel"], grad_bounds(r, world))]


def check_moe(res: dict) -> None:
    """Phase 35(a)-(c)'s assertions on one rank's result."""
    for key in ("init", "init_large"):
        if key in res:
            r = res[key]
            assert r["over_resident"] <= (1 + MOE_INIT_SLACK) * r["slice_bytes"], (key, r)
    assert res["init"]["init_bitwise"], res["init"]
    if "init_large" in res:
        assert res["init_large"]["leaf_bytes"] > res["init_large"]["card_bytes"], res["init_large"]
    data = res["mesh"][0]
    for key in ("train", "thin"):
        if key not in res:
            continue
        r = res[key]
        for got, want in zip(r["sharded_losses"] + r["sharded_grad_norms"],
                             r["plain_losses"] + r["plain_grad_norms"]):
            assert abs(got - want) <= SHARDED_ATOL + SHARDED_RTOL * abs(want), (key, r)
        outside = grads_outside(r, res["world"])
        assert not any(outside), (key, outside, r["grad_worst_rel"], r["sensitivity"])
        assert not r["params_outside"], (key, r["params_outside"][:8], r["param_excess"])
        # the rows of a microbatch over the "data" shards, or one microbatch a shard side by
        # side (train_loop._rows); one layer: 2 flash launches an iteration (remat), 1 CE
        side = 1 if (r["B"] // r["microbatch"]) % data == 0 else data
        iterations = r["microbatch"] // side
        assert r["launches"] == r["ops"] == {"flash_attention": 2 * iterations,
                                             "crossentropy": iterations}, (key, r)
    serve = res["serve"]
    assert serve["finite"] and serve["same_bits"], serve
    assert serve["excess"] <= 0.0, serve
    assert serve["launches"] == serve["ops"] == 1, serve  # one attention layer a prefill


def _moe_cell(pool, pending) -> dict:
    """Phase 35(d): the 512-card cell's result, printed and checked."""
    from repro_torch.launch.roofline import HBM_BYTES

    t0 = time.perf_counter()
    row = pending.get()
    pool.join()
    terms = ", ".join(f"{k} {v:.4g} s" for k, v in row["terms_s"].items())
    print(f"  (d) qwen3-moe-235b-a22b train_4k on {row['n_chips']} fake ranks (2, 32, 8), "
          f"{row['layers']} layers: {row['memory'] / 2**30:.3f} GiB a card; largest term "
          f"{row['largest']} ({terms}); kernel ops {row['ops']}; collectives "
          f"{row['collectives_by_dim']}; {row['seconds']:.1f} s in its worker, waited "
          f"{time.perf_counter() - t0:.1f} s")
    assert row["memory"] < HBM_BYTES, row
    # 8 microbatches, 2 side by side: 4 iterations, a loss and 2 flash launches a layer each
    assert row["ops"] == {"flash_attention": 2 * row["layers"] * 4, "crossentropy": 4}, row
    return row


def phase_moe_sharded(pool, pending) -> dict:
    """Phase 35: MoE training under a mesh at qwen3-moe-235b-a22b's full
    width: (a) the born-sharded init's peak, (b) the sort dispatch trained
    (8 microbatches) and served on phase 31's world against the unsharded
    steps, (c) with 4 cards thin microbatches side by side, (d) the
    512-card train cell on fake ranks."""
    import shutil
    import tempfile

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    world, shape = sharded_world()
    print(f"phase 35: qwen3-moe-235b-a22b under a mesh at full width; (a) make_sharded_init at "
          f"{MOE_INIT_LAYERS} layers; (b) the sort dispatch at capacity {MOE_SORT_CAPACITY}, one "
          f"layer, float32: {SHARDED_STEPS} SGD steps of {MOE_SORT_B} x {MOE_SORT_S} in "
          f"{MOE_SORT_M} microbatches, a prefill of {MOE_SERVE_B} x {MOE_SERVE_S} and "
          f"{MOE_SERVE_STEPS} decode steps; world {world} in a {shape} ('data', 'model') mesh "
          f"({torch.cuda.device_count()} card(s)); (d) train_4k on 512 fake ranks at "
          f"{OPS_DRYRUN_LAYERS} layers; {nvidia_smi('name,power.limit')}")
    tmp = tempfile.mkdtemp(prefix="phase35-", dir=os.path.join(ROOT, "build"))
    try:
        out = {"sharded": _run_world(world, tmp, moe_rank)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["cell"] = _moe_cell(pool, pending)
    print(f"  {nvidia_smi('name,power.limit')}")
    return out


#: phase 36(a): llava-next-34b's prefill_32k on (2, 32, 8) = 512 fake ranks at full width and
#: depth on fake CUDA tensors, in a worker process started after the build (host-bound, no card):
#: the batch of 32 divides "pod" but not "pod" x "data", so a rank holds 16 rows of 32768
#: positions; the memory rule's estimate at the chosen row chunks no lower than the measured
#: peak and at most this many times it
ROWS_RULE_SLACK = 1.5
#: phase 36(b): llava at full width cut to 2 layers, float32 weights, compute and cache: 4 rows
#: of 4096 positions (the config's 1152 image embeddings and 2944 tokens), each rank's rows in
#: 2 chunks (a memory budget that asks for 2) and in one
ROWS_LAYERS, ROWS_B, ROWS_S, ROWS_CHUNKS = 2, 4, 4096, 2
#: phase 36(b), (c): the float32 flash kernel sums a row's keys in its own order, so the
#: unsharded model on the kernels lies a measured distance from it on the plain versions (its
#: float32 sensitivity to that order); the sharded steps may lie this many times that distance
#: beyond phase 31's bound from the plain versions (the factor of phases 34 and 35)
ROWS_REORDER_FACTOR = XLSTM_REORDER_FACTOR
#: (b): that distance may not pass this, twice the larger of its readings on an H100 (logits
#: 2.4766e-5, cache 2.4796e-5): a drift fails the check instead of widening its bound
ROWS_SENSITIVITY_CEILING = 2 * 2.4796e-5
#: phase 36(c), with 4 cards: gemma2-9b at 2 layers with a long_500k cache of 524288 rows split
#: over "data" (262144 a shard) on (1, 2, 2): a prefill of this many tokens ending at the shard
#: boundary, then decode steps past it
BOUNDARY_PROMPT, BOUNDARY_STEPS = 8, 16
#: (c): each step's distance between the kernels and the plain versions may not pass twice its
#: largest reading on an H100: the prefill's 2.5392e-5, a decode step's 2.1458e-6
BOUNDARY_SENSITIVITY_CEILING = (2 * 2.5392e-5, 2 * 2.1458e-6)


def llava_rows_cell() -> dict:
    """Phase 36(a) in a worker process: ``launch.dryrun.run_cell`` of
    llava-next-34b's ``prefill_32k`` on the multi-pod fake world at full
    width and depth on fake CUDA tensors: the rows' chunks, memory a card
    and the memory rule's estimate, the flash op's count, the roofline's
    terms, collective bytes by mesh dim."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.op_analysis import kernel_ops
    from repro_torch.launch.roofline import roofline_row

    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    t0 = time.perf_counter()
    rec = run_cell("llava-next-34b", "prefill_32k", True, verbose=False, device="cuda",
                   out_dir=os.path.join(ROOT, "build", "phase36_dryrun"))
    row = roofline_row(rec)
    return {"n_chips": rec["n_chips"], "row_chunks": rec["row_chunks"],
            "memory": rec["memory"]["per_device_total"], "memory_rule": rec["memory_rule"],
            "terms_s": {k: row[f"t_{k}_s"] for k in ("compute", "memory", "collective")},
            "largest": row["bottleneck"],
            "flash_ops": kernel_ops(rec["op_stats"]).get("flash_attention", {}).get("count", 0),
            "collective_bytes": rec["op_stats"]["collective_bytes"],
            "collectives_by_dim": rec["op_stats"]["collectives_by_dim"],
            "seconds": time.perf_counter() - t0}


def start_llava_rows_cell():
    """Phase 36(a)'s cell in a spawned process: ``(pool, pending result)``;
    the pool is terminated at exit if a phase fails before phase 36."""
    import atexit
    import multiprocessing as mp

    pool = mp.get_context("spawn").Pool(1)
    atexit.register(pool.terminate)
    pending = pool.apply_async(llava_rows_cell)
    pool.close()
    return pool, pending


def _llava_rows_cell(pool, pending) -> dict:
    """Phase 36(a): the 512-card prefill cell's result, printed and checked."""
    from repro_torch import configs
    from repro_torch.launch.roofline import HBM_BYTES

    t0 = time.perf_counter()
    row = pending.get()
    pool.join()
    gib = 2.0**30
    terms = ", ".join(f"{k} {v:.4g} s" for k, v in row["terms_s"].items())
    print(f"  (a) llava-next-34b prefill_32k on {row['n_chips']} fake ranks (2, 32, 8), 60 layers: "
          f"{row['row_chunks']} row chunks a rank; per_device_total {row['memory']:.0f} B "
          f"({row['memory'] / gib:.2f} GiB) against {HBM_BYTES:.0f}; the rule's estimate "
          f"{row['memory_rule']:.0f} B ({row['memory_rule'] / gib:.2f} GiB, "
          f"{row['memory_rule'] / row['memory']:.3f}x the measured peak); flash ops "
          f"{row['flash_ops']}; largest term {row['largest']} ({terms}); collective bytes "
          f"{row['collective_bytes']:.6g} {row['collectives_by_dim']}; {row['seconds']:.1f} s in "
          f"its worker, waited {time.perf_counter() - t0:.1f} s")
    assert row["row_chunks"] >= 2, row
    assert row["memory"] <= HBM_BYTES, row  # fits
    assert row["memory"] <= row["memory_rule"] <= ROWS_RULE_SLACK * row["memory"], row
    # one flash launch a layer a chunk
    layers = configs.get_config("llava-next-34b").n_layers
    assert row["flash_ops"] == layers * row["row_chunks"], row
    return row


def _past(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ``|got - want|`` beyond phase 31's float32 bound."""
    return float(((got - want).abs() - (SHARDED_ATOL + SHARDED_RTOL * want.abs())).max())


def _llava_rows(cfg, mesh) -> dict:
    """Phase 36(b) on this rank: ``build_step``'s prefill cell on ``mesh``
    through the flash kernel, with each rank's rows in one chunk and in
    ``ROWS_CHUNKS`` (``memory_budget`` set to the rule's estimate for this
    batch at that count), float32 with a float32 cache, against the
    unsharded ``Engine``'s prefill on the plain versions (``engine="torch"``)
    and on the kernels (``"cuda"``), whose distance is the model's own
    float32 sensitivity to the kernel's order of the attention's sums; each
    sharded step counted by ``analyze_step`` with the launch counter set to
    0 just before it, and its ``max_memory_allocated`` over the memory held
    before it."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.op_analysis import analyze_step, kernel_ops
    from repro_torch.launch.roofline import HBM_BYTES
    from repro_torch.launch.specs import build_step, prefill_peak_bytes
    from repro_torch.models import init_cache, init_model_params
    from repro_torch.serve import Engine

    B, S = ROWS_B, ROWS_S
    rng = np.random.RandomState(36)
    batch = {"tokens": torch.from_numpy(rng.randint(0, cfg.vocab, (B, S - cfg.img_tokens))).cuda(),
             "image_embeds": torch.from_numpy(rng.standard_normal(
                 (B, cfg.img_tokens, cfg.d_model)).astype(np.float32)).cuda()}
    gen = lambda: torch.Generator(device="cuda").manual_seed(36)  # noqa: E731
    f32_cache = lambda: init_cache(cfg, B, S, torch.float32, device="cuda")  # noqa: E731

    def kv_leaves(cache):
        return [t.full_tensor() if hasattr(t, "full_tensor") else t.clone()
                for c in cache["stack"].values() for t in c.values()]

    ref = {}
    for key in ("torch", "cuda"):
        engine = Engine(cfg, init_model_params(cfg, gen(), "cuda"), capacity=S, slots=B,
                        engine=key)
        logits, cache = engine._prefill(engine.model, batch, f32_cache())
        ref[key] = (logits, kv_leaves(cache))
        del engine, cache
        torch.cuda.empty_cache()
    (want, want_kv), (kernel, kernel_kv) = ref["torch"], ref["cuda"]
    plain = build_step(cfg, "prefill_32k", mesh)
    budget = prefill_peak_bytes(cfg, (B, S), mesh, plain.rules, ROWS_CHUNKS)
    smodel = None
    out = {"layers": cfg.n_layers, "rows": [B, S], "image_embeds": cfg.img_tokens,
           "sensitivity": float((kernel - want).abs().max()),
           "cache_sensitivity": max(float((k - w).abs().max())
                                    for k, w in zip(kernel_kv, want_kv)),
           "kernel_engine_excess": _past(kernel, want)}
    for cell, limit in ((plain, HBM_BYTES), (build_step(cfg, "prefill_32k", mesh,
                                                        memory_budget=budget), budget)):
        if smodel is None:
            smodel, sbatch, _ = cell.shard(init_model_params(cfg, gen(), "cuda"), batch, None)
        scache = cell.shard(None, None, f32_cache())[2]
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        held = {}
        fa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = analyze_step(lambda *a: held.setdefault("out", cell.step(*a)), smodel, sbatch,
                             scache, mesh=mesh, memory=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        logits, scache = held["out"]
        got, got_kv = logits.full_tensor(), kv_leaves(scache)
        chunks, rule = cell.plans[B, S]  # the step's own decision
        out[f"R{chunks}"] = {
            "row_chunks": chunks, "budget": limit, "rule": rule,
            "local_rows": sbatch["tokens"].to_local().shape[0],
            "launches": fa.launches(),
            "ops": kernel_ops(stats).get("flash_attention", {"count": 0})["count"],
            "excess": _past(got, want), "worst_abs": float((got - want).abs().max()),
            "cache_excess": max(_past(g, w) for g, w in zip(got_kv, want_kv)),
            "kernel_excess": _past(got, kernel),
            "kernel_worst_abs": float((got - kernel).abs().max()),
            "kernel_cache_excess": max(_past(g, w) for g, w in zip(got_kv, kernel_kv)),
            "finite": bool(torch.isfinite(got).all()),
            "peak_bytes": peak, "peak_over_held": peak - base, "seconds": seconds}
        del held, logits, scache, got, got_kv
    del smodel, sbatch
    torch.cuda.empty_cache()
    return out


def rows_rank(rank: int, world: int, store: str, out_path: str) -> dict:
    """Phase 36(b) on one rank (``cuda:rank``), in phase 31's world: a (1, 2,
    2) ("pod", "data", "model") mesh over 4 NCCL ranks with 4 cards (the 4
    rows over "data", 2 a rank), else a (1, 1, 1) mesh over one; rank 0
    writes the result to ``out_path``.  Every check raises on this rank."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    _build.load()
    dist.init_process_group("nccl", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        shape = (1, 2, 2) if world == 4 else (1, 1, 1)
        mesh = make_host_mesh(shape, ("pod", "data", "model"), device_type="cuda")
        cfg = dataclasses.replace(cut_depth(configs.get_config("llava-next-34b"), ROWS_LAYERS),
                                  compute_dtype="float32", serve_param_dtype="float32")
        res = {"rank": rank, "world": world, "mesh": list(shape), "rows": _llava_rows(cfg, mesh)}
        every = [None] * world
        dist.all_gather_object(every, {k: {"launches": v["launches"], "ops": v["ops"],
                                           "peak_bytes": v["peak_bytes"]}
                                       for k, v in res["rows"].items() if k.startswith("R")})
        res["ranks"] = every
        if rank == 0:  # before the checks, so that a failing run shows its numbers
            gib = 2.0**30
            for key, r in res["rows"].items():
                if key.startswith("R"):
                    print(f"  (b) {key}: {r}; peak {r['peak_bytes'] / gib:.3f} GiB "
                          f"({r['peak_over_held'] / gib:.3f} over the memory held before the step)")
            print(f"  (b) flash launches and peaks of each rank: {every}")
        check_rows(res)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    return res


def check_rows(res: dict) -> None:
    """Phase 36(b)'s assertions on one rank's result, for both chunkings:
    logits and every KV cache leaf within phase 31's float32 bound of the
    unsharded ``Engine`` on the plain versions plus ``ROWS_REORDER_FACTOR``
    times the model's own sensitivity, and on a world of one (the same
    operations) within the bound of the ``Engine`` on the kernels; one
    flash launch a layer a chunk, each its op's count; the chunked step's
    peak below the unchunked one's; the sensitivity under
    ``ROWS_SENSITIVITY_CEILING``."""
    r = res["rows"]
    one, more = r["R1"], r[f"R{ROWS_CHUNKS}"]
    assert max(r["sensitivity"], r["cache_sensitivity"]) <= ROWS_SENSITIVITY_CEILING, r
    allow, allow_kv = (ROWS_REORDER_FACTOR * r[k] for k in ("sensitivity", "cache_sensitivity"))
    for got in (one, more):
        assert got["finite"] and got["excess"] <= allow and got["cache_excess"] <= allow_kv, (
            got, allow, allow_kv)
        if res["world"] == 1:
            assert got["kernel_excess"] <= 0.0 and got["kernel_cache_excess"] <= 0.0, got
        assert got["launches"] == got["ops"] == r["layers"] * got["row_chunks"], got
    assert more["local_rows"] % ROWS_CHUNKS == 0, more
    assert more["peak_over_held"] < one["peak_over_held"], (one, more)


def _gemma2_boundary(mesh) -> dict:
    """Phase 36(c) on this rank: gemma2-9b (one window and one global layer)
    with a float32 cache of long_500k's 524288 rows filled with seeded
    values, the prompt prefilled from cache index 262136 and then decode
    steps across row 262144 (the "data" shard boundary); the sharded steps
    through the flash kernel against the unsharded ``Engine``'s model and
    decode step on the plain versions and on the kernels (their distance the
    model's own float32 sensitivity to the kernel's order), step by step;
    and the KV rows (ring slots) of the positions written, each rank's
    shard of them against the plain ``Engine``'s cache.  The window
    layer's ring is prefilled as from index 0, in all three (the one-device
    block's rule)."""
    from torch.distributed.tensor import Shard

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.specs import build_step
    from repro_torch.models import (SHAPES, forward, init_cache, init_model_params,
                                    logits_from_hidden)
    from repro_torch.models.sharding import wrap_with_sharding_ctx
    from repro_torch.serve import Engine

    cfg = dataclasses.replace(two_layers(configs.get_config("gemma2-9b")),
                              compute_dtype="float32", serve_param_dtype="float32")
    capacity = SHAPES["long_500k"].seq_len
    first = capacity // 2 - BOUNDARY_PROMPT
    rng = np.random.RandomState(36)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab, (1, BOUNDARY_PROMPT))).cuda()
    fed = [torch.from_numpy(rng.randint(0, cfg.vocab, (1, 1))).cuda()
           for _ in range(BOUNDARY_STEPS)]
    gen = lambda: torch.Generator(device="cuda").manual_seed(36)  # noqa: E731

    def filled():
        cache = init_cache(cfg, 1, capacity, torch.float32, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(360)
        for c in cache["stack"].values():
            for t in c.values():
                t.normal_(generator=g)
        return cache

    def prefill_at(model, tokens, cache, ci, engine="auto"):
        with torch.no_grad():
            x, cache, _ = forward(model, {"tokens": tokens}, cache=cache, cache_index=ci,
                                  mode="prefill", engine=engine)
            return logits_from_hidden(model, x[:, -1:]), cache

    last = first + BOUNDARY_PROMPT + BOUNDARY_STEPS - 1

    def slots(rows: int) -> list:  # the rows (ring slots) of the positions written
        return sorted({p % rows for p in range(first, last + 1)})

    ref, ref_kv = {}, {}
    for key in ("torch", "cuda"):
        engine = Engine(cfg, init_model_params(cfg, gen(), "cuda"), capacity=capacity, slots=1,
                        engine=key)
        logits, cache = prefill_at(engine.model, prompt, filled(), first, engine=key)
        ref[key] = [logits]
        for i, tok in enumerate(fed):
            logits, cache = engine._decode(engine.model, tok, cache, first + BOUNDARY_PROMPT + i)
            ref[key].append(logits)
        ref_kv[key] = {pos: {name: t[:, :, slots(t.shape[2])].clone() for name, t in c.items()}
                       for pos, c in cache["stack"].items()}
        del engine, cache
        torch.cuda.empty_cache()
    want, kernel = ref["torch"], ref["cuda"]
    cell = build_step(cfg, "long_500k", mesh)
    step = wrap_with_sharding_ctx(prefill_at, mesh, cell.rules)
    smodel, _, scache, _ = cell.shard(init_model_params(cfg, gen(), "cuda"), None, filled(), None)
    torch.cuda.empty_cache()
    fa.reset_launches()
    tokens = build_step(cfg, "prefill_32k", mesh).shard(None, {"tokens": prompt}, None)[1]
    logits, scache = step(smodel, tokens["tokens"], scache, first)
    launches = fa.launches()
    got = [logits.full_tensor()]
    for i, tok in enumerate(fed):
        logits, scache = cell.step(smodel, cell.shard(None, tok)[1], scache,
                                   first + BOUNDARY_PROMPT + i)
        got.append(logits.full_tensor())
    data = mesh.mesh_dim_names.index("data")
    kv = scache["stack"]
    cache_excess, cache_rows = -math.inf, {}
    for pos, c in kv.items():
        for name, t in c.items():
            local, off = t.to_local(), _shard_offsets(t)  # rows along dim 2
            mine = [slice(o, o + n) for o, n in zip(off, local.shape)]
            mine[2] = slice(None)
            whole = ref_kv["torch"][pos][name][tuple(mine)]
            for j, slot in enumerate(slots(t.shape[2])):
                if off[2] <= slot < off[2] + local.shape[2]:
                    cache_excess = max(cache_excess, _past(local.select(2, slot - off[2]),
                                                           whole.select(2, j)))
                    cache_rows.setdefault(pos, set()).add(slot)
    out = {"capacity": capacity, "prefill_from": first, "decode_to": last,
           "cache_excess": cache_excess,
           "cache_rows": {pos: sorted(rows) for pos, rows in cache_rows.items()},
           "cache_sensitivity": max(float((ref_kv["cuda"][pos][n] - t).abs().max())
                                    for pos, c in ref_kv["torch"].items() for n, t in c.items()),
           "excess": max(_past(g, w) for g, w in zip(got, want)),
           "excess_by_step": [_past(g, w) for g, w in zip(got, want)],
           "worst_abs": max(float((g - w).abs().max()) for g, w in zip(got, want)),
           "sensitivity": max(float((k - w).abs().max()) for k, w in zip(kernel, want)),
           "sensitivity_by_step": [float((k - w).abs().max()) for k, w in zip(kernel, want)],
           "kernel_excess": max(_past(g, k) for g, k in zip(got, kernel)),
           "finite": all(bool(torch.isfinite(g).all()) for g in got), "launches": launches,
           "local_rows": {pos: c["k"].to_local().shape[2] for pos, c in kv.items()},
           "rows": {pos: c["k"].shape[2] for pos, c in kv.items()},
           "placements": {pos: str(c["k"].placements) for pos, c in kv.items()},
           "data_split": {pos: c["k"].placements[data] == Shard(2) for pos, c in kv.items()}}
    del smodel, scache
    torch.cuda.empty_cache()
    return out


def _shard_offsets(t) -> list:
    """Each dim's global offset of this rank's shard of the DTensor ``t``
    (even splits; a dim split over several mesh dims in mesh order, the
    first the major one)."""
    from torch.distributed.tensor import Shard

    local = t.to_local()
    index = [0] * t.dim()
    for size, coord, p in zip(t.device_mesh.shape, t.device_mesh.get_coordinate(), t.placements):
        if isinstance(p, Shard):
            index[p.dim] = index[p.dim] * size + coord
    return [i * n for i, n in zip(index, local.shape)]


def boundary_rank(rank: int, world: int, store: str, out_path: str) -> dict:
    """Phase 36(c)'s gemma2 boundary on one of 4 ranks, a (1, 2, 2) mesh;
    rank 0 writes the result to ``out_path``.  Every check raises."""
    import torch.distributed as dist

    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    _build.load()
    dist.init_process_group("nccl", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        mesh = make_host_mesh((1, 2, 2), ("pod", "data", "model"), device_type="cuda")
        res = {"rank": rank, "world": world, "boundary": _gemma2_boundary(mesh)}
        every = [None] * world
        dist.all_gather_object(every, {k: res["boundary"][k] for k in ("cache_excess",
                                                                       "cache_rows")})
        res["ranks"] = every
        if rank == 0:
            print(f"  (c) gemma2-9b across the shard boundary: {res['boundary']}")
            print(f"  (c) each rank's KV rows of the positions written against the plain "
                  f"Engine's: {every}")
        r = res["boundary"]
        # each step within ROWS_REORDER_FACTOR x its own distance between the kernels and the
        # plain versions, that distance under its ceiling
        for i, (excess, sens) in enumerate(zip(r["excess_by_step"], r["sensitivity_by_step"])):
            assert sens <= BOUNDARY_SENSITIVITY_CEILING[min(i, 1)], (i, r)
            assert excess <= ROWS_REORDER_FACTOR * sens, (i, r)
        assert r["finite"], r
        # the written KV rows on every rank within phase 31's bound of the plain Engine's, and
        # the global layer's rows 262136 .. 262159 held on both sides of its "data" boundary
        assert all(e["cache_excess"] <= 0.0 for e in every), every
        held = set().union(*(e["cache_rows"].get("1", ()) for e in every))
        assert held == set(range(r["prefill_from"], r["decode_to"] + 1)), (held, every)
        # the global layer's rows split over "data" at 262144; the prefill ends there
        assert r["local_rows"]["1"] * 2 == r["rows"]["1"] == r["capacity"], r
        assert r["prefill_from"] + BOUNDARY_PROMPT == r["capacity"] // 2 < r["decode_to"], r
        assert r["data_split"]["1"], r
        assert r["launches"] == 2, r  # one flash launch a layer in the prefill
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    return res


def prefill_rows_worlds() -> list:
    """Phase 36(b), (c): ``(key, ranks, rank function)`` of each world this
    machine's cards allow."""
    world, _ = sharded_world()
    worlds = [("rows", world, rows_rank)]
    if torch.cuda.device_count() >= 4:
        worlds += [("xlstm_regime_b", 3, xlstm_rank), ("boundary", 4, boundary_rank)]
    return worlds


def prefill_rows_world(key: str, ranks: int, rank_fn) -> dict:
    """One of :func:`prefill_rows_worlds`, run: rank 0's result."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix=f"phase36-{key}-", dir=os.path.join(ROOT, "build"))
    try:
        return _run_world(ranks, tmp, rank_fn)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_prefill_rows(pool, pending) -> dict:
    """Phase 36: a prefill's rows in chunks by the memory rule: (a) llava's
    512-card ``prefill_32k`` on fake ranks, (b) llava at full width, 2
    layers, in phase 31's world through the kernels against the unsharded
    ``Engine``; (c) with 4 cards, xlstm-1.3b's regime (B) on 3 ranks ((1,
    3): 4 heads do not divide 3) and gemma2-9b's long_500k cache crossing
    its "data" shard boundary on 4."""
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    world, _ = sharded_world()
    cards = torch.cuda.device_count()
    print(f"phase 36: a prefill's rows in chunks where the memory rule asks for them; (a) "
          f"llava-next-34b prefill_32k on 512 fake ranks; (b) llava at full width, "
          f"{ROWS_LAYERS} layers, float32, {ROWS_B} rows of {ROWS_S} positions in 1 and "
          f"{ROWS_CHUNKS} chunks a rank, world {world} ({cards} card(s)); (c) with 4 cards "
          f"xlstm-1.3b's regime (B) on 3 ranks and gemma2-9b's long_500k boundary on 4; "
          f"{nvidia_smi('name,power.limit')}")
    out = {key: prefill_rows_world(key, n, fn) for key, n, fn in prefill_rows_worlds()}
    if cards < 4:
        print(f"  (c) not run: it needs 4 cards, this machine has {cards}")
    out["cell"] = _llava_rows_cell(pool, pending)
    print(f"  {nvidia_smi('name,power.limit')}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    opts = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    # phase 1: device and build
    smi = nvidia_smi("name,power.limit")
    print(smi)
    sm_clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"max SM clock {sm_clock_hz / 1e6:.0f} MHz")
    _build.load()
    print(f"phase 1: kernels built and loaded in {_build.build_seconds():.2f} s")
    for line in _build.build_log().splitlines():
        if "ptxas" in line:
            print(f"  {line.strip()}")
    sass = tensor_core_sass()
    print("  tensor-core instructions (HMMA / HGMMA) in the SASS of the bf16 kernels:")
    for name, count in sass.items():
        print(f"    {name}: {count}")
    if "not available" not in sass:
        assert sass and all(n > 0 for n in sass.values()), sass
        assert any("ssd_tc_kernel" in name for name in sass), sass
    for key, lines in ssd_ptxas(_build.build_log()).items():
        if key.startswith("bfloat16"):
            print(f"  ptxas ssd ({key}): {'; '.join(lines)}")

    phase_s = {"1": time.perf_counter() - t_start}
    xlstm_pool, xlstm_pending = start_xlstm_cells()  # phase 34(a), read there
    moe_pool, moe_pending = start_moe_cell()  # phase 35(d), read there
    rows_pool, rows_pending = start_llava_rows_cell()  # phase 36(a), read there

    def timed(phases: str, fn, *args):
        """``fn(*args)``, its wall seconds printed and kept under ``phases``."""
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[phases] = time.perf_counter() - t0
        print(f"  [phase {phases}: {phase_s[phases]:.1f} s]")
        return out

    kernel_rows = timed("2", phase_kernels, sm_clock_hz)
    optimize, optimize_rows = timed("3", phase_optimize, sm_clock_hz)
    waves, wave_rows = timed("4", phase_waves, sm_clock_hz)
    timed("5", phase_agreement)
    mc_rows = timed("6", phase_mc_kernel)
    mc_set_rows = timed("6b", phase_mc_sets)
    motpe, motpe_rows, motpe_set_row = timed("7", phase_motpe)
    nsga2 = timed("8", phase_nsga2)
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full precision
    torch.backends.cudnn.allow_tf32 = False
    flash_rows = timed("9", phase_flash, _build.build_log())
    tinyllama = timed("10", phase_tinyllama)
    gemma2 = timed("11", phase_gemma2)
    ce_rows, ce_grads = timed("12", phase_crossentropy)
    flash_grads = timed("13", phase_flash_grad)
    train_tinyllama = timed("14", phase_train_tinyllama, ce_rows, flash_rows)
    train_gemma2 = timed("15", phase_train_gemma2, ce_rows)
    tune = timed("16", phase_tune, 16, ("dense",))
    ssd_rows, ssd_grads, ssd_ptx = timed("17", phase_ssd, _build.build_log())
    serve_zamba2 = timed("18", phase_serve_zamba2, ssd_rows)
    train_zamba2 = timed("19", phase_train_zamba2, ssd_rows)
    tune_hybrid = timed("20", phase_tune, 20, ("dense", "mamba2"))
    slstm_rows, slstm_grads, slstm_ptx, slstm_repeat = timed("21", phase_slstm,
                                                             _build.build_log())
    serve_xlstm = timed("22", phase_serve_xlstm, slstm_rows)
    train_xlstm = timed("23", phase_train_xlstm, slstm_rows)
    tune_xlstm = timed("24", phase_tune, 24, ("dense", "mlstm", "mamba2"))
    serve_deepseek = timed("25", phase_serve_deepseek)
    train_deepseek = timed("26", phase_train_deepseek)
    qwen3 = timed("27", phase_qwen3_moe, _build.build_log())
    flash_rows.append(qwen3["train_checks"]["flash"])
    flash_grads.append(qwen3["train_checks"]["flash_grad"])
    ce_rows.append(qwen3["train_checks"]["ce"])
    ce_grads.append(qwen3["train_checks"]["ce_grad"])
    tune_moe = timed("28", phase_tune, 28, ("dense", "mlstm", "mamba2", "moe"))
    moe_trials = tune_moe["states_by_family"]["moe"]
    assert moe_trials and set(moe_trials) <= {"COMPLETE", "PRUNED"}, moe_trials
    storage = timed("29", phase_storage)
    tune_slices = timed("30", phase_tune_slices, tune_moe)
    sharded = timed("31", phase_sharded)
    op_analysis = timed("32", phase_op_analysis)
    serve_cache = timed("33", phase_serve_cache)
    xlstm_sharded = timed("34", phase_xlstm_sharded, xlstm_pool, xlstm_pending)
    moe_sharded = timed("35", phase_moe_sharded, moe_pool, moe_pending)
    prefill_rows = timed("36", phase_prefill_rows, rows_pool, rows_pending)

    shape_rows = optimize_rows + wave_rows
    table = wave_rows[-1]  # the score-table build: the kernel's large shape
    kernels = [{
        "name": "parzen_score",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/parzen.cu",
        "replaces": "src/repro/kernels/parzen.py:34",
        "launches": optimize["parzen_launches"],
        "launches_waves": waves["parzen_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows + shape_rows),
        "ms": table["ms"],
        "card_ms": table["card_ms"],
        "plain_ms": table["plain_ms"],
        "bound_ms": table["bound_ms"],
        "bound_by": table["bound_by"],
        "library_ms": None,
        "shapes": shape_rows,
    }]
    # the main path's own shape: the below set's contributions (25 x 8192 x 5)
    mc_main = motpe_rows[0]
    kernels.append({
        "name": "mc_hv_counts",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hypervolume.cu",
        "replaces": "src/repro/kernels/hypervolume.py:38",
        "launches": motpe["mc_hv_launches"],
        "mismatches": sum(r["mismatches"] for r in mc_rows + motpe_rows),
        "max_abs_err": max(r["max_abs_err"] for r in mc_rows + motpe_rows),
        "ms": mc_main["ms"],
        "plain_ms": mc_main["plain_ms"],
        "bound_ms": mc_main["bound_ms"],
        "bound_by": mc_main["bound_by"],
        "library_ms": None,
        "shapes": mc_rows + motpe_rows,
    })
    # the batched counts at phase 7's largest greedy step
    kernels.append({
        "name": "mc_hv_counts_sets",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hypervolume.cu",
        "replaces": "src/repro/kernels/hypervolume.py:38",
        "launches": motpe["mc_hv_set_launches"],
        "mismatches": sum(r["mismatches"] for r in mc_set_rows + [motpe_set_row]),
        "max_abs_err": max(r["max_abs_err"] for r in mc_set_rows + [motpe_set_row]),
        "ms": motpe_set_row["ms"],
        "card_ms": motpe_set_row["card_ms"],
        "plain_ms": motpe_set_row["plain_ms"],
        "bound_ms": motpe_set_row["bound_ms"],
        "bound_by": motpe_set_row["bound_by"],
        "library_ms": None,
        "shapes": mc_set_rows + [motpe_set_row],
    })
    kernels[0]["launches_motpe"] = motpe["parzen_launches"]
    # the main path's own shape: tinyllama-1.1b's prefill at B = 8, S = 2048
    fa_main = next(r for r in flash_rows if r["label"] == "tinyllama prefill")
    kernels.append({
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:31",
        "launches": tinyllama["flash_launches"],
        "launches_entry_point": tinyllama["entry"]["flash_launches"],
        "launches_gemma2": gemma2["flash_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
        "ms": fa_main["ms"],
        "plain_ms": fa_main["plain_ms"],
        "bound_ms": fa_main["bound_ms"],
        "bound_by": fa_main["bound_by"],
        "library_ms": fa_main["library_ms"],
        "launches_train_tinyllama": train_tinyllama["launches"]["flash_attention"],
        "launches_train_gemma2": train_gemma2["launches"]["flash_attention"],
        "launches_tune": tune["launches"]["flash_attention"],
        "launches_zamba2_entry_point": serve_zamba2["entry"]["launches"]["flash_attention"],
        "launches_zamba2": serve_zamba2["flash_launches"],
        "launches_train_zamba2": train_zamba2["launches"]["flash_attention"],
        "launches_tune_hybrid": tune_hybrid["launches"]["flash_attention"],
        "launches_tune_xlstm": tune_xlstm["launches"]["flash_attention"],
        "launches_entry_point_qwen3_moe": qwen3["serve"]["entry"]["flash_launches"],
        "launches_serve_qwen3_moe": qwen3["serve"]["flash_launches"],
        "launches_train_qwen3_moe": qwen3["train"]["launches"]["flash_attention"],
        "launches_tune_moe": tune_moe["launches"]["flash_attention"],
        "launches_tune_slices": tune_slices["launches"]["flash_attention"],
        "launches_sharded_train": sharded["f32"]["launches"]["flash_attention"],
        "launches_sharded_train_bf16": sharded["bf16"]["launches"]["flash_attention"],
        "launches_sharded_serve_gemma2": serve_cache["served"]["gemma2-9b"]["launches"][
            "flash_attention"],
        "launches_sharded_serve_zamba2": serve_cache["served"]["zamba2-1.2b"]["launches"][
            "flash_attention"],
        "launches_sharded_train_moe_sort": moe_sharded["sharded"]["train"]["launches"][
            "flash_attention"],
        "launches_sharded_serve_moe_sort": moe_sharded["sharded"]["serve"]["launches"],
        "dryrun_qwen3_moe_512": moe_sharded["cell"]["ops"]["flash_attention"],
        "launches_sharded_prefill_rows_llava": {
            k: r["launches"] for k, r in prefill_rows["rows"]["rows"].items() if k.startswith("R")},
        "dryrun_llava_prefill_512": prefill_rows["cell"]["flash_ops"],
        "qwen3_moe_prefill": [{k: r[k] for k in ("B", "Sq", "Skv", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "max_abs_err")}
                              for r in qwen3["flash_rows"]],
        "tensor_core_sass": {k: n for k, n in sass.items()
                             if "flash" in k or k == "not available"},
        "shapes": flash_rows,
        "gradient_checks": flash_grads,
    })
    kernels[0]["launches_tune"] = tune["launches"]["parzen_score"]
    kernels[0]["launches_tune_hybrid"] = tune_hybrid["launches"]["parzen_score"]
    kernels[0]["launches_tune_xlstm"] = tune_xlstm["launches"]["parzen_score"]
    kernels[0]["launches_tune_moe"] = tune_moe["launches"]["parzen_score"]
    kernels[0]["launches_storage"] = storage["backends"][0]["launches"]
    kernels[0]["launches_distributed"] = storage["served"]["launches"]
    kernels[0]["launches_distributed_journal"] = storage["journal"]["launches"]
    kernels[0]["launches_tune_slices"] = tune_slices["launches"]["parzen_score"]
    # the training main path's own shape: tinyllama-1.1b's loss at B = 8, S = 2048
    ce_main = next(r for r in ce_rows if r["label"] == "tinyllama training")
    kernels.append({
        "name": "crossentropy",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/crossentropy.cu",
        "replaces": "src/repro/kernels/crossentropy.py:27",
        "launches": train_tinyllama["launches"]["crossentropy"],
        "launches_train_gemma2": train_gemma2["launches"]["crossentropy"],
        "launches_tune": tune["launches"]["crossentropy"],
        "launches_train_zamba2": train_zamba2["launches"]["crossentropy"],
        "launches_tune_hybrid": tune_hybrid["launches"]["crossentropy"],
        "launches_train_xlstm": train_xlstm["launches"]["crossentropy"],
        "launches_tune_xlstm": tune_xlstm["launches"]["crossentropy"],
        "launches_train_deepseek": train_deepseek["launches"]["crossentropy"],
        "launches_train_qwen3_moe": qwen3["train"]["launches"]["crossentropy"],
        "launches_tune_moe": tune_moe["launches"]["crossentropy"],
        "launches_tune_slices": tune_slices["launches"]["crossentropy"],
        "launches_sharded_train": sharded["f32"]["launches"]["crossentropy"],
        "launches_sharded_train_bf16": sharded["bf16"]["launches"]["crossentropy"],
        "launches_sharded_train_xlstm": xlstm_sharded["sharded"]["train"]["launches"][
            "crossentropy"],
        "launches_sharded_train_moe_sort": moe_sharded["sharded"]["train"]["launches"][
            "crossentropy"],
        "dryrun_qwen3_moe_512": moe_sharded["cell"]["ops"]["crossentropy"],
        "max_abs_err": max(r["max_abs_err"] for r in ce_rows),
        "ms": ce_main["ms"],
        "plain_ms": ce_main["plain_ms"],
        "bound_ms": ce_main["bound_ms"],
        "bound_by": ce_main["bound_by"],
        "library_ms": ce_main["library_ms"],
        "ptxas": ce_ptxas(_build.build_log()),
        "tensor_core_sass": {k: n for k, n in sass.items()
                             if "crossentropy" in k or k == "not available"},
        "shapes": ce_rows,
        "gradient_checks": ce_grads,
    })
    # the serving main path's own shape: zamba2-1.2b's prefill at B = 8, S = 2048
    ssd_main = next(r for r in ssd_rows if r["label"] == "zamba2 prefill")
    kernels.append({
        "name": "ssd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd.py:25",
        "launches": serve_zamba2["ssd_launches"],
        "launches_entry_point": serve_zamba2["entry"]["launches"]["ssd"],
        "launches_train_zamba2": train_zamba2["launches"]["ssd"],
        "launches_tune_hybrid": tune_hybrid["launches"]["ssd"],
        "launches_tune_xlstm": tune_xlstm["launches"]["ssd"],
        "launches_tune_moe": tune_moe["launches"]["ssd"],
        "launches_tune_slices": tune_slices["launches"]["ssd"],
        "launches_sharded_serve_zamba2": serve_cache["served"]["zamba2-1.2b"]["launches"]["ssd"],
        "max_abs_err": max(r["max_abs_err"] for r in ssd_rows),
        "ms": ssd_main["ms"],
        "card_ms": ssd_main["card_ms"],
        "plain_ms": ssd_main["plain_ms"],
        "bound_ms": ssd_main["bound_ms"],
        "bound_by": ssd_main["bound_by"],
        "bytes_bound_ms": ssd_main["bytes_bound_ms"],
        "library_ms": None,
        "ptxas": ssd_ptx,
        "tensor_core_sass": {k: n for k, n in sass.items()
                             if "ssd" in k or k == "not available"},
        "shapes": ssd_rows,
        "gradient_checks": ssd_grads,
    })
    # the serving main path's own shape: xlstm-1.3b's prefill (and training) at B = 8, S = 2048
    slstm_main = next(r for r in slstm_rows if r["label"] == "xlstm-1.3b prefill / training")
    slstm_decode = next(r for r in slstm_rows if r["label"] == "xlstm-1.3b decode")
    kernels.append({
        "name": "slstm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/slstm.cu",
        "replaces": "src/repro/kernels/slstm.py:31",
        "launches": serve_xlstm["slstm_launches"],
        "launches_entry_point": serve_xlstm["entry"]["slstm_launches"],
        "launches_train_xlstm": train_xlstm["launches"]["slstm"],
        "launches_sharded_serve_xlstm": sum(xlstm_sharded["sharded"]["serve"]["launches"]),
        "launches_sharded_train_xlstm": xlstm_sharded["sharded"]["train"]["launches"]["slstm"],
        "dryrun_xlstm_ops": {k: r["slstm_ops"] for k, r in xlstm_sharded["cells"].items()},
        "max_abs_err": max(max(r["step_errs"].values()) for r in slstm_rows),
        "ms": slstm_main["ms"],
        "plain_ms": slstm_main["plain_ms"],
        "bound_ms": slstm_main["bound_ms"],
        "bound_by": slstm_main["bound_by"],
        "library_ms": None,
        "decode_ms": slstm_decode["ms"],
        "decode_card_ms": slstm_decode["card_ms"],
        "decode_bound_ms": slstm_decode["bound_ms"],
        "repeatable": slstm_repeat["equal_bits"],
        "ptxas": slstm_ptx,
        "shapes": slstm_rows,
        "gradient_checks": slstm_grads,
    })
    for entry in kernels:  # every launch is the kernel's custom op (kernels/ops.py)
        entry["op"] = f"repro_torch::{entry['name']}"
        name = entry["name"]
        if name in op_analysis["bound_shares"]:
            entry["launches_op_analysis_train"] = op_analysis["real"]["train"]["launches"][name]
            entry["launches_op_analysis_prefill"] = op_analysis["real"]["prefill"]["launches"][name]
            entry["op_analysis_bound_share"] = op_analysis["bound_shares"][name]
            entry["dryrun_tinyllama"] = op_analysis["dryrun_tinyllama"]["kernel_ops"][name]
        if name in op_analysis["dispatch"]:
            entry["dispatch"] = op_analysis["dispatch"][name]
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump({"nvidia_smi": smi, "sm_clock_hz": sm_clock_hz,
                       "build_seconds": _build.build_seconds(),
                       "kernel_checks": kernel_rows, "optimize": optimize, "waves": waves,
                       "motpe": motpe, "nsga2": nsga2, "tinyllama": tinyllama,
                       "gemma2": gemma2, "train_tinyllama": train_tinyllama,
                       "train_gemma2": train_gemma2, "tune": tune,
                       "serve_zamba2": serve_zamba2, "train_zamba2": train_zamba2,
                       "tune_hybrid": tune_hybrid, "serve_xlstm": serve_xlstm,
                       "train_xlstm": train_xlstm, "tune_xlstm": tune_xlstm,
                       "serve_deepseek": serve_deepseek, "train_deepseek": train_deepseek,
                       "qwen3_moe": qwen3, "tune_moe": tune_moe, "storage": storage,
                       "tune_slices": tune_slices, "sharded": sharded,
                       "op_analysis": op_analysis, "serve_cache": serve_cache,
                       "xlstm_sharded": xlstm_sharded, "moe_sharded": moe_sharded,
                       "prefill_rows": prefill_rows,
                       "phase_seconds": phase_s,
                       "kernels": kernels}, f,
                      indent=1)
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s "
          f"(kernel build {_build.build_seconds():.2f} s)")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
