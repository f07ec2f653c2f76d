#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one Hopper card.

    python3 chip_smoke.py

Needs one H100 (sm_90), ``nvcc`` under ``$CUDA_HOME/bin`` or
``/usr/local/cuda/bin``, and nothing but this checkout: it imports the port
(``src/repro_torch``), never JAX or the JAX package.  Phases, in order; any
failure ends the run with a non-zero exit:

1. device: the card's name and power limit, capability (9, 0), TF32 off;
2. build: the FlashAttention, SSD, fused GEMM-epilogue and streamed GEMM
   kernels from ``csrc/`` into ``build/torch_kernels``, one ``nvcc`` for
   each source, started together; registers, shared memory and spills of
   every instance (a bf16 FlashAttention, GEMM-epilogue or streamed-GEMM
   instance must not spill); FlashAttention's keys a tile and ring stages
   of every head dim (must equal ``flash_attention.tiling``'s) and its
   shared memory; the GEMM epilogue's dynamic shared memory and
   ``cudaOccupancyMaxActiveClusters`` of every instance at every cluster
   size ``gemm_epilogue.tiling`` uses (each must be > 0); the streamed
   GEMM's tiles and cluster (must equal the wrapper's ``TILES`` and
   ``CLUSTER``) and the clusters of its bf16 kernel the card holds
   (must be > 0); and the SSD scan's bf16 instances: registers and spills
   (none may spill or have its wgmma serialized by ptxas), ring stages
   and shared memory (must equal
   ``ssd.bf16_layout``'s) and the CTAs an SM holds (from the occupancy
   calculator, must equal ``ssd.tiling``'s), with every unit of mamba2's
   serving shape resident at once in both input forms;
3. FlashAttention against its plain version ``attention_ref`` on the card,
   in f32 (tolerance 2e-5) and bf16 (3e-2), over GQA, ragged, Sq < Skv,
   window, fully-masked-row and head-dim cases, and at every edge of the
   tiling (``flash_attention.BOUNDARY_CASES``: both sides of the q and key
   tiles, a single key tile, groups of 1, 3 and 16, windows inside one key
   tile and across several, Sq > Skv, Sq = 1, every head dim); rows that
   see no key must be exactly 0; then, in bf16, at the shapes one rank of
   a model axis of 2 or 4 hands it when serving on a mesh
   (``kernel_bench.RANK_ATTENTION_SHAPES``: glm4-9b's 16 q heads over its
   kv head and 8 over one of two gathered kv heads, hymba-1.5b's 25 heads
   cut mid-head), each checked and timed (CUDA events and device time of
   the kernel, the plain version and SDPA, the bound);
4. FlashAttention at glm4-9b's serving prefill shape: error against the
   plain version, CUDA-event times of the kernel, the plain version and
   ``F.scaled_dot_product_attention`` (a yardstick the port never calls),
   device-only times of the kernel and of SDPA from ``torch.profiler``, the
   least time the card could take, and the Q, K/V and O bytes the tiling
   loads through L2 (``kernel_bench.attention_l2_bytes``: a count of the
   tiling's loads, not a reading) over the device time; beside them, the
   COMET plan's modelled latency for that shape on ``h100()`` (logged
   only, never a gate);
5. the plan warmup, then serving glm4-9b: ``$REPRO_PLAN_CACHE`` on a
   fresh directory, the engine built twice (batch 4, prompt 1024, cache
   2048): the cold one solves every plan job of ``plan_shapes()`` and
   hits none, the warm one (over the same store, its in-memory layer
   dropped) hits every job and solves none, both warmup times logged; then
   serving glm4-9b at full width and depth, bf16, random weights from seed
   0, with every layer's prefill attention through the kernel; every
   kernel's launches are counted over this run alone; then one prefill and
   one decode step of that batch, timed with CUDA events and profiled
   (kernel time, idle share, top kernels);
6. continuous batching on the card (glm4 smoke config, f32, kernel on):
   a 3-slot engine equals serial 1-slot decoding, and the kernel path's
   logits equal the plain path's;
7. the SSD kernel against its plain version ``ssd_chunked_ref`` (on B and
   C repeated to one row a head) on the card, in f32 (2e-3, as
   tests/test_kernels.py) and bf16 (1e-2 of the output's largest
   magnitude), with B/C in group form at r 1 and 24: the JAX sweep shapes,
   a ragged S, a chunk below 64, the mamba2 smoke head (P 16, N 16), the
   full head (P 64, N 128), and every edge of the tiling
   (``ssd.BOUNDARY_CASES``: chunks of 8 and 40, ragged S, P 16/32/64, N
   16-128, groups of 1-24, B/C as strided views of a conv output); then,
   in bf16 at the plan's chunk, at a rank's heads of a model axis of 2 or
   4 (``kernel_bench.RANK_SSD_SHAPES``: mamba2-130m's 12 and 6 of 24,
   hymba-1.5b's 25 of 50, B/C views of the gathered conv output), each
   checked and timed;
8. the SSD kernel at mamba2-130m's serving prefill shape (BH 192, S 1024,
   P 64, N 128, bf16), B/C one row a head (``kernel_bench.SSD_SHAPE``) and
   as the model hands them over (``SSD_GROUP_SHAPE``: r 24, strided views
   of a conv output of 1792 columns): error, CUDA-event
   times of the kernel and the plain version, device-only times from
   ``torch.profiler``, and the least time the card could take for the
   bytes each form reads (no single PyTorch call computes the scan, so
   there is no library time); the chunk the COMET plan chooses there
   (``autotune.ssd_chunk_len(1024, 64, 128)``), and the group form timed
   at every chunk the plan ranked (16, 32 and 64: the plan's and the
   kernel's own among them) beside each one's modelled latency (logged
   only);
9. the plan warmup as in phase 5 for mamba2-130m (batch 8, prompt 1024,
   cache 2048), then serving it at full width and depth, bf16, random
   weights from seed 0, with every layer's prefill SSD scan through the
   kernel, B and C handed over in group form: launches == 24 x prefill
   calls over this run alone, every one at the plan's chunk; one prefill
   and one decode step timed and profiled as in phase 5, with the SSD
   kernel's share of the prefill;
10. continuous batching on the mamba2 smoke config (f32, kernel on), and
    its kernel-path logits against the plain path's (1e-2);
11. the fused GEMM-Softmax, GEMM-LayerNorm and GEMM-RMSNorm kernel
    against their plain versions on the card, within the bars of
    ``gemm_epilogue.tolerance`` (f32: softmax 2e-5, norms 1e-4; bf16: 1e-2
    of the output's largest magnitude): the JAX sweep shapes, ragged
    M/K/N, M 1 and M 4, every cluster size 1-16, a softmax row whose max
    sits in the last CTA's slice, LayerNorm rows of mean 1e3 and std about
    1, both sides of every change of tiling in both dtypes
    (``gemm_epilogue.boundary_shapes``: N at 256/264, 4096/4104, 8192/8200
    and 16384; M at 1, BM - 1, BM + 1 and a ragged multiple; K at 8, 100
    and one off the K step), and the largest paper shape (4096, 16384,
    4096) three times;
12. the bench chain (``repro_torch.launch.run``: the paper tables, Fig.
    6, the kernel benchmark ``kernel_bench.run_all`` on the card at its
    default shapes, the MoE dispatch model and the roofline of whatever
    dry-run artifacts exist, from a scratch directory), with every
    kernel's count set to 0 just before and read just after: each kernel's
    launches equal the bench's calls to it (no fallback, every kernel
    launched), each GEMM output within the bar of phase 11, FlashAttention
    within 3e-2 (absolute and relative), the SSD scan within 1e-2 of its
    largest |y| and the streamed GEMM within ``allgather_gemm.tolerance``
    (phases 4, 8 and 14 check and time those three in full); beside
    the CUDA-event times, device-only times of the kernel and of the
    library pair from ``torch.profiler``; beside each shape, the COMET
    plan's modelled latency on ``h100()`` (logged only);
13. the streamed GEMM against its plain version ``streamed_gemm_ref`` on
    the card, both buffer modes, f32 (atol 2e-4, rtol 2e-5, the JAX test's
    bar, w scaled 0.2 as there) and bf16 (1e-2 of the output's largest
    magnitude), within ``allgather_gemm.tolerance``: the JAX test shapes,
    the three ``BUDGET_SHAPES``, ragged M, N and K, chunks that are not a
    multiple of the k-tile or smaller than it, ``chunks=1``, every edge of
    the tiling (``allgather_gemm.boundary_shapes``: M and N on both sides of
    a tile, odd counts of row and column tiles, kc of 8 to 1024, more tiles
    than the persistent grid's CTAs) and, in bf16, glm4-9b's (4096, 4096,
    13696) once; the two modes equal bit for bit; and the refusals (chunks
    that do not divide K, ``buffers=3``, misaligned N) raise on the card and
    launch nothing;
14. the overlap bench (``repro_torch.launch.overlap_bench.run_all``) in a
    one-rank NCCL group (``mesh.host_group``), with the streamed GEMM's
    count set to 0 just before and read just after (launches == the bench's
    calls): ``allgather_gemm`` at glm4-9b's MLP input projection, (M, K, N)
    = (4096, 4096, 13696) bf16, against ``allgather_gemm_reference``; both
    buffer modes timed at that shape (``chunks=4``) and at the three
    ``BUDGET_SHAPES`` in f32, beside the bound, the plain version and
    ``torch.matmul``, with device-only times from ``torch.profiler`` and
    the X and W bytes the tiling loads from L2
    (``kernel_bench.streamed_l2_bytes``: a count, not a reading); the two
    modes within 1e-3 of each other; the hidden fraction degenerate (one rank); the synthetic overlap
    recovery within 0.01 and 0.10;
15. training mamba2-130m at full width and depth (``train_phase``: bf16,
    batch 8 x seq 1024, remat "full", random weights and data from seed
    0): at step 0 the kernel path against the plain path on the same
    params and batch (loss within 1e-2 relative; every gradient leaf at
    cosine >= 0.99 with a norm within 2%, or within 4 x the bf16 noise
    floor where that is looser: the plain path against itself at chunk 32,
    whose worst leaf was 0.985 and 3.2% apart), the kernel launched twice
    a layer (forward and recompute) and the plain path not at all; the f32
    smoke config's kernel path against its plain path within the CPU
    parity bars of tests/test_torch_train.py (loss 1e-5 relative,
    gradients 1e-2 of their largest magnitude for mamba2, whose SSD runs
    in bf16 in every config); 6 steps of ``train_loop`` with the plans
    warmed and an ``AsyncCheckpointer`` save at steps 3 and 6, counts set
    to 0 just before: 6 x 24 x 2 SSD launches, every one at the plan's
    chunk, finite losses (whether they fall is logged), the step-6
    checkpoint restored bit for bit into a fresh TrainState; one step
    without remat (24 launches); step ms (CUDA events, steps 2-6),
    tokens/s, and one profiled step's idle share, top kernels and the
    shares of the SSD kernel, the plain recompute backward and AdamW;
16. the same for glm4-9b at full width and 4 of its 40 layers (the cut is
    forced by memory and logged), batch 4 x seq 1024, FlashAttention
    instead of the SSD scan, gradients of the f32 smoke step within 1e-4
    of their largest magnitude, no checkpoint;
17. serving hymba-1.5b (the hybrid family: attention and SSD heads in
    every layer) at full width and depth, bf16, random weights from seed
    0, batch 4, prompt 1536 (so the window of 1024 masks inside the
    FlashAttention kernel and the prefill builds its ring: 1536 < 2 x 1024
    keeps it off the banded path), cache 2048: FlashAttention at hymba's
    shape (4, 25, 5, 1536, 1536, 64, window 1024; a GQA group of 5, one
    head a work item) against ``attention_ref`` (3e-2) and the SSD scan at
    hymba's (BH 200, r 50, S 1536, P 64, N 16, the conv output's views) at
    the plan's chunk against ``ssd_chunked_ref`` (1e-2 of the largest
    |y|), each timed beside its bound, plain version and SDPA (a boolean
    window mask); then the serve run, counts set to 0 just before:
    32 FlashAttention and 32 SSD launches per prefill, every SSD launch at
    the plan's chunk; one prefill and one decode step timed and profiled
    as in phase 5; the phase's peak memory;
18. the same for qwen3-moe-30b-a3b (MoE: 128 experts top-8), full config,
    all 48 layers, batch 4, prompt 1024, cache 2048: FlashAttention at
    (4, 32, 4, 1024, 1024, 128), 48 launches per prefill;
19. deepseek-v3-671b (MLA + the sigmoid-routed MoE with a shared expert)
    at full width and 4 of its 61 layers (3 dense + 1 MoE; the cut is
    forced by memory and logged): no kernel launches at all (MLA's q and v
    head dims differ, so it takes the blocked loop, as in JAX);
20. seamless-m4t-medium (enc-dec) full config, batch 4, prompt 1024
    (128 encoder frames), cache 2048: FlashAttention at the cross shape
    (4, 16, 16, 1024, 128, 64, not causal) as above; 36 launches per
    prefill (12 encoder, 12 decoder self, 12 cross); the engine feeds zero
    frames, the timed prefill seeded ones, so the cross-attention sees
    real keys;
21. for each of the four families' smoke configs (f32, kernels on): a
    3-slot engine equals serial decoding (the MoE configs at capacity
    factor E / k: a batched prefill's rows share each expert's capacity,
    so batching equals serial decoding only where nothing drops), and the
    kernel path's logits equal the plain path's (1e-4; hymba 1e-2, its
    SSD in bf16);
22. the planner loss (``parallel/collective_planner.sharded_softmax_xent``)
    at glm4-9b's full width: h (4, 1024, 4096) bf16, unembed (4096,
    151552) bf16 (1.24 GB), labels under the real vocab, on
    ``launch/mesh.make_host_mesh()`` ((1, 1) over NCCL, checked), each
    strategy forced: the loss within 1e-4 relative and the gradients of h
    and the unembed within 1e-2 of their largest magnitude of the plain
    ``cross_entropy_loss(h @ W)`` under autograd; forward + backward timed
    (CUDA events) beside the plain loss's; the collectives each emits,
    counted over NCCL, against ``softmax_collective_schedule`` (one
    shard: none declared; the emitted ones all run in one-rank groups);
23. the train CLI with ``--mesh host --planner-loss`` on glm4-9b (full
    width, ``--layers 4`` of 40 as phase 16, kernels on, 3 steps), counts
    set to 0 just before and read just after: the params placed by
    ``shard_tree``, ZeRO-1 moments, the tensor-parallel embedding,
    attention (FlashAttention at the rank's heads) and MLP on the (1, 1)
    NCCL mesh; FlashAttention launched 4 x 2 times a step; the step-0 loss
    within 1e-3 relative of the plain-loss CLI's at the same seed and
    batch; the step times beside phase 16's; the collectives' labels, the
    remat recompute's share of them, the peak memory;
24. the front ends: ``repro_torch.examples.serve_lm`` (8 requests, 4
    slots, glm4's smoke config in bf16) and ``train_lm`` (lm-100m, 3
    steps of batch 4 x seq 256) with ``--device cuda``, counts set to 0
    just before each: FlashAttention launches > 0 and equal to what each
    reports; ``examples.comet_attention`` to its end, its planner lines
    the expected strings; ``launch.costmodel_compare.collective_compare``
    (Fig. 6's predicted-vs-measured collectives on the synthetic backend)
    logged, not degenerate;
25. the train CLI with ``--mesh host --planner-loss`` on
    qwen3-moe-30b-a3b (full width, ``--layers 4`` of 48: 3.1 B parameters
    at 12 B each (bf16 params and grads, f32 moments) are 37 GB, all 48
    layers 366 GB), batch 4 x seq 1024, bf16, kernels on, 3 steps, counts
    set to 0 just before and read just after: tensor-parallel attention
    and expert-parallel MoE layers on the (1, 1) NCCL mesh, the first MoE
    training run on the card; FlashAttention launched 4 x 2 x 3 = 24
    times; the step-0 loss within 1e-3 relative of the same CLI's without
    a mesh; finite losses; ``moe/combine`` and ``moe/router-grad`` among
    the collectives; the trained params saved on the mesh and restored
    with ``shardings=`` bit for bit; the step times beside the step
    without a mesh, the peak memory; one step without a mesh timed and
    profiled as in phase 15 (idle share, top kernels, FlashAttention's
    share, the recompute backward and AdamW by CUDA events);
26. serving glm4-9b at full width and depth through
    ``ServeEngine(mesh=make_host_mesh())`` (the one-card (1, 1) NCCL mesh:
    params placed by ``param_shardings``, the tensor-parallel serving
    layers, every collective a one-rank copy) with phase 5's requests,
    counts set to 0 just before and read just after: the greedy tokens
    equal phase 5's, FlashAttention launched 40 times a prefill; one
    prefill and one decode step timed and profiled, each named
    collective's count logged, and the decode step's top host ops by self
    CPU time (``torch.profiler``; a one-rank group's collective is a copy
    with no NCCL call); then ``python -m repro_torch.launch.serve --arch
    glm4-9b --mesh host`` once (exit 0, every token out);
27. the same for hymba-1.5b (phase 17's requests and tokens; 32
    FlashAttention and 32 SSD launches a prefill);
28. training hymba-1.5b at full width and depth as phase 15
    (``train_phase``), batch 4 x seq 1536 (the window masks inside the
    kernel), 4 steps: step 0's kernel path against the plain path at
    mamba2's bars (the SSD floor), both kernels launched 2 x 32 times a
    step, every SSD launch at the plan's chunk, the f32 smoke step within
    the CPU bars (1e-2: its SSD), one step without remat, step ms over
    steps 2-4 and the profiled step;
29. the same for seamless-m4t-medium (12 encoder, 12 decoder layers),
    batch 4 x seq 1024 (128 frames): FlashAttention 2 x 36 times a step
    (encoder, decoder self and cross attention);
30. the same for deepseek-v3-671b at full width and 3 of its 61 layers
    (the dense stack: one MoE layer holds 11.3 B expert parameters, 135
    GB with their moments; the cut is logged), batch 4 x seq 1024: no
    kernel launch (MLA reaches none), so no kernel path to hold against
    the plain one;
31. the pod axis: ``train_loop`` of glm4-9b at full width, 4 of its 40
    layers (phase 16's cut), bf16, kernels on, the planner loss, batch 4
    x seq 1024, 3 steps, on a one-rank ``("pod", "data", "model")`` NCCL
    mesh of shape (1, 1, 1) (``launch/mesh.make_auto_mesh``), counts set
    to 0 just before and read just after: FlashAttention launched 4 x 2 x
    3 times; the step-0 loss within 1e-3 relative of phase 16's (no
    mesh); every collective a one-rank copy, the labels logged; the step
    times beside phase 23's on the (1, 1) mesh;
32. ``seq_shard=True`` on the (1, 1) NCCL mesh (the residual's sequence
    over ``model``: every block gathers the rows in and Reduce-Scatters
    them out): the same glm4-9b training as phase 23 (3 steps, the planner
    loss), its step-0 loss equal to phase 23's (1e-6 relative) and every
    step's within 1e-3, FlashAttention 24 launches, the rows' gathers and
    scatters among the collectives; 2 steps of mamba2-130m at full config
    (batch 8 x seq 1024): 24 x 2 x 2 SSD launches, every one at the plan's
    chunk, the step-0 loss within 1e-3 of phase 15's; glm4-9b served with
    phase 5's requests through ``ServeEngine(mesh=)``: its greedy tokens
    equal phase 5's, FlashAttention 40 launches a prefill, the prefill's
    gathers and scatters among the collectives;
33. ``tensor_parallel=False`` on the (1, 1) NCCL mesh: one glm4-9b step as
    phase 23's first (4 layers, the planner loss), its loss within 1e-6
    relative of phase 23's step 0, FlashAttention 4 x 2 launches, no
    ``tp/`` collective (the dense layers run on whole weights);
34. calibration (``python -m repro_torch.calibrate``), each run in a fresh
    store: ``--backend nccl`` on the one card exits 2, degenerate, nothing
    persisted, no file written, and every point of its grid a real
    one-rank NCCL call that was timed (none dropped as an error or a
    non-finite time); ``--backend gloo --ranks 4`` at a small sweep (``CALIB_GLOO``)
    is not degenerate, its constants finite, persisted; run again it
    reuses the file (``fits_solved`` 0) and leaves its bytes as they were;
    ``tpu_v5e(calibrated=path)`` carries the fitted constants; the gate's
    median and max error logged (exit 0 or 1: the gate is a measurement
    here);
35. static contracts: ``python -m repro_torch.analysis`` on the full
    paper shapes in a subprocess (exit 0: every contract and the lint);
    then each kernel launched once at each contract shape (the kernel
    arm's) under ``torch.profiler``: the trace's grid equals the tiling's
    (``tiling(...).grid``, ``gemm_epilogue.launch_grid``), its shared
    memory holds the library's dynamic figure (``fa_smem_bytes``,
    ``ge_smem_bytes``, ``ssd_bf16_tile``; the trace adds the static
    part, at most what ptxas reports) and is within the card's per-block
    opt-in, the card's half of the lint's ``smem-budget``;
36. the dry run against the card: ``python -m repro_torch.launch.dryrun``
    of glm4-9b (full width, 4 of 40 layers, the planner loss, batch 4 x
    seq 1024) on the (1, 1) mesh of a fake one-rank world in a
    subprocess, and the real step on the card's (1, 1) NCCL mesh under
    the same counter and ``record_collectives``: equal FLOPs and equal
    records; the state's bytes those the card allocated up to 512 B a
    tensor; the peaks logged, with no bar;
37. the full-width dry-run cells: glm4-9b ``train_4k`` on the 256-rank
    single-pod mesh and qwen3-moe-30b-a3b ``train_4k`` on the 512-rank
    multi-pod mesh, each in a subprocess: seconds, FLOPs a rank and the
    reconciliation's findings logged, the roofline terms logged as
    predictions;
38. the search-throughput bench (``python -m
    repro_torch.launch.search_throughput``, all nine sections) in a
    subprocess on the card: exit 0 and ``ok``, with every timing floor
    met on the card's host (the batched engine 20x the tree path on each
    space, warm plan lookups 100x a cold solve, process >= thread
    jobs/sec with no fallback to threads, size-aware chunking >= 0.95x
    contiguous) and the streamed GEMM launched by its overlap section
    (launches == calls > 0); each section's seconds, the executors' and
    chunking's jobs/sec and the streamed GEMM's times logged;
39. a JSON line of the kernels (every number in it measured in this run,
    but ``bound_ms``, computed from this run's inputs, and ``launches``
    and ``train_launches``, counted over the serve or bench run and over
    the training run; the FlashAttention and SSD rows also carry each
    family's serve and training launches and its shape's record, the
    mesh phases' launches (phases 23, 25-27 and 31-33) and the rank shapes'
    records), then
    ``{"ok": true, ...}`` as the last line.

Timing and bound helpers are those of ``repro_torch.launch.kernel_bench``.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# and for the search's process pools: their fork server imports the
# workers' module once, through its own path, which older Python 3.12
# releases take from PYTHONPATH and not from this process's sys.path
os.environ["PYTHONPATH"] = os.pathsep.join(
    p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.launch import kernel_bench as kb  # noqa: E402

F32_TOL, BF16_TOL = 2e-5, 3e-2           # TOL of tests/test_kernels.py
SSD_F32_TOL = 2e-3                       # tests/test_kernels.py's SSD bar
# bf16 SSD: max |kernel - plain| <= 1e-2 * max |plain|.  Both sides round
# y to bf16, one step of which is up to 2^-7 of the largest |y|, and the
# kernel rounds the decayed X and the state to bf16 for two of its products
# (2^-9 relative each); an element's error follows the size of the terms
# it sums, not its own value.
SSD_BF16_TOL = 1e-2
# mamba2 smoke logits, kernel path against plain path (f32 config, bf16 SSD
# inputs on both): the kernel's bf16 products put them 2.2e-3 apart on the
# H100, while a 1% gain error in the scan's output moves them by 4e-2
# (tests/test_torch_ssm.py::test_mamba2_logit_bar_catches_scan_faults).
MAMBA_PATH_TOL = 1e-2
KERNEL_SOURCES = ("flash_attention", "ssd_scan", "gemm_epilogue",
                  "streamed_gemm")
GEMM_KERNELS = ("gemm_softmax", "gemm_layernorm", "gemm_rmsnorm")
# what the kernels line keeps of a kernel's record at a family's shape
FAMILY_KEYS = ("shape", "max_abs_err", "ms", "device_ms", "plain_ms",
               "bound_ms", "bound_by", "library_ms", "library_device_ms",
               "tile")


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    log(f"== {name}")
    return time.perf_counter()


def device_profile(fn):
    """Run ``fn`` once under ``torch.profiler``; returns the summed device
    time of its kernels (ms) and (kernel name, ms) pairs, largest first."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and e.name != "Command Buffer Full":
            per_name[e.name] = per_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    return sum(per_name.values()), sorted(per_name.items(),
                                          key=lambda kv: -kv[1])


def host_profile(fn, top=12):
    """Run ``fn`` once under ``torch.profiler`` (CPU activity): its host
    ops by self CPU time, largest first, as (name, calls, self ms)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return [[e.key[:80], e.count, e.self_cpu_time_total / 1e3]
            for e in rows[:top]]


def ptxas_summary(log_text: str):
    """(kernel entry, registers/shared-memory line, spill line) for every
    instance that ``nvcc -Xptxas -v`` reports."""
    out, entry, spill = [], None, ""
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        elif "spill" in line:
            spill = line.split(":", 1)[-1].strip()
        elif "Used" in line and entry:
            out.append((entry, line.split(":", 1)[-1].strip(), spill))
    return out


def attn_inputs(gen, B, Hq, Hkv, Sq, Skv, D, dtype, model_layout=False):
    """q/k/v on the card; ``model_layout`` gives (B, H, S, D) views of
    (B, S, H, D) tensors, as the model hands them to the kernel."""
    def make(H, S):
        if model_layout:
            return torch.randn(B, S, H, D, generator=gen, device="cuda",
                               dtype=dtype).transpose(1, 2)
        return torch.randn(B, H, S, D, generator=gen, device="cuda",
                           dtype=dtype)
    return make(Hq, Sq), make(Hkv, Skv), make(Hkv, Skv)


def gemm_inputs(gen, M, K, N, dtype, kind="normal"):
    """a (M, K), b (K, N) in ``dtype`` and f32 gamma/beta (N,) on the card.
    ``spike``: column N - 1 of C is larger than the rest by about 30, so
    each row's max lies in the last CTA's slice.  ``mean_1e3``: every row
    of C is 1000 plus a sum of 31 products of {-1, 0, 1} and {-0.25, 0,
    0.25} (std about 0.9); all of it exact in bf16 and f32, so only the
    statistics can err."""
    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale
    if kind == "mean_1e3":
        a = torch.randint(-1, 2, (M, K), generator=gen, device="cuda")
        b = torch.randint(-1, 2, (K, N), generator=gen, device="cuda") * 0.25
        a[:, 0], b[0] = 1, 1000.0
        a, b = a.to(dtype), b.to(dtype)
    else:
        a, b = rand(M, K).to(dtype), rand(K, N, scale=0.2).to(dtype)
        if kind == "spike":
            a[:, 0], b[0, N - 1] = 1, 30.0
    return a, b, rand(N), rand(N)


def gemm_entry(name, a, b, gamma, beta):
    """The ``ops`` entry of fused kernel ``name`` on these inputs, as a
    function of ``use_kernel``."""
    from repro_torch.kernels import ops
    return {"gemm_softmax": lambda k: ops.fused_gemm_softmax(
                a, b, use_kernel=k),
            "gemm_layernorm": lambda k: ops.fused_gemm_layernorm(
                a, b, gamma, beta, use_kernel=k),
            "gemm_rmsnorm": lambda k: ops.fused_gemm_rmsnorm(
                a, b, gamma, use_kernel=k)}[name]


def gemm_check(name, a, b, gamma, beta):
    """The fused kernel of ``name`` against its plain version on the same
    inputs, both through the ``ops`` entry: (max abs error, max |plain|,
    tolerance, passed)."""
    from repro_torch.kernels import gemm_epilogue as ge
    entry = gemm_entry(name, a, b, gamma, beta)
    out, want = entry(True), entry(False)
    torch.cuda.synchronize()
    if out.dtype != a.dtype or out.shape != want.shape:
        raise AssertionError(f"{name}: output {out.dtype} "
                             f"{tuple(out.shape)}, want {a.dtype} "
                             f"{tuple(want.shape)}")
    err = float((out.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    tol = ge.tolerance(name[len("gemm_"):], a.dtype, scale)
    return err, scale, tol, err <= tol and bool(torch.isfinite(out).all())


def serve_and_profile(name, model, params, dev, *, batch, prompt_len,
                      cache_len, n_requests, max_new, counters, seed=0,
                      mesh=None):
    """Serve ``n_requests`` random prompts through a ``batch``-slot engine
    after a warm-up run, with every kernel's count set to 0 just before and
    read just after; then time and profile one prefill and one decode step
    of that batch.  With ``mesh``, the engine and the model serve on it
    (``params`` this rank's shards) and the run's collectives are counted
    by label.  Returns the record (the requests' tokens in it) and the
    launch counts."""
    from repro_torch.parallel.collective_planner import record_collectives
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = model.cfg
    rng = np.random.default_rng(seed)

    def requests(n, new):
        return [Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, size=prompt_len).astype(np.int32),
            max_new_tokens=new) for i in range(n)]

    def engine():
        return ServeEngine(model, params, batch_size=batch,
                           cache_len=cache_len, prompt_len=prompt_len,
                           mesh=mesh)

    engine().run(requests(batch, 2))      # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng, reqs = engine(), requests(n_requests, max_new)
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "chunks"):
            fn.chunks = {}
    t_run = time.perf_counter()
    with record_collectives() as rec_run:
        done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = {k: fn.launches for k, fn in counters.items()}
    chunks = {k: dict(fn.chunks) for k, fn in counters.items()
              if hasattr(fn, "chunks")}
    n_tok = sum(len(r.output) for r in done)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  requests {len(done)}  tokens {n_tok}  wall_s {wall:.3f}  "
        f"tok_per_s {n_tok / wall:.1f}  prefill_calls "
        f"{eng.stats['prefill_calls']}  decode_steps "
        f"{eng.stats['decode_steps']}  peak_mem_gb {peak_gb:.2f}  "
        f"launches {launches}")
    if not all(len(r.output) == max_new and r.done for r in done):
        raise AssertionError("a request did not get all its tokens")
    toks = torch.from_numpy(np.stack([r.prompt for r in done[:batch]])) \
        .long().to(dev)
    inputs = {"tokens": toks}
    if cfg.is_encdec:   # seeded frames: the cross-attention sees real keys
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        inputs["src_embeds"] = torch.randn(
            batch, max(1, prompt_len // cfg.enc_ratio), cfg.d_model,
            generator=gen, device=dev)
    logits, cache = model.prefill(params, inputs, cache_len, mesh)
    step, _ = model.decode(params, cache, logits[:, -1].argmax(-1)[:, None],
                           mesh, cache_len)
    if not (torch.isfinite(logits).all() and torch.isfinite(step).all()):
        raise AssertionError(f"{name} logits are not finite")
    if logits.shape != (batch, 1, cfg.padded_vocab):
        raise AssertionError(f"prefill logits shape {tuple(logits.shape)}")
    # where the time goes: one prefill and one decode step of this batch,
    # timed with CUDA events, then their kernels under the profiler
    tok = logits[:, -1].argmax(-1)[:, None]

    def run_prefill():
        return model.prefill(params, inputs, cache_len, mesh)

    def run_decode():
        return model.decode(params, cache, tok, mesh, cache_len)

    prefill_ms = kb.cuda_ms(run_prefill, iters=3, warmup=1)
    decode_ms = kb.cuda_ms(run_decode, iters=10)
    breakdown = {"prefill_ms": prefill_ms, "decode_step_ms": decode_ms}
    for step_name, fn, ms in (("prefill", run_prefill, prefill_ms),
                              ("decode_step", run_decode, decode_ms)):
        busy, ranked = device_profile(fn)
        own = {k: sum(t for n, t in ranked if sym in n)
               for k, sym in (("flash_attention", "fa_fwd"),
                              ("ssd_scan", "ssd_fwd"))}
        top = ranked[:6]
        breakdown[step_name] = {
            "kernel_ms": busy, "idle_share": 1 - busy / ms,
            **{f"{k}_ms": v for k, v in own.items()},
            "top_kernels": [[n[:80], t] for n, t in top]}
        log(f"  {step_name}: {ms:.2f} ms (CUDA events), kernels {busy:.2f} "
            f"ms (profiler), idle share {100 * (1 - busy / ms):.1f}%, "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in own.items()))
        for n, t in top:
            log(f"    {t:9.3f} ms  {n[:100]}")
    record = {"requests": len(done), "tokens": n_tok, "wall_s": wall,
              "tok_per_s": n_tok / wall,
              "prefill_calls": eng.stats["prefill_calls"],
              "decode_steps": eng.stats["decode_steps"],
              "peak_mem_gb": peak_gb, "launches": launches,
              "launch_chunks": chunks, "breakdown": breakdown,
              "outputs": [r.output for r in done]}
    if mesh is not None:
        record["collectives"] = _counted(rec_run)
        log(f"  collectives of the run (label: count, MB): "
            f"{record['collectives']}")
        # the host's share of a mesh decode step, op by op
        ops = host_profile(run_decode)
        record["decode_host_ops"] = ops
        log(f"  decode step's top host ops by self CPU time (profiler, "
            f"one step): name, calls, ms")
        for n, c, t in ops:
            log(f"    {t:9.3f} ms  {c:5d}  {n}")
    return record, launches


def batching_matches_serial(model, params, prompt_len, cache_len):
    """7 requests through 3 slots give each request the tokens of its
    serial 1-slot run."""
    from repro_torch.serve.engine import Request, ServeEngine
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=12)
               .astype(np.int32) for _ in range(7)]
    new_tokens = [5, 3, 4, 6, 2, 5, 3]
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, new_tokens))]
    ServeEngine(model, params, batch_size=3, cache_len=cache_len,
                prompt_len=prompt_len).run(reqs)
    one = ServeEngine(model, params, batch_size=1, cache_len=cache_len,
                      prompt_len=prompt_len)
    for i, (p, n) in enumerate(zip(prompts, new_tokens)):
        ref = Request(rid=100 + i, prompt=p.copy(), max_new_tokens=n)
        one.run([ref])
        if reqs[i].output != ref.output:
            raise AssertionError(f"request {i}: 3-slot {reqs[i].output} != "
                                 f"serial {ref.output}")


def plan_warmup_check(name, model, params, plan_root, *, batch, prompt_len,
                      cache_len):
    """Point ``$REPRO_PLAN_CACHE`` at a fresh directory under ``plan_root``
    and build the engine twice on it: the cold engine must solve every
    plan job of its shapes and hit none, the warm one (over the same
    store, the in-memory layer dropped as in a second process) hit every
    job and solve none.  The directory stays the store for the rest of the
    phase.  Returns the record."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.kernels.autotune import plan_jobs
    from repro_torch.serve.engine import ServeEngine
    os.environ["REPRO_PLAN_CACHE"] = tempfile.mkdtemp(prefix=name,
                                                      dir=plan_root)
    rec = {}
    for kind in ("cold", "warm"):
        if kind == "warm":
            with plan_mod._CACHES_LOCK:
                plan_mod._CACHES.clear()
        eng = ServeEngine(model, params, batch_size=batch,
                          cache_len=cache_len, prompt_len=prompt_len)
        n_jobs = len(plan_jobs(eng.plan_shapes()))
        st = {k: eng.stats[f"plan_warmup_{k}"] for k in ("solved", "hits",
                                                         "s")}
        store = plan_mod.get_plan_cache().store_stats()["store"]
        log(f"  plan warmup ({kind}): {n_jobs} jobs of {eng.plan_shapes()}: "
            f"solved {st['solved']}, hits {st['hits']}, "
            f"{1e3 * st['s']:.2f} ms; store {store.get('backend')} with "
            f"{store.get('plans', 0)} plans")
        want = (n_jobs, 0) if kind == "cold" else (0, n_jobs)
        if n_jobs == 0 or (st["solved"], st["hits"]) != want:
            raise AssertionError(f"{name}: the {kind} engine's warmup solved "
                                 f"{st['solved']} and hit {st['hits']} of "
                                 f"{n_jobs} jobs; want {want}")
        rec[kind] = dict(st, jobs=n_jobs, store=store.get("backend"))
    return rec


def plan_ms(job, times=1):
    """The COMET plan's modelled latency (ms) of a plan job (an autotune
    ``*_plan_job`` tuple), times ``times``: information beside a measured
    time, never a gate."""
    from repro_torch.core.plan import get_plan_cache
    co, arch, kw = job[:3]
    return 1e3 * times * get_plan_cache().resolve(co, arch, **kw).latency_s


# kernel path against plain path at step 0 of a bf16 training phase
TRAIN_LOSS_RTOL, TRAIN_GRAD_COS, TRAIN_NORM_RTOL = 1e-2, 0.99, 0.02
# mamba2's bf16 gradients at step 0 have a noise floor above those bars:
# the plain path at chunk 32 against itself at chunk 64 (the same math
# summed in another order) reached a worst leaf cosine of 0.9848 and a
# norm 3.2% apart on the H100.  There the bars are FLOOR_FACTOR times the
# floor measured in the same run, where that is looser than the above,
# and never looser than cosine 0.9 and norms 20% apart.
FLOOR_CHUNK, FLOOR_FACTOR = 32, 4
# the f32 smoke step: the CPU parity bars of tests/test_torch_train.py
# (GRAD_TOL: "ssd" for a family with an SSD mixer, else "f32")
SMOKE_LOSS_RTOL, SMOKE_GRAD_TOL = 1e-5, {"f32": 1e-4, "ssd": 1e-2}
TRAIN_STEPS = 6


def kernel_layers(cfg):
    """{kernel: how many times one forward pass of ``cfg`` launches it}:
    FlashAttention once an attention layer (MLA reaches no kernel; an
    enc-dec model's encoder layers once, its decoder layers twice, self
    and cross), the SSD scan once an SSD layer."""
    fa = 0
    if cfg.has_attention and cfg.attn_type != "mla":
        fa = cfg.n_enc_layers + 2 * cfg.n_layers if cfg.is_encdec \
            else cfg.n_layers
    return {"flash_attention": fa,
            "ssd_scan": cfg.n_layers if cfg.has_ssm else 0}


def train_data(cfg, seq, batch):
    """``SyntheticLM`` at seed 0, with an enc-dec model's frames."""
    from repro_torch.train.data import SyntheticLM
    return SyntheticLM(cfg.vocab_size, seq, batch, seed=0,
                       encdec=cfg.is_encdec, d_model=cfg.d_model,
                       enc_ratio=cfg.enc_ratio)


def to_dev(batch, dev):
    """A numpy batch on ``dev``: token ids as int64, frames as they are."""
    return {k: torch.from_numpy(v).to(dev, torch.long if v.dtype.kind in
                                       "iu" else None)
            for k, v in batch.items()}


def grad_agreement(gk, gp):
    """Per leaf of two gradient trees: (name, cosine similarity, |norm
    ratio - 1|) of the kernel path's gradient against the plain path's,
    both summed in f32."""
    from repro_torch.train.checkpoint import flatten_with_names
    out = []
    for (name, a), (_, b) in zip(flatten_with_names(gk),
                                 flatten_with_names(gp)):
        a, b = a.float().flatten(), b.float().flatten()
        na, nb = float(a.norm()), float(b.norm())
        cos = float(torch.dot(a, b)) / (na * nb) if na * nb else \
            float(na == nb)
        out.append((name, cos, abs(na / nb - 1) if nb else abs(na)))
    return out


def section_ms(fn):
    """Run one train step ``fn`` with CUDA events around every call of the
    autograd wrappers' recompute backward (``_FlashAttention.backward``,
    ``_SSDScan.backward``) and of ``adamw_update``: the ms of each on the
    card's stream, summed over the step."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    from repro_torch.train import train_step as ts
    spans = {"recompute_backward": [], "adamw_update": []}

    def timed(key, f):
        def wrapper(*args, **kwargs):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = f(*args, **kwargs)
            ev[1].record()
            spans[key].append(ev)
            return out
        return wrapper

    saved = (fa._FlashAttention.backward, ssd._SSDScan.backward,
             ts.adamw_update)
    fa._FlashAttention.backward = staticmethod(
        timed("recompute_backward", saved[0]))
    ssd._SSDScan.backward = staticmethod(timed("recompute_backward",
                                               saved[1]))
    ts.adamw_update = timed("adamw_update", saved[2])
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        fa._FlashAttention.backward = staticmethod(saved[0])
        ssd._SSDScan.backward = staticmethod(saved[1])
        ts.adamw_update = saved[2]
    return {k: sum(a.elapsed_time(b) for a, b in v)
            for k, v in spans.items()}


def profile_step(one_step, name):
    """Where the time of a train step goes: one call of ``one_step`` timed
    with CUDA events, one with CUDA events around the recompute backward
    and AdamW (``section_ms``), one under ``torch.profiler`` (kernel time,
    idle share, the hand-written kernels' time, the top kernels).  Returns
    the record."""
    ms = kb.cuda_ms(one_step, iters=1, warmup=1)
    under = section_ms(one_step)
    busy, ranked = device_profile(one_step)
    own = {k: sum(t for n, t in ranked if sym in n)
           for k, sym in (("flash_attention", "fa_fwd"),
                          ("ssd_scan", "ssd_fwd"))}
    rec = {"step_ms": ms, "kernel_ms": busy, "idle_share": 1 - busy / ms,
           **{f"{k}_ms": v for k, v in own.items()},
           "recompute_backward_ms": under["recompute_backward"],
           "adamw_update_ms": under["adamw_update"],
           "top_kernels": [[n[:80], t] for n, t in ranked[:8]]}
    log(f"  {name}, one step: {ms:.2f} ms (CUDA events), kernels "
        f"{busy:.2f} ms (profiler), idle share {100 * (1 - busy / ms):.1f}%;"
        f" " + ", ".join(f"{k} {v:.3f} ms ({100 * v / busy:.1f}% of the "
                         f"kernel time)" for k, v in own.items())
        + f"; by CUDA events, the plain recompute backward "
        f"{under['recompute_backward']:.2f} ms "
        f"({100 * under['recompute_backward'] / ms:.1f}% of the step), "
        f"AdamW {under['adamw_update']:.2f} ms "
        f"({100 * under['adamw_update'] / ms:.1f}%)")
    for n, t in ranked[:8]:
        log(f"    {t:9.3f} ms  {n[:100]}")
    return rec


def train_phase(arch, dev, counters, *, batch, seq, cut, n_layers=None,
                ckpt_dir=None, steps=TRAIN_STEPS):
    """The training path of ``arch`` (bf16, ``use_kernels=True``, remat
    "full"; ``n_layers`` of its layers when given) on the card, every
    check failing the run; each kernel the model reaches
    (:func:`kernel_layers`) launches that many times a forward pass:

    - step 0, kernel path against plain path on the same params and batch:
      the loss within TRAIN_LOSS_RTOL, every gradient leaf at cosine >=
      TRAIN_GRAD_COS with a norm within TRAIN_NORM_RTOL (for an SSD model,
      or FLOOR_FACTOR x the plain path's disagreement with itself at
      chunk FLOOR_CHUNK, where that is looser); each kernel launched
      twice its layers (forward and remat recompute), the plain path not
      at all; a model that reaches no kernel skips this and the next;
    - the f32 smoke config, kernel path against plain path, within the CPU
      parity bars (SMOKE_LOSS_RTOL, SMOKE_GRAD_TOL);
    - ``steps`` steps of ``train_loop`` (plans warmed; with an
      ``AsyncCheckpointer`` save at step 3 and at the end when
      ``ckpt_dir``), counts set to 0 just before and read just after:
      each kernel launched steps x 2 x its layers times, every SSD launch
      at the plan's chunk, finite losses; the checkpoint restores bit for
      bit into a fresh TrainState;
    - one step without remat: each kernel launched once its layers;
    - where the time of a step goes (:func:`profile_step`).

    Returns the record and the main run's launches."""
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.kernels import autotune
    from repro_torch.launch.train import train_loop
    from repro_torch.models.model import Model
    from repro_torch.train.checkpoint import (flatten_with_names,
                                              latest_step, restore_checkpoint)
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import (TrainState, make_loss_fn,
                                              make_train_step, value_and_grad)
    cfg = get_config(arch).with_(use_kernels=True)
    if n_layers:
        cfg = cfg.with_(n_layers=n_layers)
    name, L = cfg.name, cfg.n_layers
    per_pass = kernel_layers(cfg)

    def zero_counts():
        for f in counters.values():
            f.launches = 0
            if hasattr(f, "chunks"):
                f.chunks = {}

    def counts():
        return {k: f.launches for k, f in counters.items()}

    def want(times):
        return {k: times * per_pass.get(k, 0) for k in counters}

    rec = {"config": name, "layers": L, "batch": batch, "seq": seq,
           "cut": cut, "launches_per_pass": per_pass}
    log(f"  {name}: {cut}; {L} layers, d_model {cfg.d_model}, batch "
        f"{batch} x seq {seq}, bf16, remat {cfg.remat_policy}; kernel "
        f"launches a forward pass {per_pass}")
    # ---- step 0: kernel path against plain path, full size
    model = Model(cfg)
    params = model.init(0, device=dev)
    n_params = model.n_params()
    rec["params_b"] = n_params / 1e9
    log(f"  {n_params / 1e9:.3f} B params: bf16 params and grads and f32 "
        f"AdamW moments {12 * n_params / 1e9:.1f} GB")
    b0 = to_dev(train_data(cfg, seq, batch).batch(0), dev)
    if any(per_pass.values()):
        zero_counts()
        lk, gk = value_and_grad(make_loss_fn(model), params, b0)
        torch.cuda.synchronize()
        grad_launches = counts()
        lp, gp = value_and_grad(
            make_loss_fn(Model(cfg.with_(use_kernels=False))), params, b0)
        torch.cuda.synchronize()
        if (grad_launches, counts()) != (want(2), want(2)):
            raise AssertionError(f"{name}: launches {grad_launches} in the "
                                 f"kernel path's gradient, {counts()} after "
                                 f"the plain path's; want {want(2)} for "
                                 f"both")
        agree = grad_agreement(gk, gp)
        loss_err = abs(float(lk) / float(lp) - 1)
        worst_cos = min(agree, key=lambda x: x[1])
        worst_norm = max(agree, key=lambda x: x[2])
        cos_bar, norm_bar = TRAIN_GRAD_COS, TRAIN_NORM_RTOL
        rec["step0"] = {"loss_kernel": float(lk), "loss_plain": float(lp),
                        "loss_rel_err": loss_err,
                        "leaves": [list(x) for x in agree]}
        if cfg.has_ssm:
            # the floor: the plain path against itself at another chunk
            from repro_torch.models import ssm
            plan_chunk = ssm.plan_chunk
            ssm.plan_chunk = lambda *_: FLOOR_CHUNK
            try:
                _, gf = value_and_grad(make_loss_fn(Model(cfg.with_(
                    use_kernels=False))), params, b0)
            finally:
                ssm.plan_chunk = plan_chunk
            floor = grad_agreement(gf, gp)
            f_cos = min(x[1] for x in floor)
            f_norm = max(x[2] for x in floor)
            cos_bar = min(cos_bar, max(0.9, 1 - FLOOR_FACTOR * (1 - f_cos)))
            norm_bar = max(norm_bar, min(0.2, FLOOR_FACTOR * f_norm))
            log(f"  step 0, the bf16 floor: the plain path at chunk "
                f"{FLOOR_CHUNK} against itself at the plan's: worst cosine "
                f"{f_cos:.6f}, worst norm ratio - 1 {f_norm:.2e}; bars "
                f"{FLOOR_FACTOR} x the floor: cosine >= {cos_bar:.4f}, norm "
                f"within {norm_bar:.4f}")
            rec["step0"].update(floor_cos=f_cos, floor_norm=f_norm)
            del gf
        log(f"  step 0, kernel vs plain: loss {float(lk):.6f} vs "
            f"{float(lp):.6f} (rel {loss_err:.2e}, tol {TRAIN_LOSS_RTOL}); "
            f"worst cosine {worst_cos[1]:.6f} ({worst_cos[0]}, tol >= "
            f"{cos_bar:.4f}); worst norm ratio - 1 {worst_norm[2]:.2e} "
            f"({worst_norm[0]}, tol {norm_bar:.4f})")
        rec["step0"].update(cos_bar=cos_bar, norm_bar=norm_bar)
        if not (loss_err <= TRAIN_LOSS_RTOL and worst_cos[1] >= cos_bar
                and worst_norm[2] <= norm_bar):
            raise AssertionError(f"{name}: the kernel path's step 0 "
                                 f"disagrees with the plain path's")
        del gk, gp
    else:
        log("  no kernel on this model's path (MLA takes the blocked "
            "loop): no kernel path to hold against the plain one")
    del params, model
    torch.cuda.empty_cache()
    # ---- the f32 smoke config: kernel path against plain path
    scfg = get_smoke_config(arch).with_(dtype="float32", use_kernels=True)
    if any(kernel_layers(scfg).values()):
        sparams = Model(scfg).init(0, device=dev)
        # a windowed smoke model at up to 2 windows, where the attention
        # takes the kernel (from 2 on it takes the banded path)
        sseq = 64 if not scfg.window or 64 < 2 * scfg.window \
            else 3 * scfg.window // 2
        sb = to_dev(train_data(scfg, sseq, 4).batch(0), dev)
        l1, g1 = value_and_grad(make_loss_fn(Model(scfg)), sparams, sb)
        l2, g2 = value_and_grad(make_loss_fn(Model(scfg.with_(
            use_kernels=False))), sparams, sb)
        s_loss = abs(float(l1) / float(l2) - 1)
        s_grad = max(float((a - b).abs().max() / b.abs().max())
                     for (_, a), (_, b) in zip(flatten_with_names(g1),
                                               flatten_with_names(g2)))
        gtol = SMOKE_GRAD_TOL["ssd" if scfg.has_ssm else "f32"]
        log(f"  f32 smoke step (seq {sseq}), kernel vs plain: loss rel "
            f"{s_loss:.2e} (tol {SMOKE_LOSS_RTOL}), worst gradient leaf "
            f"max|diff| / max|plain| {s_grad:.2e} (tol {gtol})")
        rec["f32_smoke"] = {"loss_rel_err": s_loss, "grad_rel_err": s_grad}
        if not (s_loss <= SMOKE_LOSS_RTOL and s_grad <= gtol):
            raise AssertionError(f"{name}: the f32 smoke step's kernel "
                                 f"path disagrees with the plain path")
        del sparams, g1, g2
    # ---- ``steps`` steps of train_loop, the counts of this run alone
    model = Model(cfg)
    opt_cfg = OptConfig(total_steps=steps, warmup_steps=1)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    out = train_loop(model, steps=steps, batch=batch, seq=seq,
                     opt_cfg=opt_cfg, ckpt_dir=ckpt_dir, ckpt_every=3,
                     warmup_plans=True, log_every=1, device=dev)
    torch.cuda.synchronize()
    launches = counts()
    if launches != want(2 * steps) or any(
            out["launches"][k] != want(2 * steps)[k] for k in out["launches"]):
        raise AssertionError(f"{name}: launches {launches} over {steps} "
                             f"steps; want {want(2 * steps)}")
    if per_pass["ssd_scan"]:
        fn = counters["ssd_scan"]
        plan = autotune.ssd_chunk_len(seq, cfg.ssm_headdim, cfg.ssm_state)
        if fn.chunks != {plan: launches["ssd_scan"]}:
            raise AssertionError(f"{name}: ssd_scan launches by chunk "
                                 f"{fn.chunks}; want all at the plan's "
                                 f"{plan}")
        rec["plan_chunk"] = plan
        log(f"  every ssd_scan launch at the plan's chunk {plan}: "
            f"{fn.chunks}")
    losses = out["losses"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: losses {losses}")
    timed = out["step_ms"][1:]           # steps 2 on
    step_ms = sum(timed) / len(timed)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  launches {launches} == {steps} steps x 2 x {per_pass}")
    log(f"  losses {[round(x, 4) for x in losses]}; falls: "
        f"{losses[-1] < losses[0]} (logged, not gated)")
    log(f"  step ms (CUDA events, steps 2-{steps}) "
        f"{[round(x, 2) for x in timed]}: mean {step_ms:.2f} ms, "
        f"{batch * seq / step_ms * 1e3:.0f} tokens/s; peak memory "
        f"{peak:.2f} GB")
    rec.update(losses=losses, step_ms=out["step_ms"], mean_step_ms=step_ms,
               tokens_per_s=batch * seq / step_ms * 1e3, launches=launches,
               peak_mem_gb=peak)
    state = out["state"]
    # ---- the checkpoint restores bit for bit
    if ckpt_dir:
        fresh = model.init(1, device=dev)
        restored, step, _ = restore_checkpoint(
            ckpt_dir, TrainState(fresh, init_opt_state(fresh)))
        got, ref = flatten_with_names(restored), flatten_with_names(state)
        same = len(got) == len(ref) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for (_, a), (_, b) in zip(got, ref))
        _, step3, _ = restore_checkpoint(
            ckpt_dir, TrainState(fresh, init_opt_state(fresh)), step=3)
        if not (same and step == latest_step(ckpt_dir) == steps
                and step3 == 3):
            raise AssertionError(f"{name}: checkpoint of step {step} does "
                                 f"not restore bit for bit")
        log(f"  checkpoints at steps 3 and {steps} (AsyncCheckpointer,"
            f" no errors); step {steps} restores bit for bit into a "
            f"fresh TrainState ({len(got)} tensors, the step among them)")
        del fresh, restored
    # ---- one step without remat: each kernel once its layers
    zero_counts()
    state, _ = make_train_step(Model(cfg.with_(remat=False)), opt_cfg)(
        state, b0)
    torch.cuda.synchronize()
    if counts() != want(1):
        raise AssertionError(f"{name}: launches {counts()} in a step "
                             f"without remat; want {want(1)}")
    log(f"  one step without remat: launches {counts()} == once a layer")
    # ---- where the time of a step goes
    step_fn = make_train_step(model, opt_cfg)
    holder = [state]

    def one_step():
        holder[0], _ = step_fn(holder[0], b0)

    rec["profile"] = profile_step(one_step, name)
    del holder, state, out, model, step_fn
    torch.cuda.empty_cache()
    return rec, launches


def family_attention_check(gen, arch, m=None):
    """FlashAttention at the shape where ``arch``'s serving prefill reaches
    it (``kernel_bench.FAMILY_ATTENTION_SHAPES``; with ``m``, where one rank
    of a model axis of m reaches it, ``RANK_ATTENTION_SHAPES``: k/v views
    of the rank's projection of kv heads), model layout, bf16, against
    ``attention_ref`` elementwise within BF16_TOL, then timed by
    ``kernel_bench.bench_attention`` (CUDA events and device time of the
    kernel, the plain version and SDPA, and the bound).  Returns the
    record."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref
    if m is None:
        shape = kb.FAMILY_ATTENTION_SHAPES[arch]
        B, Hq, Hkv, Sq, Skv, D, causal, window = shape
        kv_of, where = Hkv, f"{arch}'s shape"
    else:
        B, Hq, Hkv, Sq, Skv, D, causal, window, kv_of = \
            kb.RANK_ATTENTION_SHAPES[(arch, m)]
        where = f"{arch}'s rank shape at m = {m}"
    q = torch.randn(B, Sq, Hq, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16).transpose(1, 2)
    k, v = [torch.randn(B, Skv, kv_of, D, generator=gen, device="cuda",
                        dtype=torch.bfloat16)[:, :, :Hkv].transpose(1, 2)
            for _ in range(2)]
    out = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    diff = (out.float() - want.float()).abs()
    err = float(diff.max())
    if not bool((diff <= BF16_TOL + BF16_TOL * want.float().abs()).all()):
        raise AssertionError(f"flash_attention disagrees at {where}: "
                             f"{err}")
    del out, want, diff
    rec = kb.bench_attention(q, k, v, causal=causal, window=window)
    t = fa.tiling(B, Hq, Hkv, Sq, Skv, D, torch.bfloat16)
    log(f"  flash_attention at {where} q {tuple(q.shape)} k/v "
        f"{tuple(k.shape)} causal {causal} window {window}: tiling "
        f"{t.heads} head(s) a work item, {t.items} items; max_abs_err "
        f"{err:.3e} (tol {BF16_TOL}); kernel_ms {rec['ms']:.4f} device_ms "
        f"{rec['device_ms']:.4f}  plain_ms {rec['plain_ms']:.4f}  "
        f"library_ms {rec['library_ms']:.4f} (device "
        f"{rec['library_device_ms']:.4f}; {rec['library']})  bound_ms "
        f"{rec['bound_ms']:.4f} ({rec['bound_by']}, "
        f"{rec['flops'] / 1e9:.2f} GFLOP of the visible pairs)")
    return rec


def rank_ssd_check(gen, arch, m):
    """The SSD scan at one rank's heads of a model axis of m
    (``kernel_bench.RANK_SSD_SHAPES``, bf16, B/C views of the gathered conv
    output) at the plan's chunk, against ``ssd_chunked_ref`` within
    SSD_BF16_TOL of the largest |y|, then timed by ``bench_ssd``.  Returns
    the record."""
    from repro_torch.kernels import autotune
    shape = kb.RANK_SSD_SHAPES[(arch, m)]
    chunk = autotune.ssd_chunk_len(shape["S"], shape["P"], shape["N"])
    x, dA, Bm, Cm = kb.ssd_inputs(gen, shape, torch.bfloat16, "cuda")
    rec = kb.bench_ssd(x, dA, Bm, Cm, chunk=chunk)
    if rec["max_abs_err"] > SSD_BF16_TOL * rec["max_abs_plain"]:
        raise AssertionError(f"ssd_scan disagrees at {arch}'s rank shape at "
                             f"m = {m}: {rec['max_abs_err']}")
    log(f"  ssd_scan at {arch}'s rank shape at m = {m}: xdt "
        f"{tuple(x.shape)} B/C {tuple(Bm.shape)} (strides {Bm.stride()}), "
        f"chunk {chunk}: max_abs_err {rec['max_abs_err']:.3e} (max |plain| "
        f"{rec['max_abs_plain']:.2f}, tol {SSD_BF16_TOL} of it); kernel_ms "
        f"{rec['ms']:.4f} device_ms {rec['device_ms']:.4f}  plain_ms "
        f"{rec['plain_ms']:.4f}  library_ms null  bound_ms "
        f"{rec['bound_ms']:.4f} ({rec['bound_by']}); {rec['tile']}")
    return rec


def collective_probe(mesh, cfg, calls=100):
    """Host milliseconds a call, synchronised, of a one-rank NCCL
    All-Reduce (through ``collective_planner.collective``, unrecorded) of a
    decode step's (4, 1, d_model) residual and of a prefill's (4, 1024,
    d_model), beside a ``clone`` of each: what each one-rank collective of
    the mesh path adds to a step."""
    from repro_torch.parallel.collective_planner import collective, model_axis
    group = model_axis(mesh)[2]
    out = {}
    for name, rows in (("decode", 1), ("prefill", 1024)):
        x = torch.randn(4, rows, cfg.d_model, device="cuda",
                        dtype=torch.bfloat16)
        for what, fn in (("all_reduce", lambda: collective(
                "AllReduce", "probe", x, group)), ("clone", x.clone)):
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            out[f"{name}_{what}"] = (time.perf_counter() - t) * 1e3 / calls
    log(f"  one-rank collective probe (host ms a call, synchronised, "
        f"{calls} calls): " + ", ".join(f"{k} {v:.4f}"
                                        for k, v in out.items()))
    return out


def mesh_serve(arch, dev, counters, plan_root, plain, *, batch, prompt_len,
               cache_len, n_requests, max_new, want, knob=None):
    """Serve ``arch`` at full size (the config ``knob`` set) through
    ``ServeEngine(mesh=make_host_mesh())`` (the one-card (1, 1) NCCL mesh,
    params placed by ``param_shardings``) with the requests of ``plain``
    (its serve record without a mesh): the same greedy tokens, the
    launches ``want``.  Returns the record."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models.model import Model
    from repro_torch.parallel.sharding import param_shardings, shard_tree
    cfg = get_config(arch).with_(use_kernels=True, **(knob or {}))
    model = Model(cfg)
    mesh = tmesh.make_host_mesh(device=dev)
    try:
        params = shard_tree(model.init(0, device=dev),
                            param_shardings(model.specs, mesh), mesh)
        os.environ["REPRO_PLAN_CACHE"] = tempfile.mkdtemp(
            prefix=f"{arch}-mesh", dir=plan_root)
        rec, got = serve_and_profile(
            f"{arch} on the (1, 1) mesh", model, params, dev, batch=batch,
            prompt_len=prompt_len, cache_len=cache_len,
            n_requests=n_requests, max_new=max_new, counters=counters,
            mesh=mesh)
        rec["one_rank_collective_ms"] = collective_probe(mesh, cfg)
    finally:
        tmesh.destroy()
    expect_launches(f"{arch} on the mesh", got, want)
    if rec["outputs"] != plain["outputs"]:
        raise AssertionError(f"{arch}: the mesh engine's tokens "
                             f"{rec['outputs']} != without a mesh "
                             f"{plain['outputs']}")
    labels = {k.split()[0] for k in rec["collectives"]}
    if not {"tp/embed", "tp/attn-out", "serve/argmax"} <= labels:
        raise AssertionError(f"{arch}: collectives {rec['collectives']}")
    for step in ("prefill", "decode_step"):
        ms = rec["breakdown"][f"{step}_ms"]
        base = plain["breakdown"][f"{step}_ms"]
        log(f"  {step}: {ms:.2f} ms on the mesh, {base:.2f} ms without one "
            f"({100 * (ms / base - 1):+.1f}%)")
    log(f"  the greedy tokens of {len(rec['outputs'])} requests equal the "
        f"engine's without a mesh")
    del params, model
    torch.cuda.empty_cache()
    return rec


def family_serve(arch, dev, counters, plan_root, *, batch, prompt_len,
                 cache_len, n_requests, max_new, n_layers=None,
                 cut="nothing cut"):
    """Serve ``arch`` at full width (``n_layers`` of its layers when given),
    bf16, ``use_kernels=True``, random weights from seed 0, on a fresh plan
    store, through ``serve_and_profile``; the model is freed before
    returning.  Returns the record and the serve run's launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    cfg = get_config(arch).with_(use_kernels=True)
    if n_layers:
        cfg = cfg.with_(n_layers=n_layers)
    model = Model(cfg)
    t_init = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    log(f"  {arch}: {cut}; {cfg.n_layers} layers, d_model {cfg.d_model}; "
        f"{model.n_params() / 1e9:.3f} B params initialised on the card in "
        f"{time.perf_counter() - t_init:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    os.environ["REPRO_PLAN_CACHE"] = tempfile.mkdtemp(prefix=arch,
                                                      dir=plan_root)
    rec, launches = serve_and_profile(
        arch, model, params, dev, batch=batch, prompt_len=prompt_len,
        cache_len=cache_len, n_requests=n_requests, max_new=max_new,
        counters=counters)
    rec.update(config=cfg.name, layers=cfg.n_layers, cut=cut, batch=batch,
               prompt_len=prompt_len, cache_len=cache_len,
               params_b=model.n_params() / 1e9)
    del params, model
    torch.cuda.empty_cache()
    return rec, launches


def expect_launches(arch, launches, want):
    """Every kernel's launches over a serve run equal ``want`` (a kernel
    not named there: 0), and each kernel named there launched at least
    once."""
    full = {k: want.get(k, 0) for k in launches}
    if launches != full or 0 in want.values():
        raise AssertionError(f"{arch}: launches {launches}; want {full}")
    log(f"  {arch}: launches {launches} as expected")


def family_batching(arch):
    """The smoke config of ``arch`` in f32 with the kernels on: a 3-slot
    engine equals serial decoding (``batching_matches_serial``), and the
    kernel path's logits the plain path's.  A MoE model's capacity is
    shared by every row of a batched prefill, so batching equals serial
    decoding only where no expert drops: its config runs at capacity
    factor E / k (every expert takes every token)."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.model import Model
    cfg = get_smoke_config(arch).with_(dtype="float32", use_kernels=True)
    if cfg.is_moe:
        cfg = cfg.with_(capacity_factor=cfg.n_experts / cfg.top_k)
    model = Model(cfg)
    params = model.init(0, device="cuda")
    batching_matches_serial(model, params, prompt_len=16, cache_len=48)
    batch = {"tokens": torch.arange(256, device="cuda").reshape(2, 128)
             % cfg.vocab_size}
    if cfg.is_encdec:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        batch["src_embeds"] = torch.randn(2, 128 // cfg.enc_ratio,
                                          cfg.d_model, generator=gen,
                                          device="cuda")
    lk = model.logits(params, batch)
    lp = Model(cfg.with_(use_kernels=False)).logits(params, batch)
    tol = MAMBA_PATH_TOL if cfg.has_ssm else 1e-4
    err = float((lk - lp).abs().max())
    if not torch.allclose(lk, lp, atol=tol, rtol=tol):
        raise AssertionError(f"{arch} kernel path logits differ: {err}")
    log(f"  {arch} smoke: 7 requests through 3 slots == serial decoding"
        f"{' (capacity factor E / k)' if cfg.is_moe else ''}; kernel-path "
        f"logits vs plain path max_abs_err {err:.3e} (tol {tol})")
    return err


def serve_families(dev, gen, counters, plan_root):
    """Phases 17-21: the hybrid, MoE, MLA and enc-dec families served on
    the card, their kernels checked and timed at the shapes their prefills
    give them, and their smoke configs' batching.  Returns the serve
    records, FlashAttention's records at each family's shape, the SSD's at
    hymba's, and the smoke kernel-path errors."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import autotune
    # ------------------------------------- 17. serve hymba-1.5b (hybrid)
    t0 = phase("17. serve hymba-1.5b (full config, bf16, use_kernels=True)")
    torch.cuda.reset_peak_memory_stats()
    family = {}
    hcfg = get_config("hymba-1.5b")
    fam_fa = {"hymba-1.5b": family_attention_check(gen, "hymba-1.5b")}
    os.environ["REPRO_PLAN_CACHE"] = tempfile.mkdtemp(prefix="hymba-ssd",
                                                      dir=plan_root)
    shape = kb.HYMBA_SSD_SHAPE
    h_chunk = autotune.ssd_chunk_len(shape["S"], shape["P"], shape["N"])
    x, dA, Bm, Cm = kb.ssd_inputs(gen, shape, torch.bfloat16, dev)
    if Bm.stride(1) != hcfg.conv_dim \
            or shape["BH"] != 4 * hcfg.ssm_nheads \
            or shape["r"] != hcfg.ssm_nheads // hcfg.ssm_ngroups:
        raise AssertionError(f"HYMBA_SSD_SHAPE {shape} is not hymba's "
                             f"serving scan")
    h_ssd = kb.bench_ssd(x, dA, Bm, Cm, chunk=h_chunk)
    if h_ssd["max_abs_err"] > SSD_BF16_TOL * h_ssd["max_abs_plain"]:
        raise AssertionError(f"ssd_scan disagrees at hymba's shape: "
                             f"{h_ssd['max_abs_err']}")
    log(f"  ssd_scan at hymba's shape xdt {tuple(x.shape)} B/C "
        f"{tuple(Bm.shape)} (strides {Bm.stride()}), the plan's chunk "
        f"{h_chunk}: max_abs_err {h_ssd['max_abs_err']:.3e} (max |plain| "
        f"{h_ssd['max_abs_plain']:.2f}, tol {SSD_BF16_TOL} of it); "
        f"kernel_ms {h_ssd['ms']:.4f} device_ms {h_ssd['device_ms']:.4f}  "
        f"plain_ms {h_ssd['plain_ms']:.4f}  library_ms null  bound_ms "
        f"{h_ssd['bound_ms']:.4f} ({h_ssd['bound_by']}); {h_ssd['tile']}")
    del x, dA, Bm, Cm
    rec, got = family_serve("hymba-1.5b", dev, counters, plan_root, batch=4,
                            prompt_len=1536, cache_len=2048, n_requests=8,
                            max_new=8)
    n_pre = rec["prefill_calls"]
    expect_launches("hymba-1.5b", got, {
        "flash_attention": hcfg.n_layers * n_pre,
        "ssd_scan": hcfg.n_layers * n_pre})
    plan = autotune.ssd_chunk_len(1536, hcfg.ssm_headdim, hcfg.ssm_state)
    if rec["launch_chunks"]["ssd_scan"] != {plan: got["ssd_scan"]} \
            or plan != h_chunk:
        raise AssertionError(f"hymba ssd_scan launches by chunk "
                             f"{rec['launch_chunks']['ssd_scan']}; want all "
                             f"at the plan's {plan}")
    log(f"  every ssd_scan launch at the plan's chunk {plan}: "
        f"{rec['launch_chunks']['ssd_scan']}")
    rec["plan_chunk"] = plan
    family["hymba-1.5b"] = rec
    log(f"  phase peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    log(f"phase 17: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------ 18. serve qwen3-moe-30b-a3b (MoE)
    t0 = phase("18. serve qwen3-moe-30b-a3b (full config, all 48 layers, "
               "bf16, use_kernels=True)")
    torch.cuda.reset_peak_memory_stats()
    fam_fa["qwen3-moe-30b-a3b"] = family_attention_check(
        gen, "qwen3-moe-30b-a3b")
    rec, got = family_serve("qwen3-moe-30b-a3b", dev, counters, plan_root,
                            batch=4, prompt_len=1024, cache_len=2048,
                            n_requests=8, max_new=8)
    expect_launches("qwen3-moe-30b-a3b", got, {
        "flash_attention": 48 * rec["prefill_calls"]})
    family["qwen3-moe-30b-a3b"] = rec
    log(f"  phase peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    log(f"phase 18: {time.perf_counter() - t0:.1f} s")

    # ---------------------- 19. serve deepseek-v3-671b (MLA + MoE), 4 layers
    t0 = phase("19. serve deepseek-v3-671b (full width, 4 of 61 layers, "
               "bf16, use_kernels=True)")
    torch.cuda.reset_peak_memory_stats()
    rec, got = family_serve(
        "deepseek-v3-671b", dev, counters, plan_root, batch=4,
        prompt_len=1024, cache_len=2048, n_requests=8, max_new=8,
        n_layers=4,
        cut="depth cut to 4 of 61 layers (3 dense + 1 MoE) by memory: 61 "
            "layers are 671 B parameters, 1.3 TB in bf16; 4 are about 15 B, "
            "30 GB")
    expect_launches("deepseek-v3-671b", got, {})
    log("  MLA's q and v head dims differ (192, 128): its attention takes "
        "the blocked loop and launches no kernel, as in the JAX package")
    family["deepseek-v3-671b"] = rec
    log(f"  phase peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    log(f"phase 19: {time.perf_counter() - t0:.1f} s")

    # --------------------------- 20. serve seamless-m4t-medium (enc-dec)
    t0 = phase("20. serve seamless-m4t-medium (full config, bf16, "
               "use_kernels=True)")
    torch.cuda.reset_peak_memory_stats()
    fam_fa["seamless-m4t-medium"] = family_attention_check(
        gen, "seamless-m4t-medium")
    scfg_full = get_config("seamless-m4t-medium")
    rec, got = family_serve("seamless-m4t-medium", dev, counters, plan_root,
                            batch=4, prompt_len=1024, cache_len=2048,
                            n_requests=8, max_new=8)
    expect_launches("seamless-m4t-medium", got, {
        "flash_attention": (scfg_full.n_enc_layers + 2 * scfg_full.n_layers)
        * rec["prefill_calls"]})
    family["seamless-m4t-medium"] = rec
    log(f"  phase peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    log(f"phase 20: {time.perf_counter() - t0:.1f} s")

    # ------------- 21. continuous batching of the four families' smoke configs
    t0 = phase("21. continuous batching (hybrid, MoE, MLA, enc-dec smoke "
               "configs, f32, use_kernels=True)")
    family_paths = {arch: family_batching(arch) for arch in (
        "hymba-1.5b", "qwen3-moe-30b-a3b", "deepseek-v3-671b",
        "seamless-m4t-medium")}
    log(f"phase 21: {time.perf_counter() - t0:.1f} s")

    return family, fam_fa, h_ssd, family_paths


# the planner loss on the card (phase 22): loss within 1e-4 relative of the
# plain loss; each gradient within 1e-2 of its largest |g| (bf16 h and
# unembed: both sides round the logits' cotangent to bf16 for the two
# matmuls of the backward pass, one step of which is 2^-8 of a value)
PLANNER_LOSS_RTOL = 1e-4
PLANNER_GRAD_TOL = 1e-2
# phase 23: the planner-loss train step's step-0 loss against the plain
# loss's at the same seed and batch
MESH_STEP0_RTOL = 1e-3
MESH_STEPS = 3
# the collective planner's lines of examples/comet_attention.py
PLANNER_LINES = ["  rows= 65536 vocab=151552 x16 shards -> dist",
                 "  rows=   128 vocab=129280 x16 shards -> dist",
                 "  rows=     1 vocab=  4096 x16 shards -> gather"]


def _counted(records):
    """Collectives recorded by ``record_collectives``, by (label, type,
    bytes, participants)."""
    out = {}
    for label, col_type, dv, p in records:
        key = f"{label} {col_type} {int(dv)} B x{p}"
        out[key] = out.get(key, 0) + 1
    return out


def planner_loss_phase(dev):
    """Phase 22: ``sharded_softmax_xent`` at glm4-9b's full width on
    ``make_host_mesh()`` (one card: (1, 1) over NCCL), both strategies
    forced, held to the plain ``cross_entropy_loss(h @ W)`` under autograd
    (loss and the gradients of h and the unembed) and timed (forward and
    backward, CUDA events); the collectives each emits, counted, against
    ``softmax_collective_schedule``'s declaration (participants > 1)."""
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import destroy, make_host_mesh
    from repro_torch.models.layers import cross_entropy_loss
    from repro_torch.parallel.collective_planner import (
        plan_softmax_strategy, record_collectives, sharded_softmax_xent,
        softmax_collective_schedule)
    cfg = get_config("glm4-9b")
    B, S, D, Vp, V = 4, 1024, cfg.d_model, cfg.padded_vocab, cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    h = torch.randn(B, S, D, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.empty(D, Vp, dtype=torch.bfloat16, device=dev)
    for i in range(0, D, 512):            # in slices: no 2.5 GB f32 draw
        w[i:i + 512] = (torch.randn(min(512, D - i), Vp, generator=gen,
                                    device=dev) * D ** -0.5).to(w.dtype)
    y = torch.randint(0, V, (B, S), generator=gen, device=dev)
    mesh = make_host_mesh(device=dev)
    backend = dist.get_backend(mesh.get_group("model"))
    if backend != "nccl" or tuple(mesh.shape) != (1, 1):
        raise AssertionError(f"host mesh {tuple(mesh.shape)} over {backend}; "
                             f"want (1, 1) over nccl")
    log(f"  mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} over {backend}; "
        f"h {tuple(h.shape)} bf16, unembed {tuple(w.shape)} bf16 "
        f"({w.numel() * 2 / 1e9:.2f} GB), labels < {V}; the planner picks "
        f"{plan_softmax_strategy(B * S, Vp, 1)!r} at one shard")

    def run(loss_fn):
        hh = h.detach().requires_grad_(True)
        ww = w.detach().requires_grad_(True)
        loss = loss_fn(hh, ww)
        loss.backward()
        return loss.detach(), hh.grad, ww.grad

    def plain(hh, ww):
        return cross_entropy_loss(hh @ ww, y, V)

    lp, ghp, gwp = run(plain)
    plain_ms = kb.cuda_ms(lambda: run(plain), iters=3, warmup=1)
    rec = {"shape": [B, S, D, Vp], "mesh": list(mesh.shape),
           "backend": backend, "plain_ms": plain_ms, "strategies": {}}
    try:
        for strategy in ("dist", "gather"):
            def xent(hh, ww, strategy=strategy):
                return sharded_softmax_xent(hh, ww, y, mesh, real_vocab=V,
                                            strategy=strategy)
            with record_collectives() as fwd:
                hh = h.detach().requires_grad_(True)
                ww = w.detach().requires_grad_(True)
                loss = xent(hh, ww)
            with record_collectives() as bwd:
                loss.backward()
            torch.cuda.synchronize()
            loss = loss.detach()
            loss_err = abs(float(loss) / float(lp) - 1)
            gh_err = float((hh.grad.float() - ghp.float()).abs().max()
                           / ghp.float().abs().max())
            gw_err = float((ww.grad.float() - gwp.float()).abs().max()
                           / gwp.float().abs().max())
            ms = kb.cuda_ms(lambda: run(xent), iters=3, warmup=1)
            declared = softmax_collective_schedule(strategy, B * S, Vp, 1)
            emitted = [r for r in fwd if r[3] > 1]
            r = {"loss": float(loss), "loss_plain": float(lp),
                 "loss_rel_err": loss_err, "grad_h_err": gh_err,
                 "grad_unembed_err": gw_err, "ms": ms,
                 "fwd_collectives": _counted(fwd),
                 "bwd_collectives": _counted(bwd), "declared": declared}
            rec["strategies"][strategy] = r
            log(f"  {strategy}: loss {float(loss):.6f} vs plain "
                f"{float(lp):.6f} (rel {loss_err:.2e}, tol "
                f"{PLANNER_LOSS_RTOL}); grad h max err / max|g| "
                f"{gh_err:.2e}, grad unembed {gw_err:.2e} (tol "
                f"{PLANNER_GRAD_TOL}); forward + backward {ms:.2f} ms "
                f"(CUDA events) vs the plain loss {plain_ms:.2f} ms")
            log(f"    collectives over NCCL, forward {_counted(fwd)}, "
                f"backward {_counted(bwd)}; declared (participants > 1) "
                f"{declared}, emitted with participants > 1 {emitted}")
            if not (loss_err <= PLANNER_LOSS_RTOL
                    and gh_err <= PLANNER_GRAD_TOL
                    and gw_err <= PLANNER_GRAD_TOL):
                raise AssertionError(f"planner loss ({strategy}) disagrees "
                                     f"with the plain loss")
            if emitted != [] or declared != [] or not fwd or not bwd:
                raise AssertionError(f"{strategy}: collectives {fwd} {bwd} "
                                     f"against the declared {declared}")
    finally:
        destroy()
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  phase peak memory {rec['peak_mem_gb']:.2f} GB")
    return rec


def mesh_train_phase(dev, counters, train_glm4):
    """Phase 23: the train CLI with ``--mesh host --planner-loss`` on
    glm4-9b (full width, 4 of 40 layers, the kernels on, 3 steps), counts
    set to 0 just before and read just after: FlashAttention launched
    layers x 2 a step; the step-0 loss the plain-loss CLI's at the same
    seed and batch; the step times beside phase 16's."""
    from repro_torch.launch import train as train_cli
    from repro_torch.parallel.collective_planner import record_collectives
    L = 4
    argv = ["--arch", "glm4-9b", "--layers", str(L), "--batch", "4",
            "--seq", "1024"]
    torch.cuda.reset_peak_memory_stats()
    plain = train_cli.main(argv + ["--steps", "1"])
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    with record_collectives() as rec_c:
        out = train_cli.main(argv + ["--steps", str(MESH_STEPS), "--mesh",
                                     "host", "--planner-loss"])
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    want = {k: 2 * L * MESH_STEPS if k == "flash_attention" else 0
            for k in counters}
    err = abs(out["losses"][0] / plain["losses"][0] - 1)
    labels = sorted({r[0] for r in rec_c})
    timed = out["step_ms"][1:]
    rec = {"layers": L, "steps": MESH_STEPS, "losses": out["losses"],
           "plain_step0_loss": plain["losses"][0], "step0_rel_err": err,
           "step_ms": out["step_ms"], "launches": launches,
           "collectives": _counted(rec_c),
           "recompute_collectives": _counted(rec_c.recompute),
           "phase16_mean_step_ms": train_glm4["mean_step_ms"],
           "mean_step_ms": sum(timed) / len(timed),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"  labels {labels}; the remat recompute issued "
        f"{len(rec_c.recompute)} of {len(rec_c) + len(rec_c.recompute)} "
        f"collectives: {rec['recompute_collectives']}")
    log(f"  --mesh host --planner-loss: losses "
        f"{[round(x, 4) for x in out['losses']]}; step 0 {out['losses'][0]:.6f}"
        f" vs the plain loss's {plain['losses'][0]:.6f} (rel {err:.2e}, tol "
        f"{MESH_STEP0_RTOL})")
    log(f"  step ms (CUDA events) {[round(x, 2) for x in out['step_ms']]}; "
        f"mean of steps 2-{MESH_STEPS} {rec['mean_step_ms']:.2f} ms beside "
        f"phase 16's plain-loss step {train_glm4['mean_step_ms']:.2f} ms")
    log(f"  launches {launches}; want {want}; collectives (one-rank NCCL "
        f"groups) {len(rec_c)} of {len(labels)} labels: {rec['collectives']}")
    log(f"  phase peak memory {rec['peak_mem_gb']:.2f} GB")
    if launches != want or out["launches"]["flash_attention"] != \
            want["flash_attention"]:
        raise AssertionError(f"mesh train step launches {launches}; want "
                             f"{want}")
    if err > MESH_STEP0_RTOL or not all(np.isfinite(out["losses"])):
        raise AssertionError(f"mesh train step's step 0 loss off by {err}")
    if not {"xent/hidden-cotangent", "tp/attn-out", "tp/ffn-out",
            "tp/embed", "grads/norm"} <= set(labels) or not any(
            x.startswith("grads/") for x in labels):
        raise AssertionError(f"the mesh step emitted {labels}")
    return rec, launches


# phases 28-30: steps of train_loop (steps 2-4 timed)
FAMILY_STEPS = 4
# phase 30: deepseek-v3-671b at full width, cut in depth by memory
DEEPSEEK_LAYERS = 3
DEEPSEEK_CUT = ("depth cut to 3 of 61 layers, the dense stack (no MoE layer) "
                "by memory: 3.6 B parameters at 12 B each (bf16 params and "
                "grads, f32 AdamW moments) take 43 GB; one MoE layer alone "
                "holds 256 x 3 x 7168 x 2048 = 11.3 B expert parameters, 135 "
                "GB, more than the card's 80 GB.  Its MoE training is held "
                "on the CPU against the JAX step and by phase 25")

# phase 25: qwen3-moe-30b-a3b at full width, cut in depth by memory
MOE_LAYERS = 4
MOE_CUT = ("depth cut to 4 of 48 layers by memory: 3.1 B parameters at 12 B "
           "each (bf16 params and grads, f32 AdamW moments) take 37 GB; all "
           "48 layers would take 366 GB, more than the card's 80 GB")


# phases 31-33: the pod axis and the config knobs on a one-rank NCCL mesh
KNOB_STEPS = 3
SEQ_SSM_STEPS = 2
# a knob that changes no arithmetic on a one-rank axis (phase 32's glm4
# step 0, phase 33's step) gives the loss of the step without it
KNOB_LOSS_RTOL = 1e-6
POD_AXES = ("pod", "data", "model")


def knob_train(arch, dev, counters, *, shape, axes, knob, steps, batch,
               seq, n_layers=None, planner=False):
    """``steps`` steps of ``launch.train.train_loop`` for ``arch`` (bf16,
    kernels on, the config ``knob`` set; ``n_layers`` of its layers) on a
    one-rank NCCL mesh of ``shape`` named ``axes``
    (``launch/mesh.make_auto_mesh``), with the counts set to 0 just before
    and read just after and every collective recorded: each must run in a
    one-rank group (a copy).  Returns the record."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.train import train_loop
    from repro_torch.models.model import Model
    from repro_torch.parallel.collective_planner import record_collectives
    from repro_torch.train.optimizer import OptConfig
    cfg = get_config(arch).with_(use_kernels=True, **knob)
    if n_layers:
        cfg = cfg.with_(n_layers=n_layers)
    mesh = tmesh.make_auto_mesh(shape, axes, device=dev)
    try:
        for f in counters.values():
            f.launches = 0
            if hasattr(f, "chunks"):
                f.chunks = {}
        torch.cuda.reset_peak_memory_stats()
        with record_collectives() as coll:
            out = train_loop(Model(cfg), steps=steps, batch=batch, seq=seq,
                             mesh=mesh, opt_cfg=OptConfig(
                                 total_steps=steps, warmup_steps=1),
                             use_planner_loss=planner, warmup_plans=True,
                             log_every=1, device=dev)
        torch.cuda.synchronize()
    finally:
        tmesh.destroy()
    launches = {k: f.launches for k, f in counters.items()}
    wide = {r[3] for r in list(coll) + coll.recompute} - {1}
    if wide or not all(np.isfinite(out["losses"])):
        raise AssertionError(f"{cfg.name} {knob} on {shape}: collectives "
                             f"over {wide} ranks, losses {out['losses']}")
    timed = out["step_ms"][1:] or out["step_ms"]
    rec = {"config": cfg.name, "layers": cfg.n_layers, "knob": knob,
           "mesh": dict(zip(axes, shape)), "batch": batch, "seq": seq,
           "steps": steps, "losses": out["losses"], "step_ms": out["step_ms"],
           "mean_step_ms": sum(timed) / len(timed), "launches": launches,
           "ssd_chunks": dict(getattr(counters["ssd_scan"], "chunks", {})),
           "labels": sorted({f"{r[0]} {r[1]}" for r in coll}),
           "collectives": _counted(coll),
           "recompute_collectives": _counted(coll.recompute),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del out
    torch.cuda.empty_cache()
    log(f"  {cfg.name} {knob or 'no knob'} on {rec['mesh']}: losses "
        f"{[round(x, 6) for x in rec['losses']]}; step ms (CUDA events) "
        f"{[round(x, 2) for x in rec['step_ms']]}; launches {launches}; "
        f"peak memory {rec['peak_mem_gb']:.2f} GB")
    log(f"  {len(rec['labels'])} labels (one-rank copies): {rec['labels']}")
    return rec


def _rel(a, b):
    return abs(a / b - 1)


def pod_phase(dev, counters, train_glm4, mesh_train):
    """Phase 31: glm4-9b (4 layers, the planner loss) on the (1, 1, 1)
    ``(pod, data, model)`` mesh."""
    L = 4
    rec = knob_train("glm4-9b", dev, counters, shape=(1, 1, 1),
                     axes=POD_AXES, knob={}, steps=KNOB_STEPS, batch=4,
                     seq=1024, n_layers=L, planner=True)
    want = {k: 2 * L * KNOB_STEPS if k == "flash_attention" else 0
            for k in counters}
    err = _rel(rec["losses"][0], train_glm4["losses"][0])
    rec.update(step0_rel_err_vs_phase16=err,
               phase23_mean_step_ms=mesh_train["mean_step_ms"])
    log(f"  step 0 {rec['losses'][0]:.6f} vs phase 16's "
        f"{train_glm4['losses'][0]:.6f} (rel {err:.2e}, tol "
        f"{MESH_STEP0_RTOL}); mean step {rec['mean_step_ms']:.2f} ms beside "
        f"phase 23's {mesh_train['mean_step_ms']:.2f} ms on (1, 1)")
    if rec["launches"] != want:
        raise AssertionError(f"pod mesh launches {rec['launches']}; want "
                             f"{want}")
    if err > MESH_STEP0_RTOL:
        raise AssertionError(f"pod mesh step 0 loss off by {err}")
    need = {"xent/hidden-cotangent AllReduce", "xent/unembed-grad AllReduce",
            "tp/attn-out AllReduce", "tp/embed AllReduce",
            "grads/norm AllReduce"}
    if not need <= set(rec["labels"]):
        raise AssertionError(f"pod mesh labels {rec['labels']}")
    return rec


def seq_shard_phase(dev, counters, plan_root, mesh_train, train_mamba,
                    serve, m_batch):
    """Phase 32: ``seq_shard=True`` on the (1, 1) mesh: glm4-9b's training
    as phase 23, mamba2-130m's (2 steps), glm4-9b served."""
    from repro_torch.kernels import autotune
    L = 4
    seq_kw = {"seq_shard": True}
    glm4 = knob_train("glm4-9b", dev, counters, shape=(1, 1),
                      axes=("data", "model"), knob=seq_kw, steps=KNOB_STEPS,
                      batch=4, seq=1024, n_layers=L, planner=True)
    errs = [_rel(a, b) for a, b in zip(glm4["losses"], mesh_train["losses"])]
    glm4["rel_err_vs_phase23"] = errs
    ref = [round(x, 6) for x in mesh_train["losses"]]
    log(f"  losses against phase 23's {ref}: rel "
        f"{[f'{e:.2e}' for e in errs]} (step 0 "
        f"tol {KNOB_LOSS_RTOL}, the rest {MESH_STEP0_RTOL}); mean step "
        f"{glm4['mean_step_ms']:.2f} ms beside phase 23's "
        f"{mesh_train['mean_step_ms']:.2f} ms")
    fa = {k: 2 * L * KNOB_STEPS if k == "flash_attention" else 0
          for k in counters}
    if glm4["launches"] != fa:
        raise AssertionError(f"seq_shard glm4 launches {glm4['launches']}")
    if errs[0] > KNOB_LOSS_RTOL or max(errs) > MESH_STEP0_RTOL:
        raise AssertionError(f"seq_shard glm4 losses off by {errs}")
    need = {"tp/seq-gather AllGather", "tp/seq-gather ReduceScatter",
            "tp/attn-out ReduceScatter", "tp/ffn-out ReduceScatter",
            "tp/embed ReduceScatter"}
    if not need <= set(glm4["labels"]) or "tp/attn-out AllReduce" in \
            glm4["labels"]:
        raise AssertionError(f"seq_shard glm4 labels {glm4['labels']}")

    mamba = knob_train("mamba2-130m", dev, counters, shape=(1, 1),
                       axes=("data", "model"), knob=seq_kw,
                       steps=SEQ_SSM_STEPS, batch=m_batch, seq=1024)
    n = 24 * 2 * SEQ_SSM_STEPS
    plan = autotune.ssd_chunk_len(1024, 64, 128)
    err = _rel(mamba["losses"][0], train_mamba["losses"][0])
    mamba["step0_rel_err_vs_phase15"] = err
    log(f"  mamba2 ssd_scan launches by chunk {mamba['ssd_chunks']} (want "
        f"{n}, all at the plan's {plan}); step 0 {mamba['losses'][0]:.6f} vs "
        f"phase 15's {train_mamba['losses'][0]:.6f} (rel {err:.2e}); mean "
        f"step {mamba['mean_step_ms']:.2f} ms beside phase 15's "
        f"{train_mamba['mean_step_ms']:.2f} ms")
    if mamba["launches"]["ssd_scan"] != n or mamba["ssd_chunks"] != {plan: n}:
        raise AssertionError(f"seq_shard mamba2 launches {mamba['launches']}"
                             f", chunks {mamba['ssd_chunks']}")
    if err > MESH_STEP0_RTOL or "tp/ssm-out ReduceScatter" not in \
            mamba["labels"]:
        raise AssertionError(f"seq_shard mamba2: step 0 off by {err}, "
                             f"labels {mamba['labels']}")

    from repro_torch.configs.registry import get_config
    served = mesh_serve(
        "glm4-9b", dev, counters, plan_root, serve, batch=4,
        prompt_len=1024, cache_len=2048, n_requests=8, max_new=16,
        want={"flash_attention": get_config("glm4-9b").n_layers
              * serve["prefill_calls"]}, knob=seq_kw)
    kinds = {" ".join(k.split()[:2]) for k in served["collectives"]}
    if not {"tp/seq-gather AllGather", "tp/attn-out ReduceScatter"} <= kinds:
        raise AssertionError(f"seq_shard serve collectives "
                             f"{served['collectives']}")
    return {"glm4_train": glm4, "mamba2_train": mamba, "glm4_serve": served}


def tp_off_phase(dev, counters, mesh_train):
    """Phase 33: one glm4-9b step with ``tensor_parallel=False`` on the
    (1, 1) mesh."""
    L = 4
    rec = knob_train("glm4-9b", dev, counters, shape=(1, 1),
                     axes=("data", "model"),
                     knob={"tensor_parallel": False}, steps=1, batch=4,
                     seq=1024, n_layers=L, planner=True)
    err = _rel(rec["losses"][0], mesh_train["losses"][0])
    rec["step0_rel_err_vs_phase23"] = err
    log(f"  loss {rec['losses'][0]:.6f} vs phase 23's step 0 "
        f"{mesh_train['losses'][0]:.6f} (rel {err:.2e}, tol "
        f"{KNOB_LOSS_RTOL}); step {rec['step_ms'][0]:.2f} ms")
    want = {k: 2 * L if k == "flash_attention" else 0 for k in counters}
    if rec["launches"] != want or err > KNOB_LOSS_RTOL:
        raise AssertionError(f"tensor_parallel=False: launches "
                             f"{rec['launches']}, loss off by {err}")
    if any(x.startswith(("tp/", "grads/norm")) for x in rec["labels"]) or \
            "xent/hidden-cotangent AllReduce" not in rec["labels"]:
        raise AssertionError(f"tensor_parallel=False labels {rec['labels']}")
    return rec


def moe_mesh_train_phase(counters):
    """Phase 25: the train CLI with ``--mesh host --planner-loss`` on
    qwen3-moe-30b-a3b (full width, 4 of 48 layers, the kernels on, 3
    steps), counts set to 0 just before and read just after: FlashAttention
    launched layers x 2 a step; the step-0 loss the CLI's without a mesh
    (1e-3 relative); finite losses; the MoE collectives recorded; the
    trained params saved on the mesh and restored with ``shardings=`` bit
    for bit; the step times beside those without a mesh."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import destroy, make_host_mesh
    from repro_torch.models.model import Model
    from repro_torch.parallel.collective_planner import record_collectives
    from repro_torch.parallel.sharding import param_shardings
    from repro_torch.train.checkpoint import (flatten_with_names,
                                              restore_checkpoint,
                                              save_checkpoint)
    L = MOE_LAYERS
    argv = ["--arch", "qwen3-moe-30b-a3b", "--layers", str(L), "--batch",
            "4", "--seq", "1024"]
    log(f"  {MOE_CUT}")
    torch.cuda.reset_peak_memory_stats()
    plain = train_cli.main(argv + ["--steps", "2"])
    plain_state = plain.pop("state")
    torch.cuda.synchronize()
    # where the time of a step without a mesh goes, on the CLI's state
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import make_train_step
    cfg = get_config("qwen3-moe-30b-a3b").with_(n_layers=L,
                                                 use_kernels=True)
    step_fn = make_train_step(Model(cfg), OptConfig(total_steps=2,
                                                    warmup_steps=1))
    b0 = to_dev(train_data(cfg, 1024, 4).batch(0), "cuda")
    holder = [plain_state]

    def one_step():
        holder[0], _ = step_fn(holder[0], b0)

    profile = profile_step(one_step, "qwen3-moe-30b-a3b (4 layers, no mesh)")
    del holder, plain_state, step_fn
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    plain_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    for f in counters.values():
        f.launches = 0
    with record_collectives() as rec_c:
        out = train_cli.main(argv + ["--steps", str(MESH_STEPS), "--mesh",
                                     "host", "--planner-loss"])
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    want = {k: 2 * L * MESH_STEPS if k == "flash_attention" else 0
            for k in counters}
    err = abs(out["losses"][0] / plain["losses"][0] - 1)
    labels = sorted({r[0] for r in rec_c})
    timed = out["step_ms"][1:]
    rec = {"layers": L, "steps": MESH_STEPS, "cut": MOE_CUT,
           "plain_profile": profile,
           "losses": out["losses"], "plain_losses": plain["losses"],
           "step0_rel_err": err, "step_ms": out["step_ms"],
           "plain_step_ms": plain["step_ms"], "launches": launches,
           "collectives": _counted(rec_c),
           "recompute_collectives": _counted(rec_c.recompute),
           "mean_step_ms": sum(timed) / len(timed),
           "plain_peak_mem_gb": plain_peak,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"  --mesh host --planner-loss: losses "
        f"{[round(x, 4) for x in out['losses']]}; step 0 "
        f"{out['losses'][0]:.6f} vs the CLI's without a mesh "
        f"{plain['losses'][0]:.6f} (rel {err:.2e}, tol {MESH_STEP0_RTOL})")
    log(f"  step ms (CUDA events) {[round(x, 2) for x in out['step_ms']]}, "
        f"mean of steps 2-{MESH_STEPS} {rec['mean_step_ms']:.2f} ms; "
        f"without a mesh {[round(x, 2) for x in plain['step_ms']]}")
    log(f"  launches {launches}; want {want}; labels {labels}; the remat "
        f"recompute issued {len(rec_c.recompute)} of "
        f"{len(rec_c) + len(rec_c.recompute)} collectives")
    log(f"  peak memory {rec['peak_mem_gb']:.2f} GB on the mesh, "
        f"{plain_peak:.2f} GB without")
    if launches != want or out["launches"]["flash_attention"] != \
            want["flash_attention"]:
        raise AssertionError(f"MoE mesh train step launches {launches}; "
                             f"want {want}")
    if err > MESH_STEP0_RTOL or not all(np.isfinite(out["losses"])):
        raise AssertionError(f"MoE mesh step's losses {out['losses']} "
                             f"(step 0 off by {err})")
    if not {"moe/combine", "moe/router-grad", "moe/expert-grad",
            "tp/attn-out", "xent/hidden-cotangent"} <= set(labels):
        raise AssertionError(f"the MoE mesh step emitted {labels}")

    # the trained params saved on the mesh, restored with shardings=
    params = out.pop("state").params
    model = Model(get_config("qwen3-moe-30b-a3b").with_(n_layers=L))
    t0 = time.perf_counter()
    mesh = make_host_mesh(device="cuda")
    try:
        placed = param_shardings(model.specs, mesh)
        with tempfile.TemporaryDirectory(prefix="moe-ckpt-") as d:
            save_checkpoint(d, MESH_STEPS, params, placements=placed,
                            mesh=mesh)
            got, step, _ = restore_checkpoint(d, params, shardings=placed,
                                              mesh=mesh)
    finally:
        destroy()
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        flatten_with_names(params), flatten_with_names(got)))
    nbytes = sum(t.numel() * t.element_size() for t in
                 (x for _, x in flatten_with_names(params)))
    rec["checkpoint"] = {"bytes": nbytes, "step": step, "bit_equal": same,
                         "s": time.perf_counter() - t0}
    log(f"  params checkpoint on the mesh ({nbytes / 1e9:.2f} GB) saved and "
        f"restored with shardings= in {rec['checkpoint']['s']:.1f} s: "
        f"{'bit for bit' if same else 'DIFFERENT'}")
    del got, params
    torch.cuda.empty_cache()
    if not same or step != MESH_STEPS:
        raise AssertionError("the MoE checkpoint did not restore bit for "
                             "bit")
    return rec, launches


def front_ends_phase(counters):
    """Phase 24: ``repro_torch.examples.serve_lm`` and ``train_lm`` on the
    card (a few requests and steps each, ``--device cuda``), counts set to
    0 just before each and read just after (> 0); ``comet_attention`` to
    its end, its planner lines the expected strings; Fig. 6's
    ``collective_compare`` line."""
    import contextlib
    import io

    from repro_torch.examples import comet_attention, serve_lm, train_lm
    from repro_torch.launch import costmodel_compare
    rec = {}
    for name, run in (
            ("serve_lm", lambda: serve_lm.main(
                ["--device", "cuda", "--requests", "8", "--batch", "4",
                 "--max-new", "8"])),
            ("train_lm", lambda: train_lm.main(
                ["--device", "cuda", "--steps", "3", "--batch", "4",
                 "--seq", "256"]))):
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in counters.items()}
        rec[name] = {"launches": launches, "s": time.perf_counter() - t0,
                     "wrapper_launches": out["launches"]}
        log(f"  {name}: launches {launches} in "
            f"{rec[name]['s']:.1f} s")
        if launches["flash_attention"] <= 0 or \
                out["launches"]["flash_attention"] != \
                launches["flash_attention"]:
            raise AssertionError(f"{name} launched {launches}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        comet_attention.main()
    lines = buf.getvalue().splitlines()
    rec["comet_attention"] = {"lines": lines,
                              "s": time.perf_counter() - t0}
    for ln in lines:
        log(f"  | {ln}")
    if lines[-3:] != PLANNER_LINES:
        raise AssertionError(f"comet_attention's planner lines {lines[-3:]}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rec["collective_compare"] = costmodel_compare.collective_compare()
    log(f"  | {buf.getvalue().strip()}")
    if rec["collective_compare"]["degenerate"]:
        raise AssertionError(f"collective_compare {rec['collective_compare']}")
    return rec


# phase 34's gloo sweep: 4 CPU ranks, 4 KiB to 1 MiB, 4 sizes a type, 3
# timed iterations a point
CALIB_GLOO = ["--backend", "gloo", "--ranks", "4", "--max-bytes",
              str(1 << 20), "--sizes", "4", "--iters", "3"]


def calibrate_cli(args, store):
    """``python -m repro_torch.calibrate ARGS --store STORE --json``:
    (exit code, summary, seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.calibrate", *args, "--store",
         store, "--json"], env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    try:
        summary = json.loads(r.stdout)
    except ValueError:
        raise AssertionError(f"calibrate {args} exited {r.returncode}: "
                             f"{r.stdout[-1000:]} {r.stderr[-3000:]}")
    return r.returncode, summary, time.perf_counter() - t0


def calibration_phase(plan_root):
    """Phase 34: the calibration CLI on the card's machine, each run in a
    fresh store under ``plan_root``."""
    from repro_torch.calibrate import CALIBRATED_TYPES, SweepConfig
    from repro_torch.core.hardware import tpu_v5e
    rec = {}
    store = tempfile.mkdtemp(prefix="calib-nccl", dir=plan_root)
    rc, s, sec = calibrate_cli(["--backend", "nccl"], store)
    rec["nccl"] = {"rc": rc, "s": sec, "summary": s}
    grid = len(CALIBRATED_TYPES) * SweepConfig().n_sizes
    log(f"  nccl, one card ({sec:.1f} s): exit {rc}, {s['n_points']} of "
        f"{grid} points (each the best of 5 timed one-rank NCCL calls after "
        f"a warmup), dropped {s['dropped']}, degenerate {s['degenerate']}, "
        f"persisted {s['persisted']}")
    if rc != 2 or not s["degenerate"] or s["persisted"] or os.listdir(store):
        raise AssertionError(f"nccl on one card: exit {rc}, {s}, "
                             f"{os.listdir(store)}")
    # every point a real NCCL call that returned a finite time: a call that
    # raised would end the run (exit 3), and none may be dropped as an
    # error or a non-finite time; a point slower than a larger one may be
    if set(s["dropped"]) - {"non-monotone"} \
            or s["n_points"] + s["n_dropped"] != grid:
        raise AssertionError(f"nccl on one card: {s['n_points']} points, "
                             f"dropped {s['dropped']} of {grid}")
    store = tempfile.mkdtemp(prefix="calib-gloo", dir=plan_root)
    path = Path(store) / "calibrated_noc.json"
    rc, s, sec = calibrate_cli(CALIB_GLOO, store)
    p = s["params"]
    consts = [p["channel_bandwidth"], p["t_router"], p["t_enq"]]
    rec["gloo"] = {"rc": rc, "s": sec, "summary": s}
    log(f"  gloo, 4 CPU ranks ({sec:.1f} s): exit {rc}, {s['n_points']} "
        f"points, dropped {s['dropped']}, channel_bandwidth "
        f"{p['channel_bandwidth']:.6g} B/s, t_router {p['t_router']:.6g} s, "
        f"t_enq {p['t_enq']:.6g} s; gate median {s['median_rel_err']:.4f} "
        f"max {s['max_rel_err']:.4f} (bar {s['gate_median']}: "
        f"{'met' if s['gate_ok'] else 'missed'})")
    if rc not in (0, 1) or s["degenerate"] or not s["persisted"] \
            or not all(np.isfinite(c) and c > 0 for c in consts):
        raise AssertionError(f"gloo calibration: exit {rc}, {s}")
    first = path.read_bytes()
    rc2, s2, sec2 = calibrate_cli(CALIB_GLOO, store)
    rec["gloo_again"] = {"rc": rc2, "s": sec2, "summary": s2}
    log(f"  gloo again ({sec2:.1f} s): exit {rc2}, reused {s2['reused']}, "
        f"fits_solved {s2['fits_solved']}, file unchanged "
        f"{path.read_bytes() == first}")
    if not s2["reused"] or s2["fits_solved"] != 0 or rc2 != rc \
            or path.read_bytes() != first:
        raise AssertionError(f"gloo calibration not reused: {s2}")
    noc = tpu_v5e(calibrated=path).cluster_noc
    if [noc.channel_bandwidth, noc.t_router, noc.t_enq] != consts:
        raise AssertionError(f"tpu_v5e(calibrated=) gives {noc}")
    return rec


# phase 35: the kernel arm's shapes (``autotune.PAPER_KERNEL_SHAPES``) and
# the CLI's time limit; late in a long process the profiler now and then
# loses a kernel's event (PERF.md §6), so a launch the wrapper counted is
# profiled again, at most this many times
ANALYSIS_TIMEOUT = 600
PROFILE_TRIES = 5
# phases 36-37: the dry run's cells and its time limit (a cell)
DRYRUN_TIMEOUT = 600
DRYRUN_GLM4 = ("glm4-9b", 4, 4, 1024)   # arch, layers, batch, seq: phase 25's
DRYRUN_CELLS = (("glm4-9b", "train_4k", "single"),
                ("qwen3-moe-30b-a3b", "train_4k", "multi"))


def _static_smem(build_log):
    """The largest static shared memory ptxas reports for an entry of a
    source (``N bytes smem``)."""
    return max([int(m.group(1)) for m in
                re.finditer(r"(\d+) bytes smem", build_log)] or [0])


def static_contracts_phase(dev, built):
    """Phase 35: ``python -m repro_torch.analysis`` on the full paper
    shapes (exit 0); the custom op's host cost (:func:`op_dispatch_cost`);
    then :func:`contract_launches` in a fresh process (late in a long one
    the profiler's trace loses some kernels' events: gemm_layernorm's, on
    every try, in this script's earlier runs)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        "--json", path], env=env, cwd=ROOT,
                       capture_output=True, text=True,
                       timeout=ANALYSIS_TIMEOUT)
    cli_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"python -m repro_torch.analysis exited "
                             f"{r.returncode}: {r.stdout[-2000:]} "
                             f"{r.stderr[-3000:]}")
    with open(path) as f:
        report = json.load(f)
    os.remove(path)
    c = report["contracts"]
    rec = {"cli_s": cli_s, "checked": c["checked"], "passed": c["passed"],
           "lint_findings": report["lint"]["count"]}
    log(f"  python -m repro_torch.analysis ({cli_s:.1f} s): contracts "
        f"{c['passed']}/{c['checked']} passed, arms {c['arms']}, lint "
        f"{report['lint']['count']} findings")
    rec["dispatch"] = op_dispatch_cost(dev)
    static = {src: _static_smem(built[src][2])
              for src in ("gemm_epilogue", "flash_attention", "ssd_scan")}
    code = ("import json, sys\n"
            "import chip_smoke as cs\n"
            "rows = cs.contract_launches(json.loads(sys.argv[1]))\n"
            "print(json.dumps(rows))\n")
    r = subprocess.run([sys.executable, "-c", code, json.dumps(static)],
                       env=dict(env, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}"),
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=ANALYSIS_TIMEOUT)
    lines = r.stdout.rstrip().splitlines()
    for line in lines[:-1]:
        log(line)
    if r.returncode != 0:
        raise AssertionError(f"the contract launches exited {r.returncode}:"
                             f" {r.stdout[-2000:]} {r.stderr[-3000:]}")
    rec["launches"] = json.loads(lines[-1])
    return rec


def contract_launches(static):
    """Each kernel launched once at each contract shape (the kernel
    arm's) under ``torch.profiler``: the trace's grid equals the tiling's
    (the geometry the FLOP formula counts); its shared memory holds the
    library's dynamic figure, plus at most the source's static shared
    memory ``static[source]`` (ptxas's, which the trace adds), and is
    within the card's per-block opt-in; the Python layout equals the
    library's figure.  Returns a row a launch; raises on a failed bar."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm_epilogue as ge
    from repro_torch.kernels import ssd
    from repro_torch.kernels.autotune import (PAPER_KERNEL_SHAPES,
                                              ssd_chunk_len)
    from repro_torch.kernels.gemm_layernorm import gemm_layernorm
    from repro_torch.kernels.gemm_softmax import gemm_softmax
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(0)
    optin = props.shared_memory_per_block_optin
    bf = torch.bfloat16
    cases = []
    for m, n, k in PAPER_KERNEL_SHAPES["gemm_epilogue_blocks"]:
        a = torch.randn(m, k, device=dev, dtype=bf)
        b = torch.randn(k, n, device=dev, dtype=bf) / 16
        g = torch.ones(n, device=dev, dtype=bf)
        t = ge.tiling(n, bf)
        want = (*ge.launch_grid(m, t), 1)
        lib = ge.smem_bytes(bf, t.rows, t.passes)
        layout = ge.layout_smem_bytes(bf, t.rows, t.passes)
        cases.append((f"gemm_softmax{(m, n, k)}",
                      lambda a=a, b=b: gemm_softmax(a, b), "ge_bf16",
                      want, lib, layout, "gemm_epilogue", gemm_softmax))
        cases.append((f"gemm_layernorm{(m, n, k)}",
                      lambda a=a, b=b, g=g: gemm_layernorm(a, b, g, g),
                      "ge_bf16", want, lib, layout, "gemm_epilogue",
                      gemm_layernorm))
    for sq, skv, d in PAPER_KERNEL_SHAPES["attention_blocks"]:
        M, N = max(sq, 128), max(skv, 128)
        q = torch.randn(1, 1, M, d, device=dev, dtype=bf)
        kv = torch.randn(1, 1, N, d, device=dev, dtype=bf)
        t = fa.tiling(1, 1, 1, M, N, d, bf, props.multi_processor_count)
        cases.append((f"flash_attention{(sq, skv, d)}",
                      lambda q=q, kv=kv: fa.flash_attention_fwd(
                          q, kv, kv, causal=False), "fa_fwd_bf16",
                      (*t.grid, 1), fa.smem_bytes(bf, d),
                      fa.layout_smem_bytes(bf, d), "flash_attention",
                      fa.flash_attention_fwd))
    for s, p, n in PAPER_KERNEL_SHAPES["ssd_chunk_len"]:
        chunk = ssd_chunk_len(s, p, n)
        x = torch.randn(1, s, p, device=dev, dtype=bf)
        dA = -torch.rand(1, s, device=dev) / 8
        bc = torch.randn(1, s, n, device=dev, dtype=bf)
        t = ssd.tiling(1, 1, s, p, n, bf)
        cases.append((f"ssd{(s, p, n)} chunk {chunk}",
                      lambda x=x, dA=dA, bc=bc, c=chunk: ssd.ssd_scan_fwd(
                          x, dA, bc, bc, chunk=c), "ssd_fwd_bf16",
                      (*t.grid, 1), ssd.bf16_tile(n, p)[1],
                      ssd.bf16_layout(n, p)[1], "ssd_scan",
                      ssd.ssd_scan_fwd))
    rows = []
    for name, fn, entry, want, lib, layout, source, counter in cases:
        fn()                               # the instance's first launch
        for attempt in range(1, PROFILE_TRIES + 1):
            before = counter.launches
            ev = kb.launch_events(fn, (entry,))
            if counter.launches != before + 1:
                raise AssertionError(f"{name}: {counter.launches - before} "
                                     f"launches counted, want 1")
            if ev:
                break
            # the wrapper counted its launch: the trace lost the event
            log(f"  {name}: the profiler's trace lost the launch (try "
                f"{attempt} of {PROFILE_TRIES})")
        row = {"case": name, "events": len(ev), "want_grid": list(want),
               "library_smem": lib, "layout_smem": layout,
               "static_smem_max": static[source], "optin": optin,
               "tries": attempt}
        if len(ev) != 1:
            raise AssertionError(f"{name}: {len(ev)} launches of {entry} "
                                 f"in the trace, want 1")
        row.update(grid=list(ev[0]["grid"]), trace_smem=ev[0][
            "shared_memory"], trace_keys=ev[0]["keys"])
        rows.append(row)
        log(f"  {name}: trace grid {ev[0]['grid']} (tiling {want}), "
            f"shared memory {ev[0]['shared_memory']} B (library "
            f"{lib} B dynamic, Python layout {layout} B, static at most "
            f"{static[source]} B, opt-in {optin} B); trace keys "
            f"{ev[0]['keys']}")
        if ev[0]["grid"] != want:
            raise AssertionError(f"{name}: launch grid {ev[0]['grid']}, "
                                 f"tiling {want}")
        if not lib <= ev[0]["shared_memory"] <= lib + static[source] \
                or layout != lib or ev[0]["shared_memory"] > optin:
            raise AssertionError(f"{name}: shared memory {row}")
    return rows


def op_dispatch_cost(dev, calls=400):
    """The host cost of a kernel entry's custom op: the host time of
    ``calls`` back-to-back FlashAttention calls through the entry
    (``flash_attention_fwd``: the checks, then ``_run`` itself where no
    dispatch mode is active), through the op (``torch.ops.repro_torch.
    flash_attention_fwd``, the dispatcher, as under a counter or a fake
    mode) and through ``_run`` (the launch alone), at a shape whose
    launch is shorter than its host cost (1 x 2 heads x 64 x 64, bf16),
    so the host's time is what the loop measures; each the best of 3."""
    from repro_torch.kernels import flash_attention as fa
    q = torch.randn(1, 2, 64, 64, device=dev, dtype=torch.bfloat16)
    scale = 64 ** -0.5

    def host_us(fn):
        best = None
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            us = (t1 - t0) / calls * 1e6
            best = us if best is None else min(best, us)
        return best
    from torch.utils._python_dispatch import is_in_torch_dispatch_mode
    entry = host_us(lambda: fa.flash_attention_fwd(q, q, q, causal=True))
    op = host_us(lambda: fa._op.op(q, q, q, True, scale, None))
    run = host_us(lambda: fa._run(q, q, q, True, scale, None))
    check = host_us(lambda: fa._check(q, q, q, None))
    decide = host_us(lambda: is_in_torch_dispatch_mode() or any(
        type(a) is not torch.Tensor and isinstance(a, torch.Tensor)
        for a in (q, q, q)))
    ev = kb.device_ms(lambda: fa.flash_attention_fwd(q, q, q, causal=True),
                      iters=20, match=("fa_fwd",)) * 1e3
    rec = {"entry_us": entry, "op_us": op, "run_us": run,
           "dispatcher_us": op - run, "check_us": check,
           "decision_us": decide, "device_us": ev,
           "prefill_launches_glm4": 40}
    log(f"  custom-op dispatch: a call through the entry {entry:.2f} us "
        f"(checks + run), through the op {op:.2f} us (the dispatcher), "
        f"through _run {run:.2f} us (the launch alone): the dispatcher "
        f"{op - run:.2f} us a launch, which the entry skips outside a "
        f"dispatch mode (x 40 glm4-9b prefill launches: "
        f"{(op - run) * 40 / 1e3:.4f} ms); the checks alone {check:.2f} us "
        f"(the entry ran them before it became an op), its choice of path "
        f"{decide:.2f} us; the kernel's device time here {ev:.2f} us "
        f"(0: the trace lost it)")
    return rec


def dryrun_cli(args, out):
    """``python -m repro_torch.launch.dryrun ARGS --out OUT``: (artifact,
    seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        *args, "--out", out],
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=DRYRUN_TIMEOUT)
    sec = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"dryrun {args} exited {r.returncode}: "
                             f"{r.stdout[-2000:]} {r.stderr[-3000:]}")
    with open(out) as f:
        return json.load(f), sec


def dryrun_vs_card_phase(dev):
    """Phase 36: the dry run of glm4-9b (full width, 4 of 40 layers, the
    planner loss, phase 25's batch 4 x seq 1024) on the (1, 1) mesh of a
    fake one-rank world, in a subprocess (a fake world and this process's
    NCCL world cannot share a process), against the real step on the
    card's (1, 1) NCCL mesh under the same counter and
    ``record_collectives``: equal FLOPs, equal records (the recompute's
    too), the state's bytes those the card allocated for it up to the
    allocator's rounding (512 B a tensor); the dry run's peak logged
    beside ``max_memory_allocated``, with no bar."""
    from repro_torch.analysis.counts import trace_counts
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.specs import tree_bytes
    from repro_torch.models.model import Model
    from repro_torch.models.param import tree_leaves
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    arch, L, B, S = DRYRUN_GLM4
    fd, out = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    dry, dry_s = dryrun_cli(
        ["--arch", arch, "--shape", "train_4k", "--mesh", "host", "--opt",
         f"n_layers={L},global_batch={B},seq_len={S},planner_loss=true"],
        out)
    os.remove(out)
    cfg = get_config(arch).with_(n_layers=L, use_kernels=True)
    model = Model(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mesh = tmesh.make_host_mesh(device=dev)
    try:
        m0 = torch.cuda.memory_allocated()
        state = init_train_state(model, model.init(0, device=dev), mesh)
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated() - m0
        batch = to_dev(train_data(cfg, S, B).batch(0), dev)
        step = make_train_step(model, OptConfig(), mesh,
                               use_planner_loss=True)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        real = trace_counts(step, state, batch)
        torch.cuda.synchronize()
        real_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        n_tensors = sum(1 for t in tree_leaves(state.params)) + 2 * sum(
            1 for t in tree_leaves(state.opt.m)) + 1
        real_bytes = tree_bytes(state)
    finally:
        tmesh.destroy()
        torch.cuda.empty_cache()
    want_bytes = dry["memory"]["state_bytes"]
    rec = {"dryrun_s": dry_s, "dryrun_trace_s": dry["trace_s"],
           "real_step_s": real_s,
           "flops": {"dryrun": dry["structural_flops_per_device"],
                     "card": real.flops},
           "records": len(real.records), "recompute": len(real.recompute),
           "state_bytes": {"dryrun": want_bytes, "card_tensors": real_bytes,
                           "card_allocated": allocated,
                           "tensors": n_tensors},
           "peak": {"dryrun_total": dry["memory"]["peak_by_category"].get(
               "Total"), "card_max_memory_allocated": peak},
           "findings": {"dryrun": dry.get("trace_findings", []),
                        "card": real.findings}}
    log(f"  dry run (fake one-rank world, subprocess) {dry_s:.1f} s "
        f"({dry['trace_s']} s traced); the real step under the counter "
        f"{real_s:.2f} s")
    log(f"  FLOPs a rank: dry run {dry['structural_flops_per_device']:.6g}, "
        f"card {real.flops:.6g}; records {len(real.records)} (+"
        f"{len(real.recompute)} in the recompute)")
    log(f"  state: dry run {want_bytes} B, card tensors {real_bytes} B, "
        f"allocated {allocated} B over {n_tensors} tensors; peak: dry run "
        f"{rec['peak']['dryrun_total']} B, card max_memory_allocated "
        f"{peak} B (no bar)")
    if real.flops != dry["structural_flops_per_device"]:
        raise AssertionError(f"FLOPs: card {real.flops}, dry run "
                             f"{dry['structural_flops_per_device']}")
    if [list(r) for r in real.records] != dry["records"] or \
            [list(r) for r in real.recompute] != dry["recompute_records"]:
        raise AssertionError(f"collective records differ: card "
                             f"{real.records[:8]}..., dry run "
                             f"{dry['records'][:8]}...")
    if real_bytes != want_bytes or not \
            0 <= allocated - want_bytes <= 512 * n_tensors:
        raise AssertionError(f"state bytes: {rec['state_bytes']}")
    if real.findings or dry.get("trace_findings"):
        raise AssertionError(f"findings: {rec['findings']}")
    return rec


def dryrun_cells_phase():
    """Phase 37: the full-width dry-run cells, each in a subprocess: glm4-9b
    train_4k on the 256-rank single-pod mesh and qwen3-moe-30b-a3b
    train_4k on the 512-rank multi-pod mesh; their seconds, FLOPs a rank
    and reconciliation findings logged, and their roofline terms, which
    are predictions from the H100's data-sheet constants, not times."""
    rec = {}
    for arch, shape, mesh in DRYRUN_CELLS:
        fd, out = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        art, sec = dryrun_cli(["--arch", arch, "--shape", shape, "--mesh",
                               mesh], out)
        os.remove(out)
        r = art["roofline"]
        rec[f"{arch} {shape} {mesh}"] = {
            "s": sec, "trace_s": art["trace_s"], "devices": art["devices"],
            "flops_per_device": art["structural_flops_per_device"],
            "useful_flop_ratio": art.get("useful_flop_ratio"),
            "state_bytes": art["memory"]["state_bytes"],
            "peak_total": art["memory"]["peak_by_category"].get("Total"),
            "reconcile_findings": len(art["reconcile"]["findings"]),
            "reconcile_unexplained": sum(
                1 for f in art["reconcile"]["findings"]
                if not f.get("explained")),
            "contracts_ok": art["contracts"]["ok"],
            "predicted_roofline": {k: r[k] for k in (
                "t_compute_s", "t_memory_s", "t_collective_s",
                "bottleneck", "bound_serial_s", "bound_overlap_s")}}
        log(f"  {arch} {shape} {mesh} ({art['devices']} fake ranks): "
            f"{sec:.1f} s ({art['trace_s']} s traced), "
            f"{art['structural_flops_per_device']:.6g} FLOPs a rank, "
            f"reconciliation {len(art['reconcile']['findings'])} findings, "
            f"sharded contracts ok {art['contracts']['ok']}; predicted "
            f"(data-sheet constants, not times) compute "
            f"{r['t_compute_s']:.4g} s, memory {r['t_memory_s']:.4g} s, "
            f"collective {r['t_collective_s']:.4g} s")
        if not art["contracts"]["ok"] or art.get("trace_findings"):
            raise AssertionError(f"{arch} {mesh}: {art['contracts']} "
                                 f"{art.get('trace_findings')}")
    return rec


# phase 38: the bench's time limit
SEARCH_BENCH_TIMEOUT = 600


def search_throughput_phase(plan_root):
    """Phase 38: ``python -m repro_torch.launch.search_throughput`` on
    the card, in a subprocess, its record in a scratch directory.  Every
    gate of the bench must hold (exit 0, ``ok``); the timing floors and
    the streamed GEMM's launches are checked here again by name."""
    from repro_torch.launch import search_throughput as st
    import resource
    out = Path(tempfile.mkdtemp(prefix="search", dir=plan_root)) / "st.json"
    load = os.getloadavg()
    own = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.search_throughput",
         "--out", str(out)], env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        cwd=ROOT, capture_output=True, text=True,
        timeout=SEARCH_BENCH_TIMEOUT)
    sec = time.perf_counter() - t0
    used = resource.getrusage(resource.RUSAGE_SELF)
    # the host's timing floors share its cores with this process
    log(f"  load average before {load[0]:.2f}; this process used "
        f"{used.ru_utime - own.ru_utime + used.ru_stime - own.ru_stime:.1f}"
        f" s of CPU while the bench ran")
    for line in r.stdout.splitlines():
        log(f"  | {line}")
    if r.returncode != 0 or not out.exists():
        raise AssertionError(f"search_throughput exited {r.returncode}: "
                             f"{r.stderr[-3000:]}")
    res = json.loads(out.read_text())
    ex, ch, ov = res["executors"], res["chunking"], res["overlap"]
    kern = ov["fused_kernel"]
    log(f"  {sec:.1f} s in all on {res['device']}; host "
        f"{res['host']['cpu_model']}, {res['host']['machine']} "
        f"({res['host']['cpus']} CPUs); "
        f"sections (s) " + ", ".join(f"{k} {v:.2f}" for k, v in
                                   res["section_seconds"].items()))
    log("  executors jobs/s " + ", ".join(
        f"{k} {v:.1f}" for k, v in ex["jobs_per_sec"].items())
        + f" (process/thread {ex['process_vs_thread']:.2f}); chunking "
        "jobs/s " + ", ".join(f"{k} {v:.2f}" for k, v in
                              ch["jobs_per_sec"].items())
        + f" (size/contiguous {ch['size_vs_contiguous']:.3f})")
    log("  spaces speedup " + ", ".join(
        f"{s['workload']}_{s['axes']} {s['speedup']:.1f}x"
        for s in res["spaces"]) + "; autotune warm speedup " + ", ".join(
        f"{k} {e['warm_speedup']:.0f}x"
        for k, e in res["autotune"]["entries"].items()))
    for rec in kern["bench"]["double_buffer"]:
        log(f"  streamed_gemm {rec['shape']}: ms {rec['ms']:.4f} (device "
            f"{rec['device_ms']:.4f}), buffers=1 {rec['ms_buffers1']:.4f}, "
            f"torch.matmul {rec['library_ms']:.4f}, bound "
            f"{rec['bound_ms']:.4f}")
    log(f"  overlap bench: streamed_gemm launches {kern['launches']} (calls "
        f"{kern['calls']}), hidden fraction "
        f"{'degenerate (one rank)' if kern['hidden_degenerate'] else kern['hidden_fraction']}")
    floors = {
        "spaces": all(s["speedup"] >= st.SPEEDUP_FLOOR
                      for s in res["spaces"]),
        "autotune": all(e["warm_speedup"] >= st.WARM_SPEEDUP_FLOOR
                        for e in res["autotune"]["entries"].values()),
        "process >= thread": (ex["jobs_per_sec"]["process"]
                              >= ex["jobs_per_sec"]["thread"]
                              and not ex["fallbacks"]),
        "chunking": ch["size_vs_contiguous"] >= st.CHUNKING_TOLERANCE,
    }
    if not (res["ok"] and all(floors.values())
            and res["schema"] == st.SCHEMA
            and kern["launches"] == kern["calls"] > 0
            and kern["device"] == torch.cuda.get_device_name(0)):
        raise AssertionError(f"search_throughput: ok {res['ok']}, floors "
                             f"{floors}, streamed_gemm launches "
                             f"{kern['launches']} of {kern['calls']}")
    return {"seconds": sec, "device": res["device"], "host": res["host"],
            "section_seconds": res["section_seconds"],
            "jobs_per_sec": {"executors": ex["jobs_per_sec"],
                             "chunking": ch["jobs_per_sec"]},
            "floors": floors, "streamed_gemm": kern["bench"]["double_buffer"],
            "launches": kern["launches"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from repro_torch import resolve_device
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm_epilogue as ge
    from repro_torch.kernels import ssd
    from repro_torch.kernels.allgather_gemm import (CLUSTER, TILES,
                                                    cluster,
                                                    max_active_clusters,
                                                    streamed_gemm, tile)
    from repro_torch.kernels.allgather_gemm import tolerance as ag_tolerance
    from repro_torch.kernels.gemm_layernorm import (gemm_layernorm,
                                                     gemm_rmsnorm)
    from repro_torch.kernels.gemm_softmax import gemm_softmax
    from repro_torch.kernels.ref import attention_ref, ssd_chunked_ref
    from repro_torch.models.model import Model

    counters = {"flash_attention": fa.flash_attention_fwd,
                "ssd_scan": ssd.ssd_scan_fwd, "gemm_softmax": gemm_softmax,
                "gemm_layernorm": gemm_layernorm,
                "gemm_rmsnorm": gemm_rmsnorm, "streamed_gemm": streamed_gemm}
    from repro_torch.kernels import autotune
    # every plan this run solves goes to a fresh directory, removed at exit
    plan_dir = tempfile.TemporaryDirectory(prefix="repro-plans-")
    plan_root = plan_dir.name
    os.environ["REPRO_PLAN_CACHE"] = tempfile.mkdtemp(prefix="kernels",
                                                      dir=plan_root)
    t_all = time.perf_counter()
    # ------------------------------------------------------------ 1. device
    t0 = phase("1. device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    log(smi)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"device {kind}, capability {torch.cuda.get_device_capability(0)}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")

    # ------------------------------------------------------------- 2. build
    t0 = phase("2. build")
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:   # nvcc each
        built = dict(zip(KERNEL_SOURCES,
                         pool.map(_build.build, KERNEL_SOURCES)))
    build_s = {}
    for name, (lib, seconds, build_log) in built.items():
        build_s[name] = seconds
        log(f"built {lib.relative_to(ROOT)} in {seconds:.1f} s")
        for entry, used, spill in ptxas_summary(build_log):
            log(f"  ptxas: {entry}: {used}; {spill}")
    for source, bf16_entry in (("flash_attention", "fa_fwd_bf16"),
                               ("ssd_scan", "ssd_fwd_bf16"),
                               ("gemm_epilogue", "ge_bf16_kernel"),
                               ("streamed_gemm", "sg_bf16_kernel")):
        for entry, used, spill in ptxas_summary(built[source][2]):
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", spill)
            if bf16_entry in entry and (not m or m.groups() != ("0", "0")):
                raise AssertionError(f"a bf16 {source} instance spills: "
                                     f"{entry}: {used}; {spill}")
    for D in fa.HEAD_DIMS:
        keys, stages = fa.source_tile(D)
        t = fa.tiling(4, 32, 2, 1024, 1024, D, torch.bfloat16)
        log(f"  flash_attention D {D}: bf16 {keys} keys a tile, {stages} "
            f"stages, dynamic shared memory "
            f"{fa.smem_bytes(torch.bfloat16, D)} B; f32 "
            f"{fa.smem_bytes(torch.float32, D)} B")
        if (keys, stages) != (t.keys, t.stages):
            raise AssertionError(f"flash_attention.cu's bf16 D {D} tile is "
                                 f"{keys} keys x {stages} stages, the "
                                 f"wrapper's tiling says {t.keys} x "
                                 f"{t.stages}")
    for dtype in (torch.float32, torch.bfloat16):
        for rows, passes, cl in ge.instances(dtype):
            placed = {epi: ge.max_active_clusters(epi, dtype, rows, passes,
                                                  cl) for epi in ge.EPILOGUES}
            log(f"  gemm_epilogue {str(dtype)[6:]} {rows} rows {passes} "
                f"pass(es) cluster {cl:2d}: dynamic shared memory "
                f"{ge.smem_bytes(dtype, rows, passes)} B; max active "
                f"clusters " + ", ".join(f"{epi} {n}"
                                         for epi, n in placed.items()))
            if min(placed.values()) <= 0:
                raise AssertionError(f"gemm_epilogue {dtype} {rows} rows "
                                     f"{passes} passes: a cluster of {cl} "
                                     f"cannot be placed: {placed}")
    for dtype, want_tile in TILES.items():
        log(f"  streamed_gemm {str(dtype)[6:]}: tile {tile(dtype)} (rows, "
            f"columns, k-tile), cluster {cluster(dtype)}")
        if tile(dtype) != want_tile or cluster(dtype) != CLUSTER[dtype]:
            raise AssertionError(f"streamed_gemm.cu's {dtype} tile is "
                                 f"{tile(dtype)} in clusters of "
                                 f"{cluster(dtype)}, the wrapper assumes "
                                 f"{want_tile} in clusters of "
                                 f"{CLUSTER[dtype]}")
    sg_clusters = max_active_clusters()
    log(f"  streamed_gemm bf16: max active clusters {sg_clusters}")
    if sg_clusters <= 0:
        raise AssertionError("a cluster of the bf16 streamed GEMM cannot be "
                             "placed")
    serialized = [line for line in built["ssd_scan"][2].splitlines()
                  if "C7512" in line and "ssd_fwd_bf16" in line]
    if serialized:   # ptxas waits after each wgmma: the overlap is gone
        raise AssertionError(f"a bf16 ssd_scan instance's wgmma are "
                             f"serialized: {serialized[0]}")
    for P, N in ((16, 16), (16, 32), (32, 64), (64, 128)):
        log(f"  ssd_scan f32 P {P} N {N}: dynamic shared memory "
            f"{ssd.f32_smem_bytes(N, P)} B")
    mcfg = get_config("mamba2-130m").with_(use_kernels=True)
    m_batch = 8     # phases 8 and 9: BH = 8 x 24 heads, S 1024
    for r in (1, mcfg.ssm_nheads // mcfg.ssm_ngroups):
        t = ssd.tiling(m_batch * mcfg.ssm_nheads, r, 1024,
                       mcfg.ssm_headdim, mcfg.ssm_state, torch.bfloat16)
        stages, smem, per_sm = ssd.bf16_tile(mcfg.ssm_state, mcfg.ssm_headdim)
        log(f"  ssd_scan bf16 serving shape, r {r}: {t.units} CTAs of one "
            f"head, {stages} stages, dynamic shared memory {smem} B, "
            f"{per_sm} CTAs an SM (tiling {t.ctas_per_sm}), "
            f"{ssd.SMS * per_sm} resident")
        if (stages, smem) != ssd.bf16_layout(mcfg.ssm_state,
                                              mcfg.ssm_headdim) \
                or per_sm != t.ctas_per_sm or t.units > ssd.SMS * per_sm:
            raise AssertionError(f"ssd_scan.cu's unit does not match "
                                 f"ssd.tiling or is not one wave: {t}, "
                                 f"stages {stages}, smem {smem}, {per_sm} "
                                 f"an SM")
    log(f"phase 2: {time.perf_counter() - t0:.1f} s")

    # ----------------------------------- 3. kernel against its plain version
    t0 = phase("3. kernel vs attention_ref")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = []
    spec = [  # name, B, Hq, Hkv, Sq, Skv, D, causal, window, model layout
        ("glm4_gqa", 2, 32, 2, 256, 256, 128, True, None, True),
        ("glm4_gqa_noncausal", 2, 32, 2, 256, 256, 128, False, None, True),
        ("ragged_100", 1, 4, 2, 100, 100, 64, True, None, False),
        ("sq_lt_skv", 2, 8, 2, 64, 192, 32, True, None, False),
        ("sq_lt_skv_noncausal", 2, 8, 2, 64, 192, 32, False, None, False),
        ("window_64", 1, 4, 4, 256, 256, 64, True, 64, False),
        ("fully_masked_rows", 1, 4, 2, 100, 40, 128, True, None, False),
        ("head_dim_16", 1, 4, 2, 72, 72, 16, True, None, False),
    ] + list(fa.BOUNDARY_CASES)
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for name, B, Hq, Hkv, Sq, Skv, D, causal, window, layout in spec:
            q, k, v = attn_inputs(gen, B, Hq, Hkv, Sq, Skv, D, dtype,
                                  model_layout=layout)
            out = fa.flash_attention_fwd(q, k, v, causal=causal,
                                         window=window)
            want = attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            diff = (out.float() - want.float()).abs()
            err = float(diff.max())
            ok = bool((diff <= tol + tol * want.float().abs()).all())
            if causal and Sq > Skv:   # rows before the first key: exactly 0
                ok &= bool((out[:, :, :Sq - Skv] == 0).all())
            label = f"{name}_{str(dtype)[6:]}"
            t = fa.tiling(B, Hq, Hkv, Sq, Skv, D, dtype)
            log(f"  {label:36s} tiling {t.keys} keys {t.heads} head(s) "
                f"{t.stages} stages {t.items} items  max_abs_err "
                f"{err:.3e}  tol {tol:g}  {'ok' if ok else 'FAIL'}")
            cases.append({"case": label, "max_abs_err": err, "tol": tol})
            if not ok:
                raise AssertionError(f"flash_attention disagrees with "
                                     f"attention_ref in {label}: {err}")
    # the shapes a rank of a 2- or 4-rank model axis gives it (serving on a
    # mesh; the card runs the (1, 1) mesh, which gives it phase 5's)
    rank_fa = {f"{arch} m={m}": family_attention_check(gen, arch, m)
               for arch, m in kb.RANK_ATTENTION_SHAPES}
    log(f"phase 3: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------ 4. kernel at the serve shape
    t0 = phase("4. kernel time at glm4-9b prefill shape")
    B, Hq, Hkv, S, D = (kb.ATTENTION_SHAPE[n] for n in
                        ("B", "Hq", "Hkv", "S", "D"))
    q, k, v = attn_inputs(gen, B, Hq, Hkv, S, S, D, torch.bfloat16,
                          model_layout=True)
    out = fa.flash_attention_fwd(q, k, v, causal=True)
    want = attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    diff = (out.float() - want.float()).abs()
    main_err = float(diff.max())
    if not bool((diff <= BF16_TOL + BF16_TOL * want.float().abs()).all()):
        raise AssertionError(f"kernel disagrees at the serve shape: {main_err}")
    del out, want, diff
    rec = kb.bench_attention(q, k, v)
    kernel_ms, plain_ms, library_ms = rec["ms"], rec["plain_ms"], \
        rec["library_ms"]
    bound_ms, bound_by, flops = rec["bound_ms"], rec["bound_by"], rec["flops"]
    log(f"  q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal: "
        f"{flops / 1e9:.2f} GFLOP, {rec['bytes'] / 1e6:.1f} MB")
    log(f"  max_abs_err {main_err:.3e}")
    log(f"  kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}  "
        f"library_ms {library_ms:.4f}  bound_ms {bound_ms:.4f} ({bound_by})")
    log(f"  device_ms {rec['device_ms']:.4f}  library_device_ms "
        f"{rec['library_device_ms']:.4f} (torch.profiler, 50 calls)")
    l2 = rec["l2_bytes_q"] + rec["l2_bytes_kv"] + rec["l2_bytes_o"]
    log(f"  tiling {rec['tile']}")
    log(f"  L2 loads counted from the tiling: q "
        f"{rec['l2_bytes_q'] / 1e6:.1f} MB, k/v "
        f"{rec['l2_bytes_kv'] / 1e6:.1f} MB, o {rec['l2_bytes_o'] / 1e6:.1f}"
        f" MB; {l2 / rec['device_ms'] / 1e9:.2f} TB/s over the device time")
    log(f"  kernel {flops / kernel_ms / 1e9:.1f} TFLOP/s, "
        f"{100 * bound_ms / kernel_ms:.1f}% of bound")
    fa_job = autotune.attention_plan_job(S, S, D)
    log(f"  COMET plan on h100 (information only): blocks "
        f"{autotune.attention_blocks(S, S, D)}, {plan_ms(fa_job):.4f} ms a "
        f"({S}, {S}, {D}) head (not causal), x {B * Hq} heads "
        f"{plan_ms(fa_job, B * Hq):.4f} ms against the kernel's "
        f"{kernel_ms:.4f} ms")
    fa_shape = {"q": [B, Hq, S, D], "kv": [B, Hkv, S, D],
                "dtype": "bfloat16", "causal": True}
    fa_rec = rec
    del q, k, v
    log(f"phase 4: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------- 5. serve glm4-9b
    t0 = phase("5. serve glm4-9b (full config, bf16, use_kernels=True)")
    cfg = get_config("glm4-9b").with_(use_kernels=True)
    model = Model(cfg)
    t_init = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    log(f"  {model.n_params() / 1e9:.3f} B params initialised on the card "
        f"in {time.perf_counter() - t_init:.1f} s")
    glm4_plans = plan_warmup_check("glm4", model, params, plan_root,
                                   batch=4, prompt_len=1024, cache_len=2048)
    serve, glm4_launches = serve_and_profile(
        "glm4-9b", model, params, dev, batch=4, prompt_len=1024,
        cache_len=2048, n_requests=8, max_new=16, counters=counters)
    launches = glm4_launches["flash_attention"]
    if launches != cfg.n_layers * serve["prefill_calls"] or launches == 0:
        raise AssertionError(f"flash_attention launched {launches} times for "
                             f"{serve['prefill_calls']} prefills of "
                             f"{cfg.n_layers} layers")
    serve["plan_warmup"] = glm4_plans
    del params, model
    torch.cuda.empty_cache()
    log(f"phase 5: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------- 6. continuous batching on the card
    t0 = phase("6. continuous batching (glm4 smoke, f32, use_kernels=True)")
    scfg = get_smoke_config("glm4-9b").with_(dtype="float32", use_kernels=True)
    smodel = Model(scfg)
    sparams = smodel.init(0, device=dev)
    batching_matches_serial(smodel, sparams, prompt_len=16, cache_len=48)
    toks = torch.arange(256, device=dev).reshape(2, 128) % scfg.vocab_size
    lk = smodel.logits(sparams, {"tokens": toks})
    lp = Model(scfg.with_(use_kernels=False)).logits(sparams, {"tokens": toks})
    path_err = float((lk - lp).abs().max())
    if not torch.allclose(lk, lp, atol=1e-4, rtol=1e-4):
        raise AssertionError(f"kernel path logits differ: {path_err}")
    log(f"  7 requests through 3 slots == serial decoding; kernel-path "
        f"logits vs plain path max_abs_err {path_err:.3e} (tol 1e-4)")
    log(f"phase 6: {time.perf_counter() - t0:.1f} s")

    # --------------------------------- 7. SSD kernel against its plain version
    t0 = phase("7. SSD kernel vs ssd_chunked_ref")
    ssd_cases = []
    ssd_spec = [  # name, BH, r, S, P, N, chunk, xbc view
        ("jax_sweep_1", 2, 1, 128, 16, 32, 64, False),
        ("jax_sweep_2", 4, 1, 256, 32, 64, 64, False),
        ("jax_sweep_ragged", 1, 1, 200, 16, 32, 64, False),
        ("smoke_head", 4, 1, 96, 16, 16, 64, False),
        ("smoke_head_chunk8", 4, 1, 24, 16, 16, 8, False),
        ("full_head", 4, 1, 512, 64, 128, 64, False),
        ("full_head_ragged", 3, 1, 100, 64, 128, 64, False),
        ("full_head_group24", 48, 24, 512, 64, 128, 64, False),
        ("full_head_group24_ragged", 24, 24, 100, 64, 128, 64, False),
    ] + list(ssd.BOUNDARY_CASES)
    for dtype in (torch.float32, torch.bfloat16):
        for name, BH, r, S_, P, N, chunk, view in ssd_spec:
            x, dA, Bm, Cm = kb.ssd_inputs(
                gen, {"BH": BH, "S": S_, "P": P, "N": N, "r": r, "xbc": view},
                dtype, "cuda")
            out = ssd.ssd_scan_fwd(x, dA, Bm, Cm, chunk=chunk)
            want = ssd_chunked_ref(x, dA, ssd.expand_groups(Bm, r),
                                   ssd.expand_groups(Cm, r),
                                   chunk=min(chunk, S_))
            torch.cuda.synchronize()
            diff = (out.float() - want.float()).abs()
            err = float(diff.max())
            scale = float(want.float().abs().max())
            if dtype == torch.float32:
                tol = SSD_F32_TOL
                ok = bool((diff <= tol + tol * want.float().abs()).all())
            else:
                tol = SSD_BF16_TOL
                ok = err <= tol * scale
            ok &= out.dtype == dtype and out.shape == x.shape
            label = f"{name}_{str(dtype)[6:]}"
            log(f"  {label:36s} r {r:2d}  max_abs_err {err:.3e}  max|plain| "
                f"{scale:.2f}  tol {tol:g}  {'ok' if ok else 'FAIL'}")
            ssd_cases.append({"case": label, "r": r, "max_abs_err": err,
                              "max_abs_plain": scale, "tol": tol})
            if not ok:
                raise AssertionError(f"ssd_scan disagrees with "
                                     f"ssd_chunked_ref in {label}: {err}")
    rank_ssd = {f"{arch} m={m}": rank_ssd_check(gen, arch, m)
                for arch, m in kb.RANK_SSD_SHAPES}
    log(f"phase 7: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------- 8. SSD at the mamba2 serve shape
    t0 = phase("8. SSD kernel time at mamba2-130m prefill shape")
    BH, S, P, N = m_batch * mcfg.ssm_nheads, 1024, mcfg.ssm_headdim, \
        mcfg.ssm_state
    if {"BH": BH, "S": S, "P": P, "N": N} != kb.SSD_SHAPE \
            or dict(kb.SSD_SHAPE, r=mcfg.ssm_nheads // mcfg.ssm_ngroups,
                    xbc=True) != kb.SSD_GROUP_SHAPE:
        raise AssertionError(f"the bench's SSD shapes {kb.SSD_SHAPES} are "
                             f"not the serving shape")
    ssd_recs = {}
    for form, shape in (("per_head", kb.SSD_SHAPE),
                        ("group", kb.SSD_GROUP_SHAPE)):
        x, dA, Bm, Cm = kb.ssd_inputs(gen, shape, torch.bfloat16, dev)
        if form == "group" and Bm.stride(1) != mcfg.conv_dim:
            raise AssertionError(f"the group form's B/C rows {Bm.stride()} "
                                 f"are not the model's conv output rows "
                                 f"({mcfg.conv_dim} columns)")
        rec = kb.bench_ssd(x, dA, Bm, Cm)
        if rec["max_abs_err"] > SSD_BF16_TOL * rec["max_abs_plain"]:
            raise AssertionError(f"ssd_scan disagrees at the serve shape "
                                 f"({form}): {rec['max_abs_err']} (max "
                                 f"|plain| {rec['max_abs_plain']})")
        log(f"  {form}: xdt {tuple(x.shape)} B/C {tuple(Bm.shape)} (strides "
            f"{Bm.stride()}) bf16, dA "
            f"f32, chunk {ssd.CHUNK}: {rec['flops'] / 1e9:.2f} GFLOP, "
            f"{rec['bytes'] / 1e6:.1f} MB; tiling {rec['tile']}")
        log(f"    max_abs_err {rec['max_abs_err']:.3e} (max |plain| "
            f"{rec['max_abs_plain']:.2f})")
        log(f"    kernel_ms {rec['ms']:.4f}  device_ms {rec['device_ms']:.4f}"
            f" (torch.profiler, 50 calls)  plain_ms {rec['plain_ms']:.4f}  "
            f"library_ms null (no single PyTorch call computes the SSD "
            f"scan)  bound_ms {rec['bound_ms']:.4f} ({rec['bound_by']})")
        log(f"    kernel {rec['bytes'] / rec['ms'] / 1e6:.1f} GB/s, "
            f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of bound "
            f"({100 * rec['bound_ms'] / rec['device_ms']:.1f}% by device "
            f"time)")
        ssd_recs[form] = rec
        del x, dA, Bm, Cm
    # the plan's chunk, and the group form timed at every chunk the plan
    # ranked (the plan's and the kernel's 64 among them) beside the
    # modelled latency of each
    plan_chunk = autotune.ssd_chunk_len(S, P, N)
    log(f"  the plan's chunk: {plan_chunk} (the kernel's own: {ssd.CHUNK})")
    x, dA, Bm, Cm = kb.ssd_inputs(gen, kb.SSD_GROUP_SHAPE, torch.bfloat16,
                                  dev)
    for job in autotune.ssd_plan_jobs(S, P, N):
        c = job[3]
        rec = kb.bench_ssd(x, dA, Bm, Cm, chunk=c)
        if rec["max_abs_err"] > SSD_BF16_TOL * rec["max_abs_plain"]:
            raise AssertionError(f"ssd_scan disagrees at chunk {c}: "
                                 f"{rec['max_abs_err']}")
        log(f"    group form at chunk {c}: kernel_ms {rec['ms']:.4f}  "
            f"device_ms {rec['device_ms']:.4f}  max_abs_err "
            f"{rec['max_abs_err']:.3e}; COMET plan on h100 (information "
            f"only): {plan_ms(job, BH * -(-S // c)):.4f} ms for {BH} heads")
        ssd_recs[f"group_chunk{c}"] = rec
    del x, dA, Bm, Cm
    rec = ssd_recs["per_head"]
    ssd_err, ssd_ms, ssd_plain_ms = rec["max_abs_err"], rec["ms"], \
        rec["plain_ms"]
    ssd_bound_ms, ssd_bound_by = rec["bound_ms"], rec["bound_by"]
    log(f"phase 8: {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------- 9. serve mamba2-130m
    t0 = phase("9. serve mamba2-130m (full config, bf16, use_kernels=True)")
    model = Model(mcfg)
    t_init = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    log(f"  {model.n_params() / 1e6:.1f} M params initialised on the card "
        f"in {time.perf_counter() - t_init:.1f} s")
    mamba_plans = plan_warmup_check("mamba2", model, params, plan_root,
                                    batch=m_batch, prompt_len=1024,
                                    cache_len=2048)
    mserve, mamba_launches = serve_and_profile(
        "mamba2-130m", model, params, dev, batch=m_batch, prompt_len=1024,
        cache_len=2048, n_requests=16, max_new=16, counters=counters)
    launches_ssd = mamba_launches["ssd_scan"]
    if launches_ssd != mcfg.n_layers * mserve["prefill_calls"] \
            or launches_ssd == 0:
        raise AssertionError(f"ssd_scan launched {launches_ssd} times for "
                             f"{mserve['prefill_calls']} prefills of "
                             f"{mcfg.n_layers} layers")
    served_chunks = mserve["launch_chunks"]["ssd_scan"]
    if served_chunks != {plan_chunk: launches_ssd}:
        raise AssertionError(f"ssd_scan launches by chunk {served_chunks}; "
                             f"want all {launches_ssd} at the plan's chunk "
                             f"{plan_chunk}")
    log(f"  every ssd_scan launch at the plan's chunk {plan_chunk}: "
        f"{served_chunks}")
    mserve["plan_warmup"], mserve["plan_chunk"] = mamba_plans, plan_chunk
    pre = mserve["breakdown"]["prefill"]
    log(f"  ssd_scan launches {launches_ssd} == {mcfg.n_layers} layers x "
        f"{mserve['prefill_calls']} prefills; its share of one prefill: "
        f"{pre['ssd_scan_ms']:.3f} of {mserve['breakdown']['prefill_ms']:.2f}"
        f" ms ({100 * pre['ssd_scan_ms'] / mserve['breakdown']['prefill_ms']:.1f}"
        f"% by CUDA events; {100 * pre['ssd_scan_ms'] / pre['kernel_ms']:.1f}"
        f"% of the kernel time)")
    del params, model
    torch.cuda.empty_cache()
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")

    # --------------------------- 10. mamba2 continuous batching on the card
    t0 = phase("10. continuous batching (mamba2 smoke, f32, use_kernels=True)")
    scfg = get_smoke_config("mamba2-130m").with_(dtype="float32",
                                                 use_kernels=True)
    smodel = Model(scfg)
    sparams = smodel.init(0, device=dev)
    batching_matches_serial(smodel, sparams, prompt_len=16, cache_len=48)
    toks = torch.arange(256, device=dev).reshape(2, 128) % scfg.vocab_size
    lk = smodel.logits(sparams, {"tokens": toks})
    lp = Model(scfg.with_(use_kernels=False)).logits(sparams, {"tokens": toks})
    mpath_err = float((lk - lp).abs().max())
    if not torch.allclose(lk, lp, atol=MAMBA_PATH_TOL, rtol=MAMBA_PATH_TOL):
        raise AssertionError(f"mamba2 kernel path logits differ: {mpath_err}")
    log(f"  7 requests through 3 slots == serial decoding; kernel-path "
        f"logits vs plain path max_abs_err {mpath_err:.3e} "
        f"(tol {MAMBA_PATH_TOL})")
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")

    # ---------------------- 11. fused GEMM epilogues against plain versions
    t0 = phase("11. fused GEMM epilogues vs their plain versions")
    gemm_spec = [  # name, M, K, N, kind, kernels
        ("jax_sweep_1", 128, 64, 256, "normal", GEMM_KERNELS),
        ("jax_sweep_2_ragged", 200, 96, 256, "normal", GEMM_KERNELS),
        ("jax_sweep_3", 64, 128, 512, "normal", GEMM_KERNELS),
        ("jax_norm_ragged_k", 96, 100, 128, "normal", GEMM_KERNELS),
        ("ragged_n1000_cl1", 200, 100, 1000, "normal", GEMM_KERNELS),
        ("ragged_cl2", 33, 40, 1032, "normal", GEMM_KERNELS),
        ("cl4", 64, 64, 4096, "normal", GEMM_KERNELS),
        ("ragged_cl8", 17, 72, 4104, "normal", GEMM_KERNELS),
        ("cl16", 48, 64, 16384, "normal", GEMM_KERNELS),
        ("m1_cloud", 1, 128, 16384, "normal", GEMM_KERNELS),
        ("m4_cloud", 4, 128, 16384, "normal", GEMM_KERNELS),
        ("softmax_max_in_last_slice", 8, 64, 16384, "spike",
         ("gemm_softmax",)),
        ("layernorm_mean_1e3", 32, 32, 4096, "mean_1e3",
         ("gemm_layernorm",)),
    ]
    gemm_cases = []

    def gemm_case(label, inputs, name):
        err, scale, tol, ok = gemm_check(name, *inputs)
        t = ge.tiling(inputs[1].shape[1], inputs[0].dtype)
        log(f"  {name:14s} {label:36s} tiling {tuple(t)}  max_abs_err "
            f"{err:.3e}  max|plain| {scale:.3g}  tol {tol:.3g}  "
            f"{'ok' if ok else 'FAIL'}")
        gemm_cases.append({"kernel": name, "case": label,
                           "cluster": t.cluster, "tiling": list(t),
                           "max_abs_err": err, "max_abs_plain": scale,
                           "tol": tol})
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"in {label}: {err} > {tol}")

    for dtype in (torch.float32, torch.bfloat16):
        for label, M, K, N, data, names in gemm_spec:
            inputs = gemm_inputs(gen, M, K, N, dtype, data)
            for name in names:
                gemm_case(f"{label}_{str(dtype)[6:]}", inputs, name)
        # both sides of every change of tiling (ge.boundary_shapes)
        for M, K, N in ge.boundary_shapes(dtype):
            inputs = gemm_inputs(gen, M, K, N, dtype)
            for name in GEMM_KERNELS:
                gemm_case(f"edge_{M}x{K}x{N}_{str(dtype)[6:]}", inputs, name)
    # the largest paper shape, three times each: a missing cluster barrier
    # shows only now and then
    inputs = gemm_inputs(gen, 4096, 4096, 16384, torch.bfloat16)
    for name in GEMM_KERNELS:
        for rep in range(3):
            gemm_case(f"paper_4096x16384x4096_bf16_run{rep}", inputs, name)
    del inputs
    torch.cuda.empty_cache()
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------- 12. the bench chain
    t0 = phase("12. the bench chain (repro_torch.launch.run: paper tables, "
               "Fig. 6, kernel_bench, MoE dispatch, roofline)")
    from repro_torch.launch import run as bench_chain
    for fn in counters.values():
        fn.launches = 0
    cwd = os.getcwd()
    # paper_tables writes its plan bundle (PLANS_kernels.json) to the cwd
    os.chdir(tempfile.mkdtemp(prefix="chain", dir=plan_root))
    try:
        chain = bench_chain.run_all("cuda")
    finally:
        os.chdir(cwd)
    bench = chain["kernel_bench"]
    torch.cuda.synchronize()
    bench_launches = {k: fn.launches for k, fn in counters.items()}
    log(f"  launches {bench_launches}  bench calls {bench['calls']}")
    want_launches = {k: bench["calls"].get(k, 0) for k in counters}
    if bench_launches != want_launches or 0 in bench_launches.values():
        raise AssertionError(f"launches {bench_launches} != the bench's "
                             f"calls {bench['calls']}")
    log(f"  chain: paper tables {sorted(chain['paper_tables'])}, Fig. 6 "
        f"collective median {chain['costmodel_compare']['collective']['median_rel_err']:.4f}, "
        f"MoE presets {sorted(chain['moe_dispatch'])}, roofline "
        f"{chain['roofline']['n']} dry-run artifacts")
    for rec in bench["records"]:
        name, err, big = rec["name"], rec["max_abs_err"], rec["max_abs_plain"]
        if name in GEMM_KERNELS:
            ok = err <= ge.tolerance(name[len("gemm_"):], torch.bfloat16, big)
        elif name == "flash_attention":
            ok = err <= BF16_TOL + BF16_TOL * big
        elif name == "ssd_scan":
            ok = err <= SSD_BF16_TOL * big
        else:
            ok = rec["within_tol"]
        if not ok:
            raise AssertionError(f"bench: {name} {rec['shape']} error "
                                 f"{err} (largest |plain| {big})")
    for shape in sorted({(r["shape"]["M"], r["shape"]["N"], r["shape"]["K"])
                         for r in bench["records"]
                         if r["name"] in GEMM_KERNELS}):
        measured = ", ".join(
            f"{r['name']} {r['ms']:.4f}" for r in bench["records"]
            if r["name"] in GEMM_KERNELS
            and (r["shape"]["M"], r["shape"]["N"], r["shape"]["K"]) == shape)
        job = autotune.gemm_epilogue_plan_job(*shape)
        log(f"  COMET plan on h100 (information only): (M, N, K) {shape}: "
            f"blocks {autotune.gemm_epilogue_blocks(*shape)}, "
            f"{plan_ms(job):.4f} ms; measured ms {measured}")
    gemm_main = {r["name"]: r for r in bench["records"]
                 if r["name"] in GEMM_KERNELS
                 and (r["shape"]["M"], r["shape"]["N"], r["shape"]["K"])
                 == (4096, 16384, 4096)}
    if sorted(gemm_main) != sorted(GEMM_KERNELS):
        raise AssertionError(f"the bench timed {sorted(gemm_main)} at "
                             f"(4096, 16384, 4096)")
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")

    # ----------------- 13. the streamed GEMM against its plain version
    t0 = phase("13. streamed GEMM vs streamed_gemm_ref")
    from repro_torch.kernels.allgather_gemm import (BUDGET_SHAPES,
                                                    boundary_shapes)
    from repro_torch.kernels.ref import streamed_gemm_ref
    sg_spec = [  # name, M, K, N, chunks
        ("jax_1", 64, 256, 128, 8), ("jax_2", 128, 512, 256, 4),
        ("jax_3_tiny_m", 8, 128, 128, 2),
        *[(f"budget_{M}x{K}x{N}x{c}", M, K, N, c)
          for M, K, N, c in BUDGET_SHAPES],
        ("ragged_mnk", 200, 200, 136, 1),       # K 200: a ragged k-tile
        ("ragged_chunk_40", 72, 160, 264, 4),   # kc 40 = 32 + 8 = 2 x 16 + 8
        ("chunk_48", 96, 240, 128, 5),          # kc 48 = 32 + 16 (bf16)
        ("chunk_below_k_tile", 33, 64, 40, 8),  # kc 8
        ("chunks_1", 96, 256, 192, 1),
    ]
    sg_cases = []
    for dtype in (torch.float32, torch.bfloat16):
        edges = [(f"edge_{M}x{K}x{N}x{c}", M, K, N, c)
                 for M, K, N, c in boundary_shapes(dtype)]
        glm4 = [("glm4_mlp_in", *kb.STREAMED_GEMM_SHAPE)] \
            if dtype == torch.bfloat16 else []
        for name, M, K, N, chunks in sg_spec + edges + glm4:
            x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
            w = (torch.randn(K, N, generator=gen, device="cuda")
                 * 0.2).to(dtype)
            want = streamed_gemm_ref(x, w, chunks=chunks)
            outs = {nbuf: streamed_gemm(x, w, chunks=chunks, buffers=nbuf)
                    for nbuf in (2, 1)}
            torch.cuda.synchronize()
            want_abs = want.float().abs()
            atol, rtol = ag_tolerance(dtype, float(want_abs.max()))
            errs = {nbuf: float((o.float() - want.float()).abs().max())
                    for nbuf, o in outs.items()}
            ok = all(o.dtype == dtype and o.shape == want.shape
                     and bool(((o.float() - want.float()).abs()
                               <= atol + rtol * want_abs).all())
                     for o in outs.values())
            same = torch.equal(outs[1], outs[2])
            label = f"{name}_{str(dtype)[6:]}"
            log(f"  {label:36s} max_abs_err buffers=2 {errs[2]:.3e} "
                f"buffers=1 {errs[1]:.3e}  max|plain| "
                f"{float(want_abs.max()):.3g}  atol {atol:.3g} rtol {rtol:g}"
                f"  modes equal {same}  {'ok' if ok and same else 'FAIL'}")
            sg_cases.append({"case": label, "M": M, "K": K, "N": N,
                             "chunks": chunks, "max_abs_err": errs[2],
                             "max_abs_err_buffers1": errs[1],
                             "max_abs_plain": float(want_abs.max()),
                             "atol": atol, "rtol": rtol,
                             "modes_equal": same})
            if not (ok and same):
                raise AssertionError(f"streamed_gemm disagrees with "
                                     f"streamed_gemm_ref in {label}: {errs}"
                                     f" (modes equal: {same})")
    refusals = [  # x shape, w shape, dtype, chunks, buffers, message
        ((16, 100), (100, 128), torch.float32, 3, 2, "must divide"),
        ((16, 128), (128, 128), torch.float32, 2, 3, "buffers"),
        ((16, 128), (128, 132), torch.bfloat16, 2, 2, "16-byte aligned"),
    ]
    before = streamed_gemm.launches
    for xs, ws, dtype, chunks, nbuf, msg in refusals:
        x = torch.randn(*xs, device="cuda").to(dtype)
        w = torch.randn(*ws, device="cuda").to(dtype)
        try:
            streamed_gemm(x, w, chunks=chunks, buffers=nbuf)
        except ValueError as e:
            if msg not in str(e):
                raise AssertionError(f"refusal of {xs} x {ws} chunks={chunks}"
                                     f" buffers={nbuf}: {e}") from e
            log(f"  refused on the card: {e}")
        else:
            raise AssertionError(f"streamed_gemm took {xs} x {ws} "
                                 f"chunks={chunks} buffers={nbuf}")
    if streamed_gemm.launches != before:
        raise AssertionError("a refused streamed_gemm call launched")
    log(f"phase 13: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------- 14. the overlap bench
    t0 = phase("14. overlap bench (repro_torch.launch.overlap_bench.run_all)")
    from repro_torch.launch import overlap_bench as ob
    for fn in counters.values():
        fn.launches = 0
    overlap = ob.run_all("cuda")
    torch.cuda.synchronize()
    overlap_launches = {k: fn.launches for k, fn in counters.items()}
    log(f"  launches {overlap_launches}  bench calls {overlap['calls']}")
    want_launches = {k: overlap["calls"].get(k, 0) for k in counters}
    if overlap_launches != want_launches \
            or overlap_launches["streamed_gemm"] == 0:
        raise AssertionError(f"launches {overlap_launches} != the bench's "
                             f"calls {overlap['calls']}")
    ag_rec = overlap["allgather_gemm"]
    if ag_rec["participants"] != 1 or ag_rec["backend"] != "nccl" \
            or not ag_rec["ok"]:
        raise AssertionError(f"allgather_gemm through one NCCL rank: "
                             f"{ag_rec}")
    if not overlap["fused_gather_gemm"]["degenerate"]:
        raise AssertionError("one rank must give a degenerate hidden "
                             "fraction")
    if not overlap["ok"]:
        raise AssertionError(f"the overlap bench failed a bar: "
                             f"{json.dumps(overlap)}")
    sg_main = overlap["double_buffer"][0]
    M, K, N, chunks = kb.STREAMED_GEMM_SHAPE
    if sg_main["shape"] != {"M": M, "K": K, "N": N, "chunks": chunks,
                            "dtype": "bfloat16"}:
        raise AssertionError(f"the bench's first shape is {sg_main['shape']}")
    sg_l2 = sg_main["l2_bytes_x"] + sg_main["l2_bytes_w"]
    log(f"  streamed_gemm (M, K, N) = ({M}, {K}, {N}) chunks {chunks} bf16: "
        f"ms {sg_main['ms']:.4f} (device {sg_main['device_ms']:.4f}), "
        f"torch.matmul {sg_main['library_ms']:.4f} (device "
        f"{sg_main['library_device_ms']:.4f}), bound "
        f"{sg_main['bound_ms']:.4f}; t1/t2 {sg_main['speedup']:.3f}; L2 "
        f"loads counted from the tiling ({sg_main['tile']}): x "
        f"{sg_main['l2_bytes_x'] / 1e9:.3f} GB, w "
        f"{sg_main['l2_bytes_w'] / 1e9:.3f} GB, "
        f"{sg_l2 / sg_main['device_ms'] / 1e9:.2f} TB/s over the device time")
    log(f"phase 14: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------- 15. train mamba2-130m
    t0 = phase("15. train mamba2-130m (full config, bf16, use_kernels=True)")
    ckpt = tempfile.TemporaryDirectory(prefix="train-ckpt-")
    train_mamba, train_ssd = train_phase(
        "mamba2-130m", dev, counters, batch=m_batch,
        seq=1024, cut="nothing cut", ckpt_dir=ckpt.name)
    ckpt.cleanup()
    log(f"phase 15: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------- 16. train glm4-9b, 4 layers
    t0 = phase("16. train glm4-9b (full width, 4 of 40 layers, bf16, "
               "use_kernels=True)")
    train_glm4, train_fa = train_phase(
        "glm4-9b", dev, counters, batch=4,
        seq=1024, n_layers=4,
        cut="depth cut to 4 of 40 layers by memory: at 40 layers bf16 "
            "params and grads and f32 AdamW moments take 9.4 B x 12 B = 113 "
            "GB, more than the card's 80 GB; at 4 layers 2.06 B x 12 B = 25 "
            "GB")
    log(f"phase 16: {time.perf_counter() - t0:.1f} s")

    family, fam_fa, h_ssd, family_paths = serve_families(
        dev, gen, counters, plan_root)

    # ---------------------- 22. the planner loss at glm4-9b's full width
    t0 = phase("22. the planner loss (sharded_softmax_xent) at glm4-9b's "
               "width on the host mesh")
    planner = planner_loss_phase(dev)
    log(f"phase 22: {time.perf_counter() - t0:.1f} s")

    # ----------------- 23. the train CLI on the host mesh, planner loss on
    t0 = phase("23. train CLI --mesh host --planner-loss (glm4-9b, full "
               "width, 4 of 40 layers, use_kernels=True)")
    mesh_train, mesh_train_fa = mesh_train_phase(dev, counters, train_glm4)
    log(f"phase 23: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------ 24. the front ends on the card
    t0 = phase("24. front ends (examples.serve_lm, train_lm, comet_attention)")
    torch.cuda.reset_peak_memory_stats()
    front = front_ends_phase(counters)
    log(f"  phase peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    log(f"phase 24: {time.perf_counter() - t0:.1f} s")

    # --------------- 25. qwen3-moe-30b-a3b on the host mesh, 4 of 48 layers
    t0 = phase("25. train CLI --mesh host --planner-loss (qwen3-moe-30b-a3b, "
               "full width, 4 of 48 layers, use_kernels=True)")
    moe_train, moe_train_fa = moe_mesh_train_phase(counters)
    log(f"phase 25: {time.perf_counter() - t0:.1f} s")

    # ----------------------------------------- 26. serve glm4-9b on a mesh
    t0 = phase("26. serve glm4-9b on the (1, 1) NCCL mesh (full config, "
               "bf16, use_kernels=True)")
    torch.cuda.reset_peak_memory_stats()
    mesh_glm4 = mesh_serve(
        "glm4-9b", dev, counters, plan_root, serve, batch=4, prompt_len=1024,
        cache_len=2048, n_requests=8, max_new=16,
        want={"flash_attention": get_config("glm4-9b").n_layers
              * serve["prefill_calls"]})
    cli_env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   REPRO_PLAN_CACHE=tempfile.mkdtemp(prefix="cli",
                                                     dir=plan_root))
    t_cli = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "glm4-9b", "--mesh", "host"], env=cli_env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    if cli.returncode:
        raise AssertionError(f"serve --mesh host exited {cli.returncode}: "
                             f"{cli.stderr[-2000:]}")
    cli_out = json.loads(cli.stdout.strip().splitlines()[-1])
    if cli_out["tokens"] != 8 * 16 or cli_out["completed"] != 8:
        raise AssertionError(f"serve --mesh host: {cli_out}")
    log(f"  python -m repro_torch.launch.serve --arch glm4-9b --mesh host "
        f"({time.perf_counter() - t_cli:.1f} s): {cli.stdout.strip()}")
    mesh_glm4["cli"] = cli_out
    log(f"  phase peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    log(f"phase 26: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------ 27. serve hymba-1.5b on a mesh
    t0 = phase("27. serve hymba-1.5b on the (1, 1) NCCL mesh (full config, "
               "bf16, use_kernels=True)")
    torch.cuda.reset_peak_memory_stats()
    n_pre = family["hymba-1.5b"]["prefill_calls"]
    mesh_hymba = mesh_serve(
        "hymba-1.5b", dev, counters, plan_root, family["hymba-1.5b"],
        batch=4, prompt_len=1536, cache_len=2048, n_requests=8, max_new=8,
        want={"flash_attention": 32 * n_pre, "ssd_scan": 32 * n_pre})
    log(f"  phase peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    log(f"phase 27: {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------- 28-30. train the other families
    t0 = phase("28. train hymba-1.5b (full config, bf16, use_kernels=True)")
    train_hymba, train_hymba_k = train_phase(
        "hymba-1.5b", dev, counters, batch=4, seq=1536, steps=FAMILY_STEPS,
        cut="nothing cut: 1.5 B parameters at 12 B each take 18 GB; seq "
            "1536 < 2 x the window of 1024 keeps the attention off the "
            "banded path, so the window masks inside the kernel")
    log(f"phase 28: {time.perf_counter() - t0:.1f} s")

    t0 = phase("29. train seamless-m4t-medium (full config, bf16, "
               "use_kernels=True)")
    train_seamless, train_seamless_k = train_phase(
        "seamless-m4t-medium", dev, counters, batch=4, seq=1024,
        steps=FAMILY_STEPS,
        cut="nothing cut: 12 encoder and 12 decoder layers, 128 frames a "
            "row; the f32 logits of 4 x 1024 rows over the 256206-token "
            "vocab take 4.2 GB")
    log(f"phase 29: {time.perf_counter() - t0:.1f} s")

    t0 = phase("30. train deepseek-v3-671b (full width, 3 of 61 layers: "
               "the dense stack, bf16)")
    train_deepseek, _ = train_phase(
        "deepseek-v3-671b", dev, counters, batch=4, seq=1024,
        n_layers=DEEPSEEK_LAYERS, steps=FAMILY_STEPS, cut=DEEPSEEK_CUT)
    log(f"phase 30: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------- 31. the pod axis, (1, 1, 1) mesh
    t0 = phase("31. train glm4-9b on a (pod, data, model) mesh of (1, 1, 1) "
               "(full width, 4 of 40 layers, planner loss, use_kernels=True)")
    pod = pod_phase(dev, counters, train_glm4, mesh_train)
    log(f"phase 31: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------- 32. seq_shard on (1, 1)
    t0 = phase("32. seq_shard=True on the (1, 1) NCCL mesh (glm4-9b and "
               "mamba2-130m training, glm4-9b serving)")
    seq_shard = seq_shard_phase(dev, counters, plan_root, mesh_train,
                                train_mamba, serve, m_batch)
    log(f"phase 32: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------ 33. tensor_parallel=False on (1, 1)
    t0 = phase("33. tensor_parallel=False on the (1, 1) NCCL mesh (one "
               "glm4-9b step, 4 of 40 layers)")
    tp_off = tp_off_phase(dev, counters, mesh_train)
    log(f"phase 33: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------- 34. calibration
    t0 = phase("34. calibration (python -m repro_torch.calibrate: nccl on "
               "the one card, gloo on 4 CPU ranks)")
    calibration = calibration_phase(plan_root)
    log(f"phase 34: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------- 35. static contracts
    t0 = phase("35. static contracts (python -m repro_torch.analysis; each "
               "contract shape's launch under torch.profiler)")
    contracts = static_contracts_phase(dev, built)
    log(f"phase 35: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------- 36. the dry run vs the card
    t0 = phase("36. the dry run against the card (glm4-9b, 4 layers, batch "
               "4 x seq 1024, the (1, 1) mesh)")
    dryrun_card = dryrun_vs_card_phase(dev)
    log(f"phase 36: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------ 37. the full-width dry runs
    t0 = phase("37. full-width dry-run cells (glm4-9b single pod, 256 fake "
               "ranks; qwen3-moe-30b-a3b multi-pod, 512)")
    dryrun_cells = dryrun_cells_phase()
    log(f"phase 37: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------- 38. the search-throughput bench
    t0 = phase("38. the search-throughput bench (python -m "
               "repro_torch.launch.search_throughput, nine sections)")
    torch.cuda.empty_cache()
    search_bench = search_throughput_phase(plan_root)
    log(f"phase 38: {time.perf_counter() - t0:.1f} s")

    # -------------------------------------------------------- 39. the result
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:35",
        "tpu_kernel": "repro/kernels/flash_attention.py::_fa_kernel",
        "launches": launches,
        "train_launches": train_fa["flash_attention"],
        "family_train_launches": {
            "hymba-1.5b": train_hymba_k["flash_attention"],
            "seamless-m4t-medium": train_seamless_k["flash_attention"]},
        "max_abs_err": main_err,
        "max_err": main_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "library": "torch.nn.functional.scaled_dot_product_attention",
        "device_ms": fa_rec["device_ms"],
        "library_device_ms": fa_rec["library_device_ms"],
        "tile": fa_rec["tile"],
        "to_library": fa_rec["to_library"],
        "shape": fa_shape,
        "build_s": build_s["flash_attention"],
        "cases": cases,
        "family_launches": {a: family[a]["launches"]["flash_attention"]
                            for a in family},
        "planner_train_launches": mesh_train_fa["flash_attention"],
        "moe_mesh_train_launches": moe_train_fa["flash_attention"],
        "front_end_launches": {n: front[n]["launches"]["flash_attention"]
                               for n in ("serve_lm", "train_lm")},
        "family_shapes": {a: {k: r[k] for k in FAMILY_KEYS}
                          for a, r in fam_fa.items()},
        "rank_shapes": {a: {k: r[k] for k in FAMILY_KEYS}
                        for a, r in rank_fa.items()},
        "mesh_serve_launches": {
            "glm4-9b": mesh_glm4["launches"]["flash_attention"],
            "hymba-1.5b": mesh_hymba["launches"]["flash_attention"],
            "glm4-9b seq_shard": seq_shard["glm4_serve"]["launches"][
                "flash_attention"]},
        "knob_train_launches": {
            "pod (1, 1, 1)": pod["launches"]["flash_attention"],
            "seq_shard": seq_shard["glm4_train"]["launches"][
                "flash_attention"],
            "tensor_parallel=False": tp_off["launches"]["flash_attention"]},
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd.py:31",
        "tpu_kernel": "repro/kernels/ssd.py::_ssd_kernel",
        "launches": launches_ssd,
        "train_launches": train_ssd["ssd_scan"],
        "family_train_launches": {"hymba-1.5b": train_hymba_k["ssd_scan"]},
        "max_abs_err": ssd_err,
        "max_err": ssd_err,
        "ms": ssd_ms,
        "plain_ms": ssd_plain_ms,
        "bound_ms": ssd_bound_ms,
        "bound_by": ssd_bound_by,
        "library_ms": None,
        "library": "none: no single PyTorch call computes the SSD scan",
        "device_ms": ssd_recs["per_head"]["device_ms"],
        "tile": ssd_recs["per_head"]["tile"],
        "shape": ssd_recs["per_head"]["shape"],
        "group_form": {k: ssd_recs["group"][k] for k in (
            "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "tile")},
        "build_s": build_s["ssd_scan"],
        "cases": ssd_cases,
        "family_launches": {"hymba-1.5b":
                            family["hymba-1.5b"]["launches"]["ssd_scan"]},
        "family_shapes": {"hymba-1.5b": {k: h_ssd[k] for k in FAMILY_KEYS}},
        "rank_shapes": {a: {k: r[k] for k in FAMILY_KEYS}
                        for a, r in rank_ssd.items()},
        "mesh_serve_launches": {
            "hymba-1.5b": mesh_hymba["launches"]["ssd_scan"]},
        "knob_train_launches": {
            "seq_shard": seq_shard["mamba2_train"]["launches"]["ssd_scan"]},
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gemm_epilogue.cu",
        "replaces": "src/repro/kernels/gemm_softmax.py:27"
        if name == "gemm_softmax" else "src/repro/kernels/gemm_layernorm.py:26",
        "tpu_kernel": "repro/kernels/gemm_softmax.py::_kernel"
        if name == "gemm_softmax" else "repro/kernels/gemm_layernorm.py::_kernel",
        "launches": bench_launches[name],
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"],
        "library": rec["library"],
        "device_ms": rec["device_ms"],
        "library_device_ms": rec["library_device_ms"],
        "tile": rec["tile"],
        "shape": rec["shape"],
        "to_library": rec["to_library"],
        "build_s": build_s["gemm_epilogue"],
        "cases": [c for c in gemm_cases if c["kernel"] == name],
    } for name, rec in gemm_main.items()] + [{
        "name": "streamed_gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/streamed_gemm.cu",
        "replaces": "src/repro/kernels/allgather_gemm.py:70",
        "tpu_kernel": "repro/kernels/allgather_gemm.py::_kernel",
        "launches": overlap_launches["streamed_gemm"],
        "max_abs_err": sg_main["max_abs_err"],
        "ms": sg_main["ms"],
        "ms_buffers1": sg_main["ms_buffers1"],
        "speedup": sg_main["speedup"],
        "plain_ms": sg_main["plain_ms"],
        "bound_ms": sg_main["bound_ms"],
        "bound_by": sg_main["bound_by"],
        "library_ms": sg_main["library_ms"],
        "library": sg_main["library"],
        "device_ms": sg_main["device_ms"],
        "library_device_ms": sg_main["library_device_ms"],
        "tile": sg_main["tile"],
        "shape": sg_main["shape"],
        "chunks": chunks,
        "to_library": sg_main["to_library"],
        "build_s": build_s["streamed_gemm"],
        "cases": sg_cases,
    }]
    log(json.dumps({"card": smi, "serve_glm4_9b": serve,
                    "serve_mamba2_130m": mserve,
                    "train_mamba2_130m": train_mamba,
                    "train_glm4_9b_4_layers": train_glm4,
                    "serve_families": family,
                    "family_kernel_vs_plain_logits": family_paths,
                    "planner_loss": planner,
                    "train_glm4_9b_mesh_planner_loss": mesh_train,
                    "train_qwen3_moe_mesh_4_layers": moe_train,
                    "front_ends": front,
                    "serve_glm4_9b_mesh": mesh_glm4,
                    "serve_hymba_1_5b_mesh": mesh_hymba,
                    "train_hymba_1_5b": train_hymba,
                    "train_seamless_m4t_medium": train_seamless,
                    "train_deepseek_v3_3_layers": train_deepseek,
                    "train_glm4_9b_pod_mesh": pod,
                    "seq_shard": seq_shard,
                    "train_glm4_9b_tensor_parallel_off": tp_off,
                    "calibration": calibration,
                    "static_contracts": contracts,
                    "dryrun_vs_card": dryrun_card,
                    "dryrun_cells": dryrun_cells,
                    "search_throughput": search_bench,
                    "kernel_bench": bench["records"],
                    "overlap_bench": overlap}))
    log(json.dumps({"kernels": kernels}))
    plan_dir.cleanup()
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
