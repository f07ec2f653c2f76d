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
   see no key must be exactly 0;
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
   16-128, groups of 1-24, B/C as strided views of a conv output);
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
12. the kernel benchmark (``repro_torch.launch.kernel_bench.run_all``)
    at the paper's eight GEMM shapes in bf16 (phases 4 and 8 time the
    other two kernels), with every kernel's count set to 0 just before and
    read just after: each kernel's launches equal the bench's calls to it
    (no fallback), and each output is within the bar of phase 11; beside
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
15. a JSON line of the kernels (every number in it measured in this run,
    but ``bound_ms``, computed from this run's inputs, and ``launches``,
    counted), then ``{"ok": true, ...}`` as the last line.

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
                      cache_len, n_requests, max_new, counters, seed=0):
    """Serve ``n_requests`` random prompts through a ``batch``-slot engine
    after a warm-up run, with every kernel's count set to 0 just before and
    read just after; then time and profile one prefill and one decode step
    of that batch.  Returns the record and the launch counts."""
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = model.cfg
    rng = np.random.default_rng(seed)

    def requests(n, new):
        return [Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, size=prompt_len).astype(np.int32),
            max_new_tokens=new) for i in range(n)]

    def engine():
        return ServeEngine(model, params, batch_size=batch,
                           cache_len=cache_len, prompt_len=prompt_len)

    engine().run(requests(batch, 2))      # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng, reqs = engine(), requests(n_requests, max_new)
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "chunks"):
            fn.chunks = {}
    t_run = time.perf_counter()
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
    logits, cache = model.prefill(params, {"tokens": toks}, cache_len)
    step, _ = model.decode(params, cache, logits[:, -1].argmax(-1)[:, None])
    if not (torch.isfinite(logits).all() and torch.isfinite(step).all()):
        raise AssertionError(f"{name} logits are not finite")
    if logits.shape != (batch, 1, cfg.padded_vocab):
        raise AssertionError(f"prefill logits shape {tuple(logits.shape)}")
    # where the time goes: one prefill and one decode step of this batch,
    # timed with CUDA events, then their kernels under the profiler
    tok = logits[:, -1].argmax(-1)[:, None]

    def run_prefill():
        return model.prefill(params, {"tokens": toks}, cache_len)

    def run_decode():
        return model.decode(params, cache, tok)

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
              "launch_chunks": chunks, "breakdown": breakdown}
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

    # ------------------------------------------------ 12. the kernel bench
    t0 = phase("12. kernel bench (repro_torch.launch.kernel_bench.run_all)")
    for fn in counters.values():
        fn.launches = 0
    bench = kb.run_all("cuda", attention_shape=None, ssd_shapes=(),
                       streamed_shape=None)
    torch.cuda.synchronize()
    bench_launches = {k: fn.launches for k, fn in counters.items()}
    log(f"  launches {bench_launches}  bench calls {bench['calls']}")
    want_launches = {k: bench["calls"].get(k, 0) for k in counters}
    if bench_launches != want_launches \
            or 0 in (bench_launches[k] for k in GEMM_KERNELS):
        raise AssertionError(f"launches {bench_launches} != the bench's "
                             f"calls {bench['calls']}")
    for rec in bench["records"]:
        name = rec["name"]
        tol = ge.tolerance(name[len("gemm_"):], torch.bfloat16,
                           rec["max_abs_plain"])
        if not rec["max_abs_err"] <= tol:
            raise AssertionError(f"bench: {name} {rec['shape']} error "
                                 f"{rec['max_abs_err']} > {tol}")
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

    # -------------------------------------------------------- 15. the result
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:35",
        "tpu_kernel": "repro/kernels/flash_attention.py::_fa_kernel",
        "launches": launches,
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
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd.py:31",
        "tpu_kernel": "repro/kernels/ssd.py::_ssd_kernel",
        "launches": launches_ssd,
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
