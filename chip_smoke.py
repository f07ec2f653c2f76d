#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one Hopper card.

    python3 chip_smoke.py

Needs one H100 (sm_90), ``nvcc`` under ``$CUDA_HOME/bin`` or
``/usr/local/cuda/bin``, and nothing but this checkout: it imports the port
(``src/repro_torch``), never JAX or the JAX package.  Phases, in order; any
failure ends the run with a non-zero exit:

1. device: the card's name and power limit, capability (9, 0), TF32 off;
2. build: the FlashAttention, SSD and fused GEMM-epilogue kernels from
   ``csrc/`` into ``build/torch_kernels``, one ``nvcc`` for each source,
   started together; registers, shared memory and spills of every
   instance, and ``cudaOccupancyMaxActiveClusters`` of every GEMM-epilogue
   instance at every cluster size (each must be > 0);
3. FlashAttention against its plain version ``attention_ref`` on the card,
   in f32 (tolerance 2e-5) and bf16 (3e-2), over GQA, ragged, Sq < Skv,
   window, fully-masked-row and head-dim cases;
4. FlashAttention at glm4-9b's serving prefill shape: error against the
   plain version, CUDA-event times of the kernel, the plain version and
   ``F.scaled_dot_product_attention`` (a yardstick the port never calls),
   and the least time the card could take;
5. serving glm4-9b at full width and depth, bf16, random weights from seed
   0, with every layer's prefill attention through the kernel; every
   kernel's launches are counted over this run alone; then one prefill and
   one decode step of that batch, timed with CUDA events and profiled
   (kernel time, idle share, top kernels);
6. continuous batching on the card (glm4 smoke config, f32, kernel on):
   a 3-slot engine equals serial 1-slot decoding, and the kernel path's
   logits equal the plain path's;
7. the SSD kernel against its plain version ``ssd_chunked_ref`` on the
   card, in f32 (2e-3, as tests/test_kernels.py) and bf16 (1e-2 of the
   output's largest magnitude), over the JAX sweep shapes, a ragged S, a
   chunk below 64, the mamba2 smoke head (P 16, N 16) and the full head
   (P 64, N 128);
8. the SSD kernel at mamba2-130m's serving prefill shape (BH 192, S 1024,
   P 64, N 128, bf16): error, CUDA-event times of the kernel and the plain
   version, and the least time the card could take (no single PyTorch
   call computes the scan, so there is no library time);
9. serving mamba2-130m at full width and depth, bf16, random weights from
   seed 0, with every layer's prefill SSD scan through the kernel:
   launches == 24 x prefill calls over this run alone; one prefill and one
   decode step timed and profiled as in phase 5;
10. continuous batching on the mamba2 smoke config (f32, kernel on), and
    its kernel-path logits against the plain path's (1e-2);
11. the fused GEMM-Softmax, GEMM-LayerNorm and GEMM-RMSNorm kernel
    against their plain versions on the card, within the bars of
    ``gemm_epilogue.tolerance`` (f32: softmax 2e-5, norms 1e-4; bf16: 1e-2
    of the output's largest magnitude): the JAX sweep shapes, ragged
    M/K/N, M 1 and M 4, every
    cluster size 1-16, a softmax row whose max sits in the last CTA's
    slice, LayerNorm rows of mean 1e3 and std about 1, and the largest
    paper shape (4096, 16384, 4096) three times;
12. the kernel benchmark (``repro_torch.launch.kernel_bench.run_all``)
    at the paper's eight GEMM shapes in bf16 (phases 4 and 8 time the
    other two kernels), with every kernel's count set to 0 just before and
    read just after: each kernel's launches equal the bench's calls to it
    (no fallback), and each output is within the bar of phase 11;
13. a JSON line of the kernels, then ``{"ok": true, ...}`` as the last line.

Timing and bound helpers are those of ``repro_torch.launch.kernel_bench``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
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
KERNEL_SOURCES = ("flash_attention", "ssd_scan", "gemm_epilogue")
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


def ssd_inputs(gen, BH, S, P, N, dtype):
    """xdt/B/C in ``dtype`` and dA f32 < 0 on the card, contiguous as the
    model hands them to the kernel."""
    x = torch.randn(BH, S, P, generator=gen, device="cuda").to(dtype)
    dA = -torch.rand(BH, S, generator=gen, device="cuda") * 0.2
    B = torch.randn(BH, S, N, generator=gen, device="cuda").to(dtype)
    C = torch.randn(BH, S, N, generator=gen, device="cuda").to(dtype)
    return x, dA, B, C


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


def gemm_check(name, a, b, gamma, beta):
    """The fused kernel of ``name`` against its plain version on the same
    inputs, both through the ``ops`` entry: (max abs error, max |plain|,
    tolerance, passed)."""
    from repro_torch.kernels import gemm_epilogue as ge
    from repro_torch.kernels import ops
    entry = {"gemm_softmax": lambda k: ops.fused_gemm_softmax(
                 a, b, use_kernel=k),
             "gemm_layernorm": lambda k: ops.fused_gemm_layernorm(
                 a, b, gamma, beta, use_kernel=k),
             "gemm_rmsnorm": lambda k: ops.fused_gemm_rmsnorm(
                 a, b, gamma, use_kernel=k)}[name]
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
    t_run = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = {k: fn.launches for k, fn in counters.items()}
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
              "breakdown": breakdown}
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
    from repro_torch.kernels.gemm_layernorm import (gemm_layernorm,
                                                     gemm_rmsnorm)
    from repro_torch.kernels.gemm_softmax import gemm_softmax
    from repro_torch.kernels.ref import attention_ref, ssd_chunked_ref
    from repro_torch.models.model import Model

    counters = {"flash_attention": fa.flash_attention_fwd,
                "ssd_scan": ssd.ssd_scan_fwd, "gemm_softmax": gemm_softmax,
                "gemm_layernorm": gemm_layernorm,
                "gemm_rmsnorm": gemm_rmsnorm}
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
    for dtype in (torch.float32, torch.bfloat16):
        for P, N in ((16, 16), (16, 32), (32, 64), (64, 128)):
            log(f"  ssd_scan {str(dtype)[6:]} P {P} N {N}: dynamic shared "
                f"memory {ssd.smem_bytes(dtype, P, N)} B")
    if ge.slice_columns() != ge.SLICE_COLUMNS:
        raise AssertionError(f"gemm_epilogue.cu holds {ge.slice_columns()} "
                             f"columns a CTA, the wrapper assumes "
                             f"{ge.SLICE_COLUMNS}")
    for dtype in (torch.float32, torch.bfloat16):
        for epi in ge.EPILOGUES:
            placed = {cl: ge.max_active_clusters(epi, dtype, cl)
                      for cl in ge.CLUSTER_SIZES}
            log(f"  gemm_epilogue {epi} {str(dtype)[6:]}: dynamic shared "
                f"memory {ge.smem_bytes(dtype)} B; max active clusters "
                + ", ".join(f"{n} of {cl}" for cl, n in placed.items()))
            if min(placed.values()) <= 0:
                raise AssertionError(f"gemm_epilogue {epi} {dtype}: a "
                                     f"cluster cannot be placed: {placed}")
    log(f"phase 2: {time.perf_counter() - t0:.1f} s")

    # ----------------------------------- 3. kernel against its plain version
    t0 = phase("3. kernel vs attention_ref")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = []
    spec = [  # name, B, Hq, Hkv, Sq, Skv, D, causal, window
        ("glm4_gqa", 2, 32, 2, 256, 256, 128, True, None),
        ("glm4_gqa_noncausal", 2, 32, 2, 256, 256, 128, False, None),
        ("ragged_100", 1, 4, 2, 100, 100, 64, True, None),
        ("sq_lt_skv", 2, 8, 2, 64, 192, 32, True, None),
        ("sq_lt_skv_noncausal", 2, 8, 2, 64, 192, 32, False, None),
        ("window_64", 1, 4, 4, 256, 256, 64, True, 64),
        ("fully_masked_rows", 1, 4, 2, 100, 40, 128, True, None),
        ("head_dim_16", 1, 4, 2, 72, 72, 16, True, None),
    ]
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for name, B, Hq, Hkv, Sq, Skv, D, causal, window in spec:
            q, k, v = attn_inputs(gen, B, Hq, Hkv, Sq, Skv, D, dtype,
                                  model_layout=name.startswith("glm4"))
            out = fa.flash_attention_fwd(q, k, v, causal=causal,
                                         window=window)
            want = attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            diff = (out.float() - want.float()).abs()
            err = float(diff.max())
            ok = bool((diff <= tol + tol * want.float().abs()).all())
            if name == "fully_masked_rows":   # rows before the first key
                ok &= bool((out[:, :, :Sq - Skv] == 0).all())
            label = f"{name}_{str(dtype)[6:]}"
            log(f"  {label:32s} max_abs_err {err:.3e}  tol {tol:g}  "
                f"{'ok' if ok else 'FAIL'}")
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
    log(f"  kernel {flops / kernel_ms / 1e9:.1f} TFLOP/s, "
        f"{100 * bound_ms / kernel_ms:.1f}% of bound")
    fa_shape = {"q": [B, Hq, S, D], "kv": [B, Hkv, S, D],
                "dtype": "bfloat16", "causal": True}
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
    serve, glm4_launches = serve_and_profile(
        "glm4-9b", model, params, dev, batch=4, prompt_len=1024,
        cache_len=2048, n_requests=8, max_new=16, counters=counters)
    launches = glm4_launches["flash_attention"]
    if launches != cfg.n_layers * serve["prefill_calls"] or launches == 0:
        raise AssertionError(f"flash_attention launched {launches} times for "
                             f"{serve['prefill_calls']} prefills of "
                             f"{cfg.n_layers} layers")
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
    ssd_spec = [  # name, BH, S, P, N, chunk
        ("jax_sweep_1", 2, 128, 16, 32, 64),
        ("jax_sweep_2", 4, 256, 32, 64, 64),
        ("jax_sweep_ragged", 1, 200, 16, 32, 64),
        ("smoke_head", 4, 96, 16, 16, 64),
        ("smoke_head_chunk8", 4, 24, 16, 16, 8),
        ("full_head", 4, 512, 64, 128, 64),
        ("full_head_ragged", 3, 100, 64, 128, 64),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for name, BH, S_, P, N, chunk in ssd_spec:
            x, dA, Bm, Cm = ssd_inputs(gen, BH, S_, P, N, dtype)
            out = ssd.ssd_scan_fwd(x, dA, Bm, Cm, chunk=chunk)
            want = ssd_chunked_ref(x, dA, Bm, Cm, chunk=min(chunk, S_))
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
            label = f"{name}_{str(dtype)[6:]}"
            log(f"  {label:28s} max_abs_err {err:.3e}  max|plain| "
                f"{scale:.2f}  tol {tol:g}  {'ok' if ok else 'FAIL'}")
            ssd_cases.append({"case": label, "max_abs_err": err,
                              "max_abs_plain": scale, "tol": tol})
            if not ok:
                raise AssertionError(f"ssd_scan disagrees with "
                                     f"ssd_chunked_ref in {label}: {err}")
    log(f"phase 7: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------- 8. SSD at the mamba2 serve shape
    t0 = phase("8. SSD kernel time at mamba2-130m prefill shape")
    mcfg = get_config("mamba2-130m").with_(use_kernels=True)
    m_batch = 8
    BH, S, P, N = m_batch * mcfg.ssm_nheads, 1024, mcfg.ssm_headdim, \
        mcfg.ssm_state
    x, dA, Bm, Cm = ssd_inputs(gen, BH, S, P, N, torch.bfloat16)
    out = ssd.ssd_scan_fwd(x, dA, Bm, Cm)
    want = ssd_chunked_ref(x, dA, Bm, Cm, chunk=ssd.CHUNK)
    torch.cuda.synchronize()
    ssd_err = float((out.float() - want.float()).abs().max())
    ssd_scale = float(want.float().abs().max())
    if ssd_err > SSD_BF16_TOL * ssd_scale:
        raise AssertionError(f"ssd_scan disagrees at the serve shape: "
                             f"{ssd_err} (max |plain| {ssd_scale})")
    del out, want
    if {"BH": BH, "S": S, "P": P, "N": N} != kb.SSD_SHAPE:
        raise AssertionError(f"the bench's SSD shape {kb.SSD_SHAPE} is not "
                             f"the serving shape")
    rec = kb.bench_ssd(x, dA, Bm, Cm)
    ssd_ms, ssd_plain_ms = rec["ms"], rec["plain_ms"]
    ssd_bound_ms, ssd_bound_by = rec["bound_ms"], rec["bound_by"]
    c = ssd.CHUNK
    log(f"  xdt {tuple(x.shape)} B/C {tuple(Bm.shape)} bf16, dA f32, chunk "
        f"{c}: {rec['flops'] / 1e9:.2f} GFLOP, {rec['bytes'] / 1e6:.1f} MB")
    log(f"  max_abs_err {ssd_err:.3e} (max |plain| {ssd_scale:.2f})")
    log(f"  kernel_ms {ssd_ms:.4f}  plain_ms {ssd_plain_ms:.4f}  "
        f"library_ms null (no single PyTorch call computes the SSD scan)  "
        f"bound_ms {ssd_bound_ms:.4f} ({ssd_bound_by})")
    log(f"  kernel {rec['bytes'] / ssd_ms / 1e6:.1f} GB/s, "
        f"{100 * ssd_bound_ms / ssd_ms:.1f}% of bound")
    ssd_shape = {"xdt": [BH, S, P], "B": [BH, S, N], "dtype": "bfloat16",
                 "chunk": c}
    del x, dA, Bm, Cm
    log(f"phase 8: {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------- 9. serve mamba2-130m
    t0 = phase("9. serve mamba2-130m (full config, bf16, use_kernels=True)")
    model = Model(mcfg)
    t_init = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    log(f"  {model.n_params() / 1e6:.1f} M params initialised on the card "
        f"in {time.perf_counter() - t_init:.1f} s")
    mserve, mamba_launches = serve_and_profile(
        "mamba2-130m", model, params, dev, batch=m_batch, prompt_len=1024,
        cache_len=2048, n_requests=16, max_new=16, counters=counters)
    launches_ssd = mamba_launches["ssd_scan"]
    if launches_ssd != mcfg.n_layers * mserve["prefill_calls"] \
            or launches_ssd == 0:
        raise AssertionError(f"ssd_scan launched {launches_ssd} times for "
                             f"{mserve['prefill_calls']} prefills of "
                             f"{mcfg.n_layers} layers")
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
        cl = ge.cluster_size(inputs[1].shape[1])
        log(f"  {name:14s} {label:36s} cluster {cl:2d}  max_abs_err "
            f"{err:.3e}  max|plain| {scale:.3g}  tol {tol:.3g}  "
            f"{'ok' if ok else 'FAIL'}")
        gemm_cases.append({"kernel": name, "case": label, "cluster": cl,
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
    bench = kb.run_all("cuda", attention_shape=None, ssd_shape=None)
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
    gemm_main = {r["name"]: r for r in bench["records"]
                 if r["name"] in GEMM_KERNELS
                 and (r["shape"]["M"], r["shape"]["N"], r["shape"]["K"])
                 == (4096, 16384, 4096)}
    if sorted(gemm_main) != sorted(GEMM_KERNELS):
        raise AssertionError(f"the bench timed {sorted(gemm_main)} at "
                             f"(4096, 16384, 4096)")
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")

    # -------------------------------------------------------- 13. the result
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
        "shape": ssd_shape,
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
        "cluster": rec["cluster"],
        "shape": rec["shape"],
        "to_library": rec["to_library"],
        "build_s": build_s["gemm_epilogue"],
        "cases": [c for c in gemm_cases if c["kernel"] == name],
    } for name, rec in gemm_main.items()]
    log(json.dumps({"card": smi, "serve_glm4_9b": serve,
                    "serve_mamba2_130m": mserve,
                    "kernel_bench": bench["records"]}))
    log(json.dumps({"kernels": kernels}))
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
