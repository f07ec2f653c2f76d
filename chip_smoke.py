#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one Hopper card.

    python3 chip_smoke.py

Needs one H100 (sm_90), ``nvcc`` under ``$CUDA_HOME/bin`` or
``/usr/local/cuda/bin``, and nothing but this checkout: it imports the port
(``src/repro_torch``), never JAX or the JAX package.  Phases, in order; any
failure ends the run with a non-zero exit:

1. device: the card's name and power limit, capability (9, 0), TF32 off;
2. build: the FlashAttention kernel from ``csrc/`` into ``build/torch_kernels``;
3. the kernel against its plain version ``attention_ref`` on the card, in
   f32 (tolerance 2e-5) and bf16 (3e-2), over GQA, ragged, Sq < Skv,
   window, fully-masked-row and head-dim cases;
4. the kernel at glm4-9b's serving prefill shape: error against the plain
   version, CUDA-event times of the kernel, the plain version and
   ``F.scaled_dot_product_attention`` (a yardstick the port never calls),
   and the least time the card could take;
5. serving glm4-9b at full width and depth, bf16, random weights from seed
   0, with every layer's prefill attention through the kernel; launches are
   counted over this run alone; then one prefill and one decode step of
   that batch, timed with CUDA events and profiled (kernel time, idle
   share, top kernels);
6. continuous batching on the card (glm4 smoke config, f32, kernel on):
   a 3-slot engine equals serial 1-slot decoding, and the kernel path's
   logits equal the plain path's;
7. a JSON line of the kernels, then ``{"ok": true, ...}`` as the last line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

F32_TOL, BF16_TOL = 2e-5, 3e-2           # TOL of tests/test_kernels.py
H100_BF16_FLOPS = 989e12                 # dense bf16 tensor-core peak
H100_BYTES_PER_S = 3.35e12               # HBM3


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    log(f"== {name}")
    return time.perf_counter()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` back-to-back launches,
    timed with CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def visible_pairs(Sq, Skv, causal, window) -> int:
    """(q, k) pairs the masks leave visible: the work this input needs."""
    q_pos = np.arange(Sq)[:, None] + (Skv - Sq)
    k_pos = np.arange(Skv)[None, :]
    mask = np.ones((Sq, Skv), bool)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    return int(mask.sum())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from repro_torch import resolve_device
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Request, ServeEngine

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
    lib, build_s, build_log = _build.build("flash_attention")
    log(f"built {lib.relative_to(ROOT)} in {build_s:.1f} s "
        f"(phase {time.perf_counter() - t0:.1f} s)")
    for line in build_log.splitlines():
        if "Used" in line or "spill" in line:
            log("  ptxas: " + line.strip())

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
    B, Hq, Hkv, S, D = 4, 32, 2, 1024, 128
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
    kernel_ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True),
                        iters=50)
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v, causal=True), iters=5,
                       warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=True,
                                      enable_gqa=True), iters=50)
    flops = 4 * B * Hq * D * visible_pairs(S, S, True, None)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v)) \
        + q.numel() * q.element_size()
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"  q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal: "
        f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB")
    log(f"  max_abs_err {main_err:.3e}")
    log(f"  kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}  "
        f"library_ms {library_ms:.4f}  bound_ms {bound_ms:.4f} ({bound_by})")
    log(f"  kernel {flops / kernel_ms / 1e9:.1f} TFLOP/s, "
        f"{100 * bound_ms / kernel_ms:.1f}% of bound")
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
    prompt_len, cache_len, max_new = 1024, 2048, 16
    rng = np.random.default_rng(0)

    def requests(n, new):
        return [Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, size=prompt_len).astype(np.int32),
            max_new_tokens=new) for i in range(n)]

    def engine():
        return ServeEngine(model, params, batch_size=4, cache_len=cache_len,
                           prompt_len=prompt_len)

    engine().run(requests(4, 2))          # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng, reqs = engine(), requests(8, max_new)
    fa.flash_attention_fwd.launches = 0
    t_run = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = fa.flash_attention_fwd.launches
    n_tok = sum(len(r.output) for r in done)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  requests {len(done)}  tokens {n_tok}  wall_s {wall:.3f}  "
        f"tok_per_s {n_tok / wall:.1f}  prefill_calls "
        f"{eng.stats['prefill_calls']}  decode_steps "
        f"{eng.stats['decode_steps']}  peak_mem_gb {peak_gb:.2f}  "
        f"flash_attention_launches {launches}")
    if not all(len(r.output) == max_new and r.done for r in done):
        raise AssertionError("a request did not get all its tokens")
    if launches != cfg.n_layers * eng.stats["prefill_calls"] or launches == 0:
        raise AssertionError(f"flash_attention launched {launches} times for "
                             f"{eng.stats['prefill_calls']} prefills of "
                             f"{cfg.n_layers} layers")
    toks = torch.from_numpy(np.stack([r.prompt for r in done[:4]])).long()
    logits, cache = model.prefill(params, {"tokens": toks.to(dev)}, cache_len)
    step, _ = model.decode(params, cache, logits[:, -1].argmax(-1)[:, None])
    if not (torch.isfinite(logits).all() and torch.isfinite(step).all()):
        raise AssertionError("glm4-9b logits are not finite")
    if logits.shape != (4, 1, cfg.padded_vocab):
        raise AssertionError(f"prefill logits shape {tuple(logits.shape)}")
    # where the time goes: one prefill and one decode step of this batch,
    # timed with CUDA events, then their kernels under the profiler
    tok = logits[:, -1].argmax(-1)[:, None]
    prefill_ms = cuda_ms(lambda: model.prefill(
        params, {"tokens": toks.to(dev)}, cache_len), iters=3, warmup=1)
    decode_ms = cuda_ms(lambda: model.decode(params, cache, tok), iters=10)
    breakdown = {"prefill_ms": prefill_ms, "decode_step_ms": decode_ms}
    for name, fn, ms in (
            ("prefill", lambda: model.prefill(
                params, {"tokens": toks.to(dev)}, cache_len), prefill_ms),
            ("decode_step", lambda: model.decode(params, cache, tok),
             decode_ms)):
        busy, ranked = device_profile(fn)
        fa_ms = sum(t for n, t in ranked if "fa_fwd" in n)
        top = ranked[:6]
        breakdown[name] = {"kernel_ms": busy, "idle_share": 1 - busy / ms,
                           "flash_attention_ms": fa_ms,
                           "top_kernels": [[n[:80], t] for n, t in top]}
        log(f"  {name}: {ms:.2f} ms (CUDA events), kernels {busy:.2f} ms "
            f"(profiler), idle share {100 * (1 - busy / ms):.1f}%, "
            f"flash_attention {fa_ms:.2f} ms")
        for n, t in top:
            log(f"    {t:9.3f} ms  {n[:100]}")
    serve = {"requests": len(done), "tokens": n_tok, "wall_s": wall,
             "tok_per_s": n_tok / wall,
             "prefill_calls": eng.stats["prefill_calls"],
             "decode_steps": eng.stats["decode_steps"],
             "peak_mem_gb": peak_gb, "flash_attention_launches": launches,
             "breakdown": breakdown}
    del params, cache, logits, step, tok, eng, model
    torch.cuda.empty_cache()
    log(f"phase 5: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------- 6. continuous batching on the card
    t0 = phase("6. continuous batching (glm4 smoke, f32, use_kernels=True)")
    scfg = get_smoke_config("glm4-9b").with_(dtype="float32", use_kernels=True)
    smodel = Model(scfg)
    sparams = smodel.init(0, device=dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, scfg.vocab_size, size=12).astype(np.int32)
               for _ in range(7)]
    new_tokens = [5, 3, 4, 6, 2, 5, 3]
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, new_tokens))]
    ServeEngine(smodel, sparams, batch_size=3, cache_len=48,
                prompt_len=16).run(reqs)
    one = ServeEngine(smodel, sparams, batch_size=1, cache_len=48,
                      prompt_len=16)
    for i, (p, n) in enumerate(zip(prompts, new_tokens)):
        ref = Request(rid=100 + i, prompt=p.copy(), max_new_tokens=n)
        one.run([ref])
        if reqs[i].output != ref.output:
            raise AssertionError(f"request {i}: 3-slot {reqs[i].output} != "
                                 f"serial {ref.output}")
    toks = torch.arange(256, device=dev).reshape(2, 128) % scfg.vocab_size
    lk = smodel.logits(sparams, {"tokens": toks})
    lp = Model(scfg.with_(use_kernels=False)).logits(sparams, {"tokens": toks})
    path_err = float((lk - lp).abs().max())
    if not torch.allclose(lk, lp, atol=1e-4, rtol=1e-4):
        raise AssertionError(f"kernel path logits differ: {path_err}")
    log(f"  7 requests through 3 slots == serial decoding; kernel-path "
        f"logits vs plain path max_abs_err {path_err:.3e} (tol 1e-4)")
    log(f"phase 6: {time.perf_counter() - t0:.1f} s")

    # -------------------------------------------------------- 7. the result
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
        "shape": {"q": [B, Hq, S, D], "kv": [B, Hkv, S, D],
                  "dtype": "bfloat16", "causal": True},
        "build_s": build_s,
        "cases": cases,
    }]
    log(json.dumps({"card": smi, "serve_glm4_9b": serve}))
    log(json.dumps({"kernels": kernels}))
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
