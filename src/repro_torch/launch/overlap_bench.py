"""Compute-collective overlap bench: the streamed GEMM's two buffer modes,
the hidden fraction of an all-gather under a GEMM, and the overlap fit.

Port of ``benchmarks/overlap_bench.py``.  Four measurements:

- ``check_allgather_gemm``: the ``torch.distributed`` entry
  ``allgather_gemm`` (gather over the group, then the kernel with one chunk
  per rank) against its unfused oracle ``allgather_gemm_reference``.
- ``measure_double_buffer``: the streamed GEMM with ``buffers=2`` (the next
  k-tiles loaded under the current one's products) against ``buffers=1``
  (load, wait, compute), timed with CUDA events through
  ``kernel_bench.bench_streamed_gemm``: each time (``buffers=2`` also
  device-only, from ``torch.profiler``), their ratio t1/t2 (the JAX
  bench's ``speedup``), the largest difference between the two modes, the
  bound, the plain version's time and ``torch.matmul``'s (a yardstick the
  port never calls).  At ``BUDGET_SHAPES`` in f32, the JAX bench's
  scale, and at glm4-9b's MLP input projection at the serving prefill in
  bf16 (``kernel_bench.STREAMED_GEMM_SHAPE``).
- ``measure_hidden_fraction``: an all-gather over the group and the
  port's GEMM timed alone and together (best of ``iters`` by the host
  clock after a synchronise), with the JAX bench's formula

      hidden fraction = clamp((t_gather + t_gemm - t_conc)
                              / min(t_gather, t_gemm), 0, 1).

  With one rank (``participants <= 1``) nothing is gathered: that is the
  case ``calibrate.overlap.fit_overlap`` treats as degenerate, and the
  record says ``degenerate: true`` with no times and no fraction.  On one
  card this is always so; four cards are needed for a figure.  On the CPU
  (gloo) the ranks share the host's cores, so a fraction read there says
  nothing of a device.
- ``synthetic_recovery``: ``fit_overlap`` recovers a known overlap from
  the synthetic concurrent sweep on the copied ``tpu_v5e().cluster_noc``
  (the model's constants, not a speed).

Bars, those of ``benchmarks/search_throughput.py:763-765``: the two buffer
modes agree within ``KERNEL_AGREEMENT_TOL`` (1e-3), and the recovery is
within 0.01 (clean) and 0.10 (5% jitter).  Each kernel output is also held
to ``allgather_gemm.tolerance`` against its plain version.

    PYTHONPATH=src python -m repro_torch.launch.overlap_bench \\
        [--device cpu] [--json PATH]

runs all four inside ``mesh.host_group()`` (a one-rank NCCL group on the
card, or the world group under ``torchrun``) and exits 1 if a bar fails.
On the CPU the wrappers take their plain versions and no time is measured:
every time is ``None`` ("not measured").
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.calibrate.overlap import (fit_overlap,
                                           synthetic_concurrent_points)
from repro_torch.core.hardware import tpu_v5e
from repro_torch.kernels.allgather_gemm import (BUDGET_SHAPES,
                                                allgather_gemm,
                                                allgather_gemm_reference,
                                                streamed_gemm, tolerance)
from repro_torch.launch import kernel_bench as kb
from repro_torch.launch import mesh

__all__ = ["KERNEL_AGREEMENT_TOL", "OVERLAP_RECOVERY_TOL_CLEAN",
           "OVERLAP_RECOVERY_TOL_JITTER", "HIDDEN_SHAPE", "BENCH_SHAPES",
           "check_allgather_gemm", "measure_double_buffer",
           "measure_hidden_fraction", "synthetic_recovery", "run_all",
           "main"]

KERNEL_AGREEMENT_TOL = 1e-3        # buffers=2 vs buffers=1
OVERLAP_RECOVERY_TOL_CLEAN = 0.01  # fit_overlap on a noise-free sweep
OVERLAP_RECOVERY_TOL_JITTER = 0.10  # ... on a 5%-jittered sweep
# (M, K, N) of the JAX bench's measure_hidden_fraction
HIDDEN_SHAPE = (256, 4096, 512)
# (M, K, N, chunks, dtype) that run_all times: the full-width shape in
# bf16, then the JAX bench's BUDGET_SHAPES in f32
BENCH_SHAPES = ((*kb.STREAMED_GEMM_SHAPE, torch.bfloat16),
                *((*s, torch.float32) for s in BUDGET_SHAPES))


def _operands(M: int, K: int, N: int, dtype: torch.dtype,
              device: torch.device, seed: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M, K) standard normal and w (K, N) scaled by K^-0.5 (outputs of
    order 1), the same on every rank: numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32)
                         * np.float32(K ** -0.5))
    return x.to(device, dtype), w.to(device, dtype)


def check_allgather_gemm(group: Optional[dist.ProcessGroup], *,
                         device: torch.device, M: int, K: int, N: int,
                         dtype: torch.dtype,
                         calls: Optional[Counter] = None) -> Dict:
    """``allgather_gemm`` in both buffer modes against
    ``allgather_gemm_reference`` on this rank's column shard of one x
    (M, K), every element within ``allgather_gemm.tolerance``; K is rounded
    up to a multiple of the group's size times 8.  Every rank of ``group``
    must call it."""
    calls = Counter() if calls is None else calls
    P, rank = dist.get_world_size(group), dist.get_rank(group)
    K = -(-K // (8 * P)) * 8 * P
    x, w = _operands(M, K, N, dtype, device, seed=2)
    kc = K // P
    x_shard = x[:, rank * kc:(rank + 1) * kc].contiguous()
    want = allgather_gemm_reference(x_shard, w, group=group).float()
    atol, rtol = tolerance(dtype, float(want.abs().max()))
    errs, ok = {}, True
    for nbuf in (2, 1):
        calls["streamed_gemm"] += 1
        out = allgather_gemm(x_shard, w, group=group, buffers=nbuf)
        if out.dtype != dtype or out.shape != want.shape:
            raise AssertionError(f"allgather_gemm gave {out.dtype} "
                                 f"{tuple(out.shape)}, want {dtype} "
                                 f"{tuple(want.shape)}")
        diff = (out.float() - want).abs()
        errs[nbuf] = float(diff.max())
        ok &= bool((diff <= atol + rtol * want.abs()).all())
    return {"participants": P, "backend": dist.get_backend(group),
            "shape": {"M": M, "K": K, "N": N, "dtype": str(dtype)[6:]},
            "max_abs_err": errs[2], "max_abs_err_buffers1": errs[1],
            "max_abs_ref": float(want.abs().max()), "tol": [atol, rtol],
            "ok": ok}


def measure_double_buffer(device: torch.device,
                          shapes: Sequence[Tuple[int, int, int, int,
                                                 torch.dtype]],
                          calls: Optional[Counter] = None) -> List[Dict]:
    """``kernel_bench.bench_streamed_gemm`` at each (M, K, N, chunks,
    dtype), plus ``speedup`` = ms_buffers1 / ms and whether the record
    meets its bars (``ok``)."""
    out = []
    for i, (M, K, N, chunks, dtype) in enumerate(shapes):
        x, w = _operands(M, K, N, dtype, device, seed=1 + i)
        rec = kb.bench_streamed_gemm(x, w, chunks=chunks, calls=calls)
        t2, t1 = rec["ms"], rec["ms_buffers1"]
        rec["speedup"] = t1 / t2 if t1 and t2 else None
        rec["ok"] = rec["buffer_agreement_err"] <= KERNEL_AGREEMENT_TOL \
            and rec["within_tol"]
        out.append(rec)
        del x, w
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _best_of(fn: Callable[[], object], iters: int,
             sync: Callable[[], None]) -> float:
    """Best-of-``iters`` host seconds of ``fn()`` then ``sync()``, after one
    warm-up (jitter only ever adds time, so the minimum is the cleanest
    estimate, as in the JAX bench)."""
    fn()
    sync()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def measure_hidden_fraction(group: Optional[dist.ProcessGroup], *,
                            device: torch.device,
                            M: int = HIDDEN_SHAPE[0],
                            K: int = HIDDEN_SHAPE[1],
                            N: int = HIDDEN_SHAPE[2], iters: int = 20,
                            calls: Optional[Counter] = None) -> Dict:
    """The hidden fraction of an all-gather of x (M, K) along dim 1 over
    ``group`` under an independent (M, K) x (K, N) product by the port's
    streamed GEMM (one chunk), f32; K is rounded up to a multiple of the
    group's size times 8.  Degenerate with one rank.  Every rank of
    ``group`` must call it."""
    calls = Counter() if calls is None else calls
    P, rank = dist.get_world_size(group), dist.get_rank(group)
    K = -(-K // (8 * P)) * 8 * P
    rec = {"participants": P, "backend": dist.get_backend(group),
           "device": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu", "shape": [M, K, N]}
    if P <= 1:
        rec.update(t_gather_s=None, t_gemm_s=None, t_concurrent_s=None,
                   hidden_fraction=None, degenerate=True,
                   reason="one rank: nothing to gather (participants <= 1, "
                          "the case fit_overlap treats as degenerate)")
        return rec
    x, _ = _operands(M, K, 1, torch.float32, device, seed=0)
    a, w = _operands(M, K, N, torch.float32, device, seed=3)
    kc = K // P
    x_shard = x[:, rank * kc:(rank + 1) * kc].contiguous()
    parts = [torch.empty_like(x_shard) for _ in range(P)]

    def gather(async_op=False):
        return dist.all_gather(parts, x_shard, group=group, async_op=async_op)

    def gemm():
        calls["streamed_gemm"] += 1
        return streamed_gemm(a, w, chunks=1)

    def both():   # the gather in flight (NCCL's stream, gloo's thread)
        work = gather(async_op=True)
        gemm()
        work.wait()

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t_gather = _best_of(gather, iters, sync)
    t_gemm = _best_of(gemm, iters, sync)
    t_conc = _best_of(both, iters, sync)
    cap = min(t_gather, t_gemm)
    hidden = t_gather + t_gemm - t_conc
    rec.update(t_gather_s=t_gather, t_gemm_s=t_gemm, t_concurrent_s=t_conc,
               hidden_fraction=float(np.clip(hidden / cap, 0.0, 1.0))
               if cap > 0 else 0.0, degenerate=False)
    return rec


def synthetic_recovery(true_overlap: float = 0.6) -> Dict:
    """``fit_overlap`` must recover a known achievable overlap from a
    synthetic concurrent sweep (clean, and with 5% lognormal jitter)."""
    noc = tpu_v5e().cluster_noc
    clean = fit_overlap(synthetic_concurrent_points(noc, true_overlap), noc)
    jit_f = fit_overlap(
        synthetic_concurrent_points(noc, true_overlap, jitter=0.05, seed=3),
        noc)
    return {"true_overlap": true_overlap,
            "clean_fitted": clean.overlap,
            "clean_err": abs(clean.overlap - true_overlap),
            "clean_pred_max_err": clean.max_abs_err,
            "jittered_fitted": jit_f.overlap,
            "jittered_err": abs(jit_f.overlap - true_overlap)}


def run_all(device: Optional[str] = None, *,
            shapes: Optional[Sequence[Tuple[int, int, int, int,
                                            torch.dtype]]] = None,
            allgather_shape: Tuple[int, int, int, torch.dtype]
            = (*kb.STREAMED_GEMM_SHAPE[:3], torch.bfloat16),
            hidden_shape: Tuple[int, int, int] = HIDDEN_SHAPE,
            iters: int = 20) -> Dict:
    """All four measurements on ``device`` (``cuda`` unless it says
    ``cpu``) at ``shapes`` (``BENCH_SHAPES`` if None).  The
    distributed ones run inside ``mesh.host_group``.  Returns the records,
    ``calls`` (the calls this run made to the streamed GEMM's wrapper: on
    the card each is a launch) and ``ok`` (every bar met)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    calls: Counter = Counter()
    out: Dict = {"schema": "repro_torch/overlap_bench/v1",
                 "device": torch.cuda.get_device_name(dev)
                 if dev.type == "cuda" else "cpu"}
    group = mesh.host_group(dev)
    try:
        M, K, N, dtype = allgather_shape
        out["allgather_gemm"] = check_allgather_gemm(
            group, device=dev, M=M, K=K, N=N, dtype=dtype, calls=calls)
        M, K, N = hidden_shape
        out["fused_gather_gemm"] = measure_hidden_fraction(
            group, device=dev, M=M, K=K, N=N, iters=iters, calls=calls)
    finally:
        mesh.destroy()
    out["double_buffer"] = measure_double_buffer(
        dev, BENCH_SHAPES if shapes is None else shapes, calls)
    out["synthetic_recovery"] = syn = synthetic_recovery()
    out["calls"] = dict(calls)
    out["ok"] = (out["allgather_gemm"]["ok"]
                 and all(r["ok"] for r in out["double_buffer"])
                 and syn["clean_err"] <= OVERLAP_RECOVERY_TOL_CLEAN
                 and syn["jittered_err"] <= OVERLAP_RECOVERY_TOL_JITTER)
    _report(out)
    return out


def _report(out: Dict) -> None:
    def f(x, scale=1.0):
        return "not measured" if x is None else f"{x * scale:.4g}"
    a = out["allgather_gemm"]
    print(f"allgather_gemm {a['shape']} over {a['participants']} "
          f"{a['backend']} rank(s): max_abs_err {a['max_abs_err']:.3e} "
          f"(buffers=1 {a['max_abs_err_buffers1']:.3e})  atol "
          f"{a['tol'][0]:.3g} rtol {a['tol'][1]:.3g}"
          f"  {'ok' if a['ok'] else 'FAIL'}", flush=True)
    h = out["fused_gather_gemm"]
    if h["degenerate"]:
        print(f"hidden_fraction: degenerate ({h['reason']})", flush=True)
    else:
        print(f"gather {f(h['t_gather_s'], 1e6)} us  gemm "
              f"{f(h['t_gemm_s'], 1e6)} us  concurrent "
              f"{f(h['t_concurrent_s'], 1e6)} us  hidden_fraction "
              f"{h['hidden_fraction']:.3f} ({h['participants']} "
              f"{h['backend']} ranks on {h['device']})", flush=True)
    for r in out["double_buffer"]:
        print(f"streamed_gemm {r['shape']}: ms {f(r['ms'])} (device "
              f"{f(r['device_ms'])})  ms_buffers1 "
              f"{f(r['ms_buffers1'])}  t1/t2 {f(r['speedup'])}  bound_ms "
              f"{r['bound_ms']:.4g} ({r['bound_by']})  plain_ms "
              f"{f(r['plain_ms'])}  matmul_ms {f(r['library_ms'])}  "
              f"agreement {r['buffer_agreement_err']:.1e}  max_abs_err "
              f"{r['max_abs_err']:.3e} (atol {r['tol'][0]:.3g}, rtol "
              f"{r['tol'][1]:.3g})  "
              f"{'ok' if r['ok'] else 'FAIL'}", flush=True)
    s = out["synthetic_recovery"]
    print(f"synthetic recovery: true {s['true_overlap']:.2f}  clean "
          f"{s['clean_fitted']:.4f} (err {s['clean_err']:.2e}, bar "
          f"{OVERLAP_RECOVERY_TOL_CLEAN})  jittered {s['jittered_fitted']:.4f}"
          f" (err {s['jittered_err']:.3f}, bar "
          f"{OVERLAP_RECOVERY_TOL_JITTER})", flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions, untimed)")
    ap.add_argument("--json", default=None,
                    help="also write the records to this file")
    args = ap.parse_args(argv)
    out = run_all(args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
