"""Kernel benchmark: every hand-written kernel of the port, timed on the card.

Port of ``benchmarks/kernel_bench.py``.  On the card each kernel is timed
with CUDA events against the least time the H100 could take for the same
work (its bound: the larger of the compulsory bytes over the memory rate
and the operations over the peak rate of their type), its plain PyTorch
version, and one PyTorch library call computing the same function where
there is one (a yardstick the port never calls):

- FlashAttention at glm4-9b's serving prefill shape, library
  ``F.scaled_dot_product_attention``;
- the SSD chunk scan at mamba2-130m's serving prefill shape (no library
  call computes it);
- the fused GEMM epilogues (``ops.fused_gemm_softmax``,
  ``fused_gemm_layernorm``, ``fused_gemm_rmsnorm``) at the paper's shapes
  in bf16: the six cloud GEMMs of Table II and the two large shapes of the
  plan path's kernel shapes.  Their library is the unfused pair the paper
  compares against, ``torch.matmul`` and then ``torch.softmax``,
  ``F.layer_norm`` or ``F.rms_norm``, with C written to device memory
  between them.

Each line gives the kernel's ms, the bound ms and what sets it, the plain
ms, the library ms, the kernel-to-library ratio and the kernel's fixed
tile (for the fused GEMMs: 16 rows and the cluster size chosen from N; the
plan-chosen tile is later work).  On the CPU (``device="cpu"``, for tests
at small shapes) the wrappers take their plain versions and no time is
measured: every time is ``None`` ("not measured").

    PYTHONPATH=src python -m repro_torch.launch.kernel_bench [--json PATH]

The timing and bound helpers here are the ones ``chip_smoke.py`` uses.
"""
from __future__ import annotations

import argparse
import json
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm_epilogue as ge
from repro_torch.kernels import ops, ssd
from repro_torch.kernels.ref import attention_ref, ssd_chunked_ref

__all__ = ["PEAK_FLOPS", "BYTES_PER_S", "PAPER_GEMM_SHAPES",
           "ATTENTION_SHAPE", "SSD_SHAPE", "cuda_ms", "bound", "nbytes",
           "visible_pairs", "attention_flops", "ssd_flops", "gemm_flops",
           "bench_attention", "bench_ssd", "bench_gemm_epilogue", "run_all",
           "main"]

# One H100 SXM at its 700 W limit (NVIDIA's data sheet, dense): bf16 on the
# tensor cores; f32 on the CUDA cores (the kernels' f32 paths use no TF32)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
BYTES_PER_S = 3.35e12                     # HBM3

# (M, N, K): Table II's cloud GEMMs (``GEMMS_CLOUD`` of
# benchmarks/paper_tables.py) and the two large GEMM-epilogue shapes of
# ``PAPER_KERNEL_SHAPES`` (repro/kernels/autotune.py)
PAPER_GEMM_SHAPES: List[Tuple[int, int, int]] = [
    (1, 16384, 128), (1, 2048, 64), (256, 4096, 128), (4, 8192, 128),
    (512, 2048, 64), (512, 4096, 128), (4096, 4096, 4096),
    (4096, 16384, 4096)]
# glm4-9b prefill attention at batch 4, prompt 1024 (q heads 32, kv 2)
ATTENTION_SHAPE = {"B": 4, "Hq": 32, "Hkv": 2, "S": 1024, "D": 128}
# mamba2-130m prefill scan at batch 8 x 24 heads, prompt 1024
SSD_SHAPE = {"BH": 192, "S": 1024, "P": 64, "N": 128}
GEMM_ENTRIES = ("gemm_softmax", "gemm_layernorm", "gemm_rmsnorm")


def cuda_ms(fn: Callable[[], object], iters: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` back-to-back calls,
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


def bound(flops: float, n_bytes: float, dtype: torch.dtype
          ) -> Tuple[float, str]:
    """(least ms the card could take, "operations" or "bytes"): the larger
    of ``flops`` at the peak rate of ``dtype`` and ``n_bytes`` at the
    memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], n_bytes / BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def visible_pairs(Sq: int, Skv: int, causal: bool,
                  window: Optional[int]) -> int:
    """(q, k) pairs the masks leave visible: the work this input needs."""
    q_pos = np.arange(Sq)[:, None] + (Skv - Sq)
    k_pos = np.arange(Skv)[None, :]
    mask = np.ones((Sq, Skv), bool)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    return int(mask.sum())


def attention_flops(B: int, Hq: int, D: int, Sq: int, Skv: int,
                    causal: bool, window: Optional[int] = None) -> int:
    """QK^T and PV over the visible pairs."""
    return 4 * B * Hq * D * visible_pairs(Sq, Skv, causal, window)


def ssd_flops(BH: int, S: int, P: int, N: int, chunk: int) -> int:
    """The chunked algorithm's products per chunk: C B^T and (.)X over the
    lower triangle the causal mask keeps, C h and B^T X in full."""
    tri = chunk * (chunk + 1) // 2
    return 2 * BH * (-(-S // chunk)) * (tri * (N + P) + 2 * chunk * N * P)


def gemm_flops(M: int, N: int, K: int) -> int:
    """The product; the epilogue's few operations per element of C are left
    out (at the f32 rate they add well under 1% at the paper's shapes)."""
    return 2 * M * N * K


def _timed(kernel: Callable, plain: Callable, library: Optional[Callable],
           device: torch.device, iters: int, plain_iters: int) -> Dict:
    if device.type != "cuda":
        return {"ms": None, "plain_ms": None, "library_ms": None}
    return {"ms": cuda_ms(kernel, iters),
            "plain_ms": cuda_ms(plain, plain_iters, warmup=1),
            "library_ms": cuda_ms(library, iters) if library else None}


def _finish(rec: Dict, out: torch.Tensor, want: torch.Tensor, flops: int,
            n_bytes: int, dtype: torch.dtype) -> Dict:
    diff = (out.float() - want.float()).abs()
    rec["max_abs_err"] = float(diff.max())
    rec["max_abs_plain"] = float(want.float().abs().max())
    rec["flops"], rec["bytes"] = flops, n_bytes
    rec["bound_ms"], rec["bound_by"] = bound(flops, n_bytes, dtype)
    ms, lib = rec["ms"], rec["library_ms"]
    rec["to_library"] = ms / lib if ms and lib else None
    return rec


def _counted(calls: Counter, name: str, fn: Callable) -> Callable:
    def call():
        calls[name] += 1
        return fn()
    return call


def bench_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    calls: Optional[Counter] = None) -> Dict:
    """Causal FlashAttention on q (B, Hq, S, D), k/v (B, Hkv, S, D)."""
    calls = Counter() if calls is None else calls
    kernel = _counted(calls, "flash_attention",
                      lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    plain = lambda: attention_ref(q, k, v, causal=True)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, enable_gqa=True)
    B, Hq, S, D = q.shape
    rec = {"name": "flash_attention", "shape": {
        "q": list(q.shape), "kv": list(k.shape), "dtype": str(q.dtype)[6:],
        "causal": True}, "tile": "64 q rows x 64 keys",
        "library": "torch.nn.functional.scaled_dot_product_attention"}
    out, want = kernel(), plain()
    rec.update(_timed(kernel, plain, library, q.device, 50, 5))
    return _finish(rec, out, want,
                   attention_flops(B, Hq, D, S, k.shape[2], True),
                   nbytes(q, k, v) + nbytes(q), q.dtype)


def bench_ssd(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
              Cm: torch.Tensor, *, calls: Optional[Counter] = None) -> Dict:
    """The SSD chunk scan on xdt (BH, S, P), dA (BH, S), B/C (BH, S, N)."""
    calls = Counter() if calls is None else calls
    kernel = _counted(calls, "ssd_scan",
                      lambda: ssd.ssd_scan_fwd(x, dA, Bm, Cm))
    chunk = min(ssd.CHUNK, x.shape[1])
    plain = lambda: ssd_chunked_ref(x, dA, Bm, Cm, chunk=chunk)  # noqa: E731
    BH, S, P = x.shape
    rec = {"name": "ssd_scan", "shape": {
        "xdt": [BH, S, P], "B": list(Bm.shape), "dtype": str(x.dtype)[6:],
        "chunk": chunk}, "tile": f"chunk {ssd.CHUNK} x P {min(P, 32)}",
        "library": None}
    out, want = kernel(), plain()
    rec.update(_timed(kernel, plain, None, x.device, 50, 5))
    return _finish(rec, out, want, ssd_flops(BH, S, P, Bm.shape[2], chunk),
                   nbytes(x, dA, Bm, Cm) + nbytes(x), x.dtype)


def bench_gemm_epilogue(entry: str, a: torch.Tensor, b: torch.Tensor,
                        gamma: torch.Tensor, beta: torch.Tensor, *,
                        calls: Optional[Counter] = None) -> Dict:
    """One fused GEMM entry of ``ops`` (``entry`` in ``GEMM_ENTRIES``) on a
    (M, K), b (K, N), gamma/beta (N,) f32."""
    calls = Counter() if calls is None else calls
    M, K = a.shape
    N = b.shape[1]
    g_lib, b_lib = gamma.to(a.dtype), beta.to(a.dtype)
    if entry == "gemm_softmax":
        fused = lambda k: ops.fused_gemm_softmax(  # noqa: E731
            a, b, use_kernel=k)
        library = lambda: torch.softmax(a @ b, dim=-1)  # noqa: E731
        lib_name, vecs = "torch.matmul + torch.softmax", ()
    elif entry == "gemm_layernorm":
        fused = lambda k: ops.fused_gemm_layernorm(  # noqa: E731
            a, b, gamma, beta, use_kernel=k)
        library = lambda: F.layer_norm(  # noqa: E731
            a @ b, (N,), g_lib, b_lib, 1e-6)
        lib_name, vecs = "torch.matmul + F.layer_norm", (gamma, beta)
    elif entry == "gemm_rmsnorm":
        fused = lambda k: ops.fused_gemm_rmsnorm(  # noqa: E731
            a, b, gamma, use_kernel=k)
        library = lambda: F.rms_norm(a @ b, (N,), g_lib, 1e-6)  # noqa: E731
        lib_name, vecs = "torch.matmul + F.rms_norm", (gamma,)
    else:
        raise ValueError(f"unknown entry {entry!r}; want one of "
                         f"{GEMM_ENTRIES}")
    kernel = _counted(calls, entry, lambda: fused(True))
    plain = lambda: fused(False)  # noqa: E731
    cluster = ge.cluster_size(N)
    rec = {"name": entry, "shape": {"M": M, "N": N, "K": K,
                                    "dtype": str(a.dtype)[6:]},
           "cluster": cluster,
           "tile": f"{ge.ROW_BLOCK} rows x {ge.slice_width(N, cluster)} "
                   f"columns a CTA",
           "library": lib_name}
    out, want = kernel(), plain()
    rec.update(_timed(kernel, plain, library, a.device, 20, 3))
    return _finish(rec, out, want, gemm_flops(M, N, K),
                   nbytes(a, b, *vecs) + M * N * a.element_size(), a.dtype)


def _line(rec: Dict) -> str:
    def f(x):
        return "not measured" if x is None else f"{x:.4g}"
    ratio = rec["to_library"]
    shape = ", ".join(f"{k} {v}" for k, v in rec["shape"].items())
    extra = f"  cluster {rec['cluster']}" if "cluster" in rec else ""
    return (f"{rec['name']:16s} {shape}:  ms {f(rec['ms'])}  bound_ms "
            f"{rec['bound_ms']:.4g} ({rec['bound_by']})  plain_ms "
            f"{f(rec['plain_ms'])}  library_ms {f(rec['library_ms'])}  "
            f"kernel/library {'n/a' if ratio is None else f'{ratio:.3f}'}"
            f"{extra}  tile {rec['tile']}  max_abs_err "
            f"{rec['max_abs_err']:.3e}")


def run_all(device: Optional[str] = None, *,
            gemm_shapes: Sequence[Tuple[int, int, int]] = PAPER_GEMM_SHAPES,
            attention_shape: Optional[Dict] = ATTENTION_SHAPE,
            ssd_shape: Optional[Dict] = SSD_SHAPE) -> Dict:
    """Time every kernel of the port in bf16 on data from seed 0, printing
    a line each; ``device`` is ``cuda`` unless it says ``cpu``.  A shape
    of ``None`` leaves that kernel out (``chip_smoke.py`` times
    FlashAttention and SSD in their own phases).  Returns {"device",
    "records", "calls"}: ``calls`` counts the calls this run made to each
    kernel's wrapper (on the card each is a launch)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    dtype = torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def log(rec):
        records.append(rec)
        print(_line(rec), flush=True)

    calls: Counter = Counter()
    records = []
    s = attention_shape
    if s is not None:
        q = randn(s["B"], s["S"], s["Hq"], s["D"]).to(dtype).transpose(1, 2)
        k, v = [randn(s["B"], s["S"], s["Hkv"], s["D"]).to(dtype)
                .transpose(1, 2) for _ in range(2)]   # (B, H, S, D) views
        log(bench_attention(q, k, v, calls=calls))
        del q, k, v
    s = ssd_shape
    if s is not None:
        x = randn(s["BH"], s["S"], s["P"]).to(dtype)
        dA = -torch.rand(s["BH"], s["S"], generator=gen, device=dev) * 0.2
        Bm, Cm = [randn(s["BH"], s["S"], s["N"]).to(dtype) for _ in range(2)]
        log(bench_ssd(x, dA, Bm, Cm, calls=calls))
        del x, dA, Bm, Cm
    for M, N, K in gemm_shapes:
        a = randn(M, K).to(dtype)
        b = randn(K, N, scale=K ** -0.5).to(dtype)
        gamma, beta = 1 + 0.1 * randn(N), 0.1 * randn(N)
        for entry in GEMM_ENTRIES:
            log(bench_gemm_epilogue(entry, a, b, gamma, beta, calls=calls))
        del a, b
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return {"device": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else "cpu",
            "records": records, "calls": dict(calls)}


def main(argv: Optional[List[str]] = None) -> Dict:
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
    return out


if __name__ == "__main__":
    main()
