"""Kernel benchmark: every hand-written kernel of the port, timed on the card.

Port of ``benchmarks/kernel_bench.py``.  On the card each kernel is timed
with CUDA events against the least time the H100 could take for the same
work (its bound: the larger of the compulsory bytes over the memory rate
and the operations over the peak rate of their type), its plain PyTorch
version, and one PyTorch library call computing the same function where
there is one (a yardstick the port never calls):

- FlashAttention at glm4-9b's serving prefill shape, library
  ``F.scaled_dot_product_attention`` (``--attention-sweep``: at the shapes
  of ``ATTENTION_SWEEP`` around it instead);
- the SSD chunk scan at mamba2-130m's serving prefill shape, with B and C
  one row a head (``SSD_SHAPE``) and in mamba2's own group form, one group
  of 24 heads, as views of the conv output (``SSD_GROUP_SHAPE``); no
  library call computes it (``--ssd-sweep``: the SSD scan alone, at both
  forms);
- the fused GEMM epilogues (``ops.fused_gemm_softmax``,
  ``fused_gemm_layernorm``, ``fused_gemm_rmsnorm``) at the paper's shapes
  in bf16: the six cloud GEMMs of Table II and the two large shapes of the
  plan path's kernel shapes.  Their library is the unfused pair the paper
  compares against, ``torch.matmul`` and then ``torch.softmax``,
  ``F.layer_norm`` or ``F.rms_norm``, with C written to device memory
  between them;
- the streamed GEMM (``allgather_gemm.streamed_gemm``) at glm4-9b's MLP
  input projection at the serving prefill, bf16, ``chunks=4``, in both
  buffer modes; library ``torch.matmul``.

Each line gives the kernel's ms, the bound ms and what sets it, the plain
ms, the library ms, the kernel-to-library ratio and the kernel's fixed
tile (FlashAttention: ``flash_attention.tiling``; the fused GEMMs:
``gemm_epilogue.tiling`` of N; the plan-chosen tile is later work).
FlashAttention, the SSD scan, the fused GEMMs and the streamed GEMM also
get device-only times from ``torch.profiler`` (``device_ms``: the kernel;
``library_device_ms``: every kernel of the library call, summed), which
leave out the host's cost of issuing a call, and the bytes they move
through L2 (``attention_l2_bytes``, ``gemm_l2_bytes``,
``streamed_l2_bytes``).  On
the CPU (``device="cpu"``, for tests at small shapes) the wrappers take
their plain versions and no time is measured: every time is ``None``
("not measured").

    PYTHONPATH=src python -m repro_torch.launch.kernel_bench [--json PATH]
        [--attention-sweep | --ssd-sweep]

The timing and bound helpers here are the ones ``chip_smoke.py`` uses.
"""
from __future__ import annotations

import argparse
import functools
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
from repro_torch.kernels.allgather_gemm import (CLUSTER, TILES,
                                                streamed_gemm, tolerance)
from repro_torch.kernels.ref import (attention_ref, ssd_chunked_ref,
                                     streamed_gemm_ref)

__all__ = ["PEAK_FLOPS", "BYTES_PER_S", "PAPER_GEMM_SHAPES",
           "ATTENTION_SHAPE", "ATTENTION_SWEEP", "SSD_SHAPE", "SSD_GROUP_SHAPE",
           "SSD_SHAPES", "STREAMED_GEMM_SHAPE", "cuda_ms",
           "device_ms",
           "bound", "nbytes", "visible_pairs", "attention_flops",
           "attention_l2_bytes", "ssd_flops", "gemm_flops", "gemm_l2_bytes",
           "streamed_l2_bytes", "bench_attention",
           "bench_ssd", "ssd_inputs",
           "bench_gemm_epilogue", "bench_streamed_gemm", "run_all",
           "attention_sweep", "ssd_sweep", "main"]

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
# FlashAttention around the serve shape (B, Hq, Hkv, Sq, Skv, D, causal),
# model layout, bf16: the serve shape, the same without the causal mask,
# a long kv (the kernel's steady state), a long causal prompt, head dim 64,
# and MHA (one q head a work item)
ATTENTION_SWEEP: List[Tuple[int, int, int, int, int, int, bool]] = [
    (4, 32, 2, 1024, 1024, 128, True), (4, 32, 2, 1024, 1024, 128, False),
    (4, 32, 2, 1024, 4096, 128, False), (4, 32, 2, 4096, 4096, 128, True),
    (4, 32, 2, 1024, 1024, 64, True), (4, 32, 32, 1024, 1024, 128, True)]
# mamba2-130m prefill scan at batch 8 x 24 heads, prompt 1024: B and C one
# row a head (r 1, the JAX kernel's interface), and as the model hands them
# over: one group of 24 heads a batch row (r 24: B/C (8, 1024, 128)),
# strided views of the conv output (8, 1024, conv_dim 1792)
SSD_SHAPE = {"BH": 192, "S": 1024, "P": 64, "N": 128}
SSD_GROUP_SHAPE = {"BH": 192, "S": 1024, "P": 64, "N": 128, "r": 24,
                   "xbc": True}
SSD_SHAPES = (SSD_SHAPE, SSD_GROUP_SHAPE)
# (M, K, N, chunks): glm4-9b's MLP input projection x @ wi (d_model 4096,
# d_ff 13696) at the serving prefill of batch 4 x 1024 tokens, the
# activation sharded 4 ways along d_model as a 4-rank layer gathers it
STREAMED_GEMM_SHAPE = (4096, 4096, 13696, 4)
GEMM_ENTRIES = ("gemm_softmax", "gemm_layernorm", "gemm_rmsnorm")
# the fused kernel's instances as the profiler names them
GEMM_KERNEL_NAMES = ("ge_bf16_kernel", "ge_f32_kernel")
# the FlashAttention kernel's instances as the profiler names them
ATTENTION_KERNEL_NAMES = ("fa_fwd_bf16", "fa_fwd_f32")
# the SSD kernel's instances as the profiler names them
SSD_KERNEL_NAMES = ("ssd_fwd_bf16", "ssd_fwd_f32")
# the streamed GEMM's bf16 and f32 instances as the profiler names them
STREAMED_KERNEL_NAMES = ("sg_bf16_kernel", "sg_fwd_kernel")


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


def attention_l2_bytes(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, D: int,
                       causal: bool, window: Optional[int],
                       dtype: torch.dtype) -> Tuple[int, int, int]:
    """(Q, K/V, O) bytes the FlashAttention kernel moves through L2 at this
    shape, with ``flash_attention.tiling``: each work item (a CTA's q tile
    of ``tiling.heads`` heads) reads its q rows once, and every K/V tile of
    its range (``flash_attention.tile_range`` over the item's rows) once
    for K and once for V, the rows past Skv not at all; every output row is
    written once.  An item whose rows see no key reads nothing in bf16 (the
    f32 kernel still reads its q rows)."""
    t = fa.tiling(B, Hq, Hkv, Sq, Skv, D, dtype)
    e = torch.empty((), dtype=dtype).element_size()
    items = B * Hq // t.heads     # work items at each q tile
    q_rows = kv_rows = 0          # rows one item of each q tile reads
    for q0 in range(0, Sq, t.rows):
        lo, hi = fa.tile_range(Sq, Skv, q0, t.rows, t.keys, causal, window)
        if lo < hi or dtype == torch.float32:
            q_rows += min(t.rows, Sq - q0) * t.heads
        kv_rows += sum(min(t.keys, Skv - j * t.keys) for j in range(lo, hi))
    return (q_rows * items * D * e, 2 * kv_rows * items * D * e,
            B * Hq * Sq * D * e)


def ssd_flops(BH: int, S: int, P: int, N: int, chunk: int) -> int:
    """The chunked algorithm's products per chunk: C B^T and (.)X over the
    lower triangle the causal mask keeps, C h and B^T X in full."""
    tri = chunk * (chunk + 1) // 2
    return 2 * BH * (-(-S // chunk)) * (tri * (N + P) + 2 * chunk * N * P)


def gemm_flops(M: int, N: int, K: int) -> int:
    """The product; the epilogue's few operations per element of C are left
    out (at the f32 rate they add well under 1% at the paper's shapes)."""
    return 2 * M * N * K


def device_ms(fn: Callable[[], object], iters: int,
              match: Optional[Tuple[str, ...]] = None) -> float:
    """Device milliseconds of ``fn`` per call: the CUDA kernels of
    ``iters`` back-to-back calls under ``torch.profiler``, summed and
    divided by ``iters``; with ``match``, only the kernels whose name
    holds one of its strings.  Unlike ``cuda_ms`` this leaves out the
    host's cost of issuing each call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.name != "Command Buffer Full"
             and (match is None or any(m in e.name for m in match)))
    return us / 1e3 / iters


def gemm_l2_bytes(M: int, N: int, K: int, dtype: torch.dtype
                  ) -> Tuple[int, int]:
    """(B, A) bytes the fused GEMM epilogue reads from L2 at (M, N, K):
    every block of ``gemm_epilogue.tiling(N, dtype).rows`` rows reads all
    of B once, and each CTA of its cluster reads the block's rows of A
    once a column pass."""
    t = ge.tiling(N, dtype)
    e = torch.empty((), dtype=dtype).element_size()
    return -(-M // t.rows) * K * N * e, M * K * e * t.cluster * t.passes


def streamed_l2_bytes(M: int, N: int, K: int, dtype: torch.dtype
                      ) -> Tuple[int, int]:
    """(X, W) bytes the streamed GEMM's tiling loads from L2 at (M, N, K)
    in ``dtype`` (``TILES``): a count of the tiling's loads, not a
    reading.  Every tile loads its rows of X and its columns of W over all
    of K, the parts past M, N or a chunk's end not at all (they arrive as
    zeros).  f32: X once per column tile, W once per row tile.  bf16: a row pair of tiles loads X's tile once between them, so X
    crosses L2 once per two column tiles, and W once per row tile, except
    the last column of an odd count, which column pairs load once per two
    row tiles."""
    bm, bn, _ = TILES[dtype]
    e = torch.empty((), dtype=dtype).element_size()
    tm, tn = -(-M // bm), -(-N // bn)     # row and column tiles
    if dtype == torch.float32:
        return tn * M * K * e, tm * K * N * e
    paired = min(N, tn // 2 * 2 * bn)     # columns of the row pairs
    return (-(-tn // 2) * M * K * e,
            (tm * paired + -(-tm // 2) * (N - paired)) * K * e)


def _timed(kernel: Callable, plain: Callable, library: Optional[Callable],
           device: torch.device, iters: int, plain_iters: int,
           kernel_match: Optional[Tuple[str, ...]] = None) -> Dict:
    """CUDA-event ms of the kernel, the plain version and the library call
    (``None`` off the card), each over ``iters`` calls after 3 warm-up
    calls.  With ``kernel_match``, ``iters`` more calls of the kernel and
    of the library, after their timed ones, run under the profiler and give
    ``device_ms`` (the kernels named by ``kernel_match``) and
    ``library_device_ms`` (every kernel of the library call); the kernel's
    call count is then 1 + 3 + 2 ``iters``."""
    if device.type != "cuda":
        rec = {"ms": None, "plain_ms": None, "library_ms": None}
        if kernel_match:
            rec.update(device_ms=None, library_device_ms=None)
        return rec
    rec = {"ms": cuda_ms(kernel, iters, 3),
           "plain_ms": cuda_ms(plain, plain_iters, warmup=1),
           "library_ms": cuda_ms(library, iters, 3) if library else None}
    if kernel_match:   # steady state: after the warm-up and timed calls
        rec.update(device_ms=device_ms(kernel, iters, kernel_match),
                   library_device_ms=device_ms(library, iters)
                   if library else None)
    return rec


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
                    causal: bool = True,
                    calls: Optional[Counter] = None) -> Dict:
    """FlashAttention on q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D).  SDPA's
    causal mask aligns q to the start of kv, the port's to its end, so a
    causal call with Sq != Skv has no library time."""
    calls = Counter() if calls is None else calls
    kernel = _counted(calls, "flash_attention",
                      lambda: fa.flash_attention_fwd(q, k, v, causal=causal))
    plain = lambda: attention_ref(q, k, v, causal=causal)  # noqa: E731
    library = None
    B, Hq, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if not causal or S == Skv:
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=causal, enable_gqa=True)
    t = fa.tiling(B, Hq, Hkv, S, Skv, D, q.dtype)
    rec = {"name": "flash_attention", "shape": {
        "q": list(q.shape), "kv": list(k.shape), "dtype": str(q.dtype)[6:],
        "causal": causal}, "tiling": t._asdict(),
        "tile": f"{t.q_rows} q rows x {t.keys} keys a consumer, {t.heads} "
                f"head{'s' if t.heads > 1 else ''} a work item, "
                f"{t.stages} stages, {t.items} items on {t.grid[0]} CTAs",
        "library": "torch.nn.functional.scaled_dot_product_attention"
        if library else None}
    rec["l2_bytes_q"], rec["l2_bytes_kv"], rec["l2_bytes_o"] = \
        attention_l2_bytes(B, Hq, Hkv, S, Skv, D, causal, None, q.dtype)
    out, want = kernel(), plain()
    rec.update(_timed(kernel, plain, library, q.device, 50, 5,
                      kernel_match=ATTENTION_KERNEL_NAMES))
    return _finish(rec, out, want,
                   attention_flops(B, Hq, D, S, Skv, causal),
                   nbytes(q, k, v) + nbytes(q), q.dtype)


def bench_ssd(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
              Cm: torch.Tensor, *, calls: Optional[Counter] = None,
              chunk: int = ssd.CHUNK) -> Dict:
    """The SSD chunk scan on xdt (BH, S, P), dA (BH, S), B/C (BH/r, S, N)
    at ``chunk`` (the kernel's 64 by default).  The bound counts the bytes
    this input form reads: B and C once a group row."""
    calls = Counter() if calls is None else calls
    chunk = min(chunk, x.shape[1])
    kernel = _counted(calls, "ssd_scan",
                      lambda: ssd.ssd_scan_fwd(x, dA, Bm, Cm, chunk=chunk))
    BH, S, P = x.shape
    r = BH // Bm.shape[0]
    Bh, Ch = ssd.expand_groups(Bm, r), ssd.expand_groups(Cm, r)
    plain = lambda: ssd_chunked_ref(x, dA, Bh, Ch, chunk=chunk)  # noqa: E731
    t = ssd.tiling(BH, r, S, P, Bm.shape[2], x.dtype)
    rec = {"name": "ssd_scan", "shape": {
        "xdt": [BH, S, P], "B": list(Bm.shape), "B_stride": list(Bm.stride()),
        "r": r, "dtype": str(x.dtype)[6:], "chunk": chunk},
        "tiling": t._asdict(),
        "tile": f"chunk {chunk}, one head a CTA, {t.stages} stages, "
                f"{t.units} CTAs",
        "library": None}
    out, want = kernel(), plain()
    rec.update(_timed(kernel, plain, None, x.device, 50, 5,
                      kernel_match=SSD_KERNEL_NAMES))
    return _finish(rec, out, want, ssd_flops(BH, S, P, Bm.shape[2], chunk),
                   nbytes(x, dA, Bm, Cm) + nbytes(x), x.dtype)


def ssd_inputs(gen: torch.Generator, shape: Dict, dtype: torch.dtype,
               device) -> Tuple[torch.Tensor, ...]:
    """xdt, dA (f32 < 0), B and C of ``shape`` from ``gen``: {"BH", "S",
    "P", "N"}, optionally "r" (default 1: B/C of BH / r rows) and "xbc"
    (default False: B/C contiguous; True: strided views of one (BH / r, S,
    r P + 2 N) tensor, the (x, B, C) columns of the conv output the model
    hands over, x's r heads of P first)."""
    BH, S, P, N = (shape[k] for k in ("BH", "S", "P", "N"))
    r = shape.get("r", 1)
    G = BH // r
    x = torch.randn(BH, S, P, generator=gen, device=device).to(dtype)
    dA = -torch.rand(BH, S, generator=gen, device=device) * 0.2
    if shape.get("xbc", False):
        xbc = torch.randn(G, S, r * P + 2 * N, generator=gen,
                          device=device).to(dtype)
        return x, dA, xbc[..., r * P:r * P + N], xbc[..., r * P + N:]
    Bm, Cm = [torch.randn(G, S, N, generator=gen, device=device).to(dtype)
              for _ in range(2)]
    return x, dA, Bm, Cm


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
    t = ge.tiling(N, a.dtype)
    rec = {"name": entry, "shape": {"M": M, "N": N, "K": K,
                                    "dtype": str(a.dtype)[6:]},
           "cluster": t.cluster,
           "tile": f"{t.rows} rows x {t.columns} columns a CTA in "
                   f"{t.passes} pass{'es' if t.passes > 1 else ''}, "
                   f"cluster {t.cluster}",
           "library": lib_name}
    rec["l2_bytes_b"], rec["l2_bytes_a"] = gemm_l2_bytes(M, N, K, a.dtype)
    out, want = kernel(), plain()
    rec.update(_timed(kernel, plain, library, a.device, 20, 3,
                      kernel_match=GEMM_KERNEL_NAMES))
    return _finish(rec, out, want, gemm_flops(M, N, K),
                   nbytes(a, b, *vecs) + M * N * a.element_size(), a.dtype)


def bench_streamed_gemm(x: torch.Tensor, w: torch.Tensor, *, chunks: int,
                        calls: Optional[Counter] = None) -> Dict:
    """The streamed GEMM on x (M, K), w (K, N) in both buffer modes: ``ms``
    (and ``device_ms``) with ``buffers=2``, ``ms_buffers1`` with
    ``buffers=1``, their largest difference (``buffer_agreement_err``), the
    error of ``buffers=2`` against ``streamed_gemm_ref`` with whether every
    element is within ``allgather_gemm.tolerance`` (``tol``: atol, rtol;
    ``within_tol``), and the X and W bytes its tiling reads from L2
    (``streamed_l2_bytes``)."""
    calls = Counter() if calls is None else calls
    kernel2, kernel1 = [_counted(calls, "streamed_gemm", functools.partial(
        streamed_gemm, x, w, chunks=chunks, buffers=nbuf))
        for nbuf in (2, 1)]
    plain = functools.partial(streamed_gemm_ref, x, w, chunks=chunks)
    library = functools.partial(torch.matmul, x, w)
    M, K = x.shape
    N = w.shape[1]
    bm, bn, bk = TILES[x.dtype]
    cl = CLUSTER[x.dtype]
    rec = {"name": "streamed_gemm", "shape": {
        "M": M, "K": K, "N": N, "chunks": chunks, "dtype": str(x.dtype)[6:]},
        "cluster": cl, "tile": f"{bm} x {bn}, k-tile {bk}, cluster {cl}",
        "library": "torch.matmul"}
    rec["l2_bytes_x"], rec["l2_bytes_w"] = streamed_l2_bytes(M, N, K,
                                                             x.dtype)
    out2, out1, want = kernel2(), kernel1(), plain()
    rec.update(_timed(kernel2, plain, library, x.device, 20, 3,
                      kernel_match=STREAMED_KERNEL_NAMES))
    rec["ms_buffers1"] = cuda_ms(kernel1, 20) \
        if x.device.type == "cuda" else None
    rec["buffer_agreement_err"] = float(
        (out2.float() - out1.float()).abs().max())
    want_abs = want.float().abs()
    atol, rtol = tolerance(x.dtype, float(want_abs.max()))
    rec["tol"] = [atol, rtol]
    rec["within_tol"] = bool(((out2.float() - want.float()).abs()
                              <= atol + rtol * want_abs).all())
    return _finish(rec, out2, want, gemm_flops(M, N, K),
                   nbytes(x, w) + M * N * x.element_size(), x.dtype)


def _line(rec: Dict) -> str:
    def f(x):
        return "not measured" if x is None else f"{x:.4g}"
    ratio = rec["to_library"]
    shape = ", ".join(f"{k} {v}" for k, v in rec["shape"].items())
    extra = f"  cluster {rec['cluster']}" if "cluster" in rec else ""
    if "l2_bytes_x" in rec:
        extra += (f"  l2_bytes x {rec['l2_bytes_x'] / 1e9:.3f} GB, w "
                  f"{rec['l2_bytes_w'] / 1e9:.3f} GB")
    if "device_ms" in rec:
        extra += (f"  device_ms {f(rec['device_ms'])}  library_device_ms "
                  f"{f(rec['library_device_ms'])}")
    if "ms_buffers1" in rec:
        extra += (f"  ms_buffers1 {f(rec['ms_buffers1'])}  buffer_agreement"
                  f"_err {rec['buffer_agreement_err']:.3e}")
    return (f"{rec['name']:16s} {shape}:  ms {f(rec['ms'])}  bound_ms "
            f"{rec['bound_ms']:.4g} ({rec['bound_by']})  plain_ms "
            f"{f(rec['plain_ms'])}  library_ms {f(rec['library_ms'])}  "
            f"kernel/library {'n/a' if ratio is None else f'{ratio:.3f}'}"
            f"{extra}  tile {rec['tile']}  max_abs_err "
            f"{rec['max_abs_err']:.3e}")


def run_all(device: Optional[str] = None, *,
            gemm_shapes: Sequence[Tuple[int, int, int]] = PAPER_GEMM_SHAPES,
            attention_shape: Optional[Dict] = ATTENTION_SHAPE,
            ssd_shapes: Sequence[Dict] = SSD_SHAPES,
            streamed_shape: Optional[Tuple[int, int, int, int]]
            = STREAMED_GEMM_SHAPE) -> Dict:
    """Time every kernel of the port in bf16 on data from seed 0, printing
    a line each; ``device`` is ``cuda`` unless it says ``cpu``.  A shape
    of ``None`` (no SSD shapes) leaves that kernel out (``chip_smoke.py``
    times FlashAttention and SSD in their own phases, and the streamed GEMM
    through the overlap bench).  Returns {"device",
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
    for s in ssd_shapes:
        log(bench_ssd(*ssd_inputs(gen, s, dtype, dev), calls=calls))
    for M, N, K in gemm_shapes:
        a = randn(M, K).to(dtype)
        b = randn(K, N, scale=K ** -0.5).to(dtype)
        gamma, beta = 1 + 0.1 * randn(N), 0.1 * randn(N)
        for entry in GEMM_ENTRIES:
            log(bench_gemm_epilogue(entry, a, b, gamma, beta, calls=calls))
        del a, b
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if streamed_shape is not None:
        M, K, N, chunks = streamed_shape
        x = randn(M, K).to(dtype)
        w = randn(K, N, scale=K ** -0.5).to(dtype)
        log(bench_streamed_gemm(x, w, chunks=chunks, calls=calls))
        del x, w
    return {"device": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else "cpu",
            "records": records, "calls": dict(calls)}


def attention_sweep(device: Optional[str] = None,
                    shapes: Sequence[Tuple[int, int, int, int, int, int, bool]]
                    = tuple(ATTENTION_SWEEP)) -> Dict:
    """``bench_attention`` at each of ``shapes`` in bf16, q/k/v as (B, H,
    S, D) views of (B, S, H, D) tensors from seed 0, printing a line each.
    Returns {"device", "records", "calls"} as ``run_all``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    calls: Counter = Counter()
    records = []
    for B, Hq, Hkv, Sq, Skv, D, causal in shapes:
        q, k, v = [torch.randn(B, S, H, D, generator=gen, device=dev)
                   .to(torch.bfloat16).transpose(1, 2)
                   for H, S in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv))]
        rec = bench_attention(q, k, v, causal=causal, calls=calls)
        records.append(rec)
        print(_line(rec), flush=True)
        del q, k, v
    return {"device": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else "cpu",
            "records": records, "calls": dict(calls)}


def ssd_sweep(device: Optional[str] = None,
              shapes: Sequence[Dict] = SSD_SHAPES) -> Dict:
    """``run_all`` of the SSD scan alone at ``shapes`` (both input forms by
    default)."""
    return run_all(device, gemm_shapes=(), attention_shape=None,
                   ssd_shapes=shapes, streamed_shape=None)


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions, untimed)")
    ap.add_argument("--json", default=None,
                    help="also write the records to this file")
    sweep = ap.add_mutually_exclusive_group()
    sweep.add_argument("--attention-sweep", action="store_true",
                       help="time FlashAttention at ATTENTION_SWEEP's shapes "
                            "instead of every kernel")
    sweep.add_argument("--ssd-sweep", action="store_true",
                       help="time the SSD scan alone at SSD_SHAPES (both "
                            "input forms) instead of every kernel")
    args = ap.parse_args(argv)
    out = (attention_sweep if args.attention_sweep else ssd_sweep
           if args.ssd_sweep else run_all)(args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
