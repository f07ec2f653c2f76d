"""Where a chunk's time goes in the bf16 SSD kernel: clock stamps.

No tool that splits a kernel's time into its phases runs on the card's
machine (``ncu``, ``nsys``), so this builds a copy of ``csrc/ssd_scan.cu``
with ``clock64()`` stamps that thread 0 of every 37th CTA takes after each
phase of the chunk loop, runs it at mamba2-130m's serving shape in both
input forms (``kernel_bench.SSD_SHAPES``), and prints the mean cycles of
each phase over chunks 2..13, and of a whole chunk.  The stamped copy is
written and built under ``build/torch_kernels/`` (``_build.build``'s
``edit``) and launched through ``ssd._launch``; the kernel the port runs
is untouched.  A stamp costs a global store of thread 0, so the stamped
kernel runs a little slower than the real one.

    PYTHONPATH=src python -m repro_torch.launch.ssd_trace [--json PATH]
"""
from __future__ import annotations

import argparse
import ctypes
import json
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ssd
from repro_torch.launch import kernel_bench as kb

__all__ = ["PHASES", "stamped_source", "run", "main"]

# (the line of the chunk loop after which a stamp is taken, the phase that
# ends there); each line is looked for after the previous one
PHASES = (
    ("    if (c + 1 < nc) load_da(c + 1, da_next);", "next dA issued"),
    ("    warp_cumsum64(da[0], da[1], csw, LOG2E);", "cumsum"),
    ("    mbar_wait(&full[s], phase);", "wait for the tiles"),
    ("    fence_acc(sc);", "S = C B^T"),
    ("      split_bf16(sc[2 * k], sc[2 * k + 1], hi[k], lo[k]);",
     "mask, split"),
    ("    wgmma_commit();", "issue (S o L) X, C h"),
    ("    __syncthreads();", "decayed X"),
    ("    wgmma_commit();", "issue the state update"),
    ("    fence_regs(lo);", "wait for (S o L) X, C h"),
    ("    wgmma_wait<0>();", "store y, wait for the update"),
    ("    copy_h();  // the state before the next chunk; every read of "
     "stage s done", "copy h"),
    ("    if (t == 0 && c + ST < nc) load_b(c + ST, s);", "refill B"),
)
_LOOP = "  for (int c = 0; c < nc; ++c) {\n    const int row0"
_EVERY = 37      # stamp every 37th CTA
_CHUNKS = 16     # stamps kept for the first 16 chunks of a CTA
_STRIDE = _CHUNKS * 16


def stamped_source(text: str) -> str:
    """``ssd_scan.cu``'s text with a stamp after each line of ``PHASES``
    in the bf16 chunk loop, a ``g_trace`` pointer and a ``set_trace``
    entry; ValueError if a line is not found."""
    if _LOOP not in text:
        raise ValueError("the bf16 chunk loop is not in the source")
    head, body = text.split(_LOOP, 1)
    lines = (_LOOP + body).split("\n")
    pos = 0
    for k, (line, name) in enumerate(PHASES, start=1):
        try:
            pos = lines.index(line, pos)
        except ValueError:
            raise ValueError(f"no line for phase {name!r}: {line!r}") from None
        lines.insert(pos + 1, f"    SSD_STAMP({k});")
        pos += 2
    stamp = (f"#define SSD_STAMP(k) if (t == 0 && blockIdx.x % {_EVERY} == 0 "
             f"&& c < {_CHUNKS}) g_trace[(blockIdx.x / {_EVERY}) * {_STRIDE}"
             f" + c * 16 + (k)] = clock64();")
    head = head.replace('#include "hopper.cuh"',
                        '#include "hopper.cuh"\n__device__ long long* '
                        'g_trace;\n' + stamp + "\n//", 1)
    return (head + "\n".join(lines) + '\nextern "C" int set_trace(long long*'
            ' p) {\n  return (int)cudaMemcpyToSymbol(g_trace, &p, '
            'sizeof(p));\n}\n')


def run(device: Optional[str] = None) -> Dict:
    """Stamp, build and run the kernel at ``SSD_SHAPES``; returns
    {"device", "forms": {form: [per stamped CTA {"cta", "chunk_cycles",
    "phases": {phase: cycles}}]}} and prints a line a CTA."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the stamps are read on the card only")
    lib = ssd._library(stamped_source)
    lib.set_trace.argtypes = [ctypes.c_void_p]
    lib.set_trace.restype = ctypes.c_int
    buf = torch.zeros(_STRIDE * 16, dtype=torch.int64, device=dev)
    if lib.set_trace(buf.data_ptr()):
        raise RuntimeError("set_trace failed")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    forms = {}
    for shape in kb.SSD_SHAPES:
        form = f"r {shape.get('r', 1)}"
        args = kb.ssd_inputs(gen, shape, torch.bfloat16, dev)
        r = ssd._check(*args, ssd.CHUNK)
        for _ in range(3):
            ssd._launch(lib, *args, ssd.CHUNK, r)
        torch.cuda.synchronize()
        buf.zero_()
        ssd._launch(lib, *args, ssd.CHUNK, r)
        torch.cuda.synchronize()
        stamps = buf.view(16, _CHUNKS, 16).cpu().numpy()
        rows: List[Dict] = []
        for i in range(16):
            t = stamps[i, :, 1:len(PHASES) + 1]
            if not t[:, 0].any():
                continue
            steady = t[2:14]
            phases = np.diff(steady, axis=1).mean(0)
            rows.append({
                "cta": i * _EVERY,
                "chunk_cycles": float(np.diff(t[2:15, 0]).mean()),
                "phases": {name: float(v) for (_, name), v in
                           zip(PHASES[1:], phases)}})
            print(f"{form}  cta {i * _EVERY:3d}: a chunk "
                  f"{rows[-1]['chunk_cycles']:.0f} cycles; " + ", ".join(
                      f"{n} {v:.0f}"
                      for n, v in rows[-1]["phases"].items()), flush=True)
        forms[form] = rows
    return {"device": torch.cuda.get_device_name(dev), "forms": forms}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None,
                    help="also write the stamps' means to this file")
    args = ap.parse_args(argv)
    out = run("cuda")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
