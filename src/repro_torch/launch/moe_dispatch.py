"""MoE expert-parallel dispatch strategies, costed with COMET's collective
model (the AllToAll entry of Fig. 1(b)) — now per hardware preset and
with the compute-collective ``overlap`` axis applied.

Two EP designs for (tokens T over dp axis, E experts over the P-way model
axis, top-k routing), per layer:

* **replicated-EP** (what the framework ships, models/moe.py): activations
  are already replicated over `model`; each shard gathers its experts'
  tokens locally and the combine is one AllReduce of the (T_local, d)
  output over `model`.  Collective volume per layer: AR(T_l·d).
* **a2a-EP** (classic GShard/DeepSpeed): tokens sequence-sharded over
  `model`; dispatch AllToAll (T_l/P·k copies out), expert compute,
  combine AllToAll back.  Volume: 2·A2A(T_l·k/P·d) — but the residual
  stream must also be resharded (AG per layer) unless the whole block is
  sequence-parallel.

Both strategies are charged twice: **serial** (``overlap=0``, the
pre-overlap model, every collective fully exposed) and
**overlap-adjusted** (``overlapped_collective_seconds`` with the expert
GEMM as the adjacent compute window — a2a-EP's dispatch/combine can hide
under expert compute; replicated-EP's single AllReduce has the same
window).  The crossover can *move* under overlap — a2a-EP's volume
advantage only matters for the exposed share — which is exactly the kind
of mapping decision COMET's explicit representation makes costable
before committing an implementation.

All collective charging goes through the shared ``collective_seconds`` /
``overlapped_collective_seconds`` entry points (``core/collectives.py``)
— no hand-rolled latency math (the pre-refactor ``_lat`` helper is
pinned bit-identical to ``collective_seconds`` in
the JAX package's ``tests/test_collective_table.py``).

Port of ``benchmarks/moe_dispatch.py`` on the port's collective model
and presets, which add ``h100`` (a single-node cluster: no EP collective
to cost).  ``--calibrated PATH`` hands PATH to the presets' ``calibrated=``,
which load a persisted ``calibrated_noc.json`` (``python -m
repro_torch.calibrate``) through ``repro_torch.calibrate.persist``; a path
that holds no usable calibration leaves the presets' constants as they
are.  A bare ``--calibrated`` passes ``True`` and raises ``TypeError``, as
the original does (ROADMAP C.17).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.moe_dispatch \
        [--preset tpu_v5e] [--overlap 1.0] [--calibrated [STORE]]
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

from repro_torch.core.collectives import (collective_seconds,
                                    overlapped_collective_seconds)
from repro_torch.core.hardware import PRESETS

# (config name, d_model, top_k, moe_d_ff, T_local at train_4k dp scale)
CASES = [
    ("deepseek-v3-671b", 7168, 8, 2048, 65536),
    ("qwen3-moe-30b-a3b", 2048, 8, 768, 65536),
]


def _expert_gemm_seconds(arch, d: int, k: int, d_ff: int, t_l: int) -> float:
    """Per-layer expert compute across the cluster: every routed copy of
    every token runs the gated FFN (wi, wg, wo — 3 GEMMs, 2·d·d_ff MACs
    each); the cluster's peak absorbs the P-way expert parallelism."""
    flops = t_l * k * 3 * 2.0 * d * d_ff
    return flops / arch.peak_flops_total()


def _strategy_seconds(noc, P: int, d: int, k: int, t_l: int, *,
                      overlap: float, compute_s: float) -> Dict[str, float]:
    """Per-layer collective seconds of both EP designs at ``overlap``."""
    rep = overlapped_collective_seconds(
        "AllReduce", t_l * d * 2, P, noc,
        overlap=overlap, compute_seconds=compute_s)
    a2a = (2 * overlapped_collective_seconds(
        "AllToAll", (t_l // P) * k * d * 2, P, noc,
        overlap=overlap, compute_seconds=compute_s)
        + overlapped_collective_seconds(
            "AllGather", t_l * d * 2, P, noc,
            overlap=overlap, compute_seconds=compute_s))
    return {"replicated": rep, "a2a": a2a}


def run_all(presets=None, *, overlap: float = 1.0,
            calibrated: Optional[str] = None) -> Dict:
    """Cost both EP strategies per preset, serial and overlap-adjusted.

    ``overlap`` is the achievable overlap factor used for the adjusted
    numbers (1.0 = everything hideable hides — the optimistic bound; a
    calibrated value from the calibration loop's overlap fit (``calibrate/overlap.py``) is the honest
    choice).  ``calibrated`` forwards to the preset constructors, so the
    collective model runs on measured-and-fitted NoC constants.
    """
    out = {}
    for preset in (presets or sorted(PRESETS)):
        arch = PRESETS[preset](calibrated=calibrated)
        noc = arch.cluster_noc
        P = noc.num_nodes
        if P <= 1:
            print(f"moe_dispatch[{preset}]: single-node cluster, "
                  f"no EP collectives to cost")
            continue
        out[preset] = {}
        for name, d, k, d_ff, t_l in CASES:
            comp = _expert_gemm_seconds(arch, d, k, d_ff, t_l)
            serial = _strategy_seconds(noc, P, d, k, t_l,
                                       overlap=0.0, compute_s=comp)
            adj = _strategy_seconds(noc, P, d, k, t_l,
                                    overlap=overlap, compute_s=comp)
            best_serial = min(serial, key=serial.get)
            best_adj = min(adj, key=adj.get)
            print(f"moe_dispatch_{preset}_{name},"
                  f"{serial['replicated'] * 1e6:.0f},"
                  f"P={P};replicated={serial['replicated'] * 1e3:.2f}ms;"
                  f"a2a={serial['a2a'] * 1e3:.2f}ms;best={best_serial};"
                  f"ov{overlap:g}:replicated={adj['replicated'] * 1e3:.2f}ms;"
                  f"a2a={adj['a2a'] * 1e3:.2f}ms;best={best_adj}")
            out[preset][name] = {
                "participants": P,
                "expert_gemm_ms": comp * 1e3,
                "serial": {s: t * 1e3 for s, t in serial.items()},
                "overlap_adjusted": {s: t * 1e3 for s, t in adj.items()},
                "overlap": overlap,
                "best_serial": best_serial,
                "best_overlap_adjusted": best_adj,
            }
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None,
                    help="cost one preset (default: all)")
    ap.add_argument("--overlap", type=float, default=1.0,
                    help="achievable overlap factor for the adjusted "
                         "numbers (default 1.0, the optimistic bound)")
    ap.add_argument("--calibrated", nargs="?", const=True, default=None,
                    metavar="STORE",
                    help="use calibrated NoC constants from STORE "
                         "(default store root when given bare)")
    args = ap.parse_args()
    if not 0.0 <= args.overlap <= 1.0:
        ap.error("--overlap must lie in [0, 1]")
    run_all([args.preset] if args.preset else None,
            overlap=args.overlap, calibrated=args.calibrated)


if __name__ == "__main__":
    main()
