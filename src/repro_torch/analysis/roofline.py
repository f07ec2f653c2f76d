"""The three roofline terms of a cell, on the H100's constants.

Port of ``HW`` and ``roofline_terms`` of ``repro/analysis/hlo.py``: the
same keys and the same overlap arithmetic.  The constants are the card's,
from one source, ``launch/kernel_bench.py``'s (``PEAK_FLOPS``,
``BYTES_PER_S``: NVIDIA's data sheet of the H100 SXM at 700 W).  The link
constant is a data-sheet figure too: NVLink 4 moves 900 GB/s a GPU over
both directions, 450e9 B/s each way.  ``link_bw=`` takes a calibration's
``channel_bandwidth`` instead (``launch/dryrun.py --calibrated``), as in
the JAX package.  Every term is a prediction from these constants, never a
time.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..launch.kernel_bench import BYTES_PER_S, PEAK_FLOPS

__all__ = ["HW", "roofline_terms"]

# H100 SXM constants (per card)
HW = {
    "peak_flops_bf16": PEAK_FLOPS[torch.bfloat16],   # FLOP/s, dense
    "hbm_bw": BYTES_PER_S,                           # B/s, HBM3
    "link_bw": 450e9,   # B/s, NVLink 4, one direction (data sheet)
}


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   wire_bytes_per_device: float,
                   link_bw: float = None,
                   overlap: float = 1.0) -> Dict[str, float]:
    """Three roofline terms in seconds (per-device quantities).

    ``link_bw`` overrides the data-sheet link bandwidth (a calibration's
    fitted channel bandwidth).  ``overlap`` in [0, 1] is the achievable
    compute-collective overlap: ``bound_serial_s`` charges the collective
    term fully exposed, ``bound_overlap_s`` hides up to ``overlap`` of it
    behind the on-chip bound; ``bottleneck`` / ``bound_s`` keep the
    max-of-three."""
    t_compute = flops_per_device / HW["peak_flops_bf16"]
    t_memory = bytes_per_device / HW["hbm_bw"]
    t_collective = wire_bytes_per_device / (link_bw if link_bw
                                            else HW["link_bw"])
    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_collective)), key=lambda kv: kv[1])[0]
    total = max(t_compute, t_memory, t_collective)
    on_chip = max(t_compute, t_memory)
    t_col_exposed = (1.0 - overlap) * t_collective
    dominant_ov = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_col_exposed)), key=lambda kv: kv[1])[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "bottleneck": dominant,
        "bound_s": total,
        "compute_fraction": t_compute / total if total > 0 else 0.0,
        "bound_serial_s": on_chip + t_collective,
        "overlap": overlap,
        "t_collective_exposed_s": t_col_exposed,
        "bound_overlap_s": on_chip + t_col_exposed,
        "bottleneck_overlap": dominant_ov,
    }
