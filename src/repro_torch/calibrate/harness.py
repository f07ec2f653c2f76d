"""The pieces of the calibration harness that ``calibrate/overlap.py``
needs: the collective types a real backend executes and the log-spaced
message-size sweep.

Port-local copy of those two names of ``repro/calibrate/harness.py``, held
to the original by ``tests/test_torch_overlap.py``.  The harness's measure
functions, ``run_sweep`` and the fault handling around them arrive with
calibration (ROADMAP Queue A.6), where ``jax_measure_fn`` becomes a
``torch.distributed`` measure function.
"""
from __future__ import annotations

from typing import List

__all__ = ["CALIBRATED_TYPES", "log_sizes"]

#: the four COMET collective types a real backend can execute directly
#: (Gather/Broadcast have no first-class collective; their
#: dissemination-tree factors share the AllGather exchange schedule).
CALIBRATED_TYPES = ("AllReduce", "AllGather", "ReduceScatter", "AllToAll")


def log_sizes(min_bytes: int, max_bytes: int, n: int, *,
              multiple: int = 4) -> List[int]:
    """``n`` log-spaced byte sizes in [min_bytes, max_bytes], each
    rounded to a positive multiple of ``multiple`` (element size x
    participants, so per-device shards divide evenly), deduplicated and
    ascending."""
    if n <= 0:
        return []
    if n == 1:
        targets = [float(max_bytes)]
    else:
        ratio = (max_bytes / min_bytes) ** (1.0 / (n - 1))
        targets = [min_bytes * ratio ** i for i in range(n)]
    out: List[int] = []
    for t in targets:
        size = max(1, round(t / multiple)) * multiple
        if not out or size > out[-1]:
            out.append(size)
    return out
