"""Achievable compute–collective overlap fitting from concurrent sweeps.

The cost model's ``overlap`` factor (``core/cost.py``, the Eq. 5–7
extension) charges each window

    hidden = overlap * min(hideable, compute)

where ``hideable`` is the collective's Eq. 1 wire time (its Eq. 3
enqueue/router term stays exposed).  This module inverts that model
against *measured* concurrent runs: each :class:`ConcurrentPoint`
records the serial compute time, the serial collective time, and the
wall time when both are launched together.  The measured hidden time

    hidden_meas = t_compute + t_collective - t_concurrent

divided by the model's hiding capacity ``min(hideable, t_compute)``
yields a per-point achievable-overlap estimate; :func:`fit_overlap`
aggregates per collective type by the median (robust to a straggler
iteration) and clamps to [0, 1].  The result is the ``overlap`` value a
calibrated search should use instead of the optimistic 1.0 — the same
role ``fit_noc_params`` plays for the serial timing constants.

``hideable`` is computed from the *same* ``collective_overlap_terms``
decomposition the cost model charges, so the fit and the predictions
cannot drift apart (mirroring ``fitter.py``'s use of
``collective_cost``).

Degenerate sweeps (no point with positive compute, collective, and
concurrent time, or ``participants <= 1`` everywhere) return
``overlap=0.0`` with ``degenerate=True`` — never invent hiding the
hardware did not demonstrate.

Port-local copy of ``repro/calibrate/overlap.py``, held to the original by
``tests/test_torch_overlap.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.collectives import collective_overlap_terms, collective_seconds
from ..core.hardware import NoCParams

from .harness import CALIBRATED_TYPES, log_sizes

__all__ = ["ConcurrentPoint", "OverlapFit", "fit_overlap",
           "measured_hidden_fraction", "predicted_concurrent_seconds",
           "synthetic_concurrent_points"]


@dataclass(frozen=True)
class ConcurrentPoint:
    """One measured concurrent compute+collective run.

    ``compute_seconds`` and ``collective_seconds`` are the *serial*
    times of each half run alone; ``concurrent_seconds`` is the wall
    time with both in flight.  A perfectly overlapping device gives
    ``concurrent = max(compute, collective)``; a fully serializing one
    gives the sum.
    """

    col_type: str
    data_volume_bytes: int
    participants: int
    compute_seconds: float
    collective_seconds: float
    concurrent_seconds: float

    def to_json(self) -> Dict:
        return {"col_type": self.col_type,
                "data_volume_bytes": int(self.data_volume_bytes),
                "participants": int(self.participants),
                "compute_seconds": self.compute_seconds,
                "collective_seconds": self.collective_seconds,
                "concurrent_seconds": self.concurrent_seconds}

    @classmethod
    def from_json(cls, d: Dict) -> "ConcurrentPoint":
        return cls(col_type=d["col_type"],
                   data_volume_bytes=int(d["data_volume_bytes"]),
                   participants=int(d["participants"]),
                   compute_seconds=float(d["compute_seconds"]),
                   collective_seconds=float(d["collective_seconds"]),
                   concurrent_seconds=float(d["concurrent_seconds"]))


@dataclass(frozen=True)
class OverlapFit:
    """Fitted achievable overlap, overall and per collective type."""

    overlap: float                       # pooled median, in [0, 1]
    per_type: Dict[str, float]           # col_type -> achievable overlap
    n_points: int
    max_abs_err: float                   # |pred - meas|/meas on t_conc
    median_abs_err: float
    points: Tuple[ConcurrentPoint, ...]
    degenerate: bool = False

    def overlap_for(self, col_type: str) -> float:
        return self.per_type.get(col_type, self.overlap)

    def to_json(self) -> Dict:
        return {"overlap": self.overlap,
                "per_type": dict(self.per_type),
                "n_points": self.n_points,
                "max_abs_err": self.max_abs_err,
                "median_abs_err": self.median_abs_err,
                "degenerate": self.degenerate}


def _usable(p: ConcurrentPoint) -> bool:
    vals = (p.compute_seconds, p.collective_seconds, p.concurrent_seconds)
    return (p.participants > 1 and all(np.isfinite(v) and v > 0.0
                                       for v in vals))


def measured_hidden_fraction(p: ConcurrentPoint, noc: NoCParams) -> float:
    """Per-point achievable-overlap estimate: measured hidden time over
    the model's hiding capacity ``min(hideable, compute)``, clamped to
    [0, 1]."""
    hideable, _exposed = collective_overlap_terms(
        p.col_type, float(p.data_volume_bytes), p.participants, noc)
    cap = min(hideable, p.compute_seconds)
    if cap <= 0.0:
        return 0.0
    hidden = p.compute_seconds + p.collective_seconds - p.concurrent_seconds
    return float(np.clip(hidden / cap, 0.0, 1.0))


def predicted_concurrent_seconds(p: ConcurrentPoint, noc: NoCParams,
                                 overlap: float) -> float:
    """Model prediction for the concurrent wall time: serial sum minus
    the hidden share — the same charging ``core/cost.py`` applies inside
    a window, using the *measured* serial halves as the window terms."""
    hideable, _exposed = collective_overlap_terms(
        p.col_type, float(p.data_volume_bytes), p.participants, noc)
    hidden = overlap * min(hideable, p.compute_seconds)
    return p.compute_seconds + p.collective_seconds - hidden


def fit_overlap(points: Sequence[ConcurrentPoint],
                noc: NoCParams) -> OverlapFit:
    """Fit the achievable ``overlap`` factor to a concurrent sweep.

    ``noc`` must be the (calibrated) NoC the serial collective model was
    validated against — the hideable/exposed split is taken from it.
    """
    pts = tuple(p for p in points if _usable(p))
    if not pts:
        return OverlapFit(overlap=0.0, per_type={}, n_points=0,
                          max_abs_err=0.0, median_abs_err=0.0,
                          points=tuple(points), degenerate=True)

    fracs = np.array([measured_hidden_fraction(p, noc) for p in pts])
    per_type: Dict[str, float] = {}
    for col_type in sorted({p.col_type for p in pts}):
        sel = np.array([p.col_type == col_type for p in pts])
        per_type[col_type] = float(np.median(fracs[sel]))
    overall = float(np.median(fracs))

    errs = np.array([
        abs(predicted_concurrent_seconds(p, noc, per_type[p.col_type])
            - p.concurrent_seconds) / p.concurrent_seconds
        for p in pts])
    return OverlapFit(overlap=overall, per_type=per_type,
                      n_points=len(pts), max_abs_err=float(errs.max()),
                      median_abs_err=float(np.median(errs)), points=pts)


def synthetic_concurrent_points(
        noc: NoCParams, true_overlap: float, *,
        participants: int = 8,
        n_sizes: int = 6,
        compute_ratios: Sequence[float] = (0.5, 1.0, 2.0),
        col_types: Sequence[str] = CALIBRATED_TYPES,
        jitter: float = 0.0,
        seed: int = 0) -> Tuple[ConcurrentPoint, ...]:
    """Generate a concurrent sweep from known ground truth — the overlap
    analogue of ``synthetic_measure_fn``: serial halves follow Eq. 4
    under ``noc``, the concurrent time hides exactly ``true_overlap`` of
    the capacity, and ``jitter`` multiplies every timing by a seeded
    lognormal factor.  ``fit_overlap`` on the clean output must recover
    ``true_overlap`` (the recovery gate in ``tests/test_calibrate.py``).

    ``compute_ratios`` sets compute time as multiples of each point's
    serial collective time, spanning collective-bound (<1) and
    compute-bound (>1) windows so the min() in the capacity is exercised
    from both sides.
    """
    rng = np.random.default_rng(seed)
    pts = []
    for col_type in col_types:
        for dv in log_sizes(1 << 12, 1 << 24, n_sizes):
            t_col = collective_seconds(col_type, float(dv), participants,
                                       noc)
            hideable, _ = collective_overlap_terms(col_type, float(dv),
                                                   participants, noc)
            for ratio in compute_ratios:
                t_comp = ratio * t_col
                hidden = true_overlap * min(hideable, t_comp)
                t_conc = t_comp + t_col - hidden
                if jitter > 0.0:
                    t_comp *= float(rng.lognormal(0.0, jitter))
                    t_col *= float(rng.lognormal(0.0, jitter))
                    t_conc *= float(rng.lognormal(0.0, jitter))
                pts.append(ConcurrentPoint(
                    col_type=col_type, data_volume_bytes=int(dv),
                    participants=participants, compute_seconds=t_comp,
                    collective_seconds=t_col, concurrent_seconds=t_conc))
    return tuple(pts)
