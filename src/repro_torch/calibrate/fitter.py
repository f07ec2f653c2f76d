"""Least-squares ``NoCParams`` fitting from measured collective sweeps.

The model being inverted is exactly what the cost model charges per
collective (``collective_latency_terms``, Eqs. 1/3/4):

    t(type, DV, P) = t_router * hops(type, P)
                   + vol(type, DV, P) * (t_enq / W  +  1 / B)

where ``vol = DV * volume_factor(type, P)`` and ``hops`` come from the
same per-NoC factor tables the search engine reads (so the fit and the
predictions can never drift apart), ``W`` is the channel width and ``B``
the channel bandwidth.  Substituting x1 = t_router and
x2 = t_enq/W + 1/B makes the model **linear**:

    t_i = x1 * hops_i + x2 * vol_i

which a weighted linear least squares solves directly — weights are
1/t_i, so the fit minimizes *relative* residuals and the microsecond
latency floor counts as much as the multi-millisecond bandwidth regime
(an absolute fit would let the largest message drown the alpha term,
the standard alpha–beta fitting pitfall).

Identifiability
---------------
``t_enq`` and ``channel_bandwidth`` both multiply ``vol`` — a timing
sweep can only observe their combined per-byte cost x2, never the split
(this is inherent to alpha–beta models, not a weakness of the solver).
The fitter therefore apportions x2 using the *reference* NoC's
enqueue-vs-bandwidth ratio:

    frac  = (t_enq_ref / W) / (t_enq_ref / W + 1 / B_ref)
    t_enq = x2 * frac * W,     B = 1 / (x2 * (1 - frac))

so calibrating from a preset keeps the preset's split while matching
every measured latency exactly.  The ground-truth-recovery tests pass
the true params as the reference, which makes all three constants
recoverable; ``FitResult.identifiable`` documents the caveat in every
persisted artifact.

Degenerate sweeps (P <= 1 everywhere — e.g. a (1,1) mesh — or fewer
than two usable points) return the reference unchanged with
``degenerate=True`` rather than inventing constants from nothing.

Port-local copy of ``repro/calibrate/fitter.py`` on the port's
``core/collectives.py``; ``tests/test_torch_calibrate.py`` holds its fits
bit-equal to the original's.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.collectives import collective_cost, collective_seconds
from repro_torch.core.hardware import NoCParams

from .harness import MeasuredPoint

__all__ = ["TypeFit", "FitResult", "fit_noc_params", "predicted_seconds",
           "relative_errors"]


@dataclass(frozen=True)
class TypeFit:
    """Per-collective-type alpha–beta diagnostic fit: t = alpha * hops +
    beta * vol (same regressors as the joint fit, restricted to one
    type's points)."""

    col_type: str
    alpha_s: float               # fitted per-hop latency for this type
    beta_s_per_byte: float       # fitted per-wire-byte cost for this type
    n_points: int
    max_rel_err: float
    median_rel_err: float

    def to_json(self) -> Dict:
        return {"col_type": self.col_type, "alpha_s": self.alpha_s,
                "beta_s_per_byte": self.beta_s_per_byte,
                "n_points": self.n_points,
                "max_rel_err": self.max_rel_err,
                "median_rel_err": self.median_rel_err}


@dataclass(frozen=True)
class FitResult:
    """Fitted NoCParams + per-point residuals of one calibration."""

    params: NoCParams            # reference with fitted timing constants
    reference: NoCParams
    per_type: Tuple[TypeFit, ...]
    residuals: Tuple[float, ...]   # signed rel err per point, point order
    points: Tuple[MeasuredPoint, ...]
    max_rel_err: float
    median_rel_err: float
    degenerate: bool = False
    #: False while t_enq / channel_bandwidth are split by the reference
    #: ratio rather than separately observed (see module docstring)
    identifiable: bool = False

    @property
    def n_points(self) -> int:
        return len(self.points)


def _wls(h: np.ndarray, v: np.ndarray, t: np.ndarray,
         w: np.ndarray) -> Tuple[float, float]:
    """Non-negative weighted least squares of t ~ x1*h + x2*v (2-column
    active set: solve unconstrained; if a coefficient goes negative, pin
    it to zero and re-solve the other)."""
    A = np.stack([h, v], axis=1) * w[:, None]
    b = t * w
    x, *_ = np.linalg.lstsq(A, b, rcond=None)
    x1, x2 = float(x[0]), float(x[1])

    def solve_one(col: np.ndarray) -> float:
        denom = float(np.dot(col * w, col * w))
        if denom <= 0.0:
            return 0.0
        return max(0.0, float(np.dot(col * w, b)) / denom)

    if x1 < 0.0 and x2 < 0.0:
        return 0.0, 0.0
    if x1 < 0.0:
        return 0.0, solve_one(v)
    if x2 < 0.0:
        return solve_one(h), 0.0
    return x1, x2


def _regressors(points: Sequence[MeasuredPoint], noc: NoCParams
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(hops, wire-volume bytes, measured seconds) arrays, one row per
    point, from the same factor tables the cost model reads."""
    h = np.empty(len(points))
    v = np.empty(len(points))
    t = np.empty(len(points))
    for i, p in enumerate(points):
        cc = collective_cost(p.col_type, float(p.data_volume_bytes),
                             p.participants, noc)
        h[i] = cc.hops
        v[i] = cc.volume_bytes
        t[i] = p.seconds
    return h, v, t


def predicted_seconds(points: Sequence[MeasuredPoint],
                      noc: NoCParams) -> np.ndarray:
    """Eq. 4 prediction for each measured point under ``noc``."""
    return np.array([collective_seconds(p.col_type,
                                        float(p.data_volume_bytes),
                                        p.participants, noc)
                     for p in points])


def relative_errors(points: Sequence[MeasuredPoint],
                    noc: NoCParams) -> np.ndarray:
    """Signed (pred - measured) / measured per point."""
    pred = predicted_seconds(points, noc)
    meas = np.array([p.seconds for p in points])
    return (pred - meas) / np.where(meas > 0, meas, 1.0)


def _split_beta(x2: float, reference: NoCParams) -> Tuple[float, float]:
    """Apportion the combined per-byte cost into (t_enq, bandwidth) by
    the reference ratio; a zero x2 keeps the reference constants."""
    if x2 <= 0.0:
        return reference.t_enq, reference.channel_bandwidth
    enq = reference.t_enq / reference.channel_width
    inv_b = 1.0 / reference.channel_bandwidth
    total = enq + inv_b
    frac = (enq / total) if total > 0 else 0.0
    if frac >= 1.0:                       # reference had infinite bandwidth
        return x2 * reference.channel_width, reference.channel_bandwidth
    t_enq = x2 * frac * reference.channel_width
    bandwidth = 1.0 / (x2 * (1.0 - frac))
    return t_enq, bandwidth


def _stats(res: np.ndarray) -> Tuple[float, float]:
    if res.size == 0:
        return 0.0, 0.0
    a = np.abs(res)
    return float(a.max()), float(np.median(a))


def fit_noc_params(points: Sequence[MeasuredPoint], reference: NoCParams,
                   ) -> FitResult:
    """Fit ``(channel_bandwidth, t_router, t_enq)`` to a measured sweep.

    ``reference`` supplies everything a timing sweep cannot observe: the
    mesh geometry the hop distances are computed on (it must match the
    topology the sweep ran over), the channel width, the hop energy, and
    the enqueue-vs-bandwidth split of the per-byte cost.  Points with
    ``participants <= 1`` contribute nothing (the model predicts exactly
    zero) and are excluded; if nothing usable remains the reference is
    returned unchanged with ``degenerate=True``.
    """
    pts = tuple(p for p in points
                if p.participants > 1 and p.seconds > 0.0
                and np.isfinite(p.seconds))
    if len(pts) < 2:
        return FitResult(params=reference, reference=reference,
                         per_type=(), residuals=(), points=tuple(points),
                         max_rel_err=0.0, median_rel_err=0.0,
                         degenerate=True)
    h, v, t = _regressors(pts, reference)
    usable = v > 0.0
    if usable.sum() < 2:
        return FitResult(params=reference, reference=reference,
                         per_type=(), residuals=(), points=tuple(points),
                         max_rel_err=0.0, median_rel_err=0.0,
                         degenerate=True)
    w = 1.0 / np.where(t > 0, t, 1.0)
    x1, x2 = _wls(h[usable], v[usable], t[usable], w[usable])
    t_enq, bandwidth = _split_beta(x2, reference)
    fitted = replace(reference, t_router=x1, t_enq=t_enq,
                     channel_bandwidth=bandwidth)

    res = relative_errors(pts, fitted)
    max_err, med_err = _stats(res)

    per_type: List[TypeFit] = []
    for col_type in sorted({p.col_type for p in pts}):
        idx = np.array([p.col_type == col_type for p in pts])
        sel = idx & usable
        if sel.sum() < 2:
            continue
        a_t, b_t = _wls(h[sel], v[sel], t[sel], w[sel])
        pred_t = a_t * h[sel] + b_t * v[sel]
        res_t = (pred_t - t[sel]) / t[sel]
        mx, md = _stats(res_t)
        per_type.append(TypeFit(col_type, a_t, b_t, int(sel.sum()), mx, md))

    return FitResult(params=fitted, reference=reference,
                     per_type=tuple(per_type),
                     residuals=tuple(float(r) for r in res),
                     points=pts, max_rel_err=max_err,
                     median_rel_err=med_err)
