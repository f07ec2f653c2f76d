"""Persist calibrated NoC params next to the plan store.

One JSON document, ``calibrated_noc.json``, lives in the plan-store
root (``$REPRO_PLAN_CACHE`` or ``~/.cache/repro-plans`` — the same
resolution ``repro_torch.core.plan`` uses, so a serving fleet that
shares a plan store shares its calibration).  The file carries full
provenance — measurement backend, mesh shape, participant counts, torch
version, timestamp, per-point residuals — because a calibration is only
valid for the machine it was measured on:

* **roundtrip** is bit-identical: canonical JSON (sorted keys, fixed
  indent, repr-exact floats), so re-saving a loaded calibration writes
  the same bytes and CI can gate on file equality;
* **stale provenance** (different mesh shape, backend or torch version
  than the caller expects) is *refused* with one actionable warning —
  silently applying another machine's constants is exactly the failure
  mode the calibration loop exists to remove;
* **corruption** (torn write, truncation) quarantines the file to a
  ``corrupt/`` sibling (planstore convention) with one warning and
  falls back to preset params — ``load_calibration`` returns ``None``
  and ``apply_calibration`` leaves the arch untouched;
* a fit with **non-finite residuals or params is never persisted**:
  ``save_calibration`` refuses (one warning) instead of writing a file
  that would poison every later run.

Port of ``repro/calibrate/persist.py`` with the same schema string and
canonical bytes, so a file the JAX package wrote loads here and re-saves
to the same bytes.  The port's provenance records ``torch_version``
where the JAX package's records ``jax_version``: a loader that expects a
torch version refuses a JAX-written file as stale; one that states no
expectation (``hardware.apply_calibration``) applies it.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.hardware import NoCParams

from .fitter import FitResult
from .harness import MeasuredPoint, _warn_once

__all__ = ["CALIBRATION_SCHEMA", "CALIB_FILENAME", "Calibration",
           "calibration_path", "save_calibration", "load_calibration",
           "calibration_from_fit"]

CALIBRATION_SCHEMA = "repro/calibrated-noc/v1"
CALIB_FILENAME = "calibrated_noc.json"
CORRUPT_DIRNAME = "corrupt"

#: provenance keys that must match for a persisted calibration to be
#: trusted by a loader that states its expectations
_STALE_KEYS = ("backend", "mesh", "torch_version")


@dataclass(frozen=True)
class Calibration:
    """A fitted NoCParams plus the provenance that scopes its validity."""

    params: NoCParams
    provenance: Dict             # backend, mesh, torch_version, timestamp_s…
    per_type: Tuple[Dict, ...]   # TypeFit.to_json() rows
    points: Tuple[MeasuredPoint, ...]
    residuals: Tuple[float, ...]
    max_rel_err: float
    median_rel_err: float
    identifiable: bool = False

    def to_json(self) -> Dict:
        return {
            "schema": CALIBRATION_SCHEMA,
            "provenance": dict(self.provenance),
            "params": _noc_to_json(self.params),
            "per_type": [dict(t) for t in self.per_type],
            "points": [p.to_json() for p in self.points],
            "residuals": list(self.residuals),
            "max_rel_err": self.max_rel_err,
            "median_rel_err": self.median_rel_err,
            "identifiable": self.identifiable,
        }

    @classmethod
    def from_json(cls, d: Dict) -> "Calibration":
        if d.get("schema") != CALIBRATION_SCHEMA:
            raise ValueError(f"unknown calibration schema {d.get('schema')!r}")
        return cls(
            params=_noc_from_json(d["params"]),
            provenance=dict(d["provenance"]),
            per_type=tuple(dict(t) for t in d["per_type"]),
            points=tuple(MeasuredPoint.from_json(p) for p in d["points"]),
            residuals=tuple(float(r) for r in d["residuals"]),
            max_rel_err=float(d["max_rel_err"]),
            median_rel_err=float(d["median_rel_err"]),
            identifiable=bool(d.get("identifiable", False)),
        )


def _noc_to_json(noc: NoCParams) -> Dict:
    return {"mesh": list(noc.mesh), "channel_width": noc.channel_width,
            "channel_bandwidth": noc.channel_bandwidth,
            "t_router": noc.t_router, "t_enq": noc.t_enq,
            "hop_energy_pj_per_byte": noc.hop_energy_pj_per_byte}


def _noc_from_json(d: Dict) -> NoCParams:
    return NoCParams(mesh=tuple(int(x) for x in d["mesh"]),
                     channel_width=int(d["channel_width"]),
                     channel_bandwidth=float(d["channel_bandwidth"]),
                     t_router=float(d["t_router"]),
                     t_enq=float(d["t_enq"]),
                     hop_energy_pj_per_byte=float(
                         d["hop_energy_pj_per_byte"]))


def calibration_from_fit(fit: FitResult, *, backend: str,
                         torch_version: str,
                         now: Callable[[], float] = time.time,
                         extra: Optional[Dict] = None) -> Calibration:
    """Wrap a ``FitResult`` with the provenance that scopes it."""
    prov = {
        "backend": backend,
        "mesh": list(fit.params.mesh),
        "participants": sorted({p.participants for p in fit.points}),
        "torch_version": torch_version,
        "timestamp_s": float(now()),
        "n_points": fit.n_points,
        "degenerate": fit.degenerate,
    }
    if extra:
        prov.update(extra)
    return Calibration(params=fit.params, provenance=prov,
                       per_type=tuple(t.to_json() for t in fit.per_type),
                       points=fit.points, residuals=fit.residuals,
                       max_rel_err=fit.max_rel_err,
                       median_rel_err=fit.median_rel_err,
                       identifiable=fit.identifiable)


# ----------------------------------------------------------------- paths


def calibration_path(root: Optional[str] = None) -> Path:
    """``calibrated_noc.json`` inside the plan-store root (the same
    ``$REPRO_PLAN_CACHE`` / ``~/.cache/repro-plans`` resolution the plan
    cache uses, re-read per call like ``plan.default_cache``)."""
    if root is None:
        from repro_torch.core.plan import DEFAULT_CACHE_DIR, _ENV_VAR
        root = os.environ.get(_ENV_VAR) or DEFAULT_CACHE_DIR
    return Path(root).expanduser() / CALIB_FILENAME


# ------------------------------------------------------------ save / load


def _canonical_bytes(doc: Dict) -> bytes:
    """Sorted-key, fixed-indent JSON: float repr is exact (json uses
    ``repr``-shortest round-trip floats), so equal documents are equal
    bytes and the roundtrip is bit-identical."""
    return (json.dumps(doc, indent=2, sort_keys=True) + "\n").encode()


def _finite(x: float) -> bool:
    return x == x and abs(x) != float("inf")


def save_calibration(cal: Calibration,
                     path: Optional[Path] = None) -> Optional[Path]:
    """Atomically write ``cal`` to ``path`` (default: the store root).

    Refuses — one warning, returns ``None``, writes nothing — when any
    residual or fitted constant is non-finite: a NaN fit must never
    outlive the process that produced it.
    """
    path = Path(path) if path is not None else calibration_path()
    bad = [r for r in cal.residuals if not _finite(r)]
    p = cal.params
    if bad or not all(_finite(x) for x in
                      (p.channel_bandwidth, p.t_router, p.t_enq)):
        _warn_once(("calib-nan", str(path)),
                   f"refusing to persist calibration to {path}: "
                   f"{len(bad)} non-finite residuals / params — fix the "
                   f"measurement backend and re-run the sweep")
        return None
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".json.tmp")
    tmp.write_bytes(_canonical_bytes(cal.to_json()))
    os.replace(tmp, path)
    return path


def _quarantine(path: Path) -> None:
    qdir = path.parent / CORRUPT_DIRNAME
    try:
        qdir.mkdir(parents=True, exist_ok=True)
        os.replace(path, qdir / path.name)
    except OSError:
        pass                              # read-only media: leave in place


def load_calibration(path: Optional[Path] = None, *,
                     expect: Optional[Dict] = None) -> Optional[Calibration]:
    """Load a persisted calibration, or ``None`` when unusable.

    * missing file — ``None``, silently (never calibrated is a normal
      state);
    * unparsable / schema-mismatched file — quarantined to ``corrupt/``
      beside the store (planstore convention), one warning, ``None``;
    * ``expect`` provenance mismatch (any of ``backend`` / ``mesh`` /
      ``torch_version`` present in ``expect`` and different in the file)
      — one warning naming the drift and the recalibrate command,
      ``None``.
    """
    path = Path(path) if path is not None else calibration_path()
    try:
        raw = path.read_bytes()
    except OSError:
        return None
    try:
        cal = Calibration.from_json(json.loads(raw))
    except (ValueError, KeyError, TypeError) as e:
        _quarantine(path)
        _warn_once(("calib-corrupt", str(path)),
                   f"corrupted calibration file quarantined to "
                   f"{path.parent / CORRUPT_DIRNAME}: {e!r}; falling back "
                   f"to preset NoC params")
        return None
    if expect:
        drift: List[str] = []
        for key in _STALE_KEYS:
            if key in expect:
                want, got = expect[key], cal.provenance.get(key)
                if key == "mesh":
                    want, got = list(want), list(got or [])
                if want != got:
                    drift.append(f"{key}: file has {got!r}, "
                                 f"this run is {want!r}")
        if drift:
            _warn_once(("calib-stale", str(path)),
                       f"stale calibration at {path} refused "
                       f"({'; '.join(drift)}) — re-run "
                       f"`python -m repro_torch.calibrate` on this backend "
                       f"to recalibrate; using preset NoC params")
            return None
    return cal
