"""One calibration pass: reuse-or-sweep, fit, gate, persist, summarize.

``calibrate_once`` is the single orchestration point behind the
``python -m repro_torch.calibrate`` CLI — it owns the reuse semantics:

* a persisted ``calibrated_noc.json`` whose provenance (backend, mesh,
  torch version) matches the requested run is **reused verbatim** — the
  summary reports ``reused: true`` and ``fits_solved: 0``, no sweep
  runs, and the file is not rewritten (so re-running is bit-identical);
* otherwise the sweep runs, the fit solves once (``fits_solved: 1``),
  and the result is persisted only when it is non-degenerate and finite
  (``save_calibration`` refuses NaN) — a degenerate fit warns and
  leaves any existing file alone;
* the **error gate** compares the fitted model's predictions against
  the very sweep it was fitted on: ``median |rel err| <= gate_median``.
  A calibration that cannot reproduce its own measurements is worse
  than the preset it would replace.

Port of ``repro/calibrate/driver.py``: the same summary keys, reuse and
gate, with ``torch_version=`` in place of ``jax_version=``.  On a group
of ranks (:func:`calibrate_group`, which the CLI runs on spawned ranks
through :func:`spawn_group`) rank 0 decides reuse once and alone calls
``calibrate_once``; the other ranks run the same ``run_sweep`` beside it.
"""
from __future__ import annotations

import datetime
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, Optional

from repro_torch.core.hardware import NoCParams

from .fitter import fit_noc_params
from .harness import (SweepConfig, _replace_mesh, _warn_once, run_sweep,
                      torch_measure_fn)
from .persist import (calibration_from_fit, calibration_path,
                      load_calibration, save_calibration)

__all__ = ["calibrate_once", "calibrate_group", "spawn_group"]

#: how long a spawned rank waits in one collective before its backend
#: gives up
RANK_TIMEOUT_S = 300


def _params_json(p: NoCParams) -> Dict:
    return {"mesh": list(p.mesh), "channel_bandwidth": p.channel_bandwidth,
            "t_router": p.t_router, "t_enq": p.t_enq}


def _reused_summary(cached, path: Path, backend: str,
                    gate_median: float) -> Dict:
    """The summary of a run that reuses the persisted ``cached``."""
    return {
        "reused": True,
        "fits_solved": 0,
        "path": str(path),
        "backend": backend,
        "n_points": len(cached.points),
        "n_dropped": 0,
        "degenerate": bool(cached.provenance.get("degenerate", False)),
        "max_rel_err": cached.max_rel_err,
        "median_rel_err": cached.median_rel_err,
        "gate_median": gate_median,
        "gate_ok": cached.median_rel_err <= gate_median,
        "persisted": True,
        "params": _params_json(cached.params),
    }


def calibrate_once(
    measure_fn: Callable[[str, int, int], float],
    reference: NoCParams,
    participants,
    *,
    backend: str,
    torch_version: str,
    store: Optional[str] = None,
    force: bool = False,
    config: Optional[SweepConfig] = None,
    gate_median: float = 0.6,
    now: Callable[[], float] = time.time,
) -> Dict:
    """Run (or reuse) one calibration; return a flat summary dict.

    ``reference`` must carry the mesh the sweep actually runs over —
    hop distances are computed on it (``_replace_mesh`` in the harness
    re-meshes a preset NoC).  ``gate_median`` bounds the median
    |relative error| of the fitted model on its own sweep.
    """
    path = calibration_path(store)
    expect = {"backend": backend, "mesh": list(reference.mesh),
              "torch_version": torch_version}

    if not force:
        cached = load_calibration(path, expect=expect)
        if cached is not None:
            return _reused_summary(cached, path, backend, gate_median)

    sweep = run_sweep(measure_fn, participants, config=config)
    fit = fit_noc_params(sweep.points, reference)

    persisted_path = None
    if fit.degenerate:
        _warn_once(("calib-degenerate", backend),
                   f"calibration sweep on backend {backend!r} left "
                   f"{len(sweep.points)} usable point(s) "
                   f"(dropped: {dict(sweep.dropped)}) — fit is degenerate, "
                   f"keeping preset NoC params and persisting nothing")
    else:
        cal = calibration_from_fit(
            fit, backend=backend, torch_version=torch_version, now=now,
            extra={"dropped": dict(sweep.dropped),
                   "sweep": {"min_bytes": (config or SweepConfig()).min_bytes,
                             "max_bytes": (config or SweepConfig()).max_bytes,
                             "n_sizes": (config or SweepConfig()).n_sizes,
                             "iters": (config or SweepConfig()).iters}})
        persisted_path = save_calibration(cal, path)

    return {
        "reused": False,
        "fits_solved": 1,
        "path": str(persisted_path) if persisted_path else None,
        "backend": backend,
        "n_points": fit.n_points,
        "n_dropped": sweep.n_dropped,
        "dropped": dict(sweep.dropped),
        "degenerate": fit.degenerate,
        "max_rel_err": fit.max_rel_err,
        "median_rel_err": fit.median_rel_err,
        "gate_median": gate_median,
        "gate_ok": (not fit.degenerate
                    and fit.median_rel_err <= gate_median),
        "persisted": persisted_path is not None,
        "params": _params_json(fit.params),
    }


def calibrate_group(reference: NoCParams, *, backend: str,
                    store: Optional[str] = None, force: bool = False,
                    config: Optional[SweepConfig] = None,
                    gate_median: float = 0.6) -> Optional[Dict]:
    """One calibration over the world group of ``torch.distributed``,
    called by every rank in lock step with the same arguments.

    ``reference`` is re-meshed to ``(1, n)`` for the group's n ranks.
    Rank 0 loads the persisted calibration once, decides from it whether
    it is reused and broadcasts that; on reuse it returns the summary of
    the file it loaded.  Otherwise every rank runs the same sweep
    (``torch_measure_fn`` over the world group), and rank 0 fits, gates
    and persists through :func:`calibrate_once` (forced: the decision is
    taken) and returns its summary.  The other ranks return ``None``:
    had each decided reuse or persisted alone, they could wait on each
    other's collectives or race on the file.
    """
    import torch
    import torch.distributed as dist

    n, rank = dist.get_world_size(), dist.get_rank()
    reference = _replace_mesh(reference, (1, n))
    path = calibration_path(store)
    cached = None
    if rank == 0 and not force:
        cached = load_calibration(
            path, expect={"backend": backend, "mesh": list(reference.mesh),
                          "torch_version": torch.__version__})
    reuse = [cached is not None]
    if n > 1:
        dist.broadcast_object_list(reuse, src=0)
    if reuse[0]:
        return (_reused_summary(cached, path, backend, gate_median)
                if rank == 0 else None)
    measure_fn = torch_measure_fn()
    if rank == 0:
        return calibrate_once(
            measure_fn, reference, n, backend=backend,
            torch_version=torch.__version__, store=store, force=True,
            config=config, gate_median=gate_median)
    run_sweep(measure_fn, n, config=config)
    return None


def _group_rank(rank: int, world: int, backend: str, tmp: str,
                kwargs: Dict) -> None:
    """A rank started by :func:`spawn_group`: joins the group through a
    ``FileStore`` in ``tmp``; rank 0 writes the summary there.  A rank
    that raises leaves its group as it is (its peers may wait in a
    collective) and ends; ``spawn_group`` then ends the others."""
    import torch
    import torch.distributed as dist

    if backend == "nccl":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    summary = calibrate_group(backend=backend, **kwargs)
    dist.destroy_process_group()
    if summary is not None:
        Path(tmp, "summary.json").write_text(json.dumps(summary))


def spawn_group(world: int, backend: str, reference: NoCParams,
                **kwargs) -> Dict:
    """Start ``world`` ranks with ``spawn`` (``backend`` ``nccl``: rank r
    on card r; ``gloo``: CPU ranks), run :func:`calibrate_group` on them
    with ``reference`` and ``kwargs``, wait for them, and return rank 0's
    summary.  A rank that fails ends the others, and ``start_processes``
    raises."""
    import torch.multiprocessing as mp

    kwargs = dict(kwargs, reference=reference)
    with tempfile.TemporaryDirectory(prefix="repro_torch_calibrate_") as tmp:
        mp.start_processes(_group_rank,
                           args=(world, backend, tmp, kwargs),
                           nprocs=world, start_method="spawn")
        return json.loads(Path(tmp, "summary.json").read_text())
