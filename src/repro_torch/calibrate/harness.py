"""PARAM/nccl-tests-style collective microbenchmark harness.

The COMET collective model (Eqs. 3–4, ``core/collectives.py`` +
``core/cost.py``) is purely analytical: every per-NoC volume/hop/step
factor comes from the paper's HiSIM/Orion constants.  This harness is
the *measured* side of the calibration loop — it times real
``torch.distributed`` collectives (the four COMET collective types that
appear in compound-op dataflows) over a log-spaced message-size sweep,
nccl-tests style:

    for each collective type:
        for each log-spaced data volume DV:
            warmup, then best-of-``iters`` timed executions

The backend is pluggable.  :func:`run_sweep` drives any
``measure_fn(col_type, dv_bytes, participants) -> seconds`` — one timed
execution per call — so tests and benchmarks swap the real group for
:func:`synthetic_measure_fn` (an analytic generator from known
``NoCParams``, optionally jittered) and the whole fit path is
deterministic in CI.  :func:`torch_measure_fn` is the real backend: it
times ``all_reduce`` / ``all_gather_into_tensor`` /
``reduce_scatter_tensor`` / ``all_to_all_single`` over a process group,
NCCL on the cards and gloo on CPU ranks.  Timing uses an injectable
``clock=`` (the ``planstore.py`` ``now=`` pattern), so even the real
backend can be driven with a fake clock.

Data-volume convention matches ``core/collectives.py``: ``dv_bytes`` is
the *logical tensor size* the collective operates on (the full tensor
for All-Reduce / Reduce-Scatter / All-to-All, the gathered result for
All-Gather), so measured points feed the fitter and
``collective_latency_terms`` without unit conversion.

Fault behavior (pinned by ``tests/test_torch_calibrate.py``, as the JAX
package's by ``tests/test_calibrate.py``): a ``measure_fn`` that raises,
returns non-finite/non-positive values, or produces wildly non-monotone
timings mid-sweep degrades the sweep to the surviving points — one
``RuntimeWarning`` per cause (planstore-style), never a crash, and the
dropped points are tallied in ``SweepResult.dropped`` so persistence can
refuse to write a fit built from nothing.  The one exception is
:class:`CollectiveFailure`: the real backend raises it when a call fails
after its checks, on one rank or some, which leaves the ranks out of
lock step, so it ends the run instead of dropping a point.

Port of ``repro/calibrate/harness.py``.  The JAX package's sweep is one
controller timing every device; here every rank of the group runs the
same sweep in lock step, so :func:`torch_measure_fn` gives every rank
the same answer for every call (see its docstring) and every rank ends
with the same ``SweepResult``.
"""
from __future__ import annotations

import threading
import time
import warnings
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.collectives import collective_seconds
from repro_torch.core.hardware import NoCParams

__all__ = [
    "CALIBRATED_TYPES",
    "CollectiveFailure",
    "MeasuredPoint",
    "SweepConfig",
    "SweepResult",
    "run_sweep",
    "log_sizes",
    "torch_measure_fn",
    "synthetic_measure_fn",
]

#: the four COMET collective types a real backend can execute directly
#: (Gather/Broadcast have no first-class collective; their
#: dissemination-tree factors share the AllGather exchange schedule).
CALIBRATED_TYPES = ("AllReduce", "AllGather", "ReduceScatter", "AllToAll")

#: a point whose timing falls below this fraction of the running maximum
#: of *smaller* messages of the same type is non-monotone noise (a
#: 4 MiB collective cannot be 4x faster than a 4 KiB one) and is dropped
NONMONOTONE_FRACTION = 0.25


class CollectiveFailure(RuntimeError):
    """A real collective, or its buffers, failed on this rank after the
    call's checks.  Its peers may already wait in the next collective,
    so ``run_sweep`` does not drop the point: the run ends."""


@dataclass(frozen=True)
class MeasuredPoint:
    """One timed collective execution (best-of-iters)."""

    col_type: str
    data_volume_bytes: int      # logical tensor size (COMET DV convention)
    participants: int
    seconds: float

    def to_json(self) -> Dict:
        return {"col_type": self.col_type,
                "data_volume_bytes": self.data_volume_bytes,
                "participants": self.participants,
                "seconds": self.seconds}

    @classmethod
    def from_json(cls, d: Dict) -> "MeasuredPoint":
        return cls(str(d["col_type"]), int(d["data_volume_bytes"]),
                   int(d["participants"]), float(d["seconds"]))


@dataclass(frozen=True)
class SweepConfig:
    """Sweep shape: which collectives, which sizes, how many repeats."""

    col_types: Tuple[str, ...] = CALIBRATED_TYPES
    min_bytes: int = 1 << 12            # 4 KiB
    max_bytes: int = 1 << 24            # 16 MiB
    n_sizes: int = 8                    # log-spaced points per type
    warmup: int = 1                     # untimed executions per point
    iters: int = 5                      # timed executions; best is kept


@dataclass
class SweepResult:
    """Surviving measurements plus the fault tally of one sweep."""

    points: List[MeasuredPoint] = field(default_factory=list)
    dropped: Dict[str, int] = field(default_factory=dict)
    participants: Tuple[int, ...] = ()
    config: Optional[SweepConfig] = None

    @property
    def n_dropped(self) -> int:
        return sum(self.dropped.values())


# ------------------------------------------------------------- warn-once

_WARNED: set = set()
_WARNED_LOCK = threading.Lock()


def _warn_once(cause_key: Tuple, msg: str) -> None:
    """One warning per cause for the life of the process (planstore
    style): a flaky backend degrades once, not once per point."""
    with _WARNED_LOCK:
        if cause_key in _WARNED:
            return
        _WARNED.add(cause_key)
    warnings.warn(msg, RuntimeWarning, stacklevel=3)


def _reset_warned() -> None:
    """Test hook: forget which sweep degradations have been warned."""
    with _WARNED_LOCK:
        _WARNED.clear()


# ------------------------------------------------------------ size sweep


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


def run_sweep(
    measure_fn: Callable[[str, int, int], float],
    participants,
    *,
    config: Optional[SweepConfig] = None,
) -> SweepResult:
    """Drive ``measure_fn`` over the (type x size x participants) grid.

    ``participants`` is one int (the real backend: every rank of the
    group) or a sequence (synthetic backends can sweep several group
    sizes, which sharpens the fit's separation of the per-hop and
    per-byte terms).

    Each grid point is measured ``config.warmup + config.iters`` times;
    the best (minimum) timed iteration survives — the nccl-tests
    convention, which rejects one-sided scheduler noise.  Faults degrade
    per the module docstring; the returned ``SweepResult.dropped`` maps
    cause (``error`` / ``not-finite`` / ``non-monotone``) to the number
    of grid points lost to it.
    """
    cfg = config or SweepConfig()
    ps: Tuple[int, ...] = (tuple(participants)
                           if isinstance(participants, (list, tuple))
                           else (int(participants),))
    result = SweepResult(participants=ps, config=cfg)

    def drop(cause: str, detail: str) -> None:
        result.dropped[cause] = result.dropped.get(cause, 0) + 1
        _warn_once(("sweep", cause),
                   f"calibration sweep: dropping point(s) [{cause}] — "
                   f"{detail}; continuing with a partial sweep")

    for col_type in cfg.col_types:
        for P in ps:
            # shards must divide: DV multiple of elem_size * P * P (the
            # all-to-all split needs P^2 alignment of the flat buffer)
            sizes = log_sizes(cfg.min_bytes, cfg.max_bytes, cfg.n_sizes,
                              multiple=4 * max(1, P) * max(1, P))
            running_max = 0.0
            for dv in sizes:
                best = None
                try:
                    for _ in range(cfg.warmup):
                        measure_fn(col_type, dv, P)
                    for _ in range(cfg.iters):
                        t = float(measure_fn(col_type, dv, P))
                        if best is None or t < best:
                            best = t
                except CollectiveFailure:
                    raise                 # the ranks left lock step
                except Exception as e:  # noqa: BLE001 — degrade, never crash
                    drop("error", f"{col_type}@{dv}B/P={P} raised {e!r}")
                    continue
                if best is None or not (best > 0.0) or best != best \
                        or best == float("inf"):
                    drop("not-finite",
                         f"{col_type}@{dv}B/P={P} returned {best!r}")
                    continue
                if running_max > 0.0 and best < NONMONOTONE_FRACTION * running_max:
                    drop("non-monotone",
                         f"{col_type}@{dv}B/P={P}: {best:.3e}s after "
                         f"{running_max:.3e}s at a smaller size")
                    continue
                running_max = max(running_max, best)
                result.points.append(
                    MeasuredPoint(col_type, dv, P, best))
    return result


# ------------------------------------------------------------- backends


def dv_elements(col_type: str, dv_bytes: int, participants: int,
                elem_size: int = 4) -> Tuple[int, int]:
    """(elements of each rank's input, of each rank's output) of one
    collective of ``dv_bytes`` over ``participants`` ranks, the JAX
    backend's shard shapes: the DV's elements rounded down to a multiple
    of P² (at least P²); each rank holds them all for All-Reduce,
    Reduce-Scatter and All-to-All and a 1/P shard for All-Gather, whose
    gathered result is the DV."""
    P = participants
    elems = max(1, dv_bytes // elem_size)
    elems = max(1, elems // (P * P)) * P * P
    if col_type == "AllGather":
        return elems // P, elems
    if col_type == "ReduceScatter":
        return elems, elems // P
    return elems, elems


def torch_measure_fn(group=None, *, device=None,
                     clock: Callable[[], float] = time.perf_counter,
                     dtype=None) -> Callable[[str, int, int], float]:
    """Real backend: time one execution of the requested collective over
    the process group ``group`` (default: the world group).

    Every rank of the group calls the returned function with the same
    arguments in the same order (``run_sweep`` in lock step), so:

    * the checks that can raise — ``participants`` must equal the group
      size (a real collective cannot run over a subgroup the group does
      not express), the type must be in ``CALIBRATED_TYPES`` — run
      before the call's first collective and give the same answer on
      every rank: no rank raises alone and leaves its peers waiting;
    * a barrier precedes each timed execution, and the call returns the
      *maximum* elapsed time over the ranks, taken with an All-Reduce
      MAX outside the timed window, so every rank drops the same points
      and ends with the same ``SweepResult``.

    Past those checks, a failure on this rank (a buffer that cannot be
    allocated, a collective or the clock that raises) is re-raised as
    :class:`CollectiveFailure`, which ends the run: its peers may wait in
    a collective it will not join.  A fault that NCCL reports only
    asynchronously is its watchdog's to end.  Buffers are made outside
    the timed window and
    cached per (type, elements), with a rank-distinct pattern
    (``rank * n + arange(n)`` for a rank's n input elements; the
    All-Reduce's in-place buffer is refilled from it before each call);
    ``measure.buffers`` maps each key to (input, output) so a caller can
    check the last result.  On a CUDA ``device`` (default: the current
    card on an NCCL group, the CPU otherwise) the device is synchronised
    before and after the collective inside the window; the warmup
    iterations absorb NCCL's communicator set-up.  ``clock`` is
    injectable (planstore ``now=`` pattern) for deterministic tests.
    """
    import torch
    import torch.distributed as dist

    if group is None:
        group = dist.group.WORLD
    n_ranks = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(group) == "nccl"
                  else torch.device("cpu"))
    device = torch.device(device)
    dtype = dtype or torch.float32
    elem = torch.empty((), dtype=dtype).element_size()
    on_cuda = device.type == "cuda"
    barrier_kw = {"device_ids": [device.index]} if on_cuda else {}

    def sync() -> None:
        if on_cuda:
            torch.cuda.synchronize(device)

    buffers: Dict[Tuple[str, int], Tuple] = {}
    pristine: Dict[Tuple[str, int], "torch.Tensor"] = {}

    def run(col_type: str, inp, out) -> None:
        if col_type == "AllReduce":
            dist.all_reduce(inp, group=group)
        elif col_type == "AllGather":
            dist.all_gather_into_tensor(out, inp, group=group)
        elif col_type == "ReduceScatter":
            dist.reduce_scatter_tensor(out, inp, group=group)
        else:
            dist.all_to_all_single(out, inp, group=group)

    def measure(col_type: str, dv_bytes: int, participants: int) -> float:
        if participants != n_ranks:
            raise ValueError(
                f"torch backend measures over all {n_ranks} ranks of its "
                f"group; got participants={participants}")
        if col_type not in CALIBRATED_TYPES:
            raise ValueError(f"torch backend cannot execute {col_type!r}")
        try:
            return timed(col_type, *dv_elements(col_type, dv_bytes, n_ranks,
                                                elem))
        except Exception as e:
            raise CollectiveFailure(
                f"rank {rank}: {col_type}@{dv_bytes}B over {n_ranks} ranks "
                f"failed: {e!r}") from e

    def timed(col_type: str, n_in: int, n_out: int) -> float:
        key = (col_type, n_in)
        if key not in buffers:
            src = (torch.arange(n_in, dtype=torch.float64) + rank * n_in
                   ).to(dtype=dtype, device=device)
            inp = src.clone()
            out = inp if col_type == "AllReduce" else torch.empty(
                n_out, dtype=dtype, device=device)
            buffers[key] = (inp, out)
            pristine[key] = src
        inp, out = buffers[key]
        if col_type == "AllReduce":
            inp.copy_(pristine[key])
        dist.barrier(group=group, **barrier_kw)
        sync()
        t0 = clock()
        run(col_type, inp, out)
        sync()
        elapsed = torch.tensor([clock() - t0], dtype=torch.float64,
                               device=device)
        dist.all_reduce(elapsed, op=dist.ReduceOp.MAX, group=group)
        return float(elapsed.item())

    measure.buffers = buffers
    return measure


def synthetic_measure_fn(params: NoCParams, *, jitter: float = 0.0,
                         seed: int = 0) -> Callable[[str, int, int], float]:
    """Analytic backend: generate timings from known ``NoCParams``
    through the exact Eq. 1/3/4 prediction (``collective_seconds``) the
    fitter inverts, optionally with bounded multiplicative jitter
    (uniform in ``[1-jitter, 1+jitter]``, seeded, deterministic).

    This is the ground-truth generator of the recovery tests: a
    noise-free sweep must let the fitter recover ``params`` to float
    precision, and a jittered one must stay within the documented
    tolerance.
    """
    import random

    rng = random.Random(seed)

    def measure(col_type: str, dv_bytes: int, participants: int) -> float:
        t = collective_seconds(col_type, float(dv_bytes), int(participants),
                               params)
        if jitter > 0.0:
            t *= 1.0 + rng.uniform(-jitter, jitter)
        return t

    return measure


def _replace_mesh(params: NoCParams, mesh: Tuple[int, int]) -> NoCParams:
    """Reference NoC re-meshed to the measured topology (hop distances
    must be computed on the mesh the sweep actually ran on)."""
    return replace(params, mesh=mesh)
