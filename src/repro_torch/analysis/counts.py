"""Structural FLOP and collective counting of one run of a function.

Port of ``repro/analysis/jaxpr.py``.  The JAX package walks a jaxpr with
trip-count multipliers; the port has no traced program to walk, so it
counts a run: the function runs once (on fake tensors under
``FakeTensorMode`` when nothing may be allocated or launched, as the dry
run and the contract arms do, or on real tensors) under

- ``torch.utils.flop_counter.FlopCounterMode``: the aten matmuls and
  convolutions (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``convolution``,
  SDPA: the walker's ``dot_general`` and ``conv_general_dilated``), and
  every kernel entry of ``repro_torch::`` through its FLOP formula, the
  products its launch issues on its tiling (``kernels/_op.py``);
- ``parallel/collective_planner.record_collectives``: every collective
  issued through ``collective()``, forward and backward, with its label,
  its COMET type, its DV in the cost model's convention and its
  participants; those of a remat recompute apart (``recompute``), where
  the JAX package's count of a traced program has none.

A loop runs as many times as it runs, so there is no trip count to find
and no ``while-unbounded`` finding.  The walker's findings become:

- ``data-dependent``: an op whose output shape or value the host reads
  from the data (``nonzero``, ``.item()``; aten's ``dynamic_output_shape``
  and ``data_dependent_output`` tags).  On fake tensors such an op cannot
  run: the count stops there, is a lower bound, and says so;
- ``kernel-no-formula``: a ``repro_torch::`` op with no FLOP formula,
  whose products would go uncounted.

FLOPs are this rank's (the program of one rank); the JAX walker's are
global (``shard_map`` x devices).  Multiply by the world's size where
the ranks run the same program.

No HLO exists here: ``repro/analysis/hlo.py``'s ``parse_collectives`` and
``shape_bytes`` have no counterpart (the recorded collectives are
complete, where the jaxpr misses what GSPMD inserts), and neither have the
launch shims ``launch/hlo_analysis.py`` and ``launch/jaxpr_analysis.py``.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from ..parallel.collective_planner import record_collectives

__all__ = ["CollectiveRecord", "TraceCounts", "trace_counts",
           "structural_flops", "counts_of_records", "fake_world",
           "fake_mode", "FAKE_DEVICE"]

# The device of the fake tensors of a whole model's run.  A build of torch
# with CUDA makes fake CUDA tensors, the card's; a CPU-only build makes
# them too, but its Python indexing (``x[None, :]``) takes a CUDA device
# guard that it lacks, so there a model's run takes fake CPU tensors.  The
# kernel entries take the same op, shape function and formula on either:
# fake tensors never reach the plain version or the launch.
FAKE_DEVICE = "cuda" if torch.backends.cuda.is_built() else "cpu"


@dataclass
class CollectiveRecord:
    """Aggregated trace of one (collective type, participant count) pair."""

    col_type: str
    participants: int
    count: float = 0.0
    dv_bytes: float = 0.0
    shard_bytes: float = 0.0

    def merge(self, other: "CollectiveRecord") -> None:
        self.count += other.count
        self.dv_bytes += other.dv_bytes
        self.shard_bytes += other.shard_bytes

    def to_dict(self) -> Dict:
        return {"type": self.col_type, "participants": self.participants,
                "count": self.count, "dv_bytes": self.dv_bytes,
                "shard_bytes": self.shard_bytes}


@dataclass
class TraceCounts:
    """FLOPs and collectives counted from one run.  ``records`` are the
    collectives ``(label, type, dv_bytes, participants)`` in issue order,
    those of the remat recompute in ``recompute`` (not in
    ``collectives``)."""

    flops: float = 0.0
    collectives: Dict[Tuple[str, int], CollectiveRecord] = field(
        default_factory=dict)
    findings: list = field(default_factory=list)
    records: List[Tuple[str, str, float, int]] = field(default_factory=list)
    recompute: List[Tuple[str, str, float, int]] = field(
        default_factory=list)

    def add_finding(self, kind: str, detail: str) -> None:
        self.findings.append({"kind": kind, "detail": detail})

    def add_collective(self, col_type: str, participants: int, count: float,
                       dv_bytes: float, shard_bytes: float) -> None:
        key = (col_type, int(participants))
        rec = self.collectives.get(key)
        if rec is None:
            rec = self.collectives[key] = CollectiveRecord(
                col_type, int(participants))
        rec.count += count
        rec.dv_bytes += dv_bytes
        rec.shard_bytes += shard_bytes

    def total_collective_dv(self) -> float:
        return sum(r.dv_bytes for r in self.collectives.values())

    def by_type(self) -> Dict[str, CollectiveRecord]:
        """Per-type totals (participants field holds the max seen)."""
        out: Dict[str, CollectiveRecord] = {}
        for rec in self.collectives.values():
            t = out.get(rec.col_type)
            if t is None:
                out[rec.col_type] = CollectiveRecord(
                    rec.col_type, rec.participants, rec.count,
                    rec.dv_bytes, rec.shard_bytes)
            else:
                t.participants = max(t.participants, rec.participants)
                t.merge(rec)
        return out

    def to_dict(self) -> Dict:
        return {"flops": self.flops,
                "collectives": [r.to_dict() for _, r in
                                sorted(self.collectives.items())],
                "findings": list(self.findings),
                "recompute_collectives": len(self.recompute)}


def counts_of_records(records, out: TraceCounts) -> TraceCounts:
    """Add ``record_collectives``' records to ``out``: one occurrence each,
    its DV as recorded, its shard the operand (an All-Gather's DV over its
    participants)."""
    for rec in records:
        label, col_type, dv, P = rec
        shard = dv / P if col_type == "AllGather" else dv
        out.add_collective(col_type, P, 1.0, dv, shard)
        out.records.append(tuple(rec))
    return out


class _Findings(TorchDispatchMode):
    """Notes each op whose output the data decides and each kernel op
    with no FLOP formula."""

    def __init__(self, out: TraceCounts):
        super().__init__()
        self.out, self.seen = out, set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        tags = getattr(func, "tags", ())
        key = str(func)
        if key not in self.seen:
            if _data_dependent(func, tags, args):
                self.seen.add(key)
                self.out.add_finding(
                    "data-dependent",
                    f"{key}: its output depends on the data's values; on "
                    f"fake tensors the count stops here (a lower bound)")
            elif func.namespace == "repro_torch" and \
                    func._overloadpacket not in flop_registry:
                self.seen.add(key)
                self.out.add_finding(
                    "kernel-no-formula",
                    f"{key} has no FLOP formula: its products are not "
                    f"counted")
        return func(*args, **(kwargs or {}))


def _data_dependent(func, tags, args) -> bool:
    """Whether the host reads ``func``'s output shape or value from the
    data: aten's tags, but for an index by integer tensors (a gather,
    whose shape the indices' shapes decide; one by a bool mask is not)."""
    if torch.Tag.data_dependent_output in tags:
        return True
    if torch.Tag.dynamic_output_shape not in tags:
        return False
    if func is torch.ops.aten.index.Tensor:
        return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in (args[1] if len(args) > 1 else ()) or ())
    return True


def _data_dependent_errors() -> tuple:
    from torch._subclasses import fake_tensor as ft
    return tuple(getattr(ft, n) for n in ("DynamicOutputShapeException",
                                          "DataDependentOutputException")
                 if hasattr(ft, n))


def trace_counts(fn, *args, **kwargs) -> TraceCounts:
    """FLOPs (this rank's) and collectives of one run of ``fn(*args,
    **kwargs)``.  The run's result is discarded."""
    out = TraceCounts()
    with record_collectives() as rec:
        counter = FlopCounterMode(display=False)
        try:
            with counter, _Findings(out):
                fn(*args, **kwargs)
        except _data_dependent_errors() as exc:
            out.add_finding("data-dependent", f"the run stopped: {exc!r}")
    out.flops = float(counter.get_total_flops())
    counts_of_records(rec, out)
    out.recompute = [tuple(r) for r in rec.recompute]
    return out


def structural_flops(fn, *args, **kwargs) -> float:
    """Matmul FLOPs (this rank's) of one run of ``fn``."""
    return trace_counts(fn, *args, **kwargs).flops


def fake_mode():
    """A ``FakeTensorMode`` in which tensors of any device, CUDA among
    them, are made without memory or a device: its tensors have shapes,
    dtypes, devices and strides, and run no arithmetic."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A default process group of ``world_size`` ranks in this one
    process, on the ``fake`` backend (``torch.testing``'s ``FakeStore``):
    every collective returns at once with its input as it was, so one
    process runs rank ``rank``'s program of a world of any size.  Made
    here, destroyed on exit with the meshes' groups
    (``forget_mesh_groups``); refused if a group exists already."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ..parallel.collective_planner import forget_mesh_groups
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already; a fake "
                           "world needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        forget_mesh_groups()
        if dist.is_initialized():
            dist.destroy_process_group()
