"""Static analysis of the port: contracts and the repo-invariant lint.

Port of ``repro/analysis``.  Two arms, both runnable as ``python -m
repro_torch.analysis`` (one JSON document out, nonzero exit on a failure):

- :mod:`.contracts`: the kernels' FLOP formulas against the compound ops'
  GEMM FLOPs, and the mesh paths' recorded collectives against the
  declared schedules the planner prices, on fake tensors and fake worlds;
- :mod:`.lint`: the AST lint of the invariants the review keeps
  re-litigating (the array-polymorphic Eq. 1-7 path, the kernels' launch
  path free of host work, every kernel instance inside the card's shared
  memory, sqlite confined to the plan store).

:mod:`.counts` counts a run (the JAX package's jaxpr walker),
:mod:`.reconcile` compares declared and recorded collectives, and
:mod:`.roofline` holds the card's roofline terms.  Importing the package
makes no process group and loads nothing of ``torch.testing``: the fake
world is made only while an arm or a dry run runs.
"""
from .counts import (CollectiveRecord, TraceCounts, fake_mode, fake_world,
                     structural_flops, trace_counts)
from .reconcile import (CollectiveStats, ReconcileReport,
                        expected_wire_from_schedule, expected_wire_from_trace,
                        reconcile, reconcile_cell, stats_from_trace)
from .roofline import HW, roofline_terms

__all__ = [
    "CollectiveRecord", "TraceCounts", "fake_mode", "fake_world",
    "structural_flops", "trace_counts", "CollectiveStats",
    "ReconcileReport", "expected_wire_from_schedule",
    "expected_wire_from_trace", "reconcile", "reconcile_cell",
    "stats_from_trace", "HW", "roofline_terms",
]
