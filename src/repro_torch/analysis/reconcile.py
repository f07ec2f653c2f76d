"""Declared-vs-recorded collective reconciliation.

Port of ``repro/analysis/reconcile.py``.  The JAX package compares two
static views: the jaxpr walker's explicit collectives (plus the declared
``origin == "gspmd"`` schedule entries for what GSPMD inserts, which the
jaxpr cannot see) against the compiled HLO's parse.  The port issues every
collective itself, through ``collective()``, so its "observed" side is the
recorded run (:mod:`.counts`), complete by construction, where the JAX
package has the HLO parse.  ``expected`` is the same: the recorded
explicit-family collectives (``xent/``, ``moe/combine``, ``moe/*-grad``)
plus the declared ``gspmd`` entries.  Per op type the larger side is
charged, and each disagreement is a finding.

Both sides are per-participant wire bytes with the ring factors of
:func:`_wire_factor` (``repro/analysis/hlo.py``'s), so a match means the
cost model and the run agree on what each rank puts on the wire.

Known causes of a finding, named in its ``note``: the declaration sizes
each ``grads/*`` entry as the whole leaf where each rank reduces its
``model`` shard (ROADMAP C.6; under ZeRO-3 its ``grads/*``
Reduce-Scatters and ``params/*`` All-Gathers too, which the port issues
a layer's slice at a time), the backward's ZeRO-3 regathers run in the
remat recompute (C.20), and the port issues collectives of its own that
no entry declares (``PORT_OWN``).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, List, Optional, Tuple

from .counts import TraceCounts

__all__ = ["TypeReconciliation", "ReconcileReport", "CollectiveStats",
           "reconcile", "expected_wire_from_trace",
           "expected_wire_from_schedule", "stats_from_trace",
           "reconcile_cell", "size_grads_as_issued", "HLO_OP_FOR_TYPE",
           "EXPLICIT_LABELS", "PORT_OWN"]

# COMET collective type -> the op name the per-type report is keyed by
# (the HLO op's, as in the JAX package)
HLO_OP_FOR_TYPE = {
    "AllReduce": "all-reduce",
    "AllGather": "all-gather",
    "ReduceScatter": "reduce-scatter",
    "AllToAll": "all-to-all",
    "Permute": "collective-permute",
}

DEFAULT_TOL = 0.25

# label prefixes of the declaration's ``origin == "explicit"`` entries:
# the collectives the JAX package's shard_map bodies emit (and its jaxpr
# walker sees)
EXPLICIT_LABELS = ("xent/", "moe/combine", "moe/expert-grad",
                   "moe/router-grad", "moe/router-bias-grad")

# the port's own collectives, which no entry of the declaration names
# (tests/torch_mesh_checks.py::port_own_schedule): what GSPMD inserts for
# the JAX step undeclared
PORT_OWN = {
    "tp/embed": "the embedding's vocab-sharded lookup summed over model",
    "tp/q-gather": "q heads split mid-head: gathered and scattered back",
    "tp/kv-gather": "kv heads fewer than model ranks: gathered",
    "tp/qk-norm-grad": "the q/k norm scales' cotangents summed",
    "tp/ssm-gather": "the SSM mixer's in_proj and conv outputs gathered",
    "tp/ssm-norm": "the SSM gated norm's sum over model",
    "tp/ssm-out": "the SSM mixer's out projection reduced",
    "tp/ssm-param-grad": "the SSM per-head leaves' cotangents",
    "tp/mla-latent": "MLA's latents' cotangents (C.13)",
    "tp/cross-kv": "the encoder output's cotangent under cross-attention",
    "tp/seq-gather": "seq_shard's rows gathered (C.15)",
    "tp/unembed-gather": "the plain loss's unembed gathered",
    "moe/shared-out": "the shared experts' f and g",
    "moe/expert-block": "tensor_parallel=False expert blocks (C.16)",
    "xent/unembed-block": "tensor_parallel=False unembed block (C.16)",
    "grads/norm": "the global norm's sharded leaves' squares summed",
    "loss/mean": "the plain loss's mean over data",
    "zero1/params": "ZeRO-1's All-Gather of the updated parameter slices",
}


@dataclass
class CollectiveStats:
    """Per op: [count, raw bytes, wire bytes, wire bytes in loop bodies]
    (the JAX package's HLO parse result; here from a recorded run, which
    has no loop body to scale: the last slot stays 0)."""
    by_type: Dict[str, List[float]] = field(default_factory=dict)

    @property
    def total_wire_bytes(self) -> float:
        return sum(v[2] + v[3] for v in self.by_type.values())

    @property
    def total_raw_bytes(self) -> float:
        return sum(v[1] for v in self.by_type.values())

    def wire_bytes_scaled(self, loop_trip: int) -> float:
        return sum(v[2] + v[3] * loop_trip for v in self.by_type.values())

    def to_dict(self) -> Dict:
        return {k: {"count": v[0], "raw_bytes": v[1], "wire_bytes": v[2],
                    "wire_bytes_in_loop": v[3]}
                for k, v in self.by_type.items()}


def _wire_factor(op: str, g: int) -> float:
    if g <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (g - 1) / g
    if op in ("all-gather", "all-to-all", "ragged-all-to-all"):
        return (g - 1) / g
    if op == "reduce-scatter":
        return (g - 1)
    if op == "collective-permute":
        return 1.0
    return 1.0


def _wire_of(col_type: str, dv_bytes: float, participants: int) -> float:
    """Per-participant wire bytes of one collective in the cost model's
    DV convention (a Reduce-Scatter's DV is its input, P x its result)."""
    P = int(participants)
    if P <= 1:
        return 0.0
    op = HLO_OP_FOR_TYPE.get(col_type)
    if op is None:
        return 0.0
    if col_type == "ReduceScatter":
        return _wire_factor(op, P) * (dv_bytes / P)
    return _wire_factor(op, P) * dv_bytes


def is_explicit(label: str) -> bool:
    return label.startswith(EXPLICIT_LABELS)


def expected_wire_from_trace(trace: TraceCounts,
                             explicit_only: bool = True
                             ) -> Dict[str, float]:
    """Per-op expected wire bytes of a recorded run's collectives; with
    ``explicit_only`` those of the explicit-family labels alone (what the
    JAX walker sees)."""
    out: Dict[str, float] = {}
    for label, col_type, dv, P in trace.records:
        op = HLO_OP_FOR_TYPE.get(col_type)
        if op is None or P <= 1 or (explicit_only and not is_explicit(label)):
            continue
        out[op] = out.get(op, 0.0) + _wire_of(col_type, dv, P)
    return out


def expected_wire_from_schedule(schedule: Iterable,
                                origins: Iterable[str] = ("gspmd",),
                                ) -> Dict[str, float]:
    """Per-op expected wire bytes from ``DeclaredCollective`` entries
    (the ``gspmd`` origin by default: explicit ones are recorded)."""
    origins = set(origins)
    out: Dict[str, float] = {}
    for d in schedule:
        if d.origin not in origins or d.participants <= 1:
            continue
        op = HLO_OP_FOR_TYPE.get(d.col_type)
        if op is None:
            continue
        out[op] = out.get(op, 0.0) + d.count * _wire_of(
            d.col_type, d.dv_bytes, d.participants)
    return out


def stats_from_trace(trace: TraceCounts) -> CollectiveStats:
    """The observed side: every recorded collective (outside the remat
    recompute), per op, with its raw DV and wire bytes."""
    stats = CollectiveStats()
    for label, col_type, dv, P in trace.records:
        op = HLO_OP_FOR_TYPE.get(col_type)
        if op is None:
            continue
        ent = stats.by_type.setdefault(op, [0, 0.0, 0.0, 0.0])
        ent[0] += 1
        ent[1] += dv
        ent[2] += _wire_of(col_type, dv, P)
    return stats


@dataclass
class TypeReconciliation:
    """Expected-vs-observed verdict for one collective op type."""

    hlo_op: str
    expected_wire: float
    hlo_wire: float
    status: str            # match | mismatch | hlo-only | expected-only
    reconciled_wire: float

    @property
    def rel_err(self) -> float:
        base = max(abs(self.expected_wire), abs(self.hlo_wire))
        return abs(self.expected_wire - self.hlo_wire) / base if base else 0.0

    def to_dict(self) -> Dict:
        return {"hlo_op": self.hlo_op, "expected_wire": self.expected_wire,
                "hlo_wire": self.hlo_wire, "status": self.status,
                "rel_err": self.rel_err,
                "reconciled_wire": self.reconciled_wire}


@dataclass
class ReconcileReport:
    per_type: Dict[str, TypeReconciliation] = field(default_factory=dict)
    findings: List[Dict] = field(default_factory=list)
    tolerance: float = DEFAULT_TOL

    @property
    def clean(self) -> bool:
        return not self.findings

    @property
    def total_reconciled_wire(self) -> float:
        return sum(t.reconciled_wire for t in self.per_type.values())

    @property
    def total_hlo_wire(self) -> float:
        return sum(t.hlo_wire for t in self.per_type.values())

    @property
    def total_expected_wire(self) -> float:
        return sum(t.expected_wire for t in self.per_type.values())

    def to_dict(self) -> Dict:
        return {"clean": self.clean, "tolerance": self.tolerance,
                "total_reconciled_wire": self.total_reconciled_wire,
                "total_hlo_wire": self.total_hlo_wire,
                "total_expected_wire": self.total_expected_wire,
                "per_type": {k: t.to_dict()
                             for k, t in sorted(self.per_type.items())},
                "findings": list(self.findings)}

    def describe_findings(self) -> str:
        return "\n".join(f"[{f['kind']}] {f['detail']}"
                         for f in self.findings)


def reconcile(expected: Dict[str, float], stats: CollectiveStats, *,
              loop_trip: int = 1,
              tol: float = DEFAULT_TOL) -> ReconcileReport:
    """Compare expected per-op wire bytes against the observed ones; the
    JAX package's verdicts (``match`` within ``tol``, else ``mismatch``
    charged at the larger side; ``hlo-only``: observed, nothing expected;
    ``expected-only``), findings and messages, with "HLO" the observed
    side."""
    hlo_wire: Dict[str, float] = {}
    for op, v in stats.by_type.items():
        hlo_wire[op] = hlo_wire.get(op, 0.0) + v[2] + v[3] * loop_trip
    if "ragged-all-to-all" in hlo_wire:
        hlo_wire["all-to-all"] = (hlo_wire.get("all-to-all", 0.0)
                                  + hlo_wire.pop("ragged-all-to-all"))

    report = ReconcileReport(tolerance=tol)
    for op in sorted(set(expected) | set(hlo_wire)):
        e = float(expected.get(op, 0.0))
        h = float(hlo_wire.get(op, 0.0))
        if e == 0.0 and h == 0.0:
            report.per_type[op] = TypeReconciliation(op, 0.0, 0.0,
                                                     "match", 0.0)
            continue
        if e > 0.0 and h > 0.0:
            base = max(e, h)
            if abs(e - h) / base <= tol:
                status, rec_wire = "match", h
            else:
                status, rec_wire = "mismatch", max(e, h)
                report.findings.append({
                    "kind": "reconcile-mismatch",
                    "hlo_op": op,
                    "detail": (f"{op}: declared/traced wire {e:.4g} B vs "
                               f"HLO {h:.4g} B (rel_err "
                               f"{abs(e - h) / base:.2f} > tol {tol:g}); "
                               f"roofline charges the larger side")})
        elif h > 0.0:
            status, rec_wire = "hlo-only", h
            report.findings.append({
                "kind": "reconcile-hlo-only",
                "hlo_op": op,
                "detail": (f"{op}: HLO executes {h:.4g} wire bytes with no "
                           f"declared or traced counterpart (GSPMD-inserted "
                           f"resharding or collective rewrite)")})
        else:
            status, rec_wire = "expected-only", e
            report.findings.append({
                "kind": "reconcile-expected-only",
                "hlo_op": op,
                "detail": (f"{op}: {e:.4g} declared/traced wire bytes never "
                           f"appear in the compiled HLO (XLA eliminated the "
                           f"op, or the text parse missed it)")})
        report.per_type[op] = TypeReconciliation(op, e, h, status, rec_wire)
    return report


def explain(report: ReconcileReport, trace: TraceCounts, schedule,
            tol: float = DEFAULT_TOL,
            shards: Optional[Dict[str, float]] = None) -> List[Dict]:
    """Name each finding's causes in its ``note``, and mark it
    ``explained`` when they account for the gap: the observed wire of the
    port's own labels (:data:`PORT_OWN`) taken out, each declared
    ``grads/X`` (or ``params/X``) entry sized as the rank's ``model``
    shard of X (C.6, :func:`_c6_issued`), and the ``params/*`` gathers of
    the remat recompute added (C.20: the declaration's second, backward
    gather of each ZeRO-3 leaf), the two sides agree within ``tol``.
    Returns the findings left unexplained."""
    own: Dict[str, Dict[str, float]] = {}
    for label, col_type, dv, P in trace.records:
        op = HLO_OP_FOR_TYPE.get(col_type)
        if op is not None and P > 1 and label in PORT_OWN:
            d = own.setdefault(op, {})
            d[label] = d.get(label, 0.0) + _wire_of(col_type, dv, P)
    schedule = list(schedule or ())
    c20: Dict[str, float] = {}
    for label, col_type, dv, P in trace.recompute:
        if label.startswith("params/") and P > 1:
            op = HLO_OP_FOR_TYPE[col_type]
            c20[op] = c20.get(op, 0.0) + _wire_of(col_type, dv, P)
    c6: Dict[str, float] = {}
    c6_labels: Dict[str, List[str]] = {}
    for i, got in _c6_issued(schedule, trace, shards).items():
        d = schedule[i]
        op = HLO_OP_FOR_TYPE[d.col_type]
        c6[op] = c6.get(op, 0.0) + d.count * (
            _wire_of(d.col_type, d.dv_bytes, d.participants)
            - _wire_of(d.col_type, got, d.participants))
        c6_labels.setdefault(op, []).append(d.label)
    left = []
    for f in report.findings:
        op = f["hlo_op"]
        t = report.per_type[op]
        ow = sum(own.get(op, {}).values())
        e = t.expected_wire - c6.get(op, 0.0)
        h = t.hlo_wire - ow + c20.get(op, 0.0)
        notes = []
        if c6.get(op):
            kinds = [f"{n} {k}/* entries" for k, n in (
                (k, sum(lb.startswith(k + "/") for lb in c6_labels[op]))
                for k in ("grads", "params")) if n]
            notes.append(f"C.6: {' and '.join(kinds)} declared as the "
                         f"whole leaf, issued as each rank's model shard "
                         f"({c6[op]:.4g} wire B)")
        if c20.get(op):
            notes.append(f"C.20: the backward's ZeRO-3 regathers, issued "
                         f"in the remat recompute ({c20[op]:.4g} wire B)")
        if ow:
            notes.append("the port's own collectives "
                         + ", ".join(f"{k} ({v:.4g} wire B: {PORT_OWN[k]})"
                                     for k, v in sorted(own[op].items())))
        base = max(abs(e), abs(h))
        f["explained"] = bool(notes) and (
            base == 0.0 or abs(e - h) / base <= tol)
        f["note"] = "; ".join(notes) if notes else "no known cause"
        if not f["explained"]:
            left.append(f)
    return left


def _c6_issued(schedule: List, trace: TraceCounts,
               shards: Optional[Dict[str, float]] = None
               ) -> Dict[int, float]:
    """Index -> the bytes of the rank's ``model`` shard of the leaf X of
    each ``gspmd`` ``grads/X`` or ``params/X`` entry of ``schedule`` that
    declares a whole number of times more (C.6: the declaration's whole
    leaf, a power of the model axis apart).  ``shards`` gives each leaf's
    shard bytes by its dotted name; without it a ``grads/X`` entry is
    sized as the run issued it."""
    issued = {(label, col_type, P): dv
              for label, col_type, dv, P in trace.records
              if label.startswith("grads/") and P > 1
              and HLO_OP_FOR_TYPE.get(col_type) is not None}
    out: Dict[int, float] = {}
    for i, d in enumerate(schedule):
        if shards is not None:
            got = shards.get(d.label.split("/", 1)[1]) \
                if d.label.startswith(("grads/", "params/")) else None
        else:
            got = issued.get((d.label, d.col_type, d.participants))
        if d.origin == "gspmd" and got:
            ratio = d.dv_bytes / got
            if ratio > 1.0 and abs(ratio - round(ratio)) < 1e-9:
                out[i] = got
    return out


def size_grads_as_issued(schedule: Iterable, trace: TraceCounts,
                         shards: Optional[Dict[str, float]] = None
                         ) -> Tuple[List, List[str]]:
    """``schedule`` with each C.6 entry (:func:`_c6_issued`) sized as the
    rank's ``model`` shard, and the labels so sized: :func:`explain`'s
    rule, applied before the comparison."""
    schedule = list(schedule)
    got = _c6_issued(schedule, trace, shards)
    return ([replace(d, dv_bytes=got[i]) if i in got else d
             for i, d in enumerate(schedule)],
            [schedule[i].label for i in got])


def reconcile_cell(trace: Optional[TraceCounts], *,
                   schedule: Optional[Iterable] = None,
                   tol: float = DEFAULT_TOL,
                   shards: Optional[Dict[str, float]] = None
                   ) -> ReconcileReport:
    """One-call reconciliation for a dry-run cell: expected = the run's
    explicit-family collectives + the declared gspmd entries, observed =
    every collective the run recorded; each finding's causes named
    (:func:`explain`; ``shards``: each leaf's ``model``-shard bytes, by
    its dotted name)."""
    trace = trace if trace is not None else TraceCounts()
    expected = expected_wire_from_trace(trace)
    if schedule is not None:
        for op, w in expected_wire_from_schedule(schedule).items():
            expected[op] = expected.get(op, 0.0) + w
    report = reconcile(expected, stats_from_trace(trace), tol=tol)
    explain(report, trace, schedule, tol, shards)
    return report
