"""``reconcile`` and ``roofline_terms`` of the port against the JAX
package's (``repro/analysis/reconcile.py``, ``hlo.py``): given the same
inputs and the same ``HW``, the same report and the same dict; the wire
factors and the schedule's expected wire alike."""
import importlib

import pytest

from repro.analysis import hlo as jhlo
from repro.parallel.collective_planner import DeclaredCollective as JDecl
from repro_torch.analysis import roofline as troof
from repro_torch.analysis.counts import TraceCounts, counts_of_records
from repro_torch.parallel.collective_planner import DeclaredCollective

# the modules (both packages export a function ``reconcile`` too)
jrec = importlib.import_module("repro.analysis.reconcile")
trec = importlib.import_module("repro_torch.analysis.reconcile")
# per op: [count, raw, wire, wire in loop bodies]
STATS = {"all-reduce": [12, 4.0e6, 7.0e6, 1.0e5],
         "all-gather": [3, 2.0e6, 1.5e6, 0.0],
         "reduce-scatter": [1, 8.0e5, 6.0e5, 2.0e4],
         "ragged-all-to-all": [2, 1.0e5, 9.0e4, 0.0]}
EXPECTED = [
    {"all-reduce": 7.2e6, "all-gather": 1.5e6},            # match, hlo-only
    {"all-reduce": 2.0e7, "collective-permute": 5.0e3},    # mismatch, exp-only
    {},                                                    # all hlo-only
    {"all-to-all": 9.0e4, "reduce-scatter": 0.0},
]


@pytest.mark.parametrize("expected", EXPECTED)
@pytest.mark.parametrize("loop_trip,tol", [(1, 0.25), (40, 0.25),
                                           (4, 0.05)])
def test_reconcile_matches_jax(expected, loop_trip, tol):
    js = jhlo.CollectiveStats({k: list(v) for k, v in STATS.items()})
    ts = trec.CollectiveStats({k: list(v) for k, v in STATS.items()})
    j = jrec.reconcile(expected, js, loop_trip=loop_trip, tol=tol)
    t = trec.reconcile(expected, ts, loop_trip=loop_trip, tol=tol)
    assert t.to_dict() == j.to_dict()
    assert t.describe_findings() == j.describe_findings()
    assert ts.to_dict() == js.to_dict()
    assert ts.wire_bytes_scaled(loop_trip) == js.wire_bytes_scaled(loop_trip)


@pytest.mark.parametrize("col_type", ["AllReduce", "AllGather",
                                      "ReduceScatter", "AllToAll",
                                      "Permute"])
@pytest.mark.parametrize("P", [1, 2, 16])
def test_wire_of_matches_jax(col_type, P):
    assert trec._wire_of(col_type, 3.0e6, P) == \
        jrec._wire_of(col_type, 3.0e6, P)


def test_expected_wire_from_schedule_matches_jax():
    entries = [("grads/w", "AllReduce", 4096.0, 2, 1, "gspmd"),
               ("tp/attn-out", "AllReduce", 8192.0, 4, 8, "gspmd"),
               ("params/w", "AllGather", 4096.0, 2, 2, "gspmd"),
               ("xent/stats", "AllReduce", 64.0, 4, 5, "explicit"),
               ("one", "AllReduce", 64.0, 1, 5, "gspmd")]
    j = jrec.expected_wire_from_schedule([JDecl(*e) for e in entries])
    t = trec.expected_wire_from_schedule(
        [DeclaredCollective(*e) for e in entries])
    assert t == j
    assert trec.expected_wire_from_schedule(
        [DeclaredCollective(*e) for e in entries],
        origins=("explicit",)) == jrec.expected_wire_from_schedule(
        [JDecl(*e) for e in entries], origins=("explicit",))


def test_recorded_side_is_the_trace_walkers_convention():
    """The observed side of a recorded run, per op, is the wire the JAX
    package's ``expected_wire_from_trace`` charges the same collectives,
    and the explicit-family filter keeps only xent/ and moe/ labels."""
    from repro.analysis.jaxpr import TraceCounts as JTrace
    recs = [("xent/stats", "AllReduce", 512.0, 4),
            ("tp/attn-out", "AllReduce", 4096.0, 4),
            ("zero1/params", "AllGather", 2048.0, 2),
            ("moe/combine", "AllReduce", 1024.0, 4),
            ("tp/kv-gather", "ReduceScatter", 1024.0, 4),
            ("tp/embed", "AllReduce", 4096.0, 1)]
    t = counts_of_records(recs, TraceCounts())
    j = JTrace()
    for _, col, dv, P in recs:
        j.add_collective(col, P, 1.0, dv, dv / P if col == "AllGather"
                         else dv)
    assert {k: r.to_dict() for k, r in t.collectives.items()} == \
        {k: r.to_dict() for k, r in j.collectives.items()}
    stats = trec.stats_from_trace(t)
    assert {op: v[2] for op, v in stats.by_type.items()} == \
        jrec.expected_wire_from_trace(j)
    explicit = trec.expected_wire_from_trace(t)
    assert explicit == {"all-reduce": trec._wire_of("AllReduce", 512.0, 4)
                        + trec._wire_of("AllReduce", 1024.0, 4)}


def test_size_grads_as_issued_takes_explains_c6_out_before_the_comparison():
    """C.6 sizing: a ``gspmd`` ``grads/X`` entry declared a whole number of
    times the issued bytes is sized as issued, other entries stay; the
    sized declaration then reconciles the All-Reduce as a ``match`` where
    the declared one is a ``mismatch`` that ``explain`` names C.6."""
    recs = [("grads/w", "AllReduce", 1024.0, 2),
            ("grads/b", "AllReduce", 300.0, 2),
            ("tp/attn-out", "AllReduce", 4096.0, 4)]
    t = counts_of_records(recs, TraceCounts())
    sched = [DeclaredCollective("grads/w", "AllReduce", 4096.0, 2, 1,
                                "gspmd"),
             DeclaredCollective("grads/b", "AllReduce", 400.0, 2, 1,
                                "gspmd"),
             DeclaredCollective("tp/attn-out", "AllReduce", 4096.0, 4, 1,
                                "gspmd")]
    sized, labels = trec.size_grads_as_issued(sched, t)
    assert labels == ["grads/w"]
    assert [d.dv_bytes for d in sized] == [1024.0, 400.0, 4096.0]
    assert sized[1:] == sched[1:]
    raw = trec.reconcile_cell(t, schedule=sched)
    assert raw.per_type["all-reduce"].status == "mismatch"
    assert "C.6: 1 grads/* entries" in raw.findings[0]["note"]
    assert trec.reconcile_cell(t, schedule=sized).per_type[
        "all-reduce"].status == "match"


ROOF = [(1e12, 2e9, 0.0), (3e14, 5e10, 2e9), (1e9, 8e11, 4e10),
        (5e13, 1e9, 9e10)]


@pytest.mark.parametrize("flops,nbytes,wire", ROOF)
@pytest.mark.parametrize("link_bw,overlap", [(None, 1.0), (None, 0.0),
                                             (2.8e11, 0.5)])
def test_roofline_terms_match_jax_on_the_same_hw(monkeypatch, flops, nbytes,
                                                 wire, link_bw, overlap):
    for k, v in troof.HW.items():
        monkeypatch.setitem(jhlo.HW, k, v)
    assert troof.roofline_terms(flops, nbytes, wire, link_bw=link_bw,
                                overlap=overlap) == \
        jhlo.roofline_terms(flops, nbytes, wire, link_bw=link_bw,
                            overlap=overlap)


def test_hw_is_the_cards_from_one_source():
    import torch

    from repro_torch.launch.kernel_bench import BYTES_PER_S, PEAK_FLOPS
    assert troof.HW["peak_flops_bf16"] == PEAK_FLOPS[torch.bfloat16]
    assert troof.HW["hbm_bw"] == BYTES_PER_S
    assert set(troof.HW) == set(jhlo.HW)
