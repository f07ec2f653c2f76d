"""The port's copies of ``core/hardware``, ``core/collectives``,
``core/numerics``, ``calibrate/harness`` and ``calibrate/overlap`` against
the JAX package's originals, and the port of the overlap bench on the CPU.

The copies are pure Python and numpy, so they must agree with the
originals bit for bit; the bar on the collective models is 1e-12 relative
all the same, with a zero where both are zero.  The recovery bars are those
of ``benchmarks/search_throughput.py:763-764`` (0.01 clean, 0.10 jittered).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.calibrate import harness as jharness
from repro.calibrate import overlap as joverlap
from repro.core import collectives as jcol
from repro.core import hardware as jhw
from repro.core import numerics as jnum
from repro_torch.calibrate import harness as tharness
from repro_torch.calibrate import overlap as toverlap
from repro_torch.core import collectives as tcol
from repro_torch.core import hardware as thw
from repro_torch.core import numerics as tnum
from repro_torch.launch import overlap_bench as ob

PRESETS = sorted(jhw.PRESETS)
SIZES = [0, 1, 4096, 1 << 20, 3 * (1 << 22) + 8, 1 << 30]
PARTICIPANTS = [0, 1, 2, 3, 4, 5, 6, 8, 12, 16, 64, 256]


def _same_tree(a, b):
    """Dataclass trees equal field by field (a ``MemLevel`` of the copy
    is a different class from the original's)."""
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def _close(a, b, rel=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.all(np.abs(a - b) <= rel * np.maximum(np.abs(a), np.abs(b)))


def _nocs():
    return [getattr(jhw, n)().cluster_noc for n in PRESETS] \
        + [getattr(jhw, n)().core_noc for n in PRESETS] \
        + [jhw.tpu_v5e(mesh=(2, 4)).cluster_noc]


def _port_noc(noc):
    return thw.NoCParams(**dataclasses.asdict(noc))


@pytest.mark.parametrize("name", PRESETS)
def test_presets_field_by_field(name):
    j, t = getattr(jhw, name)(), getattr(thw, name)()
    assert _same_tree(j, t)
    assert [f.name for f in dataclasses.fields(j)] \
        == [f.name for f in dataclasses.fields(t)]
    assert j.peak_flops_total() == t.peak_flops_total()
    assert (j.num_clusters, j.cores_per_cluster, j.total_cores) \
        == (t.num_clusters, t.cores_per_cluster, t.total_cores)
    for lvl in ("DRAM", "GB", "OB"):
        assert j.spatial_fanout(lvl) == t.spatial_fanout(lvl)
        assert j.parent_of(lvl) == t.parent_of(lvl)
    # the port's presets are the original's and its own card, h100
    assert sorted(thw.PRESETS) == sorted([*jhw.PRESETS, "h100"])


@pytest.mark.parametrize("mesh", [(1, 1), (2, 4), (16, 16)])
def test_tpu_v5e_mesh(mesh):
    assert _same_tree(jhw.tpu_v5e(mesh=mesh), thw.tpu_v5e(mesh=mesh))


def test_apply_calibration_matches():
    fitted = dict(mesh=(3, 3), channel_width=64, channel_bandwidth=7e9,
                  t_router=3e-9, t_enq=4e-9)

    class Cal:                      # anything with a .params NoCParams
        pass

    for core_noc in (False, True):
        j = jhw.apply_calibration(jhw.edge(), jhw.NoCParams(**fitted),
                                  core_noc=core_noc)
        t = thw.apply_calibration(thw.edge(), thw.NoCParams(**fitted),
                                  core_noc=core_noc)
        assert _same_tree(j, t) and j.cluster_noc.t_enq == 4e-9
        cal = Cal()
        cal.params = thw.NoCParams(**fitted)
        assert _same_tree(thw.apply_calibration(thw.edge(), cal,
                                                core_noc=core_noc), t)
    assert _same_tree(thw.cloud(calibrated=None), jhw.cloud())


def test_calibration_path_is_not_ported_yet(tmp_path):
    """A ``calibrated=`` path now loads through the port's own
    ``calibrate/persist`` (the name predates its port, and is kept so
    that the test's record carries over): a missing file
    leaves the preset as the original's, a persisted one applies as it
    does there."""
    missing = tmp_path / "calibrated_noc.json"
    assert _same_tree(thw.edge(calibrated=str(missing)), jhw.edge())
    from repro_torch.calibrate import persist as tpersist
    from repro_torch.calibrate.fitter import fit_noc_params
    noc = dataclasses.replace(thw.edge().cluster_noc, mesh=(1, 8))
    sweep = tharness.run_sweep(tharness.synthetic_measure_fn(noc), [2, 4, 8])
    fit = fit_noc_params(sweep.points, noc)
    path = tpersist.save_calibration(tpersist.calibration_from_fit(
        fit, backend="synthetic", torch_version="synthetic"), missing)
    assert _same_tree(thw.edge(calibrated=str(path)),
                      jhw.edge(calibrated=str(path)))


def test_numerics_copy():
    for fn in ("ceil_div", "vmax", "vmin"):
        for a, b in ((7, 3), (3, 7), (np.arange(5), 2)):
            assert np.array_equal(getattr(jnum, fn)(a, b),
                                  getattr(tnum, fn)(a, b))
    m = np.array([True, False])
    assert np.array_equal(jnum.vwhere(m, 1, 2), tnum.vwhere(m, 1, 2))
    assert jnum.reduce_max([1, 5, 2]) == tnum.reduce_max([1, 5, 2])
    assert tnum.is_array(np.zeros(1)) and not tnum.is_array(1.0)


@pytest.mark.parametrize("col_type", jcol.COLLECTIVE_TYPES)
def test_collective_models_match(col_type):
    assert jcol.COLLECTIVE_TYPES == tcol.COLLECTIVE_TYPES
    for noc in _nocs():
        tnoc = _port_noc(noc)
        for dv in SIZES:
            for p in PARTICIPANTS:
                jc = jcol.collective_cost(col_type, dv, p, noc)
                tc = tcol.collective_cost(col_type, dv, p, tnoc)
                assert (jc.hops, jc.steps) == (tc.hops, tc.steps)
                assert _close(jc.volume_bytes, tc.volume_bytes)
                assert _close(jcol.collective_seconds(col_type, dv, p, noc),
                              tcol.collective_seconds(col_type, dv, p, tnoc))
                assert _close(
                    jcol.collective_overlap_terms(col_type, dv, p, noc),
                    tcol.collective_overlap_terms(col_type, dv, p, tnoc))
                for ov in (0.0, 0.5, 1.0):
                    assert _close(
                        jcol.overlapped_collective_seconds(
                            col_type, dv, p, noc, overlap=ov,
                            compute_seconds=1e-6),
                        tcol.overlapped_collective_seconds(
                            col_type, dv, p, tnoc, overlap=ov,
                            compute_seconds=1e-6))


@pytest.mark.parametrize("col_type", jcol.COLLECTIVE_TYPES)
def test_collective_array_path_matches(col_type):
    """Batched participants and data volumes: the factor-table gather."""
    ps = np.array(PARTICIPANTS)
    dvs = np.array(SIZES[:4], dtype=np.float64)[:, None]
    for noc in _nocs()[:3]:
        jc = jcol.collective_cost(col_type, dvs, ps, noc)
        tc = tcol.collective_cost(col_type, dvs, ps, _port_noc(noc))
        assert np.array_equal(jc.hops, tc.hops)
        assert np.array_equal(jc.steps, tc.steps)
        assert _close(jc.volume_bytes, tc.volume_bytes)
        assert _close(jcol.collective_latency_terms(col_type, dvs, ps, noc)[2],
                      tcol.collective_latency_terms(col_type, dvs, ps,
                                                    _port_noc(noc))[2])


def test_collective_cache_and_errors():
    tcol.collective_cache_clear()
    noc = thw.cloud().cluster_noc
    a = tcol.collective_cost("AllGather", 4096, 8, noc)
    assert a == tcol.collective_cost("AllGather", 4096, 8, noc)   # cached
    tcol.collective_cache_clear()
    assert a == tcol.collective_cost("AllGather", 4096, 8, noc)
    with pytest.raises(ValueError, match="unknown collective type"):
        tcol.collective_cost("AllSum", 4096, 8, noc)


def test_harness_names():
    assert tharness.CALIBRATED_TYPES == jharness.CALIBRATED_TYPES
    for args in ((1 << 12, 1 << 24, 6), (100, 100, 1), (4, 1 << 20, 9),
                 (1, 2, 0)):
        for multiple in (4, 32):
            assert tharness.log_sizes(*args, multiple=multiple) \
                == jharness.log_sizes(*args, multiple=multiple)


@pytest.mark.parametrize("true_overlap", [0.0, 0.35, 0.6, 1.0])
@pytest.mark.parametrize("jitter", [0.0, 0.05])
def test_fit_overlap_matches(true_overlap, jitter):
    noc = jhw.tpu_v5e().cluster_noc
    tnoc = thw.tpu_v5e().cluster_noc
    jp = joverlap.synthetic_concurrent_points(noc, true_overlap,
                                              jitter=jitter, seed=3)
    tp = toverlap.synthetic_concurrent_points(tnoc, true_overlap,
                                              jitter=jitter, seed=3)
    assert [dataclasses.asdict(p) for p in jp] \
        == [dataclasses.asdict(p) for p in tp]
    jf, tf = joverlap.fit_overlap(jp, noc), toverlap.fit_overlap(tp, tnoc)
    assert jf.to_json() == tf.to_json()
    assert [dataclasses.asdict(p) for p in jf.points] \
        == [dataclasses.asdict(p) for p in tf.points]
    for jq, tq in zip(jp, tp):
        assert joverlap.measured_hidden_fraction(jq, noc) \
            == toverlap.measured_hidden_fraction(tq, tnoc)
        assert joverlap.predicted_concurrent_seconds(jq, noc, 0.4) \
            == toverlap.predicted_concurrent_seconds(tq, tnoc, 0.4)
        assert toverlap.ConcurrentPoint.from_json(tq.to_json()) == tq


def test_fit_overlap_degenerate_sweeps():
    """One participant, or no usable time: overlap 0, degenerate, as the
    original; the bench's one-rank hidden fraction is this case."""
    noc = thw.tpu_v5e().cluster_noc
    one = toverlap.ConcurrentPoint("AllGather", 4096, 1, 1e-3, 1e-3, 1.5e-3)
    bad = toverlap.ConcurrentPoint("AllGather", 4096, 8, 1e-3, 0.0, 1e-3)
    for pts in ((one,), (bad,), ()):
        fit = toverlap.fit_overlap(pts, noc)
        assert fit.degenerate and fit.overlap == 0.0 and fit.n_points == 0
        jpts = [joverlap.ConcurrentPoint(**dataclasses.asdict(p))
                for p in pts]
        assert joverlap.fit_overlap(jpts, jhw.tpu_v5e().cluster_noc
                                    ).to_json() == fit.to_json()


def test_synthetic_recovery_bars():
    s = ob.synthetic_recovery()
    assert s["clean_err"] <= ob.OVERLAP_RECOVERY_TOL_CLEAN
    assert s["jittered_err"] <= ob.OVERLAP_RECOVERY_TOL_JITTER
    assert (ob.OVERLAP_RECOVERY_TOL_CLEAN, ob.OVERLAP_RECOVERY_TOL_JITTER,
            ob.KERNEL_AGREEMENT_TOL) == (0.01, 0.10, 1e-3)


def test_overlap_bench_runs_on_the_cpu():
    """run_all at tiny shapes in a one-rank gloo group: every time None (no
    device metric from a CPU run), the hidden fraction degenerate, every
    bar met, and the calls counted."""
    shapes = [(40, 128, 72, 4, torch.bfloat16), (24, 64, 40, 8,
                                                 torch.float32)]
    out = ob.run_all("cpu", shapes=shapes,
                     allgather_shape=(16, 64, 32, torch.bfloat16),
                     hidden_shape=(16, 64, 32), iters=2)
    assert out["ok"] and out["device"] == "cpu"
    a = out["allgather_gemm"]
    assert a["participants"] == 1 and a["backend"] == "gloo" \
        and a["max_abs_err"] == 0.0
    h = out["fused_gather_gemm"]
    assert h["degenerate"] and h["hidden_fraction"] is None
    assert all(h[k] is None for k in ("t_gather_s", "t_gemm_s",
                                      "t_concurrent_s"))
    recs = out["double_buffer"]
    assert [(r["shape"]["M"], r["shape"]["dtype"]) for r in recs] \
        == [(40, "bfloat16"), (24, "float32")]
    for r in recs:
        assert r["ok"] and r["speedup"] is None
        assert all(r[k] is None for k in ("ms", "ms_buffers1", "plain_ms",
                                          "library_ms"))
    # allgather 2 + 2 a shape
    assert out["calls"] == {"streamed_gemm": 2 + 2 * len(shapes)}
    assert not torch.distributed.is_initialized()     # the group is gone


def test_bench_shapes_are_the_full_width_and_budget_shapes():
    shapes = ob.BENCH_SHAPES
    assert shapes[0] == (4096, 4096, 13696, 4, torch.bfloat16)
    assert [s[:4] for s in shapes[1:]] == [
        (256, 4096, 512, 8), (128, 1024, 256, 8), (128, 512, 256, 4)]
    assert {s[4] for s in shapes[1:]} == {torch.float32}
