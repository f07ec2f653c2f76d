"""The port's calibration loop (repro_torch.calibrate) on the CPU.

- The matrix of tests/test_calibrate.py, run on the port: the sweep
  harness's fault matrix (raise / NaN / non-monotone mid-sweep degrade to
  a partial fit, one warning per cause), the fitter's ground-truth
  recovery (noise-free within 1%, jitter within 10%, degenerate sweeps),
  persistence (bit-identical roundtrip, stale provenance and mesh
  refused, corrupt file quarantined, NaN never persisted, missing file
  silent), the presets' ``calibrated=``, ``calibrate_once``'s reuse and
  the ``python -m repro_torch.calibrate --backend synthetic`` CLI.
- Across the packages: the same synthetic sweep gives equal points and
  bit-equal fits in both; a file the JAX package saved loads in the port,
  calibrates ``tpu_v5e`` as it does there and re-saves to the same bytes;
  ``calibrated=True`` raises ``TypeError`` in both (ROADMAP C.17).
- ``torch_measure_fn`` on 2 and 4 gloo ranks (tests/torch_calibrate_ranks.py
  by spawn in subprocesses with a timeout): every rank ends with the same
  points, each collective's result and each rank's element counts follow
  the DV convention, a ``participants`` mismatch raises on every rank
  with no hang; and the CLI's ``--backend gloo --ranks 2`` persists once,
  then reuses.
"""
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import warnings
from dataclasses import asdict, replace
from pathlib import Path

import numpy as np
import pytest

import faults
from repro.calibrate import fitter as jfitter
from repro.calibrate import harness as jharness
from repro.calibrate import persist as jpersist
from repro.core import hardware as jhw
from repro_torch.calibrate import (CALIBRATED_TYPES, Calibration,
                                   MeasuredPoint, SweepConfig,
                                   calibrate_once, calibration_from_fit,
                                   fit_noc_params, load_calibration,
                                   log_sizes, relative_errors, run_sweep,
                                   save_calibration, synthetic_measure_fn)
from repro_torch.calibrate import harness as harness_mod
from repro_torch.calibrate import persist as persist_mod
from repro_torch.core.collectives import (collective_cost,
                                          collective_latency_terms,
                                          collective_seconds, noc_latency)
from repro_torch.core.hardware import apply_calibration, tpu_v5e
from repro_torch.launch import moe_dispatch
from repro_torch.launch.costmodel_compare import _pearson

ROOT = Path(__file__).resolve().parents[1]
REF = replace(tpu_v5e().cluster_noc, mesh=(1, 8))
JREF = replace(jhw.tpu_v5e().cluster_noc, mesh=(1, 8))
FAST = SweepConfig(n_sizes=4, iters=2, warmup=0)
RANKS_TIMEOUT = 180
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


@pytest.fixture(autouse=True)
def _fresh_warn_state():
    """Per-test warn-once registries (production semantics are
    per-process; tests assert per-cause counts)."""
    harness_mod._reset_warned()
    jharness._reset_warned()
    yield
    harness_mod._reset_warned()
    jharness._reset_warned()


def _rel(a, b):
    return abs(a - b) / abs(b)


def _worst_err(fit, true):
    p = fit.params
    return max(_rel(p.channel_bandwidth, true.channel_bandwidth),
               _rel(p.t_router, true.t_router), _rel(p.t_enq, true.t_enq))


def _cal_warnings(rec):
    return [w for w in rec if issubclass(w.category, RuntimeWarning)]


# --------------------------------------------------------------- harness


def test_log_sizes_ascending_dedup_multiple():
    sizes = log_sizes(1 << 12, 1 << 24, 8, multiple=4 * 8 * 8)
    assert sizes == sorted(set(sizes))
    assert all(s % (4 * 8 * 8) == 0 for s in sizes)
    assert sizes[0] >= 256 and sizes[-1] >= (1 << 24) - 4 * 8 * 8
    assert len(sizes) == 8


def test_log_sizes_edges():
    assert log_sizes(1024, 4096, 0) == []
    assert log_sizes(1024, 4096, 1, multiple=4) == [4096]
    assert log_sizes(64, 128, 10, multiple=64) == [64, 128]


def test_sweep_full_grid_no_faults():
    sweep = run_sweep(synthetic_measure_fn(REF), [2, 4, 8], config=FAST)
    assert sweep.dropped == {}
    assert len(sweep.points) == len(CALIBRATED_TYPES) * 3 * FAST.n_sizes
    assert sweep.participants == (2, 4, 8)
    assert all(p.seconds > 0 for p in sweep.points)


def test_sweep_accepts_single_participant_count():
    sweep = run_sweep(synthetic_measure_fn(REF), 8, config=FAST)
    assert sweep.participants == (8,)
    assert {p.participants for p in sweep.points} == {8}


@pytest.mark.parametrize("mode,cause", [("raise", "error"),
                                        ("nan", "not-finite"),
                                        ("tiny", "non-monotone")])
def test_sweep_fault_degrades_with_one_warning(mode, cause):
    mf = faults.faulty_measure_fn(synthetic_measure_fn(REF),
                                  fail_at=range(4, 8), mode=mode)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        sweep = run_sweep(mf, 8, config=FAST)
    assert sweep.dropped.get(cause, 0) >= 1
    full = len(CALIBRATED_TYPES) * FAST.n_sizes
    assert 0 < len(sweep.points) < full
    assert len(_cal_warnings(rec)) == 1          # one per cause, not per point
    fit = fit_noc_params(sweep.points, REF)
    assert not fit.degenerate
    assert _worst_err(fit, REF) < 0.01


def test_sweep_ends_on_a_collective_failure():
    """Any other error drops its point; a ``CollectiveFailure`` (the real
    backend's ranks out of lock step) ends the sweep."""
    calls = []

    def measure(col_type, dv_bytes, participants):
        calls.append(col_type)
        if len(calls) == 1:
            raise OSError("dropped")
        raise harness_mod.CollectiveFailure("ended")

    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        with pytest.raises(harness_mod.CollectiveFailure, match="ended"):
            run_sweep(measure, 8, config=FAST)
    assert calls == ["AllReduce", "AllReduce"]


def test_sweep_two_causes_two_warnings():
    inner = synthetic_measure_fn(REF)

    def mf(ct, dv, p):
        t = inner(ct, dv, p)
        if ct == "AllGather":
            raise RuntimeError("boom")
        if ct == "AllToAll":
            return float("inf")
        return t

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        sweep = run_sweep(mf, 8, config=FAST)
    assert sweep.dropped["error"] == FAST.n_sizes
    assert sweep.dropped["not-finite"] == FAST.n_sizes
    assert len(_cal_warnings(rec)) == 2


def test_warn_once_reset_hook():
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        harness_mod._warn_once(("x",), "first")
        harness_mod._warn_once(("x",), "suppressed")
        harness_mod._reset_warned()
        harness_mod._warn_once(("x",), "again")
    assert len(rec) == 2


@pytest.mark.parametrize("col_type", CALIBRATED_TYPES)
@pytest.mark.parametrize("P", [1, 2, 3, 4, 8])
def test_dv_elements_are_the_jax_shards(col_type, P):
    """Each rank's input and output elements are the JAX backend's shards:
    the global array of ``jax_measure_fn`` split over P devices."""
    for dv in log_sizes(1 << 12, 1 << 20, 5, multiple=4 * P * P) + [12, 4]:
        elems = max(1, dv // 4)
        elems = max(1, elems // (P * P)) * P * P
        glob = elems if col_type == "AllGather" else elems * P
        out = {"AllReduce": elems, "AllGather": elems,
               "ReduceScatter": glob // P // P, "AllToAll": glob // P}
        assert harness_mod.dv_elements(col_type, dv, P) \
            == (glob // P, out[col_type])


# ---------------------------------------------------------------- fitter


def test_noise_free_recovery_pow2():
    sweep = run_sweep(synthetic_measure_fn(REF), [2, 4, 8])
    fit = fit_noc_params(sweep.points, REF)
    assert _worst_err(fit, REF) < 1e-9
    assert fit.max_rel_err < 1e-9
    assert not fit.identifiable          # split came from the reference


def test_noise_free_recovery_non_pow2():
    true = replace(REF, mesh=(1, 7), t_router=3e-8, t_enq=2e-9)
    sweep = run_sweep(synthetic_measure_fn(true), [3, 5, 7], config=FAST)
    fit = fit_noc_params(sweep.points, true)
    assert _worst_err(fit, true) < 0.01


def test_jitter_recovery_within_10pct():
    sweep = run_sweep(synthetic_measure_fn(REF, jitter=0.03, seed=11),
                      [2, 4, 8])
    fit = fit_noc_params(sweep.points, REF)
    assert _worst_err(fit, REF) < 0.10
    assert fit.max_rel_err < 0.10


def test_degenerate_single_participant():
    pts = [MeasuredPoint("AllReduce", 4096 * i, 1, 1e-6 * i)
           for i in range(1, 6)]
    fit = fit_noc_params(pts, REF)
    assert fit.degenerate
    assert fit.params == REF


def test_degenerate_too_few_points():
    fit = fit_noc_params([], REF)
    assert fit.degenerate and fit.params == REF
    one = [MeasuredPoint("AllReduce", 65536, 8, 1e-4)]
    assert fit_noc_params(one, REF).degenerate


def test_per_type_diagnostics_and_residuals():
    sweep = run_sweep(synthetic_measure_fn(REF, jitter=0.02, seed=5),
                      [2, 4, 8])
    fit = fit_noc_params(sweep.points, REF)
    assert {t.col_type for t in fit.per_type} == set(CALIBRATED_TYPES)
    assert len(fit.residuals) == fit.n_points
    assert all(math.isfinite(r) for r in fit.residuals)
    assert fit.max_rel_err >= fit.median_rel_err >= 0.0
    res = relative_errors(fit.points, fit.params)
    assert max(abs(r) for r in res) == pytest.approx(fit.max_rel_err)


# ------------------------------------------------------ across packages


SWEEPS = [((2, 4, 8), 0.0, 0, None), ((2, 4, 8), 0.03, 11, None),
          ((3, 5, 7), 0.02, 5, FAST), ((2, 7, 8), 0.1, 3, FAST)]


@pytest.mark.parametrize("ps,jitter,seed,cfg", SWEEPS)
def test_sweep_and_fit_bit_equal_to_jax(ps, jitter, seed, cfg):
    """The same synthetic sweep gives equal points in both packages'
    ``run_sweep``, and ``fit_noc_params`` gives bit-equal params,
    residuals and per-type fits."""
    jcfg = None if cfg is None else jharness.SweepConfig(**asdict(cfg))
    js = jharness.run_sweep(jharness.synthetic_measure_fn(
        JREF, jitter=jitter, seed=seed), list(ps), config=jcfg)
    ts = run_sweep(synthetic_measure_fn(REF, jitter=jitter, seed=seed),
                   list(ps), config=cfg)
    assert [asdict(p) for p in ts.points] == [asdict(p) for p in js.points]
    assert ts.dropped == js.dropped and ts.participants == js.participants
    jf = jfitter.fit_noc_params(js.points, JREF)
    tf = fit_noc_params(ts.points, REF)
    assert asdict(tf.params) == asdict(jf.params)
    assert tf.residuals == jf.residuals
    assert [t.to_json() for t in tf.per_type] \
        == [t.to_json() for t in jf.per_type]
    assert (tf.max_rel_err, tf.median_rel_err, tf.degenerate,
            tf.identifiable) == (jf.max_rel_err, jf.median_rel_err,
                                 jf.degenerate, jf.identifiable)
    assert list(relative_errors(ts.points, tf.params)) \
        == list(jfitter.relative_errors(js.points, jf.params))


def test_jax_written_calibration_loads_in_the_port(tmp_path):
    """A ``calibrated_noc.json`` the JAX package saved: the port loads it,
    calibrates ``tpu_v5e`` as the JAX package does, and re-saves it to
    the same bytes; a loader that expects a torch version refuses it."""
    js = jharness.run_sweep(jharness.synthetic_measure_fn(JREF, jitter=0.02),
                            [2, 4, 8], config=jharness.SweepConfig(n_sizes=4))
    jcal = jpersist.calibration_from_fit(
        jfitter.fit_noc_params(js.points, JREF), backend="cpu",
        jax_version="0.9.0", now=lambda: 7.0)
    path = jpersist.save_calibration(jcal, tmp_path / "jax.json")
    cal = load_calibration(path)
    assert cal is not None and asdict(cal.params) == asdict(jcal.params)
    assert persist_mod.save_calibration(cal, tmp_path / "port.json"
                                        ).read_bytes() == path.read_bytes()
    assert asdict(tpu_v5e(calibrated=str(path)).cluster_noc) \
        == asdict(jhw.tpu_v5e(calibrated=str(path)).cluster_noc)
    assert tpu_v5e(calibrated=path).cluster_noc.channel_bandwidth \
        == jcal.params.channel_bandwidth
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert load_calibration(path, expect={"torch_version": "2.13.0"}) \
            is None
    assert "torch_version" in str(_cal_warnings(rec)[0].message)
    # the port's own file the other way: the JAX loader applies it too
    tcal = _make_cal()
    tpath = save_calibration(tcal, tmp_path / "torch.json")
    assert asdict(jhw.tpu_v5e(calibrated=str(tpath)).cluster_noc) \
        == asdict(tpu_v5e(calibrated=str(tpath)).cluster_noc)


def test_calibrated_true_raises_as_the_reference_does(tmp_path):
    """ROADMAP C.17: a bare ``--calibrated`` hands ``True`` to the
    presets; both packages raise the same ``TypeError``.  A store root
    (a directory) applies nothing in either, silently."""
    with pytest.raises(TypeError) as jexc:
        jhw.tpu_v5e(calibrated=True)
    with pytest.raises(TypeError) as texc:
        tpu_v5e(calibrated=True)
    assert str(texc.value) == str(jexc.value)
    save_calibration(_make_cal(jitter=0.02), tmp_path / "calibrated_noc.json")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert tpu_v5e(calibrated=str(tmp_path)).signature() \
            == tpu_v5e().signature()
        assert jhw.tpu_v5e(calibrated=str(tmp_path)).signature() \
            == jhw.tpu_v5e().signature()
    assert _cal_warnings(rec) == []


def test_moe_dispatch_on_a_calibration_file_matches_jax(tmp_path, capsys):
    path = save_calibration(_make_cal(jitter=0.02), tmp_path / "c.json")
    spec = importlib.util.spec_from_file_location(
        "jax_front_moe_dispatch", ROOT / "benchmarks" / "moe_dispatch.py")
    jmoe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmoe)
    want = jmoe.run_all(["tpu_v5e", "cloud"], calibrated=str(path))
    got = moe_dispatch.run_all(["tpu_v5e", "cloud"], calibrated=str(path))
    assert got == want
    assert got != moe_dispatch.run_all(["tpu_v5e", "cloud"])
    capsys.readouterr()


# ----------------------------------------------------------- persistence


def _make_cal(jitter=0.0, **prov):
    sweep = run_sweep(synthetic_measure_fn(REF, jitter=jitter), [2, 4, 8],
                      config=FAST)
    fit = fit_noc_params(sweep.points, REF)
    kw = dict(backend="synthetic", torch_version="testver", now=lambda: 123.0)
    kw.update(prov)
    return calibration_from_fit(fit, **kw)


def test_roundtrip_bit_identical(tmp_path):
    cal = _make_cal()
    p1 = save_calibration(cal, tmp_path / "a.json")
    loaded = load_calibration(p1)
    assert loaded is not None
    p2 = save_calibration(loaded, tmp_path / "b.json")
    assert p1.read_bytes() == p2.read_bytes()
    assert loaded.params == cal.params
    assert loaded.points == cal.points
    assert loaded.provenance == cal.provenance
    assert json.loads(p1.read_bytes())["schema"] == "repro/calibrated-noc/v1"


def test_stale_provenance_refused(tmp_path):
    path = save_calibration(_make_cal(), tmp_path / "c.json")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = load_calibration(path, expect={"backend": "synthetic",
                                             "mesh": (1, 8),
                                             "torch_version": "OTHER"})
    assert got is None
    msgs = [str(w.message) for w in _cal_warnings(rec)]
    assert len(msgs) == 1 and "stale" in msgs[0]
    assert "repro_torch.calibrate" in msgs[0]     # actionable: names the fix
    assert load_calibration(path, expect={"backend": "synthetic",
                                          "mesh": (1, 8),
                                          "torch_version": "testver"})


def test_stale_mesh_refused(tmp_path):
    path = save_calibration(_make_cal(), tmp_path / "d.json")
    assert load_calibration(path, expect={"mesh": (4, 4)}) is None


def test_corrupt_file_quarantined(tmp_path):
    path = save_calibration(_make_cal(), tmp_path / "e.json")
    faults.torn_file(path, keep=0.4)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = load_calibration(path)
    assert got is None
    assert not path.exists()
    assert (tmp_path / "corrupt" / "e.json").exists()
    msgs = [str(w.message) for w in _cal_warnings(rec)]
    assert len(msgs) == 1 and "quarantined" in msgs[0]


def test_nan_residuals_never_persisted(tmp_path):
    cal = _make_cal()
    bad = Calibration(params=cal.params, provenance=cal.provenance,
                      per_type=cal.per_type, points=cal.points,
                      residuals=cal.residuals + (float("nan"),),
                      max_rel_err=cal.max_rel_err,
                      median_rel_err=cal.median_rel_err)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = save_calibration(bad, tmp_path / "f.json")
    assert out is None
    assert list(tmp_path.iterdir()) == []         # not even a tmp file
    assert len(_cal_warnings(rec)) == 1


def test_missing_file_is_silent(tmp_path):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert load_calibration(tmp_path / "nope.json") is None
        assert tpu_v5e(calibrated=tmp_path / "nope.json").signature() \
            == tpu_v5e().signature()
    assert _cal_warnings(rec) == []


def test_calibration_path_resolution(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "store"))
    assert persist_mod.calibration_path() \
        == jpersist.calibration_path() \
        == tmp_path / "store" / "calibrated_noc.json"
    assert persist_mod.calibration_path(str(tmp_path)) \
        == tmp_path / "calibrated_noc.json"


# ------------------------------------------------- arch override / model


def test_apply_calibration_and_preset_kwarg(tmp_path):
    path = save_calibration(_make_cal(), tmp_path / "g.json")
    base = tpu_v5e()
    cal = load_calibration(path)
    patched = apply_calibration(base, cal)
    assert patched.cluster_noc.channel_bandwidth == \
        cal.params.channel_bandwidth
    assert patched.cluster_noc.mesh == base.cluster_noc.mesh  # geometry kept
    assert patched.core_noc == base.core_noc
    assert patched.signature() != base.signature()
    assert tpu_v5e(calibrated=str(path)).cluster_noc == patched.cluster_noc
    assert tpu_v5e(calibrated=cal.params).cluster_noc == patched.cluster_noc
    with_core = apply_calibration(base, cal, core_noc=True)
    assert with_core.core_noc.channel_bandwidth == \
        cal.params.channel_bandwidth


def test_apply_calibration_none_is_identity():
    base = tpu_v5e()
    assert apply_calibration(base, None) is base
    assert tpu_v5e(calibrated=None).signature() == base.signature()


def test_collective_latency_terms_matches_model():
    cc, mem_lat, lat = collective_latency_terms("AllReduce", 1 << 20, 8, REF)
    assert cc.volume_bytes == collective_cost("AllReduce", 1 << 20, 8,
                                              REF).volume_bytes
    assert mem_lat == pytest.approx(cc.volume_bytes / REF.channel_bandwidth)
    assert lat == pytest.approx(mem_lat + noc_latency(cc, REF))
    assert collective_seconds("AllReduce", 1 << 20, 8, REF) == lat


# ----------------------------------------------------- _pearson edge case


def test_pearson_degenerate_series_return_zero():
    assert _pearson([], []) == 0.0
    assert _pearson([1.0], [1.0]) == 0.0
    assert _pearson([2.0, 2.0, 2.0], [1.0, 2.0, 3.0]) == 0.0
    assert _pearson([1.0, 2.0, 3.0], [5.0, 5.0, 5.0]) == 0.0


def test_pearson_correlated_series():
    assert _pearson([1.0, 2.0, 3.0], [2.0, 4.0, 6.0]) == pytest.approx(1.0)
    assert _pearson([1.0, 2.0, 3.0], [3.0, 2.0, 1.0]) == pytest.approx(-1.0)


# ------------------------------------------------------------ driver/CLI


def test_calibrate_once_reuse_semantics(tmp_path):
    kw = dict(backend="synthetic", torch_version="testver",
              store=str(tmp_path), config=FAST, now=lambda: 99.0)
    s1 = calibrate_once(synthetic_measure_fn(REF), REF, [2, 4, 8], **kw)
    assert s1["fits_solved"] == 1 and not s1["reused"]
    assert s1["persisted"] and s1["gate_ok"]
    store_file = tmp_path / "calibrated_noc.json"
    bytes1 = store_file.read_bytes()
    s2 = calibrate_once(synthetic_measure_fn(REF), REF, [2, 4, 8], **kw)
    assert s2["reused"] and s2["fits_solved"] == 0
    assert store_file.read_bytes() == bytes1      # untouched, bit-identical
    assert [p.name for p in tmp_path.iterdir()] == ["calibrated_noc.json"]
    s3 = calibrate_once(synthetic_measure_fn(REF), REF, [2, 4, 8],
                        force=True, **kw)
    assert s3["fits_solved"] == 1
    assert set(s1) == set(s3) and set(s2) < set(s1)


def test_calibrate_group_decides_reuse_once(tmp_path, monkeypatch):
    """On a group, rank 0 loads the persisted file once and returns the
    summary of what it loaded: a second load that disagreed (the file
    replaced in between) could have rank 0 sweep alone."""
    import torch
    import torch.distributed as dist

    from repro_torch.calibrate import driver
    fit = fit_noc_params(run_sweep(synthetic_measure_fn(REF), [2, 4, 8],
                                   config=FAST).points, REF)
    cal = calibration_from_fit(fit, backend="gloo",
                               torch_version=torch.__version__)
    cal = replace(cal, params=replace(cal.params, mesh=(1, 1)),
                  provenance=dict(cal.provenance, mesh=[1, 1]))
    save_calibration(cal, tmp_path / "calibrated_noc.json")
    loads = []

    def load_once(*args, **kwargs):
        loads.append(args)
        return load_calibration(*args, **kwargs) if len(loads) == 1 \
            else None

    def no_sweep(*args, **kwargs):
        raise AssertionError("swept although the file was reused")

    monkeypatch.setattr(driver, "load_calibration", load_once)
    monkeypatch.setattr(driver, "run_sweep", no_sweep)
    monkeypatch.setattr(harness_mod, "run_sweep", no_sweep)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        s = driver.calibrate_group(tpu_v5e().cluster_noc, backend="gloo",
                                   store=str(tmp_path))
    finally:
        dist.destroy_process_group()
    assert len(loads) == 1
    assert s["reused"] and s["fits_solved"] == 0 and s["persisted"]
    assert s["params"]["t_router"] == fit.params.t_router
    assert s["path"] == str(tmp_path / "calibrated_noc.json")


def test_cli_exits_3_when_a_rank_fails(tmp_path, monkeypatch, capsys):
    from repro_torch.calibrate import __main__ as cli

    def fail(args):
        raise harness_mod.CollectiveFailure("rank 1: AllReduce failed")

    monkeypatch.setattr(cli, "_group_summary", fail)
    assert cli.main(["--backend", "gloo", "--store", str(tmp_path),
                     "--json"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "rank 1: AllReduce failed" in out.err
    assert list(tmp_path.iterdir()) == []


def test_calibrate_once_degenerate_persists_nothing(tmp_path):
    mf = faults.faulty_measure_fn(synthetic_measure_fn(REF),
                                  fail_at=range(10_000))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        s = calibrate_once(mf, REF, 8, backend="synthetic",
                           torch_version="testver", store=str(tmp_path),
                           config=FAST)
    assert s["degenerate"] and not s["persisted"] and not s["gate_ok"]
    assert not (tmp_path / "calibrated_noc.json").exists()
    assert any("degenerate" in str(w.message) for w in _cal_warnings(rec))


def _cli(args, timeout=RANKS_TIMEOUT):
    return subprocess.run([sys.executable, "-m", "repro_torch.calibrate",
                           *args], env=ENV, cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)


def test_cli_end_to_end(tmp_path):
    cmd = ["--backend=synthetic", "--store", str(tmp_path), "--sizes=4",
           "--json"]
    r1 = _cli(cmd)
    assert r1.returncode == 0, r1.stderr
    s1 = json.loads(r1.stdout)
    assert s1["fits_solved"] == 1 and s1["gate_ok"]
    store_file = tmp_path / "calibrated_noc.json"
    bytes1 = store_file.read_bytes()
    prov = json.loads(bytes1)["provenance"]
    assert prov["torch_version"] == "synthetic" and prov["mesh"] == [1, 8]
    r2 = _cli(cmd)
    s2 = json.loads(r2.stdout)
    assert r2.returncode == 0
    assert s2["reused"] and s2["fits_solved"] == 0
    assert store_file.read_bytes() == bytes1


def test_cli_nccl_raises_without_a_gpu(tmp_path):
    import torch

    from repro_torch.calibrate.__main__ import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the nccl backend runs")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        main(["--store", str(tmp_path)])
    assert list(tmp_path.iterdir()) == []


def test_cli_gloo_persists_once_then_reuses(tmp_path):
    cmd = ["--backend", "gloo", "--ranks", "2", "--store", str(tmp_path),
           "--max-bytes", "65536", "--sizes", "3", "--iters", "2", "--json"]
    r1 = _cli(cmd)
    assert r1.returncode in (0, 1), r1.stderr[-3000:]   # the gate measures
    s1 = json.loads(r1.stdout)
    assert s1["fits_solved"] == 1 and s1["persisted"]
    assert not s1["degenerate"]
    assert s1["n_points"] + s1["n_dropped"] == 12
    assert all(math.isfinite(v) and v > 0 for k, v in s1["params"].items()
               if k != "mesh")
    store_file = tmp_path / "calibrated_noc.json"
    bytes1 = store_file.read_bytes()
    prov = json.loads(bytes1)["provenance"]
    assert prov["backend"] == "gloo" and prov["mesh"] == [1, 2]
    assert prov["participants"] == [2]
    r2 = _cli(cmd)
    s2 = json.loads(r2.stdout)
    assert s2["reused"] and s2["fits_solved"] == 0
    assert r2.returncode == r1.returncode
    assert store_file.read_bytes() == bytes1
    assert tpu_v5e(calibrated=store_file).cluster_noc.t_router \
        == s1["params"]["t_router"]


# ---------------------------------------------------- gloo ranks (spawn)


@pytest.fixture(scope="module")
def gloo_worlds(tmp_path_factory):
    """tests/torch_calibrate_ranks.py at worlds 2 and 4, and at world 2
    with a rank that fails (under ``"fail"``: its exit code, its errors,
    and the seconds from the failure to the end of the run), side by
    side."""
    script = ROOT / "tests" / "torch_calibrate_ranks.py"
    dirs, procs = {}, {}
    for world, extra in ((2, []), (4, []), ("fail", ["fail"])):
        d = tmp_path_factory.mktemp(f"calibrate{world}")
        dirs[world] = d
        procs[world] = subprocess.Popen(
            [sys.executable, str(script), str(2 if extra else world),
             str(d), *extra], cwd=d,
            env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    fail = procs.pop("fail")
    try:
        _, err = fail.communicate(timeout=RANKS_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail.kill()
        _, err = fail.communicate()
    failed_at = dirs["fail"] / "failed_at"
    failed = {"rc": fail.returncode, "err": err,
              "seconds": (time.time() - float(failed_at.read_text())
                          if failed_at.exists() else None)}
    errors = {}
    for world, p in procs.items():
        try:
            _, err = p.communicate(timeout=RANKS_TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            errors[world] = "timed out (a rank hung)\n" + err[-3000:]
            continue
        if p.returncode:
            errors[world] = err[-3000:]
    assert not errors, errors
    worlds = {w: [(json.loads((d / f"r{r}.json").read_text()),
                   dict(np.load(d / f"r{r}.npz"))) for r in range(w)]
              for w, d in dirs.items() if w != "fail"}
    worlds["fail"] = failed
    return worlds


def test_a_failed_collective_ends_the_run(gloo_worlds):
    """A rank whose timed call fails past the checks ends the run with a
    ``CollectiveFailure`` (the sweep does not drop the point and go on
    out of lock step), and its peer, waiting in the collective, is ended
    with it well before gloo's timeout would end it."""
    from torch_calibrate_ranks import RANK_TIMEOUT_S
    failed = gloo_worlds["fail"]
    assert failed["rc"] != 0
    assert "CollectiveFailure: rank 1: AllReduce@256B over 2 ranks " \
        "failed: OSError('clock failed')" in failed["err"]
    assert "went on past" not in failed["err"]
    assert failed["seconds"] is not None
    assert failed["seconds"] < RANK_TIMEOUT_S / 2


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_ends_with_the_same_points(gloo_worlds, world):
    """The same points and the same drops on every rank: a loaded CPU can
    make a real time non-monotone, and then every rank drops it."""
    metas = [m for m, _ in gloo_worlds[world]]
    assert all(m["points"] == metas[0]["points"] for m in metas)
    assert all(m["dropped"] == metas[0]["dropped"] for m in metas)
    pts, dropped = metas[0]["points"], metas[0]["dropped"]
    assert set(dropped) <= {"non-monotone"}
    assert len(pts) + sum(dropped.values()) == len(CALIBRATED_TYPES) * 3
    assert {p["participants"] for p in pts} == {world}
    assert all(p["seconds"] > 0 for p in pts)
    # the max over the ranks: rank r's windows last (r + 1) ms
    for m in metas:
        assert m["fake_seconds"] == [world * 1e-3] * len(CALIBRATED_TYPES) * 3


@pytest.mark.parametrize("world", [2, 4])
def test_collective_results_and_dv_shards(gloo_worlds, world):
    """Each rank's buffers hold the DV convention's element counts, and
    each collective's last result is the sum or the blocks its inputs
    (rank r's: r * n + arange(n)) give."""
    P = world
    sizes = log_sizes(256, 16384, 3, multiple=4 * P * P)
    for rank, (meta, arrays) in enumerate(gloo_worlds[world]):
        want_keys = set()
        # the sweep's points, and the All-Reduce after the refused calls
        for ct, dv in [(ct, dv) for ct in CALIBRATED_TYPES
                       for dv in sizes] + [("AllReduce", 4096)]:
            elems = dv // 4
            n_in = elems // P if ct == "AllGather" else elems
            n_out = {"AllGather": elems, "ReduceScatter": elems // P
                     }.get(ct, elems)
            key = f"{ct}_{n_in}"
            want_keys.add(key)
            assert meta["buffers"][key] == [n_in, n_out]
            out = arrays[key]
            i = np.arange(n_out, dtype=np.float64)
            base = n_in * P * (P - 1) / 2
            m = n_in // P
            if ct == "AllReduce":
                want = base + P * i
            elif ct == "AllGather":
                want = i
            elif ct == "ReduceScatter":
                want = base + P * (rank * m + i)
            else:
                s, j = np.divmod(np.arange(n_out), m)
                want = s * n_in + rank * m + j
            np.testing.assert_array_equal(out, want.astype(np.float32))
        assert set(meta["buffers"]) == want_keys


@pytest.mark.parametrize("world", [2, 4])
def test_participants_mismatch_raises_on_every_rank(gloo_worlds, world):
    for meta, _ in gloo_worlds[world]:
        assert len(meta["errors"]) == 2
        assert f"participants={world + 1}" in meta["errors"][0]
        assert "'Gather'" in meta["errors"][1]
        assert meta["bad_points"] == 0
        assert meta["bad_dropped"] == {"error": 4 * 3}
        assert meta["after"] > 0               # the group still runs
