"""The port's copy of the COMET core (``repro_torch.core``) against the JAX
package's (``repro.core``): the same workloads, MappingSpecs and searches
on numpy-seeded inputs give bit-equal latency, energy and headroom
(``==``, not close: the copies run the same arithmetic), in the per-spec
tree path and the batched grid path, on every preset both packages have;
and the port's own card preset, ``h100``.

No plan cache is read here: results are compared directly, so a plan the
other package stored can never answer for this one.
"""
import dataclasses
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro.core import batcheval as jbe
from repro.core import hardware as jhw
from repro.core import ir as jir
from repro.core import search as jsearch
from repro.core import workload as jwl
from repro_torch.core import batcheval as tbe
from repro_torch.core import hardware as thw
from repro_torch.core import ir as tir
from repro_torch.core import search as tsearch
from repro_torch.core import workload as twl

ROOT = Path(__file__).resolve().parents[1]
PRESETS = sorted(jhw.PRESETS)
# the compound ops of tests/test_comet_core.py and tests/test_batcheval.py
# at their small sizes: (builder, args)
OPS = [
    ("gemm", (128, 256, 64)),
    ("gemm_softmax", (512, 1024, 128)),
    ("gemm_layernorm", (512, 4096, 128)),
    ("attention", (1024, 256, 1024, 256)),
    ("attention", (1, 128, 1024, 128)),
    ("flash_attention", (2048, 256, 2048, 256)),
    ("gemm_softmax", (509, 769, 127)),
    ("attention", (769, 127, 769, 127)),
]
SSD = dict(S=1024, H=1, P=64, Dst=128)
VARIANTS = {"gemm": ("unfused", "fused_epilogue", "fused_std",
                     "fused_dist"),
            "gemm_softmax": ("unfused", "fused_epilogue", "fused_std",
                             "fused_dist"),
            "gemm_layernorm": ("unfused", "fused_epilogue", "fused_std",
                               "fused_dist"),
            "attention": ("ua", "pfa", "fa"),
            "flash_attention": ("fa",),
            "ssd_chunk": ("fused_dist",)}


def _ops(name, args):
    return getattr(jwl, name)(*args), getattr(twl, name)(*args)


def _specs(mod, variants, dims, n, seed):
    """``n`` MappingSpecs of ``mod`` (either package's ``ir``) drawn from a
    numpy generator seeded with ``seed``: tile counts up to each dim,
    fanouts, schedule, collective granularity and overlap."""
    rng = np.random.default_rng(seed)
    M = dims.get("M", dims.get("Cq", 1))
    K = dims.get("K", dims.get("Ds", 1))
    N = dims.get("N", 1)
    out = []
    for _ in range(n):
        out.append(mod.MappingSpec(
            variant=str(rng.choice(variants)),
            m_tiles=int(rng.integers(1, max(2, M) + 1)),
            k_tiles=int(rng.integers(1, max(2, K) + 1)),
            n_tiles=int(rng.integers(1, max(2, N) + 1)),
            sp_cluster=int(rng.choice([0, 1, 2, 4, 16])),
            sp_core=int(rng.choice([0, 1, 2, 4])),
            schedule=str(rng.choice(["sequential", "pipelined"])),
            collective_gran=str(rng.choice(["tile", "stats"])),
            overlap=float(rng.choice([0.0, 0.5, 1.0]))))
    return out


def _per_spec(ir, co, arch, spec):
    try:
        r = ir.evaluate_mapping(co, arch, spec)
    except (ValueError, KeyError) as e:
        return type(e).__name__
    return (r.latency, r.energy_pj, r.headroom, r.valid,
            sorted(r.headroom_levels.items()))


def _batched(be, co, arch, specs, variant):
    br = be.evaluate_specs_batch(
        co, arch, be.Topology(variant=variant),
        [s.m_tiles for s in specs], [s.k_tiles for s in specs],
        [s.n_tiles for s in specs], [s.sp_cluster for s in specs],
        [s.sp_core for s in specs], [s.schedule for s in specs],
        [s.overlap for s in specs])
    return (br.latency.tolist(), br.energy_pj.tolist(),
            br.headroom.tolist(), br.valid.tolist())


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("name,args", OPS + [("ssd_chunk", ())],
                         ids=[f"{n}{'x'.join(map(str, a))}"
                              for n, a in OPS] + ["ssd_chunk"])
def test_same_spec_same_cost_on_every_preset(preset, name, args):
    """The per-spec path (``evaluate_mapping``) and the batched path
    (``evaluate_specs_batch``) give bit-equal latency, energy and headroom
    in both packages for the same MappingSpecs."""
    if name == "ssd_chunk":
        jco, tco = jwl.ssd_chunk(C=64, **SSD), twl.ssd_chunk(C=64, **SSD)
    else:
        jco, tco = _ops(name, args)
    ja, ta = getattr(jhw, preset)(), getattr(thw, preset)()
    variants = VARIANTS[name]
    jspecs = _specs(jir, variants, jco.dim_sizes, 12, seed=len(args))
    tspecs = _specs(tir, variants, tco.dim_sizes, 12, seed=len(args))
    for js, ts in zip(jspecs, tspecs):
        assert dataclasses.asdict(js) == dataclasses.asdict(ts)
        assert _per_spec(jir, jco, ja, js) == _per_spec(tir, tco, ta, ts)
    for v in variants:
        jv = [s for s in jspecs if s.variant == v]
        tv = [s for s in tspecs if s.variant == v]
        if jv:
            assert _batched(jbe, jco, ja, jv, v) \
                == _batched(tbe, tco, ta, tv, v)


@pytest.mark.parametrize("arch", ["edge", "cloud"])
@pytest.mark.parametrize("name,args", OPS[1:6],
                         ids=[f"{n}{'x'.join(map(str, a))}"
                              for n, a in OPS[1:6]])
def test_search_same_best_spec_and_latency(arch, name, args):
    """``search()`` (exhaustive over the whole map space, then the
    randomized search of tests/test_comet_core.py) picks the same spec at
    the same latency in both packages."""
    jco, tco = _ops(name, args)
    ja, ta = getattr(jhw, arch)(), getattr(thw, arch)()
    for kw in ({}, {"budget": 60, "seed": 3, "mode": "randomized"}):
        jr, tr = jsearch.search(jco, ja, **kw), tsearch.search(tco, ta, **kw)
        assert dataclasses.asdict(jr.best.spec) \
            == dataclasses.asdict(tr.best.spec)
        assert (jr.latency, jr.energy_pj, jr.evaluated, jr.valid, jr.mode) \
            == (tr.latency, tr.energy_pj, tr.evaluated, tr.valid, tr.mode)


def test_search_objectives_and_pareto_front_match():
    """The energy and EDP objectives and the Pareto front (the search
    objectives of tests/test_batcheval.py) agree point for point."""
    jco, tco = _ops("gemm_softmax", (512, 1024, 128))
    ja, ta = jhw.edge(), thw.edge()
    for obj in ("energy", "edp"):
        jr = jsearch.search(jco, ja, objective=obj)
        tr = tsearch.search(tco, ta, objective=obj)
        assert (jr.latency, jr.energy_pj) == (tr.latency, tr.energy_pj)
    jf = jsearch.search(jco, ja, objective="pareto").front
    tf = tsearch.search(tco, ta, objective="pareto").front
    assert [(lat, en, dataclasses.asdict(s)) for lat, en, s in jf] \
        == [(lat, en, dataclasses.asdict(s)) for lat, en, s in tf]


def test_search_many_thread_matches_serial_and_jax():
    """``search_many`` over threads returns the serial results in job
    order, equal to the JAX package's."""
    shapes = [("gemm_softmax", (256, 512, 64)), ("attention",
                                                  (1, 128, 512, 128))]
    tjobs = [(getattr(twl, n)(*a), thw.edge()) for n, a in shapes]
    jjobs = [(getattr(jwl, n)(*a), jhw.edge()) for n, a in shapes]
    thr = tsearch.search_many(tjobs, executor="thread", max_workers=2)
    ser = tsearch.search_many(tjobs, executor="serial")
    jser = jsearch.search_many(jjobs, executor="serial")
    assert [r.latency for r in thr] == [r.latency for r in ser] \
        == [r.latency for r in jser]


# ---------------------------------------------------- the process pools


class _Refused:
    """A ProcessPoolExecutor stand-in that records its arguments and
    refuses to start, so the fallback runs with no pool."""
    seen = []

    def __init__(self, **kw):
        _Refused.seen.append(kw)
        raise OSError("no pool here")


def test_both_process_pools_take_forkserver_or_spawn(monkeypatch):
    """``parallel_map(executor='process')`` and ``search_many``'s process
    path build their pools with an explicit ``forkserver``/``spawn``
    context, never the platform's ``fork``."""
    monkeypatch.setattr(tsearch, "ProcessPoolExecutor", _Refused)
    monkeypatch.setattr(tsearch, "_shm_usable", lambda: True)
    _Refused.seen.clear()
    with pytest.warns(RuntimeWarning, match="running serially"):
        assert tsearch.parallel_map(abs, [-1, -2],
                                    executor="process") == [1, 2]
    co = twl.gemm_softmax(64, 128, 32)
    with pytest.warns(RuntimeWarning, match="falling back to threads"):
        res = tsearch.search_many([(co, thw.edge())] * 2,
                                  executor="process")
    assert res[0].latency == tsearch.search(co, thw.edge()).latency
    assert len(_Refused.seen) == 2
    for kw in _Refused.seen:
        assert kw["mp_context"].get_start_method() in ("forkserver", "spawn")


_POOL_PROBE = """
import sys
sys.path.insert(0, {src!r})
from repro_torch.core.hardware import edge
from repro_torch.core.search import search_many
from repro_torch.core.workload import attention, gemm_softmax
jobs = [(gemm_softmax(256, 512, 64), edge()),
        (attention(1, 128, 512, 128), edge())]
pool = search_many(jobs, executor="process", max_workers=2)
serial = search_many(jobs, executor="serial")
assert [r.latency for r in pool] == [r.latency for r in serial], pool
print("ok", [r.mode for r in pool])
"""


def test_search_many_process_pool_runs_spawned_workers():
    """One real process-pool sweep, in a subprocess under a time limit:
    its workers start by forkserver or spawn and return the serial
    results."""
    res = subprocess.run(
        [sys.executable, "-c", _POOL_PROBE.format(src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().startswith("ok")


# ------------------------------------------------------------- the card


@pytest.mark.parametrize("mesh", [None, (4, 4)])
def test_h100_peak_and_bandwidth(mesh):
    """The kernel arch is the whole card: dense bf16 989.4 TFLOP/s, HBM3
    at 3.35 TB/s, one CTA's 227 KB of shared memory as the GB level.  A
    cluster mesh is 16 SMs of it: 16 / 132 of the peak and of HBM3, the
    same GB a node, 16 nodes on a DSMEM mesh."""
    if mesh is None:
        a = thw.h100()
        assert a.peak_flops_total() == pytest.approx(989.4e12, rel=1e-3)
        assert a.dram.bandwidth == 3.35e12
        assert a.gb.size_bytes == 227 * 1024
        assert a.cluster_noc.mesh == a.core_noc.mesh == (1, 1)
        assert a.total_cores == 1
        assert thw.PRESETS["h100"] is thw.h100 and a.name == "h100"
        return
    a = thw.h100(mesh=mesh)
    assert a.peak_flops_total() == pytest.approx(989.4e12 * 16 / 132,
                                                 rel=1e-3)
    assert a.dram.bandwidth == pytest.approx(3.35e12 * 16 / 132)
    assert a.gb.size_bytes == 227 * 1024
    assert a.cluster_noc.mesh == mesh and a.core_noc.mesh == (1, 1)
    assert a.total_cores == a.num_clusters == 16 and a.name == "h100"


@pytest.mark.parametrize("name,args", [("gemm_softmax", (512, 1024, 128)),
                                       ("flash_attention",
                                        (1024, 128, 1024, 128)),
                                       ("ssd_chunk", ())])
def test_h100_batched_equals_per_spec(name, args):
    """On ``h100`` the batched grid and the per-spec tree path agree over
    a small grid of every topology, to the 1e-9 of tests/test_batcheval.py
    (one package's two paths sum in different orders; each path is
    bit-equal across the packages, above)."""
    co = (twl.ssd_chunk(C=32, **SSD) if name == "ssd_chunk"
          else getattr(twl, name)(*args))
    arch = thw.h100()
    cands = tsearch.candidate_specs(co, arch)
    rng = np.random.default_rng(0)
    checked = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for topo in tbe.enumerate_topologies(co, cands):
            br = tbe.evaluate_topology_grid(co, arch, topo, cands)
            for i in {0, br.size - 1,
                      *rng.integers(0, br.size, 6).tolist()}:
                r = tir.evaluate_mapping(co, arch, br.spec_at(i))
                assert bool(br.valid[i]) == r.valid
                assert br.latency[i] == pytest.approx(r.latency, rel=1e-9)
                assert br.energy_pj[i] == pytest.approx(r.energy_pj,
                                                        rel=1e-9)
                assert br.headroom[i] == pytest.approx(r.headroom, rel=1e-9)
                checked += 1
    assert checked >= 4
