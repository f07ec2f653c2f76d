"""The fused GEMM epilogues' COMET plan in the port against the JAX package
on the CPU: ``h100(mesh=)`` (one thread-block cluster, DSMEM its cluster
NoC) prices the same as ``repro.core`` on an ``Arch`` of the same
constants, bit for bit; ``gemm_epilogue.tilings`` is the source's
``valid_tiling`` rule; ``autotune.gemm_epilogue_tiling`` is the cost
model's choice among every tiling; the three wrappers launch it by default
(and any named tiling the kernel runs) and equal the Pallas kernels in
interpret mode.

Inputs come from numpy seeds; plans are solved into a temporary store of
each test's own.  Tolerances are tests/test_kernels.py's: ``TOL`` (f32
2e-5, bf16 3e-2, absolute and relative, as its sweeps compare) and 1e-4
for its f32 norms.
"""
import dataclasses
import itertools
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.core import batcheval as jbe
from repro.core import hardware as jhw
from repro.core import ir as jir
from repro.core import workload as jwl
from repro.kernels import ops as jops
from repro_torch.core import batcheval as tbe
from repro_torch.core import hardware as thw
from repro_torch.core import ir as tir
from repro_torch.core import workload as twl
from repro_torch.kernels import autotune
from repro_torch.kernels import gemm_epilogue as ge
from repro_torch.kernels import ops as tops
from repro_torch.kernels.gemm_layernorm import gemm_layernorm, gemm_rmsnorm
from repro_torch.kernels.gemm_softmax import gemm_softmax
from repro_torch.models.convert import tensor_from_numpy

ROOT = Path(__file__).resolve().parents[1]
CU = ROOT / "src/repro_torch/kernels/csrc/gemm_epilogue.cu"
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
NORM_F32_TOL = 1e-4
BF, F32 = torch.bfloat16, torch.float32


@pytest.fixture(autouse=True)
def plan_store(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans"))


# ------------------------------------------------------------ the preset


def _h100_before():
    """``h100()`` as it stood before it took a mesh (its constants, as
    written there): the whole card as one node."""
    G = thw.GIGA
    smem = 132 * 128 * 1.98
    mk = thw._mk_mem
    return thw.Arch(
        name="h100", dram=mk("DRAM", 80 << 30, 3350, 28.0, 28.0),
        gb=mk("GB", 227 << 10, smem, 1.2, 1.2),
        ib=mk("IB", 64 << 10, 4 * smem, 0.3, 0.3),
        wb=mk("WB", 64 << 10, 4 * smem, 0.3, 0.3),
        ob=mk("OB", 128 << 10, 4 * smem, 0.3, 0.3),
        cluster_noc=thw.NoCParams((1, 1), 128, 128 * 1.98 * G, 1e-7,
                                  1 / (1.98 * G), 0.5),
        core_noc=thw.NoCParams((1, 1), 128, 4 * smem * G, 1e-9, 1e-9, 0.01),
        gemm_unit=thw.GemmUnit(16, 32, (132, 4),
                               989.4e12 / (132 * 4 * 16 * 32 * 2), 0.2),
        simd_unit=thw.SimdUnit(132 * 128, 1.98 * G, 0.1))


def test_default_mesh_is_the_whole_card_as_before():
    before = _h100_before()
    for arch in (thw.h100(), thw.h100(mesh=(1, 1))):
        assert arch == before and arch.signature() == before.signature()
    assert thw.h100_cluster((1, 1)) != before


def test_existing_plans_keep_their_values():
    """The attention and SSD plans (the card as one node) at the paper's
    kernel shapes: the kernels' own tile and chunk, as before."""
    for shape in autotune.PAPER_KERNEL_SHAPES["attention_blocks"]:
        assert autotune.attention_blocks(*shape) == (128, 128)
        assert autotune.attention_plan_job(*shape)[1] == thw.h100()
    for shape in autotune.PAPER_KERNEL_SHAPES["ssd_chunk_len"]:
        assert autotune.ssd_chunk_len(*shape) == 64


def _jax_arch(arch):
    """A ``repro.core`` Arch of the port arch's constants."""
    f = dataclasses.asdict
    return jhw.Arch(
        name=arch.name,
        **{lvl: jhw.MemLevel(**f(getattr(arch, lvl)))
           for lvl in ("dram", "gb", "ib", "wb", "ob")},
        cluster_noc=jhw.NoCParams(**f(arch.cluster_noc)),
        core_noc=jhw.NoCParams(**f(arch.core_noc)),
        gemm_unit=jhw.GemmUnit(**f(arch.gemm_unit)),
        simd_unit=jhw.SimdUnit(**f(arch.simd_unit)))


@pytest.mark.parametrize("mesh", [(4, 4), (2, 4)])
@pytest.mark.parametrize("op,args", [("gemm_softmax", (256, 1024, 64)),
                                     ("gemm_layernorm", (128, 2048, 96))])
def test_cluster_mesh_costs_equal_repro_core(mesh, op, args):
    """Per-spec and batched latency, energy and headroom on a cluster
    mesh, ``fused_dist`` at every cluster fanout 1-16 and both collective
    granularities, equal ``repro.core``'s on the same constants."""
    ta = thw.h100(mesh=mesh)
    ja = _jax_arch(ta)
    assert ta.num_clusters == mesh[0] * mesh[1] and ta.total_cores \
        == ta.num_clusters
    tco, jco = getattr(twl, op)(*args), getattr(jwl, op)(*args)
    grid = list(itertools.product(range(1, 17), ("tile", "stats"),
                                  (1, 2, 4), ("sequential", "pipelined"),
                                  (0.0, 1.0)))
    for gran in ("tile", "stats"):
        rows = [g for g in grid if g[1] == gran]
        tspecs = [tir.MappingSpec(variant="fused_dist", sp_cluster=cl,
                                  collective_gran=gr, m_tiles=mt,
                                  schedule=sc, overlap=ov)
                  for cl, gr, mt, sc, ov in rows]
        jspecs = [jir.MappingSpec(**dataclasses.asdict(s)) for s in tspecs]
        for ts, js in zip(tspecs, jspecs):
            tr = tir.evaluate_mapping(tco, ta, ts)
            jr = jir.evaluate_mapping(jco, ja, js)
            assert (tr.latency, tr.energy_pj, tr.headroom, tr.valid) \
                == (jr.latency, jr.energy_pj, jr.headroom, jr.valid)
        out = []
        for be, co, arch, specs in ((tbe, tco, ta, tspecs),
                                    (jbe, jco, ja, jspecs)):
            br = be.evaluate_specs_batch(
                co, arch, be.Topology(variant="fused_dist",
                                      collective_gran=gran),
                [s.m_tiles for s in specs], [s.k_tiles for s in specs],
                [s.n_tiles for s in specs], [s.sp_cluster for s in specs],
                [s.sp_core for s in specs], [s.schedule for s in specs],
                [s.overlap for s in specs])
            out.append((br.latency.tolist(), br.energy_pj.tolist(),
                        br.headroom.tolist(), br.valid.tolist()))
        assert out[0] == out[1]


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (2, 4), (4, 4)])
def test_cluster_preset_constants(mesh):
    """A cluster of CL SMs: CL / 132 of the card's peak and HBM3 rate, one
    SM's shared memory and registers a node, DSMEM as its NoC."""
    cl = mesh[0] * mesh[1]
    a = thw.h100(mesh=mesh)
    whole = thw.h100()
    assert a == thw.h100_cluster(mesh) and a.name == "h100"
    assert a.peak_flops_total() == pytest.approx(989.4e12 * cl / 132,
                                                 rel=1e-12)
    assert a.dram.bandwidth == pytest.approx(3.35e12 * cl / 132, rel=1e-12)
    assert a.gb.size_bytes == 227 << 10
    assert a.gb.bandwidth == pytest.approx(whole.gb.bandwidth / 132)
    assert a.cluster_noc.mesh == mesh and a.core_noc.mesh == (1, 1)
    assert dataclasses.replace(a.cluster_noc, mesh=(1, 1)) \
        == whole.cluster_noc
    assert a.simd_unit.lanes == 128 and a.gemm_unit.grid == (1, 4)


# ------------------------------------------------------------ the tilings


def _valid_tiling(dtype, N, cluster, rows, cols, passes):
    """``valid_cluster``, ``valid_instance`` and ``valid_tiling`` of
    csrc/gemm_epilogue.cu, line for line, in numpy (dtype 0 f32, 1 bf16;
    C's integer division on non-negative ints)."""
    ok_cluster = np.isin(cluster, (1, 2, 4, 8, 16))
    if dtype == 0:
        ok_inst = (rows == 16) & (passes == 1)
    else:
        ok_inst = ((rows == 128) & (passes == 1)) | (
            (rows == 64) & ((passes == 1) | (passes == 2)))
    align = 16 if dtype == 0 else 8
    c = np.maximum(cluster, 1)
    ns = ((N + c - 1) // c + align - 1) // align * align
    ok = ok_inst & ok_cluster & (cols == ns) & ((cluster - 1) * ns < N)
    if dtype == 0:
        return ok & (ns <= 1024)
    pass_cols = np.where(rows == 128, 256, 512)
    return ok & (ns > (passes - 1) * pass_cols) & (ns <= passes * pass_cols)


def test_the_rule_is_the_sources():
    """The lines the brute force transcribes are the source's."""
    src = CU.read_text()
    for line in (
            "const int align = dtype == 0 ? 16 : 8;",
            "const int ns = ((N + t.cluster - 1) / t.cluster + align - 1) "
            "/ align * align;",
            "if (t.cols != ns || (long long)(t.cluster - 1) * ns >= N) "
            "return false;",
            "if (dtype == 0) return ns <= F32_NT;",
            "return ns > (t.passes - 1) * pass_cols && ns <= t.passes * "
            "pass_cols;",
            "return cluster == 1 || cluster == 2 || cluster == 4 || "
            "cluster == 8 ||"):
        assert line in src, line


@pytest.mark.parametrize("dtype", [F32, BF])
def test_tilings_are_every_tiling_the_source_runs(dtype):
    """Brute force over clusters 0-32, rows 8-256, passes 1-3 and slices
    of 1-2048 columns: the tilings the source's rule accepts are exactly
    ``tilings(N, dtype)``, each covering N; the first is ``tiling``."""
    code = 0 if dtype == F32 else 1
    cl, rows, passes, cols = (a.ravel() for a in np.meshgrid(
        np.arange(33), np.array([8, 16, 32, 64, 128, 256]),
        np.arange(1, 4), np.arange(1, 2049), indexing="ij"))
    for N in sorted(set(ge.TILING_BOUNDARIES) | set(range(1, 65))):
        ok = _valid_tiling(code, N, cl, rows, cols, passes)
        want = {ge.Tiling(*map(int, t)) for t in
                zip(cl[ok], rows[ok], cols[ok], passes[ok])}
        got = ge.tilings(N, dtype)
        assert set(got) == want and len(got) == len(want), N
        for t in got:
            assert t.cluster * t.columns >= N > (t.cluster - 1) * t.columns
        if got:
            assert ge.tiling(N, dtype) == got[0]
    assert ge.tilings(16392, dtype) == ()


def test_tilings_at_4096_offer_clusters_and_rows():
    assert ge.tilings(4096, BF) == (
        ge.Tiling(16, 128, 256, 1), ge.Tiling(8, 64, 512, 1),
        ge.Tiling(16, 64, 256, 1), ge.Tiling(4, 64, 1024, 2))
    jobs = autotune.gemm_epilogue_plan_job(4096, 4096, 4096)
    offered = [t for *_, ts in jobs for t in ts]
    assert sorted(offered) == sorted(ge.tilings(4096, BF))
    assert len({t.cluster for t in offered}) >= 2


# --------------------------------------------------------------- the plan


def _rows_a_cluster(m, t):
    return math.ceil(math.ceil(m / t.rows) / (132 // t.cluster)) * t.rows


def _gemm_tiling_ref(m, n, k, dtype):
    """The choice the plan must make, from the per-spec path alone: every
    tiling at every schedule and overlap, each on its own cluster's arch
    over its cluster's rows, a spec that fits first, then the least
    latency, the first on a tie (clusters ascending)."""
    e = torch.empty((), dtype=dtype).element_size()
    best = None
    for t in sorted(ge.tilings(n, dtype), key=lambda t: (
            t.cluster, _rows_a_cluster(m, t))):
        rows_cl = _rows_a_cluster(m, t)
        arch = thw.h100_cluster(autotune.CLUSTER_MESH[t.cluster])
        co = twl.gemm_softmax(rows_cl, n, k, dtype_bytes=e)
        for sched in ("sequential", "pipelined"):
            for ov in (0.0, 1.0):
                r = tir.evaluate_mapping(co, arch, tir.MappingSpec(
                    variant="fused_dist", m_tiles=rows_cl // t.rows,
                    sp_cluster=t.cluster, collective_gran="stats",
                    schedule=sched, overlap=ov))
                key = (not r.valid, r.latency)
                if best is None or key < best[0]:
                    best = (key, t)
    return best[1]


@pytest.mark.parametrize("shape,dtype", [
    ((512, 4096, 128), BF), ((4096, 4096, 4096), BF),
    ((4096, 16384, 4096), BF), ((1, 2048, 64), BF), ((64, 256, 64), BF),
    ((33, 1032, 40), BF), ((200, 520, 96), BF), ((64, 256, 64), F32),
    ((100, 4104, 32), F32)])
def test_gemm_epilogue_tiling_is_the_models_argmin(shape, dtype):
    t = autotune.gemm_epilogue_tiling(*shape, dtype)
    assert t == _gemm_tiling_ref(*shape, dtype)
    assert t in ge.tilings(shape[1], dtype)
    if dtype == BF:
        assert autotune.gemm_epilogue_blocks(*shape) == (t.rows, t.columns)


def test_plan_jobs_warm_every_cluster_job():
    shapes = {"gemm_epilogue_blocks": [(512, 4096, 128), (64, 256, 64)]}
    jobs = autotune.plan_jobs(shapes)
    want = [j[:3] for s in shapes["gemm_epilogue_blocks"]
            for j in autotune.gemm_epilogue_plan_job(*s)]
    assert len(jobs) == len(want) > 2
    for (co, arch, kw), (co2, arch2, kw2) in zip(jobs, want):
        assert co is co2 and arch is arch2 and kw is kw2
        assert arch.name == "h100" and all(
            s.collective_gran == "stats" and s.variant == "fused_dist"
            for s in kw["candidate_list"])


# ----------------------------------------------------------- the wrappers


def _inputs(seed, M, K, N, dtype):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(M, K)), rng.normal(size=(K, N)) * K ** -0.5,
          1 + 0.1 * rng.normal(size=(N,)), 0.1 * rng.normal(size=(N,))]
    jx = [jnp.asarray(x, getattr(jnp, dtype) if i < 2 else jnp.float32)
          for i, x in enumerate(xs)]
    return jx, [tensor_from_numpy(np.asarray(x)) for x in jx]


def _close(t, j, dtype, norm):
    tol = NORM_F32_TOL if norm and dtype == "float32" else TOL[dtype]
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrappers_match_jax_at_the_plan_and_every_tiling(dtype):
    """On CPU tensors each wrapper, at its default (the plan's) tiling and
    at every tiling of ``tilings(N)``, equals the JAX kernel in interpret
    mode, and records the tiling it was given."""
    M, K, N = 40, 48, 64
    (ja, jb, jg, jbe), (a, b, g, be) = _inputs(7, M, K, N, dtype)
    dt = getattr(torch, dtype)
    want = {
        "softmax": jops.gemm_softmax(ja, jb, block_m=16, block_k=16,
                                     interpret=True),
        "layernorm": jops.gemm_layernorm(ja, jb, jg, jbe, block_m=16,
                                         block_k=16, interpret=True),
        "rmsnorm": jops.gemm_rmsnorm(ja, jb, jg, block_m=16, block_k=16,
                                     interpret=True)}
    calls = {
        "softmax": (gemm_softmax, lambda t: gemm_softmax(a, b, tiling=t)),
        "layernorm": (gemm_layernorm, lambda t: gemm_layernorm(
            a, b, g, be, tiling=t)),
        "rmsnorm": (gemm_rmsnorm, lambda t: gemm_rmsnorm(a, b, g,
                                                         tiling=t))}
    plan = autotune.gemm_epilogue_tiling(M, N, K, dt)
    assert len(ge.tilings(N, dt)) >= 3
    for kind, (wrapper, call) in calls.items():
        for t in (None,) + ge.tilings(N, dt):
            out = call(t)
            assert wrapper.last_tiling == (plan if t is None else t)
            _close(out, want[kind], dtype, kind != "softmax")
    for t in ge.tilings(N, dt):     # the ops entries pass the tiling on
        _close(tops.fused_gemm_softmax(a, b, use_kernel=True, tiling=t),
               want["softmax"], dtype, False)
        assert gemm_softmax.last_tiling == t


def test_planned_tiling_is_memoized_per_shape_and_dtype(monkeypatch):
    a, b = torch.randn(24, 16), torch.randn(16, 512)
    gemm_softmax(a, b)
    plan = gemm_softmax.last_tiling
    assert plan == autotune.gemm_epilogue_tiling(24, 512, 16, F32)

    def boom(*args, **kw):
        raise AssertionError("a repeated call looked its plan up")
    monkeypatch.setattr(autotune, "gemm_epilogue_tiling", boom)
    gemm_softmax(a, b)
    assert gemm_softmax.last_tiling == plan
    with pytest.raises(AssertionError, match="looked its plan up"):
        gemm_softmax(a.bfloat16(), b.bfloat16())


@pytest.mark.parametrize("bad", [(16, 64, 256, 2), (16, 128, 264, 1),
                                 (8, 128, 512, 1), (3, 64, 1368, 2),
                                 (16, 32, 256, 1)])
def test_a_tiling_the_kernel_does_not_run_raises(bad):
    """On the CPU as on the card: no fallback to another tiling."""
    a, b = torch.randn(8, 32).bfloat16(), torch.randn(32, 4096).bfloat16()
    g = torch.randn(4096)
    with pytest.raises(ValueError, match="does not run tiling"):
        gemm_softmax(a, b, tiling=ge.Tiling(*bad))
    with pytest.raises(ValueError, match="does not run tiling"):
        gemm_rmsnorm(a, b, g, tiling=ge.Tiling(*bad))
    with pytest.raises(ValueError, match="does not run tiling"):
        tops.fused_gemm_layernorm(a, b, g, g, use_kernel=True,
                                  tiling=ge.Tiling(*bad))


def test_fake_flops_follow_an_explicit_tiling():
    """Under FakeTensorMode the op's FLOP formula counts the named
    tiling's products, padding included, and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    M, K, N = 300, 100, 4096
    counts = {}
    before = gemm_softmax.launches
    for t in ge.tilings(N, BF):
        with FakeTensorMode():
            a = torch.empty(M, K, dtype=BF)
            b = torch.empty(K, N, dtype=BF)
            with FlopCounterMode(display=False) as fc:
                out = gemm_softmax(a, b, tiling=t)
            assert tuple(out.shape) == (M, N)
        counts[t] = fc.get_total_flops()
        assert counts[t] == ge.mma_flops(M, N, K, BF, t)
        # every pass's whole width: 256 columns a CTA at 128 rows, 512 at
        # 64, whatever the slice holds
        bk = 16 if t.passes == 2 else 32
        width = t.passes * (256 if t.rows == 128 else 512)
        assert ge.pass_columns(t, BF) == width >= t.columns
        assert counts[t] == 2 * math.ceil(M / t.rows) * t.rows * t.cluster \
            * width * math.ceil(K / bk) * bk
    assert len(set(counts.values())) > 1
    assert gemm_softmax.launches == before
    # f32: each CTA over its slice alone
    t = ge.tilings(N, F32)[0]
    with FakeTensorMode():
        a = torch.empty(M, K)
        b = torch.empty(K, N)
        with FlopCounterMode(display=False) as fc:
            gemm_softmax(a, b, tiling=t)
    assert fc.get_total_flops() == 2 * math.ceil(M / 16) * 16 * t.cluster \
        * t.columns * math.ceil(K / 8) * 8
