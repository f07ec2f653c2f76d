"""Port fused GEMM epilogues (GEMM-Softmax, GEMM-LayerNorm, GEMM-RMSNorm)
against the JAX package on the CPU: the plain versions against the JAX
package's, the ``ops`` entries with ``use_kernel=True`` (which on CPU
tensors take the plain versions after the kernel's checks) against the
Pallas kernels in interpret mode, the checks that refuse what the kernel
refuses, the cluster size, the bound, and the kernel bench at a small
shape.

Inputs are made with numpy from a seed and handed to both packages with the
same bits.  The Pallas kernels get explicit ``block_m``/``block_k``, as
tests/test_kernels.py does, so no plan search runs.

Tolerances, each with its reason, are those of ``gemm_epilogue.tolerance``,
which the card's checks use too:
- f32: softmax 2e-5 (``TOL`` of tests/test_kernels.py) and the norms 1e-4
  (that file's norm bar); the same f32 math, sums in another order.
- bf16, all three: 1e-2 of the output's largest magnitude.  Both sides
  round the output to bf16, one step of which is up to 2^-7 of the
  largest |y|; the error of an element follows the row's scale, not its
  own value.  For softmax this is tighter than tests/test_kernels.py's
  absolute 3e-2, which outputs near 1/N at N 16384 (about 3e-3 at most)
  would pass as zeros; ``test_card_bars_catch_cluster_faults`` shows the
  bar breaks when one CTA's partial sum is left out.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import autotune
from repro_torch.kernels import gemm_epilogue as ge
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.gemm_layernorm import gemm_layernorm, gemm_rmsnorm
from repro_torch.kernels.gemm_softmax import gemm_softmax
from repro_torch.launch import kernel_bench as kb
from repro_torch.models.convert import tensor_from_numpy

NORM_F32_TOL = ge.tolerance("layernorm", torch.float32, 1.0)
DTYPES = ["float32", "bfloat16"]
# (M, K, N, block_m, block_k): tests/test_kernels.py's softmax sweep, then a
# paper cloud shape (Table II: N 16384, K 128) at M 1 and M 4
SOFTMAX_SHAPES = [(128, 64, 256, 128, 64), (200, 96, 256, 128, 32),
                  (64, 128, 512, 64, 128), (1, 128, 16384, 16, 64),
                  (4, 128, 16384, 16, 64)]
# (M, K, N): tests/test_kernels.py's norm shapes (block_m 64, block_k 32)
# and the same cloud shape
NORM_SHAPES = [(128, 64, 256), (96, 100, 128), (1, 128, 16384),
               (4, 128, 16384)]


def _inputs(seed, M, K, N, dtype, b_scale):
    """Same bits for both packages: a (M, K), b (K, N) in ``dtype``, f32
    gamma/beta (N,)."""
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(M, K)), rng.normal(size=(K, N)) * b_scale,
          rng.normal(size=(N,)), rng.normal(size=(N,))]
    jx = [jnp.asarray(x, getattr(jnp, dtype) if i < 2 else jnp.float32)
          for i, x in enumerate(xs)]
    return jx, [tensor_from_numpy(np.asarray(x)) for x in jx]


def _err_and_tol(t, j, dtype, kind):
    """(max |t - j|, the bar of epilogue ``kind`` in ``dtype``)."""
    want = np.asarray(j, np.float32)
    got = t.float().numpy()
    assert got.shape == want.shape
    tol = ge.tolerance(kind, getattr(torch, dtype), float(np.abs(want).max()))
    return np.abs(got - want).max(), tol


def _assert_close(t, j, dtype, kind):
    err, tol = _err_and_tol(t, j, dtype, kind)
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_versions_match_jax(dtype):
    (ja, jb, jg, jbe), (a, b, g, be) = _inputs(0, 48, 40, 96, dtype, 0.2)
    out = tref.gemm_softmax_ref(a, b)
    assert out.dtype == a.dtype
    _assert_close(out, jref.gemm_softmax_ref(ja, jb), dtype, "softmax")
    _assert_close(tref.gemm_layernorm_ref(a, b, g, be),
                  jref.gemm_layernorm_ref(ja, jb, jg, jbe), dtype,
                  "layernorm")
    _assert_close(tref.gemm_rmsnorm_ref(a, b, g),
                  jref.gemm_rmsnorm_ref(ja, jb, jg), dtype, "rmsnorm")


@pytest.mark.parametrize("M,K,N,bm,bk", SOFTMAX_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_gemm_softmax_matches_pallas_kernel(M, K, N, bm, bk, dtype):
    (ja, jb, _, _), (a, b, _, _) = _inputs(1, M, K, N, dtype, 0.1)
    want = jops.gemm_softmax(ja, jb, block_m=bm, block_k=bk, interpret=True)
    out = tops.fused_gemm_softmax(a, b, use_kernel=True)
    assert out.dtype == a.dtype
    _assert_close(out, want, dtype, "softmax")


@pytest.mark.parametrize("M,K,N", NORM_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_gemm_norms_match_pallas_kernel(M, K, N, dtype):
    (ja, jb, jg, jbe), (a, b, g, be) = _inputs(2, M, K, N, dtype, 0.2)
    want = jops.gemm_layernorm(ja, jb, jg, jbe, block_m=64, block_k=32,
                               interpret=True)
    out = tops.fused_gemm_layernorm(a, b, g, be, use_kernel=True)
    assert out.dtype == a.dtype
    _assert_close(out, want, dtype, "layernorm")
    want = jops.gemm_rmsnorm(ja, jb, jg, block_m=64, block_k=32,
                             interpret=True)
    out = tops.fused_gemm_rmsnorm(a, b, g, use_kernel=True)
    assert out.dtype == a.dtype
    _assert_close(out, want, dtype, "rmsnorm")


@pytest.mark.parametrize("N", [256, 4096, 8192, 16384])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_versions_match_pallas_per_tiling_regime(N, dtype):
    """One shape in each bf16 regime (128 rows; 64 rows in one pass; 64
    rows in two passes at 8192 < N), M and K ragged against the Pallas
    blocks: the plain versions the card is held to agree with the Pallas
    kernels in interpret mode."""
    (ja, jb, jg, jbe), (a, b, g, be) = _inputs(6, 20, 40, N, dtype, 0.2)
    _assert_close(tref.gemm_softmax_ref(a, b),
                  jops.gemm_softmax(ja, jb, block_m=16, block_k=32,
                                    interpret=True), dtype, "softmax")
    _assert_close(tref.gemm_layernorm_ref(a, b, g, be),
                  jops.gemm_layernorm(ja, jb, jg, jbe, block_m=16,
                                      block_k=32, interpret=True),
                  dtype, "layernorm")
    _assert_close(tref.gemm_rmsnorm_ref(a, b, g),
                  jops.gemm_rmsnorm(ja, jb, jg, block_m=16, block_k=32,
                                    interpret=True), dtype, "rmsnorm")


@pytest.mark.parametrize("K,padded", [(100, 104), (64, 64), (8, 8)])
def test_bf16_a_is_padded_for_tma(K, padded):
    """bf16 A reaches the kernel with rows 16 bytes apart: K = 100 gets a
    zero-padded copy; f32 A and bf16 A with K a multiple of 8 pass as they
    are."""
    a = torch.randn(5, K).bfloat16()
    ak = ge.kernel_operand(a)
    assert ak.shape == (5, padded) and torch.equal(ak[:, :K], a)
    assert (ak is a) == (padded == K)
    assert not ak[:, K:].any()
    f = torch.randn(5, K)
    assert ge.kernel_operand(f) is f


@pytest.mark.parametrize("dtype", DTYPES)
def test_boundary_shapes_cover_every_tiling_edge(dtype):
    """The card's boundary cases: N on both sides of every change, M at 1,
    BM - 1, BM + 1 and a ragged multiple, K at 8, 100 and one that is not
    a multiple of the K step."""
    dt = getattr(torch, dtype)
    shapes = ge.boundary_shapes(dt)
    assert {n for _, _, n in shapes} == {256, 264, 4096, 4104, 8192, 8200,
                                         16384}
    step = 32 if dtype == "bfloat16" else 8
    for n in {n for _, _, n in shapes}:
        bm = ge.tiling(n, dt).rows
        ms = {m for m, _, n2 in shapes if n2 == n}
        assert ms == {1, bm - 1, bm + 1, 2 * bm + bm // 2 + 3}
    ks = {k for _, k, _ in shapes}
    assert 8 in ks and 100 in ks and any(k % step for k in ks - {100})


def test_layernorm_plain_version_uses_the_centred_variance():
    """Rows of mean 1e3 and std about 1 (exact in f32): E[c^2] - mean^2
    would lose the variance to cancellation; the centred form keeps it to
    f32 rounding against a float64 computation."""
    rng = np.random.default_rng(3)
    a = rng.integers(-1, 2, size=(8, 32)).astype(np.float32)
    b = (rng.integers(-1, 2, size=(32, 4096)) * 0.25).astype(np.float32)
    a[:, 0], b[0] = 1, 1000.0
    c = a.astype(np.float64) @ b
    want = (c - c.mean(-1, keepdims=True)) \
        / np.sqrt(c.var(-1, keepdims=True) + 1e-6)
    ones, zeros = torch.ones(4096), torch.zeros(4096)
    out = tref.gemm_layernorm_ref(torch.from_numpy(a), torch.from_numpy(b),
                                  ones, zeros)
    assert np.abs(out.numpy() - want).max() < NORM_F32_TOL
    naive = c.astype(np.float32)
    var = (naive ** 2).mean(-1) - naive.mean(-1) ** 2
    assert np.abs(var - c.var(-1)).max() > 1e-2   # what the centred form avoids


# N -> (cluster, rows per block, columns per CTA, passes), by dtype: both
# sides of every boundary; f32 keeps the cluster sizes of the first
# version (16 rows, slices of up to 1024 columns)
TILINGS = {
    "bfloat16": {8: (1, 128, 8, 1), 256: (1, 128, 256, 1),
                 264: (2, 128, 136, 1), 512: (2, 128, 256, 1),
                 520: (4, 128, 136, 1), 1024: (4, 128, 256, 1),
                 1032: (8, 128, 136, 1), 2048: (8, 128, 256, 1),
                 2056: (16, 128, 136, 1), 4096: (16, 128, 256, 1),
                 4104: (16, 64, 264, 1), 8192: (16, 64, 512, 1),
                 8200: (16, 64, 520, 2), 16384: (16, 64, 1024, 2)},
    "float32": {8: (1, 16, 16, 1), 1000: (1, 16, 1008, 1),
                1024: (1, 16, 1024, 1), 1032: (2, 16, 528, 1),
                2048: (2, 16, 1024, 1), 4096: (4, 16, 1024, 1),
                4104: (8, 16, 528, 1), 8192: (8, 16, 1024, 1),
                8200: (16, 16, 528, 1), 16384: (16, 16, 1024, 1)},
}


@pytest.mark.parametrize("dtype,N", [(d, n) for d in TILINGS
                                     for n in TILINGS[d]] + [
    ("bfloat16", 16392), ("float32", 16392)])
def test_cluster_size_follows_n(dtype, N):
    """The tiling at each boundary; N > 16384 does not fit 16 CTAs."""
    dt = getattr(torch, dtype)
    if N > 16384:
        with pytest.raises(ValueError, match="does not fit 16 slices"):
            ge.tiling(N, dt)
        return
    t = ge.tiling(N, dt)
    assert tuple(t) == TILINGS[dtype][N]
    assert t.cluster * t.columns >= N > (t.cluster - 1) * t.columns
    if N in ge.TILING_BOUNDARIES:
        assert (t.rows, t.passes, t.cluster) in ge.instances(dt)


def test_bf16_tiling_reads_b_once_per_64_rows():
    """At every N the bf16 kernel takes, a block has at least 64 rows (B
    crosses L2 at most once per 64 rows of A), a pass holds at most 256
    columns a warpgroup, and the cluster's slices cover the row."""
    for N in range(8, 16385, 8):
        t = ge.tiling(N, torch.bfloat16)
        assert t.rows >= 64 and t.rows in (64, 128)
        assert t.columns * t.cluster >= N and t.columns % 8 == 0
        per_pass = 256 if t.rows == 128 else 512
        assert t.columns <= t.passes * per_pass and t.passes in (1, 2)
        assert t.cluster in ge.CLUSTER_SIZES


def test_wrappers_refuse_what_the_kernel_refuses():
    """On CPU tensors, as on the card: the checks run before dispatch."""
    a, b = torch.randn(4, 32), torch.randn(32, 64)
    g = torch.randn(64)
    with pytest.raises(ValueError, match="does not fit 16 slices"):
        gemm_softmax(a, torch.randn(32, 16392))
    with pytest.raises(ValueError, match="does not fit 16 slices"):
        gemm_rmsnorm(a.bfloat16(), torch.randn(32, 16392).bfloat16(),
                     torch.randn(16392))
    with pytest.raises(TypeError, match="share one dtype"):
        gemm_softmax(a, b.bfloat16())
    with pytest.raises(TypeError, match="share one dtype"):
        gemm_softmax(a.half(), b.half())
    with pytest.raises(ValueError, match="gamma must have shape"):
        gemm_layernorm(a, b, torch.randn(63), g)
    with pytest.raises(ValueError, match="beta must have shape"):
        gemm_layernorm(a, b, g, torch.randn(64, 1))
    with pytest.raises(ValueError, match="gamma must have shape"):
        gemm_rmsnorm(a, b, torch.randn(1, 64))
    with pytest.raises(ValueError, match="want a"):
        gemm_softmax(a, torch.randn(31, 64))
    with pytest.raises(ValueError, match="contiguous"):
        gemm_softmax(a, torch.randn(64, 32).t())
    with pytest.raises(ValueError, match="16-byte aligned"):
        gemm_softmax(a.bfloat16(), torch.randn(32, 60).bfloat16())
    with pytest.raises(ValueError, match="empty"):
        gemm_softmax(a[:0], b)
    with pytest.raises(ValueError, match="different devices"):
        gemm_layernorm(a, b, g, g.to("meta"))


def test_ops_entries_take_the_plain_version_on_the_cpu():
    _, (a, b, g, be) = _inputs(4, 16, 24, 64, "float32", 0.2)
    counts = (gemm_softmax.launches, gemm_layernorm.launches,
              gemm_rmsnorm.launches)
    for use_kernel in (False, True):
        assert torch.equal(tops.fused_gemm_softmax(a, b,
                                                   use_kernel=use_kernel),
                           tref.gemm_softmax_ref(a, b))
        assert torch.equal(tops.fused_gemm_layernorm(a, b, g, be,
                                                     use_kernel=use_kernel),
                           tref.gemm_layernorm_ref(a, b, g, be))
        assert torch.equal(tops.fused_gemm_rmsnorm(a, b, g,
                                                   use_kernel=use_kernel),
                           tref.gemm_rmsnorm_ref(a, b, g))
    # launches count kernels on the card only
    assert counts == (gemm_softmax.launches, gemm_layernorm.launches,
                      gemm_rmsnorm.launches)


def test_bound_at_the_paper_shapes():
    M, N, K = 4096, 16384, 4096
    flops = kb.gemm_flops(M, N, K)
    n_bytes = 2 * (M * K + K * N + M * N) + 4 * N
    ms, by = kb.bound(flops, n_bytes, torch.bfloat16)
    assert by == "operations" and abs(ms - 549.755813888e9 / 989e12 * 1e3) \
        < 1e-12
    ms, by = kb.bound(kb.gemm_flops(512, 4096, 128),
                      2 * (512 * 128 + 128 * 4096 + 512 * 4096),
                      torch.bfloat16)
    assert by == "bytes" and 1.5e-3 < ms < 1.7e-3
    assert (1, 16384, 128) in kb.PAPER_GEMM_SHAPES \
        and len(kb.PAPER_GEMM_SHAPES) == 8
    # B from L2 once per block of 64 rows (two passes over A) at the
    # largest shape, once per 128 rows at (4096, 4096, 4096) on its first
    # tiling, once per 64 rows on its 4-CTA two-pass tiling
    b, a = kb.gemm_l2_bytes(M, N, K, torch.bfloat16,
                            ge.Tiling(16, 64, 1024, 2))
    assert b == 64 * K * N * 2 and a == 16 * 2 * M * K * 2
    b, a = kb.gemm_l2_bytes(4096, 4096, 4096, torch.bfloat16,
                            ge.Tiling(16, 128, 256, 1))
    assert b == 32 * 4096 * 4096 * 2 and a == 16 * 4096 * 4096 * 2
    b, a = kb.gemm_l2_bytes(4096, 4096, 4096, torch.bfloat16,
                            ge.Tiling(4, 64, 1024, 2))
    assert b == 64 * 4096 * 4096 * 2 and a == 4 * 2 * 4096 * 4096 * 2


def test_kernel_bench_runs_on_the_cpu():
    shapes = [(4, 64, 32), (17, 1032, 40)]
    out = kb.run_all("cpu", gemm_shapes=shapes,
                     attention_shape={"B": 1, "Hq": 2, "Hkv": 1, "S": 16,
                                      "D": 16},
                     ssd_shapes=[{"BH": 2, "S": 16, "P": 16, "N": 16}],
                     streamed_shape=(24, 64, 40, 4))
    recs = out["records"]
    assert out["device"] == "cpu"
    assert [r["name"] for r in recs] == ["flash_attention", "ssd_scan"] \
        + ["gemm_softmax", "gemm_layernorm", "gemm_rmsnorm"] * 2 \
        + ["streamed_gemm"]
    assert out["calls"] == {"flash_attention": 1, "ssd_scan": 1,
                            "gemm_softmax": 2, "gemm_layernorm": 2,
                            "gemm_rmsnorm": 2, "streamed_gemm": 2}
    for r in recs:
        # no device metric from a CPU run
        assert r["ms"] is None and r["plain_ms"] is None \
            and r["library_ms"] is None and r["to_library"] is None
        assert r["max_abs_err"] == 0.0 and r["bound_ms"] > 0
    # the fused GEMMs launch the plan's tiling, which the record names
    for r, (M, N, K) in zip(recs[2:-1], [s for s in shapes for _ in
                                         range(3)]):
        t = autotune.gemm_epilogue_tiling(M, N, K, torch.bfloat16)
        assert r["tiling"] == r["plan_tiling"] == list(t)
        assert r["cluster"] == t.cluster
        assert r["tile"] == f"{t.rows} rows x {t.columns} columns a CTA " \
            f"in {t.passes} pass{'es' if t.passes > 1 else ''}, cluster " \
            f"{t.cluster}"
        assert (r["l2_bytes_b"], r["l2_bytes_a"]) == kb.gemm_l2_bytes(
            M, N, K, torch.bfloat16, t)
    for r in recs[2:-1]:   # device-only times: not measured on the CPU
        assert r["device_ms"] is None and r["library_device_ms"] is None
    assert recs[-1]["ms_buffers1"] is None and recs[-1]["within_tol"]


def test_kernel_bench_leaves_out_the_kernels_it_is_not_given():
    """chip_smoke.py's phase 12 asks for the fused GEMMs alone."""
    out = kb.run_all("cpu", gemm_shapes=[(4, 64, 32)], attention_shape=None,
                     ssd_shapes=(), streamed_shape=None)
    assert [r["name"] for r in out["records"]] == list(kb.GEMM_ENTRIES)
    assert out["calls"] == {name: 1 for name in kb.GEMM_ENTRIES}


def test_bf16_bar_is_relative_to_the_output():
    """Softmax outputs at N 16384 are near 1/N: zeros must break the bf16
    bar, one bf16 step of the largest output must not."""
    for kind in ge.EPILOGUES:
        assert ge.tolerance(kind, torch.bfloat16, 3e-3) == 3e-5
        assert 2 ** -7 * 3e-3 < ge.tolerance(kind, torch.bfloat16, 3e-3)
    assert ge.tolerance("softmax", torch.float32, 0.5) == 2e-5
    assert ge.tolerance("rmsnorm", torch.float32, 20.0) == 1e-4
    with pytest.raises(ValueError, match="unknown epilogue"):
        ge.tolerance("gelu", torch.bfloat16, 1.0)
    with pytest.raises(TypeError, match="no bar"):
        ge.tolerance("softmax", torch.float16, 1.0)


def _sliced(c, cluster):
    """C's rows cut into the cluster's slices: (M, cluster, N / cluster)."""
    return c.reshape(c.shape[0], cluster, -1)


def _fault_softmax_cta_max(a, b, g, be):
    """Each CTA subtracts its own slice's max, not the cluster's."""
    c = _sliced(a.float() @ b.float(), 16)
    e = torch.exp(c - c.amax(-1, keepdim=True))
    return (e / e.sum((1, 2), keepdim=True)).reshape(a.shape[0], -1)


def _fault_softmax_cta_sum(a, b, g, be):
    """The row max is the cluster's, but each CTA divides by its own
    slice's sum."""
    c = a.float() @ b.float()
    e = _sliced(torch.exp(c - c.amax(-1, keepdim=True)), 16)
    return (e / e.sum(-1, keepdim=True)).reshape(a.shape[0], -1)


def _fault_softmax_rank_left_out(a, b, g, be):
    """The all-reduce of the sum leaves the last of 16 ranks' partials
    out."""
    c = a.float() @ b.float()
    e = torch.exp(c - c.amax(-1, keepdim=True))
    return e / _sliced(e, 16)[:, :-1].sum((1, 2))[:, None]


def _fault_layernorm_uncentred(a, b, g, be):
    """var = E[c^2] - mean^2 in f32."""
    c = a.float() @ b.float()
    mu = c.mean(-1, keepdim=True)
    var = (c * c).mean(-1, keepdim=True) - mu * mu
    return (c - mu) * torch.rsqrt(var + 1e-6) * g + be


def _fault_layernorm_no_allreduce(a, b, g, be):
    """Each CTA normalises by its own slice's statistics."""
    c = _sliced(a.float() @ b.float(), 4)
    mu = c.mean(-1, keepdim=True)
    var = ((c - mu) ** 2).mean(-1, keepdim=True)
    y = ((c - mu) * torch.rsqrt(var + 1e-6)).reshape(a.shape[0], -1)
    return y * g + be


def _card_inputs(kind, M, K, N, dtype):
    """The inputs of the card's special cases (chip_smoke phase 11 and
    tests/test_torch_kernels_cuda.py), made the same way on the CPU."""
    gen = torch.Generator().manual_seed(5)
    if kind == "bench":             # run_all's data: C of std about 1
        return (torch.randn(M, K, generator=gen).to(dtype),
                (torch.randn(K, N, generator=gen) * K ** -0.5).to(dtype),
                None, None)
    if kind == "mean_1e3":
        a = torch.randint(-1, 2, (M, K), generator=gen)
        b = torch.randint(-1, 2, (K, N), generator=gen) * 0.25
        a[:, 0], b[0] = 1, 1000.0
    else:
        a = torch.randn(M, K, generator=gen)
        b = torch.randn(K, N, generator=gen) * 0.2
        if kind == "spike":
            a[:, 0], b[0, N - 1] = 1, 30.0
    return (a.to(dtype), b.to(dtype), torch.randn(N, generator=gen),
            torch.randn(N, generator=gen))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fault,kind,shape,kernel", [
    (_fault_softmax_cta_max, "spike", (8, 64, 16384), "softmax"),
    (_fault_layernorm_uncentred, "mean_1e3", (32, 32, 4096), "layernorm"),
    (_fault_layernorm_no_allreduce, "normal", (64, 64, 4096), "layernorm"),
    (_fault_softmax_cta_sum, "normal", (48, 64, 16384), "softmax"),
    (_fault_softmax_rank_left_out, "normal", (48, 64, 16384), "softmax"),
    (_fault_softmax_rank_left_out, "bench", (4, 128, 16384), "softmax"),
])
def test_card_bars_catch_cluster_faults(fault, kind, shape, kernel, dtype):
    """The card's cases hold the kernel to its plain version within the
    bars above; each fault of the cluster's statistics, applied to the
    same kind of input, breaks the bar of its dtype."""
    a, b, g, be = _card_inputs(kind, *shape, getattr(torch, dtype))
    if kernel == "softmax":
        want = tref.gemm_softmax_ref(a, b)
    else:
        want = tref.gemm_layernorm_ref(a, b, g, be)
    err, tol = _err_and_tol(fault(a, b, g, be).to(a.dtype),
                            want.float().numpy(), dtype, kernel)
    print(f"{fault.__name__} {dtype}: max_abs_err {err:.4g}, bar {tol:.4g}")
    assert err > tol
