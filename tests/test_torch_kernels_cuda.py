"""The FlashAttention, SSD and fused GEMM-epilogue kernels on the card
against their plain versions.

These tests need an NVIDIA Hopper card (marker ``cuda``) and skip
elsewhere; on the card run them with
    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
This file imports no JAX, so it runs where only PyTorch is installed.
Tolerances: FlashAttention 2e-5 in f32, 3e-2 in bf16 (``TOL`` of
tests/test_kernels.py); SSD 2e-3 in f32 (tests/test_kernels.py's SSD bar)
and, in bf16, 1e-2 of the output's largest magnitude (both sides round y
to bf16, one step of which is up to 2^-7 of the largest |y|; the kernel
rounds two of its product operands to bf16); the fused GEMM epilogues
those of ``gemm_epilogue.tolerance``: softmax 2e-5 and the norms 1e-4 in
f32, and all three 1e-2 of the output's largest magnitude in bf16 (both
sides round the output to bf16, one step of which is up to 2^-7 of the
largest |y|; relative, because softmax outputs near 1/N would pass an
absolute bar as zeros).
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm_epilogue as ge
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import ssd
from repro_torch.kernels.gemm_layernorm import gemm_layernorm, gemm_rmsnorm
from repro_torch.kernels.gemm_softmax import gemm_softmax
from repro_torch.kernels.ref import attention_ref, ssd_chunked_ref

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture
def hopper():
    """Skip unless a compute-capability 9.0 card is present (decided here,
    not at import, so every test worker collects the same tests)."""
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA Hopper (sm_90) card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def _qkv(gen, B, Hq, Hkv, Sq, Skv, D, dtype):
    return [torch.randn(B, H, S, D, generator=gen, device="cuda", dtype=dtype)
            for H, S in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv))]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D", [
    (1, 4, 4, 128, 128, 64),
    (2, 8, 2, 128, 256, 64),
    (1, 4, 1, 64, 192, 32),
    (1, 2, 2, 100, 100, 128),
    (1, 4, 2, 72, 72, 16),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain_version(hopper, B, Hq, Hkv, Sq, Skv, D, dtype,
                                      causal):
    q, k, v = _qkv(hopper, B, Hq, Hkv, Sq, Skv, D, dtype)
    before = fa.flash_attention_fwd.launches
    out = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    want = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_window_and_fully_masked_rows(hopper, dtype):
    q, k, v = _qkv(hopper, 1, 4, 4, 256, 256, 64, dtype)
    out = ops.mha(q, k, v, causal=True, window=64, use_kernel=True)
    want = attention_ref(q, k, v, causal=True, window=64)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    q, k, v = _qkv(hopper, 1, 2, 2, 100, 40, 32, dtype)
    out = fa.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert (out[:, :, :60] == 0).all()
    torch.testing.assert_close(out.float(),
                               attention_ref(q, k, v, causal=True).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_kernel_reads_strided_model_layout_and_backward(hopper):
    q, k, v = [torch.randn(2, 128, H, 32, generator=hopper, device="cuda")
               .transpose(1, 2).requires_grad_(True) for H in (8, 2, 2)]
    out = fa.flash_attention(q, k, v, True)
    want = attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
    g1 = torch.autograd.grad(out.sum(), (q, k, v))
    g2 = torch.autograd.grad(want.sum(), (q, k, v))
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_kernel_raises_instead_of_falling_back(hopper):
    q, k, v = _qkv(hopper, 1, 4, 2, 16, 16, 48, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q, k, v)


def _ssd_inputs(gen, BH, S, P, N, dtype):
    x = torch.randn(BH, S, P, generator=gen, device="cuda").to(dtype)
    dA = -torch.rand(BH, S, generator=gen, device="cuda") * 0.2
    B = torch.randn(BH, S, N, generator=gen, device="cuda").to(dtype)
    C = torch.randn(BH, S, N, generator=gen, device="cuda").to(dtype)
    return x, dA, B, C


@pytest.mark.parametrize("BH,S,P,N,chunk", [
    (2, 128, 16, 32, 64),
    (4, 256, 32, 64, 64),
    (1, 200, 16, 32, 64),
    (4, 96, 16, 16, 64),
    (4, 24, 16, 16, 8),
    (3, 100, 64, 128, 64),
    (2, 256, 64, 128, 32),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain_version(hopper, BH, S, P, N, chunk, dtype):
    x, dA, B, C = _ssd_inputs(hopper, BH, S, P, N, dtype)
    before = ssd.ssd_scan_fwd.launches
    out = ssd.ssd_scan_fwd(x, dA, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan_fwd.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    want = ssd_chunked_ref(x, dA, B, C, chunk=min(chunk, S))
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, atol=2e-3, rtol=2e-3)
    else:
        err = (out.float() - want.float()).abs().max()
        assert err <= 1e-2 * want.float().abs().max()


def test_ssd_kernel_through_ops_and_backward(hopper):
    x, dA, B, C = [t.requires_grad_(True) for t in
                   _ssd_inputs(hopper, 2, 128, 16, 32, torch.float32)]
    out = ops.ssd(x, dA, B, C, chunk=64, use_kernel=True)
    want = ssd_chunked_ref(x, dA, B, C, chunk=64)
    torch.testing.assert_close(out, want, atol=2e-3, rtol=2e-3)
    g1 = torch.autograd.grad(out.sum(), (x, dA, B, C))
    g2 = torch.autograd.grad(want.sum(), (x, dA, B, C))
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_ssd_kernel_raises_instead_of_falling_back(hopper):
    x, dA, B, C = _ssd_inputs(hopper, 1, 64, 16, 32, torch.bfloat16)
    before = ssd.ssd_scan_fwd.launches
    with pytest.raises(ValueError, match="state dim"):
        ssd.ssd_scan_fwd(x, dA, B[..., :24].contiguous(),
                         C[..., :24].contiguous())
    with pytest.raises(ValueError, match="16-byte aligned"):
        ssd.ssd_scan_fwd(x, dA, B[:, :, 1:17], C[:, :, 1:17])
    assert ssd.ssd_scan_fwd.launches == before


GEMM_KERNELS = ("softmax", "layernorm", "rmsnorm")


def _gemm_inputs(gen, M, K, N, dtype, kind="normal"):
    """a (M, K), b (K, N) in ``dtype``, f32 gamma/beta (N,).  ``spike``:
    column N - 1 of C exceeds the rest by about 30, so each row's max lies
    in the last CTA's slice.  ``mean_1e3``: rows of C are 1000 plus a sum of
    31 products of {-1, 0, 1} and {-0.25, 0, 0.25}, exact in both dtypes."""
    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale
    if kind == "mean_1e3":
        a = torch.randint(-1, 2, (M, K), generator=gen, device="cuda")
        b = torch.randint(-1, 2, (K, N), generator=gen, device="cuda") * 0.25
        a[:, 0], b[0] = 1, 1000.0
        a, b = a.to(dtype), b.to(dtype)
    else:
        a, b = rand(M, K).to(dtype), rand(K, N, scale=0.2).to(dtype)
        if kind == "spike":
            a[:, 0], b[0, N - 1] = 1, 30.0
    return a, b, rand(N), rand(N)


def _gemm_check(kernel, a, b, g, be):
    fn = {"softmax": gemm_softmax, "layernorm": gemm_layernorm,
          "rmsnorm": gemm_rmsnorm}[kernel]
    before = fn.launches
    if kernel == "softmax":
        out, want = fn(a, b), ref.gemm_softmax_ref(a, b)
    elif kernel == "layernorm":
        out, want = fn(a, b, g, be), ref.gemm_layernorm_ref(a, b, g, be)
    else:
        out, want = fn(a, b, g), ref.gemm_rmsnorm_ref(a, b, g)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert out.dtype == a.dtype and out.shape == want.shape
    assert torch.isfinite(out).all()
    err = (out.float() - want.float()).abs().max()
    tol = ge.tolerance(kernel, a.dtype, float(want.float().abs().max()))
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("M,K,N", [
    (128, 64, 256), (200, 96, 256), (64, 128, 512), (96, 100, 128),  # JAX
    (200, 100, 1000),                  # ragged M/K/N, cluster 1
    (33, 40, 1032),                    # cluster 2, a ragged last slice
    (64, 64, 4096),                    # cluster 4
    (17, 72, 4104),                    # cluster 8, a ragged last slice
    (48, 64, 16384),                   # cluster 16
    (1, 128, 16384), (4, 128, 16384),  # the paper's M 1 and M 4
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", GEMM_KERNELS)
def test_gemm_epilogue_matches_plain_version(hopper, M, K, N, dtype, kernel):
    _gemm_check(kernel, *_gemm_inputs(hopper, M, K, N, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_softmax_max_in_the_last_slice(hopper, dtype):
    """The max must be the cluster's row max, not the CTA's."""
    a, b, g, be = _gemm_inputs(hopper, 8, 64, 16384, dtype, "spike")
    assert ge.cluster_size(16384) == 16
    _gemm_check("softmax", a, b, g, be)
    assert (gemm_softmax(a, b)[:, -1].float() > 0.99).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_layernorm_rows_of_mean_1e3(hopper, dtype):
    """The centred variance: E[c^2] - mean^2 in f32 loses these rows."""
    _gemm_check("layernorm", *_gemm_inputs(hopper, 32, 32, 4096, dtype,
                                           "mean_1e3"))


@pytest.mark.parametrize("kernel", GEMM_KERNELS)
def test_gemm_epilogue_largest_shape_three_times(hopper, kernel):
    """A missing cluster barrier shows only now and then."""
    inputs = _gemm_inputs(hopper, 4096, 4096, 16384, torch.bfloat16)
    for _ in range(3):
        _gemm_check(kernel, *inputs)


def test_gemm_epilogue_clusters_can_be_placed(hopper):
    assert ge.slice_columns() == ge.SLICE_COLUMNS
    for dtype in (torch.float32, torch.bfloat16):
        for epi in ge.EPILOGUES:
            for cl in ge.CLUSTER_SIZES:
                assert ge.max_active_clusters(epi, dtype, cl) > 0


def test_gemm_epilogue_raises_instead_of_falling_back(hopper):
    a = torch.randn(4, 32, device="cuda")
    before = gemm_softmax.launches
    with pytest.raises(ValueError, match="does not fit 16 slices"):
        gemm_softmax(a, torch.randn(32, 16392, device="cuda"))
    with pytest.raises(TypeError, match="share one dtype"):
        gemm_softmax(a, torch.randn(32, 64, device="cuda").bfloat16())
    assert gemm_softmax.launches == before
