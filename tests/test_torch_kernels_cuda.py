"""The FlashAttention and SSD kernels on the card against their plain
versions.

These tests need an NVIDIA Hopper card (marker ``cuda``) and skip
elsewhere; on the card run them with
    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
This file imports no JAX, so it runs where only PyTorch is installed.
Tolerances: FlashAttention 2e-5 in f32, 3e-2 in bf16 (``TOL`` of
tests/test_kernels.py); SSD 2e-3 in f32 (tests/test_kernels.py's SSD bar)
and, in bf16, 1e-2 of the output's largest magnitude (both sides round y
to bf16, one step of which is up to 2^-7 of the largest |y|; the kernel
rounds two of its product operands to bf16).
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd
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
