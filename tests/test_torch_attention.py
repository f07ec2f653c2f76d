"""Port attention against the JAX package on the CPU: the plain reference,
``ops.mha`` (which on CPU tensors takes the plain reference) against the
Pallas kernel in interpret mode, the fully-masked-row case, the
recompute backward, the model's blocked/banded paths, and the kernel
wrapper's input checks.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: 2e-5 in f32 and 3e-2 in bf16 (``TOL`` of tests/test_kernels.py:
f32 differs only by summation order; bf16 rounds the inputs and the
output), 1e-4 for gradients (as tests/test_kernels.py's grad test).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models.convert import tensor_from_numpy

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(seed, B, Hq, Hkv, Sq, Skv, D, dtype):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=s).astype(np.float32)
          for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]
    jx = [jnp.asarray(x, getattr(jnp, dtype)) for x in xs]
    tx = [tensor_from_numpy(np.asarray(x)) for x in jx]   # same bits
    return jx, tx


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


SHAPES = [
    (1, 4, 4, 128, 128, 64),      # MHA square
    (2, 8, 2, 64, 192, 32),       # GQA, kv longer
    (1, 2, 2, 100, 100, 128),     # ragged, non-multiple of block
]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_jax(B, Hq, Hkv, Sq, Skv, D, dtype, causal):
    jx, tx = _inputs(1, B, Hq, Hkv, Sq, Skv, D, dtype)
    out = tref.attention_ref(*tx, causal=causal)
    assert out.dtype == tx[0].dtype
    _close(out, jref.attention_ref(*jx, causal=causal), TOL[dtype])


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D", SHAPES[:2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_mha_kernel_path_matches_jax_pallas(B, Hq, Hkv, Sq, Skv, D, dtype,
                                            causal):
    jx, tx = _inputs(2, B, Hq, Hkv, Sq, Skv, D, dtype)
    want = jops.flash_attention(*jx, causal, None, None, 64, 64, True)
    _close(tops.mha(*tx, causal=causal, use_kernel=True), want, TOL[dtype])


def test_mha_window_matches_jax_pallas():
    jx, tx = _inputs(3, 1, 4, 4, 256, 256, 64, "float32")
    want = jops.flash_attention(*jx, True, None, 64, 128, 128, True)
    _close(tops.mha(*tx, causal=True, window=64, use_kernel=True), want,
           2e-5)


def test_fully_masked_rows_give_zero_like_jax_ref():
    """Causal with Sq > Skv: q rows before the first key see no key.  The
    port gives 0 there, as the JAX reference does (the JAX Pallas kernel
    gives the mean of V instead; see ROADMAP Queue C)."""
    jx, tx = _inputs(4, 1, 2, 2, 8, 4, 32, "float32")
    out = tops.mha(*tx, causal=True, use_kernel=True)
    _close(out, jref.attention_ref(*jx, causal=True), 2e-5)
    assert torch.count_nonzero(out[:, :, :4]) == 0
    assert torch.count_nonzero(out[:, :, 4:]) > 0


def test_flash_attention_grads_match_ref_autograd():
    _, tx = _inputs(5, 1, 2, 2, 128, 128, 32, "float32")
    a = [t.clone().requires_grad_(True) for t in tx]
    b = [t.clone().requires_grad_(True) for t in tx]
    tfa.flash_attention(*a, True).sum().backward()
    tref.attention_ref(*b, causal=True).sum().backward()
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), atol=1e-4)


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, None, 0), (False, None, 0), (True, 24, 0), (True, None, 16)])
def test_blocked_attention_matches_jax(causal, window, q_offset):
    Skv = 100
    jx, tx = _inputs(6, 1, 4, 2, Skv - q_offset, Skv, 16, "float32")
    kw = dict(causal=causal, window=window, scale=0.25, block_k=32,
              q_offset=q_offset)
    _close(tattn.blocked_attention(*tx, **kw),
           jattn.blocked_attention(*jx, **kw), 2e-5)


def test_banded_window_attention_matches_jax():
    jx, tx = _inputs(7, 1, 4, 2, 70, 70, 16, "float32")
    _close(tattn.banded_window_attention(*tx, window=16, scale=0.25),
           jattn.banded_window_attention(*jx, window=16, scale=0.25), 2e-5)


@pytest.mark.parametrize("case", ["head_dim", "dtype", "stride", "window",
                                  "heads"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(case):
    q = torch.zeros(1, 4, 8, 32, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 8, 32, dtype=torch.bfloat16)
    v, window = k, None
    if case == "head_dim":
        q, k = q[..., :24].contiguous(), k[..., :24].contiguous()
        v = k
    elif case == "dtype":
        q = q.half()
    elif case == "stride":
        q = torch.zeros(1, 4, 32, 8, dtype=torch.bfloat16).transpose(2, 3)
    elif case == "window":
        window = 0
    elif case == "heads":
        k = v = torch.zeros(1, 3, 8, 32, dtype=torch.bfloat16)
    with pytest.raises((ValueError, TypeError)):
        tfa._check(q, k, v, window)


def test_kernel_wrapper_accepts_model_layout_views():
    """The model hands in (B, H, S, D) views of (B, S, H, D) projections."""
    q = torch.zeros(2, 16, 4, 32, dtype=torch.bfloat16).transpose(1, 2)
    k = torch.zeros(2, 16, 2, 32, dtype=torch.bfloat16).transpose(1, 2)
    tfa._check(q, k, k, None)
