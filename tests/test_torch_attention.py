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


@pytest.mark.parametrize("dtype,D,window,error,message", [
    (torch.float32, 24, None, ValueError, r"head dim 24 not in \(16, 32"),
    (torch.float16, 32, None, TypeError, "must share one dtype"),
    (torch.float32, 32, 0, ValueError, "window must be >= 1, got 0"),
])
def test_flash_attention_refuses_on_the_cpu_what_the_card_refuses(
        dtype, D, window, error, message):
    """The wrapper's checks run before the CPU branch, with the card's
    messages: a CPU run never accepts what a CUDA launch would refuse."""
    q = torch.zeros(1, 4, 8, D, dtype=dtype)
    k = v = torch.zeros(1, 2, 8, D, dtype=dtype)
    before = tfa.flash_attention_fwd.launches
    with pytest.raises(error, match=message):
        tfa.flash_attention_fwd(q, k, v, causal=True, window=window)
    with pytest.raises(error, match=message):
        tops.mha(q, k, v, causal=True, window=window, use_kernel=True)
    assert tfa.flash_attention_fwd.launches == before


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


# --------------------------------------------- the kernel's tiling rule

_SMEM_BYTES = 232448 - 1024      # a CTA's shared memory less the barriers


@pytest.mark.parametrize("B,Hq,Hkv,Sq,D,heads,items", [
    (1, 2, 1, 64, 128, 2, 1),      # even group: two heads an item, 64 rows
    (1, 2, 1, 65, 128, 2, 2),
    (4, 32, 2, 1024, 128, 2, 4 * 2 * 8 * 16),   # glm4-9b's prefill
    (1, 32, 2, 1, 64, 2, 16),      # Sq = 1
    (1, 4, 4, 128, 32, 1, 4),      # group 1: one head an item, 128 rows
    (1, 4, 4, 129, 32, 1, 8),
    (2, 6, 2, 128, 16, 1, 2 * 2 * 3),   # odd group 3
    (1, 6, 2, 129, 64, 1, 2 * 3 * 2),
])
def test_bf16_tiling_at_its_boundaries(B, Hq, Hkv, Sq, D, heads, items):
    t = tfa.tiling(B, Hq, Hkv, Sq, 300, D, torch.bfloat16)
    assert (t.q_rows, t.consumers, t.keys) == (64, 2, 128)
    assert (t.heads, t.items, t.rows) == (heads, items, 128 // heads)
    assert t.grid == (min(items, tfa.SMS), 1)
    assert tfa.tiling(B, Hq, Hkv, Sq, 300, D, torch.bfloat16,
                      sms=3).grid == (min(items, 3), 1)


@pytest.mark.parametrize("D,stages", [(16, 8), (32, 8), (64, 6), (128, 3)])
def test_bf16_ring_is_as_deep_as_shared_memory_allows(D, stages):
    t = tfa.tiling(1, 2, 1, 64, 64, D, torch.bfloat16)
    assert t.stages == stages
    used = lambda n: 1024 + 2 * 64 * 2 * D + n * 2 * t.keys * 2 * D  # noqa: E731
    assert used(stages) <= _SMEM_BYTES
    assert stages == 8 or used(stages + 1) > _SMEM_BYTES


@pytest.mark.parametrize("B,Hq,Sq", [(1, 4, 64), (2, 3, 65), (1, 1, 1)])
def test_f32_tiling_is_a_cta_per_64_rows_of_a_head(B, Hq, Sq):
    t = tfa.tiling(B, Hq, 1, Sq, 10, 32, torch.float32)
    nqt = -(-Sq // 64)
    assert t == tfa.Tiling(64, 1, 64, 1, 1, nqt * B * Hq, (nqt, B * Hq))


@pytest.mark.parametrize("args,error,message", [
    ((1, 4, 2, 8, 8, 24, torch.bfloat16), ValueError, "head dim 24"),
    ((1, 4, 3, 8, 8, 32, torch.bfloat16), ValueError, "unsupported sizes"),
    ((1, 65536, 1, 8, 8, 32, torch.float32), ValueError, "exceeds the grid"),
    ((1, 4, 2, 8, 8, 32, torch.float16), TypeError, "no tiling"),
])
def test_tiling_refuses_what_the_kernel_does_not_take(args, error, message):
    with pytest.raises(error, match=message):
        tfa.tiling(*args)


def _strided(shape, strides, offset=0, dtype=torch.bfloat16):
    base = torch.zeros(offset + sum((n - 1) * s for n, s in
                                    zip(shape, strides)) + 1, dtype=dtype)
    return base.as_strided(shape, strides, offset)


@pytest.mark.parametrize("case", ["row_stride", "base", "zero_stride"])
def test_tma_checks_refuse_on_the_cpu_what_the_card_refuses(case):
    """bf16 tiles move by TMA: a 16-byte aligned base and nonzero strides of
    a multiple of 16 bytes.  The CPU refuses the same inputs with the card's
    message, through the wrapper and through ``ops.mha``; f32 takes them."""
    q = torch.zeros(1, 4, 8, 32, dtype=torch.bfloat16)
    k = v = torch.zeros(1, 2, 8, 32, dtype=torch.bfloat16)
    if case == "row_stride":      # rows 72 bytes apart
        q = _strided((1, 4, 8, 32), (4 * 8 * 36, 8 * 36, 36, 1))
    elif case == "base":          # base 2 bytes past a 16-byte boundary
        q = _strided((1, 4, 8, 32), (4 * 8 * 32, 8 * 32, 32, 1), offset=1)
    else:                         # kv heads expanded from one
        k = v = torch.zeros(1, 1, 8, 32, dtype=torch.bfloat16).expand(
            1, 2, 8, 32)
    before = tfa.flash_attention_fwd.launches
    for fn in (lambda: tfa.flash_attention_fwd(q, k, v, causal=True),
               lambda: tops.mha(q, k, v, causal=True, use_kernel=True)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn()
    assert tfa.flash_attention_fwd.launches == before
    assert tfa.flash_attention_fwd(q.float(), k.float(), v.float()).shape \
        == q.shape


def test_a_size_one_dim_takes_any_stride():
    """A dim of size 1 is never stepped: its stride reaches the tensor map
    as the head dim's extent, whatever the view gives it."""
    k = _strided((1, 1, 8, 32), (3, 5, 32, 1))
    q = torch.zeros(1, 2, 8, 32, dtype=torch.bfloat16)
    assert tfa.kernel_strides(k) == (32, 32, 32)
    tfa._check(q, k, k, None)


# --------------------------------------- bytes the tiling moves through L2

def _brute_l2_bytes(B, Hq, Hkv, Sq, Skv, D, causal, window, dtype):
    """Walk every q tile of every work item and every key of every K/V
    tile: a tile is read if any of the item's rows sees any of its keys."""
    t = tfa.tiling(B, Hq, Hkv, Sq, Skv, D, dtype)
    e = 2 if dtype == torch.bfloat16 else 4
    qpos = np.arange(Sq)[:, None] + (Skv - Sq)
    kpos = np.arange(Skv)[None, :]
    vis = np.ones((Sq, Skv), bool)
    if causal:
        vis &= qpos >= kpos
    if window is not None:
        vis &= qpos - kpos < window
    q_bytes = kv_bytes = 0
    for b in range(B):
        for h0 in range(0, Hq, t.heads):          # an item's heads
            for q0 in range(0, Sq, t.rows):
                rows = vis[q0:q0 + t.rows]
                tiles = [j for j in range(-(-Skv // t.keys))
                         if rows[:, j * t.keys:(j + 1) * t.keys].any()]
                if tiles or dtype == torch.float32:
                    q_bytes += rows.shape[0] * t.heads * D * e
                kv_bytes += sum(2 * min(t.keys, Skv - j * t.keys) * D * e
                                for j in tiles)
    return q_bytes, kv_bytes, B * Hq * Sq * D * e


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,window", [
    (4, 32, 2, 1024, 1024, 128, True, None),   # glm4-9b's prefill
    (1, 32, 2, 200, 333, 64, True, None),      # group 16, ragged
    (2, 4, 2, 130, 130, 32, False, None),      # group 2
    (1, 3, 3, 257, 257, 16, True, 100),        # group 1, window
    (1, 4, 4, 300, 130, 64, True, None),       # Sq > Skv: items see nothing
    (1, 6, 2, 150, 400, 128, False, 60),       # odd group, window
    (1, 2, 1, 1, 500, 32, True, None),         # Sq = 1
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_l2_bytes_matches_a_count_over_the_tiles(
        B, Hq, Hkv, Sq, Skv, D, causal, window, dtype):
    from repro_torch.launch.kernel_bench import attention_l2_bytes
    assert attention_l2_bytes(B, Hq, Hkv, Sq, Skv, D, causal, window,
                              dtype) == _brute_l2_bytes(
        B, Hq, Hkv, Sq, Skv, D, causal, window, dtype)


def test_glm4_prefill_kv_bytes():
    """glm4-9b's prefill: each of the 4 x 2 x 8 items at q tile i (two q
    heads, 64 rows) reads ceil(64 (i + 1) / 128) K/V tiles of 128 keys,
    0.30 GB in all: half of what one q head a K/V tile would read."""
    from repro_torch.launch.kernel_bench import attention_l2_bytes
    _, kv, _ = attention_l2_bytes(4, 32, 2, 1024, 1024, 128, True, None,
                                  torch.bfloat16)
    assert kv == 4 * 2 * 8 * sum(-(-64 * (i + 1) // 128) for i in range(16)) \
        * 2 * 128 * 128 * 2


def test_attention_sweep_runs_untimed_on_the_cpu():
    """The bench's FlashAttention sweep at small shapes: one counted call a
    shape, nothing timed off the card, and no library time where SDPA's
    causal mask (aligned to the start of kv) is another function."""
    from repro_torch.launch.kernel_bench import attention_sweep
    out = attention_sweep("cpu", shapes=[(1, 4, 2, 64, 64, 32, True),
                                         (1, 4, 2, 64, 200, 32, True),
                                         (1, 2, 2, 64, 100, 16, False)])
    assert out["calls"] == {"flash_attention": 3}
    recs = out["records"]
    assert all(r["ms"] is None and r["device_ms"] is None for r in recs)
    assert [r["library"] is not None for r in recs] == [True, False, True]
    assert [r["shape"]["causal"] for r in recs] == [True, True, False]
    assert all(r["max_abs_err"] == 0.0 for r in recs)
