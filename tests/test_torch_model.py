"""Port model against the JAX package on the CPU, on the glm4 smoke config
with the JAX package's parameters carried over by ``params_from_jax``:
full-sequence logits, prefill logits and every cache leaf, one decode
step; the kernel path on both sides; a bf16 case.  Also the config copies
and bit-exact weight conversion.  The other families' parity tests are
tests/test_torch_hybrid.py, test_torch_moe.py, test_torch_mla.py and
test_torch_encdec.py.

Tolerances: 1e-4 in f32 (two layers of f32 matmuls summed in another
order), 3e-2 in bf16 (activations rounded to bf16 at every layer, as in
``TOL`` of tests/test_kernels.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import Model as JModel
from repro_torch.configs.registry import ARCH_IDS as T_ARCH_IDS
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model

F32_TOL = 1e-4
BF16_TOL = 3e-2


def _pair(dtype="float32", **kw):
    cfg = get_smoke_config("glm4-9b").with_(dtype=dtype, **kw)
    jcfg = jget_smoke("glm4-9b").with_(dtype=dtype, **kw)
    jm, tm = JModel(jcfg), Model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)) \
        .astype(np.int32)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy() if torch.is_tensor(t) else t,
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def test_logits_match_jax():
    jm, jp, tm, tp = _pair()
    toks = _tokens(2, 24, tm.cfg.vocab_size)
    want = jm.logits(jp, {"tokens": jnp.asarray(toks)})
    got = tm.logits(tp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == want.shape
    _close(got, want, F32_TOL)


def test_prefill_cache_and_decode_step_match_jax():
    jm, jp, tm, tp = _pair()
    toks = _tokens(2, 12, tm.cfg.vocab_size, seed=1)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 20)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, 20)
    _close(tl, jl, F32_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for key in ("k", "v"):
        _close(tc["layers"]["attn"][key], jc["layers"]["attn"][key], F32_TOL)
    np.testing.assert_array_equal(tc["layers"]["attn"]["kpos"].numpy(),
                                  np.asarray(jc["layers"]["attn"]["kpos"]))
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    jl2, jc2 = jm.decode(jp, jc, jnp.asarray(nxt))
    tl2, tc2 = tm.decode(tp, tc, torch.from_numpy(nxt).long())
    _close(tl2, jl2, F32_TOL)
    np.testing.assert_array_equal(tc2["pos"].numpy(), np.asarray(jc2["pos"]))
    for key in ("k", "v"):
        _close(tc2["layers"]["attn"][key], jc2["layers"]["attn"][key],
               F32_TOL)
    np.testing.assert_array_equal(tc2["layers"]["attn"]["kpos"].numpy(),
                                  np.asarray(jc2["layers"]["attn"]["kpos"]))


def test_init_cache_matches_jax_layout():
    jm, _, tm, _ = _pair()
    jc = jm.init_cache(3, 16)
    tc = tm.init_cache(3, 16, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jc)
    assert len(jl) == 4
    for path, a in jl:
        t = tc
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(a, np.float32))


def test_kernel_path_matches_jax_kernel_path():
    """use_kernels=True on both sides at S=128 (JAX: the Pallas kernel in
    interpret mode; port on CPU tensors: the plain reference)."""
    jm, jp, tm, tp = _pair(use_kernels=True, window=None)
    toks = np.arange(128, dtype=np.int32).reshape(1, 128) % tm.cfg.vocab_size
    want = jm.logits(jp, {"tokens": jnp.asarray(toks)})
    got = tm.logits(tp, {"tokens": torch.from_numpy(toks).long()})
    _close(got, want, F32_TOL)


def test_bf16_prefill_matches_jax():
    """bf16 params and activations: prefill logits and every cache leaf.
    (Full-sequence logits of this random bf16 model stray past 3e-2 at a
    few of 16k points even between the JAX package's own bf16 and f32 runs:
    inside its layer scan XLA fuses each residual add into the matmul
    before it and rounds once, where eager PyTorch rounds twice.)"""
    jm, jp, tm, tp = _pair(dtype="bfloat16")
    toks = _tokens(2, 16, tm.cfg.vocab_size, seed=2)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 24)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, 24)
    assert tl.dtype == torch.bfloat16
    _close(tl, jl, BF16_TOL)
    for key in ("k", "v"):
        assert tc["layers"]["attn"][key].dtype == torch.bfloat16
        _close(tc["layers"]["attn"][key], jc["layers"]["attn"][key],
               BF16_TOL)


def test_windowed_prefill_ring_and_decode_match_jax():
    """Sliding-window layers: the banded prefill path, the ring-buffer
    cache and the windowed decode mask."""
    jm, jp, tm, tp = _pair(window=8)
    toks = _tokens(2, 20, tm.cfg.vocab_size, seed=3)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 32)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, 32)
    _close(tl, jl, F32_TOL)
    np.testing.assert_array_equal(tc["layers"]["attn"]["kpos"].numpy(),
                                  np.asarray(jc["layers"]["attn"]["kpos"]))
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    jl2, _ = jm.decode(jp, jc, jnp.asarray(nxt))
    tl2, _ = tm.decode(tp, tc, torch.from_numpy(nxt).long())
    _close(tl2, jl2, F32_TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_jax_field_by_field(arch):
    assert T_ARCH_IDS == ARCH_IDS
    for mine, theirs in ((get_config(arch), jget_config(arch)),
                         (get_smoke_config(arch), jget_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.padded_vocab == theirs.padded_vocab
        assert mine.hd == theirs.hd
        assert mine.n_params() == theirs.n_params()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_from_jax_is_bit_exact(dtype):
    jm, jp, tm, tp = _pair(dtype=dtype)
    assert Model(tm.cfg).n_params() == jm.n_params()
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jleaves) == len(jax.tree.leaves(tp)) == 12
    for path, a in jleaves:
        t = tp
        for p in path:
            t = t[p.key]
        assert t.dtype == getattr(torch, dtype)
        bits = np.uint16 if dtype == "bfloat16" else np.uint32
        np.testing.assert_array_equal(
            t.view(torch.int16 if dtype == "bfloat16" else torch.int32)
            .numpy().view(bits), np.asarray(a).view(bits))


def test_torch_init_shapes_dtypes_and_determinism():
    cfg = get_smoke_config("glm4-9b")
    tm = Model(cfg)
    a, b = tm.init(0, device="cpu"), tm.init(0, device="cpu")
    jshapes = jax.tree.map(lambda s: (s.shape, str(s.dtype)),
                           JModel(jget_smoke("glm4-9b")).abstract_params())
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), a) \
        == jshapes
    assert all(torch.equal(x, y) for x, y in
               zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    # the layer-stacked leaves are drawn slice by slice: slices differ
    wq = a["layers"]["attn"]["wq"]
    assert not torch.equal(wq[0], wq[1])
    assert abs(float(wq.float().std()) * cfg.d_model ** 0.5 - 1.0) < 0.1
