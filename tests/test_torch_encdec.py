"""Port of the enc-dec family (seamless-m4t-medium: a bidirectional
encoder over stub frame embeddings, a decoder of causal self-attention,
cross-attention over the encoder output and an MLP, LayerNorm) against the
JAX package on the CPU, on the seamless smoke config, with the same
seeded ``src_embeds`` on both sides: logits, prefill caches (``self`` grown
to the cache length, ``cross``) and three decode steps, bf16 prefill, the
kernel path, cross-attention's decode against its full form, the weights
bit for bit, greedy serving (the engine feeds zero frame embeddings, as
the JAX engine does).

Tolerances: 1e-4 in f32, 3e-2 in bf16 (tests/torch_family.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_family as fam
from repro.models import attention as jattn
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.models.model import Model

ARCH = "seamless-m4t-medium"


def test_logits_match_jax():
    fam.check_logits(ARCH)


def test_prefill_caches_and_three_decode_steps_match_jax():
    fam.check_prefill_and_decode(ARCH, S=16)


def test_bf16_prefill_matches_jax():
    fam.check_bf16_prefill(ARCH)


def test_kernel_path_matches_jax_kernel_path():
    """use_kernels=True on both sides at S 128 (16 encoder frames): the
    encoder's non-causal self-attention, the decoder's causal one and the
    cross-attention (Sq 128, Skv 16) through the Pallas kernel in
    interpret mode on the JAX side, through the kernel's plain version on
    CPU tensors on the port's."""
    jm, jp, tm, tp = fam.pair(ARCH, use_kernels=True)
    jb, tb = fam.batches(tm.cfg, 1, 128, seed=4)
    want = jm.logits(jp, jb)
    got = tm.logits(tp, tb)
    fam.close(got, want, fam.F32_TOL)


def test_every_attention_takes_the_kernel_entry(monkeypatch):
    """A prefill hands each encoder layer's self-attention (non-causal, Sq =
    Skv = S / 8), each decoder layer's causal self-attention and each
    cross-attention (non-causal, Sq = S, Skv = S / 8) to ``ops.mha`` with
    use_kernel=True: 3 x layers calls."""
    cfg = get_smoke_config(ARCH).with_(dtype="float32", use_kernels=True)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    calls = []
    mha = tops.mha

    def spy(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2], kw["causal"],
                      kw["use_kernel"]))
        return mha(q, k, v, **kw)

    monkeypatch.setattr(tops, "mha", spy)
    B, S = 2, 64
    model.prefill(params, {"tokens": torch.zeros(B, S, dtype=torch.long),
                           "src_embeds": torch.randn(B, S // 8,
                                                     cfg.d_model)}, 80)
    L = cfg.n_layers
    assert calls == [(8, 8, False, True)] * cfg.n_enc_layers \
        + [(64, 64, True, True), (64, 8, False, True)] * L


def test_cross_decode_matches_cross_attention_and_jax():
    """One decode step's cross-attention over the cached encoder K/V
    equals the full cross-attention's row for that position, and JAX's
    step."""
    jm, jp, tm, tp = fam.pair(ARCH)
    cfg = tm.cfg
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    jpl = jax.tree.map(lambda a: a[0], jp["dec_layers"]["cross"])
    tpl = jax.tree.map(lambda a: a[0], tp["dec_layers"]["cross"])
    tx, tenc = torch.from_numpy(x), torch.from_numpy(enc)
    full = tattn.cross_train(cfg, tpl, tx, tenc)
    cc = tattn.make_cross_cache(cfg, tpl, tenc)
    step = tattn.cross_decode(cfg, tpl, tx[:, -1:], cc)
    torch.testing.assert_close(step, full[:, -1:], atol=1e-5, rtol=1e-5)
    jstep = jattn.cross_decode(
        jm.cfg, jpl, jnp.asarray(x[:, -1:]),
        jattn.make_cross_cache(jm.cfg, jpl, jnp.asarray(enc)))
    fam.close(step, jstep, fam.F32_TOL)


def test_init_cache_layout_matches_jax():
    fam.check_init_cache_layout(ARCH)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_from_jax_is_bit_exact(dtype):
    fam.check_params_bit_exact(ARCH, dtype)


def test_init_matches_jax_specs():
    fam.check_init_matches_jax_specs(ARCH)


def test_greedy_outputs_token_identical_to_jax_engine():
    fam.check_engine_tokens_match_jax(ARCH)


def test_refill_matches_serial_decoding():
    """The splice walks the ``self`` and ``cross`` caches."""
    fam.check_refill_matches_serial(ARCH)


def test_serve_cli_runs_on_the_cpu_when_asked(capsys):
    fam.check_serve_cli(ARCH, capsys)
