"""Port of the hybrid family (hymba-1.5b: attention and Mamba-2 SSD heads
in every layer, mixed as 0.5 * (a * alpha_attn + s * alpha_ssm)) against
the JAX package on the CPU, on the hymba smoke config: logits, prefill
caches ({"attn", "ssm"}, the windowed ring) and three decode steps, bf16
prefill, the kernel path, the weights bit for bit, greedy serving.

Tolerances: 1e-4 in f32, 3e-2 in bf16 on one layer (tests/torch_family.py;
the whole model's bf16 logits against the JAX package's own fusion noise,
``check_bf16_prefill_within_jax_fusion_noise``).  5e-3 for the kernel
path's logits, the bar of tests/test_models_smoke.py's
test_pallas_kernel_path_in_model between the JAX package's own kernel and
plain paths.  2e-3
(``FLIP_TOL``) for the longer prompts of the window tests, as tests/test_torch_ssm.py holds mamba2's at S 128: the
SSD inputs are rounded to bf16 on both sides even in an f32 config, and
the two packages' f32 xdt straddle a bf16 rounding boundary at a few
elements, which then differ by one bf16 step (2^-8 relative) and move the
next layer's inputs, and its SSD state, by several 1e-4 (6.3e-4 of a
largest |state| of 5.9 at S 24).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_family as fam
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels import autotune
from repro_torch.kernels import ops as tops
from repro_torch.models import transformer
from repro_torch.models.model import Model
from repro_torch.serve.engine import ServeEngine

ARCH = "hymba-1.5b"
FLIP_TOL = 2e-3


def test_logits_match_jax():
    fam.check_logits(ARCH)


def test_prefill_caches_and_three_decode_steps_match_jax():
    fam.check_prefill_and_decode(ARCH)


def test_windowed_ring_prefill_and_decode_past_the_window_match_jax():
    """S 40 > window 32: the prefill's ring path (S < 2 x window keeps it
    off the banded path), then decode steps that wrap the ring."""
    fam.check_prefill_and_decode(ARCH, B=2, S=40, cache_len=48, steps=3,
                                 tol=FLIP_TOL)


def test_banded_prefill_matches_jax():
    """S 70 >= 2 x window 32: the banded window path."""
    fam.check_prefill_and_decode(ARCH, B=1, S=70, cache_len=80, steps=1,
                                 tol=FLIP_TOL)


def test_bf16_layer_prefill_matches_jax():
    fam.check_bf16_layer(ARCH)


def test_bf16_prefill_within_the_jax_packages_own_fusion_noise():
    """Whole-model bf16 prefill: at S 16 the JAX package's jitted and
    op-by-op runs are 0.033-0.047 apart in hymba's logits, past the 3e-2
    bar at some inputs; the port is held to twice that."""
    fam.check_bf16_prefill_within_jax_fusion_noise(ARCH)


def test_init_cache_layout_matches_jax():
    fam.check_init_cache_layout(ARCH)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_from_jax_is_bit_exact(dtype):
    fam.check_params_bit_exact(ARCH, dtype)


def test_init_matches_jax_specs():
    fam.check_init_matches_jax_specs(ARCH)


def test_kernel_path_matches_jax_kernel_path():
    """use_kernels=True on both sides at S 128 with no window (JAX: the
    FlashAttention and SSD Pallas kernels in interpret mode; the port on
    CPU tensors: their plain versions, the state dim 8 zero-padded to the
    SSD kernel's least, 16), as tests/test_models_smoke.py runs it."""
    jm, jp, tm, tp = fam.pair(ARCH, use_kernels=True, window=None)
    toks = np.arange(128, dtype=np.int32).reshape(1, 128) % tm.cfg.vocab_size
    want = jm.logits(jp, {"tokens": jnp.asarray(toks)})
    got = tm.logits(tp, {"tokens": torch.from_numpy(toks).long()})
    fam.close(got, want, 5e-3)


def test_kernel_path_calls_both_kernels_once_a_layer(monkeypatch):
    """Every hybrid layer's prefill hands attention to ``ops.mha`` and the
    scan to ``ops.ssd`` with use_kernel=True, the scan at the plan's chunk
    with B/C zero-padded to N 16."""
    cfg = get_smoke_config(ARCH).with_(dtype="float32",
                                           use_kernels=True, window=None)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    calls = []
    mha, ssd = tops.mha, tops.ssd

    def spy_mha(q, k, v, **kw):
        calls.append(("mha", kw["use_kernel"]))
        return mha(q, k, v, **kw)

    def spy_ssd(x, dA, B, C, **kw):
        calls.append(("ssd", kw["use_kernel"], kw["chunk"], B.shape[-1]))
        return ssd(x, dA, B, C, **kw)

    monkeypatch.setattr(tops, "mha", spy_mha)
    monkeypatch.setattr(tops, "ssd", spy_ssd)
    toks = torch.arange(2 * 40).reshape(2, 40) % cfg.vocab_size
    model.prefill(params, {"tokens": toks}, 48)
    chunk = autotune.ssd_chunk_len(40, cfg.ssm_headdim, cfg.ssm_state)
    assert calls == [("mha", True), ("ssd", True, chunk, 16)] * cfg.n_layers


def test_hybrid_mix_rounds_in_the_jax_order():
    """bf16: each product and the sum round to bf16 before the halving, as
    ``0.5 * (a * alpha_attn + s * alpha_ssm)`` does in JAX."""
    g = torch.Generator().manual_seed(0)
    a, s, wa, ws = [torch.randn(64, generator=g).to(torch.bfloat16)
                    for _ in range(4)]
    got = transformer._hybrid_mix({"alpha_attn": wa, "alpha_ssm": ws}, a, s)
    want = 0.5 * (jnp.asarray(a.float().numpy(), jnp.bfloat16)
                  * jnp.asarray(wa.float().numpy(), jnp.bfloat16)
                  + jnp.asarray(s.float().numpy(), jnp.bfloat16)
                  * jnp.asarray(ws.float().numpy(), jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_greedy_outputs_token_identical_to_jax_engine():
    fam.check_engine_tokens_match_jax(ARCH)


def test_refill_matches_serial_decoding():
    fam.check_refill_matches_serial(ARCH)


def test_engine_plans_attention_and_the_ssd_chunk():
    """hymba's engine asks for both kernels' plans, as the JAX engine does:
    the attention blocks of its prefill and decode and the SSD chunk of its
    prompt (the serving shape the card runs: batch 4, prompt 1536, cache
    2048)."""
    model = Model(get_config(ARCH))
    eng = ServeEngine(model, {"w": torch.zeros(1)}, batch_size=4,
                      cache_len=2048, prompt_len=1536, plan_warmup=False)
    assert eng.plan_shapes() == {
        "attention_blocks": [(1536, 1536, 64), (1, 2048, 64)],
        "ssd_chunk_len": [(1536, 64, 16)]}


def test_serve_cli_runs_on_the_cpu_when_asked(capsys):
    fam.check_serve_cli(ARCH, capsys)
