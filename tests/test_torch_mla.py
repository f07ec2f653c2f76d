"""Port of MLA and the DeepSeek MoE variant (deepseek-v3-671b: multi-head
latent attention with a compressed cache, absorbed decode, a sigmoid
router whose bias only picks experts, one shared expert, leading dense
layers in a stack of their own) against the JAX package on the CPU, on the
deepseek smoke config: logits, prefill caches (``dense`` and ``layers``,
MLA's ``ckv``/``kr``) and three decode steps, bf16 layers, absorbed decode
against the non-absorbed attention, the weights bit for bit, greedy
serving.

Tolerances: 1e-4 in f32, 3e-2 in bf16 on one layer with identical inputs
(tests/torch_family.py; a whole model's bf16 rounding can flip a top-k
choice near a tie).
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

ARCH = "deepseek-v3-671b"


def test_logits_match_jax():
    fam.check_logits(ARCH)


def test_prefill_caches_and_three_decode_steps_match_jax():
    fam.check_prefill_and_decode(ARCH)


def test_model_has_a_dense_stack_and_its_cache():
    cfg = get_smoke_config(ARCH)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    assert "mlp" in params["dense_layers"] and "moe" in params["layers"]
    assert params["dense_layers"]["norm1"]["scale"].shape[0] \
        == cfg.first_dense_layers
    assert params["layers"]["moe"]["wi"].shape[0] \
        == cfg.n_layers - cfg.first_dense_layers
    cache = model.init_cache(2, 16, device="cpu")
    assert set(cache) == {"pos", "dense", "layers"}
    assert set(cache["dense"]["attn"]) == {"ckv", "kr"}


@pytest.mark.parametrize("stack", ["dense_layers", "layers"])
def test_bf16_layer_prefill_matches_jax(stack):
    fam.check_bf16_layer(ARCH, stack=stack)


def _mla_case(S=12, B=2, seed=0):
    jm, jp, tm, tp = fam.pair(ARCH)
    x = np.random.default_rng(seed).standard_normal(
        (B, S, tm.cfg.d_model)).astype(np.float32)
    jpl = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tpl = jax.tree.map(lambda a: a[0], tp["layers"]["attn"])
    return jm.cfg, jpl, jnp.asarray(x), tm.cfg, tpl, torch.from_numpy(x)


def test_absorbed_decode_matches_non_absorbed_attention():
    """The last position's attention output: absorbed decode (latent
    space, over the cache of the first S - 1 positions) against the full
    decompressed attention over all S, on the port; and the absorbed step
    against JAX's on the same cache."""
    jcfg, jpl, jx, cfg, tpl, tx = _mla_case()
    S, cache_len = tx.shape[1], 16
    full = tattn.attn_train(cfg, tpl, tx)[:, -1]
    _, cache = tattn.attn_prefill(cfg, tpl, tx[:, :S - 1])
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, cache_len - (S - 1)))
             for k, v in cache.items()}
    jcache = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
    pos = torch.full((2,), S - 1, dtype=torch.int32)
    out, new = tattn.attn_decode(cfg, tpl, tx[:, S - 1:], cache, pos)
    torch.testing.assert_close(out[:, 0], full, atol=1e-5, rtol=1e-5)
    jout, jnew = jattn.attn_decode(jcfg, jpl, jx[:, S - 1:], jcache,
                                   jnp.asarray(pos.numpy()))
    fam.close(out, jout, fam.F32_TOL)
    fam.caches_close(new, jnew, fam.F32_TOL)


def test_decode_past_the_cache_writes_nothing_as_jax_drops_it():
    """A row at the cache's length: JAX's scatter drops the write, and the
    port leaves the cache as it was."""
    jcfg, jpl, jx, cfg, tpl, tx = _mla_case(S=4)
    _, cache = tattn.attn_prefill(cfg, tpl, tx)
    before = {k: v.clone() for k, v in cache.items()}
    jcache = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
    pos = torch.tensor([4, 2], dtype=torch.int32)   # row 0 past the end
    out, new = tattn.attn_decode(cfg, tpl, tx[:, :1], cache, pos)
    jout, jnew = jattn.attn_decode(jcfg, jpl, jx[:, :1], jcache,
                                   jnp.asarray(pos.numpy()))
    fam.close(out, jout, fam.F32_TOL)
    fam.caches_close(new, jnew, fam.F32_TOL)
    assert torch.equal(new["ckv"][0], before["ckv"][0])
    assert not torch.equal(new["ckv"][1], before["ckv"][1])


def test_mla_reaches_no_kernel(monkeypatch):
    """q's head dim (128 + 64 at full size) is not v's, so MLA takes the
    blocked loop, as in the JAX package, even with use_kernels: no call of
    ``ops.mha``, and the logits equal the plain path's."""
    cfg = get_smoke_config(ARCH).with_(dtype="float32")
    params = Model(cfg).init(0, device="cpu")
    monkeypatch.setattr(tops, "mha", lambda *a, **k: pytest.fail("mha"))
    toks = torch.arange(40).reshape(2, 20) % cfg.vocab_size
    a = Model(cfg.with_(use_kernels=True)).logits(params, {"tokens": toks})
    b = Model(cfg).logits(params, {"tokens": toks})
    assert torch.equal(a, b)


def test_init_cache_layout_matches_jax():
    fam.check_init_cache_layout(ARCH)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_from_jax_is_bit_exact(dtype):
    fam.check_params_bit_exact(ARCH, dtype)


def test_init_matches_jax_specs():
    fam.check_init_matches_jax_specs(ARCH)


def test_greedy_outputs_token_identical_to_jax_engine():
    fam.check_engine_tokens_match_jax(ARCH)


def test_three_slot_engine_drops_as_the_jax_engine_does():
    """At capacity factor 1.25 the batched prefills drop (see
    tests/test_torch_moe.py): the port's 3-slot engine gives the JAX
    3-slot engine's tokens."""
    fam.check_engine_tokens_match_jax(ARCH, batch_size=3)


def test_refill_matches_serial_decoding_when_dropless():
    """The splice walks both stacks (``dense`` and ``layers``); dropless
    (capacity factor E / k), each request's tokens equal its serial run."""
    cfg = get_smoke_config(ARCH)
    fam.check_refill_matches_serial(
        ARCH, capacity_factor=cfg.n_experts / cfg.top_k)


def test_serve_cli_runs_on_the_cpu_when_asked(capsys):
    fam.check_serve_cli(ARCH, capsys)
