"""Port of the MoE family (qwen3-moe-30b-a3b: 128 experts top-8, softmax
router over the selected logits, qk-norm GQA, no dense FFN) against the
JAX package on the CPU, on the qwen3-moe smoke config: the routing (softmax
and sigmoid), capacity drops in token order, ``moe_apply``, logits,
prefill caches and three decode steps, a bf16 MoE layer, the weights bit
for bit, greedy serving.

Tolerances: 1e-4 in f32, 3e-2 in bf16 (tests/torch_family.py).  bf16 is
held on one layer with identical inputs: through a whole model the bf16
rounding can flip a top-k choice near a tie, which is a different token's
expert, not an error of the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_family as fam
from repro.models import moe as jmoe
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.models import moe as tmoe
from repro_torch.models.model import Model

ARCH = "qwen3-moe-30b-a3b"


def _layer0(arch, dtype="float32", **kw):
    """(JAX cfg, JAX layer-0 moe params, port cfg, port layer-0 params)."""
    jm, jp, tm, tp = fam.pair(arch, dtype=dtype, **kw)
    return (jm.cfg, jax.tree.map(lambda a: a[0], jp["layers"]["moe"]),
            tm.cfg, jax.tree.map(lambda a: a[0], tp["layers"]["moe"]))


def _x(T, d, seed=0, dtype=np.float32):
    x = np.random.default_rng(seed).standard_normal((T, d)) \
        .astype(np.float32)
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v3-671b"])
def test_router_weights_match_jax(arch):
    """Softmax over the selected logits (qwen3) and sigmoid scores whose
    bias only picks the experts (deepseek; a random bias, so that it
    changes the choice)."""
    jcfg, jp, cfg, tp = _layer0(arch)
    if cfg.router_type == "sigmoid":
        bias = np.random.default_rng(5).standard_normal(cfg.n_experts) \
            .astype(np.float32) * 0.5
        jp = dict(jp, router_bias=jnp.asarray(bias))
        tp = dict(tp, router_bias=torch.from_numpy(bias))
    jx, tx = _x(64, cfg.d_model)
    jg, ji = jmoe.router_weights(jcfg, jp, jx)
    tg, ti = tmoe.router_weights(cfg, tp, tx)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    fam.close(tg, jg, 1e-6)
    np.testing.assert_allclose(tg.sum(-1).numpy(), 1.0, atol=1e-5)
    if cfg.router_type == "sigmoid":     # the bias moved some choices
        unbiased = tmoe.router_weights(cfg, dict(tp, router_bias=torch.zeros(
            cfg.n_experts)), tx)[1]
        assert not torch.equal(unbiased, ti)


def test_capacity_truncates_and_keeps_small_populations_dropless():
    cfg = get_smoke_config(ARCH)           # E 8, top-2, factor 1.25
    assert tmoe.capacity(cfg, 4) == 4          # min(T, 32)
    assert tmoe.capacity(cfg, 100) == 32       # int(31.25) < 32
    assert tmoe.capacity(cfg, 1000) == 312     # int(312.5)
    full = get_config(ARCH)                # E 128, top-8
    assert tmoe.capacity(full, 4096) == 320


def test_capacity_drops_follow_token_order_and_match_jax():
    """Every token routed to expert 0 first and expert 1 second, capacity
    32 of 64 tokens: tokens 0-31 keep both, tokens 32-63 are dropped by
    both experts in token order; JAX's moe_local gives the same."""
    jcfg, jp, cfg, tp = _layer0(ARCH)
    T, k, d = 64, cfg.top_k, cfg.d_model
    jx, tx = _x(T, d, seed=1)
    idx = np.tile(np.array([[0, 1]]), (T, 1))
    gates = np.full((T, k), 0.5, np.float32)
    cap = tmoe.capacity(cfg, T)
    assert cap == 32
    got = tmoe.moe_local(cfg, tx, torch.from_numpy(gates),
                         torch.from_numpy(idx), tp["wi"], tp["wg"],
                         tp["wo"], 0, cfg.n_experts, cap)
    want = jmoe.moe_local(jcfg, jx, jnp.asarray(gates), jnp.asarray(idx),
                          jp["wi"], jp["wg"], jp["wo"], 0, cfg.n_experts,
                          cap)
    fam.close(got, want, fam.F32_TOL)
    # by hand: the kept tokens' gate-weighted expert FFNs, the rest zero
    def ffn(e, x):
        h = torch.nn.functional.silu(x @ tp["wg"][e]) * (x @ tp["wi"][e])
        return h @ tp["wo"][e]
    kept = 0.5 * ffn(0, tx[:cap]) + 0.5 * ffn(1, tx[:cap])
    torch.testing.assert_close(got[:cap], kept, atol=1e-5, rtol=1e-5)
    assert torch.equal(got[cap:], torch.zeros(T - cap, d))


@pytest.mark.parametrize("T", [4, 40, 300])
def test_moe_apply_matches_jax(T):
    """Dropless (T 4, 40) and dropping (T 300: capacity int(93.75) = 93 of
    an expected 75 a expert, so the loaded experts drop)."""
    jcfg, jp, cfg, tp = _layer0(ARCH)
    jx, tx = _x(T, cfg.d_model, seed=T)
    want = jmoe.moe_apply(jcfg, jp, jx.reshape(1, T, -1))
    got = tmoe.moe_apply(cfg, tp, tx.reshape(1, T, -1))
    fam.close(got, want, fam.F32_TOL)


def test_moe_routing_conservation():
    """Top-k gates are normalized and dispatch preserves token mass for
    tokens under capacity (tests/test_models_smoke.py's check, on the
    port: bf16 tokens)."""
    cfg = get_smoke_config(ARCH)
    params = Model(cfg).init(0, device="cpu")
    layer0 = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    x = torch.randn(1, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1)).to(torch.bfloat16)
    gates, idx = tmoe.router_weights(cfg, layer0, x.reshape(8, cfg.d_model))
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, atol=1e-3)
    assert int(idx.max()) < cfg.n_experts
    out = tmoe.moe_apply(cfg, layer0, x)
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out.float()).all())


def test_combine_sums_each_tokens_choices_in_a_fixed_order():
    """The same tokens alone and among others give bit-equal rows (no
    scatter-add whose order varies)."""
    _, _, cfg, tp = _layer0(ARCH, dtype="bfloat16")
    _, tx = _x(24, cfg.d_model, seed=3, dtype=jnp.bfloat16)
    all_rows = tmoe.moe_apply(cfg, tp, tx.reshape(1, 24, -1))
    first = tmoe.moe_apply(cfg, tp, tx[:8].reshape(1, 8, -1))
    assert torch.equal(all_rows[0, :8], first[0])


def test_mesh_is_refused_naming_the_roadmap_item():
    """Shared experts train on a model axis under both knobs, which
    nothing refuses any more (the 2-rank cases: deepseek-v3 in
    tests/test_torch_seq_shard.py, qwen3-moe in test_torch_tp_off.py):
    on the one-rank gloo mesh the layer with ``seq_shard`` (the rows
    gathered in, the shared experts' product in the routed experts'
    Reduce-Scatter) and with ``tensor_parallel=False`` gives the mesh-free
    layer's output and gradients."""
    from repro_torch.launch import mesh as tmesh
    from repro_torch.parallel.collective_planner import record_collectives
    _, _, cfg, tp = _layer0("deepseek-v3-671b")
    assert cfg.n_shared_experts
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))

    def run(c, mesh, seq):
        p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        xx = x.clone().requires_grad_(True)
        with record_collectives() as rec:
            out = tmoe.moe_apply(c, p, xx, mesh, seq)
            out.square().sum().backward()
        return ([out.detach(), xx.grad] + [p[k].grad for k in sorted(p)],
                {(r[0], r[1]) for r in rec})
    want, _ = run(cfg, None, None)
    mesh = tmesh.make_host_mesh(device="cpu")
    try:
        for knob, seq in (({"seq_shard": True}, "rows"),
                          ({"tensor_parallel": False}, None)):
            got, labels = run(cfg.with_(**knob), mesh, seq)
            for g, w in zip(got, want):
                fam.close(g, w.numpy(), 1e-6)
            assert (("tp/seq-gather", "AllGather") in labels) == bool(seq)
            assert (("moe/combine", "ReduceScatter") in labels) == bool(seq)
            assert ("moe/shared-out", "AllReduce") not in labels or not seq
    finally:
        tmesh.destroy()


def test_logits_match_jax():
    fam.check_logits(ARCH)


def test_prefill_caches_and_three_decode_steps_match_jax():
    fam.check_prefill_and_decode(ARCH)


def test_bf16_moe_layer_prefill_matches_jax():
    fam.check_bf16_layer(ARCH)


def test_init_cache_layout_matches_jax():
    fam.check_init_cache_layout(ARCH)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_from_jax_is_bit_exact(dtype):
    fam.check_params_bit_exact(ARCH, dtype)


def test_init_matches_jax_specs():
    fam.check_init_matches_jax_specs(ARCH)


def test_greedy_outputs_token_identical_to_jax_engine():
    fam.check_engine_tokens_match_jax(ARCH)


def test_refill_matches_serial_decoding_when_dropless():
    """Capacity is shared by every row of a batched prefill, the rows that
    carry no request (token 0 throughout) among them, so where an expert
    overflows, batching changes which tokens it drops: the JAX engine's
    3-slot run differs from its serial runs in 3 of these 7 requests too
    (ROADMAP C.5).  At capacity_factor E / k every expert takes every
    token, and the splice of refilled rows must give the serial tokens."""
    cfg = get_smoke_config(ARCH)
    fam.check_refill_matches_serial(
        ARCH, capacity_factor=cfg.n_experts / cfg.top_k)


def test_three_slot_engine_drops_as_the_jax_engine_does():
    """At the config's capacity factor (1.25) the batched prefills drop:
    the port's 3-slot engine gives the JAX 3-slot engine's tokens."""
    fam.check_engine_tokens_match_jax(ARCH, batch_size=3)


def test_serve_cli_runs_on_the_cpu_when_asked(capsys):
    fam.check_serve_cli(ARCH, capsys)
