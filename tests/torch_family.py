"""Helpers of the per-family parity tests (tests/test_torch_hybrid.py,
test_torch_moe.py, test_torch_mla.py, test_torch_encdec.py): one smoke
config built in both packages, the JAX package's parameters carried into
the port by ``params_from_jax``, the same numpy inputs from a seed handed
to both, and the checks every family shares.

Tolerances, as tests/test_torch_model.py: 1e-4 in f32 (f32 matmuls summed
in another order), 3e-2 in bf16 (activations rounded to bf16 at every
layer).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serve.engine import Request, ServeEngine

F32_TOL = 1e-4
BF16_TOL = 3e-2


def pair(arch, dtype="float32", **kw):
    """(JAX model, JAX params, port model, port params) of ``arch``'s smoke
    config, the port's parameters those of JAX bit for bit."""
    jm = JModel(jget_smoke(arch).with_(dtype=dtype, **kw))
    tm = Model(get_smoke_config(arch).with_(dtype=dtype, **kw))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def batches(cfg, B, S, seed=0):
    """The same batch for both packages: tokens (B, S), and for an enc-dec
    model src_embeds (B, S // enc_ratio, d) from a standard normal."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)
                                              .long()}
    if cfg.is_encdec:
        src = rng.standard_normal((B, max(1, S // cfg.enc_ratio),
                                   cfg.d_model)).astype(np.float32)
        jb["src_embeds"] = jnp.asarray(src)
        tb["src_embeds"] = torch.from_numpy(src)
    return jb, tb


def close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy() if torch.is_tensor(t) else t,
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def port_leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def caches_close(tc, jc, tol):
    """Every leaf of the JAX cache against the port's at the same place,
    int leaves exactly; the two trees hold the same leaves."""
    jleaves = jax.tree_util.tree_leaves_with_path(jc)
    assert len(jleaves) == len(jax.tree.leaves(tc))
    for path, a in jleaves:
        t = port_leaf(tc, path)
        assert tuple(t.shape) == a.shape, jax.tree_util.keystr(path)
        if t.dtype in (torch.int32, torch.int64):
            np.testing.assert_array_equal(t.numpy(), np.asarray(a))
        else:
            close(t, a, tol)


def check_logits(arch, B=2, S=24, tol=F32_TOL, **kw):
    jm, jp, tm, tp = pair(arch, **kw)
    jb, tb = batches(tm.cfg, B, S)
    want = jm.logits(jp, jb)
    got = tm.logits(tp, tb)
    assert got.shape == want.shape
    close(got, want, tol)


def check_prefill_and_decode(arch, B=2, S=12, cache_len=24, steps=3,
                             tol=F32_TOL):
    """Prefill logits and every cache leaf, then ``steps`` greedy decode
    steps, each step's logits and cache."""
    jm, jp, tm, tp = pair(arch)
    jb, tb = batches(tm.cfg, B, S, seed=1)
    jl, jc = jm.prefill(jp, jb, cache_len)
    tl, tc = tm.prefill(tp, tb, cache_len)
    close(tl, jl, tol)
    caches_close(tc, jc, tol)
    for _ in range(steps):
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        jl, jc = jm.decode(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode(tp, tc, torch.from_numpy(nxt).long())
        close(tl, jl, tol)
        caches_close(tc, jc, tol)


def check_bf16_prefill(arch, B=2, S=16, cache_len=24):
    jm, jp, tm, tp = pair(arch, dtype="bfloat16")
    jb, tb = batches(tm.cfg, B, S, seed=2)
    jl, jc = jm.prefill(jp, jb, cache_len)
    tl, tc = tm.prefill(tp, tb, cache_len)
    assert tl.dtype == torch.bfloat16
    close(tl, jl, BF16_TOL)
    caches_close(tc, jc, BF16_TOL)


def check_bf16_prefill_within_jax_fusion_noise(arch, B=2, S=16,
                                               cache_len=24):
    """Whole-model bf16 prefill logits, where the bf16 bar is at the edge of
    the JAX package's own noise: its layer scan is compiled, and XLA fuses
    a residual add into the matmul before it and rounds once, where its
    op-by-op run (``jax.disable_jit``) and the port's eager PyTorch round
    twice.  The port's largest disagreement with the jitted run must be at
    most twice the JAX package's own between its two runs."""
    jm, jp, tm, tp = pair(arch, dtype="bfloat16")
    jb, tb = batches(tm.cfg, B, S, seed=2)
    jl, _ = jm.prefill(jp, jb, cache_len)
    with jax.disable_jit():
        el, _ = jm.prefill(jp, jb, cache_len)
    tl, _ = tm.prefill(tp, tb, cache_len)
    assert tl.dtype == torch.bfloat16
    jl, el = np.asarray(jl, np.float32), np.asarray(el, np.float32)
    floor = float(np.abs(el - jl).max())
    err = float(np.abs(tl.float().numpy() - jl).max())
    assert 0 < floor < 0.1 and err <= 2 * floor, (err, floor)


def check_bf16_layer(arch, stack="layers", B=2, S=16):
    """One layer's prefill in bf16, both packages on identical inputs and
    the same layer's parameters, op by op on both sides: the output and the
    layer's cache at 3e-2.  Through a whole model the rounding of each
    layer compounds (and, for a MoE model, can flip a top-k choice near a
    tie)."""
    from repro.models import transformer as jtransformer
    from repro_torch.models import transformer as ttransformer
    jm, jp, tm, tp = pair(arch, dtype="bfloat16")
    cfg, jcfg = tm.cfg, jm.cfg
    use_moe = stack == "layers" and cfg.is_moe
    if stack == "dense_layers":
        cfg, jcfg = cfg.with_(n_experts=0), jcfg.with_(n_experts=0)
    x = np.random.default_rng(2).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    jpl = jax.tree.map(lambda a: a[0], jp[stack])
    tpl = jax.tree.map(lambda a: a[0], tp[stack])
    jo, jc = jtransformer._layer_prefill(jcfg, None, use_moe,
                                         jnp.asarray(x, jnp.bfloat16), jpl)
    to, tc = ttransformer._layer_prefill(
        cfg, torch.from_numpy(x).to(torch.bfloat16), tpl,
        ttransformer._ssd_chunk(cfg, S))
    assert to.dtype == torch.bfloat16
    close(to, jo, BF16_TOL)
    caches_close(tc, jc, BF16_TOL)


def check_init_cache_layout(arch, B=3, cache_len=16):
    jm, _, tm, _ = pair(arch)
    jc = jm.init_cache(B, cache_len)
    tc = tm.init_cache(B, cache_len, device="cpu")
    caches_close(tc, jc, 0)


def check_params_bit_exact(arch, dtype):
    jm, jp, tm, tp = pair(arch, dtype=dtype)
    assert tm.n_params() == jm.n_params()
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jleaves) == len(jax.tree.leaves(tp))
    for path, a in jleaves:
        t = port_leaf(tp, path)
        a = np.asarray(a)
        assert str(t.dtype)[6:] == a.dtype.name, jax.tree_util.keystr(path)
        width = a.dtype.itemsize
        np.testing.assert_array_equal(
            t.view({2: torch.int16, 4: torch.int32}[width]).numpy(),
            a.view({2: np.int16, 4: np.int32}[width]))


def check_init_matches_jax_specs(arch):
    """The port's own init: the JAX tree's nesting, shapes and dtypes, on
    the device asked for, the same from the same seed."""
    tm = Model(get_smoke_config(arch))
    a, b = tm.init(0, device="cpu"), tm.init(0, device="cpu")
    jshapes = jax.tree.map(lambda s: (s.shape, str(s.dtype)),
                           JModel(jget_smoke(arch)).abstract_params())
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), a) \
        == jshapes
    assert all(torch.equal(x, y) for x, y in
               zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def _requests(cls, prompts, new_tokens):
    return [cls(rid=i, prompt=p.copy(), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, new_tokens))]


def check_engine_tokens_match_jax(arch, batch_size=2, **kw):
    """Greedy serving, f32: the port's engine gives the JAX engine's tokens
    and stats (five requests through ``batch_size`` slots, refills
    mid-decode)."""
    jm, jp, tm, tp = pair(arch, **kw)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tm.cfg.vocab_size, size=12).astype(np.int32)
               for _ in range(5)]
    new_tokens = [4, 2, 5, 3, 4]
    jreqs = _requests(JRequest, prompts, new_tokens)
    treqs = _requests(Request, prompts, new_tokens)
    jeng = JServeEngine(jm, jp, batch_size=batch_size, cache_len=32,
                        prompt_len=16, plan_warmup=False)
    teng = ServeEngine(tm, tp, batch_size=batch_size, cache_len=32,
                       prompt_len=16)
    jeng.run(jreqs)
    teng.run(treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    for key in ("prefill_calls", "decode_steps", "tokens_out"):
        assert teng.stats[key] == jeng.stats[key]


def check_refill_matches_serial(arch, **kw):
    """A 3-slot engine splices re-prefilled slots' rows of every cache
    stack into the live cache; each request's tokens equal its serial
    1-slot run (f32, kernels on: the plain versions on the CPU)."""
    cfg = get_smoke_config(arch).with_(dtype="float32", use_kernels=True,
                                       **kw)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=12).astype(np.int32)
               for _ in range(7)]
    new_tokens = [5, 3, 4, 6, 2, 5, 3]      # slots free at different steps
    reqs = _requests(Request, prompts, new_tokens)
    eng = ServeEngine(model, params, batch_size=3, cache_len=48,
                      prompt_len=16)
    eng.run(reqs)
    assert eng.stats["prefill_calls"] > 1          # refills happened
    one = ServeEngine(model, params, batch_size=1, cache_len=48,
                      prompt_len=16)
    for i, (p, n) in enumerate(zip(prompts, new_tokens)):
        ref = Request(rid=100 + i, prompt=p.copy(), max_new_tokens=n)
        one.run([ref])
        assert reqs[i].output == ref.output, f"request {i} diverged"


def check_serve_cli(arch, capsys):
    out = serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--requests", "3", "--batch", "2",
                          "--prompt-len", "8", "--cache-len", "16",
                          "--max-new", "2"])
    assert out["tokens"] == 6 and out["prefill_calls"] == 2
    assert '"tokens": 6' in capsys.readouterr().out
