"""Port Mamba-2 (ssm) path against the JAX package on the CPU: the SSD
plain versions, ``ops.ssd`` (which on CPU tensors takes the plain version)
against the Pallas kernel in interpret mode, the recompute backward, the
mixer's train/prefill/decode, the model's logits on the kernel path,
decode after prefill, greedy serving token for token, the weights carried
bit for bit, and the kernel wrapper's input checks.

Inputs are made with numpy from a seed and handed to both packages; JAX
parameters reach the port through ``params_from_jax``.

Tolerances, each with its reason:
- 2e-5 between the two packages' plain SSD versions in f32: the same
  algorithm, sums in another order.
- 2e-3 for the SSD scan against the Pallas kernel in f32, the bar of
  tests/test_kernels.py::test_ssd_kernel_sweep: the port's chunk (64)
  differs from the one the JAX test passes, which changes only rounding.
- bf16 SSD inputs: 1e-2 of the output's largest magnitude.  Both sides
  round y to bf16 (2^-8 relative), and a chunk of 64 against one of 128
  moves an f32 value across a rounding boundary now and then; the error of
  an element is bounded by the magnitude of the terms it sums, not by its
  own value.
- 1e-4 for the mixer and model in f32: f32 matmuls summed in another
  order, after which the SSD inputs are rounded to bf16 on both sides, as
  the JAX package does even in an f32 config (``ssm.py:106-107``).
- 2e-3 for the logits at S = 128 and 100: there the two packages' f32
  xdt straddle a bf16 rounding boundary at a few elements, which then
  differ by one bf16 step (2^-8 relative) and move the mixer's output by
  several 1e-4.
- 3e-2 for decode after prefill in bf16, as tests/test_system.py: decode
  runs the recurrence on f32 inputs where prefill rounds them to bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import Model as JModel
from repro.models import ssm as jssm
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd as tssd
from repro_torch.launch import serve as serve_cli
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_jax, tensor_from_numpy
from repro_torch.models.model import Model
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "mamba2-130m"
F32_TOL = 1e-4


def _ssd_inputs(seed, BH, S, P, N, dtype="float32"):
    """Same bits for both packages: xdt/B/C in ``dtype``, dA f32 < 0."""
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(BH, S, P)), -np.abs(rng.normal(size=(BH, S))) * 0.1,
          rng.normal(size=(BH, S, N)), rng.normal(size=(BH, S, N))]
    jx = [jnp.asarray(x, jnp.float32 if i == 1 else getattr(jnp, dtype))
          for i, x in enumerate(xs)]
    return jx, [tensor_from_numpy(np.asarray(x)) for x in jx]


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def _close_scaled(t, j, tol):
    """max |t - j| <= tol * max |j|."""
    want = np.asarray(j, np.float32)
    err = np.abs(t.detach().float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _pair(dtype="float32", **kw):
    jcfg = jget_smoke(ARCH).with_(dtype=dtype, **kw)
    jm, tm = JModel(jcfg), Model(get_smoke_config(ARCH).with_(dtype=dtype,
                                                             **kw))
    jp = jm.init(jax.random.PRNGKey(0))
    # the smoke init has A_log = dt_bias = 0 and D = 1 on every head; other
    # values, as a trained model has, so that the test sees each of them
    rng = np.random.default_rng(7)
    ssm = dict(jp["layers"]["ssm"])
    for name, lo, hi in (("A_log", -1.0, 1.5), ("dt_bias", -2.0, 0.5),
                         ("D", 0.5, 1.5)):
        ssm[name] = jnp.asarray(rng.uniform(lo, hi, ssm[name].shape),
                                jnp.float32)
    jp = {**jp, "layers": {**jp["layers"], "ssm": ssm}}
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)) \
        .astype(np.int32)


# ------------------------------------------------------------ plain SSD


def test_ssd_plain_versions_match_jax():
    jx, tx = _ssd_inputs(0, 2, 64, 16, 32)
    _close(tref.ssd_ref(*tx), jax.jit(jref.ssd_ref)(*jx), 2e-5)
    jx, tx = _ssd_inputs(1, 2, 128, 16, 32)
    for chunk in (16, 64):
        _close(tref.ssd_chunked_ref(*tx, chunk=chunk),
               jax.jit(jref.ssd_chunked_ref, static_argnames="chunk")(
                   *jx, chunk=chunk), 2e-5)


@pytest.mark.parametrize("BH,S,P,N,chunk", [
    (2, 128, 16, 32, 64),
    (4, 256, 32, 64, 128),
    (1, 200, 16, 32, 64),         # padding path
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_ssd_matches_jax_pallas_kernel(BH, S, P, N, chunk, dtype):
    """The shapes of tests/test_kernels.py::test_ssd_kernel_sweep.  The
    port's kernel takes chunks of at most 64 rows, so it runs 64 where the
    JAX case asks for 128."""
    jx, tx = _ssd_inputs(2, BH, S, P, N, dtype)
    want = jops.ssd_scan(*jx, chunk, True)
    got = tops.ssd(*tx, chunk=min(chunk, tssd.CHUNK), use_kernel=True)
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    if dtype == "float32":
        _close(got, want, 2e-3)
    else:
        _close_scaled(got, want, 1e-2)
    # the plain entries of ops: the recurrence, and the chunked version
    _close_scaled(tops.ssd(*tx), jops.ssd(*jx), 1e-2 if dtype != "float32"
                  else 2e-5)
    if S % 64 == 0:
        _close_scaled(tops.ssd(*tx, chunk=64), jops.ssd(*jx, chunk=64),
                      1e-2 if dtype != "float32" else 2e-5)


def test_ssd_scan_backward_matches_jax():
    """The recompute backward (chunk 64 by default, ragged S padded) against
    the JAX ``custom_vjp``.  f32 gradients within 1e-5 of their largest
    magnitude: dA's gradient sums P x N products per element, so its error
    follows the size of those terms, not its own value."""
    jx, tx = _ssd_inputs(3, 2, 100, 16, 32)
    g = np.random.default_rng(4).normal(size=(2, 100, 16)).astype(np.float32)
    # JAX: chunk 64 given (its default asks the TPU plan); port: its default
    want = jax.jit(lambda gg, *a: jax.vjp(
        lambda *b: jops.ssd_scan(*b, 64, True), *a)[1](gg))(jnp.asarray(g),
                                                            *jx)
    xs = [t.clone().requires_grad_(True) for t in tx]
    out = tops.ssd_scan(*xs)
    got = torch.autograd.grad(out, xs, torch.from_numpy(g))
    for a, b in zip(got, want):
        _close_scaled(a, b, 1e-5)


def test_kernel_wrapper_raises_on_what_the_kernel_does_not_take():
    _, (x, dA, B, C) = _ssd_inputs(5, 2, 128, 16, 32)
    with pytest.raises(TypeError, match="dtype"):
        tssd.ssd_scan_fwd(x.half(), dA, B.half(), C.half())
    with pytest.raises(TypeError, match="dtype"):
        tssd.ssd_scan_fwd(x, dA, B.bfloat16(), C)
    with pytest.raises(TypeError, match="dA must be float32"):
        tssd.ssd_scan_fwd(x, dA.bfloat16(), B, C)
    with pytest.raises(ValueError, match="unit inner stride"):
        tssd.ssd_scan_fwd(x.transpose(1, 2).contiguous().transpose(1, 2),
                          dA, B, C)
    for bad in (0, 128):
        with pytest.raises(ValueError, match="chunk"):
            tssd.ssd_scan_fwd(x, dA, B, C, chunk=bad)
    with pytest.raises(ValueError, match="head dim"):
        tssd.ssd_scan_fwd(torch.zeros(2, 128, 48), dA, B, C)
    with pytest.raises(ValueError, match="match"):
        tssd.ssd_scan_fwd(x, dA[:, :64], B, C)
    # what it does take gives the plain version's answer on the CPU
    torch.testing.assert_close(tssd.ssd_scan_fwd(x, dA, B, C, chunk=32),
                               tref.ssd_chunked_ref(x, dA, B, C, chunk=32))


# ---------------------------------------------------------------- mixer


def test_ssm_mixer_train_prefill_decode_match_jax():
    jm, jp, tm, tp = _pair()
    jcfg, cfg = jm.cfg, tm.cfg
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["ssm"])
    tl = {k: v[0] for k, v in tp["layers"]["ssm"].items()}
    x = np.random.default_rng(6).normal(size=(2, 24, cfg.d_model)) \
        .astype(np.float32)
    jxs, txs = jnp.asarray(x), torch.from_numpy(x)
    # jitted: one compile instead of one per op
    jtrain, jprefill, jdecode = (jax.jit(lambda p, *a, f=f: f(jcfg, p, *a))
                                 for f in (jssm.ssm_train, jssm.ssm_prefill,
                                           jssm.ssm_decode))
    _close(tssm.ssm_train(cfg, tl, txs), jtrain(jl, jxs), F32_TOL)
    jo, jc = jprefill(jl, jxs)
    to, tc = tssm.ssm_prefill(cfg, tl, txs)
    _close(to, jo, F32_TOL)
    for key in ("conv", "state"):
        assert tc[key].dtype == getattr(torch, str(jc[key].dtype))
        _close(tc[key], jc[key], F32_TOL)
    x1 = np.random.default_rng(8).normal(size=(2, 1, cfg.d_model)) \
        .astype(np.float32)
    jo1, jc1 = jdecode(jl, jnp.asarray(x1), jc)
    conv, state = tc["conv"].clone(), tc["state"].clone()
    cache = {"conv": conv, "state": state}
    to1, tc1 = tssm.ssm_decode(cfg, tl, torch.from_numpy(x1), cache)
    _close(to1, jo1, F32_TOL)
    for key in ("conv", "state"):
        _close(tc1[key], jc1[key], F32_TOL)
    # updated in place: the cache's own tensors hold the new values
    assert tc1["conv"] is conv and tc1["state"] is state


# ---------------------------------------------------------------- model


def test_specs_init_and_cache_match_jax_layout():
    jm, jp, tm, tp = _pair()
    jshapes = jax.tree.map(lambda s: (s.shape, str(s.dtype)),
                           jm.abstract_params())
    a = tm.init(0, device="cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), a) \
        == jshapes
    ssm = a["layers"]["ssm"]
    assert ssm["A_log"].dtype == ssm["dt_bias"].dtype == ssm["D"].dtype \
        == torch.float32
    assert not ssm["A_log"].any() and not ssm["dt_bias"].any() \
        and not ssm["conv_b"].any()
    assert (ssm["D"] == 1).all() and (ssm["norm_scale"] == 1).all()
    # conv_w: scale 1.0 over a fan-in of conv_kernel (its shape[-2])
    std = float(ssm["conv_w"].float().std())
    assert abs(std * tm.cfg.conv_kernel ** 0.5 - 1.0) < 0.1
    jc = jm.init_cache(3, 16)
    tc = tm.init_cache(3, 16, device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jc)
    assert len(jleaves) == 3
    for path, arr in jleaves:
        t = tc
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == arr.shape
        assert str(t.dtype)[6:] == str(arr.dtype)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(arr, np.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_from_jax_carries_the_ssm_tree_bit_for_bit(dtype):
    jm, jp, tm, tp = _pair(dtype=dtype)
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jleaves) == len(jax.tree.leaves(tp)) == 11
    for path, a in jleaves:
        t = tp
        for p in path:
            t = t[p.key]
        a = np.asarray(a)
        assert str(t.dtype)[6:] == str(a.dtype)
        wide = a.dtype.itemsize == 4
        np.testing.assert_array_equal(
            t.view(torch.int32 if wide else torch.int16).numpy()
            .view(np.uint32 if wide else np.uint16),
            a.view(np.uint32 if wide else np.uint16))


@pytest.mark.parametrize("use_kernels,S", [(False, 128), (True, 128),
                                          (True, 100)])
def test_logits_match_jax(use_kernels, S):
    """use_kernels=True at S=128 as tests/test_models_smoke.py does (JAX:
    the Pallas kernel in interpret mode; port on CPU tensors: the plain
    version), and at a ragged S, where the JAX model cuts its chunk to a
    divisor of S and the port zero-pads a chunk of 64.  2e-3: bf16
    rounding flips of the SSD inputs (module docstring)."""
    jm, jp, tm, tp = _pair(use_kernels=use_kernels)
    toks = np.arange(S, dtype=np.int32).reshape(1, S) % tm.cfg.vocab_size
    want = jm.logits(jp, {"tokens": jnp.asarray(toks)})
    got = tm.logits(tp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == want.shape
    _close(got, want, 2e-3)


def test_prefill_cache_and_decode_step_match_jax():
    jm, jp, tm, tp = _pair()
    toks = _tokens(2, 12, tm.cfg.vocab_size, seed=1)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 20)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, 20)
    _close(tl, jl, F32_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert set(tc["layers"]) == set(jc["layers"]) == {"ssm"}
    for key in ("conv", "state"):
        _close(tc["layers"]["ssm"][key], jc["layers"]["ssm"][key], F32_TOL)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    jl2, jc2 = jm.decode(jp, jc, jnp.asarray(nxt))
    tl2, tc2 = tm.decode(tp, tc, torch.from_numpy(nxt).long())
    _close(tl2, jl2, F32_TOL)
    for key in ("conv", "state"):
        _close(tc2["layers"]["ssm"][key], jc2["layers"]["ssm"][key],
               F32_TOL)


def _chunkwise(x, dA, B, C, chunk, scan):
    """``scan`` on each chunk alone: the state is not carried across."""
    return torch.cat([scan(x[:, i:i + chunk], dA[:, i:i + chunk],
                           B[:, i:i + chunk], C[:, i:i + chunk], chunk=chunk)
                      for i in range(0, x.shape[1], chunk)], 1)


def test_mamba2_logit_bar_catches_scan_faults(monkeypatch):
    """chip_smoke.py holds the mamba2 smoke model's kernel-path logits to
    the plain path's within 1e-2 (atol and rtol; f32 config, 2 x 128
    tokens).  Each fault below, put into the scan that the plain path runs,
    moves the same logits past that bar."""
    bar = 1e-2
    cfg = get_smoke_config(ARCH).with_(dtype="float32", use_kernels=False)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.arange(256).reshape(2, 128) % cfg.vocab_size
    want = model.logits(params, {"tokens": toks})
    scan = tref.ssd_chunked_ref
    faults = {
        "state not carried": lambda x, dA, B, C, chunk: _chunkwise(
            x, dA, B, C, chunk, scan),
        "decay one step late": lambda x, dA, B, C, chunk: scan(
            x, torch.roll(dA, 1, 1), B, C, chunk=chunk),
        "1% gain": lambda x, dA, B, C, chunk: scan(
            x, dA, B, C, chunk=chunk) * 1.01,
    }
    for name, fault in faults.items():
        monkeypatch.setattr(tref, "ssd_chunked_ref", fault)
        got = model.logits(params, {"tokens": toks})
        monkeypatch.setattr(tref, "ssd_chunked_ref", scan)
        err = float((got - want).abs().max())
        print(f"{name}: max_abs_err {err:.4g}")
        assert not torch.allclose(got, want, atol=bar, rtol=bar), (name, err)


def test_decode_after_prefill_equals_full_forward():
    """As tests/test_system.py::test_ssm_decode_equals_prefill_continuation,
    on the port alone (bf16 smoke config)."""
    cfg = get_smoke_config(ARCH)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    B, S = 2, 24
    toks = torch.arange(B * S).reshape(B, S) % cfg.vocab_size
    full = model.logits(params, {"tokens": toks}).float()
    _, cache = model.prefill(params, {"tokens": toks[:, :S - 1]},
                             cache_len=S + 2)
    lg, _ = model.decode(params, cache, toks[:, S - 1:S])
    torch.testing.assert_close(lg[:, 0].float(), full[:, S - 1], atol=3e-2,
                               rtol=3e-2)


# -------------------------------------------------------------- serving


def test_greedy_outputs_token_identical_to_jax_engine():
    jm, jp, tm, tp = _pair()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tm.cfg.vocab_size, size=12).astype(np.int32)
               for _ in range(5)]
    new_tokens = [4, 2, 5, 3, 4]
    jreqs = [JRequest(rid=i, prompt=p.copy(), max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, new_tokens))]
    treqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, new_tokens))]
    jeng = JServeEngine(jm, jp, batch_size=2, cache_len=32, prompt_len=16,
                        plan_warmup=False)
    teng = ServeEngine(tm, tp, batch_size=2, cache_len=32, prompt_len=16)
    jeng.run(jreqs)
    teng.run(treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    for key in ("prefill_calls", "decode_steps", "tokens_out"):
        assert teng.stats[key] == jeng.stats[key]


def test_refill_matches_serial_decoding():
    """A 3-slot engine splices re-prefilled slots' ssm conv and state rows
    into the live cache; each request's tokens equal its serial run."""
    cfg = get_smoke_config(ARCH).with_(dtype="float32", use_kernels=True)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=12).astype(np.int32)
               for _ in range(7)]
    new_tokens = [5, 3, 4, 6, 2, 5, 3]      # slots free at different steps
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, new_tokens))]
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


def test_serve_cli_runs_mamba2_on_the_cpu_when_asked(capsys):
    out = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--requests", "3", "--batch", "2",
                          "--prompt-len", "8", "--cache-len", "16",
                          "--max-new", "2"])
    assert out["tokens"] == 6 and out["prefill_calls"] == 2
    assert '"tokens": 6' in capsys.readouterr().out
