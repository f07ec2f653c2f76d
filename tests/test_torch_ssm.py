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
from repro_torch.configs.registry import get_config, get_smoke_config
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


@pytest.mark.parametrize("S", [40, 1024])
def test_default_chunk_is_the_plans(S):
    """``ssd_scan_fwd(chunk=None)`` runs the COMET plan's chunk
    (``autotune.ssd_chunk_len(S, P, N)``), as the JAX wrapper does: bit
    for bit the chunked reference at that chunk, at mamba2's head (P 64,
    N 128).  At S = 40 the plan picks 32, where the wrapper once ran its
    64 clipped to 40."""
    from repro_torch.kernels.autotune import ssd_chunk_len
    _, (x, dA, B, C) = _ssd_inputs(11, 2, S, 64, 128)
    chunk = ssd_chunk_len(S, 64, 128)
    assert chunk == {40: 32, 1024: 64}[S]
    out = tssd.ssd_scan_fwd(x, dA, B, C)
    assert torch.equal(out, tref.ssd_chunked_ref(x, dA, B, C, chunk=chunk))
    if S == 40:
        assert not torch.equal(out, tref.ssd_chunked_ref(x, dA, B, C,
                                                         chunk=40))


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


# ------------------------------------------------- B and C in group form


def _group_inputs(seed, BH, r, S, P, N, dtype="float32"):
    """Same bits for both packages, B/C in group form (BH / r rows): the
    port's (xdt, dA, B, C), and the JAX kernel's with B/C repeated to one
    row a head (``jnp.repeat``, each group's heads adjacent)."""
    rng = np.random.default_rng(seed)
    G = BH // r
    xs = [rng.normal(size=(BH, S, P)), -np.abs(rng.normal(size=(BH, S))) * 0.1,
          rng.normal(size=(G, S, N)), rng.normal(size=(G, S, N))]
    jx = [jnp.asarray(x, jnp.float32 if i == 1 else getattr(jnp, dtype))
          for i, x in enumerate(xs)]
    tx = [tensor_from_numpy(np.asarray(x)) for x in jx]
    return tx, jx[:2] + [jnp.repeat(b, r, axis=0) for b in jx[2:]]


@pytest.mark.parametrize("BH,r,S,P,N,chunk", [
    (4, 1, 128, 16, 32, 64),
    (4, 2, 200, 16, 32, 64),      # ragged S: the padding path
    (8, 8, 24, 16, 16, 8),        # a chunk below 64
    (8, 2, 96, 32, 64, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_form_matches_jax_pallas_kernel_on_repeated_inputs(
        BH, r, S, P, N, chunk, dtype):
    """B/C of BH / r rows through ``ssd_scan_fwd``, ``ops.ssd`` and
    ``ssd_scan`` against the Pallas kernel (interpret mode) on B/C repeated
    to every head: 2e-3 in f32, 1e-2 of max |y| in bf16."""
    tx, jx = _group_inputs(9, BH, r, S, P, N, dtype)
    want = jops.ssd_scan(*jx, chunk, True)
    for got in (tssd.ssd_scan_fwd(*tx, chunk=chunk),
                tops.ssd(*tx, chunk=chunk, use_kernel=True),
                tssd.ssd_scan(*tx, chunk)):
        assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
        if dtype == "float32":
            _close(got, want, 2e-3)
        else:
            _close_scaled(got, want, 1e-2)
    # the plain entries of ops take the group form too
    _close_scaled(tops.ssd(*tx, chunk=chunk), want,
                  1e-2 if dtype != "float32" else 2e-3)


@pytest.mark.parametrize("r", [2, 8])
def test_group_form_backward_sums_each_groups_heads(r):
    """The recompute backward on group-form B/C against JAX's vjp through
    ``jnp.repeat``: B's and C's gradients come back one row a group, summed
    over its heads; all four within 1e-5 of their largest magnitude."""
    BH, S, P, N = 8, 100, 16, 32
    tx, _ = _group_inputs(10, BH, r, S, P, N)
    jx = [jnp.asarray(t.numpy()) for t in tx]
    g = np.random.default_rng(11).normal(size=(BH, S, P)).astype(np.float32)
    want = jax.jit(lambda gg, *a: jax.vjp(
        lambda x, d, b, c: jops.ssd_scan(x, d, jnp.repeat(b, r, axis=0),
                                         jnp.repeat(c, r, axis=0), 64, True),
        *a)[1](gg))(jnp.asarray(g), *jx)
    xs = [t.clone().requires_grad_(True) for t in tx]
    got = torch.autograd.grad(tops.ssd(*xs, use_kernel=True), xs,
                              torch.from_numpy(g))
    assert [tuple(a.shape) for a in got] == [tuple(t.shape) for t in tx]
    for a, b in zip(got, want):
        _close_scaled(a, b, 1e-5)


def test_rows_that_do_not_divide_bh_are_refused():
    tx, _ = _group_inputs(12, 6, 2, 32, 16, 16)
    x, dA, B, C = tx
    for bad in (B[:1].expand(4, -1, -1), torch.cat([B, B[:2]])):  # 4, 5
        with pytest.raises(ValueError, match="do not divide BH"):
            tssd.ssd_scan_fwd(x, dA, bad, bad.clone())
    with pytest.raises(ValueError, match="do not divide BH"):
        tops.ssd(x, dA, B[:1].expand(4, -1, -1), C[:1].expand(4, -1, -1),
                 use_kernel=True)


@pytest.mark.parametrize("N,P,stage,want_stages,want_smem", [
    (128, 64, 40960, 2, 108544),   # mamba2: two stages, two CTAs an SM
    (128, 32, 36864, 2, 88064),
    (64, 64, 24576, 3, 92160),     # a fourth stage would not fit a pair
    (32, 64, 16384, 4, 83968),     # the ring's cap of four stages
    (16, 16, 6144, 4, 30720),
])
def test_bf16_layout_at_its_edges(N, P, stage, want_stages, want_smem):
    """The ring's stages and shared memory (the source's SsdCfg): as many
    stages of ``stage`` bytes as fit two CTAs an SM, at most 4; the card's
    SM has 233,472 B, 1 KB of it reserved for each CTA."""
    stages, smem = tssd.bf16_layout(N, P)
    assert (stages, smem) == (want_stages, want_smem)
    assert 2 * (smem + 1024) <= 233472
    assert stages == 4 or 2 * (smem + stage + 1024) > 233472


def test_tiling_at_its_edges():
    bf16, f32 = torch.bfloat16, torch.float32
    # mamba2's serving shape: 192 units of one head, two an SM: one wave
    t = tssd.tiling(192, 24, 1024, 64, 128, bf16)
    assert (t.stages, t.units, t.ctas_per_sm) == (2, 192, 2)
    assert t.units <= tssd.SMS * t.ctas_per_sm
    assert tssd.tiling(192, 1, 1024, 64, 128, bf16) == t   # r does not matter
    # every P and N: one CTA a head, the bf16 ring as bf16_layout, f32 none
    for P in tssd.HEAD_DIMS:
        for N in tssd.STATE_DIMS:
            tb = tssd.tiling(3, 1, 1, P, N, bf16)
            assert tb == (tssd.bf16_layout(N, P)[0], 3, 2)
            tf = tssd.tiling(3, 3, 70, P, N, f32)
            assert (tf.stages, tf.units) == (1, 3)
    for bad in ((2, 1, 64, 48, 16), (2, 1, 64, 16, 24), (3, 2, 64, 16, 16),
                (0, 1, 64, 16, 16), (2, 1, 0, 16, 16)):
        with pytest.raises(ValueError):
            tssd.tiling(*bad, bf16)
    with pytest.raises(TypeError):
        tssd.tiling(2, 1, 64, 16, 16, torch.float16)


def test_kernel_strides_of_the_models_group_view():
    """At one group the model hands B/C over as views of its conv output,
    (B, S, conv_dim): 16-byte aligned rows, taken with no copy; a dim of
    size 1 takes the extent inside it."""
    cd, N = 1792, 128
    xbc = torch.zeros(2, 100, cd, dtype=torch.bfloat16)
    B = xbc[..., 1536:1536 + N]
    assert tssd.kernel_strides(B) == (100 * cd, cd)
    assert tssd.kernel_strides(xbc[:1, :, 1536:1536 + N]) == (100 * cd, cd)
    assert tssd.kernel_strides(xbc[:1, :1, 1536:1536 + N]) == (N, N)
    x = torch.zeros(48, 100, 64, dtype=torch.bfloat16)
    dA = torch.zeros(48, 100)
    out = tssd.ssd_scan_fwd(x, dA, B, xbc[..., 1536 + N:])
    assert out.shape == x.shape
    with pytest.raises(ValueError, match="16-byte aligned"):
        tssd.ssd_scan_fwd(x, dA, xbc[..., 1:1 + N], xbc[..., 1 + N:1 + 2 * N])


def test_prefill_hands_the_scan_group_views(monkeypatch):
    """ssm_prefill hands the scan B/C of B x ngroups rows, views of the
    conv output at ngroups 1 (no per-head copy), in a bf16 model."""
    cfg = get_smoke_config(ARCH)
    assert cfg.ssm_ngroups == 1 and cfg.dtype == "bfloat16"
    model = Model(cfg)
    params = model.init(0, device="cpu")
    seen = []
    real = tops.ssd

    def spy(xdt, dA, B, C, **kw):
        seen.append((xdt.shape, B.shape, B._base is not None,
                     C._base is not None, B.stride()))
        return real(xdt, dA, B, C, **kw)

    monkeypatch.setattr(tops, "ssd", spy)
    toks = torch.arange(2 * 20).reshape(2, 20) % cfg.vocab_size
    model.prefill(params, {"tokens": toks}, 24)
    assert len(seen) == cfg.n_layers
    nh, N = cfg.ssm_nheads, cfg.ssm_state
    for xs, bs, b_view, c_view, stride in seen:
        assert tuple(xs)[0] == 2 * nh and tuple(bs) == (2, 20, N)
        assert b_view and c_view and stride[1] == cfg.conv_dim


def test_ssd_bench_and_sweep_run_untimed_on_the_cpu():
    """``kernel_bench.bench_ssd`` counts the bytes each input form reads
    (B and C once a group row, of a strided conv view only the B/C columns)
    in its bound; ``ssd_sweep`` runs the SSD alone at both forms, untimed
    on the CPU."""
    from repro_torch.launch import kernel_bench as kb
    shapes = [{"BH": 8, "S": 40, "P": 64, "N": 16},
              {"BH": 8, "S": 40, "P": 64, "N": 16, "r": 4, "xbc": True}]
    out = kb.ssd_sweep("cpu", shapes=shapes)
    recs = out["records"]
    assert out["device"] == "cpu" and out["calls"] == {"ssd_scan": 2}
    assert [r["name"] for r in recs] == ["ssd_scan"] * 2
    for rec, G, row in zip(recs, (8, 2), (16, 4 * 64 + 2 * 16)):
        want = 2 * 8 * 40 * 64 * 2 + 8 * 40 * 4 + 2 * G * 40 * 16 * 2
        assert rec["bytes"] == want and rec["shape"]["B"] == [G, 40, 16]
        assert rec["shape"]["B_stride"] == [40 * row, row, 1]
        assert rec["bound_ms"] == kb.bound(rec["flops"], want,
                                           torch.bfloat16)[0]
        assert rec["ms"] is None and rec["device_ms"] is None \
            and rec["max_abs_err"] == 0.0
    assert kb.SSD_GROUP_SHAPE == dict(kb.SSD_SHAPE, r=24, xbc=True)


def test_ssd_inputs_conv_view_is_the_models_layout():
    """``kernel_bench.ssd_inputs`` with "xbc" gives B/C as the model hands
    them over at one group: views of a (B, S, conv_dim) tensor, B's columns
    after the r heads of x, C's after B's; mamba2's conv_dim is 1792."""
    from repro_torch.launch import kernel_bench as kb
    cfg = get_config(ARCH)
    gen = torch.Generator().manual_seed(0)
    shape = dict(kb.SSD_GROUP_SHAPE, S=8)
    x, dA, B, C = kb.ssd_inputs(gen, shape, torch.bfloat16, "cpu")
    assert cfg.conv_dim == 1792 and cfg.ssm_ngroups == 1
    assert B._base is C._base is not None
    assert tuple(B.shape) == tuple(C.shape) == (8, 8, 128)
    assert B.stride() == C.stride() == (8 * cfg.conv_dim, cfg.conv_dim, 1)
    assert C.data_ptr() - B.data_ptr() == 128 * 2
    assert B.data_ptr() - B._base.data_ptr() == 24 * 64 * 2
    assert tuple(x.shape) == (192, 8, 64) and dA.dtype == torch.float32
    assert bool((dA <= 0).all())


def test_ssd_trace_stamps_every_phase_of_the_chunk_loop():
    """launch/ssd_trace.py finds each phase's line in the kernel's chunk
    loop (it is run on the card; here only its source edit is checked)."""
    from repro_torch.kernels import _build
    from repro_torch.launch import ssd_trace
    text = (_build.CSRC / "ssd_scan.cu").read_text()
    out = ssd_trace.stamped_source(text)
    assert [f"SSD_STAMP({k});" in out
            for k in range(1, len(ssd_trace.PHASES) + 1)] \
        == [True] * len(ssd_trace.PHASES)
    assert out.count("SSD_STAMP(") == len(ssd_trace.PHASES) + 1
    with pytest.raises(ValueError, match="no line for phase"):
        ssd_trace.stamped_source(text.replace("    fence_regs(lo);", ""))


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
