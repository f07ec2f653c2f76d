"""The FlashAttention, SSD, fused GEMM-epilogue and streamed GEMM kernels
on the card against their plain versions.

These tests need an NVIDIA Hopper card (marker ``cuda``) and skip
elsewhere; on the card run them with
    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
This file imports no JAX, so it runs where only PyTorch is installed.
Tolerances: FlashAttention 2e-5 in f32, 3e-2 in bf16 (``TOL`` of
tests/test_kernels.py); SSD 2e-3 in f32 (tests/test_kernels.py's SSD bar)
and, in bf16, 1e-2 of the output's largest magnitude (both sides round y
to bf16, one step of which is up to 2^-7 of the largest |y|; the kernel
rounds two of its product operands to bf16); the fused GEMM epilogues
those of ``gemm_epilogue.tolerance``: softmax 2e-5 and the norms 1e-4 in
f32, and all three 1e-2 of the output's largest magnitude in bf16 (both
sides round the output to bf16, one step of which is up to 2^-7 of the
largest |y|; relative, because softmax outputs near 1/N would pass an
absolute bar as zeros); the streamed GEMM those of
``allgather_gemm.tolerance``: atol 2e-4, rtol 2e-5 in f32
(tests/test_kernels.py's bar, w scaled 0.2 as there) and 1e-2 of the
output's largest magnitude in bf16, with its two buffer modes equal bit for
bit.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm_epilogue as ge
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import ssd
from repro_torch.kernels.allgather_gemm import (CLUSTER, TILES,
                                                allgather_gemm,
                                                allgather_gemm_reference,
                                                boundary_shapes, cluster,
                                                max_active_clusters,
                                                streamed_gemm, tile,
                                                tolerance)
from repro_torch.kernels.gemm_layernorm import gemm_layernorm, gemm_rmsnorm
from repro_torch.kernels.gemm_softmax import gemm_softmax
from repro_torch.kernels.ref import attention_ref, ssd_chunked_ref
from repro_torch.launch import kernel_bench as kb

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture
def hopper():
    """Skip unless a compute-capability 9.0 card is present (decided here,
    not at import, so every test worker collects the same tests)."""
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA Hopper (sm_90) card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def _qkv(gen, B, Hq, Hkv, Sq, Skv, D, dtype):
    return [torch.randn(B, H, S, D, generator=gen, device="cuda", dtype=dtype)
            for H, S in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv))]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D", [
    (1, 4, 4, 128, 128, 64),
    (2, 8, 2, 128, 256, 64),
    (1, 4, 1, 64, 192, 32),
    (1, 2, 2, 100, 100, 128),
    (1, 4, 2, 72, 72, 16),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain_version(hopper, B, Hq, Hkv, Sq, Skv, D, dtype,
                                      causal):
    q, k, v = _qkv(hopper, B, Hq, Hkv, Sq, Skv, D, dtype)
    before = fa.flash_attention_fwd.launches
    out = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    want = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_window_and_fully_masked_rows(hopper, dtype):
    q, k, v = _qkv(hopper, 1, 4, 4, 256, 256, 64, dtype)
    out = ops.mha(q, k, v, causal=True, window=64, use_kernel=True)
    want = attention_ref(q, k, v, causal=True, window=64)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    q, k, v = _qkv(hopper, 1, 2, 2, 100, 40, 32, dtype)
    out = fa.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert (out[:, :, :60] == 0).all()
    torch.testing.assert_close(out.float(),
                               attention_ref(q, k, v, causal=True).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("case", fa.BOUNDARY_CASES,
                         ids=[c[0] for c in fa.BOUNDARY_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_the_tiling_edges(hopper, case, dtype):
    """Every edge of ``flash_attention.tiling``; rows that see no key are
    exactly 0."""
    name, B, Hq, Hkv, Sq, Skv, D, causal, window, model_layout = case
    if model_layout:   # (B, H, S, D) views of (B, S, H, D), as the model
        q, k, v = [torch.randn(B, S, H, D, generator=hopper, device="cuda",
                               dtype=dtype).transpose(1, 2)
                   for H, S in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv))]
    else:
        q, k, v = _qkv(hopper, B, Hq, Hkv, Sq, Skv, D, dtype)
    before = fa.flash_attention_fwd.launches
    out = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    if causal and Sq > Skv:
        assert (out[:, :, :Sq - Skv] == 0).all()


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_source_tile_is_the_wrappers(hopper, D):
    t = fa.tiling(4, 32, 2, 1024, 1024, D, torch.bfloat16)
    assert fa.source_tile(D) == (t.keys, t.stages)


def test_kernel_reads_strided_model_layout_and_backward(hopper):
    q, k, v = [torch.randn(2, 128, H, 32, generator=hopper, device="cuda")
               .transpose(1, 2).requires_grad_(True) for H in (8, 2, 2)]
    out = fa.flash_attention(q, k, v, True)
    want = attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
    g1 = torch.autograd.grad(out.sum(), (q, k, v))
    g2 = torch.autograd.grad(want.sum(), (q, k, v))
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_kernel_raises_instead_of_falling_back(hopper):
    q, k, v = _qkv(hopper, 1, 4, 2, 16, 16, 48, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q, k, v)


def _ssd_inputs(gen, BH, S, P, N, dtype, r=1, xbc_view=False):
    """``kernel_bench.ssd_inputs`` on the card: B/C in group form (BH / r
    rows), contiguous or (``xbc_view``) strided views of a conv output."""
    return kb.ssd_inputs(gen, {"BH": BH, "S": S, "P": P, "N": N, "r": r,
                               "xbc": xbc_view}, dtype, "cuda")


def _ssd_check(gen, BH, r, S, P, N, chunk, dtype, xbc_view=False):
    x, dA, B, C = _ssd_inputs(gen, BH, S, P, N, dtype, r, xbc_view)
    before = ssd.ssd_scan_fwd.launches
    out = ssd.ssd_scan_fwd(x, dA, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan_fwd.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    want = ssd_chunked_ref(x, dA, ssd.expand_groups(B, r),
                           ssd.expand_groups(C, r), chunk=min(chunk, S))
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, atol=2e-3, rtol=2e-3)
    else:
        err = (out.float() - want.float()).abs().max()
        assert err <= 1e-2 * want.float().abs().max()


@pytest.mark.parametrize("BH,S,P,N,chunk", [
    (2, 128, 16, 32, 64),
    (4, 256, 32, 64, 64),
    (1, 200, 16, 32, 64),
    (4, 96, 16, 16, 64),
    (4, 24, 16, 16, 8),
    (3, 100, 64, 128, 64),
    (2, 256, 64, 128, 32),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain_version(hopper, BH, S, P, N, chunk, dtype):
    _ssd_check(hopper, BH, 1, S, P, N, chunk, dtype)


@pytest.mark.parametrize("BH,r,S,P,N,chunk", [
    (48, 24, 256, 64, 128, 64),      # mamba2's group of 24 heads
    (24, 24, 100, 64, 128, 64),
    (8, 1, 130, 64, 128, 64),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_group_form(hopper, BH, r, S, P, N, chunk, dtype):
    _ssd_check(hopper, BH, r, S, P, N, chunk, dtype)


@pytest.mark.parametrize("case", ssd.BOUNDARY_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_at_every_edge_of_its_tiling(hopper, case, dtype):
    _, BH, r, S, P, N, chunk, view = case
    _ssd_check(hopper, BH, r, S, P, N, chunk, dtype, view)


@pytest.mark.parametrize("shape", kb.SSD_SHAPES,
                         ids=["per_head", "group_conv_view"])
def test_ssd_kernel_at_the_serving_shape(hopper, shape):
    """mamba2-130m's prefill scan in both input forms, the group form as
    strided views of the conv output as the model hands it over."""
    x, dA, B, C = kb.ssd_inputs(hopper, shape, torch.bfloat16, "cuda")
    out = ssd.ssd_scan_fwd(x, dA, B, C)
    r = shape.get("r", 1)
    want = ssd_chunked_ref(x, dA, ssd.expand_groups(B, r),
                           ssd.expand_groups(C, r), chunk=ssd.CHUNK)
    err = (out.float() - want.float()).abs().max()
    assert err <= 1e-2 * want.float().abs().max()


def test_ssd_units_of_the_serving_shape_are_one_wave(hopper):
    """Every unit of mamba2's serving shape resident at once, in both
    forms; the source's stages and shared memory are the rule's."""
    for r in (1, 24):
        t = ssd.tiling(192, r, 1024, 64, 128, torch.bfloat16)
        stages, smem, per_sm = ssd.bf16_tile(128, 64)
        assert (stages, smem) == ssd.bf16_layout(128, 64)
        assert per_sm == t.ctas_per_sm
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        assert t.units <= sms * per_sm


def test_ssd_kernel_through_ops_and_backward(hopper):
    x, dA, B, C = [t.requires_grad_(True) for t in
                   _ssd_inputs(hopper, 2, 128, 16, 32, torch.float32)]
    out = ops.ssd(x, dA, B, C, chunk=64, use_kernel=True)
    want = ssd_chunked_ref(x, dA, B, C, chunk=64)
    torch.testing.assert_close(out, want, atol=2e-3, rtol=2e-3)
    g1 = torch.autograd.grad(out.sum(), (x, dA, B, C))
    g2 = torch.autograd.grad(want.sum(), (x, dA, B, C))
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_ssd_kernel_raises_instead_of_falling_back(hopper):
    x, dA, B, C = _ssd_inputs(hopper, 1, 64, 16, 32, torch.bfloat16)
    before = ssd.ssd_scan_fwd.launches
    with pytest.raises(ValueError, match="state dim"):
        ssd.ssd_scan_fwd(x, dA, B[..., :24].contiguous(),
                         C[..., :24].contiguous())
    with pytest.raises(ValueError, match="16-byte aligned"):
        ssd.ssd_scan_fwd(x, dA, B[:, :, 1:17], C[:, :, 1:17])
    with pytest.raises(ValueError, match="do not divide BH"):
        ssd.ssd_scan_fwd(x.expand(3, -1, -1).contiguous(),
                         dA.expand(3, -1).contiguous(),
                         B.expand(2, -1, -1).contiguous(),
                         C.expand(2, -1, -1).contiguous())
    assert ssd.ssd_scan_fwd.launches == before


def test_mamba2_prefill_launches_ssd_at_the_plans_chunk(hopper, tmp_path,
                                                        monkeypatch):
    """A mamba2 smoke prefill on the card launches the SSD kernel once a
    layer, every launch at the chunk ``ssd_chunk_len`` chose."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.kernels.autotune import ssd_chunk_len
    from repro_torch.models.model import Model
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans"))
    cfg = get_smoke_config("mamba2-130m").with_(use_kernels=True)
    model = Model(cfg)
    params = model.init(0, device="cuda")
    S = 96
    toks = torch.arange(2 * S, device="cuda").reshape(2, S) % cfg.vocab_size
    want = ssd_chunk_len(S, cfg.ssm_headdim, cfg.ssm_state)
    ssd.ssd_scan_fwd.launches, ssd.ssd_scan_fwd.chunks = 0, {}
    logits, _ = model.prefill(params, {"tokens": toks}, S + 8)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits).all())
    assert ssd.ssd_scan_fwd.launches == cfg.n_layers
    assert ssd.ssd_scan_fwd.chunks == {min(want, S): cfg.n_layers}


# ------------------------------- the hybrid, MoE and enc-dec families


@pytest.mark.parametrize("arch", sorted(kb.FAMILY_ATTENTION_SHAPES))
def test_kernel_at_the_families_serving_shapes(hopper, arch):
    """FlashAttention where hymba-1.5b (group 5, window 1024), qwen3-moe
    (group 8) and seamless's cross-attention (Sq 1024, Skv 128, not
    causal) reach it at full width, in the model's layout, bf16."""
    B, Hq, Hkv, Sq, Skv, D, causal, window = kb.FAMILY_ATTENTION_SHAPES[arch]
    q, k, v = [torch.randn(B, S, H, D, generator=hopper, device="cuda",
                           dtype=torch.bfloat16).transpose(1, 2)
               for H, S in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv))]
    before = fa.flash_attention_fwd.launches
    out = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


def test_ssd_kernel_at_hymbas_serving_shape(hopper):
    """hymba-1.5b's prefill scan: N 16, P 64, 50 heads to a B/C group,
    strided views of the conv output, at the plan's chunk."""
    from repro_torch.kernels.autotune import ssd_chunk_len
    shape = kb.HYMBA_SSD_SHAPE
    x, dA, B, C = kb.ssd_inputs(hopper, shape, torch.bfloat16, "cuda")
    chunk = ssd_chunk_len(shape["S"], shape["P"], shape["N"])
    out = ssd.ssd_scan_fwd(x, dA, B, C, chunk=chunk)
    r = shape["r"]
    want = ssd_chunked_ref(x, dA, ssd.expand_groups(B, r),
                           ssd.expand_groups(C, r), chunk=chunk)
    err = (out.float() - want.float()).abs().max()
    assert err <= 1e-2 * want.float().abs().max()


def test_hybrid_prefill_launches_both_kernels_once_a_layer(hopper, tmp_path,
                                                           monkeypatch):
    """A hymba smoke prefill on the card (f32; its state dim 8 zero-padded
    to the SSD kernel's 16) launches FlashAttention and the SSD scan once
    a layer each, and its logits match the plain path's."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.model import Model
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans"))
    cfg = get_smoke_config("hymba-1.5b").with_(dtype="float32",
                                               use_kernels=True)
    model = Model(cfg)
    params = model.init(0, device="cuda")
    toks = torch.arange(2 * 48, device="cuda").reshape(2, 48) \
        % cfg.vocab_size
    fa.flash_attention_fwd.launches = ssd.ssd_scan_fwd.launches = 0
    logits, _ = model.prefill(params, {"tokens": toks}, 64)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == cfg.n_layers
    assert ssd.ssd_scan_fwd.launches == cfg.n_layers
    plain, _ = Model(cfg.with_(use_kernels=False)).prefill(
        params, {"tokens": toks}, 64)
    torch.testing.assert_close(logits, plain, atol=1e-2, rtol=1e-2)


def test_moe_layer_stays_on_the_card(hopper):
    """qwen3-moe's smoke MoE layer on CUDA tensors: routing, dispatch,
    expert products and combine all on the card with no host sync (CUDA's
    sync debug mode raises on one), equal to the same layer on the CPU."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.models.param import tree_map
    cfg = get_smoke_config("qwen3-moe-30b-a3b").with_(dtype="float32")
    params = Model(cfg).init(0, device="cpu")
    layer = tree_map(lambda a: a[0], params["layers"]["moe"])
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    want = moe.moe_apply(cfg, layer, x)
    layer_cuda = tree_map(lambda a: a.cuda(), layer)
    x_cuda = x.cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = moe.moe_apply(cfg, layer_cuda, x_cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.device.type == "cuda"
    torch.testing.assert_close(out.cpu(), want, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------- under autograd


def _grads_match(got, want, tol):
    """Each gradient within ``tol`` of its largest magnitude."""
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        err = (a.float() - b.float()).abs().max()
        assert err <= tol * b.float().abs().max(), (err, b.abs().max())


@pytest.mark.parametrize("B,Hq,Hkv,S,D,window", [
    (1, 4, 4, 128, 64, None),       # causal
    (2, 8, 2, 96, 64, None),        # GQA, a ragged key tile
    (1, 4, 2, 160, 32, 48),         # sliding window
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gradient_through_its_wrapper(hopper, B, Hq, Hkv, S,
                                                      D, window, dtype):
    """The gradient through ``_FlashAttention`` (the kernel forward, the
    plain recompute backward) equals the plain version's, within the
    forward bars of its largest magnitude."""
    q, k, v = [t.requires_grad_(True)
               for t in _qkv(hopper, B, Hq, Hkv, S, S, D, dtype)]
    before = fa.flash_attention_fwd.launches
    out = ops.mha(q, k, v, causal=True, window=window, use_kernel=True)
    assert fa.flash_attention_fwd.launches == before + 1
    want = attention_ref(q, k, v, causal=True, window=window)
    g = torch.randn(out.shape, generator=hopper, device="cuda", dtype=dtype)
    _grads_match(torch.autograd.grad(out, (q, k, v), g),
                 torch.autograd.grad(want, (q, k, v), g), TOL[dtype])


@pytest.mark.parametrize("r", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_gradient_through_its_wrapper(hopper, r, dtype):
    """The gradient through ``_SSDScan`` with B/C in group form equals the
    plain version's on B/C repeated to one row a head (their gradients
    summed over each group's heads), within the forward bars of its
    largest magnitude."""
    xs = [t.detach().requires_grad_(True)
          for t in _ssd_inputs(hopper, 8, 100, 32, 64, dtype, r)]
    before = ssd.ssd_scan_fwd.launches
    out = ops.ssd(*xs, chunk=64, use_kernel=True)
    assert ssd.ssd_scan_fwd.launches == before + 1
    x, dA, B, C = xs
    want = ssd_chunked_ref(x, dA, ssd.expand_groups(B, r),
                           ssd.expand_groups(C, r), chunk=64)
    g = torch.randn(out.shape, generator=hopper, device="cuda", dtype=dtype)
    _grads_match(torch.autograd.grad(out, xs, g),
                 torch.autograd.grad(want, xs, g),
                 2e-3 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("arch", ["glm4-9b", "mamba2-130m"])
def test_train_step_launches_each_kernel_twice_a_layer_under_remat(
        hopper, arch, tmp_path, monkeypatch):
    """One train step of the smoke config on the card: the kernel once a
    layer in the forward pass and once in its recompute (remat "full"),
    once a layer without remat; finite losses."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import TrainState, make_train_step
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans"))
    cfg = get_smoke_config(arch).with_(use_kernels=True)
    counter = ssd.ssd_scan_fwd if cfg.has_ssm else fa.flash_attention_fwd
    toks = torch.arange(2 * 65, device="cuda").reshape(2, 65) \
        % cfg.vocab_size
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for remat, per_layer in ((True, 2), (False, 1)):
        model = Model(cfg.with_(remat=remat))
        params = model.init(0, device="cuda")
        state = TrainState(params, init_opt_state(params))
        before = counter.launches
        state, metrics = make_train_step(model, OptConfig())(state, batch)
        torch.cuda.synchronize()
        assert counter.launches - before == per_layer * cfg.n_layers
        assert bool(torch.isfinite(metrics["loss"]))


def test_warm_plans_cold_then_warm_on_the_card(hopper, tmp_path,
                                               monkeypatch):
    """On a fresh store the engine solves every plan of its shapes; a
    second engine over that store only hits."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core import plan as plan_mod
    from repro_torch.kernels.autotune import plan_jobs
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeEngine
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans"))
    model = Model(get_smoke_config("mamba2-130m").with_(use_kernels=True))
    params = model.init(0, device="cuda")

    def engine():
        return ServeEngine(model, params, batch_size=2, cache_len=48,
                           prompt_len=32)

    cold = engine()
    n = len(plan_jobs(cold.plan_shapes()))
    assert (cold.stats["plan_warmup_solved"],
            cold.stats["plan_warmup_hits"]) == (n, 0) and n > 0
    with plan_mod._CACHES_LOCK:             # a second process
        plan_mod._CACHES.clear()
    warm = engine()
    assert (warm.stats["plan_warmup_solved"],
            warm.stats["plan_warmup_hits"]) == (0, n)


GEMM_KERNELS = ("softmax", "layernorm", "rmsnorm")


def _gemm_inputs(gen, M, K, N, dtype, kind="normal"):
    """a (M, K), b (K, N) in ``dtype``, f32 gamma/beta (N,).  ``spike``:
    column N - 1 of C exceeds the rest by about 30, so each row's max lies
    in the last CTA's slice.  ``mean_1e3``: rows of C are 1000 plus a sum of
    31 products of {-1, 0, 1} and {-0.25, 0, 0.25}, exact in both dtypes."""
    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale
    if kind == "mean_1e3":
        a = torch.randint(-1, 2, (M, K), generator=gen, device="cuda")
        b = torch.randint(-1, 2, (K, N), generator=gen, device="cuda") * 0.25
        a[:, 0], b[0] = 1, 1000.0
        a, b = a.to(dtype), b.to(dtype)
    else:
        a, b = rand(M, K).to(dtype), rand(K, N, scale=0.2).to(dtype)
        if kind == "spike":
            a[:, 0], b[0, N - 1] = 1, 30.0
    return a, b, rand(N), rand(N)


def _gemm_check(kernel, a, b, g, be, tiling=None):
    """The wrapper at ``tiling`` (default: the plan's, which it must
    record) against its plain version."""
    fn = {"softmax": gemm_softmax, "layernorm": gemm_layernorm,
          "rmsnorm": gemm_rmsnorm}[kernel]
    before = fn.launches
    if kernel == "softmax":
        out, want = fn(a, b, tiling=tiling), ref.gemm_softmax_ref(a, b)
    elif kernel == "layernorm":
        out, want = fn(a, b, g, be, tiling=tiling), \
            ref.gemm_layernorm_ref(a, b, g, be)
    else:
        out, want = fn(a, b, g, tiling=tiling), \
            ref.gemm_rmsnorm_ref(a, b, g)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    M, K = a.shape
    assert fn.last_tiling == (tiling or ge.planned_tiling(
        M, b.shape[1], K, a.dtype))
    assert out.dtype == a.dtype and out.shape == want.shape
    assert torch.isfinite(out).all()
    err = (out.float() - want.float()).abs().max()
    tol = ge.tolerance(kernel, a.dtype, float(want.float().abs().max()))
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("M,K,N", [
    (128, 64, 256), (200, 96, 256), (64, 128, 512), (96, 100, 128),  # JAX
    (200, 100, 1000),                  # ragged M/K/N, cluster 1
    (33, 40, 1032),                    # cluster 2, a ragged last slice
    (64, 64, 4096),                    # cluster 4
    (17, 72, 4104),                    # cluster 8, a ragged last slice
    (48, 64, 16384),                   # cluster 16
    (1, 128, 16384), (4, 128, 16384),  # the paper's M 1 and M 4
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", GEMM_KERNELS)
def test_gemm_epilogue_matches_plain_version(hopper, M, K, N, dtype, kernel):
    _gemm_check(kernel, *_gemm_inputs(hopper, M, K, N, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_softmax_max_in_the_last_slice(hopper, dtype):
    """The max must be the cluster's row max, not the CTA's."""
    a, b, g, be = _gemm_inputs(hopper, 8, 64, 16384, dtype, "spike")
    assert ge.tiling(16384, dtype).cluster == 16
    _gemm_check("softmax", a, b, g, be)
    assert (gemm_softmax(a, b)[:, -1].float() > 0.99).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_layernorm_rows_of_mean_1e3(hopper, dtype):
    """The centred variance: E[c^2] - mean^2 in f32 loses these rows."""
    _gemm_check("layernorm", *_gemm_inputs(hopper, 32, 32, 4096, dtype,
                                           "mean_1e3"))


@pytest.mark.parametrize("kernel", GEMM_KERNELS)
def test_gemm_epilogue_largest_shape_three_times(hopper, kernel):
    """A missing cluster barrier shows only now and then."""
    inputs = _gemm_inputs(hopper, 4096, 4096, 16384, torch.bfloat16)
    for _ in range(3):
        _gemm_check(kernel, *inputs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(28))
def test_gemm_epilogue_tiling_boundaries(hopper, dtype, case):
    """Both sides of every change of tiling (``ge.boundary_shapes``): N,
    then M around the row block, then K at 8, 100 (bf16 A padded) and off
    the K step."""
    shapes = ge.boundary_shapes(dtype)
    assert len(shapes) == 28
    M, K, N = shapes[case]
    inputs = _gemm_inputs(hopper, M, K, N, dtype)
    for kernel in GEMM_KERNELS:
        _gemm_check(kernel, *inputs)


# one shape an instance (bf16 128 rows; 64 rows in one pass and in two;
# f32), each with a ragged M: every tiling the kernel runs there
CANDIDATE_SHAPES = [(200, 72, 512, torch.bfloat16),
                    (100, 40, 4096, torch.bfloat16),
                    (70, 100, 2056, torch.bfloat16),
                    (37, 24, 1032, torch.float32)]


@pytest.mark.parametrize("M,K,N,dtype", CANDIDATE_SHAPES)
@pytest.mark.parametrize("kernel", GEMM_KERNELS)
def test_gemm_epilogue_every_candidate_tiling(hopper, M, K, N, dtype,
                                              kernel):
    """Every tiling of ``ge.tilings(N, dtype)``, the plan's candidates, and
    the default call at the plan's tiling, against the plain version."""
    inputs = _gemm_inputs(hopper, M, K, N, dtype)
    assert len(ge.tilings(N, dtype)) > 1
    for t in (None,) + ge.tilings(N, dtype):
        _gemm_check(kernel, *inputs, tiling=t)


def test_gemm_epilogue_clusters_can_be_placed(hopper):
    """Every instance the tilings launch can be placed at its cluster
    size."""
    for dtype in (torch.float32, torch.bfloat16):
        for rows, passes, cl in ge.instances(dtype):
            for epi in ge.EPILOGUES:
                assert ge.max_active_clusters(epi, dtype, rows, passes,
                                              cl) > 0


@pytest.mark.parametrize("dtype,N,bad", [
    (torch.bfloat16, 4096, (8, 128, 256, 1)),    # slices miss N's last half
    (torch.bfloat16, 8192, (16, 64, 1024, 1)),   # more than a pass holds
    (torch.bfloat16, 256, (1, 32, 256, 1)),      # no 32-row instance
    (torch.float32, 1024, (3, 16, 352, 1)),      # no cluster of 3
    (torch.bfloat16, 4096, (16, 64, 256, 2)),    # two passes, one needed
    (torch.bfloat16, 4096, (16, 128, 264, 1)),   # not the rule's slice
    (torch.bfloat16, 256, (16, 128, 24, 1)),     # CTAs with no columns
])
def test_gemm_epilogue_source_refuses_a_tiling_it_cannot_run(hopper, dtype,
                                                            N, bad):
    """The source takes its tiling from the wrapper and checks it: a tiling
    that is not one of ``ge.tilings`` (no instance, slices that do not
    cover N or are not the rule's, an idle CTA) is refused."""
    a, b, _, _ = _gemm_inputs(hopper, 8, 64, N, dtype)
    ge.launch("softmax", a, b, None, None, 0.0, ge.tiling(N, dtype))
    with pytest.raises(RuntimeError, match="CUDA error 1$"):
        ge.launch("softmax", a, b, None, None, 0.0, ge.Tiling(*bad))


def test_gemm_epilogue_raises_instead_of_falling_back(hopper):
    a = torch.randn(4, 32, device="cuda")
    before = gemm_softmax.launches
    with pytest.raises(ValueError, match="does not fit 16 slices"):
        gemm_softmax(a, torch.randn(32, 16392, device="cuda"))
    with pytest.raises(TypeError, match="share one dtype"):
        gemm_softmax(a, torch.randn(32, 64, device="cuda").bfloat16())
    assert gemm_softmax.launches == before


@pytest.mark.parametrize("M,K,N,chunks", [
    (64, 256, 128, 8), (128, 512, 256, 4), (8, 128, 128, 2),   # JAX tests
    (256, 4096, 512, 8), (128, 1024, 256, 8),                  # budget
    (200, 200, 136, 1),        # ragged M, N and a ragged k-tile
    (72, 160, 264, 4),         # kc 40: a ragged last k-tile in each chunk
    (33, 64, 40, 8),           # kc 8, below the k-tile
    (96, 256, 192, 1),         # one chunk
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streamed_gemm_matches_plain_version(hopper, M, K, N, chunks, dtype):
    _streamed_check(hopper, M, K, N, chunks, dtype)


def _streamed_check(gen, M, K, N, chunks, dtype):
    """Both buffer modes against the plain version, equal bit for bit, each
    call one launch."""
    x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(K, N, generator=gen, device="cuda") * 0.2).to(dtype)
    want = ref.streamed_gemm_ref(x, w, chunks=chunks)
    before = streamed_gemm.launches
    outs = [streamed_gemm(x, w, chunks=chunks, buffers=nbuf)
            for nbuf in (2, 1)]
    torch.cuda.synchronize()
    assert streamed_gemm.launches == before + 2
    atol, rtol = tolerance(dtype, float(want.float().abs().max()))
    for out in outs:
        assert out.dtype == dtype and out.shape == (M, N)
        torch.testing.assert_close(out.float(), want.float(), atol=atol,
                                   rtol=rtol)
    assert torch.equal(outs[0], outs[1])       # the same sums, in order


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(15))
def test_streamed_gemm_at_the_tiling_edges(hopper, dtype, case):
    """Every edge of the tiling (``boundary_shapes``): M and N on both sides
    of a tile, odd counts of row and column tiles, kc 8 to 1024, one chunk,
    more tiles than the persistent grid has CTAs."""
    shapes = boundary_shapes(dtype)
    assert len(shapes) == 15
    _streamed_check(hopper, *shapes[case], dtype)


def test_streamed_gemm_at_glm4_mlp_shape(hopper):
    """glm4-9b's MLP input projection, (4096, 4096, 13696), chunks=4."""
    _streamed_check(hopper, 4096, 4096, 13696, 4, torch.bfloat16)


def test_streamed_gemm_cluster_can_be_placed(hopper):
    """The persistent grid's slots, asked of the device the tensors lie on
    (each device is asked once)."""
    assert max_active_clusters() > 0
    for d in range(torch.cuda.device_count()):
        assert max_active_clusters(torch.device("cuda", d)) > 0
    for dtype, rows in CLUSTER.items():
        assert cluster(dtype) == rows


def test_streamed_gemm_tiles(hopper):
    for dtype, want in TILES.items():
        assert tile(dtype) == want


def test_streamed_gemm_raises_instead_of_falling_back(hopper):
    before = streamed_gemm.launches
    with pytest.raises(ValueError, match="must divide"):
        streamed_gemm(torch.randn(16, 100, device="cuda"),
                      torch.randn(100, 128, device="cuda"), chunks=3)
    with pytest.raises(ValueError, match="buffers"):
        streamed_gemm(torch.randn(16, 128, device="cuda"),
                      torch.randn(128, 128, device="cuda"), chunks=2,
                      buffers=3)
    with pytest.raises(ValueError, match="16-byte aligned"):
        streamed_gemm(torch.randn(16, 128, device="cuda").bfloat16(),
                      torch.randn(128, 132, device="cuda").bfloat16(),
                      chunks=2)
    assert streamed_gemm.launches == before


def test_allgather_gemm_through_one_nccl_rank(hopper):
    from repro_torch.launch import mesh
    group = mesh.host_group("cuda")
    try:
        x = torch.randn(512, 1024, generator=hopper, device="cuda").bfloat16()
        w = (torch.randn(1024, 768, generator=hopper, device="cuda")
             * 0.03).bfloat16()
        want = allgather_gemm_reference(x, w, group=group)
        atol, _ = tolerance(torch.bfloat16, float(want.float().abs().max()))
        for nbuf in (1, 2):
            out = allgather_gemm(x, w, group=group, buffers=nbuf)
            torch.cuda.synchronize()
            assert (out.float() - want.float()).abs().max() <= atol
    finally:
        mesh.destroy()


# ------------------------------------------ the op's faces on the card


def test_a_real_cuda_tensor_never_takes_the_fake_path(hopper):
    """A CUDA tensor launches the kernel (one more launch) and counts its
    formula; the result is real and holds the plain version's bar."""
    from torch._subclasses.fake_tensor import is_fake

    from repro_torch.analysis.counts import trace_counts
    q = torch.randn(1, 8, 300, 64, generator=hopper, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn(1, 2, 300, 64, generator=hopper, device="cuda",
                    dtype=torch.bfloat16)
    before = fa.flash_attention_fwd.launches
    out = []
    t = trace_counts(lambda: out.append(fa.flash_attention_fwd(
        q, k, k, causal=True)))
    assert fa.flash_attention_fwd.launches == before + 1
    assert not is_fake(out[0]) and out[0].is_cuda
    assert t.flops == fa.mma_flops(tuple(q.shape), tuple(k.shape),
                                   torch.bfloat16, True, None)
    want = attention_ref(q, k, k, causal=True, scale=64 ** -0.5)
    assert (out[0].float() - want.float()).abs().max() <= TOL[torch.bfloat16]


def test_profiler_grid_equals_the_tiling(hopper):
    """Each launch's grid, as torch.profiler records it, is the tiling
    the FLOP formula counted; its shared memory holds at least the
    library's dynamic figure, within the card's opt-in limit."""
    bf = torch.bfloat16
    optin = torch.cuda.get_device_properties(0) \
        .shared_memory_per_block_optin
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    q = torch.randn(1, 1, 1024, 64, device="cuda", dtype=bf)
    ev = kb.launch_events(lambda: fa.flash_attention_fwd(q, q, q,
                                                         causal=False),
                          ("fa_fwd",))
    t = fa.tiling(1, 1, 1, 1024, 1024, 64, bf, sms)
    assert [e["grid"] for e in ev] == [(*t.grid, 1)]
    assert fa.smem_bytes(bf, 64) <= ev[0]["shared_memory"] <= optin
    a = torch.randn(512, 128, device="cuda", dtype=bf)
    b = torch.randn(128, 4096, device="cuda", dtype=bf)
    ev = kb.launch_events(lambda: gemm_softmax(a, b), ("ge_",))
    tg = gemm_softmax.last_tiling
    assert tg == ge.planned_tiling(512, 4096, 128, bf)
    assert [e["grid"] for e in ev] == [(*ge.launch_grid(512, tg), 1)]
    assert ge.smem_bytes(bf, tg.rows, tg.passes) == \
        ge.layout_smem_bytes(bf, tg.rows, tg.passes)
    assert ge.smem_bytes(bf, tg.rows, tg.passes) <= \
        ev[0]["shared_memory"] <= optin
    x = torch.randn(4, 256, 64, device="cuda", dtype=bf)
    dA = -torch.rand(4, 256, device="cuda")
    bc = torch.randn(1, 256, 128, device="cuda", dtype=bf)
    ev = kb.launch_events(lambda: ssd.ssd_scan_fwd(x, dA, bc, bc, chunk=64),
                          ("ssd_fwd",))
    ts = ssd.tiling(4, 4, 256, 64, 128, bf)
    assert [e["grid"] for e in ev] == [(*ts.grid, 1)]
    assert ssd.bf16_tile(128, 64)[1] <= ev[0]["shared_memory"] <= optin
