"""The port's counter (``repro_torch.analysis.counts``) against the JAX
package's walker (``repro.analysis.jaxpr.structural_flops``): the same
matmul FLOPs on a matmul, a batched einsum, a gradient and a remat, and on
the smoke configs' mesh-free train steps, where each difference is named
term by term (ROADMAP C.19); the kernel entries' fake path counts their
formulas and builds and launches nothing; a real CPU tensor still takes
the plain version."""
import collections
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro.analysis.jaxpr import _dot_flops, structural_flops
from repro_torch.analysis.counts import (TraceCounts, fake_mode,
                                         trace_counts)
from repro_torch.kernels import autotune
from repro_torch.kernels.gemm_layernorm import gemm_layernorm
from repro_torch.kernels.gemm_softmax import gemm_softmax
from repro_torch.kernels.ref import (attention_ref, gemm_softmax_ref,
                                     ssd_chunked_ref, streamed_gemm_ref)

# the modules (``repro_torch.kernels`` exports functions of these names)
ag, fa, ge, ssd = (importlib.import_module(f"repro_torch.kernels.{m}")
                   for m in ("allgather_gemm", "flash_attention",
                             "gemm_epilogue", "ssd"))
RNG = np.random.default_rng(0)


def _pair(*shape):
    """The same f32 input for both packages: (numpy, torch)."""
    a = RNG.standard_normal(shape).astype(np.float32)
    return a, torch.from_numpy(a)


def _sd(a):
    return jax.ShapeDtypeStruct(a.shape, jnp.float32)


def test_matmul_flops_match_jax():
    a, ta = _pair(24, 40)
    b, tb = _pair(40, 56)
    j = structural_flops(lambda x, y: x @ y, _sd(a), _sd(b))
    assert trace_counts(lambda x, y: x @ y, ta, tb).flops == j == \
        2 * 24 * 40 * 56


def test_batched_einsum_flops_match_jax():
    a, ta = _pair(3, 5, 8, 16)
    b, tb = _pair(3, 5, 12, 16)
    eq = "bhqd,bhkd->bhqk"
    j = structural_flops(lambda x, y: jnp.einsum(eq, x, y), _sd(a), _sd(b))
    assert trace_counts(lambda x, y: torch.einsum(eq, x, y), ta, tb).flops \
        == j == 2 * 3 * 5 * 8 * 12 * 16


def _mlp_j(w1, w2, x):
    return jnp.sum(jnp.tanh(x @ w1) @ w2)


def _mlp_t(w1, w2, x):
    return torch.sum(torch.tanh(x @ w1) @ w2)


def test_gradient_flops_match_jax():
    (w1, t1), (w2, t2), (x, tx) = _pair(16, 32), _pair(32, 8), _pair(4, 16)
    j = structural_flops(jax.grad(_mlp_j, argnums=(0, 1)), _sd(w1), _sd(w2),
                         _sd(x))

    def step(w1_, w2_, x_):
        ws = [w1_.requires_grad_(True), w2_.requires_grad_(True)]
        torch.autograd.grad(_mlp_t(*ws, x_), ws)
    assert trace_counts(step, t1.clone(), t2.clone(), tx).flops == j


def test_remat_flops_match_jax():
    """A checkpointed block's forward runs again in the backward pass in
    both packages: forward + recompute + backward."""
    (w1, t1), (w2, t2), (x, tx) = _pair(16, 32), _pair(32, 8), _pair(4, 16)
    j = structural_flops(jax.grad(jax.checkpoint(_mlp_j), argnums=(0, 1)),
                         _sd(w1), _sd(w2), _sd(x))

    def step(w1_, w2_, x_):
        ws = [w1_.requires_grad_(True), w2_.requires_grad_(True)]
        y = torch.utils.checkpoint.checkpoint(_mlp_t, *ws, x_,
                                              use_reentrant=False)
        torch.autograd.grad(y, ws)
    t = trace_counts(step, t1.clone(), t2.clone(), tx).flops
    plain = structural_flops(jax.grad(_mlp_j, argnums=(0, 1)), _sd(w1),
                             _sd(w2), _sd(x))
    assert t == j and j > plain


def _no_library(monkeypatch):
    """Every kernel module's build refuses: the fake path must not ask."""
    def refuse(*a, **k):
        raise AssertionError("a fake tensor reached _library()")
    for mod in (fa, ssd, ge, ag):
        monkeypatch.setattr(mod, "_library", refuse)
    monkeypatch.setattr(fa, "_sms", refuse)


def _launches():
    return (fa.flash_attention_fwd.launches, ssd.ssd_scan_fwd.launches,
            gemm_softmax.launches, gemm_layernorm.launches,
            ag.streamed_gemm.launches)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 100)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fake_flash_attention_counts_its_formula(monkeypatch, causal,
                                                 window, dtype):
    _no_library(monkeypatch)
    before = _launches()
    with fake_mode():
        q = torch.empty(2, 8, 300, 64, dtype=dtype, device="cuda")
        k = torch.empty(2, 2, 300, 64, dtype=dtype, device="cuda")
        t = trace_counts(lambda: fa.flash_attention_fwd(
            q, k, k, causal=causal, window=window))
    want = fa.mma_flops((2, 8, 300, 64), (2, 2, 300, 64), dtype, causal,
                        window)
    assert t.flops == want and t.findings == [] and _launches() == before
    # the tiles the causal mask skips are left out, padding is counted:
    # bf16 q tiles of 64 rows a head (two heads an item), keys of 128;
    # f32 64 and 64
    t = fa.tiling(2, 8, 2, 300, 300, 64, dtype)
    rows, keys = (t.rows, t.keys)
    full = 4 * 2 * 8 * (-(-300 // rows) * rows) * (-(-300 // keys) * keys) \
        * 64
    assert (want < full) == (causal or window is not None)
    if not causal and window is None:
        assert want == full


def test_fake_ssd_and_gemms_count_their_formulas(monkeypatch):
    _no_library(monkeypatch)
    before = _launches()
    bf = torch.bfloat16
    with fake_mode():
        x = torch.empty(8, 200, 64, dtype=bf, device="cuda")
        dA = torch.empty(8, 200, device="cuda")
        bc = torch.empty(2, 200, 128, dtype=bf, device="cuda")
        t_ssd = trace_counts(lambda: ssd.ssd_scan_fwd(x, dA, bc, bc,
                                                      chunk=64))
        a = torch.empty(300, 256, dtype=bf, device="cuda")
        b = torch.empty(256, 4096, dtype=bf, device="cuda")
        g = torch.empty(4096, dtype=bf, device="cuda")
        t_sm = trace_counts(lambda: gemm_softmax(a, b))
        t_ln = trace_counts(lambda: gemm_layernorm(a, b, g, g))
        w = torch.empty(256, 512, dtype=bf, device="cuda")
        t_sg = trace_counts(lambda: ag.streamed_gemm(a, w, chunks=4))
    assert t_ssd.flops == ssd.mma_flops(8, 200, 64, 128, 64, bf)
    # four chunks of 64-row tiles, S o L's product twice (hi and lo)
    assert ssd.mma_flops(8, 256, 64, 128, 64, bf) == 8 * 4 * 2 * 64 * (
        64 * 128 + 2 * 64 * 64 + 64 * 128 + 128 * 64)
    # the wrappers launch the plan's tiling, (16, 64, 256, 1): 5 blocks
    # of 64 rows, each CTA over a pass of 512 columns (its 256 and 256
    # computed and dropped); the first tiling's blocks of 128 rows would
    # issue 384 rows over 16 x 256 columns
    plan = autotune.gemm_epilogue_tiling(300, 4096, 256, bf)
    assert gemm_softmax.last_tiling == gemm_layernorm.last_tiling == plan \
        == (16, 64, 256, 1)
    assert t_sm.flops == t_ln.flops == ge.mma_flops(300, 4096, 256, bf,
                                                    plan) \
        == 2 * 320 * 16 * 512 * 256
    assert ge.mma_flops(300, 4096, 256, bf, ge.tiling(4096, bf)) \
        == 2 * 384 * 4096 * 256
    assert t_sg.flops == ag.mma_flops(300, 512, 256, 4, bf)
    assert _launches() == before
    assert not any(t.findings for t in (t_ssd, t_sm, t_ln, t_sg))


def test_real_cpu_tensors_take_the_plain_version():
    before = _launches()
    q = torch.randn(1, 4, 40, 32)
    k = torch.randn(1, 2, 40, 32)
    t = trace_counts(lambda: None)
    assert isinstance(t, TraceCounts)
    out = fa.flash_attention_fwd(q, k, k, causal=True)
    assert torch.equal(out, attention_ref(q, k, k, causal=True,
                                          scale=32 ** -0.5))
    # outside a dispatch mode the entry calls the op's function itself;
    # through the dispatcher the op gives the same
    assert torch.equal(out, fa._op.op(q, k, k, True, 32 ** -0.5, None))
    x, dA = torch.randn(4, 30, 16), -torch.rand(4, 30)
    b = torch.randn(2, 30, 16)
    y = ssd.ssd_scan_fwd(x, dA, b, b, chunk=16)
    ref = ssd_chunked_ref(x, dA, b.repeat_interleave(2, 0),
                          b.repeat_interleave(2, 0), chunk=16)
    assert torch.equal(y, ref)
    a, w = torch.randn(20, 64), torch.randn(64, 32)
    assert torch.equal(gemm_softmax(a, w), gemm_softmax_ref(a, w))
    assert torch.equal(ag.streamed_gemm(a, w, chunks=2),
                       streamed_gemm_ref(a, w, chunks=2))
    assert _launches() == before


# ------------------------------------------------ the mesh-free train step

B, S = 4, 16
# What the port's step counts beyond (+) or short of (-) the JAX step's,
# term by term: {FLOPs of one product: products}, ROADMAP C.19.  glm4 and
# qwen3-moe: none.  mamba2: JAX's einsum lowers the SSD reference's
# three-operand einsums (``bzcn,bzc,bzcp->bznp``, ``bzcn,bznp,bzc->bzcp``)
# to dot_generals that the walker counts where torch's einsum multiplies
# elementwise or associates otherwise: 16 contraction-free dots of 2 x 32
# x 16 x 16 and 6 batched 16^3 products more in JAX.  hymba: the same,
# and the port's SSD chunk is the h100 plan's 64, zero-padding S 16 into
# one 64-row chunk (models/ssm.py), where the JAX model cuts its plan's 128
# to gcd(S, 128) = 16: the (64 x 64) intra-chunk products of 8 and 16 state
# and head columns appear, the chunk-16 ones go.
MESH_FREE_TERMS = {
    "glm4-9b": {},
    "qwen3-moe-30b-a3b": {},
    "mamba2-130m": {16384: -16, 262144: -6},
    "hymba-1.5b": {8192: -8, 16384: -8, 131072: -24, 262144: -8,
                   524288: 10, 2097152: 8, 4194304: 8},
}


def _jax_products(arch):
    from repro.configs import get_smoke_config as jsmoke
    from repro.models import Model as JModel
    from repro.train.optimizer import OptConfig as JOpt
    from repro.train.optimizer import init_opt_state as jinit
    from repro.train.train_step import TrainState as JTS
    from repro.train.train_step import make_train_step as jstep
    jm = JModel(jsmoke(arch))
    ab = jm.abstract_params()
    state = JTS(params=ab, opt=jax.eval_shape(jinit, ab))
    batch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
             for k in ("tokens", "labels")}
    closed = jax.make_jaxpr(jstep(jm, JOpt()))(state, batch)
    out = collections.Counter()

    def walk(jaxpr, mult):   # the walker's multipliers (no shard_map here)
        for e in jaxpr.eqns:
            name = e.primitive.name
            if name == "dot_general":
                out[int(_dot_flops(e))] += mult
            elif name == "scan":
                walk(e.params["jaxpr"].jaxpr, mult * e.params["length"])
            elif name == "cond":
                walk(e.params["branches"][0].jaxpr, mult)
            else:
                for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                    sub = e.params.get(key)
                    if sub is not None:
                        walk(getattr(sub, "jaxpr", sub), mult)
    walk(closed.jaxpr, 1)
    return structural_flops(jstep(jm, JOpt()), state, batch), out


class _Products(TorchDispatchMode):
    """FlopCounterMode's count of each aten product, one by one."""

    def __init__(self):
        super().__init__()
        self.out = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        res = func(*args, **(kwargs or {}))
        p = func._overloadpacket
        if p in flop_registry:
            self.out[int(flop_registry[p](*args, **(kwargs or {}),
                                          out_val=res))] += 1
        return res


@pytest.mark.parametrize("arch", sorted(MESH_FREE_TERMS))
def test_mesh_free_train_step_flops_against_jax(arch):
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    jflops, jprod = _jax_products(arch)
    model = Model(get_smoke_config(arch))
    state = init_train_state(model, model.init(0, device="cpu"))
    batch = {k: torch.zeros((B, S), dtype=torch.long)
             for k in ("tokens", "labels")}
    step = make_train_step(model, OptConfig())
    prods = _Products()
    with prods:
        t = trace_counts(step, state, batch)
    assert t.findings == []
    assert t.flops == sum(f * n for f, n in prods.out.items())
    diff = {f: prods.out[f] - jprod[f] for f in set(prods.out) | set(jprod)
            if prods.out[f] != jprod[f]}
    assert diff == MESH_FREE_TERMS[arch]
    assert t.flops - jflops == sum(f * n for f, n in diff.items())
