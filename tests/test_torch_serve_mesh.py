"""The port's serving path on a ``(data, model)`` mesh against the JAX
package on the CPU.

Every case of ``torch_mesh_ranks.SERVE_CASES`` runs in the ``serve`` suite
(gloo ranks by spawn, world 2 and world 4 side by side in two
subprocesses with a timeout; nothing here forks or starts a pool), f32
smoke configs (MoE at capacity factor E / k, ``torch_mesh_ranks.
case_overrides``, so that each data rank's capacity drops nothing): glm4-9b on
(2, 1), (1, 2) and (1, 4) (on (1, 4) its 2 kv heads do not divide, so the
decode cache is sequence-sharded: distSM), mamba2-130m and hymba-1.5b on
(1, 2) and (1, 4) (hymba's prompt wraps its ring cache), hymba with 5 q
and 5 kv heads of 12 on (1, 2) (wq and wk split mid-head, as hymba-1.5b's
at full size), qwen3-moe-30b-a3b on (2, 2), deepseek-v3-671b (MLA, the
dense stack, shared experts) and seamless-m4t-medium on (1, 2).

Each case holds, on every rank: the engine's greedy tokens through
continuous-batching refills equal to the JAX engine's without a mesh;
the prefill's and first decode step's logits (the rank's rows and block
of the vocab) within 1e-5 of the largest; every cache shard equal to the
JAX cache's block under the JAX ``cache_shardings``; and each named
collective's count per prefill and decode step as PERF.md states
(:data:`COUNTS`).  In-process: the distSM merge of m shards against one
softmax, the sharded greedy token's tie-break, hymba's mid-head split.
"""
import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import torch_mesh_checks as checks
import torch_mesh_ranks as ranks
from repro.configs import get_smoke_config as jget_smoke
from repro.models import Model as JModel
from repro.parallel import sharding as jsh
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.registry import get_config
from repro_torch.launch import kernel_bench as kb
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention, layers
from repro_torch.models.model import Model

CASES = [(world, arch, shape) for world, cases in ranks.SERVE_CASES.items()
         for arch, shape in cases]
IDS = [f"{arch}-{ranks.tag_of(shape)}" for _, arch, shape in CASES]
TOL = 1e-5          # f32 sums over the ranks in another order
# a cache of an SSD family against the JAX package's: both round the scan's
# inputs to bf16, and a rounding flip moves hymba's k/v by up to 2e-3 of
# the largest (tests/test_torch_hybrid.py's FLIP_TOL); each shard is held
# at TOL against the port's own cache without a mesh
SSD_JAX_TOL = 2e-3

# The collectives of one prefill and of one decode step, each with its
# greedy token, by label, on every rank (as PERF.md §6 states).  Per layer:
# tp/attn-out (attention, MLA and cross-attention outputs), tp/ffn-out
# (MLP), tp/q-gather (q heads cut mid-head, or gathered for a decode over
# sequence shards), tp/kv-gather (k and v where kv heads do not divide),
# serve/attn-max + serve/attn-sum (distSM), tp/ssm-gather x 2 (in_proj
# output, conv output), tp/ssm-norm, tp/ssm-out, moe/combine,
# moe/shared-out; per call tp/embed and serve/argmax.  A one-rank model
# axis runs its collectives as copies.
_BASE = {"tp/embed": 1, "serve/argmax": 1}
_GLM = dict(_BASE, **{"tp/attn-out": 2, "tp/ffn-out": 2})
_SSM = {"tp/ssm-gather": 4, "tp/ssm-norm": 2, "tp/ssm-out": 2}
_DIST = {"serve/attn-max": 2, "serve/attn-sum": 2}
COUNTS = {
    ("glm4-9b", (2, 1)): (_GLM, _GLM),
    ("glm4-9b", (1, 2)): (_GLM, _GLM),
    ("glm4-9b", (1, 4)): (dict(_GLM, **{"tp/kv-gather": 4}),
                          dict(_GLM, **{"tp/kv-gather": 4, "tp/q-gather": 2},
                               **_DIST)),
    ("mamba2-130m", (1, 2)): (dict(_BASE, **_SSM), dict(_BASE, **_SSM)),
    ("mamba2-130m", (1, 4)): (dict(_BASE, **_SSM), dict(_BASE, **_SSM)),
    ("hymba-1.5b", (1, 2)): (dict(_GLM, **_SSM), dict(_GLM, **_SSM)),
    ("hymba-1.5b", (1, 4)): (
        dict(_GLM, **_SSM, **{"tp/kv-gather": 4}),
        dict(_GLM, **_SSM, **_DIST, **{"tp/kv-gather": 4,
                                        "tp/q-gather": 2})),
    ("hymba-1.5b-h5", (1, 2)): (
        dict(_GLM, **_SSM, **{"tp/kv-gather": 4, "tp/q-gather": 2}),
        dict(_GLM, **_SSM, **_DIST, **{"tp/kv-gather": 4,
                                        "tp/q-gather": 2})),
    ("deepseek-v3-671b", (1, 2)): (
        dict(_BASE, **{"tp/attn-out": 3, "tp/ffn-out": 1, "moe/combine": 2,
                       "moe/shared-out": 2}),
        dict(_BASE, **{"tp/attn-out": 3, "tp/ffn-out": 1, "moe/combine": 2,
                       "moe/shared-out": 2, "tp/q-gather": 3,
                       "serve/attn-max": 3, "serve/attn-sum": 3})),
    ("seamless-m4t-medium", (1, 2)): (
        dict(_BASE, **{"tp/attn-out": 6, "tp/ffn-out": 4}),
        dict(_BASE, **{"tp/attn-out": 4, "tp/ffn-out": 2})),
    ("qwen3-moe-30b-a3b", (2, 2)): (
        dict(_BASE, **{"tp/attn-out": 2, "moe/combine": 2}),
        dict(_BASE, **{"tp/attn-out": 2, "moe/combine": 2})),
}


@pytest.fixture(scope="module")
def serve_out(tmp_path_factory):
    return ranks.run_worlds(tmp_path_factory, tuple(ranks.SERVE_CASES),
                            "serve")


def _results(serve_out, world, arch, shape):
    return ranks.load(serve_out[world],
                      f"serve_{arch}_{ranks.tag_of(shape)}", world)


def _to_jax(t):
    return {k: _to_jax(v) for k, v in t.items()} if isinstance(t, dict) \
        else jnp.asarray(t.numpy())


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def jax_reference(arch):
    """The JAX package without a mesh, from the port's initial params:
    the prefill's and decode step's logits and caches on
    ``serve_inputs``, and the engine's outputs and stats."""
    cfg = ranks.case_config(arch)
    jcfg = jget_smoke(ranks.case_base(arch)).with_(
        **ranks.case_overrides(arch))
    jm, jp = JModel(jcfg), _to_jax(Model(cfg).init(0, device="cpu"))
    B, P, C = ranks.serve_sizes(arch)
    toks, src, nxt, prompts = ranks.serve_inputs(cfg, arch)
    batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    if cfg.is_encdec:
        batch["src_embeds"] = jnp.asarray(src)
    logits, cache = jm.prefill(jp, batch, C)
    logits2, cache2 = jm.decode(jp, cache, jnp.asarray(nxt, jnp.int32))
    reqs = [JRequest(rid=i, prompt=p.copy(), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts,
                                           ranks.SERVE_NEW_TOKENS))]
    eng = JServeEngine(jm, jp, batch_size=B, cache_len=C, prompt_len=P,
                       plan_warmup=False)
    eng.run(reqs)
    return {"prefill_logits": np.asarray(logits),
            "decode_logits": np.asarray(logits2),
            "prefill": (cache, _flat(cache)), "decode": (cache2, _flat(cache2)),
            "outputs": [r.output for r in reqs], "stats": dict(eng.stats),
            "port": port_caches(arch)}


def port_caches(arch):
    """The port's own caches without a mesh after the prefill and after
    the decode step of ``serve_inputs``, by name."""
    from repro_torch.train.checkpoint import flatten_with_names
    cfg = ranks.case_config(arch)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    toks, src, nxt, _ = ranks.serve_inputs(cfg, arch)
    batch = {"tokens": torch.from_numpy(toks).long()}
    if cfg.is_encdec:
        batch["src_embeds"] = torch.from_numpy(src)
    out = {}
    with torch.no_grad():
        _, cache = model.prefill(params, batch, ranks.serve_sizes(arch)[2])
        out["prefill"] = {n: t.numpy().copy()
                          for n, t in flatten_with_names(cache)}
        model.decode(params, cache, torch.from_numpy(nxt).long())
        out["decode"] = {n: t.numpy().copy()
                         for n, t in flatten_with_names(cache)}
    return out


def _close(got, want, what, rel=TOL):
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: {err} > {tol}"


@pytest.mark.parametrize("world,arch,shape", CASES, ids=IDS)
def test_prefill_counters_count_the_global_slots(serve_out, world, arch,
                                                 shape):
    B, P, _ = ranks.serve_sizes(arch)
    n = len(ranks.SERVE_NEW_TOKENS)         # prompts of P tokens each
    for _, meta in _results(serve_out, world, arch, shape):
        st = meta["stats"]
        assert st["prefill_prompt_tokens"] == n * P
        assert st["prefill_tokens"] == st["prefill_calls"] * B * P


@pytest.mark.parametrize("world,arch,shape", CASES, ids=IDS)
def test_engine_tokens_equal_the_jax_engine(serve_out, world, arch, shape):
    ref = jax_reference(arch)
    for _, meta in _results(serve_out, world, arch, shape):
        assert meta["outputs"] == ref["outputs"]
        for key in ("prefill_calls", "decode_steps", "tokens_out"):
            assert meta["stats"][key] == ref["stats"][key]
        assert ref["stats"]["prefill_calls"] > 1       # slots were refilled
        assert not any(meta["drops"]) and not any(meta["engine_drops"])
        if ranks.case_config(arch).is_moe:
            assert meta["drops"] and meta["engine_drops"]    # counted


@pytest.mark.parametrize("world,arch,shape", CASES, ids=IDS)
def test_logits_match_jax(serve_out, world, arch, shape):
    ref = jax_reference(arch)
    cfg = ranks.case_config(arch)
    m = shape[1]
    for arr, meta in _results(serve_out, world, arch, shape):
        r0, r1 = meta["rows"]
        cols = cfg.padded_vocab // m if cfg.padded_vocab % m == 0 \
            else cfg.padded_vocab
        c0 = meta["coord"][1] * cols if cols < cfg.padded_vocab else 0
        for step in ("prefill_logits", "decode_logits"):
            assert arr[step].shape == (r1 - r0, 1, cols)
            _close(arr[step], ref[step][r0:r1, :, c0:c0 + cols], step)


@pytest.mark.parametrize("world,arch,shape", CASES, ids=IDS)
def test_cache_shards_are_placed_as_cache_shardings(serve_out, world, arch,
                                                    shape):
    ref = jax_reference(arch)
    B = ranks.serve_sizes(arch)[0]
    res = _results(serve_out, world, arch, shape)
    jax_tol = SSD_JAX_TOL if ranks.case_config(arch).has_ssm else TOL
    for step in ("prefill", "decode"):
        port = ref["port"][step]
        cache, flat = ref[step]
        placed = jsh.cache_shardings(cache, AbstractMesh(shape, checks.AXES),
                                     B)
        specs = {jax.tree_util.keystr(p): checks._trimmed(v.spec)
                 for p, v in jax.tree_util.tree_flatten_with_path(
                     placed, is_leaf=lambda x: isinstance(
                         x, jax.sharding.NamedSharding))[0]}
        assert any(specs.values()) or shape == (1, 1)
        for arr, meta in res:
            got = {k[len(step):]: v for k, v in arr.items()
                   if k.startswith(step + "[")}
            assert set(got) == set(flat)
            for name, want in flat.items():
                block = checks.block_index(specs[name], meta["coord"], shape,
                                           want.shape)
                assert got[name].shape == want[block].shape, name
                if want.dtype.kind == "i":
                    np.testing.assert_array_equal(got[name], want[block],
                                                  err_msg=name)
                else:
                    _close(got[name], want[block], f"{step}{name}", jax_tol)
                    _close(got[name], port[name][block], f"{step}{name}")


@pytest.mark.parametrize("world,arch,shape", CASES, ids=IDS)
def test_init_cache_makes_each_shard_at_its_size(serve_out, world, arch,
                                                 shape):
    """``init_cache(mesh=)``: each leaf at the size of its block of the JAX
    package's empty cache under its ``cache_shardings``, empty (zeros;
    ``kpos`` -1 a slot)."""
    cfg = ranks.case_config(arch)
    jcfg = jget_smoke(ranks.case_base(arch)).with_(
        **ranks.case_overrides(arch))
    B, _, C = ranks.serve_sizes(arch)
    jcache = jax.eval_shape(lambda: JModel(jcfg).init_cache(B, C))
    placed = jsh.cache_shardings(jcache, AbstractMesh(shape, checks.AXES), B)
    specs = {jax.tree_util.keystr(p): checks._trimmed(v.spec)
             for p, v in jax.tree_util.tree_flatten_with_path(
                 placed, is_leaf=lambda x: isinstance(
                     x, jax.sharding.NamedSharding))[0]}
    whole = {jax.tree_util.keystr(p): v.shape for p, v in
             jax.tree_util.tree_flatten_with_path(jcache)[0]}
    for _, meta in _results(serve_out, world, arch, shape):
        got = meta["init_cache"]
        assert set(got) == set(whole)
        for name, full in whole.items():
            block = checks.block_index(specs[name], meta["coord"], shape,
                                       full)
            want = [len(range(*b.indices(n))) for b, n in zip(block, full)]
            size, total = got[name]
            assert size == want, name
            assert total == (-float(np.prod(size)) if "kpos" in name
                             else 0.0), name
        assert cfg.is_encdec == ("['cross']['k']" in got)


@pytest.mark.parametrize("world,arch,shape", CASES, ids=IDS)
def test_collectives_per_layer_and_step(serve_out, world, arch, shape):
    prefill, decode = COUNTS[(arch, shape)]
    for _, meta in _results(serve_out, world, arch, shape):
        for got, want in ((meta["prefill"], prefill),
                          (meta["decode"], decode)):
            assert collections.Counter(r[0] for r in got) == want
            assert {r[3] for r in got} <= {1, shape[1]}
        # the engine: its calls' collectives, and each step's tokens
        # gathered over the data axis where it splits the slots
        engine = collections.Counter(r[0] for r in meta["engine"])
        calls = meta["stats"]["prefill_calls"] + meta["stats"]["decode_steps"]
        assert engine.pop("serve/tokens", 0) == (calls if shape[0] > 1
                                                else 0)
        assert set(engine) == set(prefill) | set(decode)
        assert engine["serve/argmax"] == calls


def test_distsm_collectives_merge_a_sequence_sharded_decode(serve_out):
    """glm4 on (1, 4): 2 kv heads on 4 ranks, so the decode cache holds
    each rank's 8 of 32 slots of both kv heads, and the decode merges the
    ranks' partial softmaxes with the named collectives."""
    for arr, meta in _results(serve_out, 4, "glm4-9b", (1, 4)):
        assert arr["decode['layers']['attn']['k']"].shape[2:4] == (8, 2)
        labels = [(r[0], r[1]) for r in meta["decode"]]
        assert ("serve/attn-max", "AllReduce") in labels
        assert ("serve/attn-sum", "AllReduce") in labels


def test_deadline_is_agreed_over_the_mesh(serve_out):
    """A deadline every request blows: each gets one token on every rank,
    and the flags are agreed once a decode step."""
    for _, meta in _results(serve_out, 2, "glm4-9b", (1, 2)):
        late = meta["late"]
        assert [len(o) for o in late["outputs"]] == [1] * 6
        assert all(late["timed_out"])
        agreed = [r for r in late["records"] if r[0] == "serve/deadline"]
        assert len(agreed) == late["stats"]["decode_steps"] > 0


# ------------------------------------------------------------- in-process


def _shard_run(fn, shards, collective_of, passes=6):
    """Run ``fn(shard, collective)`` for every shard as the ranks of one
    model axis would, in passes: each collective call gets the reduction
    (``collective_of``) of every shard's input to that call in the pass
    before (the first pass: its own input, m times).  Each pass settles
    one more collective of a chain, so ``passes`` above the chain's
    length gives what the ranks would compute together."""
    shards, seen, outs = list(shards), None, []
    for _ in range(passes):
        now, outs = collections.defaultdict(list), []
        for sh in shards:
            calls = collections.Counter()

            def coll(col_type, label, x, group, **kw):
                k = calls[label]
                calls[label] += 1
                now[label].append(x)
                if seen is None:
                    parts = [x] * len(shards)
                else:
                    n = len(seen[label]) // len(shards)
                    parts = [seen[label][j * n + k]
                             for j in range(len(shards))]
                return collective_of(col_type, label, parts, kw)
            outs.append(fn(sh, coll))
        seen = now
    return outs


def _reduce(col_type, label, parts, kw):
    if col_type == "AllGather":
        return torch.cat(parts, dim=kw.get("dim", -1))
    if kw.get("op") is not None and kw["op"] == torch.distributed.ReduceOp.MAX:
        return torch.stack(parts).amax(0)
    return torch.stack(parts).sum(0)


@pytest.mark.parametrize("m,masked", [(2, ()), (4, ()), (4, (2, 3)),
                                      (4, (0, 1, 2, 3))])
def test_distsm_merge_equals_one_softmax(monkeypatch, m, masked):
    """The merge of m shards of the keys (a MAX All-Reduce of the maxima,
    one SUM All-Reduce of the exp-sums and outputs) against one softmax
    over all keys; shards in ``masked`` see no valid key (all four: a row
    no rank sees gives zeros, not NaN)."""
    rng = np.random.default_rng(0)
    S, D = 32, 16
    s = torch.from_numpy(rng.standard_normal((3, 5, S)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((3, S, D)).astype(np.float32))
    valid = torch.from_numpy(rng.random((3, 1, S)) < 0.7).expand(3, 5, S)
    valid = valid.clone()
    n = S // m
    for j in masked:
        valid[..., j * n:(j + 1) * n] = False

    def one(sh, coll):
        monkeypatch.setattr(attention, "collective", coll)
        sl = slice(sh * n, (sh + 1) * n)
        vs = v[:, sl]
        return attention._softmax_apply(
            s[..., sl], valid[..., sl],
            lambda pr: torch.einsum("bhs,bsd->bhd", pr, vs), group=object())
    outs = _shard_run(one, range(m), _reduce)
    want = attention._softmax_apply(
        s, valid, lambda pr: torch.einsum("bhs,bsd->bhd", pr, v))
    if len(masked) == m:
        want = torch.zeros_like(want)
    for got in outs:
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


class _AxisMesh:
    """Rank ``r`` of a (1, m) mesh: the attributes the layers read."""

    def __init__(self, m, r):
        self.mesh_dim_names, self.shape, self.r = ("data", "model"), (1, m), r

    def get_local_rank(self, axis):
        return self.r if axis == "model" else 0

    def get_group(self, axis):
        return None


@pytest.mark.parametrize("m", [2, 4])
def test_sharded_greedy_token_ties_to_the_lowest_index(monkeypatch, m):
    """Each rank's block of the padded vocab: the token is the argmax of
    the whole logits cut to the real vocab, and on a tie the lowest index,
    across ranks and within one; the padding never wins."""
    cfg = ranks.case_config("glm4-9b").with_(vocab_size=500)   # Vp 512
    Vp = cfg.padded_vocab
    logits = torch.zeros(4, Vp)
    logits[0, [7, 300]] = 3.0            # a tie across ranks
    logits[1, [260, 261]] = 2.0          # a tie within one rank
    logits[2, 505] = 9.0                 # padding: never the token
    logits[2, 499] = 1.0
    logits[3] = 1.0                      # all equal: index 0
    want = logits[:, :cfg.vocab_size].argmax(-1)
    assert want.tolist() == [7, 260, 499, 0]
    cols = Vp // m

    def one(r, coll):
        monkeypatch.setattr(layers, "collective", coll)
        monkeypatch.setattr(layers, "model_axis",
                            lambda mesh: (m, r, None))
        return layers.greedy_token(cfg, logits[:, r * cols:(r + 1) * cols],
                                   mesh=object())
    for got in _shard_run(one, range(m), _reduce):
        assert got.tolist() == want.tolist()


def test_hymba_mid_head_split(monkeypatch):
    """hymba-1.5b at full width on a model axis of 2: a rank's 800 wq
    columns hold 12.5 of 25 heads, so q is gathered whole and every rank
    attends every head; its 800 wo rows take columns [800 r, 800 r + 800)
    of the output, and the two partial products sum to the attention
    without a mesh.  Run at hymba's widths over 4 positions."""
    cfg = get_config("hymba-1.5b").with_(dtype="float32", n_layers=1)
    H, Hkv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    assert (H * hd // 2, H % 2, Hkv % 2) == (800, 1, 1)
    rng = np.random.default_rng(0)
    w = {k: torch.from_numpy((rng.standard_normal(s) / np.sqrt(s[0]))
                             .astype(np.float32))
         for k, s in (("wq", (d, H * hd)), ("wk", (d, Hkv * hd)),
                      ("wv", (d, Hkv * hd)), ("wo", (H * hd, d)))}
    x = torch.from_numpy(rng.standard_normal((1, 4, d)).astype(np.float32))
    want, _ = attention.attn_prefill(cfg, w, x)
    gathered = []

    def one(r, coll):
        def gather(t, group, label, grad_label, dim=-1):
            gathered.append(label)
            return coll("AllGather", label, t, group, dim=dim)

        def leave(t, group, label):
            return coll("AllReduce", label, t, group)
        monkeypatch.setattr(attention, "gather_shards", gather)
        monkeypatch.setattr(attention, "leave_parallel", leave)
        monkeypatch.setattr(attention, "cache_block",
                            lambda name, shape, mesh: tuple(
                                (0, n) for n in shape))
        local = {"wq": w["wq"][:, r * 800:(r + 1) * 800],
                 "wk": w["wk"][:, r * 160:(r + 1) * 160],
                 "wv": w["wv"][:, r * 160:(r + 1) * 160],
                 "wo": w["wo"][r * 800:(r + 1) * 800]}
        out, _ = attention.attn_prefill(cfg, local, x,
                                        mesh=_AxisMesh(2, r))
        return out
    for got in _shard_run(one, range(2), _reduce):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    # one q gather and two kv gathers (k, v) a rank and pass
    assert gathered.count("tp/q-gather") == 2 * 6
    assert gathered.count("tp/kv-gather") == 4 * 6


def test_serve_cli_mesh_host_matches_no_mesh(capsys):
    """``--mesh host`` on the CPU (a one-rank gloo mesh) prints the JAX
    CLI's JSON line with the same counts as without a mesh."""
    argv = ["--arch", "hymba-1.5b", "--smoke", "--device", "cpu",
            "--requests", "3", "--batch", "2", "--prompt-len", "8",
            "--cache-len", "16", "--max-new", "2", "--no-plan-warmup"]
    plain = serve_cli.main(argv)
    meshed = serve_cli.main(argv + ["--mesh", "host"])
    for key in ("requests", "completed", "tokens", "decode_steps",
                "prefill_calls"):
        assert meshed[key] == plain[key]
    assert set(meshed) == set(plain)
    assert capsys.readouterr().out.count('"tokens": 6') == 2


@pytest.mark.parametrize("arch,m", list(kb.RANK_ATTENTION_SHAPES))
def test_rank_attention_shapes_are_a_ranks(arch, m):
    """``kernel_bench.RANK_ATTENTION_SHAPES``, which the card checks and
    times, are what one rank's prefill hands FlashAttention: its q heads
    (every head where H does not split), the kv heads they read, views of
    the kv projection it holds (gathered where Hkv does not split), at the
    batch and prompt of chip_smoke's serve phases."""
    cfg = get_config(arch)
    B, Hq, Hkv, Sq, Skv, D, causal, window, kv_of = \
        kb.RANK_ATTENTION_SHAPES[(arch, m)]
    H, G = cfg.n_heads, cfg.n_kv_heads
    n = H // m if H % m == 0 else H
    sel = attention._kv_heads(H, G, 0, n)
    assert (Hq, Hkv, D, window, causal) == (
        n, sel.stop - sel.start, cfg.hd, cfg.window, True)
    assert kv_of == (G // m if G % m == 0 else G)
    assert (B, Sq, Skv) == (4,) + (kb.FAMILY_ATTENTION_SHAPES.get(
        arch, (0, 0, 0, 1024))[3],) * 2


@pytest.mark.parametrize("arch,m", list(kb.RANK_SSD_SHAPES))
def test_rank_ssd_shapes_are_a_ranks(arch, m):
    """``kernel_bench.RANK_SSD_SHAPES`` are one rank's scan: its heads of
    every batch row (chip_smoke's mamba2 batch 8, hymba batch 4), one
    group of them a row, B/C views of the gathered conv output."""
    cfg = get_config(arch)
    shape = kb.RANK_SSD_SHAPES[(arch, m)]
    nh = cfg.ssm_nheads
    n = nh // m if nh % m == 0 else nh
    batch = 8 if arch == "mamba2-130m" else 4
    assert shape == {"BH": batch * n, "S": 1024 if batch == 8 else 1536,
                     "P": cfg.ssm_headdim, "N": cfg.ssm_state,
                     "r": n // cfg.ssm_ngroups, "xbc": True,
                     "width": cfg.conv_dim}
