"""The port's plan path: ``repro_torch.core.plan`` (PlanCache over the
durable store), ``repro_torch.kernels.autotune`` on the ``h100`` preset,
the serve engine's warmup and the prefill's plan-chosen SSD chunk.

The PlanCache checks are tests/test_plan.py's, run against the port, plus
parity with the JAX package: each package resolves through its own store
(``PlanCache(tmp_path / "jax")`` and ``PlanCache(tmp_path / "torch")``),
so neither can answer from a plan the other stored.
"""
import json
import sqlite3
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import hardware as jhw
from repro.core import plan as jplan
from repro.core import workload as jwl
from repro.serve import engine as jengine
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import hardware as thw
from repro_torch.core import plan as plan_mod
from repro_torch.core.hardware import edge, h100
from repro_torch.core.ir import MappingSpec, evaluate_mapping
from repro_torch.core.plan import MappingPlan, PlanCache, get_plan_cache
from repro_torch.core.workload import gemm_softmax, ssd_chunk
from repro_torch.kernels import autotune
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm_epilogue as ge
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd
from repro_torch.models import ssm as tssm
from repro_torch.models.model import Model
from repro_torch.serve.engine import ServeEngine

CO = lambda: gemm_softmax(256, 1024, 64)  # noqa: E731


def _mk(tmp_path, name="plans"):
    return PlanCache(str(tmp_path / name))


# ------------------------------------------------------------- roundtrip


def test_plan_json_roundtrip(tmp_path):
    cache = _mk(tmp_path)
    plan = cache.resolve(CO(), edge())
    blob = json.dumps(plan.to_json())
    assert MappingPlan.from_json(json.loads(blob)) == plan


def test_plan_roundtrip_candidates_mode(tmp_path):
    cache = _mk(tmp_path)
    cl = [MappingSpec(variant="fused_dist", m_tiles=m) for m in (1, 2, 4)]
    plan = cache.resolve(CO(), edge(), candidate_list=cl)
    assert plan.search_mode == "candidates"
    assert plan.best_index is not None
    rt = MappingPlan.from_json(json.loads(json.dumps(plan.to_json())))
    assert rt == plan and rt.spec == cl[plan.best_index]


@pytest.mark.parametrize("preset", ["edge", "cloud", "tileflow_like"])
def test_plan_equals_the_jax_packages(tmp_path, preset):
    """The same workload on the same preset, each package through its own
    store: the stored plans are the same JSON, key fingerprints, spec,
    latency and energy included."""
    jc = jplan.PlanCache(str(tmp_path / "jax"))
    tc = PlanCache(str(tmp_path / "torch"))
    jp = jc.resolve(jwl.gemm_softmax(256, 1024, 64), getattr(jhw, preset)())
    tp = tc.resolve(CO(), getattr(thw, preset)())
    assert jc.stats["misses"] == tc.stats["misses"] == 1
    assert jp.to_json() == tp.to_json()
    assert plan_mod.ENGINE_VERSION == jplan.ENGINE_VERSION


# ----------------------------------------------------------- hit / miss


def test_memory_and_disk_hits(tmp_path):
    cache = _mk(tmp_path)
    co, arch = CO(), edge()
    p1 = cache.resolve(co, arch)
    assert cache.stats["misses"] == 1 and cache.stats["stores"] == 1
    p2 = cache.resolve(co, arch)
    assert p2 is p1 and cache.stats["hits_mem"] == 1
    # a fresh instance over the same directory = a second process
    other = PlanCache(str(tmp_path / "plans"))
    p3 = other.resolve(co, arch)
    assert p3 == p1
    assert other.stats["hits_disk"] == 1 and other.stats["misses"] == 0


def test_distinct_search_kwargs_are_distinct_plans(tmp_path):
    cache = _mk(tmp_path)
    co, arch = CO(), edge()
    lat = cache.resolve(co, arch, objective="latency")
    en = cache.resolve(co, arch, objective="energy")
    assert cache.stats["misses"] == 2
    assert en.energy_pj <= lat.energy_pj


def test_version_bump_invalidates(tmp_path, monkeypatch):
    cache = _mk(tmp_path)
    co, arch = CO(), edge()
    cache.resolve(co, arch)
    monkeypatch.setattr(plan_mod, "ENGINE_VERSION",
                        plan_mod.ENGINE_VERSION + 1)
    fresh = PlanCache(str(tmp_path / "plans"))
    assert fresh.lookup(co, arch) is None          # old plan invisible
    p2 = fresh.resolve(co, arch)                   # re-solves + persists
    assert fresh.stats["misses"] == 1
    assert p2.engine_version == plan_mod.ENGINE_VERSION


def test_resolve_counts_solves_once_across_calls(tmp_path, monkeypatch):
    calls = []
    real = plan_mod.search

    def counting(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(plan_mod, "search", counting)
    cache = _mk(tmp_path)
    for _ in range(5):
        cache.resolve(CO(), edge())
    assert len(calls) == 1


def test_get_plan_cache_follows_env(tmp_path, monkeypatch):
    a, b = tmp_path / "a", tmp_path / "b"
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(a))
    ca = get_plan_cache()
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(b))
    cb = get_plan_cache()
    assert ca is not cb and ca.root == a and cb.root == b
    assert get_plan_cache() is cb


# ------------------------------------------------------------ durability


def _rewrite_payload(root, fn):
    """Tamper with every stored payload through a direct connection (the
    moral equivalent of another process corrupting the store)."""
    db = sqlite3.connect(str(root / "plans.sqlite"))
    try:
        for rowid, payload in db.execute(
                "SELECT rowid, payload FROM plans").fetchall():
            db.execute("UPDATE plans SET payload = ? WHERE rowid = ?",
                       (fn(payload), rowid))
        db.commit()
    finally:
        db.close()


def test_corrupted_record_warns_quarantines_and_resolves(tmp_path):
    cache = _mk(tmp_path)
    co, arch = CO(), edge()
    p1 = cache.resolve(co, arch)
    cache.store.close()
    _rewrite_payload(tmp_path / "plans", lambda _p: "{ not json !")
    fresh = PlanCache(str(tmp_path / "plans"))
    with pytest.warns(RuntimeWarning, match="corrupted stored plan"):
        p2 = fresh.resolve(co, arch)
    assert p2 == p1 and fresh.stats["corrupt"] == 1
    third = PlanCache(str(tmp_path / "plans"))
    assert third.lookup(co, arch) == p1 and third.stats["corrupt"] == 0


def test_wrong_key_payload_treated_as_miss(tmp_path):
    cache = _mk(tmp_path)
    co, arch = CO(), edge()
    p1 = cache.resolve(co, arch)
    cache.store.close()

    def forge(payload):
        blob = json.loads(payload)
        blob["key"][0] = "0" * 16                   # forged arch signature
        return json.dumps(blob)

    _rewrite_payload(tmp_path / "plans", forge)
    fresh = PlanCache(str(tmp_path / "plans"))
    with pytest.warns(RuntimeWarning, match="corrupted stored plan"):
        assert fresh.resolve(co, arch) == p1


def test_unwritable_store_degrades_to_memory(tmp_path):
    blocker = tmp_path / "blocked"
    blocker.write_text("a file where the store dir should go")
    cache = PlanCache(str(blocker / "plans"))
    with pytest.warns(RuntimeWarning, match="memory-only"):
        plan = cache.resolve(CO(), edge())
    assert plan.latency_s > 0
    assert cache.resolve(CO(), edge()) is plan     # memory layer still works
    assert cache.store_stats()["store"]["backend"] == "memory"


def test_concurrent_writers_atomic(tmp_path):
    """Many writers racing on the same key (separate store connections,
    WAL mode, threads): every resolve returns the same plan, the final
    database passes an integrity check, and there is no write litter."""
    co, arch = CO(), edge()
    results, errors, caches = [], [], []

    def worker():
        try:
            c = PlanCache(str(tmp_path / "plans"))
            caches.append(c)
            results.append(c.resolve(co, arch))
        except BaseException as e:   # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(results) == 8 and all(r == results[0] for r in results)
    for c in caches:
        c.store.close()
    fresh = PlanCache(str(tmp_path / "plans"))
    assert fresh.lookup(co, arch) == results[0]
    fresh.store.close()
    db = sqlite3.connect(str(tmp_path / "plans" / "plans.sqlite"))
    try:
        assert db.execute("PRAGMA integrity_check").fetchone()[0] == "ok"
    finally:
        db.close()
    assert not list((tmp_path / "plans").glob("*.tmp"))


# --------------------------------------------------------------- bundles


def test_bundle_export_import(tmp_path):
    src = _mk(tmp_path, "src")
    co, arch = CO(), edge()
    plan = src.resolve(co, arch)
    bundle = tmp_path / "bundle.json"
    assert src.export_bundle(bundle) == 1
    dst = _mk(tmp_path, "dst")
    assert dst.import_bundle(bundle) == 1
    assert dst.lookup(co, arch) == plan
    assert PlanCache(str(tmp_path / "dst")).lookup(co, arch) == plan


def test_bundle_schema_is_the_jax_packages(tmp_path):
    """A bundle the JAX package exports imports into the port's store (the
    same schema string and keys) and answers the same lookup."""
    jsrc = jplan.PlanCache(str(tmp_path / "jax"))
    jp = jsrc.resolve(jwl.gemm_softmax(256, 1024, 64), jhw.edge())
    bundle = tmp_path / "bundle.json"
    assert jsrc.export_bundle(bundle) == 1
    assert json.loads(bundle.read_text())["schema"] == "repro/plan-bundle/v1"
    dst = _mk(tmp_path, "torch")
    assert dst.import_bundle(bundle) == 1
    assert dst.lookup(CO(), edge()).to_json() == jp.to_json()


def test_bundle_version_mismatch_skipped(tmp_path, monkeypatch):
    src = _mk(tmp_path, "src")
    src.resolve(CO(), edge())
    bundle = tmp_path / "bundle.json"
    src.export_bundle(bundle)
    monkeypatch.setattr(plan_mod, "ENGINE_VERSION",
                        plan_mod.ENGINE_VERSION + 1)
    assert _mk(tmp_path, "dst").import_bundle(bundle) == 0


# ------------------------------------------------------------ autotune


def test_autotune_has_no_lru_cache():
    """Result caching lives in the PlanCache alone."""
    import inspect
    src = inspect.getsource(autotune)
    assert "lru_cache" not in src and "get_plan_cache" in src


def test_warm_disk_cache_answers_all_paper_kernel_shapes_without_search(
        tmp_path, monkeypatch):
    """After one process warms the disk store, a second (fresh PlanCache
    instances, empty in-memory layer) answers every paper-table kernel
    shape without invoking search()."""
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans"))
    shapes = autotune.PAPER_KERNEL_SHAPES
    calls = (("attention_blocks", autotune.attention_blocks),
             ("gemm_epilogue_blocks", autotune.gemm_epilogue_blocks),
             ("ssd_chunk_len", autotune.ssd_chunk_len))
    warm = {(k, s): fn(*s) for k, fn in calls for s in shapes[k]}
    with plan_mod._CACHES_LOCK:
        plan_mod._CACHES.clear()

    def boom(*a, **kw):                            # pragma: no cover
        raise AssertionError("search() ran despite a warm disk cache")

    monkeypatch.setattr(plan_mod, "search", boom)
    monkeypatch.setattr(plan_mod, "search_many", boom)
    assert {(k, s): fn(*s) for k, fn in calls for s in shapes[k]} == warm


@pytest.mark.parametrize("shape", [(1024, 1024, 128), (1, 2048, 128),
                                   (1024, 1024, 64), (100, 300, 32),
                                   (1, 1, 16)])
def test_attention_blocks_is_a_tiling_the_kernel_takes(shape, tmp_path,
                                                       monkeypatch):
    """The plan's (block_q, block_k) is the bf16 kernel's own tile at that
    shape (``flash_attention.tiling``), and the kernel's checks accept q/k/v
    of the shape."""
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans"))
    sq, skv, d = shape
    t = fa.tiling(1, 2, 1, sq, skv, d, torch.bfloat16)
    assert autotune.attention_blocks(*shape) == (t.q_rows * t.consumers,
                                                 t.keys)
    q = torch.zeros(1, 2, sq, d, dtype=torch.bfloat16)
    kv = torch.zeros(1, 1, skv, d, dtype=torch.bfloat16)
    fa._check(q, kv, kv, None)
    # a head dim the kernel refuses has no candidate
    assert autotune.attention_plan_job(sq, skv, 24) is None


@pytest.mark.parametrize("shape", [(512, 4096, 128), (4096, 4096, 4096),
                                   (4096, 16384, 4096), (200, 1000, 96),
                                   (64, 8200, 64)])
def test_gemm_epilogue_blocks_is_a_tiling_the_kernel_takes(shape, tmp_path,
                                                           monkeypatch):
    """The plan's tiling is one of ``gemm_epilogue.tilings``, which
    ``gemm_epilogue.check`` takes when named and returns by default;
    (block_m, block_n) are its rows and slice columns."""
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans"))
    m, n, k = shape
    t = autotune.gemm_epilogue_tiling(m, n, k)
    assert t in ge.tilings(n, torch.bfloat16)
    a = torch.zeros(m, k, dtype=torch.bfloat16)
    b = torch.zeros(k, n, dtype=torch.bfloat16)
    assert ge.check(a, b, tiling=t) == t == ge.check(a, b)
    assert autotune.gemm_epilogue_blocks(m, n, k) == (t.rows, t.columns)
    assert autotune.gemm_epilogue_plan_job(8, 16392, 8) == []
    assert autotune.gemm_epilogue_tiling(8, 16392, 8) is None


def _ssd_chunk_len_ref(s, p, n):
    """The choice the plan must make, from the per-spec path alone: the
    candidate chunk with the least ceil(S / c) x latency on h100."""
    best = None
    for c in autotune.SSD_CHUNKS:
        if c > max(s, autotune.SSD_CHUNKS[0]):
            continue
        r = evaluate_mapping(ssd_chunk(S=s, H=1, P=p, Dst=n, C=c), h100(),
                             MappingSpec(variant="fused_dist", m_tiles=1))
        lat = -(-max(s, 1) // c) * r.latency
        if best is None or lat < best[0]:
            best = (lat, c)
    return best[1]


@pytest.mark.parametrize("shape", [(1024, 64, 128), (4096, 64, 128),
                                   (128, 32, 64), (24, 16, 16),
                                   (100, 16, 32)])
def test_ssd_chunk_len_is_the_models_argmin_and_a_chunk_the_kernel_takes(
        shape, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans"))
    s, p, n = shape
    c = autotune.ssd_chunk_len(*shape)
    assert c == _ssd_chunk_len_ref(*shape)
    x = torch.zeros(2, s, p)
    B = torch.zeros(1, s, n)
    assert ssd._check(x, torch.zeros(2, s), B, B, min(c, s)) == 2
    # a head dim the kernel refuses: no plan, the kernel's chunk
    assert autotune.ssd_plan_jobs(s, 48, n) == []
    assert autotune.ssd_chunk_len(s, 48, n) == ssd.CHUNK


# ------------------------------------------------------- the serve engine


def _jax_plan_shapes(arch, batch, prompt_len, cache_len):
    """The JAX engine's ``plan_shapes`` on the JAX smoke config (it reads
    only the config and the engine's sizes)."""
    from repro.configs import get_smoke_config as jget
    eng = SimpleNamespace(model=SimpleNamespace(cfg=jget(arch)), B=batch,
                          prompt_len=prompt_len, cache_len=cache_len)
    return jengine.ServeEngine.plan_shapes(eng)


@pytest.mark.parametrize("arch", ["glm4-9b", "mamba2-130m"])
def test_plan_shapes_equal_the_jax_engines(arch):
    model = Model(get_smoke_config(arch))
    params = model.init(0, device="cpu")
    for batch, prompt, cache in ((2, 16, 48), (8, 1024, 2048)):
        eng = ServeEngine(model, params, batch_size=batch, cache_len=cache,
                          prompt_len=prompt, plan_warmup=False)
        assert "plan_warmup_solved" not in eng.stats
        assert eng.plan_shapes() == _jax_plan_shapes(arch, batch, prompt,
                                                     cache)


@pytest.mark.parametrize("arch", ["glm4-9b", "mamba2-130m"])
def test_serve_engine_warmup_populates_cache(arch, tmp_path, monkeypatch):
    """A cold engine solves every plan of its shapes into a fresh store;
    a second engine over that store only hits."""
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans"))
    model = Model(get_smoke_config(arch))
    params = model.init(0, device="cpu")
    eng = ServeEngine(model, params, batch_size=2, cache_len=200,
                      prompt_len=64)
    jobs = autotune.plan_jobs(eng.plan_shapes())
    assert eng.stats["plan_warmup_solved"] == len(jobs) > 0
    assert eng.stats["plan_warmup_hits"] == 0
    assert eng.stats["plan_warmup_s"] >= 0
    assert (tmp_path / "plans" / "plans.sqlite").exists()
    cache = get_plan_cache()
    assert cache.store_stats()["store"]["plans"] == len(jobs)
    for co, a, kw in jobs:
        assert a.name == "h100" and cache.lookup(co, a, **kw) is not None
    with plan_mod._CACHES_LOCK:             # a second process
        plan_mod._CACHES.clear()
    eng2 = ServeEngine(model, params, batch_size=2, cache_len=200,
                       prompt_len=64)
    assert eng2.stats["plan_warmup_solved"] == 0
    assert eng2.stats["plan_warmup_hits"] == len(jobs)


def test_prefill_runs_the_scan_at_the_plans_chunk(monkeypatch):
    """The mamba2 prefill asks the plan once a call and runs every layer's
    scan at its chunk."""
    cfg = get_smoke_config("mamba2-130m").with_(use_kernels=True)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    asked, chunks = [], []
    real_plan, real_ssd = tssm.plan_chunk, tops.ssd

    def plan_spy(c, S):
        asked.append(S)
        return real_plan(c, S)

    def ssd_spy(xdt, dA, B, C, **kw):
        chunks.append(kw["chunk"])
        return real_ssd(xdt, dA, B, C, **kw)

    monkeypatch.setattr(tssm, "plan_chunk", plan_spy)
    monkeypatch.setattr(tops, "ssd", ssd_spy)
    toks = torch.from_numpy(np.arange(2 * 40).reshape(2, 40)
                            % cfg.vocab_size).long()
    model.prefill(params, {"tokens": toks}, 48)
    want = autotune.ssd_chunk_len(40, cfg.ssm_headdim, cfg.ssm_state)
    assert asked == [40] and chunks == [want] * cfg.n_layers
    model.logits(params, {"tokens": toks})
    assert asked == [40, 40] and chunks == [want] * (2 * cfg.n_layers)


def test_serve_cli_plan_flags(tmp_path, capsys, monkeypatch):
    """The serve CLI's plan flags and the plan fields of its JSON line:
    a cold store solves, a second run over it only hits, a bundle
    exported from it imports, and --plan-gc reports its counts."""
    from repro_torch.launch import serve
    # --plan-cache sets the variable; the fixture puts it back after
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "unused"))
    base = ["--arch", "mamba2-130m", "--smoke", "--device", "cpu",
            "--requests", "2", "--batch", "2", "--prompt-len", "16",
            "--cache-len", "24", "--max-new", "2"]
    cold = serve.main(base + ["--plan-cache", str(tmp_path / "a")])
    assert cold["plan_warmup_solved"] > 0 and cold["plan_warmup_hits"] == 0
    assert cold["plan_store"] == "sqlite"
    assert cold["plan_store_plans"] == cold["plan_warmup_solved"]
    warm = serve.main(base + ["--plan-cache", str(tmp_path / "a"),
                              "--plan-gc"])
    assert warm["plan_warmup_solved"] == 0
    assert warm["plan_warmup_hits"] == cold["plan_warmup_solved"]
    assert set(warm["plan_gc"]) >= {"expired", "evicted"}
    bundle = tmp_path / "bundle.json"
    get_plan_cache().export_bundle(bundle)
    imp = serve.main(base + ["--plan-cache", str(tmp_path / "b"),
                             "--plan-bundle", str(bundle)])
    assert imp["plan_bundle_imported"] == cold["plan_warmup_solved"]
    assert imp["plan_warmup_solved"] == 0
    off = serve.main(base + ["--plan-cache", str(tmp_path / "c"),
                             "--no-plan-warmup"])
    assert off["plan_warmup_solved"] == off["plan_warmup_hits"] == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == off


def test_bench_ssd_times_the_scan_at_a_given_chunk():
    """``kernel_bench.bench_ssd(chunk=)``, which chip_smoke runs at the
    plan's chunk where it is not the kernel's 64: the scan, its plain
    version and the operation count all take that chunk (clipped to S)."""
    from repro_torch.launch import kernel_bench as kb
    gen = torch.Generator().manual_seed(0)
    shape = {"BH": 4, "S": 40, "P": 16, "N": 16, "r": 2, "xbc": True}
    x, dA, B, C = kb.ssd_inputs(gen, shape, torch.bfloat16, "cpu")
    for chunk, used in ((16, 16), (ssd.CHUNK, 40)):
        rec = kb.bench_ssd(x, dA, B, C, chunk=chunk)
        assert rec["shape"]["chunk"] == used
        assert rec["tile"].startswith(f"chunk {used},")
        assert rec["flops"] == kb.ssd_flops(4, 40, 16, 16, used)
        assert rec["max_abs_err"] == 0.0 and rec["ms"] is None
