"""MappingPlan subsystem: durable search results shared across the stack.

The same Eq. 1-7 cost model that drives offline map-space search also
picks Pallas tile shapes at trace time and sizes serving-engine kernels —
but a search result that lives in a per-process ``lru_cache`` is re-solved
by every process that needs it.  This module promotes a solved mapping to
a first-class, **JSON-serializable artifact** (the DFModel treatment of
mappings as persisted design points) so the loop closes:

    benchmarks/paper_tables sweep ──┐
    kernels/autotune trace-time ────┼──>  PlanCache  <── serve/launch warmup
    ServeEngine startup warmup ─────┘      │     │
                                      in-memory  ~/.cache/repro-plans/*.json
                                        dict      (or $REPRO_PLAN_CACHE)

* :class:`MappingPlan` — frozen record of one solved search: the compound
  op signature, the architecture fingerprint, the winning
  :class:`~repro_torch.core.ir.MappingSpec`, the predicted latency / energy /
  capacity headroom, and the engine version that produced it.
* :class:`PlanCache` — two-level cache: an in-memory dict in front of an
  atomic-write JSON store (one file per plan).  Keys are
  ``(arch_sig, op_sig, engine_version, search-kw fingerprint)``: the full
  :meth:`~repro_torch.core.hardware.Arch.signature` and compound-op signature
  (never names alone), the :data:`ENGINE_VERSION` (bump it when the cost
  model or search semantics change and every stored plan self-invalidates)
  and a fingerprint of the search kwargs (two searches over the same
  workload with different objectives or candidate lists are different
  plans).
* :meth:`PlanCache.resolve` — hit or solve-and-persist through the shared
  :func:`repro_torch.core.search.search` engine; :meth:`PlanCache.warmup` fans
  all anticipated shapes through :func:`repro_torch.core.search.search_many`
  (``executor='auto'``) in one sweep.
* :meth:`PlanCache.export_bundle` / :meth:`PlanCache.import_bundle` —
  single-file plan bundles: a benchmark host exports its sweep, a serving
  host imports it and never solves at startup.

Durability contract (see :mod:`repro_torch.core.planstore` for the storage
engine): the disk layer is a degradation ladder — a SQLite WAL store
with LRU/age eviction, provenance and busy-retry, falling back to the
legacy atomic-write JSON directory (auto-migrated into SQLite on first
open) and finally to memory-only.  Concurrent writers race benignly
(last writer wins, both wrote the same solution); readers never observe
partial plans.  A corrupted or stale-version record is treated as a
miss — warn, quarantine, re-solve, overwrite.  Any unrecoverable store
fault demotes the cache down the ladder with **one** warning per cause
instead of failing (or spamming) the caller.

Port-local copy of ``repro/core/plan.py`` (the port imports nothing of
the JAX package); ``tests/test_torch_core.py`` and
``tests/test_torch_plan.py`` hold it to the original.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import secrets
import threading
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from . import planstore
from .batcheval import co_signature
from .hardware import Arch
from .ir import MappingSpec
from .planstore import PlanStore
from .search import SearchResult, search, search_many
from .workload import CompoundOp

__all__ = ["ENGINE_VERSION", "MappingPlan", "PlanCache", "get_plan_cache",
           "arch_fingerprint", "op_fingerprint", "kw_fingerprint",
           "DEFAULT_CACHE_DIR"]

# Version of the (cost model + search) engine whose predictions a stored
# plan embodies.  Bump on any change that can alter a chosen mapping or
# its predicted numbers: every persisted plan whose version mismatches is
# ignored and re-solved.
# v6: MappingSpec/plans carry the compute–collective ``overlap`` axis.
ENGINE_VERSION = 6

DEFAULT_CACHE_DIR = "~/.cache/repro-plans"
_ENV_VAR = "REPRO_PLAN_CACHE"


# ------------------------------------------------------------ fingerprints


def _hex(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


def arch_fingerprint(arch: Arch) -> str:
    """Stable hex fingerprint of the *full* architecture parameter
    signature (:meth:`Arch.signature`), never the name alone.  Memoized
    on the (frozen) instance — this sits on the per-call key path of
    every plan lookup."""
    fp = arch.__dict__.get("_plan_fp_memo")
    if fp is None:
        fp = _hex(arch.signature())
        object.__setattr__(arch, "_plan_fp_memo", fp)
    return fp


def op_fingerprint(co: CompoundOp) -> str:
    """Stable hex fingerprint of the compound-op signature (name, dims,
    tensor layouts).  Memoized on the instance: a CompoundOp is built
    once and treated as immutable by the whole engine."""
    fp = getattr(co, "_plan_fp_memo", None)
    if fp is None:
        fp = _hex(co_signature(co))
        co._plan_fp_memo = fp
    return fp


# Sequence-value fingerprints (candidate_list is a sequence of
# MappingSpecs whose repr costs tens of microseconds) memoized by object
# identity — the strong reference in the table keeps the id from being
# recycled.  Only **tuples** are memoized: a caller-supplied list can be
# mutated in place after its first lookup, which would silently serve a
# stale plan, so lists are re-fingerprinted every time (the autotuner
# passes tuples, so its hot path still hits the memo).
_SEQ_FP_MEMO: Dict[int, Tuple[object, str]] = {}


def _seq_fp(v) -> str:
    if not isinstance(v, tuple):
        return _hex(tuple(v))
    hit = _SEQ_FP_MEMO.get(id(v))
    if hit is not None and hit[0] is v:
        return hit[1]
    fp = _hex(v)
    if len(_SEQ_FP_MEMO) > 4096:
        _SEQ_FP_MEMO.clear()
    _SEQ_FP_MEMO[id(v)] = (v, fp)
    return fp


def kw_fingerprint(search_kw: Dict) -> str:
    """Stable hex fingerprint of a search-kwargs dict.  MappingSpec lists
    (``candidate_list``) repr deterministically; kwargs are sorted by
    name so argument order never splits the key space."""
    items = []
    for k in sorted(search_kw):
        v = search_kw[k]
        if isinstance(v, (list, tuple)):
            v = ("seq", _seq_fp(v))
        items.append((k, v))
    return _hex(tuple(items))


# ------------------------------------------------------------------- plan


def _spec_to_json(spec: MappingSpec) -> Dict:
    d = dataclasses.asdict(spec)
    d["loop_order_gb"] = list(d["loop_order_gb"])
    return d


def _spec_from_json(d: Dict) -> MappingSpec:
    kw = dict(d)
    kw["loop_order_gb"] = tuple(kw["loop_order_gb"])
    return MappingSpec(**kw)


@dataclass(frozen=True)
class MappingPlan:
    """One solved mapping, frozen and JSON-roundtrippable.

    ``op_name``/``op_dims`` are the human-readable identity;
    ``op_sig``/``arch_sig`` are the exact cache-key fingerprints (the
    full signatures hashed), so a plan can be matched back to its
    workload/arch without re-deriving anything.
    """

    op_name: str
    op_dims: Tuple[Tuple[str, int], ...]
    op_sig: str                      # op_fingerprint(co)
    arch_name: str
    arch_sig: str                    # arch_fingerprint(arch)
    spec: MappingSpec
    latency_s: float
    energy_pj: float
    headroom: float
    headroom_levels: Tuple[Tuple[str, float], ...]
    engine_version: int
    search_mode: str                 # 'exhaustive'|'randomized'|'candidates'
    evaluated: int
    # mode='candidates': winner's index in the caller's candidate_list
    best_index: Optional[int] = None

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d["op_dims"] = [list(p) for p in self.op_dims]
        d["headroom_levels"] = [list(p) for p in self.headroom_levels]
        d["spec"] = _spec_to_json(self.spec)
        return d

    @classmethod
    def from_json(cls, d: Dict) -> "MappingPlan":
        kw = dict(d)
        kw["op_dims"] = tuple((str(k), int(v)) for k, v in d["op_dims"])
        kw["headroom_levels"] = tuple(
            (str(k), float(v)) for k, v in d["headroom_levels"])
        kw["spec"] = _spec_from_json(d["spec"])
        return cls(**kw)

    @classmethod
    def from_search(cls, co: CompoundOp, arch: Arch,
                    result: SearchResult) -> "MappingPlan":
        best = result.best
        return cls(
            op_name=co.name,
            op_dims=tuple(sorted(co.dim_sizes.items())),
            op_sig=op_fingerprint(co),
            arch_name=arch.name,
            arch_sig=arch_fingerprint(arch),
            spec=best.spec,
            latency_s=float(best.latency),
            energy_pj=float(best.energy_pj),
            headroom=float(best.headroom),
            headroom_levels=tuple(sorted(
                (k, float(v)) for k, v in best.headroom_levels.items())),
            engine_version=ENGINE_VERSION,
            search_mode=result.mode,
            evaluated=result.evaluated,
            best_index=result.best_index)


# ------------------------------------------------------------------ cache


PlanKey = Tuple[str, str, int, str]     # (arch_sig, op_sig, version, kw_sig)


class PlanCache:
    """Two-level plan cache: in-memory dict over a durable
    :class:`~repro_torch.core.planstore.PlanStore` (``$REPRO_PLAN_CACHE`` or
    ``~/.cache/repro-plans``; SQLite WAL with JSON-dir and memory-only
    fallbacks).

    Thread-safe; process-safe through the store's write atomicity
    (concurrent resolvers of the same key each solve once and the last
    writer wins — both wrote the same plan).  ``stats`` counts
    memory/disk hits, misses (solves), stores and corrupt records
    tolerated; :meth:`store_stats` adds the store's own provenance view
    (row counts, bytes, per-version/per-sweep breakdowns).
    """

    def __init__(self, root: Optional[str] = None, *,
                 store: Optional[PlanStore] = None,
                 backend: Optional[str] = None,
                 max_bytes: Optional[int] = None,
                 max_plans: Optional[int] = None,
                 max_age_s: Optional[float] = None):
        if root is None:
            root = os.environ.get(_ENV_VAR) or DEFAULT_CACHE_DIR
        self.root = Path(root).expanduser()
        self.store = store if store is not None else PlanStore(
            self.root, backend=backend, max_bytes=max_bytes,
            max_plans=max_plans, max_age_s=max_age_s)
        self._mem: Dict[PlanKey, MappingPlan] = {}
        self._lock = threading.Lock()
        self.stats = {"hits_mem": 0, "hits_disk": 0, "misses": 0,
                      "stores": 0, "corrupt": 0}

    # ------------------------------------------------------------- keying

    def key(self, co: CompoundOp, arch: Arch, search_kw: Dict) -> PlanKey:
        return (arch_fingerprint(arch), op_fingerprint(co), ENGINE_VERSION,
                kw_fingerprint(search_kw))

    # --------------------------------------------------------------- disk

    def _load_disk(self, key: PlanKey) -> Optional[MappingPlan]:
        raw = self.store.get(key)
        if raw is None:
            return None
        try:
            d = json.loads(raw)
            plan = MappingPlan.from_json(d["plan"])
            if tuple(d["key"]) != key:          # hash collision / tamper
                raise ValueError("key mismatch")
            if plan.engine_version != ENGINE_VERSION:
                raise ValueError("engine version mismatch")
            return plan
        except (ValueError, KeyError, TypeError) as e:
            self.stats["corrupt"] += 1
            quarantined = self.store.discard(key)
            warnings.warn(
                f"PlanCache: ignoring corrupted stored plan {key} ({e!r}); "
                + ("quarantined; " if quarantined else "") + "re-solving",
                RuntimeWarning, stacklevel=3)
            return None

    def _store_disk(self, key: PlanKey, plan: MappingPlan,
                    sweep_id: Optional[str] = None) -> None:
        payload = json.dumps({"key": list(key), "plan": plan.to_json()},
                             indent=1)
        if self.store.put(key, payload, sweep_id=sweep_id):
            self.stats["stores"] += 1

    # -------------------------------------------------- store maintenance

    def gc(self, **kw) -> Dict[str, int]:
        """Run the store's garbage collection: age expiry plus LRU
        eviction down to the (optionally overridden) size bounds, then
        vacuum.  Returns ``{'expired': n, 'evicted': n}``."""
        return self.store.gc(**kw)

    def invalidate(self, *, engine_version: Optional[int] = None,
                   sweep_id: Optional[str] = None,
                   older_than_s: Optional[float] = None) -> int:
        """Delete exactly the stored plans matching the provenance
        filters (e.g. ``engine_version=4`` removes a stale generation
        after a cost-model bump) and drop matching in-memory entries.
        Returns the number of store rows removed."""
        n = self.store.invalidate(engine_version=engine_version,
                                  sweep_id=sweep_id,
                                  older_than_s=older_than_s)
        with self._lock:
            if engine_version is not None and sweep_id is None \
                    and older_than_s is None:
                drop = [k for k in self._mem if k[2] == engine_version]
            else:
                # memory entries carry no sweep/created provenance: be
                # conservative and drop everything (they re-load cheaply)
                drop = list(self._mem)
            for k in drop:
                del self._mem[k]
        return n

    def store_stats(self) -> Dict:
        """Cache counters plus the store's provenance/size view."""
        with self._lock:
            out = dict(self.stats, mem_plans=len(self._mem))
        out["store"] = self.store.stats()
        return out

    # ------------------------------------------------------------- lookup

    def lookup(self, co: CompoundOp, arch: Arch,
               **search_kw) -> Optional[MappingPlan]:
        """Memory-then-disk lookup; never solves."""
        key = self.key(co, arch, search_kw)
        with self._lock:
            plan = self._mem.get(key)
            if plan is not None:
                self.stats["hits_mem"] += 1
                return plan
        plan = self._load_disk(key)
        if plan is not None:
            with self._lock:
                self._mem[key] = plan
                self.stats["hits_disk"] += 1
        return plan

    def resolve(self, co: CompoundOp, arch: Arch,
                **search_kw) -> MappingPlan:
        """Return the cached plan for ``(co, arch, search_kw)`` or solve
        it through the shared :func:`repro_torch.core.search.search` engine and
        persist the result."""
        plan = self.lookup(co, arch, **search_kw)
        if plan is not None:
            return plan
        result = search(co, arch, **search_kw)
        return self._admit(co, arch, search_kw, result)

    def _admit(self, co: CompoundOp, arch: Arch, search_kw: Dict,
               result: SearchResult,
               sweep_id: Optional[str] = None) -> MappingPlan:
        key = self.key(co, arch, search_kw)
        plan = MappingPlan.from_search(co, arch, result)
        with self._lock:
            self._mem[key] = plan
            self.stats["misses"] += 1
        self._store_disk(key, plan, sweep_id=sweep_id)
        return plan

    # ------------------------------------------------------------- warmup

    def warmup(self, jobs: Sequence, *,
               executor: str = "auto",
               max_workers: Optional[int] = None,
               sweep_id: Optional[str] = None) -> Dict[str, int]:
        """Pre-solve many plans in one sweep.  Each job is ``(co, arch)``,
        ``(co, arch, kwargs)`` or a ``co``/``arch`` dict (the
        :func:`repro_torch.core.search.search_many` job forms).  Jobs already
        planned are skipped; the misses fan out through ``search_many``
        (size-aware process-pool chunking under ``executor='auto'``) and
        every result is persisted with ``sweep_id`` provenance (an
        auto-generated token when not given, so the whole warmup is
        queryable/invalidatable as one generation).  Returns counts."""
        norm: List[Tuple[CompoundOp, Arch, Dict]] = []
        for job in jobs:
            if isinstance(job, dict):
                kw = dict(job)
                norm.append((kw.pop("co"), kw.pop("arch"), kw))
            elif len(job) == 2:
                norm.append((job[0], job[1], {}))
            else:
                norm.append((job[0], job[1], dict(job[2])))
        misses, seen = [], set()
        for co, arch, kw in norm:
            key = self.key(co, arch, kw)
            # dedupe by plan key: a repeated (co, arch, kwargs) cell in
            # one sweep would otherwise be solved once per copy
            if key in seen or self.lookup(co, arch, **kw) is not None:
                continue
            seen.add(key)
            misses.append((co, arch, kw))
        if misses:
            sid = planstore.current_sweep_id(sweep_id) \
                or f"warmup-{secrets.token_hex(6)}"
            results = search_many(misses, executor=executor,
                                  max_workers=max_workers)
            for (co, arch, kw), result in zip(misses, results):
                self._admit(co, arch, kw, result, sweep_id=sid)
        return {"requested": len(norm), "hits": len(norm) - len(misses),
                "solved": len(misses)}

    # ------------------------------------------------------------ bundles

    def export_bundle(self, path) -> int:
        """Write every plan this cache can see — the in-memory layer
        *plus* everything in the durable store (current engine version
        only) — to a single JSON bundle file, for shipping a benchmark
        host's sweep to a serving fleet.  Returns the number of plans
        exported."""
        import tempfile

        with self._lock:
            plans = {k: p.to_json() for k, p in self._mem.items()}
        for key in self.store.keys():
            if key in plans or key[2] != ENGINE_VERSION:
                continue
            raw = self.store.get(key)
            if raw is None:
                continue
            try:
                d = json.loads(raw)
                if tuple(d["key"]) != key:
                    continue
                plans[key] = d["plan"]
            except (ValueError, KeyError, TypeError):
                continue                # corrupt rows never ship
        entries = [{"key": list(k), "plan": p} for k, p in plans.items()]
        bundle = {"schema": "repro/plan-bundle/v1",
                  "engine_version": ENGINE_VERSION,
                  "plans": entries}
        path = Path(path)
        fd, tmp = tempfile.mkstemp(dir=str(path.parent or Path(".")),
                                   prefix=path.name + ".", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(bundle, f, indent=1)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return len(entries)

    def import_bundle(self, path) -> int:
        """Load a plan bundle into this cache (memory + disk store).
        Entries whose engine version mismatches are skipped.  Returns the
        number of plans imported."""
        with open(path) as f:
            bundle = json.load(f)
        if bundle.get("schema") != "repro/plan-bundle/v1":
            raise ValueError(f"not a plan bundle: {path}")
        n = 0
        for entry in bundle["plans"]:
            try:
                plan = MappingPlan.from_json(entry["plan"])
                key = tuple(entry["key"])
            except (KeyError, TypeError, ValueError) as e:
                self.stats["corrupt"] += 1
                warnings.warn(
                    f"PlanCache: skipping malformed bundle entry ({e!r})",
                    RuntimeWarning, stacklevel=2)
                continue
            if plan.engine_version != ENGINE_VERSION or len(key) != 4:
                continue
            with self._lock:
                self._mem[key] = plan
            self._store_disk(key, plan, sweep_id="bundle-import")
            n += 1
        return n


# ------------------------------------------------------------- singleton

_CACHES: Dict[str, PlanCache] = {}
_CACHES_LOCK = threading.Lock()


def get_plan_cache() -> PlanCache:
    """The process-wide :class:`PlanCache` for the current store
    directory.  ``$REPRO_PLAN_CACHE`` is re-read on every call, so
    pointing it somewhere else (tests, CI sandboxes) takes effect
    immediately — each distinct directory gets its own instance with its
    own in-memory layer."""
    root = os.environ.get(_ENV_VAR) or DEFAULT_CACHE_DIR
    root = str(Path(root).expanduser())
    with _CACHES_LOCK:
        cache = _CACHES.get(root)
        if cache is None:
            cache = PlanCache(root)
            _CACHES[root] = cache
        return cache
