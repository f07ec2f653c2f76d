"""Durable plan storage engine behind :class:`repro_torch.core.plan.PlanCache`.

PR 5 gave every consumer of the search engine one shared ``PlanCache``;
this module gives that cache a **fleet-grade store**.  The flat
one-JSON-file-per-plan directory worked for a single host but had no
eviction, no GC, and no record of which sweep produced each plan — at
fleet scale (hundreds of serving hosts, thousands of (arch, op) cells,
DFModel-style datacenter provisioning sweeps) the store itself becomes
the reliability bottleneck.

The storage engine is a **degradation ladder** — every rung keeps
``resolve()`` correct, each failure just costs durability:

    SQLite (WAL)  ──open/corrupt failure──►  legacy JSON dir  ──►  memory-only
       │                                         │
       │ write failure (ENOSPC, read-only):      │ write failure:
       └── reads keep working, new plans         └── new plans stay
           stay in memory, ONE warning               in memory, ONE warning

* :class:`PlanStore` — the facade ``PlanCache`` talks to.  It owns the
  ladder: rung selection is lazy (a cache that never touches disk never
  warns), every demotion or write-disable warns **exactly once per
  cause**, and all faults degrade instead of raising to the caller.
* ``_SqliteBackend`` — the primary rung: one ``plans`` table in a WAL
  database (``plans.sqlite`` inside the store root), keyed by the exact
  ``PlanKey`` fingerprints, with

  - *busy handling*: ``PRAGMA busy_timeout`` plus a bounded exponential
    backoff retry loop around every statement, so SQLITE_BUSY storms
    from concurrent writers are absorbed silently;
  - *provenance columns*: ``engine_version`` (part of the key),
    ``sweep_id`` (which warmup sweep produced the plan;
    ``$REPRO_PLAN_SWEEP_ID`` or a per-warmup token), ``created_s`` /
    ``last_hit_s`` timestamps and a ``hits`` counter — so stale plans
    are *queryable* (:meth:`PlanStore.stats`) and *invalidatable*
    (:meth:`PlanStore.invalidate`, e.g. ``engine_version=4`` removes
    exactly the stale generation);
  - *size bounding*: LRU eviction (least-recently-hit first) whenever
    the store exceeds ``max_bytes`` / ``max_plans``, age expiry via
    ``max_age_s``, and ``PRAGMA incremental_vacuum`` so evictions
    actually return disk space;
  - *auto-migration*: on first writable open, any legacy per-plan
    ``*.json`` files in the root are imported into the table (zero lost
    plans) and moved to ``migrated-json/``; unparsable ones are
    quarantined to ``corrupt/`` instead of being re-parsed (and
    re-warned about) by every cold process forever;
  - *corruption recovery*: an unreadable database file is quarantined
    to ``corrupt/`` and recreated — one warning, no crash, plans
    re-solve.
* ``_JsonBackend`` — the legacy flat directory, kept as the fallback
  rung (and the wire format bundles still use): atomic ``os.replace``
  writes, corrupt files quarantined to ``corrupt/``.
* ``_NullBackend`` — memory-only: the store accepts writes and returns
  misses; the in-memory dict inside ``PlanCache`` is the actual cache.

Configuration (constructor kwargs override environment):

======================================  =======================================
``REPRO_PLAN_STORE``                    force a backend: ``sqlite`` | ``json``
                                        | ``memory``
``REPRO_PLAN_STORE_MAX_BYTES``          payload-byte bound before LRU eviction
``REPRO_PLAN_STORE_MAX_PLANS``          row-count bound before LRU eviction
``REPRO_PLAN_STORE_MAX_AGE_S``          age expiry applied by :meth:`gc`
``REPRO_PLAN_SWEEP_ID``                 provenance tag for new plans
======================================  =======================================

The fault matrix in ``tests/test_faults.py`` pins the contract: under
torn writes, ENOSPC, read-only stores, corrupt DB/JSON, SQLITE_BUSY
storms and killed writers, ``resolve()`` still returns plans
bit-identical to a clean-store run, with at most one warning per cause.

Port-local copy of ``repro/core/planstore.py`` (the port imports nothing of
the JAX package); ``tests/test_torch_core.py`` and
``tests/test_torch_plan.py`` hold it to the original.
"""
from __future__ import annotations

import atexit
import json
import os
import re
import tempfile
import threading
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

try:                                    # stdlib, but allow exotic builds
    import sqlite3
    _SQLITE_OK = True
except ImportError:                     # pragma: no cover
    sqlite3 = None                      # type: ignore[assignment]
    _SQLITE_OK = False

__all__ = ["PlanStore", "StoreError", "PlanKey", "DB_FILENAME",
           "CORRUPT_DIRNAME", "MIGRATED_DIRNAME", "DEFAULT_MAX_BYTES",
           "DEFAULT_MAX_PLANS", "current_sweep_id"]

PlanKey = Tuple[str, str, int, str]     # (arch_sig, op_sig, version, kw_sig)

DB_FILENAME = "plans.sqlite"
CORRUPT_DIRNAME = "corrupt"
MIGRATED_DIRNAME = "migrated-json"

_ENV_BACKEND = "REPRO_PLAN_STORE"
_ENV_MAX_BYTES = "REPRO_PLAN_STORE_MAX_BYTES"
_ENV_MAX_PLANS = "REPRO_PLAN_STORE_MAX_PLANS"
_ENV_MAX_AGE = "REPRO_PLAN_STORE_MAX_AGE_S"
_ENV_SWEEP = "REPRO_PLAN_SWEEP_ID"

DEFAULT_MAX_BYTES = 512 * 1024 * 1024   # payload bytes before LRU eviction
DEFAULT_MAX_PLANS = 1_000_000

# SQLITE_BUSY handling: sqlite's own busy_timeout sleeps inside one
# statement; the retry loop re-issues the statement with bounded
# exponential backoff on top, so writer storms degrade to latency, never
# to an exception reaching resolve().
BUSY_TIMEOUT_MS = 250
BUSY_RETRIES = 6
BUSY_BACKOFF_S = 0.01
BUSY_BACKOFF_CAP_S = 0.32

_KEY_FILE_RE = re.compile(
    r"^([0-9a-f]{16})-([0-9a-f]{16})-v(\d+)-([0-9a-f]{16})\.json$")


def current_sweep_id(explicit: Optional[str] = None) -> Optional[str]:
    """Provenance tag for plans written now: the explicit id (a warmup
    sweep's token), else ``$REPRO_PLAN_SWEEP_ID``, else None (ad-hoc
    single resolves)."""
    return explicit or os.environ.get(_ENV_SWEEP) or None


def key_filename(key: PlanKey) -> str:
    arch_sig, op_sig, version, kw_sig = key
    return f"{arch_sig}-{op_sig}-v{version}-{kw_sig}.json"


def parse_key_filename(name: str) -> Optional[PlanKey]:
    m = _KEY_FILE_RE.match(name)
    if m is None:
        return None
    return (m.group(1), m.group(2), int(m.group(3)), m.group(4))


class StoreError(Exception):
    """A backend operation failed.  ``cause`` routes the facade's
    response: ``'store-dir'`` (root uncreatable — no rung that needs the
    directory can work), ``'open'`` (backend cannot open its store),
    ``'write'`` (unrecoverable write error: ENOSPC, read-only — reads
    keep working, writes stop), ``'busy'`` (retry budget exhausted —
    transient, this write is skipped but later ones may succeed)."""

    def __init__(self, cause: str, msg: str):
        super().__init__(msg)
        self.cause = cause


def _is_busy(e: Exception) -> bool:
    s = str(e).lower()
    return "locked" in s or "busy" in s


def _is_full_or_readonly(e: Exception) -> bool:
    if isinstance(e, OSError):
        return True
    s = str(e).lower()
    return ("full" in s or "readonly" in s or "read-only" in s
            or "unable to open" in s)


# ----------------------------------------------------------- null backend


class _NullBackend:
    """Memory-only rung: every read misses, every write is accepted and
    dropped — the in-memory dict inside ``PlanCache`` is the cache."""

    kind = "memory"

    def __init__(self):
        self.dropped = 0

    def get(self, key: PlanKey) -> Optional[str]:
        return None

    def put(self, key: PlanKey, payload: str,
            sweep_id: Optional[str] = None) -> bool:
        self.dropped += 1
        return False                    # nothing durable was written

    def discard(self, key: PlanKey) -> bool:
        return False

    def keys(self) -> List[PlanKey]:
        return []

    def invalidate(self, **kw) -> int:
        return 0

    def gc(self, **kw) -> Dict[str, int]:
        return {"expired": 0, "evicted": 0}

    def stats(self) -> Dict:
        return {"backend": self.kind, "plans": 0, "bytes": 0,
                "writes_dropped": self.dropped}

    def close(self) -> None:
        pass


# ----------------------------------------------------------- json backend


class _JsonBackend:
    """Legacy flat-directory store: one atomic-write JSON file per plan.
    Kept as the ladder's fallback rung; corrupt files are quarantined to
    ``corrupt/`` so cold processes stop re-parsing (and re-warning
    about) them forever."""

    kind = "json"

    def __init__(self, root: Path, now: Callable[[], float] = time.time):
        self.root = root
        self._now = now
        self._dir_ok: Optional[bool] = None

    def _path(self, key: PlanKey) -> Path:
        return self.root / key_filename(key)

    def _ensure_dir(self) -> None:
        if self._dir_ok:
            return
        try:
            self.root.mkdir(parents=True, exist_ok=True)
        except OSError as e:
            raise StoreError(
                "store-dir",
                f"cannot create store dir {self.root}: {e!r}") from e
        self._dir_ok = True

    def get(self, key: PlanKey) -> Optional[str]:
        try:
            return self._path(key).read_text()
        except OSError:
            return None

    def put(self, key: PlanKey, payload: str,
            sweep_id: Optional[str] = None) -> bool:
        self._ensure_dir()
        path = self._path(key)
        try:
            fd, tmp = tempfile.mkstemp(dir=str(self.root),
                                       prefix=path.stem + ".",
                                       suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    f.write(payload)
                os.replace(tmp, path)   # atomic: readers never see partials
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except OSError as e:
            raise StoreError("write",
                             f"could not persist plan to {path}: "
                             f"{e!r}") from e
        return True

    def discard(self, key: PlanKey) -> bool:
        """Quarantine one stored plan (corrupt payload): move the file to
        ``corrupt/`` so it is never re-parsed, fall back to unlinking."""
        path = self._path(key)
        qdir = self.root / CORRUPT_DIRNAME
        try:
            qdir.mkdir(parents=True, exist_ok=True)
            os.replace(path, qdir / path.name)
            return True
        except OSError:
            try:
                os.unlink(path)
                return True
            except OSError:
                return False

    def _entries(self) -> List[Tuple[PlanKey, Path, os.stat_result]]:
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in names:
            key = parse_key_filename(name)
            if key is None:
                continue
            path = self.root / name
            try:
                out.append((key, path, path.stat()))
            except OSError:
                continue
        return out

    def keys(self) -> List[PlanKey]:
        return [k for k, _p, _s in self._entries()]

    def invalidate(self, *, engine_version: Optional[int] = None,
                   sweep_id: Optional[str] = None,
                   older_than_s: Optional[float] = None) -> int:
        # sweep_id provenance only exists in the SQLite rung; filtering
        # on it here can only be a no-op.
        if sweep_id is not None:
            return 0
        n = 0
        cutoff = None if older_than_s is None else self._now() - older_than_s
        for key, path, st in self._entries():
            if engine_version is not None and key[2] != engine_version:
                continue
            if cutoff is not None and st.st_mtime > cutoff:
                continue
            if engine_version is None and cutoff is None:
                continue
            try:
                os.unlink(path)
                n += 1
            except OSError:
                pass
        return n

    def gc(self, *, max_bytes: Optional[int] = None,
           max_plans: Optional[int] = None,
           max_age_s: Optional[float] = None) -> Dict[str, int]:
        expired = 0
        if max_age_s is not None:
            expired = self.invalidate(older_than_s=max_age_s)
        entries = sorted(self._entries(), key=lambda e: e[2].st_mtime)
        total = sum(st.st_size for _k, _p, st in entries)
        count = len(entries)
        evicted = 0
        for _key, path, st in entries:     # oldest-mtime first (LRU proxy)
            over = ((max_bytes is not None and total > max_bytes)
                    or (max_plans is not None and count > max_plans))
            if not over:
                break
            try:
                os.unlink(path)
            except OSError:
                continue
            total -= st.st_size
            count -= 1
            evicted += 1
        return {"expired": expired, "evicted": evicted}

    def stats(self) -> Dict:
        entries = self._entries()
        return {"backend": self.kind, "plans": len(entries),
                "bytes": sum(st.st_size for _k, _p, st in entries)}

    def close(self) -> None:
        pass


# --------------------------------------------------------- sqlite backend


_SCHEMA = """
CREATE TABLE IF NOT EXISTS plans (
    arch_sig        TEXT    NOT NULL,
    op_sig          TEXT    NOT NULL,
    engine_version  INTEGER NOT NULL,
    kw_sig          TEXT    NOT NULL,
    payload         TEXT    NOT NULL,
    size_bytes      INTEGER NOT NULL,
    sweep_id        TEXT,
    created_s       REAL    NOT NULL,
    last_hit_s      REAL    NOT NULL,
    hits            INTEGER NOT NULL DEFAULT 0,
    PRIMARY KEY (arch_sig, op_sig, engine_version, kw_sig)
);
CREATE INDEX IF NOT EXISTS plans_lru ON plans (last_hit_s);
CREATE INDEX IF NOT EXISTS plans_version ON plans (engine_version);
"""

_KEY_WHERE = ("arch_sig = ? AND op_sig = ? AND engine_version = ? "
              "AND kw_sig = ?")


class _SqliteBackend:
    """WAL-mode SQLite store: the primary rung.  One writer at a time
    (WAL readers never block), busy-timeout + bounded-backoff retries,
    LRU/age eviction with incremental vacuum, provenance per row."""

    kind = "sqlite"

    def __init__(self, root: Path, *, max_bytes: int, max_plans: int,
                 max_age_s: Optional[float],
                 now: Callable[[], float] = time.time):
        if not _SQLITE_OK:
            raise StoreError("open", "sqlite3 module unavailable")
        self.root = root
        self.db_path = root / DB_FILENAME
        self.max_bytes = max_bytes
        self.max_plans = max_plans
        self.max_age_s = max_age_s
        self._now = now
        self._conn_obj: Optional["sqlite3.Connection"] = None
        self._lock = threading.RLock()
        self.write_ok = True            # flipped once on unrecoverable error
        self.read_only = False
        self.migrated = 0
        self.quarantined = 0
        self.evicted_total = 0

    # -------------------------------------------------------- connection

    def _legacy_files(self) -> List[Path]:
        try:
            return [self.root / n for n in os.listdir(self.root)
                    if parse_key_filename(n) is not None]
        except OSError:
            return []

    def _conn(self, create: bool) -> Optional["sqlite3.Connection"]:
        with self._lock:
            if self._conn_obj is not None:
                return self._conn_obj
            if not create and not self.db_path.exists() \
                    and not self._legacy_files():
                return None             # nothing to read, don't create
            try:
                self.root.mkdir(parents=True, exist_ok=True)
            except OSError as e:
                raise StoreError(
                    "store-dir",
                    f"cannot create store dir {self.root}: {e!r}") from e
            try:
                conn = self._open_rw()
            except sqlite3.DatabaseError as e:
                if isinstance(e, sqlite3.OperationalError) \
                        and _is_full_or_readonly(e) \
                        and self.db_path.exists():
                    conn = self._open_ro(e)
                else:
                    conn = self._recover_corrupt(e)
            self._conn_obj = conn
            # closing checkpoints the WAL and removes -wal/-shm: no
            # litter left by drivers that exit without an explicit close
            atexit.register(self.close)
            if not self.read_only:
                self._migrate_legacy()
            return conn

    def _open_rw(self) -> "sqlite3.Connection":
        conn = sqlite3.connect(str(self.db_path),
                               timeout=BUSY_TIMEOUT_MS / 1000.0,
                               check_same_thread=False)
        try:
            conn.execute(f"PRAGMA busy_timeout = {BUSY_TIMEOUT_MS}")
            conn.execute("PRAGMA journal_mode = WAL")
            conn.execute("PRAGMA synchronous = NORMAL")
            # must precede table creation to shape the file; a no-op on
            # an existing database (where it would need a full VACUUM)
            conn.execute("PRAGMA auto_vacuum = INCREMENTAL")
            conn.executescript(_SCHEMA)
            conn.commit()
        except BaseException:
            conn.close()
            raise
        return conn

    def _open_ro(self, cause: Exception) -> "sqlite3.Connection":
        """The directory or file rejects writes but a database exists:
        serve reads, keep new plans in memory (one warning)."""
        try:
            conn = sqlite3.connect(f"file:{self.db_path}?mode=ro", uri=True,
                                   timeout=BUSY_TIMEOUT_MS / 1000.0,
                                   check_same_thread=False)
            conn.execute("SELECT COUNT(*) FROM plans").fetchone()
        except sqlite3.DatabaseError:
            raise StoreError("open",
                             f"cannot open plan store {self.db_path}: "
                             f"{cause!r}") from cause
        self.read_only = True
        self.write_ok = False
        _warn_once(("read-only", str(self.root)),
                   f"PlanStore: {self.db_path} is read-only ({cause!r}); "
                   "serving stored plans, keeping new plans in memory only")
        return conn

    def _recover_corrupt(self, cause: Exception) -> "sqlite3.Connection":
        """Quarantine an unreadable database file and start fresh —
        plans re-solve; a corrupt store must never poison startup."""
        qdir = self.root / CORRUPT_DIRNAME
        try:
            qdir.mkdir(parents=True, exist_ok=True)
            os.replace(self.db_path, qdir / DB_FILENAME)
            for suffix in ("-wal", "-shm"):
                try:
                    os.unlink(str(self.db_path) + suffix)
                except OSError:
                    pass
        except OSError as e:
            raise StoreError("open",
                             f"corrupt plan store {self.db_path} "
                             f"({cause!r}) and quarantine failed "
                             f"({e!r})") from e
        self.quarantined += 1
        _warn_once(("corrupt-db", str(self.root)),
                   f"PlanStore: quarantined corrupt database "
                   f"{self.db_path} -> {qdir / DB_FILENAME} ({cause!r}); "
                   "starting a fresh store, plans will re-solve")
        try:
            return self._open_rw()
        except sqlite3.DatabaseError as e:
            raise StoreError("open",
                             f"cannot recreate plan store after "
                             f"quarantine: {e!r}") from e

    # ----------------------------------------------------- retry plumbing

    def _retry(self, fn):
        """Bounded exponential backoff around one statement batch.  Busy
        errors are retried; anything else propagates to the caller's
        classification."""
        delay = BUSY_BACKOFF_S
        for attempt in range(BUSY_RETRIES):
            try:
                return fn()
            except sqlite3.OperationalError as e:
                if not _is_busy(e) or attempt == BUSY_RETRIES - 1:
                    raise
                time.sleep(delay)
                delay = min(delay * 2, BUSY_BACKOFF_CAP_S)

    def _write(self, sql: str, params: Tuple = ()) -> int:
        """One committed write statement under the store lock, with busy
        retries.  Returns the affected rowcount."""
        conn = self._conn(create=True)

        def go():
            with self._lock:
                cur = conn.execute(sql, params)
                conn.commit()
                return cur.rowcount

        return self._retry(go)

    def _read(self, sql: str, params: Tuple = ()) -> List[Tuple]:
        conn = self._conn(create=False)
        if conn is None:
            return []

        def go():
            with self._lock:
                return conn.execute(sql, params).fetchall()

        return self._retry(go)

    # ---------------------------------------------------------- get / put

    def get(self, key: PlanKey) -> Optional[str]:
        try:
            rows = self._read(
                f"SELECT payload FROM plans WHERE {_KEY_WHERE}", key)
        except sqlite3.Error:
            return None                 # degraded read: treat as a miss
        if not rows:
            return None
        if not self.read_only and self.write_ok:
            try:                        # LRU bookkeeping is best-effort
                self._write(
                    f"UPDATE plans SET hits = hits + 1, last_hit_s = ? "
                    f"WHERE {_KEY_WHERE}", (self._now(),) + key)
            except (sqlite3.Error, OSError, StoreError):
                pass
        return rows[0][0]

    def put(self, key: PlanKey, payload: str,
            sweep_id: Optional[str] = None) -> bool:
        if not self.write_ok:
            return False                # degraded: warned once already
        now = self._now()
        try:
            self._write(
                "INSERT OR REPLACE INTO plans (arch_sig, op_sig, "
                "engine_version, kw_sig, payload, size_bytes, sweep_id, "
                "created_s, last_hit_s, hits) "
                "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, 0)",
                key + (payload, len(payload.encode()),
                       current_sweep_id(sweep_id), now, now))
            self._enforce_bounds()
        except sqlite3.OperationalError as e:
            if _is_busy(e):
                raise StoreError("busy",
                                 f"plan store busy after {BUSY_RETRIES} "
                                 f"retries: {e!r}") from e
            raise StoreError("write", f"plan write failed: {e!r}") from e
        except (sqlite3.Error, OSError) as e:
            raise StoreError("write", f"plan write failed: {e!r}") from e
        return True

    def discard(self, key: PlanKey) -> bool:
        try:
            return self._write(
                f"DELETE FROM plans WHERE {_KEY_WHERE}", key) > 0
        except (sqlite3.Error, OSError, StoreError):
            return False

    def keys(self) -> List[PlanKey]:
        try:
            rows = self._read(
                "SELECT arch_sig, op_sig, engine_version, kw_sig "
                "FROM plans ORDER BY created_s")
        except sqlite3.Error:
            return []
        return [(r[0], r[1], int(r[2]), r[3]) for r in rows]

    # ------------------------------------------------- eviction / gc / gc

    def _enforce_bounds(self) -> int:
        """LRU-evict (least-recently-hit first) until the store fits the
        configured bounds; reclaim freed pages incrementally."""
        rows = self._read(
            "SELECT COUNT(*), COALESCE(SUM(size_bytes), 0) FROM plans")
        if not rows:
            return 0
        count, total = int(rows[0][0]), int(rows[0][1])
        if count <= self.max_plans and total <= self.max_bytes:
            return 0
        victims = []
        for rowid, size in self._read(
                "SELECT rowid, size_bytes FROM plans "
                "ORDER BY last_hit_s ASC, created_s ASC"):
            if count <= self.max_plans and total <= self.max_bytes:
                break
            victims.append(rowid)
            count -= 1
            total -= int(size)
        if victims:
            self._write(
                "DELETE FROM plans WHERE rowid IN (%s)"
                % ",".join("?" * len(victims)), tuple(victims))
            self._vacuum()
            self.evicted_total += len(victims)
        return len(victims)

    def _vacuum(self) -> None:
        try:
            self._write("PRAGMA incremental_vacuum")
        except (sqlite3.Error, OSError, StoreError):
            pass

    def invalidate(self, *, engine_version: Optional[int] = None,
                   sweep_id: Optional[str] = None,
                   older_than_s: Optional[float] = None) -> int:
        """Delete exactly the rows matching the provenance filters (ANDed
        together; at least one must be given)."""
        where, params = [], []
        if engine_version is not None:
            where.append("engine_version = ?")
            params.append(engine_version)
        if sweep_id is not None:
            where.append("sweep_id = ?")
            params.append(sweep_id)
        if older_than_s is not None:
            where.append("created_s < ?")
            params.append(self._now() - older_than_s)
        if not where:
            return 0
        try:
            n = self._write("DELETE FROM plans WHERE " + " AND ".join(where),
                            tuple(params))
        except (sqlite3.Error, OSError):
            return 0
        if n:
            self._vacuum()
        return max(n, 0)

    def gc(self, *, max_bytes: Optional[int] = None,
           max_plans: Optional[int] = None,
           max_age_s: Optional[float] = None) -> Dict[str, int]:
        """Expire by age, enforce (possibly tightened) size bounds, then
        vacuum and truncate the WAL."""
        expired = 0
        age = max_age_s if max_age_s is not None else self.max_age_s
        if age is not None:
            expired = self.invalidate(older_than_s=age)
        old_bounds = (self.max_bytes, self.max_plans)
        if max_bytes is not None:
            self.max_bytes = max_bytes
        if max_plans is not None:
            self.max_plans = max_plans
        try:
            evicted = self._enforce_bounds()
        finally:
            if max_bytes is not None or max_plans is not None:
                self.max_bytes, self.max_plans = old_bounds
        try:
            self._write("PRAGMA wal_checkpoint(TRUNCATE)")
        except (sqlite3.Error, OSError, StoreError):
            pass
        return {"expired": expired, "evicted": evicted}

    def stats(self) -> Dict:
        try:
            rows = self._read(
                "SELECT COUNT(*), COALESCE(SUM(size_bytes), 0), "
                "COALESCE(SUM(hits), 0) FROM plans")
            by_version = dict(self._read(
                "SELECT engine_version, COUNT(*) FROM plans "
                "GROUP BY engine_version"))
            by_sweep = dict(self._read(
                "SELECT COALESCE(sweep_id, 'adhoc'), COUNT(*) FROM plans "
                "GROUP BY sweep_id"))
        except sqlite3.Error:
            rows, by_version, by_sweep = [], {}, {}
        count, nbytes, hits = (int(rows[0][0]), int(rows[0][1]),
                               int(rows[0][2])) if rows else (0, 0, 0)
        try:
            db_bytes = self.db_path.stat().st_size
        except OSError:
            db_bytes = 0
        return {"backend": self.kind, "plans": count, "bytes": nbytes,
                "db_bytes": db_bytes, "hits": hits,
                "by_version": {int(k): int(v) for k, v in by_version.items()},
                "by_sweep": {str(k): int(v) for k, v in by_sweep.items()},
                "migrated": self.migrated, "quarantined": self.quarantined,
                "evicted_total": self.evicted_total,
                "read_only": self.read_only, "write_ok": self.write_ok,
                "max_bytes": self.max_bytes, "max_plans": self.max_plans}

    def close(self) -> None:
        with self._lock:
            if self._conn_obj is None:
                return
            try:
                if not self.read_only:
                    self._conn_obj.execute("PRAGMA wal_checkpoint(TRUNCATE)")
            except sqlite3.Error:
                pass
            try:
                self._conn_obj.close()   # drops -wal/-shm on last close
            except sqlite3.Error:
                pass
            self._conn_obj = None

    # ---------------------------------------------------------- migration

    def _migrate_legacy(self) -> int:
        """Import every legacy per-plan JSON file in the root into the
        table (first writable open only — files are then moved aside so
        no later open re-parses them).  Zero lost plans: readable files
        land in ``migrated-json/``, unreadable ones in ``corrupt/``."""
        files = self._legacy_files()
        if not files:
            return 0
        moved_dir = self.root / MIGRATED_DIRNAME
        qdir = self.root / CORRUPT_DIRNAME
        migrated = corrupt = 0
        for path in files:
            key = parse_key_filename(path.name)
            try:
                payload = path.read_text()
                d = json.loads(payload)
                if tuple(d["key"]) != key or "plan" not in d:
                    raise ValueError("key mismatch")
            except (OSError, ValueError, KeyError, TypeError):
                try:
                    qdir.mkdir(parents=True, exist_ok=True)
                    os.replace(path, qdir / path.name)
                except OSError:
                    pass
                corrupt += 1
                continue
            try:
                st_mtime = path.stat().st_mtime
            except OSError:
                st_mtime = self._now()
            try:
                self._write(
                    "INSERT OR IGNORE INTO plans (arch_sig, op_sig, "
                    "engine_version, kw_sig, payload, size_bytes, "
                    "sweep_id, created_s, last_hit_s, hits) "
                    "VALUES (?, ?, ?, ?, ?, ?, 'legacy-json', ?, ?, 0)",
                    key + (payload, len(payload.encode()),
                           st_mtime, st_mtime))
            except (sqlite3.Error, OSError, StoreError):
                continue                # file stays for the next attempt
            try:
                moved_dir.mkdir(parents=True, exist_ok=True)
                os.replace(path, moved_dir / path.name)
            except OSError:
                pass
            migrated += 1
        self.migrated += migrated
        if migrated or corrupt:
            _warn_once(("migrated", str(self.root)),
                       f"PlanStore: migrated {migrated} legacy JSON "
                       f"plan(s) from {self.root} into {DB_FILENAME}"
                       + (f"; quarantined {corrupt} corrupt file(s) to "
                          f"{CORRUPT_DIRNAME}/" if corrupt else ""))
        return migrated


# ------------------------------------------------------------ warn-once


_WARNED: set = set()
_WARNED_LOCK = threading.Lock()


def _warn_once(cause_key: Tuple, msg: str) -> None:
    """One warning per (cause, store) for the life of the process — a
    degraded store degrades once, not once per write."""
    with _WARNED_LOCK:
        if cause_key in _WARNED:
            return
        _WARNED.add(cause_key)
    warnings.warn(msg, RuntimeWarning, stacklevel=4)


def _reset_warned() -> None:
    """Test hook: forget which degradations have been warned about."""
    with _WARNED_LOCK:
        _WARNED.clear()


# --------------------------------------------------------------- facade


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if not v else int(v)


def _env_float(name: str) -> Optional[float]:
    v = os.environ.get(name)
    return None if not v else float(v)


class PlanStore:
    """The degradation-ladder facade ``PlanCache`` persists through.

    Rung selection is lazy: a cache that only ever hits its in-memory
    layer never touches disk and never warns.  All faults degrade —
    ``get`` returns a miss, ``put`` returns False — and each distinct
    cause warns exactly once per store root.
    """

    _LADDER = ("sqlite", "json", "memory")

    def __init__(self, root, *, backend: Optional[str] = None,
                 max_bytes: Optional[int] = None,
                 max_plans: Optional[int] = None,
                 max_age_s: Optional[float] = None,
                 now: Callable[[], float] = time.time):
        self.root = Path(root).expanduser()
        backend = backend or os.environ.get(_ENV_BACKEND) or None
        if backend is not None and backend not in self._LADDER:
            raise ValueError(f"unknown plan-store backend {backend!r}; "
                             f"expected one of {self._LADDER}")
        self._rungs = list(self._LADDER[self._LADDER.index(backend):]
                           if backend else self._LADDER)
        self._cfg = {
            "max_bytes": (max_bytes if max_bytes is not None
                          else _env_int(_ENV_MAX_BYTES, DEFAULT_MAX_BYTES)),
            "max_plans": (max_plans if max_plans is not None
                          else _env_int(_ENV_MAX_PLANS, DEFAULT_MAX_PLANS)),
            "max_age_s": (max_age_s if max_age_s is not None
                          else _env_float(_ENV_MAX_AGE)),
        }
        self._now = now
        self._impl = None
        self._lock = threading.Lock()
        self.demotions: List[str] = []

    # ------------------------------------------------------------ ladder

    def _make_impl(self):
        with self._lock:
            if self._impl is not None:
                return self._impl
            kind = self._rungs[0]
            if kind == "sqlite" and _SQLITE_OK:
                self._impl = _SqliteBackend(self.root, now=self._now,
                                            **self._cfg)
            elif kind == "json" or kind == "sqlite":
                self._impl = _JsonBackend(self.root, now=self._now)
            else:
                self._impl = _NullBackend()
            return self._impl

    def _demote(self, err: StoreError) -> None:
        """Drop to the next usable rung after an open-level failure.  A
        root directory that cannot exist fails every disk rung at once,
        so it jumps straight to memory with a single warning."""
        with self._lock:
            failed = self._rungs[0] if self._rungs else "memory"
            if err.cause == "store-dir" or failed == "json":
                self._rungs = ["memory"]
            else:
                self._rungs = self._rungs[1:] or ["memory"]
            nxt = self._rungs[0]
            self._impl = None
            self.demotions.append(f"{failed}->{nxt}: {err}")
        reason = ("running memory-only" if nxt == "memory"
                  else f"falling back to the {nxt} store")
        _warn_once((err.cause, failed, str(self.root)),
                   f"PlanStore: {failed} backend failed ({err}); {reason}")

    @property
    def backend(self) -> str:
        """The active rung's kind (instantiates the backend lazily)."""
        return self._make_impl().kind

    # -------------------------------------------------------- operations

    def get(self, key: PlanKey) -> Optional[str]:
        for _ in range(len(self._LADDER) + 1):
            impl = self._make_impl()
            try:
                return impl.get(key)
            except StoreError as e:
                self._demote(e)
        return None                      # pragma: no cover — ladder ends

    def put(self, key: PlanKey, payload: str,
            sweep_id: Optional[str] = None) -> bool:
        for _ in range(len(self._LADDER) + 1):
            impl = self._make_impl()
            if not getattr(impl, "write_ok", True):
                return False             # degraded: warned once already
            try:
                return impl.put(key, payload, sweep_id=sweep_id)
            except StoreError as e:
                if e.cause == "busy":
                    # transient: skip this write, keep the rung
                    _warn_once(("busy", str(self.root)),
                               f"PlanStore: {e}; plan kept in memory "
                               "(later writes will retry)")
                    return False
                if e.cause == "write" and impl.kind != "memory":
                    # reads still work; writes stop, exactly one warning
                    impl.write_ok = False
                    _warn_once(("write", impl.kind, str(self.root)),
                               f"PlanStore: unrecoverable {impl.kind} "
                               f"write error ({e}); keeping new plans "
                               "in memory only")
                    return False
                self._demote(e)
        return False                     # pragma: no cover — ladder ends

    def discard(self, key: PlanKey) -> bool:
        try:
            return self._make_impl().discard(key)
        except StoreError:
            return False

    def keys(self) -> List[PlanKey]:
        try:
            return self._make_impl().keys()
        except StoreError as e:
            self._demote(e)
            return []

    def invalidate(self, **kw) -> int:
        try:
            return self._make_impl().invalidate(**kw)
        except StoreError:
            return 0

    def gc(self, **kw) -> Dict[str, int]:
        try:
            return self._make_impl().gc(**kw)
        except StoreError as e:
            self._demote(e)
            return {"expired": 0, "evicted": 0}

    def stats(self) -> Dict:
        try:
            s = self._make_impl().stats()
        except StoreError:
            s = {"backend": "memory", "plans": 0, "bytes": 0}
        s["demotions"] = list(self.demotions)
        return s

    def close(self) -> None:
        with self._lock:
            if self._impl is not None:
                self._impl.close()
