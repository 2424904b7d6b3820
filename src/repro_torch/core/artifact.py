"""Persistent compiled-plan artifacts: a content-addressed on-disk cache.

The PyTorch port's copy of ``repro/core/artifact.py`` (stdlib only).
:func:`canonical_key`, :func:`key_hash` and the entry format are the
reference's, byte for byte, so one cache directory serves both packages:
a geometry the JAX package published is loaded by the port unchanged
when both negotiate the same chain under the same model and budget.

The paper's endgame is custom SIMD instructions "loaded in future CPUs
that feature reconfigurable regions": a compiled region program is a
*portable artifact*, not a per-process accident, and loading one must be
cheap. The dispatch caches make the warm path free **inside** one
process; this module makes the cold path cheap **across** processes by
persisting what those caches hold — negotiated block geometries (and,
once the graph partitioner is ported, plan chain splits) — keyed exactly
as the in-process memos key them (structural identity × size × dtype ×
model fingerprint × budgets), so a fresh worker skips the candidate
sweeps another process already paid for.

Layout and guarantees
---------------------
* **Content-addressed entries** — one JSON file per artifact, named
  ``{kind}-{sha256(canonical key)[:32]}.json`` inside the cache dir.
  The canonical key is the in-process memo key serialised as canonical
  JSON (sorted, compact, tuples as lists); the full key is ALSO stored
  inside the entry and verified on load, so a hash collision or a
  renamed/substituted file can never serve another key's payload.
* **Atomic publication** — writes go to a same-directory temp file and
  ``os.replace`` into place, so concurrent workers sharing one cache
  dir (scheduler fleets, CI's ``actions/cache``, the JAX package and
  the port side by side) only ever see whole entries: last writer wins,
  readers never see a torn write.
* **Corruption tolerance** — a truncated, garbage, version-mismatched
  or wrong-key entry is counted (``DISPATCH_STATS.disk_corrupt`` /
  ``disk_invalidated``), deleted best-effort, and reported as a miss:
  the caller recompiles and overwrites. Loads NEVER raise and NEVER
  serve a payload that failed validation.
* **Model-fingerprint keying** — keys embed the memory model's value
  fingerprint, so fingerprint drift (an edited ``BurstModel``, a
  swapped preset) misses naturally instead of serving a stale geometry.
  Process-local token fingerprints (models without a value
  ``fingerprint()``) are meaningless in another process, so keys
  containing them are refused for disk sharing entirely — see
  :func:`persistable_fingerprint`.
* **Bounded growth** — publishing runs an mtime-based LRU sweep when a
  size bound is configured (``PlanCache(max_entries=, max_bytes=)`` or
  ``REPRO_PLAN_CACHE_ENTRIES``/``REPRO_PLAN_CACHE_BYTES``); evictions
  are observable as ``repro_dispatch_disk_evict_total``.

Activation
----------
The cache is off by default. Point a process at a directory with
:func:`set_plan_cache` or via the ``REPRO_PLAN_CACHE`` environment
variable (how worker fleets and subprocess tests share one dir).
Consumers only consult it on an in-process memo miss, so a warm process
pays nothing.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import tempfile
from typing import Any, Callable, Optional

# Bump on ANY change to entry layout or payload semantics: version
# mismatches are invalidated (deleted + recompiled), never migrated.
ARTIFACT_VERSION = 1

ENV_VAR = "REPRO_PLAN_CACHE"
# GC bounds for env-activated caches (both optional; see PlanCache):
ENV_MAX_ENTRIES = "REPRO_PLAN_CACHE_ENTRIES"
ENV_MAX_BYTES = "REPRO_PLAN_CACHE_BYTES"


def _stats():
    """The live DISPATCH_STATS view (registry-backed). Looked up lazily
    through the module to avoid an import cycle and to stay correct if
    the global is ever rebound."""
    from . import program as _program
    return _program.DISPATCH_STATS


def _env_int(name: str) -> Optional[int]:
    try:
        v = int(os.environ.get(name, ""))
        return v if v > 0 else None
    except ValueError:
        return None


def jsonable(obj) -> Any:
    """Canonical JSON-able form of a cache key / metadata structure:
    tuples become lists, dicts sort by stringified key, scalars pass
    through, anything else degrades to ``repr`` (stable for the frozen
    value types used in fingerprints)."""
    if isinstance(obj, (list, tuple)):
        return [jsonable(o) for o in obj]
    if isinstance(obj, dict):
        return {str(k): jsonable(v)
                for k, v in sorted(obj.items(), key=lambda kv: str(kv[0]))}
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    return repr(obj)


def canonical_key(key) -> str:
    """The canonical serialised key: what gets hashed for the entry
    filename AND stored in the entry for load-time verification."""
    return json.dumps(jsonable(key), sort_keys=True,
                      separators=(",", ":"))


def key_hash(key) -> str:
    return hashlib.sha256(canonical_key(key).encode()).hexdigest()[:32]


def persistable_fingerprint(fp) -> bool:
    """Whether a model fingerprint is safe to share across processes.

    Value fingerprints (BurstModel/Hierarchy) are; the ``("token", n)``
    identity fallbacks of :func:`repro_torch.core.program._model_fingerprint`
    are process-local counters — two unrelated models in two processes
    can share a token, so persisting a token-keyed entry could serve a
    WRONG geometry. Those keys never touch the disk cache."""
    if isinstance(fp, tuple):
        if len(fp) == 2 and fp[0] == "token":
            return False
        return all(persistable_fingerprint(x) for x in fp)
    return True


class PlanCache:
    """One content-addressed artifact directory (see module docstring).

    All methods are best-effort and exception-free towards the caller:
    ``load`` answers None for anything it cannot fully verify, ``store``
    returns False instead of raising — persistence failures degrade to
    a recompile, never to a crash or a wrong result.

    Garbage collection: long-lived fleet dirs grow
    monotonically without a bound, so ``store`` runs an mtime-based LRU
    sweep when ``max_entries`` / ``max_bytes`` is set (explicitly or via
    ``REPRO_PLAN_CACHE_ENTRIES`` / ``REPRO_PLAN_CACHE_BYTES``): oldest
    entries are unlinked until the dir fits, counted in
    ``DISPATCH_STATS.disk_evict`` (exposed as the registry counter
    ``repro_dispatch_disk_evict_total``). ``load`` hits re-touch the
    entry's mtime so hot artifacts survive the sweep. The entry being
    published is always retained.
    """

    def __init__(self, path, max_entries: Optional[int] = None,
                 max_bytes: Optional[int] = None):
        self.path = os.fspath(path)
        self.max_entries = (max_entries if max_entries is not None
                            else _env_int(ENV_MAX_ENTRIES))
        self.max_bytes = (max_bytes if max_bytes is not None
                          else _env_int(ENV_MAX_BYTES))

    def __repr__(self) -> str:
        return f"PlanCache({self.path!r})"

    def entry_path(self, kind: str, key) -> str:
        return os.path.join(self.path, f"{kind}-{key_hash(key)}.json")

    def _unlink(self, path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    def load(self, kind: str, key,
             decode: Optional[Callable[[Any], Any]] = None):
        """The verified payload for ``key``, or None (miss/corrupt/stale).

        ``decode`` optionally maps the raw JSON payload to the caller's
        value; returning None (or raising) marks the entry invalid —
        counted, deleted, and reported as a miss so the caller
        recompiles and overwrites it.
        """
        path = self.entry_path(kind, key)
        stats = _stats()
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
        except FileNotFoundError:
            stats.disk_miss += 1
            return None
        except (OSError, ValueError):
            # unreadable, truncated mid-write by a crash, or garbage
            stats.disk_corrupt += 1
            self._unlink(path)
            return None
        if (not isinstance(data, dict)
                or data.get("version") != ARTIFACT_VERSION
                or data.get("kind") != kind
                or data.get("key") != json.loads(canonical_key(key))):
            stats.disk_invalidated += 1
            self._unlink(path)
            return None
        payload = data.get("payload")
        if decode is not None:
            try:
                payload = decode(payload)
            except Exception:  # noqa: BLE001 — any decode failure = stale
                payload = None
            if payload is None:
                stats.disk_invalidated += 1
                self._unlink(path)
                return None
        stats.disk_hit += 1
        try:
            os.utime(path, None)   # LRU recency for the GC sweep
        except OSError:
            pass
        return payload

    def store(self, kind: str, key, payload) -> bool:
        """Atomically publish ``payload`` under ``key`` (write-rename).
        Returns False (never raises) when the entry cannot be written —
        an unwritable cache dir only costs future processes a recompile.
        """
        entry = {"version": ARTIFACT_VERSION, "kind": kind,
                 "key": json.loads(canonical_key(key)), "payload": payload}
        path = self.entry_path(kind, key)
        tmp = None
        try:
            os.makedirs(self.path, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(entry, f)
            os.replace(tmp, path)
            tmp = None
        except (OSError, TypeError, ValueError):
            if tmp is not None:
                self._unlink(tmp)
            return False
        _stats().disk_store += 1
        if self.max_entries or self.max_bytes:
            self._sweep(keep=path)
        return True

    def invalidate(self, kind: str, key) -> None:
        """Drop one entry (best-effort)."""
        self._unlink(self.entry_path(kind, key))

    def _sweep(self, keep: Optional[str] = None) -> int:
        """Mtime-based LRU sweep: unlink oldest ``*.json`` entries until
        the dir fits ``max_entries``/``max_bytes``. ``keep`` (the entry
        just published) is never evicted. Best-effort: races with
        concurrent workers (an entry vanishing mid-scan) are ignored.
        Returns the number of evictions."""
        entries = []
        try:
            with os.scandir(self.path) as it:
                for de in it:
                    if not de.name.endswith(".json"):
                        continue
                    try:
                        st = de.stat()
                    except OSError:
                        continue
                    entries.append((st.st_mtime, de.name, de.path,
                                    st.st_size))
        except OSError:
            return 0
        total = sum(e[3] for e in entries)
        count = len(entries)
        over = ((self.max_entries and count > self.max_entries)
                or (self.max_bytes and total > self.max_bytes))
        if not over:
            return 0
        entries.sort()                      # oldest mtime first, then name
        evicted = 0
        keep = os.path.abspath(keep) if keep else None
        for mtime, name, path, size in entries:
            if ((not self.max_entries or count <= self.max_entries)
                    and (not self.max_bytes or total <= self.max_bytes)):
                break
            if keep and os.path.abspath(path) == keep:
                continue
            try:
                os.unlink(path)
            except OSError:
                continue
            count -= 1
            total -= size
            evicted += 1
        if evicted:
            _stats().disk_evict += evicted
        return evicted


# -- process-wide active cache ----------------------------------------------
# (explicitly_set, cache): until set_plan_cache is called, the env var
# decides; an explicit set (including set_plan_cache(None) = disabled)
# overrides the environment.
_STATE: tuple[bool, Optional[PlanCache]] = (False, None)


def set_plan_cache(path) -> Optional[PlanCache]:
    """Point this process at a plan-cache directory (str/PathLike/
    PlanCache), or disable disk caching with None. Returns the now-
    active cache."""
    global _STATE
    if path is None:
        _STATE = (True, None)
    elif isinstance(path, PlanCache):
        _STATE = (True, path)
    else:
        _STATE = (True, PlanCache(path))
    return _STATE[1]


def reset_plan_cache() -> None:
    """Back to the default: ``REPRO_PLAN_CACHE`` decides."""
    global _STATE
    _STATE = (False, None)


def plan_cache() -> Optional[PlanCache]:
    """The active cache, or None when disk caching is off. Consulted on
    in-process memo misses only — the warm path never calls this."""
    explicit, active = _STATE
    if explicit:
        return active
    path = os.environ.get(ENV_VAR)
    return PlanCache(path) if path else None


@contextlib.contextmanager
def using_plan_cache(path):
    """Scoped :func:`set_plan_cache` — restores the previous setting
    (including "env-controlled") on exit; what benches and tests use so
    a shared process never leaks an expired temp dir."""
    global _STATE
    prev = _STATE
    set_plan_cache(path)
    try:
        yield plan_cache()
    finally:
        _STATE = prev
