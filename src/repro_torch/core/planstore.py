"""Persistent, content-keyed plan store: warm starts across process restarts
(the port's copy of ``repro/core/planstore.py``; sqlite, no torch).

:class:`~repro_torch.core.replan.PlanCache` dies with the process, so every
controller restart re-pays the full cold optimisation for every operating
point it revisits -- exactly the replan latency the authors' prototype paper
(arXiv 2211.13778) shows dominating on real testbeds -- and a fleet of
controllers (DistrEdge-style, arXiv 2202.01699) cannot share warm plans at
all.  This module is the orco-style persistent backing tier behind the LRU:

* **Content keying.**  Entries are keyed on the *exact* in-memory cache
  identity -- the ``(cache kind, topology fingerprint, optimiser-config
  knobs, bucket key)`` tuple :class:`~repro_torch.core.replan.ReplanController`
  already builds -- serialised canonically (:func:`canonical_key`) and hashed
  (sha256).  Two controllers, two processes, or two machines that would hit
  the same in-memory cache entry therefore hit the same store row, and a row
  filled by one controller warm-starts every other.  The canonical text is
  stored alongside the hash and compared on every read, so a hash collision
  can never serve a wrong plan.

* **Reproducible payloads.**  The stored value is the optimised
  :class:`~repro_torch.core.optimizer.OptimizeResult` /
  :class:`~repro_torch.core.placement.PlacementResult` itself (pickled), so a
  store-served plan is *bit-identical* to the freshly-optimised one -- same
  row partition, same float makespan.  Keys quantise rates into bands
  optimised against band *representatives* (see
  :mod:`~repro_torch.core.replan`), so entries are reproducible regardless of
  which measured rate first filled them -- the property that makes offline
  precomputation (:meth:`~repro_torch.core.replan.ReplanController.prime`)
  meaningful.

* **Provenance.**  Each row records what the plan was optimised against (the
  band-representative link rates and per-ES platforms), the scored makespan,
  the pricing engine, and a creation timestamp -- enough to audit a fleet's
  shared store or rebuild an entry from its description.

* **Explicit invalidation.**  A changed optimiser config is a different key
  by construction (the knobs live in the fingerprint), so a reconfigured
  controller can never read a stale plan.  A changed *code schema* (the shape
  of plans/results themselves) is handled by :data:`PLAN_SCHEMA_VERSION`:
  every row carries the version it was written under, reads require an exact
  match, and :meth:`PlanStore.prune_stale` garbage-collects outdated rows.
  Bump the constant whenever ``HALPPlan`` / ``OptimizeResult`` /
  ``PlacementResult`` change shape.

* **One file, two packages.**  The key text is the same in this package
  and in the JAX package, so both may share one store file.  A payload is
  unpickled through :class:`_PortUnpickler`, which resolves classes only
  from ``repro_torch``, ``builtins``, ``collections``, ``copyreg`` and
  ``numpy``: a row the other package wrote would import its modules into
  this process, so it is refused, served as a miss, counted in ``stale``
  and left in the file for its owner.

Concurrency: sqlite in WAL mode with a busy timeout -- many reader processes
and a writer coexist, which is all the fleet sharing model needs (writers are
rare: one per cache miss).  ``put`` is last-writer-wins on a key, which is
safe because any two writers of the same key computed the same plan from the
same band representatives.
"""
from __future__ import annotations

import hashlib
import io
import json
import logging
import math
import pickle
import sqlite3
import time
from pathlib import Path

_log = logging.getLogger(__name__)

__all__ = ["PLAN_SCHEMA_VERSION", "canonical_key", "key_hash", "PlanStore"]

# Version of the *stored payload schema*: the pickled OptimizeResult /
# PlacementResult object graphs (plans, layouts, topologies).  Reads require
# an exact match, so bumping this invalidates every existing store in one
# line -- the explicit upgrade path for refactors that change plan shape.
PLAN_SCHEMA_VERSION = 2  # v2: OptimizeResult grew `schemes`; plans may be SchemePlan


def canonical_key(key) -> str:
    """Deterministic text form of a cache key tuple.

    Handles exactly the types the replan/placement cache keys are built from
    (nested tuples/lists of str, bool, int, float, None) and refuses anything
    else loudly -- a silently ambiguous serialisation here would alias store
    entries.  Distinct types never collide: strings are JSON-quoted, bools
    render as ``True``/``False``, and floats use ``repr`` (shortest
    round-trip, so distinct floats stay distinct and equal floats -- e.g. a
    band anchor -- always serialise identically)."""
    if isinstance(key, (tuple, list)):
        return "(" + ",".join(canonical_key(k) for k in key) + ")"
    if key is None or isinstance(key, bool):
        return repr(key)
    if isinstance(key, (int, float)):
        if isinstance(key, float) and not math.isfinite(key):
            raise ValueError(f"cache keys must be finite, got {key!r}")
        return repr(key)
    if isinstance(key, str):
        return json.dumps(key)
    raise TypeError(f"unsupported type in cache key: {type(key).__name__} ({key!r})")


def key_hash(key) -> str:
    """sha256 of the canonical key text -- the store's primary key."""
    return hashlib.sha256(canonical_key(key).encode("utf-8")).hexdigest()


def _kind_of(key) -> str:
    """The cache namespace of a controller key: ``key[0][0]`` is the
    controller's ``_cache_kind`` ("plan" / "placement") by construction of
    :class:`~repro_torch.core.replan.ReplanController`'s fingerprint."""
    try:
        kind = key[0][0]
        return kind if isinstance(kind, str) else "other"
    except (TypeError, IndexError, KeyError):
        return "other"


# Modules a stored payload may resolve classes from: this package's own, the
# builtins and the stdlib helpers pickle itself names, and numpy (``numpy*``)
# for its scalars and arrays.
_PAYLOAD_MODULES = ("repro_torch", "builtins", "collections", "copyreg")


class ForeignPayload(pickle.UnpicklingError):
    """A stored payload names a class outside :data:`_PAYLOAD_MODULES`."""


class _PortUnpickler(pickle.Unpickler):
    """``pickle.Unpickler`` that refuses any class whose module is not this
    package's (or one of the few that plain payloads need): a row written by
    the JAX package names ``repro.core...`` classes, and loading them would
    import that package into this process."""

    def find_class(self, module: str, name: str):
        top = module.split(".")[0]
        if top not in _PAYLOAD_MODULES and not top.startswith("numpy"):
            raise ForeignPayload(f"payload names {module}.{name}")
        return super().find_class(module, name)


_SCHEMA = """
CREATE TABLE IF NOT EXISTS plans (
    key_hash       TEXT PRIMARY KEY,
    key_text       TEXT NOT NULL,
    kind           TEXT NOT NULL,
    schema_version INTEGER NOT NULL,
    payload        BLOB NOT NULL,
    makespan       REAL,
    engine         TEXT,
    created_s      REAL NOT NULL,
    provenance     TEXT
);
CREATE INDEX IF NOT EXISTS plans_kind ON plans (kind);
"""


class PlanStore:
    """sqlite-backed persistent map from canonical cache keys to optimised
    plan results, with provenance and schema-versioned invalidation.

    Open one per process (connections are cheap; WAL handles concurrent
    processes on the same file).  ``hits`` / ``misses`` / ``stale`` mirror
    :class:`~repro_torch.core.replan.PlanCache` telemetry so warm-start claims are
    measurable; ``stale`` counts reads that found a row written under a
    different :data:`PLAN_SCHEMA_VERSION` (never served -- a restart after a
    schema bump re-optimises rather than risk deserialising an outdated
    shape) or by the JAX package (never unpickled: see
    :class:`_PortUnpickler`)."""

    def __init__(self, path: str | Path, schema_version: int = PLAN_SCHEMA_VERSION):
        self.path = str(path)
        self.schema_version = int(schema_version)
        self._conn = sqlite3.connect(self.path, timeout=30.0)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.executescript(_SCHEMA)
        self._conn.commit()
        self.hits = 0
        self.misses = 0
        self.stale = 0
        self.writes = 0
        self.invalid = 0

    # -- mapping ----------------------------------------------------------

    def get(self, key):
        """The stored result for ``key``, unpickled, or None.  Returns None
        (a miss) for absent keys, hash collisions (canonical texts compared),
        rows written under a different schema version or by another package
        (both counted in ``stale`` and kept), and rows whose payload
        fails to deserialize or whose plan fails static verification
        (:func:`repro_torch.analysis.check_plan`) -- those rows are deleted and
        counted in ``invalid``, so a corrupted store degrades to cache misses
        instead of serving broken plans or raising into the controller."""
        canon = canonical_key(key)
        khash = key_hash(key)
        row = self._conn.execute(
            "SELECT key_text, schema_version, payload FROM plans WHERE key_hash = ?",
            (khash,),
        ).fetchone()
        if row is None or row[0] != canon:
            self.misses += 1
            return None
        if int(row[1]) != self.schema_version:
            self.stale += 1
            self.misses += 1
            return None
        try:
            result = _PortUnpickler(io.BytesIO(row[2])).load()
        except ForeignPayload as exc:
            # another package's row in a shared file: a miss, kept for its owner
            _log.info("plan store row left unread (%s)", exc)
            self.stale += 1
            self.misses += 1
            return None
        except Exception as exc:
            self._invalidate_row(khash, f"payload failed to deserialize: {exc!r}")
            return None
        detail = self._verify_payload(result)
        if detail is not None:
            self._invalidate_row(khash, detail)
            return None
        self.hits += 1
        return result

    def _verify_payload(self, result) -> str | None:
        """Static-verification detail for a deserialized payload, or None if
        it is servable.  Only objects that carry plans (``.plan`` / ``.plans``)
        are checked; anything else passes through untouched.  A *crash* in the
        checker itself is logged and the payload served -- an analyzer bug
        must not take down serving."""
        plans = getattr(result, "plans", None)
        if plans is None:  # PlacementResult nests them one level down
            plans = getattr(getattr(result, "placement", None), "plans", None)
        if plans is None:
            plan = getattr(result, "plan", None)
            plans = () if plan is None else (plan,)
        if not plans:
            return None
        try:
            from ..analysis import check_plan
        except Exception:  # pragma: no cover - analysis package missing
            return None
        for plan in plans:
            try:
                rep = check_plan(plan)
            except Exception:
                _log.warning(
                    "plan-store verifier crashed on a stored payload; "
                    "serving the row unverified", exc_info=True
                )
                return None
            if not rep.ok:
                return "stored plan failed verification: " + "; ".join(
                    str(f) for f in rep.findings[:3]
                )
        return None

    def _invalidate_row(self, khash: str, detail: str) -> None:
        """Drop one corrupt/invalid row and count the read as a miss."""
        _log.warning("plan store row invalidated (%s)", detail)
        self._conn.execute("DELETE FROM plans WHERE key_hash = ?", (khash,))
        self._conn.commit()
        self.invalid += 1
        self.misses += 1

    def put(self, key, result, provenance: dict | None = None, kind: str | None = None) -> None:
        """Persist one optimised result under ``key`` (last-writer-wins --
        safe because equal keys imply equal band representatives imply equal
        plans).  ``provenance`` is stored as JSON; ``kind`` defaults to the
        key's cache namespace (``key[0][0]``)."""
        prov = dict(provenance or {})
        self._conn.execute(
            "INSERT OR REPLACE INTO plans "
            "(key_hash, key_text, kind, schema_version, payload, makespan, "
            " engine, created_s, provenance) VALUES (?,?,?,?,?,?,?,?,?)",
            (
                key_hash(key),
                canonical_key(key),
                kind if kind is not None else _kind_of(key),
                self.schema_version,
                pickle.dumps(result, protocol=pickle.HIGHEST_PROTOCOL),
                float(getattr(result, "makespan", float("nan"))),
                prov.get("engine"),
                time.time(),
                json.dumps(prov, sort_keys=True),
            ),
        )
        self._conn.commit()
        self.writes += 1

    def provenance(self, key) -> dict | None:
        """The provenance record stored with ``key`` (schema-checked like
        :meth:`get`, but without deserialising the payload)."""
        row = self._conn.execute(
            "SELECT key_text, schema_version, provenance, makespan, created_s "
            "FROM plans WHERE key_hash = ?",
            (key_hash(key),),
        ).fetchone()
        if row is None or row[0] != canonical_key(key) or int(row[1]) != self.schema_version:
            return None
        out = json.loads(row[2]) if row[2] else {}
        out["makespan"] = row[3]
        out["created_s"] = row[4]
        return out

    # -- inventory / invalidation -----------------------------------------

    def __len__(self) -> int:
        return int(
            self._conn.execute(
                "SELECT COUNT(*) FROM plans WHERE schema_version = ?",
                (self.schema_version,),
            ).fetchone()[0]
        )

    def keys(self, kind: str | None = None) -> list[str]:
        """Canonical key texts of the live (current-schema) entries."""
        q = "SELECT key_text FROM plans WHERE schema_version = ?"
        args: tuple = (self.schema_version,)
        if kind is not None:
            q += " AND kind = ?"
            args += (kind,)
        return [r[0] for r in self._conn.execute(q + " ORDER BY key_text", args)]

    def stats(self) -> dict:
        return dict(
            entries=len(self),
            hits=self.hits,
            misses=self.misses,
            stale=self.stale,
            writes=self.writes,
            invalid=self.invalid,
            path=self.path,
        )

    def invalidate(self, kind: str | None = None) -> int:
        """Delete entries (all, or one cache namespace); returns rows dropped.
        The explicit hammer -- config changes do NOT need it (they key
        differently), schema changes do not either (rows become unreadable);
        this is for operator-driven resets (e.g. a recalibrated cluster)."""
        if kind is None:
            cur = self._conn.execute("DELETE FROM plans")
        else:
            cur = self._conn.execute("DELETE FROM plans WHERE kind = ?", (kind,))
        self._conn.commit()
        return cur.rowcount

    def prune_stale(self) -> int:
        """Garbage-collect rows written under a different schema version
        (they are already unreadable); returns rows dropped."""
        cur = self._conn.execute(
            "DELETE FROM plans WHERE schema_version != ?", (self.schema_version,)
        )
        self._conn.commit()
        return cur.rowcount

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        self._conn.close()

    def __enter__(self) -> "PlanStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
