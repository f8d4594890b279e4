"""AST lint: every ``ReplanConfig`` knob must key the plan store -- or say why not
(the port's copy of ``repro/analysis/keying_lint.py``).

The silent-stale-plan bug class: a new optimiser-facing config field lands,
nobody folds it into ``ReplanController._fingerprint``, and two controllers
with different settings silently share (wrong) cache/store entries.  Comments
per knob defend against this by hand; this pass makes the partition
machine-checked:

* every field of the ``ReplanConfig`` dataclass is either read inside the
  ``self._fingerprint = (...)`` tuple (``config.<field>``) or named in the
  module-level ``FINGERPRINT_EXCLUDED`` dict with a non-trivial justification
  string (``keying.unkeyed`` otherwise);
* a field may not be both fingerprinted and excluded
  (``keying.contradiction``), and exclusions for fields that no longer exist
  are flagged (``keying.stale-exclusion``) -- dead justifications rot;
* the fingerprint may not read fields the dataclass does not define
  (``keying.unknown-field``);
* ``PlanStore.get`` must keep its two row-level vetoes: the canonical-key
  text comparison (hash-collision veto) and the ``schema_version`` check
  (``keying.store-veto`` if either disappears).

The lint operates on *source text* (defaults to the installed
``repro_torch.core.replan`` / ``repro_torch.core.planstore`` files, never the
JAX package's) so mutation tests can feed corrupted sources without touching
the real modules.
"""
from __future__ import annotations

import ast
from pathlib import Path

from .findings import Report

__all__ = ["check_keying"]

MIN_JUSTIFICATION = 10  # characters; "perf" is not a justification


def _module_source(modname: str) -> str:
    import importlib

    mod = importlib.import_module(modname)
    return Path(mod.__file__).read_text()


def _config_fields(tree: ast.Module, cls: str) -> list[str] | None:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == cls:
            return [
                stmt.target.id
                for stmt in node.body
                if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name)
            ]
    return None


def _excluded(tree: ast.Module) -> dict[str, object] | None:
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
            value = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
            value = node.value
        else:
            continue
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "FINGERPRINT_EXCLUDED":
                if not isinstance(value, ast.Dict):
                    return None
                out: dict[str, object] = {}
                for k, v in zip(value.keys, value.values):
                    key = k.value if isinstance(k, ast.Constant) else None
                    val = v.value if isinstance(v, ast.Constant) else None
                    out[str(key)] = val
                return out
    return None


def _fingerprint_reads(tree: ast.Module) -> set[str] | None:
    """Field names read as ``config.<x>`` / ``self.config.<x>`` inside any
    ``self._fingerprint = ...`` assignment."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not any(
            isinstance(t, ast.Attribute)
            and t.attr == "_fingerprint"
            and isinstance(t.value, ast.Name)
            and t.value.id == "self"
            for t in node.targets
        ):
            continue
        reads: set[str] = set()
        for sub in ast.walk(node.value):
            if not isinstance(sub, ast.Attribute):
                continue
            base = sub.value
            if isinstance(base, ast.Name) and base.id == "config":
                reads.add(sub.attr)
            elif (
                isinstance(base, ast.Attribute)
                and base.attr == "config"
                and isinstance(base.value, ast.Name)
                and base.value.id == "self"
            ):
                reads.add(sub.attr)
        return reads
    return None


def check_keying(
    replan_source: str | None = None, planstore_source: str | None = None
) -> Report:
    """Lint the config-keying contract; returns a Report (never raises)."""
    rep = Report()
    if replan_source is None:
        replan_source = _module_source("repro_torch.core.replan")
    if planstore_source is None:
        planstore_source = _module_source("repro_torch.core.planstore")

    try:
        tree = ast.parse(replan_source)
    except SyntaxError as exc:
        rep.add("keying.parse", "replan.py", f"unparseable source: {exc}")
        return rep

    rep.tick()
    fields = _config_fields(tree, "ReplanConfig")
    if fields is None:
        rep.add("keying.parse", "ReplanConfig", "dataclass not found in replan source")
        return rep

    rep.tick()
    excluded = _excluded(tree)
    if excluded is None:
        rep.add(
            "keying.exclusion-list",
            "FINGERPRINT_EXCLUDED",
            "module-level dict literal not found: non-keyed config fields "
            "need an explicit, justified exclusion list",
        )
        excluded = {}

    rep.tick()
    keyed = _fingerprint_reads(tree)
    if keyed is None:
        rep.add(
            "keying.parse",
            "ReplanController._fingerprint",
            "no `self._fingerprint = ...` assignment found",
        )
        return rep

    for f in fields:
        rep.tick()
        if f in keyed and f in excluded:
            rep.add(
                "keying.contradiction",
                f"ReplanConfig.{f}",
                "both folded into the fingerprint and listed in "
                "FINGERPRINT_EXCLUDED -- one of the two is wrong",
            )
        elif f not in keyed and f not in excluded:
            rep.add(
                "keying.unkeyed",
                f"ReplanConfig.{f}",
                "neither folded into ReplanController._fingerprint nor named "
                "in FINGERPRINT_EXCLUDED: two controllers differing only in "
                "this knob would silently share stale plan-store entries",
            )
    for f in sorted(excluded):
        rep.tick()
        if f not in fields:
            rep.add(
                "keying.stale-exclusion",
                f"FINGERPRINT_EXCLUDED[{f!r}]",
                "excludes a field ReplanConfig no longer defines",
            )
            continue
        just = excluded[f]
        if not isinstance(just, str) or len(just.strip()) < MIN_JUSTIFICATION:
            rep.add(
                "keying.no-justification",
                f"FINGERPRINT_EXCLUDED[{f!r}]",
                f"exclusion needs a justification string (>= "
                f"{MIN_JUSTIFICATION} chars), got {just!r}",
            )
    for f in sorted(keyed - set(fields)):
        rep.tick()
        rep.add(
            "keying.unknown-field",
            f"ReplanController._fingerprint -> config.{f}",
            "fingerprint reads a field ReplanConfig does not define",
        )

    # --- PlanStore.get row vetoes
    try:
        stree = ast.parse(planstore_source)
    except SyntaxError as exc:
        rep.add("keying.parse", "planstore.py", f"unparseable source: {exc}")
        return rep
    get_fn = None
    for node in ast.walk(stree):
        if isinstance(node, ast.ClassDef) and node.name == "PlanStore":
            for stmt in node.body:
                if isinstance(stmt, ast.FunctionDef) and stmt.name == "get":
                    get_fn = stmt
    rep.tick()
    if get_fn is None:
        rep.add("keying.parse", "PlanStore.get", "method not found in planstore source")
        return rep
    names = {
        sub.id for sub in ast.walk(get_fn) if isinstance(sub, ast.Name)
    } | {sub.attr for sub in ast.walk(get_fn) if isinstance(sub, ast.Attribute)}
    rep.tick()
    if "canonical_key" not in names:
        rep.add(
            "keying.store-veto",
            "PlanStore.get",
            "canonical-key text comparison missing: a 64-bit hash collision "
            "would serve another operating point's plan",
        )
    rep.tick()
    if "schema_version" not in names:
        rep.add(
            "keying.store-veto",
            "PlanStore.get",
            "schema_version row check missing: rows written under an older "
            "plan schema would be served as current",
        )
    return rep
