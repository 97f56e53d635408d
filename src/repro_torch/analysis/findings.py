"""Typed findings and the lint-rule registry (the port of
``repro.analysis.findings``).

A rule is a named check with a fixed severity and scope:

- ``cell`` rules run once per exchange cell and receive a
  :class:`repro_torch.analysis.cells.CellContext`;
- ``source`` rules run once per analysis sweep over a source tree and
  receive a root path. The reference's source rules lint JAX code
  (``repro.analysis.pylint_jax``) and have no counterpart here, so no
  port rule has this scope.

Rules are registered by importing the module that defines them
(:mod:`repro_torch.analysis.rules`); the registry itself lives here so
that registration has no import cost beyond dataclasses.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

SEVERITIES = ("error", "warning", "info")
SCOPES = ("cell", "source")


@dataclass(frozen=True)
class Finding:
    """One machine-readable lint finding."""
    rule: str       # rule id, e.g. "bytes-match"
    severity: str   # "error" | "warning" | "info"
    cell: str       # "algo=spec" for cell rules, "path:line" for source
    message: str

    def to_json(self) -> dict:
        return asdict(self)


@dataclass(frozen=True)
class Rule:
    """A registered check. ``check`` returns a list of findings; an
    empty list means the rule passed (or did not apply)."""
    id: str
    severity: str
    scope: str
    doc: str
    check: callable

    def to_json(self) -> dict:
        return {"id": self.id, "severity": self.severity,
                "scope": self.scope, "doc": self.doc}


RULES: dict[str, Rule] = {}


def register_rule(rule_id: str, severity: str, scope: str = "cell"):
    """Decorator: register ``fn`` as rule ``rule_id``. The function's
    first docstring line becomes the rule's one-line description."""
    if severity not in SEVERITIES or scope not in SCOPES:
        raise ValueError(f"rule {rule_id!r}: severity {severity!r} or "
                         f"scope {scope!r} unknown")

    def deco(fn):
        doc = (fn.__doc__ or "").strip().splitlines()[0] if fn.__doc__ \
            else ""
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id!r}")
        RULES[rule_id] = Rule(rule_id, severity, scope, doc, fn)
        return fn
    return deco


def finding(rule_id: str, cell: str, message: str) -> Finding:
    """Build a Finding with the registered severity for ``rule_id``."""
    return Finding(rule_id, RULES[rule_id].severity, cell, message)


def max_severity(findings) -> str | None:
    """Worst severity present, or None for an empty list."""
    worst = None
    for f in findings:
        if worst is None or SEVERITIES.index(f.severity) < \
                SEVERITIES.index(worst):
            worst = f.severity
    return worst
