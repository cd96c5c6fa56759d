"""TL0xx — telemetry naming discipline (port of
``repro/analysis/rules_telemetry.py``).

The observability plane fixed a convention: every metric and
span name is a **literal** string of the form ``plane.noun_unit`` —
lowercase dotted segments, e.g. ``coord.round_s``, ``embed.gather_us``,
``gnnserve.queue_depth``.  Literal names make the metric namespace
greppable and let this analyzer verify uniqueness statically; an
f-string name silently fragments a histogram into unbounded series.

Rules:

    TL001  metric/span name is not a string literal
    TL002  literal name does not match ``plane.noun_unit``
           (``^[a-z][a-z0-9_]*(\\.[a-z0-9_]+)+$``)
    TL003  the same metric name is registered from more than one module
           (two call sites mutating one series is almost always an
           aliasing accident; spans are exempt — re-entering a span
           name is normal)
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from .core import Finding, SourceFile, dotted_name

_METRIC_METHODS = {"counter", "gauge", "histogram"}
_SPAN_METHODS = {"span", "instant"}
_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_]+)+$")


def _is_registry_recv(value: ast.AST) -> bool:
    d = dotted_name(value)
    if not d:
        return False
    tail = d.split(".")[-1]
    return tail in ("REGISTRY", "_reg", "_registry", "registry")


def _is_trace_recv(value: ast.AST) -> bool:
    d = dotted_name(value)
    if not d:
        return False
    tail = d.split(".")[-1]
    return tail in ("TRACE", "_trace", "tracer")


def _telemetry_calls(sf: SourceFile):
    """Yield (kind, call) for metric registrations and span opens."""
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute):
            continue
        meth = node.func.attr
        if meth in _METRIC_METHODS and _is_registry_recv(node.func.value):
            yield "metric", node
        elif meth in _SPAN_METHODS and _is_trace_recv(node.func.value):
            yield "span", node


def check(files: list[SourceFile], *, repo_mode: bool,
          stats: Optional[dict] = None) -> list[Finding]:
    findings: list[Finding] = []
    # metric name -> [(rel, line)]
    registered: dict[str, list[tuple[str, int]]] = {}
    n_names = 0
    for sf in files:
        for kind, call in _telemetry_calls(sf):
            if not call.args:
                continue
            name_arg = call.args[0]
            n_names += 1
            if not (isinstance(name_arg, ast.Constant)
                    and isinstance(name_arg.value, str)):
                findings.append(Finding(
                    "TL001", sf.rel, call.lineno,
                    f"{kind} name passed to .{call.func.attr}() is not a "
                    "string literal — dynamic names fragment the series "
                    "and defeat static uniqueness checking",
                    "use a literal name; if the cardinality is genuinely "
                    "bounded, suppress with a justification"))
                continue
            name = name_arg.value
            if not _NAME_RE.match(name):
                findings.append(Finding(
                    "TL002", sf.rel, call.lineno,
                    f"{kind} name {name!r} does not match the "
                    "plane.noun_unit convention",
                    "lowercase dotted segments, e.g. 'coord.round_s'"))
            if kind == "metric":
                registered.setdefault(name, []).append((sf.rel, call.lineno))
    for name, sites in registered.items():
        mods = {rel for rel, _ in sites}
        if len(mods) > 1:
            for rel, line in sites[1:]:
                findings.append(Finding(
                    "TL003", rel, line,
                    f"metric {name!r} is also registered in "
                    f"{sorted(mods - {rel})[0]} — cross-module aliasing "
                    "of one series",
                    "register each metric from a single owning module "
                    "and import the handle"))
    if stats is not None:
        stats["telemetry_names"] = n_names
    return findings
