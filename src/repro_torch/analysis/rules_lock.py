"""LD0xx — lock discipline for the threaded servers (port of
``repro/analysis/rules_lock.py``).

The convention (documented in README "Static analysis"):

* every ``threading.Lock``/``RLock``/``Condition`` attribute created in
  ``__init__`` is a *lock attr*; ``Condition(self.lock)`` aliases the
  condition to its underlying lock (one canonical lock).
* a mutable shared field is annotated where it is created::

      self.results = {}        # guarded-by: self.cond

  and every read/write of that field elsewhere in the class must be
  lexically inside ``with self.cond:`` (or an aliased lock).
* a helper that is only ever called with the lock held is annotated on
  its ``def`` line with the same comment; its body is then checked with
  the lock assumed held (the *call sites* are the author's contract —
  this checker is lexical, not interprocedural, by design).

Rules:

    LD001  guarded field accessed outside its lock
    LD002  Condition.wait() not wrapped in a predicate loop (while)
    LD003  cross-module lock-acquisition-order cycle
    LD004  guarded-by annotation names an unknown lock attribute
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Optional

from .core import Finding, SourceFile, dotted_name, iter_functions

_GUARDED_RE = re.compile(r"guarded-by:\s*self\.([A-Za-z_][A-Za-z0-9_]*)")

_LOCK_CTORS = {"Lock", "RLock", "Condition"}
_EVENT_CTORS = {"Event"}

#: MetricsRegistry methods that take its internal ``_lock`` — resolved
#: heuristically at call sites on a ``REGISTRY``/``_reg`` receiver.
_REGISTRY_LOCKING = {"counter", "gauge", "histogram", "names", "snapshot",
                     "render_text", "clear", "_get"}
_REGISTRY_LOCK_NODE = "obsv.metrics.MetricsRegistry._lock"


@dataclasses.dataclass
class ClassLocks:
    """Lock topology of one class."""

    sf: SourceFile
    qual: str                              # module-relative class name
    locks: dict = dataclasses.field(default_factory=dict)   # attr -> canon
    events: set = dataclasses.field(default_factory=set)
    conditions: set = dataclasses.field(default_factory=set)
    guarded: dict = dataclasses.field(default_factory=dict)  # field -> canon
    held_methods: dict = dataclasses.field(default_factory=dict)

    def canon(self, attr: str) -> Optional[str]:
        return self.locks.get(attr)


def _collect_class(sf: SourceFile, cls: ast.ClassDef,
                   findings: list[Finding]) -> Optional[ClassLocks]:
    init = next((n for n in cls.body
                 if isinstance(n, ast.FunctionDef) and n.name == "__init__"),
                None)
    if init is None:
        return None
    info = ClassLocks(sf, cls.name)
    aliases: list[tuple[str, str]] = []     # (cond attr, underlying attr)
    for node in ast.walk(init):
        if not isinstance(node, ast.Assign):
            continue
        targets = [t for t in node.targets
                   if isinstance(t, ast.Attribute)
                   and isinstance(t.value, ast.Name)
                   and t.value.id == "self"]
        if not targets:
            continue
        v = node.value
        ctor = dotted_name(v.func).rsplit(".", 1)[-1] \
            if isinstance(v, ast.Call) else ""
        for t in targets:
            if ctor in _LOCK_CTORS:
                info.locks[t.attr] = f"{sf.rel}::{cls.name}.{t.attr}"
                if ctor == "Condition":
                    info.conditions.add(t.attr)
                    if isinstance(v, ast.Call) and v.args \
                            and isinstance(v.args[0], ast.Attribute) \
                            and isinstance(v.args[0].value, ast.Name) \
                            and v.args[0].value.id == "self":
                        aliases.append((t.attr, v.args[0].attr))
            elif ctor in _EVENT_CTORS:
                info.events.add(t.attr)
    for cond_attr, under in aliases:
        if under in info.locks:
            info.locks[cond_attr] = info.locks[under]
    # guarded-field annotations (trailing comment on the assignment line)
    for node in ast.walk(init):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        m = _GUARDED_RE.search(sf.comment_on(node.lineno))
        if not m:
            continue
        lock_attr = m.group(1)
        canon = info.canon(lock_attr)
        if canon is None:
            findings.append(Finding(
                "LD004", sf.rel, node.lineno,
                f"guarded-by names self.{lock_attr}, which is not a lock "
                f"attribute of {cls.name}",
                "annotate with a threading.Lock/Condition attr created "
                "in __init__"))
            continue
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            if isinstance(t, ast.Attribute) \
                    and isinstance(t.value, ast.Name) and t.value.id == "self":
                info.guarded[t.attr] = canon
    # held-method annotations (comment on the def line)
    for node in cls.body:
        if isinstance(node, ast.FunctionDef):
            # decorators shift lineno: scan def line and decorator lines
            for ln in range(node.lineno,
                            node.body[0].lineno if node.body else
                            node.lineno + 1):
                m = _GUARDED_RE.search(sf.comment_on(ln))
                if m:
                    canon = info.canon(m.group(1))
                    if canon is None:
                        findings.append(Finding(
                            "LD004", sf.rel, node.lineno,
                            f"guarded-by on {node.name}() names unknown "
                            f"lock self.{m.group(1)}", ""))
                    else:
                        info.held_methods[node.name] = canon
                    break
    return info


class _MethodChecker(ast.NodeVisitor):
    """LD001 within one method: guarded self.X access vs held locks."""

    def __init__(self, info: ClassLocks, fn: ast.FunctionDef,
                 findings: list[Finding]):
        self.info = info
        self.findings = findings
        self.held: list[str] = []
        if fn.name in info.held_methods:
            self.held.append(info.held_methods[fn.name])

    def _lock_of(self, expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self":
            return self.info.canon(expr.attr)
        return None

    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            c = self._lock_of(item.context_expr)
            if c is not None:
                acquired.append(c)
        self.held.extend(acquired)
        for s in node.body:
            self.visit(s)
        for _ in acquired:
            self.held.pop()

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            canon = self.info.guarded.get(node.attr)
            if canon is not None and canon not in self.held:
                self.findings.append(Finding(
                    "LD001", self.info.sf.rel, node.lineno,
                    f"self.{node.attr} is guarded-by "
                    f"{canon.rsplit('.', 1)[-1]} but accessed outside "
                    "the lock",
                    "move the access inside `with` on the guarding lock, "
                    "or annotate the enclosing helper as called-with-"
                    "lock-held"))
        self.generic_visit(node)


def _check_wait_loops(sf: SourceFile, cond_attrs: set[str],
                      findings: list[Finding]) -> None:
    """LD002: every ``<cond>.wait(...)`` lexically inside a While."""

    class V(ast.NodeVisitor):
        def __init__(self):
            self.while_depth = 0

        def visit_While(self, node):
            self.while_depth += 1
            self.generic_visit(node)
            self.while_depth -= 1

        def visit_FunctionDef(self, node):
            # a nested function resets the loop context
            saved, self.while_depth = self.while_depth, 0
            self.generic_visit(node)
            self.while_depth = saved

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Call(self, node):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "wait" \
                    and isinstance(f.value, ast.Attribute) \
                    and f.value.attr in cond_attrs \
                    and self.while_depth == 0:
                findings.append(Finding(
                    "LD002", sf.rel, node.lineno,
                    f"Condition {f.value.attr}.wait() outside a predicate "
                    "loop — wakeups are spurious and broadcast",
                    "wrap in `while not predicate(): cond.wait(...)`"))
            self.generic_visit(node)

    V().visit(sf.tree)


# -- lock acquisition-order graph ---------------------------------------------

def _module_imports(sf: SourceFile) -> dict[str, str]:
    """local name -> imported module tail (e.g. 'teleserve')."""
    out = {}
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


@dataclasses.dataclass
class _FnInfo:
    key: tuple                              # (rel, class or '', name)
    node: ast.FunctionDef
    cls: Optional[ClassLocks]
    sf: SourceFile
    acquires: set = dataclasses.field(default_factory=set)
    calls: set = dataclasses.field(default_factory=set)   # callee keys
    # (held_lock, acquired_lock_or_callee_key, line) resolved in fixpoint
    events: list = dataclasses.field(default_factory=list)


def _build_order_graph(files: list[SourceFile],
                       classes: dict[tuple, ClassLocks]
                       ) -> tuple[dict, list]:
    """→ (edges {(a, b): line_info}, functions) from nested acquisitions
    plus one level of heuristic call resolution, closed via fixpoint."""
    fns: dict[tuple, _FnInfo] = {}
    mod_of_rel = {sf.rel: sf for sf in files}
    # index functions
    for sf in files:
        imports = _module_imports(sf)
        for qual, node in iter_functions(sf.tree):
            parts = qual.split(".")
            cls = classes.get((sf.rel, parts[0])) if len(parts) > 1 else None
            key = (sf.rel, parts[0] if cls else "", parts[-1])
            fi = _FnInfo(key, node, cls, sf)
            fns[key] = fi
            _scan_fn(fi, imports, files)
    # fixpoint: propagate transitive acquisitions through calls
    acq: dict[tuple, set] = {k: set(f.acquires) for k, f in fns.items()}
    changed = True
    while changed:
        changed = False
        for k, f in fns.items():
            for callee in f.calls:
                extra = acq.get(callee, set()) - acq[k]
                if extra:
                    acq[k] |= extra
                    changed = True
    # edges: every (held, acquired) pair
    edges: dict[tuple, tuple] = {}
    for k, f in fns.items():
        for held, target, line in f.events:
            if isinstance(target, tuple):            # a call site
                for lock in acq.get(target, set()):
                    if lock != held:
                        edges.setdefault((held, lock), (f.sf.rel, line))
            elif target != held:
                edges.setdefault((held, target), (f.sf.rel, line))
    return edges, fns


def _scan_fn(fi: _FnInfo, imports: dict[str, str],
             files: list[SourceFile]) -> None:
    """Direct acquisitions, nested-acquisition events and call edges."""
    rel_by_tail = {}
    for sf in files:
        tail = sf.rel.rsplit("/", 1)[-1].removesuffix(".py")
        rel_by_tail.setdefault(tail, sf.rel)

    def lock_of(expr) -> Optional[str]:
        if fi.cls is not None and isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self":
            return fi.cls.canon(expr.attr)
        return None

    def callee_key(call: ast.Call) -> Optional[tuple]:
        f = call.func
        if isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name) and f.value.id == "self" \
                    and fi.cls is not None:
                return (fi.sf.rel, fi.cls.qual, f.attr)
            # REGISTRY.snapshot(...) / self._reg.histogram(...) /
            # metrics.REGISTRY.counter(...)
            d = dotted_name(f.value)
            if f.attr in _REGISTRY_LOCKING \
                    and (d.endswith("REGISTRY") or d.endswith("_reg")
                         or d.endswith("registry")):
                return ("__registry__",)
            # imported-module function: teleserve.handle_telemetry(...)
            if isinstance(f.value, ast.Name) and f.value.id in imports:
                mod_tail = imports[f.value.id].rsplit(".", 1)[-1]
                rel = rel_by_tail.get(mod_tail)
                if rel:
                    return (rel, "", f.attr)
        elif isinstance(f, ast.Name):
            return (fi.sf.rel, fi.cls.qual if fi.cls else "", f.id)
        return None

    held: list[str] = []
    if fi.cls is not None and fi.node.name in fi.cls.held_methods:
        held.append(fi.cls.held_methods[fi.node.name])
        fi.acquires.add(held[0])

    def walk(node):
        if isinstance(node, ast.With):
            acquired = []
            for item in node.items:
                c = lock_of(item.context_expr)
                if c is not None:
                    fi.acquires.add(c)
                    for h in held:
                        fi.events.append((h, c, item.context_expr.lineno))
                    acquired.append(c)
                else:
                    walk(item.context_expr)
            held.extend(acquired)
            for s in node.body:
                walk(s)
            for _ in acquired:
                held.pop()
            return
        if isinstance(node, ast.Call):
            key = callee_key(node)
            if key == ("__registry__",):
                fi.acquires.add(_REGISTRY_LOCK_NODE)
                for h in held:
                    fi.events.append((h, _REGISTRY_LOCK_NODE, node.lineno))
            elif key is not None:
                fi.calls.add(key)
                for h in held:
                    fi.events.append((h, key, node.lineno))
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue              # nested defs are separate functions
            walk(child)

    for s in fi.node.body:
        walk(s)


def _find_cycles(edges: dict) -> list[list[str]]:
    graph: dict[str, set] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    cycles, seen_cycles = [], set()
    for start in sorted(graph):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in sorted(graph.get(node, ())):
                if nxt == start and len(path) > 1:
                    key = frozenset(path)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        cycles.append(path + [start])
                elif nxt not in path and len(path) < 6:
                    stack.append((nxt, path + [nxt]))
    return cycles


# -- family entrypoint --------------------------------------------------------

def check(files: list[SourceFile], *, repo_mode: bool,
          stats: Optional[dict] = None) -> list[Finding]:
    findings: list[Finding] = []
    classes: dict[tuple, ClassLocks] = {}
    cond_attrs: set[str] = set()

    for sf in files:
        for node in sf.tree.body:
            if isinstance(node, ast.ClassDef):
                info = _collect_class(sf, node, findings)
                if info is not None:
                    classes[(sf.rel, node.name)] = info
                    cond_attrs |= info.conditions

    # LD001: guarded access in every method of an annotated class
    for (rel, _), info in classes.items():
        if not info.guarded:
            continue
        cls_node = next(n for n in info.sf.tree.body
                        if isinstance(n, ast.ClassDef) and n.name == info.qual)
        for m in cls_node.body:
            if isinstance(m, ast.FunctionDef) and m.name != "__init__":
                _MethodChecker(info, m, findings).visit(m)

    # LD002: Condition.wait without predicate loop (module-wide — wait
    # on an attr *named* like a known condition counts even across
    # classes, e.g. handle._state.cond.wait)
    for sf in files:
        if cond_attrs:
            _check_wait_loops(sf, cond_attrs, findings)

    # LD003: lock-order cycles
    edges, _ = _build_order_graph(files, classes)
    if stats is not None:
        stats["lock_order_edges"] = sorted(
            f"{a.rsplit('::', 1)[-1]} -> {b.rsplit('::', 1)[-1]}"
            for a, b in edges)
    for cycle in _find_cycles(edges):
        a, b = cycle[0], cycle[1]
        rel, line = edges.get((a, b), ("", 1))
        pretty = " -> ".join(c.rsplit("::", 1)[-1] for c in cycle)
        findings.append(Finding(
            "LD003", rel or files[0].rel, line,
            f"lock-acquisition-order cycle: {pretty}",
            "pick one global order for these locks and release before "
            "acquiring against it"))
    return findings
