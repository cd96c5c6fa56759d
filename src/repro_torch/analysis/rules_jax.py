"""JX0xx / TM0xx — JAX-Pallas tracing hygiene and timing discipline
(port of ``repro/analysis/rules_jax.py``: the same rules over the JAX
reference package's code, and TM001 over every file).

Traced scope is discovered per module: functions decorated with
``@jax.jit`` (bare, ``functools.partial(jax.jit, ...)``), functions
wrapped at call sites (``self._step = jax.jit(_step)``, including
lambdas), and kernels passed to ``pl.pallas_call`` — closed over
same-module calls (a helper called from a jitted function traces too).

Rules:

    JX001  host-numpy call inside traced code (np.* runs at trace time
           or forces a device sync — use jnp)
    JX002  .item() / float()/int()/bool() on a traced value (forces a
           blocking device→host transfer and breaks tracing)
    JX003  shape-derived python scalar captured by a traced closure
           (every new value recompiles — pass it through the
           row_buckets() padded path or as a static argname)
    TM001  time.time() — wall clock is not monotonic; durations must
           use time.perf_counter(), deadlines time.monotonic()
"""

from __future__ import annotations

import ast
from typing import Optional

from .core import Finding, SourceFile, dotted_name, iter_functions


def _np_alias(sf: SourceFile) -> Optional[str]:
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    return a.asname or "numpy"
    return None


def _is_jit_deco(node: ast.AST) -> bool:
    d = dotted_name(node)
    if d.endswith("jax.jit") or d == "jit":
        return True
    if isinstance(node, ast.Call):
        f = dotted_name(node.func)
        if f.endswith("jax.jit") or f == "jit":
            return True
        if f.endswith("partial") and node.args \
                and dotted_name(node.args[0]).endswith("jit"):
            return True
    return False


def traced_functions(sf: SourceFile) -> dict[str, ast.FunctionDef]:
    """{qualname: node} of every function whose body runs under trace."""
    by_name: dict[str, list[tuple[str, ast.FunctionDef]]] = {}
    traced: dict[str, ast.FunctionDef] = {}
    fns = list(iter_functions(sf.tree))
    for qual, node in fns:
        by_name.setdefault(node.name, []).append((qual, node))
        if any(_is_jit_deco(d) for d in node.decorator_list):
            traced[qual] = node
    # call-site forms: jax.jit(<name>), pl.pallas_call(<name>, ...)
    for wrapper in ast.walk(sf.tree):
        if not isinstance(wrapper, ast.Call):
            continue
        d = dotted_name(wrapper.func)
        target = None
        if (d.endswith("jax.jit") or d == "jit") and wrapper.args:
            target = wrapper.args[0]
        elif d.endswith("pallas_call") and wrapper.args:
            target = wrapper.args[0]
        if target is None:
            continue
        if isinstance(target, ast.Name):
            for qual, node in by_name.get(target.id, []):
                traced[qual] = node
        elif isinstance(target, ast.Call):
            # jax.jit(jax.vmap(f)) and friends
            inner = target
            while isinstance(inner, ast.Call) and inner.args:
                cand = inner.args[0]
                if isinstance(cand, ast.Name):
                    for qual, node in by_name.get(cand.id, []):
                        traced[qual] = node
                    break
                inner = cand if isinstance(cand, ast.Call) else None
                if inner is None:
                    break
    # same-module reachability: helpers called from traced functions
    qual_of = {q: n for q, n in fns}
    work = list(traced)
    while work:
        q = work.pop()
        node = traced[q]
        for call in ast.walk(node):
            if not isinstance(call, ast.Call):
                continue
            callee = None
            if isinstance(call.func, ast.Name):
                callee = call.func.id
            elif isinstance(call.func, ast.Attribute) \
                    and isinstance(call.func.value, ast.Name) \
                    and call.func.value.id == "self":
                callee = call.func.attr
            if callee is None:
                continue
            for cq, cn in by_name.get(callee, []):
                if cq not in traced:
                    traced[cq] = cn
                    work.append(cq)
    return traced


def traced_lambdas(sf: SourceFile) -> list[ast.Lambda]:
    out = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call) \
                and (dotted_name(node.func).endswith("jax.jit")
                     or dotted_name(node.func) == "jit") \
                and node.args and isinstance(node.args[0], ast.Lambda):
            out.append(node.args[0])
    return out


_SHAPE_DERIVED = ("len",)


def _is_shape_derived(expr: ast.AST) -> bool:
    """RHS forms that produce a python int from an array's geometry."""
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name) \
            and expr.func.id in ("len", "int"):
        if expr.func.id == "int" and expr.args:
            return _is_shape_derived(expr.args[0])
        return True
    if isinstance(expr, ast.Subscript):
        return _is_shape_derived(expr.value)
    if isinstance(expr, ast.Attribute) and expr.attr in ("shape", "ndim",
                                                         "size"):
        return True
    if isinstance(expr, ast.BinOp):
        return _is_shape_derived(expr.left) or _is_shape_derived(expr.right)
    return False


def _check_traced_body(sf: SourceFile, qual: str, body: ast.AST,
                       np_alias: Optional[str],
                       findings: list[Finding]) -> None:
    for node in ast.walk(body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not isinstance(node, ast.Call):
            continue
        d = dotted_name(node.func)
        # JX001: np.something(...) — attribute *reads* like np.int32
        # (dtype literals) are fine, calls are not
        if np_alias and d.startswith(np_alias + "."):
            findings.append(Finding(
                "JX001", sf.rel, node.lineno,
                f"host-numpy call {d}() inside traced function {qual}",
                "use jnp (or hoist the computation out of the traced "
                "scope)"))
        # JX002: .item() / float()/int()/bool() on a non-constant
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "item" and not node.args:
            findings.append(Finding(
                "JX002", sf.rel, node.lineno,
                f".item() inside traced function {qual} forces a "
                "device sync",
                "keep the value as a traced array"))
        if isinstance(node.func, ast.Name) \
                and node.func.id in ("float", "int", "bool") \
                and node.args and not isinstance(node.args[0], ast.Constant):
            # int(x) on shape attrs is static and fine; anything else
            # concretizes a tracer
            if not _is_shape_derived(node.args[0]):
                findings.append(Finding(
                    "JX002", sf.rel, node.lineno,
                    f"{node.func.id}() on a value inside traced function "
                    f"{qual} concretizes the tracer",
                    "trace it (jnp.asarray) or mark the arg static"))


def _check_closure_captures(sf: SourceFile, qual: str,
                            node: ast.FunctionDef,
                            enclosing: ast.FunctionDef,
                            findings: list[Finding]) -> None:
    """JX003: shape-derived ints captured from the enclosing scope."""
    bound: set[str] = {a.arg for a in node.args.args}
    bound |= {a.arg for a in node.args.kwonlyargs}
    if node.args.vararg:
        bound.add(node.args.vararg.arg)
    if node.args.kwarg:
        bound.add(node.args.kwarg.arg)
    for n in ast.walk(node):
        if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in targets:
                for leaf in ast.walk(t):
                    if isinstance(leaf, ast.Name):
                        bound.add(leaf.id)
    free = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                and n.id not in bound:
            free.add(n.id)
    # enclosing-scope assignments of free names
    for n in enclosing.body:
        if not isinstance(n, ast.Assign):
            continue
        for t in n.targets:
            if isinstance(t, ast.Name) and t.id in free \
                    and _is_shape_derived(n.value):
                findings.append(Finding(
                    "JX003", sf.rel, node.lineno,
                    f"traced function {qual} closes over shape-derived "
                    f"python scalar {t.id!r} — every new value is a "
                    "fresh compile",
                    "route dynamic sizes through the bucketed pad path "
                    "(kernels.quantize.row_buckets) or a static_argname"))


def check(files: list[SourceFile], *, repo_mode: bool,
          stats: Optional[dict] = None) -> list[Finding]:
    findings: list[Finding] = []
    n_traced = 0
    for sf in files:
        np_alias = _np_alias(sf)
        traced = traced_functions(sf)
        n_traced += len(traced)
        enclosing_of: dict[str, ast.FunctionDef] = {}
        for q, node in iter_functions(sf.tree):
            for cq in traced:
                if cq.startswith(q + ".") and cq.count(".") == q.count(".") + 1:
                    enclosing_of[cq] = node
        for qual, node in traced.items():
            _check_traced_body(sf, qual, node, np_alias, findings)
            if qual in enclosing_of:
                _check_closure_captures(sf, qual, node,
                                        enclosing_of[qual], findings)
        for lam in traced_lambdas(sf):
            _check_traced_body(sf, "<lambda>", lam, np_alias, findings)
    if stats is not None:
        stats["traced_functions"] = n_traced
    return findings


def check_timing(files: list[SourceFile], *, repo_mode: bool,
                 stats: Optional[dict] = None) -> list[Finding]:
    """TM001, repo-wide: no wall-clock time.time()."""
    findings: list[Finding] = []
    for sf in files:
        time_aliases = {"time"}
        from_time = set()
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "time":
                        time_aliases.add(a.asname or "time")
            elif isinstance(node, ast.ImportFrom) and node.module == "time":
                for a in node.names:
                    if a.name == "time":
                        from_time.add(a.asname or "time")
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func)
            hit = any(d == f"{alias}.time" for alias in time_aliases) \
                or (isinstance(node.func, ast.Name)
                    and node.func.id in from_time)
            if hit:
                findings.append(Finding(
                    "TM001", sf.rel, node.lineno,
                    "time.time() is wall clock — NTP steps it backwards "
                    "mid-measurement",
                    "use time.perf_counter() for durations, "
                    "time.monotonic() for deadlines"))
    return findings
