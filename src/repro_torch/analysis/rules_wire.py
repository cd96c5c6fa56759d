"""WP0xx — wire-protocol conformance across the eight TCP planes.

Port of ``repro/analysis/rules_wire.py``.  Each package has four
planes: the embedding exchange (``exchange/wire.py``), the federated
control plane (``fedsvc/protocol.py``), the scoring frontend
(``gnnserve/wire.py``) and the dynamic-graph barrier
(``dyngraph/wire.py``).  They share one length-prefixed framing but own
disjoint opcode ranges.  The JAX package names its opcodes ``OP_*``;
the port keeps the same values under ``PT_OP_*`` names, so a twin
plane of the other package shares its values by design and collisions
(WP001) are checked within each package's planes.  Nothing at runtime
checks that the dispatch tables stay disjoint, that every opcode has
exactly one builder and one handler branch, or that a builder's
``struct`` pack sequence still matches its parser's unpack sequence —
this module does, symbolically, from the AST.

Rules:

    WP001  opcode value collides with another plane's opcode
    WP002  opcode value outside its plane's reserved range
    WP003  opcode without exactly one request builder / parser branch
    WP004  opcode without exactly one server dispatch branch
    WP005  builder byte layout != parser byte layout (field-for-field)
    WP006  OP_* / PT_OP_* constant name defined in more than one module
    WP007  opcode value differs from the pinned registry below
    WP008  builder/parser construct the checker cannot verify

The pinned registry (also the README reservation table) is what makes
WP007 catch *any* opcode renumbering, including to an unused in-range
value that every relative check would accept.

Byte layouts are compared as token sequences extracted symbolically:
``_U16.pack(x)`` ↔ ``_U16.unpack_from(view, off)`` both become a
``u16`` token, ``np.ascontiguousarray(x, np.int64).tobytes()`` ↔
``np.frombuffer(view, np.int64, ...)`` both become ``i64[]``, loops
and generator joins become repeat groups, JSON/tensor-block helpers
become opaque-but-typed tokens.  A parser's calls of its own module's
helpers are inlined, as a builder's are, and a branch that serves
several opcodes (``op in (A, B)``) is read once for each, folding the
inner ``if op == A`` tests.  Offsets are *not* modelled — the
invariant checked is the field type sequence, which is exactly what
drifts when someone edits one end of the wire.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Optional

from .core import Finding, SourceFile, dotted_name

# -- pinned opcode registry ---------------------------------------------------
#
# One row per plane: reserved range and the name→value table the wire
# module must match exactly.  Editing a wire module's opcode requires
# editing this table in the same change — which is the point.

@dataclasses.dataclass(frozen=True)
class PlaneSpec:
    name: str
    wire_rel: str                       # module defining opcodes/builders
    parser: str                         # request-parse function name
    handler_rel: str                    # module containing dispatch branches
    lo: int
    hi: int
    opcodes: dict                       # name -> value (pinned)
    reserved: frozenset                 # telemetry names: no builder/branch
    shared_handled: frozenset           # other planes' opcodes it dispatches
    builder_style: str = "functions"    # or "rpc_callsites"
    parent_rel: str = ""                # module it imports framing/structs from

    @property
    def package(self) -> str:
        """The package the plane belongs to (``repro`` or
        ``repro_torch``): opcode values are unique within it."""
        return self.wire_rel.split("/")[1]


PLANES = (
    PlaneSpec(
        name="exchange",
        wire_rel="src/repro/exchange/wire.py",
        parser="parse_request",
        handler_rel="src/repro/launch/embed_server.py",
        lo=1, hi=15,
        opcodes={"OP_REGISTER": 1, "OP_WRITE": 2, "OP_GATHER": 3,
                 "OP_EMBED_STATS": 4, "OP_EMBED_SHUTDOWN": 5,
                 "OP_VGATHER": 6, "OP_METRICS": 14, "OP_TRACE": 15},
        reserved=frozenset({"OP_METRICS", "OP_TRACE"}),
        shared_handled=frozenset(),
    ),
    PlaneSpec(
        name="fedsvc",
        wire_rel="src/repro/fedsvc/protocol.py",
        parser="parse_body",
        handler_rel="src/repro/fedsvc/coordinator.py",
        lo=16, hi=31,
        opcodes={"OP_HELLO": 16, "OP_GET_MODEL": 17, "OP_PULLED": 18,
                 "OP_WAIT_PULLED": 19, "OP_UPDATE": 20,
                 "OP_COORD_STATS": 21, "OP_COORD_SHUTDOWN": 22},
        reserved=frozenset(),
        shared_handled=frozenset(),
        builder_style="rpc_callsites",
    ),
    PlaneSpec(
        name="gnnserve",
        wire_rel="src/repro/gnnserve/wire.py",
        parser="parse_serve_request",
        handler_rel="src/repro/gnnserve/frontend.py",
        lo=32, hi=47,
        opcodes={"OP_PREDICT": 32, "OP_SSTATS": 33},
        reserved=frozenset(),
        shared_handled=frozenset({"OP_EMBED_SHUTDOWN"}),
        parent_rel="src/repro/exchange/wire.py",
    ),
    PlaneSpec(
        name="dyngraph",
        wire_rel="src/repro/dyngraph/wire.py",
        parser="parse_growth_request",
        # the dispatch branch lives in the wire module's own parser;
        # fedsvc's coordinator routes the whole 48..63 band there by
        # range, without naming individual opcodes
        handler_rel="src/repro/dyngraph/wire.py",
        lo=48, hi=63,
        opcodes={"OP_GROWTH": 48},
        reserved=frozenset(),
        shared_handled=frozenset(),
    ),
    # the port's twins: the same values under PT_OP_* names
    PlaneSpec(
        name="pt_exchange",
        wire_rel="src/repro_torch/exchange/wire.py",
        parser="parse_request",
        handler_rel="src/repro_torch/launch/embed_server.py",
        lo=1, hi=15,
        opcodes={"PT_OP_REGISTER": 1, "PT_OP_WRITE": 2, "PT_OP_GATHER": 3,
                 "PT_OP_EMBED_STATS": 4, "PT_OP_EMBED_SHUTDOWN": 5,
                 "PT_OP_VGATHER": 6, "PT_OP_METRICS": 14,
                 "PT_OP_TRACE": 15},
        reserved=frozenset({"PT_OP_METRICS", "PT_OP_TRACE"}),
        shared_handled=frozenset(),
    ),
    PlaneSpec(
        name="pt_fedsvc",
        wire_rel="src/repro_torch/fedsvc/protocol.py",
        parser="parse_body",
        handler_rel="src/repro_torch/fedsvc/coordinator.py",
        lo=16, hi=31,
        opcodes={"PT_OP_HELLO": 16, "PT_OP_GET_MODEL": 17,
                 "PT_OP_PULLED": 18, "PT_OP_WAIT_PULLED": 19,
                 "PT_OP_UPDATE": 20, "PT_OP_COORD_STATS": 21,
                 "PT_OP_COORD_SHUTDOWN": 22},
        reserved=frozenset(),
        shared_handled=frozenset(),
        builder_style="rpc_callsites",
    ),
    PlaneSpec(
        name="pt_gnnserve",
        wire_rel="src/repro_torch/gnnserve/wire.py",
        parser="parse_serve_request",
        handler_rel="src/repro_torch/gnnserve/frontend.py",
        lo=32, hi=47,
        opcodes={"PT_OP_PREDICT": 32, "PT_OP_SSTATS": 33},
        reserved=frozenset(),
        shared_handled=frozenset({"PT_OP_EMBED_SHUTDOWN"}),
        parent_rel="src/repro_torch/exchange/wire.py",
    ),
    PlaneSpec(
        name="pt_dyngraph",
        wire_rel="src/repro_torch/dyngraph/wire.py",
        parser="parse_growth_request",
        handler_rel="src/repro_torch/dyngraph/wire.py",
        lo=48, hi=63,
        opcodes={"PT_OP_GROWTH": 48},
        reserved=frozenset(),
        shared_handled=frozenset(),
    ),
)

#: opcode names every plane answers via obsv.teleserve before dispatch
TELEMETRY_OPS = frozenset({"OP_METRICS", "OP_TRACE",
                           "PT_OP_METRICS", "PT_OP_TRACE"})

#: name prefixes of opcode constants: the JAX package's and the port's
OPCODE_PREFIXES = ("OP_", "PT_OP_")


def is_op_name(name: str) -> bool:
    return name.startswith(OPCODE_PREFIXES)


# -- symbolic byte-layout tokens ----------------------------------------------
#
# tokens:  ('u8'|'u16'|'u32'|'u64')            fixed-width scalar
#          ('arr', dtype)                      raw ndarray bytes ('?' = any)
#          ('op',)                             the leading opcode byte
#          ('bytes',)                          length-delimited byte string
#          ('json',)                           JSON blob
#          ('tensors',)                        build_tensors/parse_tensors
#          ('blocks',)                         opaque payload tail
#          ('rep', [tokens])                   repeated group (loop/genexp)
#          ('opt', [tokens])                   optional tail (if-guarded)
#          ('?', reason)                       unverifiable construct

_FMT_TOK = {"B": "u8", "H": "u16", "I": "u32", "L": "u32",
            "Q": "u64", "q": "u64", "i": "u32", "h": "u16", "b": "u8"}


def render_tokens(tokens) -> str:
    out = []
    for t in tokens:
        if isinstance(t, str):
            out.append(t)
        elif t[0] == "arr":
            out.append(f"{t[1]}[]")
        elif t[0] in ("rep", "opt"):
            out.append(f"{t[0]}({render_tokens(t[1])})")
        elif t[0] == "op":
            out.append("op")
        elif t[0] == "?":
            out.append(f"?<{t[1]}>")
        else:
            out.append(t[0])
    return " ".join(out) if out else "∅"


def tokens_match(a, b) -> bool:
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        xs = isinstance(x, str)
        ys = isinstance(y, str)
        if xs != ys:
            return False
        if xs:
            if x != y:
                return False
            continue
        if x[0] != y[0]:
            return False
        if x[0] == "arr":
            if x[1] != "?" and y[1] != "?" and x[1] != y[1]:
                return False
        elif x[0] in ("rep", "opt"):
            if not tokens_match(x[1], y[1]):
                return False
        elif x[0] == "?":
            return False              # unverifiable never matches
    return True


def has_unverifiable(tokens) -> Optional[str]:
    for t in tokens:
        if isinstance(t, str):
            continue
        if t[0] == "?":
            return t[1]
        if t[0] in ("rep", "opt"):
            r = has_unverifiable(t[1])
            if r:
                return r
    return None


class _Module:
    """Symbol tables of one wire module needed for token extraction."""

    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.structs: dict[str, str] = {}      # name -> struct fmt chars
        self.op_consts: dict[str, int] = {}    # module-level OP_* = int
        self.imported_ops: set[str] = set()    # OP_* imported from elsewhere
        self.imported_names: set[str] = set()  # every name imported-from
        self.functions: dict[str, ast.FunctionDef] = {}
        self.np_alias = "np"
        for node in sf.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                v = node.value
                if isinstance(v, ast.Call) \
                        and dotted_name(v.func).endswith("struct.Struct") \
                        and v.args and isinstance(v.args[0], ast.Constant) \
                        and isinstance(v.args[0].value, str):
                    fmt = v.args[0].value.lstrip("<>!=@")
                    self.structs[name] = fmt
                elif is_op_name(name) and isinstance(v, ast.Constant) \
                        and isinstance(v.value, int):
                    self.op_consts[name] = v.value
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    self.imported_names.add(a.asname or a.name)
                    if is_op_name(a.name):
                        self.imported_ops.add(a.asname or a.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "numpy":
                        self.np_alias = a.asname or "numpy"
            elif isinstance(node, ast.FunctionDef):
                self.functions[node.name] = node

    def struct_tokens(self, name: str) -> Optional[list]:
        fmt = self.structs.get(name)
        if fmt is None:
            return None
        out = []
        for ch in fmt:
            tok = _FMT_TOK.get(ch)
            if tok is None:
                return None
            out.append(tok)
        return out

    def op_name(self, node: ast.AST) -> Optional[str]:
        """The OP_* / PT_OP_* symbol an expression refers to, if any."""
        return _op_ref(node)


_NP_DTYPES = {"int8", "int16", "int32", "int64", "uint8", "uint16",
              "uint32", "uint64", "float16", "float32", "float64"}


def _np_dtype(mod: _Module, node: ast.AST) -> Optional[str]:
    d = dotted_name(node)
    if d.startswith(mod.np_alias + "."):
        tail = d[len(mod.np_alias) + 1:]
        if tail in _NP_DTYPES:
            return tail
    return None


# -- builder-side extraction --------------------------------------------------

class _BuilderCtx:
    def __init__(self, mod: _Module, depth: int = 0):
        self.mod = mod
        self.env: dict[str, list] = {}   # local name -> tokens
        self.depth = depth


def _builder_expr(node: ast.AST, ctx: _BuilderCtx) -> list:
    """Token sequence a builder expression contributes to the wire."""
    mod = ctx.mod
    if isinstance(node, ast.Constant):
        if node.value == b"":
            return []
        if isinstance(node.value, bytes):
            return [("bytes",)]
        return [("?", f"constant {node.value!r}")]
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _builder_expr(node.left, ctx) + _builder_expr(node.right, ctx)
    if isinstance(node, ast.Name):
        if node.id in ctx.env:
            return ctx.env[node.id]
        return [("blocks",)]         # parameter: opaque payload tail
    if isinstance(node, ast.IfExp):
        body = _builder_expr(node.body, ctx)
        orelse = _builder_expr(node.orelse, ctx)
        if not orelse:
            return [("opt", body)]
        if not body:
            return [("opt", orelse)]
        return [("?", "two-armed conditional payload")]
    if isinstance(node, ast.Call):
        return _builder_call(node, ctx)
    return [("?", f"builder expr {type(node).__name__}")]


def _builder_call(node: ast.Call, ctx: _BuilderCtx) -> list:
    mod = ctx.mod
    fn = node.func
    # bytes([op])
    if isinstance(fn, ast.Name) and fn.id == "bytes" and node.args:
        a = node.args[0]
        if isinstance(a, (ast.List, ast.Tuple)) and len(a.elts) == 1:
            return [("op",)]
        return [("bytes",)]
    if isinstance(fn, ast.Attribute):
        recv, meth = fn.value, fn.attr
        # <struct>.pack(...)
        if meth == "pack" and isinstance(recv, ast.Name):
            toks = mod.struct_tokens(recv.id)
            if toks is None:
                return [("?", f"unknown struct {recv.id}")]
            if len(toks) == 1 and toks[0] == "u8" and node.args:
                if mod.op_name(node.args[0]):
                    return [("op",)]
            return list(toks)
        # <expr>.tobytes()
        if meth == "tobytes":
            return [_array_token(recv, ctx)]
        # b"".join(X)
        if meth == "join" and isinstance(recv, ast.Constant) \
                and recv.value == b"" and node.args:
            x = node.args[0]
            if isinstance(x, (ast.GeneratorExp, ast.ListComp)):
                return [("rep", _builder_expr(x.elt, ctx))]
            if isinstance(x, ast.Name) and x.id in ctx.env:
                return ctx.env[x.id]
            return [("blocks",)]
        # json.dumps(...).encode(...)
        if meth == "encode":
            if isinstance(recv, ast.Call) \
                    and dotted_name(recv.func) == "json.dumps":
                return [("json",)]
            return [("bytes",)]
        # wire.build_tensors(...) / module-qualified helper
        if meth == "build_tensors":
            return [("tensors",)]
    # local helper call: inline (depth-limited)
    if isinstance(fn, ast.Name) and fn.id in mod.functions:
        if ctx.depth >= 3:
            return [("?", f"helper {fn.id} nests too deep")]
        return function_build_tokens(mod, mod.functions[fn.id],
                                     depth=ctx.depth + 1)
    if isinstance(fn, ast.Name) and fn.id == "build_tensors":
        return [("tensors",)]
    return [("?", f"builder call {dotted_name(fn) or '<expr>'}")]


def _array_token(recv: ast.AST, ctx: _BuilderCtx):
    """Token for ``<recv>.tobytes()``."""
    if isinstance(recv, ast.Call):
        d = dotted_name(recv.func)
        if d in (f"{ctx.mod.np_alias}.ascontiguousarray",
                 f"{ctx.mod.np_alias}.asarray"):
            if len(recv.args) >= 2:
                dt = _np_dtype(ctx.mod, recv.args[1])
                return ("arr", dt or "?")
            return ("arr", "?")
    return ("arr", "?")


def function_build_tokens(mod: _Module, fn: ast.FunctionDef,
                          *, depth: int = 0) -> list:
    """Byte layout a ``build_*`` function emits.

    Two shapes are understood: a single ``return <expr>`` (possibly
    after local assignments), and the accumulator idiom (``out = [...]``
    then ``out.append/extend`` in loops, returned via ``b"".join(out)``).
    """
    ctx = _BuilderCtx(mod, depth)
    acc_name: Optional[str] = None
    acc_tokens: list = []

    def stmt(s: ast.stmt) -> Optional[list]:
        nonlocal acc_name
        if isinstance(s, ast.Assign) and len(s.targets) == 1 \
                and isinstance(s.targets[0], ast.Name):
            name = s.targets[0].id
            if isinstance(s.value, ast.List):
                acc_name = name
                for e in s.value.elts:
                    acc_tokens.extend(_builder_expr(e, ctx))
            else:
                ctx.env[name] = _builder_expr(s.value, ctx)
            return None
        if isinstance(s, ast.Expr) and isinstance(s.value, ast.Call) \
                and isinstance(s.value.func, ast.Attribute) \
                and isinstance(s.value.func.value, ast.Name) \
                and s.value.func.value.id == acc_name:
            meth = s.value.func.attr
            if meth == "append" and s.value.args:
                acc_tokens.extend(_builder_expr(s.value.args[0], ctx))
            elif meth == "extend" and s.value.args:
                a = s.value.args[0]
                if isinstance(a, (ast.GeneratorExp, ast.ListComp)):
                    acc_tokens.append(("rep", _builder_expr(a.elt, ctx)))
                else:
                    acc_tokens.append(("?", "extend of non-comprehension"))
            return None
        if isinstance(s, ast.AugAssign) and isinstance(s.target, ast.Name) \
                and s.target.id in ctx.env:
            ctx.env[s.target.id] = (ctx.env[s.target.id]
                                    + _builder_expr(s.value, ctx))
            return None
        if isinstance(s, ast.For):
            start = len(acc_tokens)
            for inner in s.body:
                r = stmt(inner)
                if r is not None:
                    return r
            loop_toks = acc_tokens[start:]
            del acc_tokens[start:]
            if loop_toks:
                acc_tokens.append(("rep", loop_toks))
            return None
        if isinstance(s, ast.If) and acc_name is not None \
                and _appends_to(s, acc_name):
            acc_tokens.append(("?", "conditional append to accumulator"))
            return None
        if isinstance(s, ast.Return) and s.value is not None:
            v = s.value
            if acc_name is not None and isinstance(v, ast.Call) \
                    and isinstance(v.func, ast.Attribute) \
                    and v.func.attr == "join" \
                    and v.args and isinstance(v.args[0], ast.Name) \
                    and v.args[0].id == acc_name:
                return acc_tokens
            return _builder_expr(v, ctx)
        if isinstance(s, (ast.Assert, ast.Pass, ast.Expr, ast.AugAssign,
                          ast.If, ast.AnnAssign)):
            return None               # docstrings, asserts, guards
        return [("?", f"builder statement {type(s).__name__}")]

    for s in fn.body:
        r = stmt(s)
        if r is not None:
            return r
    return [("?", "builder without return")]


def _appends_to(node: ast.AST, acc_name: str) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in ("append", "extend") \
                and isinstance(n.func.value, ast.Name) \
                and n.func.value.id == acc_name:
            return True
    return False


# -- parser-side extraction ---------------------------------------------------

class _ParserWalker:
    """Collect wire-read tokens from parser statements, in source order.

    ``op_var`` names the parser's opcode variable and ``op`` the opcode
    whose branch is being read: inside it, ``if op == X`` / ``op in
    (...)`` tests are decided statically.  Calls of the module's own
    functions are inlined (depth-limited), as on the builder side."""

    def __init__(self, mod: _Module, view_names: set[str], *,
                 depth: int = 0):
        self.mod = mod
        self.views = view_names
        self.depth = depth
        self.op_var: Optional[str] = None
        self.op: Optional[str] = None

    def _decided(self, test: ast.AST) -> Optional[bool]:
        """The value of an opcode test inside the branch of ``self.op``,
        or None when the test is anything else."""
        if self.op is None or not isinstance(test, ast.Compare) \
                or len(test.ops) != 1 \
                or not isinstance(test.left, ast.Name) \
                or test.left.id != self.op_var:
            return None
        cmp, how = test.comparators[0], test.ops[0]
        if isinstance(how, (ast.Eq, ast.NotEq)):
            n = self.mod.op_name(cmp)
            if n is None:
                return None
            return (n == self.op) == isinstance(how, ast.Eq)
        if isinstance(how, (ast.In, ast.NotIn)) \
                and isinstance(cmp, (ast.Tuple, ast.List)):
            names = [self.mod.op_name(el) for el in cmp.elts]
            if not all(names):
                return None
            return (self.op in names) == isinstance(how, ast.In)
        return None

    def _is_view_slice(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id in self.views
                and isinstance(node.slice, ast.Slice))

    def stmts(self, body: list) -> list:
        out: list = []
        for s in body:
            out.extend(self.stmt(s))
        return out

    def stmt(self, s: ast.stmt) -> list:
        if isinstance(s, ast.Assign):
            # `view = memoryview(body)` registers another view name
            if isinstance(s.value, ast.Call) \
                    and isinstance(s.value.func, ast.Name) \
                    and s.value.func.id == "memoryview" \
                    and len(s.targets) == 1 \
                    and isinstance(s.targets[0], ast.Name):
                self.views.add(s.targets[0].id)
                return []
            return self.expr(s.value)
        if isinstance(s, (ast.AugAssign, ast.AnnAssign)):
            return self.expr(s.value) if s.value is not None else []
        if isinstance(s, ast.Expr):
            return self.expr(s.value)
        if isinstance(s, ast.Return):
            return self.expr(s.value) if s.value is not None else []
        if isinstance(s, ast.For):
            inner = self.stmts(s.body)
            return [("rep", inner)] if inner else []
        if isinstance(s, ast.While):
            inner = self.stmts(s.body)
            return [("rep", inner)] if inner else []
        if isinstance(s, ast.If):
            decided = self._decided(s.test)
            if decided is not None:
                return self.stmts(s.body if decided else s.orelse)
            body = self.stmts(s.body)
            orelse = self.stmts(s.orelse)
            if body and orelse:
                return [("?", "two-armed conditional parse")]
            inner = body or orelse
            return [("opt", inner)] if inner else []
        if isinstance(s, (ast.Raise, ast.Pass, ast.Assert)):
            return []
        if isinstance(s, (ast.FunctionDef, ast.ClassDef)):
            return []
        return [("?", f"parser statement {type(s).__name__}")]

    def expr(self, e: ast.AST) -> list:
        mod = self.mod
        if isinstance(e, ast.Call):
            fn = e.func
            d = dotted_name(fn)
            if d == "json.loads":
                return [("json",)]
            if d.endswith("parse_tensors") or d == "parse_tensors":
                return [("tensors",)]
            if isinstance(fn, ast.Attribute):
                # unwrap value-shaping chains: .reshape(...).copy() etc.
                if fn.attr in ("copy", "reshape", "astype", "tolist"):
                    return self.expr(fn.value)
                if fn.attr in ("unpack_from", "unpack") \
                        and isinstance(fn.value, ast.Name):
                    toks = mod.struct_tokens(fn.value.id)
                    if toks is None:
                        return [("?", f"unknown struct {fn.value.id}")]
                    return list(toks)
                if fn.attr == "frombuffer":
                    dt = "?"
                    if len(e.args) >= 2:
                        dt = _np_dtype(mod, e.args[1]) or "?"
                    return [("arr", dt)]
                if fn.attr == "decode":
                    return self.expr(fn.value) or [("bytes",)]
                if fn.attr == "dtype" and d == f"{mod.np_alias}.dtype":
                    pass              # falls through to arg scan
            if isinstance(fn, ast.Name) and fn.id == "bytes" and e.args:
                a = e.args[0]
                if self._is_view_slice(a):
                    return [("bytes",)]
            # local helper call: inline (depth-limited)
            if isinstance(fn, ast.Name) and fn.id in mod.functions:
                if self.depth >= 3:
                    return [("?", f"helper {fn.id} nests too deep")]
                helper = mod.functions[fn.id]
                return _ParserWalker(mod, _fn_views(helper),
                                     depth=self.depth + 1).stmts(helper.body)
            # generic call: scan arguments in order (e.g. np.dtype(...),
            # int(...), min(...)) but only keep wire reads found inside
            out: list = []
            for a in list(e.args) + [kw.value for kw in e.keywords]:
                out.extend(self.expr(a))
            return out
        if isinstance(e, ast.Subscript):
            if isinstance(e.value, ast.Name) and e.value.id in self.views:
                if isinstance(e.slice, ast.Constant) and e.slice.value == 0:
                    return [("op",)]
                if isinstance(e.slice, ast.Slice):
                    if e.slice.upper is None:
                        return [("blocks",)]
                    return []         # bounded slice: read via bytes()
                return []
            return self.expr(e.value)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            out = []
            for el in e.elts:
                out.extend(self.expr(el))
            return out
        if isinstance(e, ast.Dict):
            out = []
            for v in e.values:
                out.extend(self.expr(v))
            return out
        if isinstance(e, (ast.ListComp, ast.GeneratorExp)):
            inner = self.expr(e.elt)
            return [("rep", inner)] if inner else []
        if isinstance(e, ast.BinOp):
            return self.expr(e.left) + self.expr(e.right)
        if isinstance(e, ast.IfExp):
            return self.expr(e.body) + self.expr(e.orelse)
        if isinstance(e, (ast.Name, ast.Constant, ast.Attribute,
                          ast.Compare, ast.UnaryOp, ast.BoolOp,
                          ast.Starred, ast.Lambda, ast.JoinedStr)):
            return []
        return []


def parser_branches(mod: _Module, fn: ast.FunctionDef
                    ) -> tuple[list, dict, list]:
    """→ (preamble_tokens, {op_name: branch_tokens}, order of names).

    A parse function is a preamble (memoryview + opcode read) followed
    by a flat ``if op == OP_X: ...`` chain.  ``op in (A, B)`` yields
    one branch entry per name.
    """
    walker = _ParserWalker(mod, _fn_views(fn))
    preamble: list = []
    branches: dict[str, list] = {}
    order: list[str] = []
    op_var: Optional[str] = None

    def branch_ops(test: ast.AST) -> Optional[list[str]]:
        if not isinstance(test, ast.Compare) or len(test.ops) != 1:
            return None
        left = test.left
        if not (isinstance(left, ast.Name)
                and (op_var is None or left.id == op_var)):
            return None
        cmp = test.comparators[0]
        if isinstance(test.ops[0], ast.Eq):
            n = mod.op_name(cmp)
            return [n] if n else None
        if isinstance(test.ops[0], ast.In) \
                and isinstance(cmp, (ast.Tuple, ast.List)):
            names = [mod.op_name(el) for el in cmp.elts]
            return names if all(names) else None
        return None

    for s in fn.body:
        if isinstance(s, ast.If):
            ops = branch_ops(s.test)
            if ops:
                for n in ops:            # each opcode's own reading
                    walker.op = n
                    branches[n] = walker.stmts(s.body)
                    order.append(n)
                walker.op = None
                continue
        toks = walker.stmt(s)
        # detect the opcode variable: the first single-byte read of the
        # body is the opcode, whichever idiom reads it (``view[0]`` or
        # ``_U8.unpack_from(view, 0)``) — normalize to the 'op' token
        if op_var is None and isinstance(s, ast.Assign) \
                and toks in (["u8"], [("op",)]):
            t = s.targets[0]
            if isinstance(t, ast.Tuple) and len(t.elts) == 1 \
                    and isinstance(t.elts[0], ast.Name):
                op_var = t.elts[0].id
                toks = [("op",)]
            elif isinstance(t, ast.Name):
                op_var = t.id
                toks = [("op",)]
            walker.op_var = op_var
        preamble.extend(toks)
    return preamble, branches, order


def _fn_views(fn: ast.FunctionDef) -> set[str]:
    """Parser params are buffer views (body/payload/view/buf)."""
    return {a.arg for a in fn.args.args}


def parser_flat_tokens(mod: _Module, fn: ast.FunctionDef) -> list:
    """Token sequence of a branch-free parse function (parse_body,
    parse_tensors, parse_*_payload)."""
    toks = _ParserWalker(mod, _fn_views(fn)).stmts(fn.body)
    # normalize a leading raw-u8 opcode/status read to the 'op' token so
    # it pairs with builders that emit ``bytes([op])``
    if toks[:1] == ["u8"]:
        toks = [("op",)] + toks[1:]
    return toks


# -- per-plane conformance ----------------------------------------------------

def builder_functions(mod: _Module) -> dict[str, tuple[str, list, int]]:
    """{op_name: (func_name, tail_tokens, line)} for every request
    builder — a module function whose first emitted token is the
    opcode byte of a known OP_* constant."""
    out: dict[str, tuple[str, list, int]] = {}
    dupes: list[tuple[str, str, int]] = []
    for name, fn in mod.functions.items():
        op = _leading_op(mod, fn)
        if op is None:
            continue
        toks = function_build_tokens(mod, fn)
        tail = toks[1:] if toks and toks[0] == ("op",) else toks
        if op in out:
            dupes.append((op, name, fn.lineno))
        else:
            out[op] = (name, tail, fn.lineno)
    out["__dupes__"] = dupes          # type: ignore[assignment]
    return out


def _leading_op(mod: _Module, fn: ast.FunctionDef) -> Optional[str]:
    """The OP_* name whose byte a builder emits first, if any."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and node.value is not None:
            first = node.value
            while isinstance(first, ast.BinOp) \
                    and isinstance(first.op, ast.Add):
                first = first.left
            if isinstance(first, ast.Call) \
                    and isinstance(first.func, ast.Attribute) \
                    and first.func.attr == "pack" and first.args:
                return mod.op_name(first.args[0])
            if isinstance(first, ast.Name):
                # head assembled into a local first (build_write)
                for n2 in ast.walk(fn):
                    if isinstance(n2, ast.Assign) \
                            and isinstance(n2.targets[0], ast.Name) \
                            and n2.targets[0].id == first.id:
                        v = n2.value
                        while isinstance(v, ast.BinOp) \
                                and isinstance(v.op, ast.Add):
                            v = v.left
                        if isinstance(v, ast.Call) \
                                and isinstance(v.func, ast.Attribute) \
                                and v.func.attr == "pack" and v.args:
                            return mod.op_name(v.args[0])
            return None
    return None


def handler_branch_counts(sf: SourceFile) -> dict[str, int]:
    """How many times each OP_* name appears in a dispatch comparison
    (``op == X`` / ``op in (X, ...)``) anywhere in the handler module."""
    counts: dict[str, int] = {}
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Compare) or len(node.ops) != 1:
            continue
        cmp = node.comparators[0]
        names: list[str] = []
        if isinstance(node.ops[0], ast.Eq):
            n = _op_ref(cmp)
            if n:
                names = [n]
        elif isinstance(node.ops[0], ast.In) \
                and isinstance(cmp, (ast.Tuple, ast.List)):
            names = [n for n in (_op_ref(el) for el in cmp.elts) if n]
        for n in names:
            counts[n] = counts.get(n, 0) + 1
    return counts


def _op_ref(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name) and is_op_name(node.id):
        return node.id
    if isinstance(node, ast.Attribute) and is_op_name(node.attr):
        return node.attr
    return None


def rpc_callsite_counts(sf: SourceFile) -> dict[str, int]:
    """fedsvc builder style: one ``self._rpc(OP_X, ...)`` per opcode."""
    counts: dict[str, int] = {}
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "_rpc" and node.args:
            n = _op_ref(node.args[0])
            if n:
                counts[n] = counts.get(n, 0) + 1
    return counts


def check_plane(spec: PlaneSpec, wire_sf: SourceFile,
                handler_sf: Optional[SourceFile],
                stats: Optional[dict] = None,
                parent_sf: Optional[SourceFile] = None) -> list[Finding]:
    """Full conformance check of one plane's wire module (and its
    handler module when available).  This is the API the mutation
    tests drive directly against fixture copies.

    ``parent_sf`` is the module the plane imports its shared framing
    from (spec.parent_rel); its ``struct.Struct`` definitions resolve
    imported struct names like ``_U8``/``_U64``.
    """
    out: list[Finding] = []
    mod = _Module(wire_sf)
    if parent_sf is not None:
        parent = _Module(parent_sf)
        for name, fmt in parent.structs.items():
            if name in mod.imported_names and name not in mod.structs:
                mod.structs[name] = fmt
    rel = wire_sf.rel

    # WP007/WP002: defined constants vs the pinned registry and range
    for name, value in mod.op_consts.items():
        line = _const_line(wire_sf, name)
        pinned = spec.opcodes.get(name)
        if pinned is None:
            out.append(Finding(
                "WP007", rel, line,
                f"opcode {name}={value} is not in the pinned registry "
                f"for plane '{spec.name}'",
                "add it to analysis.rules_wire.PLANES (and the README "
                "reservation table) in the same change"))
        elif pinned != value:
            out.append(Finding(
                "WP007", rel, line,
                f"opcode {name}={value} but the pinned registry says "
                f"{pinned}",
                "opcode renumbering must update the registry in "
                "analysis.rules_wire.PLANES deliberately"))
        if not spec.lo <= value <= spec.hi:
            out.append(Finding(
                "WP002", rel, line,
                f"opcode {name}={value} outside plane '{spec.name}' "
                f"reserved range {spec.lo}..{spec.hi}",
                f"pick a free value in {spec.lo}..{spec.hi}"))
    for name in spec.opcodes:
        if name not in mod.op_consts and name not in mod.imported_ops:
            out.append(Finding(
                "WP007", rel, 1,
                f"registry opcode {name} is not defined in {rel}",
                "define the constant or remove it from the registry"))

    # within-module value uniqueness
    seen: dict[int, str] = {}
    for name, value in mod.op_consts.items():
        if value in seen:
            out.append(Finding(
                "WP001", rel, _const_line(wire_sf, name),
                f"opcode {name}={value} collides with {seen[value]} "
                "in the same module", "opcodes must be unique"))
        else:
            seen[value] = name

    # builders and parser branches
    builders = builder_functions(mod)
    dupes = builders.pop("__dupes__")
    for op, fname, line in dupes:   # type: ignore[misc]
        out.append(Finding(
            "WP003", rel, line,
            f"opcode {op} has more than one request builder "
            f"(second: {fname})", "exactly one builder per opcode"))

    plane_ops = set(mod.op_consts) - TELEMETRY_OPS
    parser_fn = mod.functions.get(spec.parser)

    if spec.builder_style == "rpc_callsites":
        out.extend(_check_rpc_plane(spec, mod, wire_sf, plane_ops,
                                    parser_fn, stats))
    else:
        out.extend(_check_function_plane(spec, mod, wire_sf, plane_ops,
                                         builders, parser_fn, stats))

    # name-matched response payload pairs: build_X_payload/parse_X_payload
    for name, fn in mod.functions.items():
        if not (name.startswith("build_") and name.endswith("_payload")):
            continue
        pname = "parse_" + name[len("build_"):]
        pfn = mod.functions.get(pname)
        if pfn is None:
            continue
        b = function_build_tokens(mod, fn)
        p = parser_flat_tokens(mod, pfn)
        out.extend(_compare(rel, fn.lineno, f"{name}/{pname}", b, p))
        if stats is not None:
            stats.setdefault("pairs_verified", []).append(
                f"{spec.name}:{name}")

    # build_tensors/parse_tensors (exchange's tensor-list framing)
    if "build_tensors" in mod.functions and "parse_tensors" in mod.functions:
        b = function_build_tokens(mod, mod.functions["build_tensors"])
        p = parser_flat_tokens(mod, mod.functions["parse_tensors"])
        out.extend(_compare(rel, mod.functions["build_tensors"].lineno,
                            "build_tensors/parse_tensors", b, p))
        if stats is not None:
            stats.setdefault("pairs_verified", []).append(
                f"{spec.name}:build_tensors")

    # handler dispatch coverage
    if handler_sf is not None:
        counts = handler_branch_counts(handler_sf)
        must_handle = plane_ops | set(spec.shared_handled)
        for op in sorted(must_handle):
            c = counts.get(op, 0)
            if c != 1:
                out.append(Finding(
                    "WP004", handler_sf.rel, 1,
                    f"opcode {op} has {c} dispatch branches in "
                    f"{handler_sf.rel} (want exactly 1)",
                    "every plane opcode needs exactly one handler branch"))
        for op, c in sorted(counts.items()):
            if op not in must_handle and op not in TELEMETRY_OPS:
                out.append(Finding(
                    "WP004", handler_sf.rel, 1,
                    f"dispatch branch for {op} which is not a plane or "
                    f"shared opcode of '{spec.name}'",
                    "remove the branch or register the opcode"))
    return out


def _check_function_plane(spec, mod, wire_sf, plane_ops, builders,
                          parser_fn, stats) -> list[Finding]:
    out: list[Finding] = []
    rel = wire_sf.rel
    if parser_fn is None:
        out.append(Finding(
            "WP003", rel, 1,
            f"parser function {spec.parser}() not found",
            "the plane spec names the request-parse entrypoint"))
        return out
    preamble, branches, _ = parser_branches(mod, parser_fn)
    expect_ops = (plane_ops | set(spec.shared_handled)) - spec.reserved
    for op in sorted(expect_ops):
        has_builder = op in builders
        if not has_builder and op in plane_ops:
            out.append(Finding(
                "WP003", rel, 1,
                f"opcode {op} has no request builder in {rel}",
                "add a build_* function emitting the opcode byte first"))
        if op not in branches:
            out.append(Finding(
                "WP003", rel, parser_fn.lineno,
                f"opcode {op} has no branch in {spec.parser}()",
                "add the parser branch"))
        if not has_builder or op not in branches:
            continue
        fname, tail, line = builders[op]
        parser_toks = preamble[1:] + branches[op] if preamble[:1] == [("op",)] \
            else preamble + branches[op]
        out.extend(_compare(rel, line, f"{fname}/{spec.parser}[{op}]",
                            tail, parser_toks))
        if stats is not None:
            stats.setdefault("pairs_verified", []).append(
                f"{spec.name}:{op}")
    for op in sorted(set(builders) & plane_ops - expect_ops):
        out.append(Finding(
            "WP003", rel, builders[op][2],
            f"request builder for reserved opcode {op}",
            "telemetry opcodes are built by obsv.teleserve only"))
    for op in sorted(set(branches) - expect_ops - spec.reserved):
        out.append(Finding(
            "WP003", rel, parser_fn.lineno,
            f"{spec.parser}() has a branch for unknown opcode {op}",
            "register the opcode or drop the branch"))
    return out


def _check_rpc_plane(spec, mod, wire_sf, plane_ops, parser_fn,
                     stats) -> list[Finding]:
    """fedsvc style: uniform body, one _rpc call site per opcode."""
    out: list[Finding] = []
    rel = wire_sf.rel
    counts = rpc_callsite_counts(wire_sf)
    for op in sorted(plane_ops):
        c = counts.get(op, 0)
        if c != 1:
            out.append(Finding(
                "WP003", rel, 1,
                f"opcode {op} has {c} _rpc() call sites (want exactly 1)",
                "one client-stub method per opcode"))
    for op in sorted(set(counts) - plane_ops):
        out.append(Finding(
            "WP003", rel, 1,
            f"_rpc() call site for unknown opcode {op}",
            "register the opcode in the module and the pinned registry"))
    # the uniform body builder/parser pair
    bfn = mod.functions.get("build_body")
    pfn = parser_fn
    if bfn is not None and pfn is not None:
        b = function_build_tokens(mod, bfn)
        p = parser_flat_tokens(mod, pfn)
        out.extend(_compare(rel, bfn.lineno, f"build_body/{spec.parser}",
                            b, p))
        if stats is not None:
            stats.setdefault("pairs_verified", []).append(
                f"{spec.name}:build_body")
    return out


def _compare(rel: str, line: int, what: str, b: list, p: list
             ) -> list[Finding]:
    ub, up = has_unverifiable(b), has_unverifiable(p)
    if ub or up:
        return [Finding(
            "WP008", rel, line,
            f"{what}: cannot verify byte layout ({ub or up})",
            "restructure to a pack/unpack idiom the checker models, "
            "or extend rules_wire")]
    if not tokens_match(b, p):
        return [Finding(
            "WP005", rel, line,
            f"{what}: builder layout [{render_tokens(b)}] != parser "
            f"layout [{render_tokens(p)}]",
            "the pack sequence and the unpack sequence must agree "
            "field-for-field")]
    return []


def _const_line(sf: SourceFile, name: str) -> int:
    for node in sf.tree.body:
        if isinstance(node, ast.Assign) \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name:
            return node.lineno
    return 1


# -- family entrypoint --------------------------------------------------------

def check(files: list[SourceFile], *, repo_mode: bool,
          stats: Optional[dict] = None) -> list[Finding]:
    out: list[Finding] = []
    by_rel = {sf.rel: sf for sf in files}

    if repo_mode:
        # full per-plane conformance against the pinned registry
        # (package, value) -> (plane, name): twin planes of the two
        # packages share their values by design
        values: dict[tuple[str, int], tuple[str, str]] = {}
        for spec in PLANES:
            wire_sf = by_rel.get(spec.wire_rel)
            if wire_sf is None:
                out.append(Finding(
                    "WP007", spec.wire_rel, 1,
                    f"plane '{spec.name}' wire module missing",
                    "update analysis.rules_wire.PLANES if it moved"))
                continue
            out.extend(check_plane(
                spec, wire_sf, by_rel.get(spec.handler_rel), stats,
                parent_sf=by_rel.get(spec.parent_rel)))
            # WP001 cross-plane value collisions (defined constants only;
            # shared opcodes are imported by reference, never re-defined)
            mod = _Module(wire_sf)
            for name, value in mod.op_consts.items():
                prev = values.get((spec.package, value))
                if prev and prev[0] != spec.name:
                    out.append(Finding(
                        "WP001", spec.wire_rel,
                        _const_line(wire_sf, name),
                        f"opcode {name}={value} collides with plane "
                        f"'{prev[0]}' opcode {prev[1]}",
                        "opcode values must be unique across all planes "
                        "sharing the framing"))
                else:
                    values[(spec.package, value)] = (spec.name, name)

    # WP006 cross-module OP_* name shadowing (all scanned files)
    owners: dict[str, list[tuple[str, int]]] = {}
    for sf in files:
        for node in sf.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and is_op_name(node.targets[0].id) \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, int):
                owners.setdefault(node.targets[0].id, []).append(
                    (sf.rel, node.lineno))
    for name, sites in sorted(owners.items()):
        if len(sites) > 1:
            first = sites[0]
            for rel, line in sites[1:]:
                out.append(Finding(
                    "WP006", rel, line,
                    f"OP_* constant {name} is also defined in "
                    f"{first[0]}:{first[1]} — a wrong import silently "
                    "sends the other plane's opcode",
                    "give each plane's constants a namespaced name "
                    "(e.g. OP_EMBED_*, OP_COORD_*) and import, never "
                    "re-define"))

    if not repo_mode:
        # flat mode (fixture dirs): self-consistency of any file that
        # looks like a wire module — defines OP_* constants and a
        # parse_* request function with opcode branches
        for sf in files:
            mod = _Module(sf)
            if not mod.op_consts:
                continue
            for name, fn in mod.functions.items():
                if not name.startswith("parse_"):
                    continue
                _, branches, _ = parser_branches(mod, fn)
                if not branches:
                    continue
                builders = builder_functions(mod)
                builders.pop("__dupes__")
                for op, (fname, tail, line) in builders.items():
                    if op in branches:
                        out.extend(_compare(
                            sf.rel, line, f"{fname}/{name}[{op}]",
                            tail, branches[op]))
    return out
