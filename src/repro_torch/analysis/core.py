"""repro-lint core of the port: source model, suppressions, findings
and the entry point that runs every rule family.

Port of ``repro/analysis/core.py``, with the same API, rules, messages
and suppression markers, so one ``# repro-lint: disable=RULE`` serves
both analyzers.  It checks the repo's hand-maintained invariants: the
wire-protocol opcode spaces of both packages' planes sharing one
framing, the ``# guarded-by:`` lock discipline of the threaded servers,
the JAX/Pallas tracing rules of the reference package, and the
telemetry naming convention.  Pure stdlib (``ast``, ``tokenize``,
``pathlib``, ``re``): it imports neither torch nor numpy nor the JAX
package, so it runs in a bare CI container and on a machine without JAX.

Rule families (each in its own module):

    WP0xx  wire-protocol conformance      rules_wire
    LD0xx  lock discipline                rules_lock
    JX0xx  JAX/Pallas tracing hygiene     rules_jax
    TM0xx  timing discipline              rules_jax
    TL0xx  telemetry naming discipline    rules_telemetry

Suppression: a finding is suppressed by a comment on its line (or the
line directly above)::

    x = self.store.hidden   # repro-lint: disable=LD001

Multiple rules comma-separate (``disable=LD001,TM001``);
``disable-file=RULE`` anywhere in the file suppresses the rule for the
whole file.  Suppressions are deliberate, reviewable markers — every
one should carry a justification comment next to it.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import pathlib
import re
import tokenize
from typing import Iterable, Optional

__all__ = ["Finding", "SourceFile", "load_file", "collect_files",
           "run_analysis", "AnalysisResult"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a file/line."""

    rule: str
    path: str           # display path (relative to the analysis root)
    line: int
    message: str
    hint: str = ""

    def sort_key(self) -> tuple:
        return (self.path, self.line, self.rule)

    def render(self) -> str:
        s = f"{self.path}:{self.line}: {self.rule} {self.message}"
        if self.hint:
            s += f"  [fix: {self.hint}]"
        return s

    def to_json(self) -> dict:
        return {"rule": self.rule, "file": self.path, "line": self.line,
                "message": self.message, "hint": self.hint}


_DISABLE_RE = re.compile(
    r"repro-lint:\s*disable(?P<file>-file)?\s*=\s*(?P<rules>[A-Z]{2}\d{3}"
    r"(?:\s*,\s*[A-Z]{2}\d{3})*)")


class SourceFile:
    """A parsed module plus its comment map and suppression table."""

    def __init__(self, path: pathlib.Path, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.tree = ast.parse(text, filename=str(path))
        # comment map: physical line -> comment text (sans leading '#')
        self.comments: dict[int, str] = {}
        self.line_disables: dict[int, set[str]] = {}
        self.file_disables: set[str] = set()
        self._scan_comments()

    def _scan_comments(self) -> None:
        try:
            toks = tokenize.generate_tokens(io.StringIO(self.text).readline)
            for tok in toks:
                if tok.type != tokenize.COMMENT:
                    continue
                line = tok.start[0]
                body = tok.string.lstrip("#").strip()
                self.comments[line] = body
                m = _DISABLE_RE.search(body)
                if m:
                    rules = {r.strip() for r in m.group("rules").split(",")}
                    if m.group("file"):
                        self.file_disables |= rules
                    else:
                        self.line_disables.setdefault(line, set()).update(
                            rules)
        except tokenize.TokenError:
            pass                      # ast.parse succeeded; comments best-effort

    def suppressed(self, rule: str, line: int) -> bool:
        if rule in self.file_disables:
            return True
        for ln in (line, line - 1):
            if rule in self.line_disables.get(ln, set()):
                return True
        return False

    def comment_on(self, line: int) -> str:
        return self.comments.get(line, "")


def load_file(path: pathlib.Path, root: pathlib.Path) -> SourceFile:
    rel = path.resolve().relative_to(root.resolve()).as_posix()
    return SourceFile(path, rel, path.read_text(encoding="utf-8"))


_SKIP_PARTS = {"__pycache__", ".git", ".venv", "node_modules"}


def collect_files(root: pathlib.Path,
                  *, exclude_fixtures: bool = True) -> list[SourceFile]:
    """Every parseable ``*.py`` under root, excluding caches and (by
    default) the analyzer's own test fixtures — those are deliberately
    broken code."""
    out = []
    for p in sorted(root.rglob("*.py")):
        rel_parts = p.resolve().relative_to(root.resolve()).parts
        if any(part in _SKIP_PARTS for part in rel_parts):
            continue
        if exclude_fixtures and "fixtures" in rel_parts:
            continue
        try:
            out.append(load_file(p, root))
        except (SyntaxError, UnicodeDecodeError):
            continue                  # not this tool's problem
    return out


@dataclasses.dataclass
class AnalysisResult:
    findings: list[Finding]
    stats: dict

    @property
    def clean(self) -> bool:
        return not self.findings


def _in_scope(sf: SourceFile, prefixes: tuple[str, ...],
              repo_mode: bool) -> bool:
    if not repo_mode:
        return True
    return sf.rel.startswith(prefixes)


def run_analysis(root, select: Optional[Iterable[str]] = None,
                 *, exclude_fixtures: bool = True) -> AnalysisResult:
    """Run every rule family over the tree at ``root``.

    When ``root`` looks like this repository (has ``src/repro_torch``),
    each family sees its documented scope (wire/lock/telemetry: ``src``;
    jax: ``src`` + ``benchmarks`` + ``examples``; timing: everything).
    Any other root — e.g. a directory of test fixtures — is scanned
    flat, with every family applied to every file.
    """
    from . import rules_jax, rules_lock, rules_telemetry, rules_wire

    root = pathlib.Path(root)
    files = collect_files(root, exclude_fixtures=exclude_fixtures)
    repo_mode = (root / "src" / "repro_torch").is_dir()
    stats: dict = {"files_scanned": len(files), "repo_mode": repo_mode}

    families = {
        "WP": (rules_wire.check, ("src/",)),
        "LD": (rules_lock.check, ("src/",)),
        "JX": (rules_jax.check, ("src/", "benchmarks/", "examples/")),
        "TM": (rules_jax.check_timing, ()),   # repo-wide
        "TL": (rules_telemetry.check, ("src/",)),
    }
    wanted = None
    if select is not None:
        wanted = {s.strip().upper() for s in select if s.strip()}

    findings: list[Finding] = []
    for fam, (fn, prefixes) in families.items():
        if wanted is not None and fam not in wanted:
            continue
        scoped = [sf for sf in files
                  if not prefixes or _in_scope(sf, prefixes, repo_mode)]
        findings.extend(fn(scoped, repo_mode=repo_mode, stats=stats))

    by_rel = {sf.rel: sf for sf in files}
    kept = [f for f in findings
            if f.path not in by_rel
            or not by_rel[f.path].suppressed(f.rule, f.line)]
    kept.sort(key=Finding.sort_key)
    stats["findings"] = len(kept)
    return AnalysisResult(kept, stats)


# -- shared AST helpers used by several rule modules --------------------------

def dotted_name(node: ast.AST) -> str:
    """'a.b.c' for nested Attribute/Name chains, '' if anything else."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def iter_functions(tree: ast.AST):
    """(qualname, node) for every function/method, depth-first."""
    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                yield q, child
                yield from walk(child, q + ".")
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.")
            else:
                yield from walk(child, prefix)
    yield from walk(tree, "")
