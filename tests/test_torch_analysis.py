"""The port's analyzer (``repro_torch.analysis``) and its CLI
(``repro_torch.launch.lint``) against the JAX package's
(``repro.analysis``, pure stdlib: it imports no JAX).

1. parity — on every fixture directory the port's findings equal JAX's,
   finding for finding; on the live tree both are empty, and the port
   verifies every pair JAX verifies plus its own four planes';
2. the CLI — exit codes 0 / 1 / 2 and the JSON shape, without torch or
   numpy in the process;
3. mutations of the port's own wire planes — each must raise its rule,
   which JAX's analyzer (``OP_*`` names, ``src/repro`` paths) never sees.
"""

from __future__ import annotations

import ast
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from repro.analysis import run_analysis as jax_run_analysis
from repro_torch.analysis import rules_wire, run_analysis
from repro_torch.analysis.core import SourceFile
from repro_torch.launch import lint

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO_ROOT / "tests" / "fixtures" / "analysis"
FIXTURE_DIRS = sorted(p.name for p in FIXTURES.iterdir() if p.is_dir())
PT_PLANES = {s.name: s for s in rules_wire.PLANES
             if s.package == "repro_torch"}

# the bad fixtures and the rule each must raise (tests/test_analysis.py)
BAD_FIXTURES = [
    ("wire_bad_layout", "WP005"),
    ("wire_bad_shadow", "WP006"),
    ("lock_bad_unguarded", "LD001"),
    ("lock_bad_wait", "LD002"),
    ("lock_bad_order", "LD003"),
    ("lock_bad_annotation", "LD004"),
    ("jax_bad_np", "JX001"),
    ("jax_bad_item", "JX002"),
    ("jax_bad_closure", "JX003"),
    ("timing_bad", "TM001"),
    ("telemetry_bad", "TL001"),
]


def _key(findings) -> list:
    return [(f.rule, f.path, f.line, f.message) for f in findings]


def _port_plane_files() -> set:
    return {rel for s in PT_PLANES.values()
            for rel in (s.wire_rel, s.handler_rel, s.parent_rel) if rel}


# -- 1. parity ----------------------------------------------------------------

@pytest.mark.parametrize("name", FIXTURE_DIRS)
def test_fixture_findings_equal_jax(name):
    assert len(FIXTURE_DIRS) == 14
    port = run_analysis(FIXTURES / name, exclude_fixtures=False)
    ref = jax_run_analysis(FIXTURES / name, exclude_fixtures=False)
    assert _key(port.findings) == _key(ref.findings)
    assert [f.hint for f in port.findings] == [f.hint for f in ref.findings]
    assert [f.to_json() for f in port.findings] == \
        [f.to_json() for f in ref.findings]
    assert port.stats == ref.stats
    if name.endswith("_good"):
        assert port.clean
    else:
        assert not port.clean


@pytest.fixture(scope="module")
def live():
    return run_analysis(REPO_ROOT), jax_run_analysis(REPO_ROOT)


def test_live_tree_clean_in_both(live):
    port, ref = live
    assert port.findings == [], "\n".join(f.render() for f in port.findings)
    assert ref.findings == [], "\n".join(f.render() for f in ref.findings)
    assert port.stats["repo_mode"] and ref.stats["repo_mode"]


def test_live_tree_parity(live):
    """Less the port's own planes, the port sees what JAX sees: the same
    files, findings, verified pairs, lock edges, traced functions and
    telemetry names; and it verifies every opcode of the port's planes
    (nothing skipped as unverifiable)."""
    port, ref = live
    own = _port_plane_files()
    assert _key(f for f in port.findings if f.path not in own) == \
        _key(ref.findings)
    pairs = port.stats.pop("pairs_verified")
    ref_stats = dict(ref.stats)
    ref_pairs = ref_stats.pop("pairs_verified")
    assert port.stats == ref_stats
    assert [p for p in pairs if not p.startswith("pt_")] == ref_pairs
    pt_pairs = {p for p in pairs if p.startswith("pt_")}
    assert pt_pairs == {"pt_" + p.replace(":OP_", ":PT_OP_")
                        for p in ref_pairs}
    assert "pt_exchange:PT_OP_VGATHER" in pt_pairs


# -- 2. the CLI ---------------------------------------------------------------

def test_cli_on_the_repo_is_clean_and_pure_stdlib(live):
    """``python -m repro_torch.launch.lint`` exits 0 on the repo with the
    in-process run's JSON, and imports neither torch nor numpy."""
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "repro_torch.launch.lint",
         "--format", "json"],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
    out = json.loads(proc.stdout)
    assert set(out) == {"findings", "stats"}
    assert out["findings"] == []
    assert out["stats"]["files_scanned"] == live[0].stats["files_scanned"]
    imported = {ln.rsplit("|", 1)[-1].strip() for ln in
                proc.stderr.splitlines() if ln.startswith("import time:")}
    assert "repro_torch.analysis.rules_wire" in imported
    heavy = {m for m in imported
             if m.split(".")[0] in ("torch", "numpy", "jax", "repro")}
    assert not heavy, sorted(heavy)


@pytest.mark.parametrize("name,rule", BAD_FIXTURES)
def test_cli_exits_1_on_bad_fixture(name, rule, capsys):
    rc = lint.main(["--root", str(FIXTURES / name), "--include-fixtures",
                    "--format", "json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert any(f["rule"] == rule for f in out["findings"])
    for f in out["findings"]:
        assert set(f) == {"rule", "file", "line", "message", "hint"}
    assert out["stats"]["findings"] == len(out["findings"])


def test_cli_exits_2_on_a_path_that_is_not_a_directory(tmp_path, capsys):
    f = tmp_path / "a.py"
    f.write_text("x = 1\n")
    assert lint.main(["--root", str(f)]) == 2
    assert lint.main(["--root", str(tmp_path / "missing")]) == 2
    assert "not a directory" in capsys.readouterr().err
    assert lint.main(["--root", str(tmp_path), "--select", "TM"]) == 0
    assert "0 findings in 1 files" in capsys.readouterr().out


# -- 3. mutations of the port's own planes ------------------------------------

def _plane_tree(dst: pathlib.Path) -> pathlib.Path:
    """A copy of every wire, handler and parent module of both
    packages' planes under ``dst`` (so ``dst`` reads as the repo)."""
    rels = {rel for s in rules_wire.PLANES
            for rel in (s.wire_rel, s.handler_rel, s.parent_rel) if rel}
    for rel in rels:
        (dst / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(REPO_ROOT / rel, dst / rel)
    return dst


def _edit(path: pathlib.Path, old: str, new: str) -> None:
    text = path.read_text(encoding="utf-8")
    assert text.count(old) == 1, old
    path.write_text(text.replace(old, new), encoding="utf-8")


MUTATIONS = {
    "renumber PT_OP_GATHER": (
        "WP007", "src/repro_torch/exchange/wire.py",
        "PT_OP_GATHER = 3\n", "PT_OP_GATHER = 7\n"),
    "move PT_OP_VGATHER out of 1-15": (
        "WP002", "src/repro_torch/exchange/wire.py",
        "PT_OP_VGATHER = 6 ", "PT_OP_VGATHER = 40 "),
    "swap a pack width in build_register": (
        "WP005", "src/repro_torch/exchange/wire.py",
        "_U8.pack(PT_OP_REGISTER) + _U64.pack(len(global_ids))",
        "_U8.pack(PT_OP_REGISTER) + _U16.pack(len(global_ids))"),
    "define PT_OP_GATHER in a second module": (
        "WP006", "src/repro_torch/gnnserve/wire.py",
        "PT_OP_SSTATS = 33\n", "PT_OP_SSTATS = 33\nPT_OP_GATHER = 3\n"),
    "drop the VGATHER dispatch branch": (
        "WP004", "src/repro_torch/launch/embed_server.py",
        "            if op == wire.PT_OP_VGATHER:\n"
        "                return self._handle_vgather(req)\n", ""),
}


def test_plane_tree_copy_is_clean(tmp_path):
    root = _plane_tree(tmp_path)
    res = run_analysis(root, select=["WP"])
    assert res.stats["repo_mode"] and res.clean, \
        "\n".join(f.render() for f in res.findings)
    assert {p.split(":")[0] for p in res.stats["pairs_verified"]} == \
        {s.name for s in rules_wire.PLANES}
    assert jax_run_analysis(root, select=["WP"]).clean


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_port_plane_mutation_raises_its_rule(case, tmp_path):
    rule, rel, old, new = MUTATIONS[case]
    root = _plane_tree(tmp_path)
    _edit(root / rel, old, new)
    found = run_analysis(root, select=["WP"]).findings
    assert (rule, rel) in {(f.rule, f.path) for f in found}, \
        "\n".join(f.render() for f in found)
    # the JAX analyzer never reads the port's planes
    ref = jax_run_analysis(root, select=["WP"]).findings
    assert not [f for f in ref if f.path.startswith("src/repro_torch/")]


# every opcode renumbered and every struct / dtype field swapped in a
# verified builder or parser (the port's counterpart of
# tests/test_analysis.py's generator, with its helper ``_layer_list``)
_EXCLUDED_FNS = {"build_ok", "build_err", "parse_response"}
_STRUCT_CALL = re.compile(
    r"(_U8|_U16|_U32|_U64|_STATS)\.(pack|unpack_from|unpack)\(")
_STRUCT_PREF = ["_U16", "_U64", "_U8", "_U32", "_STATS"]
_DTYPE_SWAPS = {"np.int64": "np.int32", "np.float32": "np.float64",
                "np.int32": "np.int64"}
_OPCODE_DEF = re.compile(r"^(PT_OP_\w+) = (\d+)", re.M)


def _verified_spans(text: str) -> list:
    return [(n.lineno, n.end_lineno) for n in ast.parse(text).body
            if isinstance(n, ast.FunctionDef) and n.name not in _EXCLUDED_FNS
            and (n.name.startswith(("build_", "parse_"))
                 or n.name in ("_gid_bytes", "_layer_list"))]


def _mutations(text: str):
    for m in _OPCODE_DEF.finditer(text):
        name, value = m.group(1), int(m.group(2))
        yield (f"{name} {value}->{value + 1}",
               text[:m.start(2)] + str(value + 1) + text[m.end(2):])
    avail = set(re.findall(r"^(_\w+) = struct\.Struct", text, re.M))
    avail |= {n for n in _STRUCT_PREF
              if re.search(rf"import.*\b{n}\b", text)}
    lines = text.splitlines(True)
    spans = _verified_spans(text)
    for i, ln in enumerate(lines):
        if not any(lo <= i + 1 <= hi for lo, hi in spans):
            continue
        for m in _STRUCT_CALL.finditer(ln):
            orig = m.group(1)
            swap = next((s for s in _STRUCT_PREF
                         if s != orig and s in avail), None)
            if swap is None:
                continue
            mut = lines[:]
            mut[i] = ln[:m.start(1)] + swap + ln[m.start(1) + len(orig):]
            yield f"line {i + 1}: {orig}->{swap}", "".join(mut)
        if "frombuffer" in ln or ".tobytes()" in ln or "asarray" in ln:
            for old, new in _DTYPE_SWAPS.items():
                if old in ln:
                    mut = lines[:]
                    mut[i] = ln.replace(old, new, 1)
                    yield f"line {i + 1}: {old}->{new}", "".join(mut)
                    break


def _plane_findings(spec, text: str):
    sf = SourceFile(REPO_ROOT / spec.wire_rel, spec.wire_rel, text)
    parent = None
    if spec.parent_rel:
        p = REPO_ROOT / spec.parent_rel
        parent = SourceFile(p, spec.parent_rel, p.read_text(encoding="utf-8"))
    return rules_wire.check_plane(spec, sf, None, {}, parent_sf=parent)


@pytest.mark.parametrize("plane", sorted(PT_PLANES))
def test_every_port_opcode_and_pack_field_mutation_caught(plane):
    spec = PT_PLANES[plane]
    text = (REPO_ROOT / spec.wire_rel).read_text(encoding="utf-8")
    assert _plane_findings(spec, text) == []
    missed, total = [], 0
    for desc, mutated in _mutations(text):
        total += 1
        if not _plane_findings(spec, mutated):
            missed.append(desc)
    assert total >= 3, f"mutation generator found too little in {plane}"
    assert not missed, f"{plane}: undetected mutations: {missed}"
