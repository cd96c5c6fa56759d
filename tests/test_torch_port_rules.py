"""Rules the PyTorch port keeps: it never imports JAX or the JAX package
(the machine with the card has no JAX), its entry points default to the
card, and its kernels build without fast math."""

import ast
import inspect
import pathlib

import pytest

from repro_torch import checkpoint
from repro_torch.core import (embedding_server, federated, fedopt, pruning,
                              serving)
from repro_torch.data import pipeline
from repro_torch.exchange import socket_transport, transport
from repro_torch.fedsvc import coordinator, runtime, worker
from repro_torch.gnnserve import engine
from repro_torch.kernels import _build
from repro_torch.launch import embed_server, gnn_serve, mesh, train
from repro_torch.models import gnn, layers, lm, moe, ssm

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] \
        + sorted((ROOT / "examples").glob("*_torch.py"))


def _imported_roots(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_port_imports_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) > 20
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in files for mod, line in _imported_roots(p)
           if mod in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_examples_on_the_port_are_scanned_and_default_to_the_card():
    names = {p.name for p in _port_files() if p.parent.name == "examples"}
    assert names == {"quickstart_torch.py", "train_federated_e2e_torch.py",
                     "serve_llm_torch.py", "federated_llm_torch.py"}
    for name in names:                       # the card unless asked
        src = (ROOT / "examples" / name).read_text(encoding="utf-8")
        assert 'ap.add_argument("--device", default="cuda")' in src, name


def test_the_analyzer_and_lint_import_only_the_stdlib():
    """``repro_torch.analysis`` and ``repro_torch.launch.lint`` run in a
    bare container: absolute imports of the stdlib and of
    ``repro_torch.analysis`` only (the package's own modules import each
    other relatively), no torch or numpy."""
    import sys

    files = sorted((PORT / "analysis").glob("*.py")) \
        + [PORT / "launch" / "lint.py"]
    assert len(files) == 7
    bad = []
    for p in files:
        for node in ast.walk(ast.parse(p.read_text(encoding="utf-8"))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                if n.split(".")[0] not in sys.stdlib_module_names \
                        and n != "repro_torch.analysis":
                    bad.append(f"{p.relative_to(ROOT)}:{node.lineno} {n}")
    assert not bad, bad


def test_scan_catches_a_jax_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import numpy\nfrom repro.kernels import ops\n"
                 "def g():\n    import jax.numpy as jnp\n")
    assert {m for m, _ in _imported_roots(f)} >= {"repro", "jax"}


@pytest.mark.parametrize("fn", [
    federated.export_for_serving, federated.pretrain_push,
    federated.FederatedGNNTrainer.__init__, pruning.top_fraction,
    engine.build_serving, engine.ShardServeEngine.__init__,
    transport.make_transport, transport.InProcessTransport.__init__,
    transport.ShardedTransport.__init__,
    embedding_server.EmbeddingServer.__init__, gnn.init_gnn,
    gnn.from_jax_leaves, lm.init_params, lm.from_jax_params, lm.init_cache,
    layers.init_kv_cache, serving.ContinuousBatcher.__init__,
    socket_transport.TcpTransport.__init__, embed_server.serve_in_thread,
    embed_server.serve, runtime.RunConfig.build_trainer,
    runtime.EvalHarness.__init__, runtime.make_coordinator_state,
    worker.FedWorker.__init__, coordinator.CoordinatorState.__init__,
    gnn_serve.build_plane_from_cfg, moe.init_moe, ssm.init_ssm,
    ssm.init_ssm_cache, layers.init_mla_cache, pipeline.synthetic_batches,
    fedopt.FederatedLMTrainer.__init__, checkpoint.load_pytree,
    mesh.make_host_mesh,
])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_train_launcher_defaults_to_the_card():
    assert train.parser().parse_args([]).device == "cuda"


def test_store_and_serving_launchers_default_to_the_card(tmp_path):
    """``RunConfig.build_trainer`` over a store, the serving launcher's
    ``--device`` and the plane it builds: the card unless asked; the
    store builder needs no device at all (it imports no torch)."""
    import argparse

    from repro_torch.graphs import make_graph
    from repro_torch.graphstore import store_from_graph

    path = store_from_graph(make_graph("arxiv", scale=0.1, seed=7),
                            str(tmp_path / "g")).path
    cfg = runtime.RunConfig(graph=f"store:{path}")
    assert cfg.build_graph().is_store
    assert inspect.signature(cfg.build_trainer).parameters[
        "device"].default == "cuda"
    ap = argparse.ArgumentParser()
    runtime.RunConfig.add_args(ap)
    assert ap.parse_args([]).device == "cuda"
    src = (PORT / "launch" / "build_store.py").read_text(encoding="utf-8")
    assert "--device" not in src
    assert "torch" not in {m for m, _ in _imported_roots(
        PORT / "launch" / "build_store.py")}
    for sub in ("graphs", "graphstore"):
        for p in (PORT / sub).glob("*.py"):
            assert "torch" not in {m for m, _ in _imported_roots(p)}, p


def test_only_the_pod_clis_import_torch_testing():
    """The ``fake`` process group lives in ``torch.testing._internal``:
    only the dry-run and fedrun, which make their own fake worlds, may
    import it (and must: the port has no other way to build one)."""
    def imports_it(path):
        for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else [node.module or ""] \
                if isinstance(node, ast.ImportFrom) else []
            if any(n.startswith("torch.testing") for n in names):
                return True
        return False

    users = {p.relative_to(ROOT).as_posix() for p in _port_files()
             if imports_it(p)}
    assert "src/repro_torch/launch/dryrun.py" in users
    assert users <= {"src/repro_torch/launch/dryrun.py",
                     "src/repro_torch/launch/fedrun.py"}, users


def test_kernels_build_without_fast_math():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "fast_math" not in flags and "fast-math" not in flags
    assert "arch=compute_90a,code=sm_90a" in flags
    for cu in (PORT / "csrc").glob("*.cu"):
        assert "__fdividef" not in cu.read_text(), cu.name
    assert set(_build.SIGNATURES) == {p.stem for p in
                                      (PORT / "csrc").glob("*.cu")}


def test_dyngraph_is_numpy_but_its_wire():
    """The growth plane's schedule, overlay, restreaming and runtime
    import no torch (a store tool can grow a graph without it); only
    its wire, on the exchange framing, does."""
    for p in (PORT / "dyngraph").glob("*.py"):
        roots = {m for m, _ in _imported_roots(p)}
        assert ("torch" in roots) is False, p
    wire_src = (PORT / "dyngraph" / "wire.py").read_text(encoding="utf-8")
    assert "repro_torch.exchange.wire" in wire_src
