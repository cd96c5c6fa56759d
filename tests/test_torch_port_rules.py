"""Rules the PyTorch port keeps: it never imports JAX or the JAX package
(the machine with the card has no JAX), its entry points default to the
card, and its kernels build without fast math."""

import ast
import inspect
import pathlib

import pytest

from repro_torch.core import embedding_server, federated, pruning, serving
from repro_torch.exchange import socket_transport, transport
from repro_torch.fedsvc import coordinator, runtime, worker
from repro_torch.gnnserve import engine
from repro_torch.kernels import _build
from repro_torch.launch import embed_server
from repro_torch.models import gnn, layers, lm

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_kernels_build_without_fast_math():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "fast_math" not in flags and "fast-math" not in flags
    assert "arch=compute_90a,code=sm_90a" in flags
    for cu in (PORT / "csrc").glob("*.cu"):
        assert "__fdividef" not in cu.read_text(), cu.name
    assert set(_build.SIGNATURES) == {p.stem for p in
                                      (PORT / "csrc").glob("*.cu")}
