"""Build, load and launch the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and is loaded with :mod:`ctypes`.  Libraries land in
``build/repro_torch/`` at the repository root, named by a hash of their
sources, so an edited source is rebuilt and an unchanged one is reused.
Nothing is built at import time: the first launch builds what it needs,
and :func:`build_all` builds every library in parallel up front.

:func:`launch` is the one place a kernel is launched: it passes the
caller's CUDA stream, raises when the C entry point reports a CUDA error,
and adds one to that entry point's launch counter.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int

#: C signature of each library's entry point (pointers and the stream as
#: c_void_p, so ctypes never truncates them to 32 bits).
SIGNATURES: dict[str, list] = {
    "quantize_rows": [_P, _P, _I64, _I32, _I64, _P, _P, _P],
    "dequantize_rows": [_P, _P, _P, _P, _I64, _I32, _I64, _I32, _P],
    "segment_mean_csr": [_P, _P, _P, _I64, _I32, _P, _P, _P],
    "segment_mean_csr_bwd": [_P, _P, _P, _P, _I64, _I32, _P, _P],
    "count_ge": [_P, _I64, _P, _P, _P],
}

#: Launches per wrapper entry point, counted where the kernel is launched.
LAUNCHES: dict[str, int] = {
    "quantize_int8": 0,
    "dequantize_int8": 0,
    "gather_quantize": 0,
    "dequant_scatter": 0,
    "gnn_aggregate": 0,
    "segment_mean_bwd": 0,
    "count_ge": 0,
}

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {home}/bin)")
    return found


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for src in (CSRC / "common.cuh", CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, pathlib.Path] | None:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish_build(name: str, started) -> None:
    if started is None:
        return
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, _lib_path(name))


def build_all() -> float:
    """Build every kernel library, one ``nvcc`` per source, all started
    together; returns the wall seconds the builds took."""
    t0 = time.perf_counter()
    started = {name: _start_build(name) for name in SIGNATURES}
    for name, s in started.items():
        _finish_build(name, s)
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        _finish_build(name, _start_build(name))
        lib = ctypes.CDLL(str(_lib_path(name)))
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def launch(counter: str, kernel: str, *args) -> None:
    """Launch C entry point ``kernel`` on the current stream and count it
    under wrapper ``counter``.  Tensors among ``args`` pass as pointers."""
    import torch

    lib = library(kernel)
    stream = torch.cuda.current_stream().cuda_stream
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    code = getattr(lib, kernel)(*c_args, stream)
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} ({msg})")
    LAUNCHES[counter] += 1
