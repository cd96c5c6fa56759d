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
and adds one to that entry point's launch counter.  It is on the host
path of every kernel call, so it stays lean: each library's entry point
takes its arguments as one struct whose fields follow :data:`SIGNATURES`,
packed with :mod:`struct` and passed as one pointer (one ctypes
conversion instead of one per argument); each entry point is resolved
once; and the current stream's raw handle is read anew on every call
through PyTorch's own C binding.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import struct
import subprocess
import time

import torch

from ._host import BUILD_DIR, CSRC

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_F32 = ctypes.c_float

#: Fields of the argument struct of each library's entry point, in order
#: (pointers and the stream as c_void_p, 64 bits wide).
SIGNATURES: dict[str, list] = {
    "quantize_rows": [_P, _P, _I64, _I32, _I64, _P, _P, _P],
    "dequantize_rows": [_P, _P, _P, _P, _P, _I64, _I32, _I64, _I32, _P],
    "segment_mean_csr": [_P, _P, _P, _P, _I64, _I32, _P, _P, _P],
    "segment_mean_csr_bwd": [_P, _P, _P, _P, _I64, _I64, _I32, _P, _P, _P],
    "count_ge": [_P, _I64, _P, _P, _P],
    "topk_select": [_P, _I64, _I64, _P, _P, _I32, _P],
    "segment_mean_csr_int8": [_P, _P, _P, _P, _P, _I64, _I32, _P, _P],
    "swa_decode": [_P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32,
                   _I32, _I32, _I32, _I32, _F32, _P, _P],
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
    "topk_mask": 0,
    "dequant_aggregate": 0,
    "swa_attention_decode": 0,
}

_libs: dict[str, ctypes.CDLL] = {}
#: :mod:`struct` codes of the fields of an entry point's struct, in native
#: alignment, as the C compiler lays the struct out.
_CODES = {_P: "P", _I64: "q", _I32: "i", _F32: "f"}

#: Each launched entry point's ctypes function, the packer of its struct
#: and its library's error-string function, resolved once.
_entries: dict[str, tuple] = {}


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
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def packer(kernel: str) -> struct.Struct:
    """The layout of entry point ``kernel``'s argument struct."""
    return struct.Struct("@" + "".join(_CODES[t] for t in SIGNATURES[kernel]))


def _entry(kernel: str) -> tuple:
    lib = library(kernel)
    fn = getattr(lib, kernel)
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_int
    found = _entries[kernel] = (fn, packer(kernel).pack,
                                lib.repro_error_string)
    return found


def current_stream() -> int:
    """The raw handle of the current CUDA stream of the current device
    (what ``torch.cuda.current_stream().cuda_stream`` reads, without
    building a Stream object); only CUDA builds of PyTorch have it."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def launch(counter: str, kernel: str, *args) -> None:
    """Launch C entry point ``kernel`` on the current stream and count it
    under wrapper ``counter``.  Tensors among ``args`` pass as pointers,
    None as a null pointer."""
    fn, pack, error_string = _entries.get(kernel) or _entry(kernel)
    code = fn(pack(*[a.data_ptr() if isinstance(a, torch.Tensor) else a or 0
                     for a in args], current_stream()))
    if code != 0:
        msg = error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} ({msg})")
    LAUNCHES[counter] += 1
