"""Build and load the port's host C++ libraries.

Each ``csrc/<name>.cpp`` compiles on its own with the host C++ compiler
(``$CXX``, else ``c++``) into a shared library with a plain C interface,
loaded with :mod:`ctypes`.  As with the CUDA libraries of
:mod:`repro_torch.kernels._build`, a library lands in ``build/repro_torch/``
at the repository root, named by a hash of its source, its flags and the
compiler's version, so an edited source is rebuilt and an unchanged one is
reused.  These run on the host alone: a machine without a GPU or ``nvcc``
builds them, and this module imports nothing of PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"

CXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}


@functools.cache
def _compiler() -> tuple[str, str]:
    """The host C++ compiler and the first line of its ``--version``."""
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no host C++ compiler found ($CXX, c++ or g++)")
    out = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                         check=True).stdout
    return cxx, out.splitlines()[0]


def lib_path(name: str) -> pathlib.Path:
    cxx, version = _compiler()
    h = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    h.update(" ".join([version, *CXX_FLAGS]).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _compile(name: str, out: pathlib.Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_compiler()[0], *CXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed for {name}.cpp:\n{proc.stdout}")
    os.replace(tmp, out)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cpp``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        out = lib_path(name)
        if not out.exists():
            _compile(name, out)
        lib = _libs[name] = ctypes.CDLL(str(out))
    return lib
