#!/usr/bin/env python3
"""Time the host pieces of one ``ops.dequantize_int8`` call on one GPU.

    python3 tools/launch_pieces.py [--src SRC] [--calls 10000]

Imports ``repro_torch`` from ``SRC`` (default: this checkout's ``src``)
and decodes a 59,803 × 32 int8 block, client 0's published rows in
``chip_smoke.py``'s reddit configuration.  Each piece of the call path is
timed on its own with ``time.perf_counter`` over ``--calls`` calls, in
batches of 256 with a synchronise between batches outside the timed
spans, so no span waits on the device.  The pieces are those of the
imported tree's own launch path: on a tree whose ``_build`` reads the
raw stream (``current_stream``), the allocation by ``empty_like``, the
raw-stream read and the call of the entry point on one packed struct; on
an older tree, ``torch.empty``, ``torch.cuda.current_stream().cuda_stream``
and a ``getattr`` on the library with one ctypes conversion per
argument.  ``call`` is the whole ``ops.dequantize_int8``, ``lib`` one
``torch.mul``.  Prints one JSON line of microseconds per call, with the
card; run it on two trees in turns to compare their launch paths.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCH = 256


def _us(torch, fn, calls: int) -> float:
    fn()
    total = 0.0
    done = 0
    while done < calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(BATCH):
            fn()
        total += time.perf_counter() - t0
        done += BATCH
    torch.cuda.synchronize()
    return total / done * 1e6


def measure(torch, calls: int = 10_000, n: int = 59_803,
            h: int = 32) -> dict[str, float]:
    """Microseconds per call of each host piece of ``ops.dequantize_int8``
    at (n, h), for the ``repro_torch`` already imported."""
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import quantize as quant

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((n, h), device="cuda", generator=gen)
    q, s = ops.quantize_int8(x)
    out = torch.empty((n, h), dtype=torch.float32, device="cuda")

    def checks():
        quant.check_cuda(q, torch.int8, "values", 2)
        quant.check_cuda(s, torch.float32, "scales", 2)
        quant.check_cuda(out, torch.float32, "out", 2)

    # the null row ids and, since the scatter-add sorts them, their null
    # sort order: the struct's pointer fields before n
    sig = getattr(_build, "SIGNATURES", {}).get("dequantize_rows")
    nulls = (None,) * (len(sig) - 8 if sig else 1)
    args = (q, s, out, *nulls, n, h, n, 0)
    pointers = [a.data_ptr() if isinstance(a, torch.Tensor) else a or 0
                for a in args]
    if hasattr(_build, "current_stream"):  # the lean launch path
        fn, pack, _ = _build._entry("dequantize_rows")
        stream = _build.current_stream
        st = stream()

        def ctypes_call():
            return fn(pack(*pointers, st))

        def empty():
            return torch.empty_like(q, dtype=torch.float32)
    else:
        lib = _build.library("dequantize_rows")

        def stream():
            return torch.cuda.current_stream().cuda_stream
        st = stream()

        def ctypes_call():
            return getattr(lib, "dequantize_rows")(*pointers, st)

        def empty():
            return torch.empty(q.shape, dtype=torch.float32, device=q.device)
    pieces = {
        "dispatch": lambda: ops._on_cuda(q),
        "empty": empty,
        "checks": checks,
        "stream": stream,
        "args": lambda: [a.data_ptr() if isinstance(a, torch.Tensor) else a
                         for a in args],
        "ctypes": ctypes_call,
        "launch": lambda: _build.launch("dequantize_int8", "dequantize_rows",
                                        *args),
        "wrapper": lambda: quant.dequantize_int8(q, s),
        "call": lambda: ops.dequantize_int8(q, s),
        "lib": lambda: torch.mul(q, s),
    }
    return {k: _us(torch, f, calls) for k, f in pieces.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--calls", type=int, default=10_000)
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("launch_pieces: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    res = measure(torch, args.calls)
    print(json.dumps({"src": args.src, "card": card, "calls": args.calls,
                      "us_per_call": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
