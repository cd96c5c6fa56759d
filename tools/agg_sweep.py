#!/usr/bin/env python3
"""Sweep the aggregation forward's row loads in flight, warps per block
and row order on one GPU, at the training path's shapes.

    python3 tools/agg_sweep.py [--unroll 2,4,8,16] [--warps 4,8,16]
                               [--order 1,0]

Two shapes, both from ``chip_smoke.py``'s graph (the reddit preset at
scale 58, 4 clients): layer 1 of ``full_propagate`` on client 0 (its
features, 96 floats a row, over the local edges' CSR built on the host)
and the layer-2 block of a minibatch (fanout 5, batch 64; 32 floats a
row).  It first prints each shape's kept-degree statistics.  The row
loads in flight (``kUnroll``) and warps per block (``kWarps``) are
compile-time constants of ``csrc/segment_mean_csr.cu``: for each pair
the tool writes a copy of that source with the two constants replaced
into ``build/agg_sweep/``, builds it with the package's ``nvcc`` flags
(all variants at once) and loads it with ctypes beside the package's own
library, which it leaves as it is.  For each (unroll, warps, order;
order 1 takes the host CSR's rows by falling degree, 0 takes them
0 .. n-1) it launches the variant, checks its bytes equal to the
package's kernel, and prints one JSON line: the kernel's device ms
(torch.profiler), the rate of its source-row reads (kept edges × f × 4
bytes over that time; most come from L2) and the card.  The last line
names the configuration with the least device time at the layer-1
shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "agg_sweep"


def degree_stats(np, indptr) -> dict:
    deg = np.diff(indptr.cpu().numpy())
    return {"rows": int(len(deg)), "kept_edges": int(deg.sum()),
            "max": int(deg.max()), "p99": float(np.percentile(deg, 99)),
            "mean": float(deg.mean())}


def build_variants(_build, pairs) -> dict:
    """One library per (unroll, warps), every nvcc started together."""
    text = (_build.CSRC / "segment_mean_csr.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for u, w in pairs:
        src = OUT / f"segment_mean_csr_u{u}_w{w}.cu"
        edited, n = re.subn(r"constexpr int kUnroll = \d+;",
                            f"constexpr int kUnroll = {u};", text)
        edited, m = re.subn(r"constexpr int kWarps = \d+;",
                            f"constexpr int kWarps = {w};", edited)
        if n != 1 or m != 1:
            raise SystemExit("agg_sweep: kUnroll/kWarps not found in "
                             "segment_mean_csr.cu")
        src.write_text(edited)
        lib = src.with_suffix(".so")
        procs[(u, w)] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"agg_sweep: nvcc failed for {key}:\n{log}")
        fn = ctypes.CDLL(str(lib)).segment_mean_csr
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        libs[key] = fn
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--unroll", default="2,4,8,16")
    ap.add_argument("--warps", default="4,8,16")
    ap.add_argument("--order", default="1,0")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.graphs import (bfs_partition, make_client_shards,
                                    make_graph)
    from repro_torch.graphs.sampler import NeighborSampler
    from repro_torch.kernels import _build
    from repro_torch.kernels import gnn_aggregate as agg
    from repro_torch.models.gnn import blocks_to_arrays, shard_to_arrays

    if not torch.cuda.is_available():
        print("agg_sweep: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    unrolls = [int(x) for x in args.unroll.split(",")]
    warps = [int(x) for x in args.warps.split(",")]
    orders = [int(x) for x in args.order.split(",")]
    libs = build_variants(_build, [(u, w) for u in unrolls for w in warps])
    pack = _build.packer("segment_mean_csr").pack

    g = make_graph("reddit", scale=cs.SCALE, seed=0)
    sh = make_client_shards(g, bfs_partition(g, 4, seed=0))[0]
    arr = shard_to_arrays(sh, "cuda")
    feats = arr["features"]
    layer1 = torch.cat([feats, torch.zeros((1, feats.shape[1]),
                                           device="cuda")])
    mb = NeighborSampler(sh, 5, 3, 64, seed=0).sample_batch(
        sh.train_vertices()[:64])
    blk = blocks_to_arrays(mb, "cuda")["blocks"][1]
    h = torch.randn((mb.blocks[1].p_src, 32), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    shapes = {"layer1": (layer1, arr["local"]["csr"]),
              "block": (h, blk["csr"])}
    want = {}
    for name, (src, csr) in shapes.items():
        print(json.dumps({"shape": name, "table": list(src.shape),
                          **degree_stats(np, csr.indptr)}), flush=True)
        want[name] = agg.segment_mean_csr(src, csr.indptr, csr.indices,
                                          csr.order)

    dev_ms: dict[tuple, float] = {}
    for (u, w), fn in libs.items():
        for o in orders:
            for name, (src, csr) in shapes.items():
                n_dst, f = csr.indptr.shape[0] - 1, src.shape[1]

                def run():
                    mean = torch.empty((n_dst, f), device="cuda")
                    cnt = torch.empty(n_dst, device="cuda")
                    code = fn(pack(
                        src.data_ptr(), csr.indptr.data_ptr(),
                        csr.indices.data_ptr(),
                        csr.order.data_ptr() if o else 0, n_dst, f,
                        mean.data_ptr(), cnt.data_ptr(),
                        _build.current_stream()))
                    cs.check(code == 0, f"unroll {u} warps {w}: CUDA error "
                                        f"{code}")
                    return mean, cnt
                got = run()
                cs.check(torch.equal(got[0], want[name][0])
                         and torch.equal(got[1], want[name][1]),
                         f"{name} unroll {u} warps {w} order {o}: the "
                         "bytes changed")
                dev = cs.device_ms(torch, run, "segment_mean_csr_kernel")
                kept = int(csr.indices.shape[0])
                row = {"shape": name, "unroll": u, "warps": w, "order": o,
                       "device_ms": dev,
                       "row_read_tb_per_s": kept * f * 4 / dev / 1e9
                       if dev else None, "card": card}
                print(json.dumps(row), flush=True)
                if dev is not None:
                    dev_ms[(name, u, w, o)] = dev
    path = {k[1:]: t for k, t in dev_ms.items() if k[0] == "layer1"}
    best = min(path, key=path.get) if path else None
    print(json.dumps({"best_unroll_warps_order": best,
                      "device_ms": path.get(best),
                      "block_device_ms": dev_ms.get(("block", *best))
                      if best else None, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
