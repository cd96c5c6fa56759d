#!/usr/bin/env python3
"""Sweep the aggregation forward's row loads in flight, warps per block
and row order on one GPU, at the training path's shapes.

    python3 tools/agg_sweep.py [--kernel fp32|int8] [--unroll 2,4,8,16]
                               [--warps 4,8,16] [--order 1,0]

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

With ``--kernel int8`` it sweeps ``csrc/segment_mean_csr_int8.cu``'s
``kUnroll`` (row loads in flight a group) and ``kWarps`` the same way,
over the same local edges' CSR with a seeded int8 table of 32 columns
and its scales (the width of the pull chain's layer-2 rows); its read
rate counts each kept edge's row and scale.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
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


def build_variants(_build, name: str, variants: list[dict]) -> dict:
    """One library of ``csrc/<name>.cu`` per variant (a dict of its
    ``constexpr int`` constants and their values), every nvcc started
    together; keyed by the variant's values in order."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for consts in variants:
        key = tuple(consts.values())
        edited = text
        for const, value in consts.items():
            edited, n = re.subn(rf"constexpr int {const} = \d+;",
                                f"constexpr int {const} = {value};", edited)
            if n != 1:
                raise SystemExit(f"agg_sweep: {const} not found in {name}.cu")
        src = OUT / (name + "".join(f"_{c}{v}" for c, v in consts.items())
                     + ".cu")
        src.write_text(edited)
        lib = src.with_suffix(".so")
        procs[key] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"agg_sweep: nvcc failed for {key}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), name)
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        libs[key] = fn
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("fp32", "int8"), default="fp32")
    ap.add_argument("--unroll", default="2,4,8,16")
    ap.add_argument("--warps", default="4,8,16")
    ap.add_argument("--order", default="1,0")
    ap.add_argument("--const", action="append", default=[],
                    metavar="NAME=V1,V2",
                    help="also sweep another constexpr int of the source")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.graphs import (bfs_partition, make_client_shards,
                                    make_graph)
    from repro_torch.graphs.sampler import NeighborSampler
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import gnn_aggregate as agg
    from repro_torch.models.gnn import blocks_to_arrays, shard_to_arrays

    if not torch.cuda.is_available():
        print("agg_sweep: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    int8 = args.kernel == "int8"
    source = "segment_mean_csr_int8" if int8 else "segment_mean_csr"
    symbol = source + ("_group_kernel" if int8 else "_kernel")
    axes = {"kUnroll": args.unroll, "kWarps": args.warps}
    axes.update(c.split("=", 1) for c in args.const)
    variants = [dict(zip(axes, values)) for values in itertools.product(
        *[[int(x) for x in v.split(",")] for v in axes.values()])]
    orders = [int(x) for x in args.order.split(",")]
    libs = build_variants(_build, source, variants)
    pack = _build.packer(source).pack

    g = make_graph("reddit", scale=cs.SCALE, seed=0)
    sh = make_client_shards(g, bfs_partition(g, 4, seed=0))[0]
    arr = shard_to_arrays(sh, "cuda")
    feats = arr["features"]
    layer1 = torch.cat([feats, torch.zeros((1, feats.shape[1]),
                                           device="cuda")])
    gen = torch.Generator(device="cuda").manual_seed(0)
    if int8:
        # tables: (values, scales); outputs: (mean,)
        shapes = {"layer1": (ops.quantize_int8(torch.randn(
            (layer1.shape[0], 32), device="cuda", generator=gen)),
            arr["local"]["csr"])}
    else:
        # tables: (src,); outputs: (mean, cnt)
        mb = NeighborSampler(sh, 5, 3, 64, seed=0).sample_batch(
            sh.train_vertices()[:64])
        blk = blocks_to_arrays(mb, "cuda")["blocks"][1]
        h = torch.randn((mb.blocks[1].p_src, 32), device="cuda",
                        generator=gen)
        shapes = {"layer1": ((layer1,), arr["local"]["csr"]),
                  "block": ((h,), blk["csr"])}

    def launch(fn, tables, csr, o):
        n_dst, f = csr.indptr.shape[0] - 1, tables[0].shape[1]
        outs = [torch.empty((n_dst, f), device="cuda")]
        if not int8:
            outs.append(torch.empty(n_dst, device="cuda"))
        code = fn(pack(*[t.data_ptr() for t in tables],
                       csr.indptr.data_ptr(), csr.indices.data_ptr(),
                       csr.order.data_ptr() if o else 0, n_dst, f,
                       *[t.data_ptr() for t in outs],
                       _build.current_stream()))
        return code, outs

    want = {}
    for name, (tables, csr) in shapes.items():
        print(json.dumps({"shape": name, "kernel": args.kernel,
                          "table": list(tables[0].shape),
                          **degree_stats(np, csr.indptr)}), flush=True)
        n_dst = csr.indptr.shape[0] - 1
        want[name] = ([agg.dequant_aggregate(*tables, None, None, None,
                                             n_dst, csr)] if int8 else
                      list(agg.segment_mean_csr(*tables, csr.indptr,
                                                csr.indices, csr.order)))

    dev_ms: dict[tuple, float] = {}
    for (u, w, *more), fn in libs.items():
        extra = dict(zip(list(axes)[2:], more))
        for o in orders:
            for name, (tables, csr) in shapes.items():
                def run():
                    code, outs = launch(fn, tables, csr, o)
                    cs.check(code == 0, f"unroll {u} warps {w}: CUDA error "
                                        f"{code}")
                    return outs
                got = run()
                cs.check(all(torch.equal(a, b)
                             for a, b in zip(got, want[name])),
                         f"{name} unroll {u} warps {w} order {o}: the "
                         "bytes changed")
                dev = cs.device_ms(torch, run, symbol)
                kept = int(csr.indices.shape[0])
                f = tables[0].shape[1]
                per_edge = f + 4 if int8 else f * 4
                row = {"shape": name, "kernel": args.kernel, "unroll": u,
                       "warps": w, **extra, "order": o, "device_ms": dev,
                       "row_read_tb_per_s": kept * per_edge / dev / 1e9
                       if dev else None, "card": card}
                print(json.dumps(row), flush=True)
                if dev is not None:
                    dev_ms[(name, u, w, *more, o)] = dev
    path = {k[1:]: t for k, t in dev_ms.items() if k[0] == "layer1"}
    best = min(path, key=path.get) if path else None
    print(json.dumps({"kernel": args.kernel,
                      "best": dict(zip([*axes, "order"], best))
                      if best else None,
                      "device_ms": path.get(best),
                      "block_device_ms": dev_ms.get(("block", *best))
                      if best else None, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
