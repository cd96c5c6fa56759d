"""Multi-pod dry-run driver.

Counterpart of ``repro/launch/dryrun.py``.  For every (architecture ×
input shape × mesh) combination it builds the step with the production
placements (:func:`repro_torch.launch.steps.build_step`) and traces it
on meta-device local shards (``bundle.trace()``): one rank's FLOPs, HBM and
collective bytes (:mod:`repro_torch.launch.census`) and its memory.  A
failure (a sharding rule DTensor refuses, an op without a rule) is
recorded and the sweep goes on.

The process is its own world: before anything else it creates a
``fake`` process group of 512 ranks (256 when only the single-pod mesh
is asked for) with this process as rank 0, as the JAX dry-run forces 512
placeholder devices; the single-pod mesh takes ranks 0–255.  Collectives
on a fake group move nothing and meta-device tensors hold no memory,
so no device is used.  The fake backend lives in
``torch.testing._internal``; without it the run fails.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # full sweep
Results are appended to results/dryrun.json (one record per combo).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback

import torch.distributed as dist

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_step


def fake_world(world_size: int) -> None:
    """Make this process rank 0 of a ``fake`` world of ``world_size``
    ranks, unless the default group already has at least that many."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" \
                and dist.get_world_size() >= world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def run_one(arch: str, shape_name: str, mesh_kind: str, *,
            microbatches=None, seq_parallel=None, fsdp_threshold=5e9,
            moe_groups=None) -> dict:
    multi = mesh_kind == "multi"
    fake_world(512 if multi else 256)
    cfg = get_config(arch)
    if moe_groups is not None and cfg.num_experts:
        cfg = dataclasses.replace(cfg, moe_groups=moe_groups)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "devices": mesh.size(), "ok": False}
    t0 = time.perf_counter()
    try:
        bundle = build_step(cfg, shape, mesh, microbatches=microbatches,
                            seq_parallel=seq_parallel,
                            fsdp_threshold=fsdp_threshold)
        cen = bundle.trace()
        rec.update({
            "ok": True,
            "trace_s": round(time.perf_counter() - t0, 1),
            "memory": cen["memory"],
            "collectives": dict(cen["collective_bytes"],
                                total=cen["collective_total"],
                                op_counts=cen["collective_ops"]),
            "census": {k: cen[k] for k in ("flops", "hbm_bytes",
                                           "collective_total",
                                           "collective_bytes")},
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "seq_parallel": bundle.rules.seq_parallel,
            "fsdp": bundle.rules.fsdp,
        })
    except Exception as e:  # noqa: BLE001 — recorded, the sweep goes on
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=6)
        rec["trace_s"] = round(time.perf_counter() - t0, 1)
    return rec


def append_result(rec: dict, out_path: pathlib.Path) -> None:
    out_path.parent.mkdir(parents=True, exist_ok=True)
    data = json.loads(out_path.read_text()) if out_path.exists() else []
    # replace any previous record of the same combo and variant
    key = (rec["arch"], rec["shape"], rec["mesh"], rec.get("variant", ""))
    data = [d for d in data
            if (d["arch"], d["shape"], d["mesh"], d.get("variant", ""))
            != key]
    data.append(rec)
    out_path.write_text(json.dumps(data, indent=1))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--seq-parallel", type=int, default=None,
                    help="override: 0/1")
    ap.add_argument("--fsdp-threshold", type=float, default=5e9)
    ap.add_argument("--moe-groups", type=int, default=None)
    ap.add_argument("--variant", default="",
                    help="label for experiment records")
    ap.add_argument("--out", default="results/dryrun.json")
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s, m) for a in list_archs() for s in SHAPES
                  for m in ("single", "multi")]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        combos = [(args.arch, args.shape, args.mesh)]
    fake_world(512 if any(m == "multi" for _, _, m in combos) else 256)

    out_path = pathlib.Path(args.out)
    sp = None if args.seq_parallel is None else bool(args.seq_parallel)
    for arch, shape, meshk in combos:
        rec = run_one(arch, shape, meshk, microbatches=args.microbatches,
                      seq_parallel=sp, fsdp_threshold=args.fsdp_threshold,
                      moe_groups=args.moe_groups)
        if args.variant:
            rec["variant"] = args.variant
        append_result(rec, out_path)
        status = "OK " if rec["ok"] else "FAIL"
        extra = "" if rec["ok"] else f"  {rec['error'][:120]}"
        print(f"{status} {arch:24s} {shape:12s} {meshk:6s} "
              f"{rec['trace_s']:6.1f}s{extra}", flush=True)
        if rec["ok"]:
            mem = rec["memory"]
            print(f"     mem: args={mem['argument_size_in_bytes'] / 2**30:.2f}"
                  f"GiB temp={mem['temp_size_in_bytes'] / 2**30:.2f}GiB  "
                  f"flops={rec['census']['flops']:.3e}  "
                  f"coll={rec['collectives']['total'] / 2**30:.3f}GiB",
                  flush=True)
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
