"""Federated multi-pod dry-run: the paper's technique on the pod axis.

Counterpart of ``repro/launch/fedrun.py``.  One federated round of
:mod:`repro_torch.core.fedopt` over silo-stacked state, the silo dim over
the ``pod`` mesh axis: each pod trains its own silo replica for
``local_steps``, then the mean of the silos' deltas is the cross-pod
collective, top-k sparsified per leaf (the pruning analogue: the bytes
sent scale with the kept fraction), and the anchor moves by it.

``main`` traces the round on the multi-pod production mesh: like the
dry-run, the process first makes itself rank 0 of a ``fake`` world of
512 ranks and runs the round on meta-device local shards under the
census; it prints the record and its roofline seconds from the H100's
datasheet rates (:mod:`repro_torch.launch.mesh`).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.fedrun --arch smollm-360m \\
      [--local-steps 4] [--topk 0.1]
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import time

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.configs import get_config, list_archs
from repro_torch.core.fedopt import _topk_sparsify
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import local_bytes, meta_shards
from repro_torch.models import lm
from repro_torch.models.layers import on_replicas
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_unflatten


def _to_pod(t):
    """A DTensor on (pod, data, model) as this rank's part of it on the
    (data, model) sub-mesh: the pod dim's shard taken whole (a silo
    stack's local silos, or the anchor's copy)."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    local = t.to_local()
    shape = list(t.shape)
    p = t.placements[0]
    if p.is_shard():
        shape[p.dim] = local.shape[p.dim]
    return DTensor.from_local(local, mesh["data", "model"],
                              t.placements[1:], run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _pod_sum(t, mesh):
    """The sum over the pod axis of each rank's ``t`` (a DTensor on the
    (data, model) sub-mesh): a Partial over pod made whole."""
    if not isinstance(t, DTensor):
        return t
    full = DTensor.from_local(t.to_local(), mesh,
                              (Partial(),) + tuple(t.placements),
                              run_check=False, shape=t.shape,
                              stride=t.stride())
    return full.redistribute(mesh, (Replicate(),) + tuple(
        Replicate() if p.is_partial() else p for p in t.placements))


def build_fed_round(cfg, mesh, *, local_steps: int, topk: float | None,
                    batch: int, seq: int):
    """One federated round over silo-stacked state.  Returns (fn,
    in_placements, abstract_inputs): ``fn(stacked_params, stacked_opt,
    anchor, batches) -> (new_anchor, mean loss)``, the silo dim of the
    stacked trees and of batches {tokens, labels: (silos, local_steps,
    batch, seq)} over ``pod`` and, within a silo, the (data, model)
    rules; meta-device stand-ins of the four inputs.

    Each silo runs ``local_steps`` of ``lm.make_train_step(cfg,
    adamw(1e-3))``.  On plain tensors the round loops over every silo;
    on the pod mesh each rank runs the silos of its pod on the (data,
    model) sub-mesh and the silos' delta sum is the pod-axis reduction.
    The top-k of each leaf's mean delta is taken on a replica of the
    leaf (a sort has no sharding rule)."""
    n_pods = mesh_lib.axis_sizes(mesh)["pod"]
    rules = sh.make_rules(mesh, cfg)
    opt = adamw(1e-3)
    inner = lm.make_train_step(cfg, opt)

    def silo_round(params, opt_state, batches):
        losses = []
        for i in range(local_steps):
            params, opt_state, m = inner(
                params, opt_state, {k: v[i] for k, v in batches.items()})
            losses.append(m["loss"])
        return params, opt_state, torch.stack(losses).mean()

    def fed_round(stacked_params, stacked_opt, anchor, batches):
        full = next((t.device_mesh for t in tree_leaves(anchor)
                     if isinstance(t, DTensor)), None)
        sp = tree_unflatten(stacked_params,
                            [_to_pod(t) for t in tree_leaves(stacked_params)])
        so = tree_unflatten(stacked_opt,
                            [_to_pod(t) for t in tree_leaves(stacked_opt)])
        a = [_to_pod(t) for t in tree_leaves(anchor)]
        b = {k: _to_pod(v) for k, v in batches.items()}
        sums, loss_sum = None, None
        for s in range(tree_leaves(sp)[0].shape[0]):
            p, _, loss = silo_round(
                tree_unflatten(anchor, [t[s] for t in tree_leaves(sp)]),
                tree_unflatten(so, [t[s] for t in tree_leaves(so)]),
                {k: v[s] for k, v in b.items()})
            # each silo's delta in its own dtype, summed in fp32 (as
            # jnp.mean sums low-precision leaves)
            d = [(pi - ai).to(torch.float32)
                 for pi, ai in zip(tree_leaves(p), a)]
            sums = d if sums is None else [x + y for x, y in zip(sums, d)]
            loss_sum = loss if loss_sum is None else loss_sum + loss
        sums = [_pod_sum(x, full) for x in sums]
        delta = [(x / n_pods).to(ai.dtype)
                 for x, ai in zip(sums, tree_leaves(anchor))]
        if topk:
            delta = on_replicas(lambda ds: _topk_sparsify(ds, topk)[0])(
                delta)
        new_anchor = tree_unflatten(anchor, [
            ai + d.to(ai.dtype) for ai, d in zip(tree_leaves(anchor), delta)])
        return new_anchor, _pod_sum(loss_sum, full) / n_pods

    pshapes = lm.init_params(cfg, generator=torch.Generator(), device="meta")
    pspecs = sh.param_specs(rules, pshapes)
    oshapes = opt.init(tree_leaves(pshapes))
    ospecs = sh.opt_specs(rules, oshapes, pspecs)

    def pod_stack_spec(spec):
        # drop 'pod' from any dp tuples inside, then lead with 'pod'
        cleaned = []
        for ax in spec:
            if isinstance(ax, tuple):
                ax = tuple(a for a in ax if a != "pod") or None
                if ax is not None and len(ax) == 1:
                    ax = ax[0]
            cleaned.append(ax)
        return sh.P("pod", *cleaned)

    def stacked(tree):
        return tree_unflatten(tree, [
            torch.empty((n_pods,) + tuple(t.shape), dtype=t.dtype,
                        device="meta") for t in tree_leaves(tree)])

    def stacked_placements(specs):
        return sh.to_placements(mesh, tree_unflatten(
            specs, [pod_stack_spec(s) for s in sh.spec_leaves(specs)],
            is_leaf=sh.is_spec))

    batches = {k: torch.empty((n_pods, local_steps, batch, seq),
                              dtype=torch.int32, device="meta")
               for k in ("tokens", "labels")}
    bpl = sh.placements(sh.P("pod", None, "data", None), mesh)
    return (fed_round,
            (stacked_placements(pspecs), stacked_placements(ospecs),
             sh.to_placements(mesh, pspecs), {k: bpl for k in batches}),
            (stacked(pshapes), stacked(oshapes), pshapes, batches))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="smollm-360m")
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--topk", type=float, default=None)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--out", default="results/fedrun.json")
    args = ap.parse_args(argv)

    from repro_torch.launch.census import Census
    from repro_torch.launch.dryrun import fake_world

    fake_world(512)
    cfg = get_config(args.arch)
    mesh = mesh_lib.make_production_mesh(multi_pod=True)
    t0 = time.perf_counter()
    fn, placements, inputs = build_fed_round(
        cfg, mesh, local_steps=args.local_steps, topk=args.topk,
        batch=args.batch, seq=args.seq)
    args_in = [meta_shards(mesh, x, pl) for x, pl in zip(inputs, placements)]
    with Census() as c:
        fn(*args_in)
    cen = c.record()
    rec = {
        "arch": args.arch, "local_steps": args.local_steps,
        "topk": args.topk, "batch": args.batch, "seq": args.seq,
        "devices": mesh.size(),
        "args_gib": local_bytes(args_in) / 2**30,
        "temp_gib": cen["peak_bytes"] / 2**30,
        "census_flops": cen["flops"],
        "hbm_bytes": cen["hbm_bytes"],
        "collective_total": cen["collective_total"],
        "collective_bytes": cen["collective_bytes"],
        "trace_s": time.perf_counter() - t0,
        # one rank's roofline terms at the H100 datasheet rates
        "collective_s": cen["collective_total"] / mesh_lib.NVLINK_BW,
        "flops_s": cen["flops"] / mesh_lib.PEAK_FLOPS_BF16,
        "hbm_s": cen["hbm_bytes"] / mesh_lib.HBM_BW,
    }
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    data = json.loads(out.read_text()) if out.exists() else []
    data.append(rec)
    out.write_text(json.dumps(data, indent=1))
    print(f"OK fed_round {args.arch} local_steps={args.local_steps} "
          f"topk={args.topk}")
    print(f"   args={rec['args_gib']:.2f}GiB temp={rec['temp_gib']:.2f}GiB "
          f"coll={rec['collective_s']:.3f}s flops={rec['flops_s']:.3f}s "
          f"(H100 datasheet rates)")
    print(json.dumps(rec), flush=True)
    if not math.isfinite(rec["census_flops"]) or rec["census_flops"] <= 0:
        raise SystemExit("fedrun: the round counted no FLOPs")


if __name__ == "__main__":
    main()
