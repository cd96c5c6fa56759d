"""Driver of the federated training cells: whole rounds of
``FederatedGNNTrainer.run_round`` back to back.

Set-up builds the trainer on the benchmark's graph, partition and
weights, with every sampler epoch cut to the configuration's first
minibatches, seeds the server (``pretrain_round``) and runs the first
round, which warms every shape up and is the round the reference
follows: client 0's first three steps (losses, the first gradient as
Adam holds it, the change after three steps), the global model's change
over the round, the server's pushed rows, the loss and the accuracy.
The window then runs rounds until ``--seconds`` have passed; the last
round finishes, and the accuracy it reports is held against the
reference's evaluation of the model it leaves.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from perfbench import census, compare, host
from perfbench.gen import graph as gen_graph
from perfbench.reference.federated import Evaluator, Federation


def init_leaves(cfg: dict, seed: int, device) -> list[torch.Tensor]:
    """The initial weights from the seed, drawn on ``device`` in one call:
    per layer a zero bias and ``W ~ N(0, 2 / d_in)``, in the leaf order
    (b, W) of each layer."""
    dims = census.layer_dims(cfg)
    sizes = [dims[l] * dims[l + 1] for l in range(len(dims) - 1)]
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(sum(sizes), generator=gen, device=device)
    leaves = []
    for l, w in enumerate(torch.split(z, sizes)):
        d_in, d_out = dims[l], dims[l + 1]
        leaves += [torch.zeros(d_out, device=device),
                   w.view(d_in, d_out) * (2.0 / d_in) ** 0.5]
    return leaves


def program_graph(arrays: dict, cfg: dict):
    from repro_torch.graphs.graph import Graph

    return Graph(indptr=arrays["indptr"], indices=arrays["indices"],
                 features=arrays["features"], labels=arrays["labels"],
                 train_mask=arrays["train_mask"],
                 num_classes=cfg["graph"]["classes"], name=cfg["name"])


def build_trainer(ctx, arrays: dict, strategy: dict, init: list):
    """The program's trainer on the benchmark's inputs."""
    from repro_torch.core.federated import FederatedGNNTrainer
    from repro_torch.core.strategies import Strategy
    from repro_torch.models.gnn import GNN, GNNLayer
    from repro_torch.optim import adam

    cfg = ctx.cell.config
    m, o = cfg["model"], cfg["model"]["optimizer"]
    model = GNN(m["conv"], [GNNLayer(init[i + 1].clone(), init[i].clone())
                            for i in range(0, len(init), 2)])
    return FederatedGNNTrainer(
        program_graph(arrays, cfg), m["clients"], Strategy(**strategy),
        conv=m["conv"], num_layers=m["num_layers"], hidden=m["hidden"],
        fanout=m["fanout"], batch_size=m["batch_size"],
        epochs_per_round=m["epochs_per_round"], lr=o["lr"],
        optimizer=adam(o["lr"], o["b1"], o["b2"], o["eps"]),
        seed=ctx.seed, part=arrays["part"],
        eval_max_edges=m["eval_max_edges"], model=model, device=ctx.device)


@dataclasses.dataclass
class Counts:
    """What the sampler handed out: minibatches, their seed vertices and
    (while tracing) their model FLOPs."""
    minibatches: int = 0
    seeds: int = 0
    flops: int = 0


def cut_epochs(ctx, counts: Counts):
    """Every sampler epoch yields its first ``minibatches_per_epoch``
    minibatches (after ``chip_smoke.py`` ``cut_epochs``), counted, and
    timed as region ``sample`` while recording.  Returns the undo."""
    from repro_torch.graphs.sampler import NeighborSampler

    cfg = ctx.cell.config
    cut = cfg["minibatches_per_epoch"]
    dims = census.layer_dims(cfg)
    rec = ctx.rec
    inner = NeighborSampler.epoch

    def epoch(self, *args, **kw):
        it = inner(self, *args, **kw)
        for _ in range(cut):
            with rec.region("sample"):
                mb = next(it, None)
            if mb is None:
                return
            counts.minibatches += 1
            counts.seeds += int(mb.seed_mask.sum())
            if rec.enabled:
                counts.flops += census.train_flops(
                    dims, [(b.n_dst, int(b.edge_mask.sum()))
                           for b in mb.blocks])
            yield mb

    NeighborSampler.epoch = epoch
    return lambda: setattr(NeighborSampler, "epoch", inner)


class AggCall(NamedTuple):
    """One aggregation call's shapes, and its rows read as device
    scalars: the distinct sources of the kept edges, and where a gradient
    follows (row 5b) the destinations that have a kept edge."""
    n_src: int
    f: int
    n_dst: int
    kept: int
    src_rows: torch.Tensor
    dst_rows: torch.Tensor | None


def agg_call(src: torch.Tensor, n_dst: int, csr, grad: bool) -> AggCall:
    """An aggregation over ``csr`` (a ``Csr``) from the table ``src``,
    with its rows read counted on ``src``'s device."""
    n_src, f = src.shape
    indices = torch.as_tensor(csr.indices, device=src.device)
    seen = torch.zeros(n_src, dtype=torch.bool, device=src.device)
    seen[indices.long()] = True
    dst_rows = None
    if grad:
        indptr = torch.as_tensor(csr.indptr, device=src.device)
        dst_rows = torch.count_nonzero(torch.diff(indptr))
    return AggCall(n_src, f, n_dst, int(indices.shape[0]), seen.sum(),
                   dst_rows)


def record_kernels(ctx):
    """While recording, the compulsory bytes of every codec call (rows
    1–4) in ``rec.data``, and every aggregation call (row 5 and, where a
    gradient follows, 5b) with the rows it reads, counted on the device
    without a wait and summed by :func:`resolve_kernel_bytes`.  Returns
    the undos."""
    from repro_torch.kernels import ops

    rec = ctx.rec
    data = rec.data
    data.update(agg_calls=[], codec_bytes=0)

    def agg(args, kw, out):
        if rec.enabled:
            src = args[0]
            data["agg_calls"].append(agg_call(
                src, args[4], args[5],
                torch.is_grad_enabled() and src.requires_grad))

    def codec(count):
        def on_call(args, kw, out):
            if rec.enabled:
                data["codec_bytes"] += count(*args)
        return on_call

    return [
        rec.wrap(ops, "gnn_aggregate", None, on_call=agg),
        rec.wrap(ops, "quantize_int8", None, on_call=codec(
            lambda x: census.quantize_bytes(*x.shape))),
        rec.wrap(ops, "dequantize_int8", None, on_call=codec(
            lambda v, s: census.dequantize_bytes(*v.shape))),
        rec.wrap(ops, "gather_quantize", None, on_call=codec(
            lambda t, rows: census.gather_quantize_bytes(len(rows),
                                                         t.shape[1]))),
        rec.wrap(ops, "dequant_scatter_", None, on_call=codec(
            lambda t, rows, v, s, **kw: census.dequant_scatter_bytes(
                *v.shape))),
    ]


def resolve_kernel_bytes(data: dict) -> None:
    """``agg_bytes``: the recorded aggregation calls' compulsory bytes,
    their rows read fetched from the device at once."""
    calls = data.pop("agg_calls", [])
    total = 0
    if calls:
        src_rows = torch.stack([c.src_rows for c in calls]).tolist()
        for c, rows in zip(calls, src_rows):
            total += census.agg_bytes(rows, c.f, c.n_dst, c.kept)
        bwd = [c for c in calls if c.dst_rows is not None]
        dst_rows = torch.stack([c.dst_rows for c in bwd]).tolist() \
            if bwd else []
        for c, rows in zip(bwd, dst_rows):
            total += census.agg_bwd_bytes(c.n_src, c.f, rows, c.kept)
    data["agg_bytes"] = total


def record_regions(ctx, tr):
    """The host regions of a round: ``pull``, ``push`` (each ending in a
    synchronise), ``step``, ``copy`` and ``fedavg_eval``.  Returns the
    undos."""
    import repro_torch.core.federated as fed

    rec = ctx.rec
    sync = tr._sync
    undo = [rec.wrap(tr, "_fill_cache", "pull", sync=sync),
            rec.wrap(tr, "_compute_push", "push", sync=sync),
            rec.wrap(tr, "train_minibatches", "step"),
            rec.wrap(fed, "blocks_to_arrays", "copy"),
            rec.wrap(tr, "aggregate", "fedavg_eval")]
    for ex in tr.ex_clients:
        if ex is not None:
            undo.append(rec.wrap(ex, "apply_push", "push", sync=sync))
    return undo


def first_round(tr, init: list, b1: float) -> dict:
    """Run the first round and keep what the reference is held to."""
    out: dict = {"loss": []}
    calls = [0]
    opt = tr.opt

    def step(params, grads, state):
        new, state = opt.step(params, grads, state)
        calls[0] += 1
        if calls[0] == 1:
            out["grad_norms"] = [float(torch.linalg.vector_norm(m)) / (1 - b1)
                                 for m in state.mu]
        if calls[0] == 3:
            out["step3_norms"] = [float(torch.linalg.vector_norm(p - p0))
                                  for p, p0 in zip(new, init)]
        return new, state

    inner = tr.train_minibatches

    def train_minibatches(ci, params, opt_state, batches):
        res = inner(ci, params, opt_state, batches)
        if ci == 0 and len(out["loss"]) < 3:
            out["loss"] += [float(x) for x in res[2][: 3 - len(out["loss"])]]
        return res

    tr.opt = dataclasses.replace(opt, step=step)
    tr.train_minibatches = train_minibatches
    try:
        stats = tr.run_round(0, 0.0)
    finally:
        tr.opt = opt
        del tr.train_minibatches
    out["round_norms"] = [float(torch.linalg.vector_norm(p.detach() - p0))
                          for p, p0 in zip(tr.model.leaves(), init)]
    out["acc"] = stats.accuracy
    if tr.exchange is not None:
        gids = np.unique(np.concatenate([sh.push_nodes for sh in tr.shards]))
        out["table"] = [t.cpu().numpy() for t in tr.exchange.gather(gids)]
    return out


@dataclasses.dataclass
class State:
    arrays: dict
    init: list
    trainer: object
    counts: Counts
    undo: list
    program: dict = None
    rounds: int = 1
    #: the global model's leaves after the window's last round
    last_leaves: list = None


def setup(ctx) -> State:
    cfg, wl = ctx.cell.config, ctx.cell.workload
    arrays = gen_graph.load(ctx.root, cfg)
    ctx.mark("graph")
    init = init_leaves(cfg, ctx.seed, ctx.device)
    counts = Counts()
    undo = [cut_epochs(ctx, counts)]
    tr = build_trainer(ctx, arrays, wl["strategy"], init)
    ctx.mark("trainer")
    tr.pretrain_round()
    ctx.mark("bootstrap")
    st = State(arrays, init, tr, counts, undo)
    st.program = first_round(tr, init, cfg["model"]["optimizer"]["b1"])
    ctx.mark("first_round")
    if ctx.trace:
        undo += record_kernels(ctx) + record_regions(ctx, tr)
    return st


def expected_minibatches(cfg: dict) -> int:
    m = cfg["model"]
    return m["clients"] * m["epochs_per_round"] * cfg["minibatches_per_epoch"]


def window(ctx, st: State) -> dict:
    from repro_torch.obsv.trace import TRACE

    tr, c = st.trainer, st.counts
    want = expected_minibatches(ctx.cell.config)
    if ctx.trace:
        TRACE.clear()
        TRACE.enable()
    rounds = []
    c.flops = 0
    t_win = time.perf_counter()
    while True:
        c.minibatches = c.seeds = 0
        t0 = time.perf_counter()
        stats = tr.run_round(st.rounds, 0.0)
        t1 = time.perf_counter()
        st.rounds += 1
        rounds.append({"t0": t0, "t1": t1, "minibatches": c.minibatches,
                       "seeds": c.seeds})
        print(f"round {st.rounds - 1}: {t1 - t0} s cpu {host.current_cpu()}",
              file=sys.stderr)
        if t1 - t_win >= ctx.seconds:
            break
    st.program["window_acc"] = stats.accuracy
    st.last_leaves = [p.detach().clone() for p in tr.model.leaves()]
    if ctx.trace:
        TRACE.disable()
        resolve_kernel_bytes(ctx.rec.data)
        ctx.rec.data["spans"] = [(e[0], e[3], e[4])
                                 for e in TRACE.snapshot(clear=True)["events"]]
        ctx.rec.data.update(rounds=rounds, flops=c.flops)
    wall = rounds[-1]["t1"] - rounds[0]["t0"]
    bad = [r["minibatches"] for r in rounds if r["minibatches"] != want]
    if bad:
        print(f"rounds trained {bad} minibatches, not {want}",
              file=sys.stderr)
    return {"train_vertices_per_s": sum(r["seeds"] for r in rounds) / wall,
            "attempted": len(rounds), "failed": len(bad)}


def release(st: State) -> None:
    for undo in reversed(st.undo):
        undo()
    st.trainer = None


def reference(ctx, st: State, **kw) -> dict:
    """The reference's records of the first round and, after a window,
    its accuracy of the model the window's last round left (``kw``: its
    precision or a planted fault)."""
    cfg, wl = ctx.cell.config, ctx.cell.workload
    fed = Federation(st.arrays, st.arrays["part"], cfg, wl["strategy"],
                     st.init, ctx.seed, ctx.device, **kw)
    out = fed.first_round()
    if st.last_leaves is not None:
        out["window_acc"] = fed.evaluate(st.last_leaves)
    return out


def window_reference(ctx, st: State, **kw) -> float:
    """The reference's accuracy of the model the window's last round left,
    alone (``kw``: its precision or a planted fault)."""
    return Evaluator(st.arrays, ctx.cell.config, ctx.seed, ctx.device,
                     **kw)(st.last_leaves)


def check(ctx, st: State) -> dict:
    return compare.train_numbers(st.program, reference(ctx, st))
