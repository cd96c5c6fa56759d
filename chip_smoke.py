#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

It takes no arguments: it always runs the one configuration below.

Phases, each of which fails the run:

1. Setup: print the card's name and power limit, build every CUDA kernel
   from ``src/repro_torch/csrc`` (one nvcc per source, in parallel) and
   build the reddit-preset graph, its partition and client shards.
2. Kernels: each kernel entry point against its plain PyTorch version on
   the card, at the slice's shapes and on edge cases: the int8 codec,
   gather and scatter-set bit-exact; the segment mean within rtol = atol
   = 1e-6 of its plain version run on a CPU copy of the inputs (which
   adds in the kernel's order), and scatter-add with duplicate rows within 1e-6 of each row's
   summed magnitudes (atomics add in no fixed order).  Each is timed with CUDA events beside its
   plain version, the one PyTorch call that computes the same function
   where there is one, and its bound (bytes moved over 3.35 TB/s).
3. Reference: publish and serve a small graph on the card and on the CPU
   (plain versions) from the same seed; published tables agree within
   one int8 step and predictions agree.
4. Slice: the reddit preset, 4 clients, Strategy E (no pruning),
   GraphConv L=3 hidden 32 from a seeded init, in-process transport on
   the card with the int8 codec: bootstrap push, export for serving,
   then 2048 Zipf queries (half at threshold 1.0, half at 0.5)
   through the batched early-exit serving plane.  The launch counters
   are zeroed just before and read just after.  Queries/s and latency
   come from this uninstrumented drain; the per-forward and per-layer
   breakdown (host planning, cache) from a second drain of fresh
   queries with host timers wrapped around those methods, and the
   device's busy share from a third, profiled one.
5. Checks: every request answered exactly once, threshold-1.0 answers
   equal offline_predict, every kernel launched on the slice, finite
   confidences, and a clean ``torch.cuda.synchronize()``.
6. Training slice: the same graph and partition, 4 clients, Strategy OPG
   (retention P_4, scored pruning to the top 25 % by degree) with the
   int8 codec, GraphConv L=3 hidden 32 from a seeded init, Adam lr 1e-2.
   The launch counters are zeroed just before the trainer is built (the
   scored pruning runs the top-k count kernel) and read after one short
   round: bootstrap push; per client a cache fill, the first 32
   minibatches of its sampler's epoch through ``train_minibatches`` and
   the push plan; then the pushes, FedAvg and evaluation.  Every loss
   must be finite, each client's last 8 losses must average below its
   first 8, and all seven kernels must have launched.  Set-up seconds by
   phase, per-step sampling / block copy / forward+backward+Adam times,
   the device's busy share over 16 profiled steps and the peak memory
   are printed; the trained model is then published and served once to
   count early exits.
7. Training kernels: the aggregation's backward and the top-k count
   against their plain versions at the slice's shapes (a minibatch's
   layer-2 block, layer 2 of ``full_propagate`` on client 0, client 0's
   101,526 scores) and at a Papers-like 40M scores: the backward within
   1e-6 of each row's summed term magnitudes (atomics add in no fixed
   order), the masks bit-equal, ``top_fraction`` equal to an
   ``np.lexsort`` selection.
8. Training reference: one round of the same strategy on a small graph
   on the card and on the CPU (plain versions) from the same seed; byte
   counts and RPC sizes equal, loss within 1 % and accuracy within 2
   points.

The line before the last is the card's name and power limit; the one
before it is the kernels' JSON report; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without it.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
TOL = 1e-6
DEV = "cuda"
SCALE = 58.0                  # reddit preset scale: 232,000 vertices
N_QUERIES = 2048
TRAIN_STEPS = 32              # minibatches per client in the short round
PROFILED_STEPS = 16
#: the kernels the serving path runs; training adds the aggregation's
#: backward and the top-k count
SERVE_KERNELS = ("quantize_int8", "dequantize_int8", "gather_quantize",
                 "dequant_scatter", "gnn_aggregate")
PAPERS_SCORES = 40_000_000    # remote-vertex scores at Papers scale


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, *, iters: int = 50, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_events(torch, run, sessions: int = 1) -> list:
    """The device-side events (kernels, copies) of ``run()`` under
    torch.profiler.  The card's CUPTI tracing has come back empty in some
    runs, so up to ``sessions`` sessions are tried before giving up
    (an empty list: "not measured")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if evs:
            return evs
    return []


def device_ms(torch, fn, kernel: str, *, iters: int = 10,
              per_call: bool = False) -> float | None:
    """Mean device milliseconds of one launch of CUDA kernel ``kernel``
    (or, with ``per_call``, of all its launches in one call of ``fn``)
    while ``fn`` runs ``iters`` times (torch.profiler), without the host
    time that back-to-back calls of a small kernel are bound by; None
    when the profiler saw no device event at all."""
    fn()

    def run():
        for _ in range(iters):
            fn()
    evs = device_events(torch, run, sessions=2)
    if not evs:
        print(f"device_ms {kernel}: the profiler saw no device event; "
              "not measured", flush=True)
        return None
    hits = [e for e in evs if kernel in e.name]
    check(len(hits) > 0, f"the profiler saw no {kernel} launch among "
                         f"{sorted({e.name[:80] for e in evs})[:12]}")
    return sum(e.time_range.elapsed_us() for e in hits) \
        / (iters if per_call else len(hits)) / 1e3


def busy_share(evs: list, wall: float) -> dict:
    """Device busy time and share of a profiled window from its device
    events, with the top items by name; None when none were seen."""
    if not evs:
        return {"device_busy_s": None, "device_busy_share": None,
                "device_idle_share": None, "top_device_ms": {}}
    per_name: dict[str, float] = {}
    for e in evs:
        key = e.name[:60]
        per_name[key] = per_name.get(key, 0.0) + e.time_range.elapsed_us()
    busy = sum(per_name.values()) / 1e6
    top = sorted(per_name.items(), key=lambda kv: kv[1], reverse=True)[:8]
    return {"device_busy_s": busy, "device_busy_share": busy / wall,
            "device_idle_share": 1.0 - busy / wall,
            "top_device_ms": {k: v / 1e3 for k, v in top}}


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def max_err(a, b) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def add_entry(report: list, name, source, replaces, err, shape, ms,
              plain_ms, nbytes, library_ms=None, **extra) -> None:
    """One kernel's row of the JSON report (launches filled in later)."""
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": 0, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms(nbytes),
           "bound_by": "bytes", "library_ms": library_ms, **extra}
    print(f"kernel {name}: shape {shape} max|d| {err:.3g} "
          f"ms {ms:.4f} device_ms {extra['device_ms']} plain_ms "
          f"{plain_ms:.4f} bound_ms {row['bound_ms']:.4f} library_ms "
          f"{library_ms}", flush=True)
    report.append(row)


# -- phase 2: kernels against their plain versions ---------------------------

def kernel_phase(torch, np, shards, num_vertices: int) -> list[dict]:
    from repro_torch.kernels import exchange_fused as fused
    from repro_torch.kernels import gnn_aggregate as agg_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.models.gnn import shard_to_arrays

    dev = "cuda"
    gen = torch.Generator(device="cpu").manual_seed(1234)
    hidden = 32
    sh = shards[0]
    n_local, n_pull = sh.num_local, len(sh.pull_nodes)
    cap = 256
    while cap < num_vertices:
        cap *= 2
    report = []

    def rand(n, h):
        x = torch.randn((n, h), generator=gen) * 3
        if n:
            x[n // 2] = 0.0                        # an all-zero row
        return x.to(dev)

    def entry(*args, **kw):
        add_entry(report, *args, **kw)

    # quantize_int8 / dequantize_int8: the published rows of one client
    for n, h in ((n_local, hidden), (257, 100), (300, 16), (0, hidden)):
        x = rand(n, h)
        q, s = ops.quantize_int8(x)
        rq, rs = ref.quantize_int8(x)
        check(torch.equal(q, rq) and torch.equal(s, rs),
              f"quantize_int8 differs from plain at {(n, h)}")
        d = ops.dequantize_int8(q, s)
        check(torch.equal(d, ref.dequantize_int8(rq, rs)),
              f"dequantize_int8 differs from plain at {(n, h)}")
    x = rand(n_local, hidden)
    q, s = ops.quantize_int8(x)
    n = n_local
    entry("quantize_int8", "src/repro_torch/csrc/quantize_rows.cu",
          "src/repro/kernels/quantize.py:151", 0.0, (n, hidden),
          time_ms(torch, lambda: ops.quantize_int8(x)),
          time_ms(torch, lambda: ref.quantize_int8(x)),
          n * hidden * 4 + n * hidden + n * 4,
          device_ms=device_ms(torch, lambda: ops.quantize_int8(x),
                              "quantize_rows_kernel"))
    entry("dequantize_int8", "src/repro_torch/csrc/dequantize_rows.cu",
          "src/repro/kernels/quantize.py:191", 0.0, (n, hidden),
          time_ms(torch, lambda: ops.dequantize_int8(q, s)),
          time_ms(torch, lambda: ref.dequantize_int8(q, s)),
          n * hidden + n * 4 + n * hidden * 4,
          library_ms=time_ms(torch, lambda: torch.mul(q, s)),
          device_ms=device_ms(torch, lambda: ops.dequantize_int8(q, s),
                              "dequantize_rows_kernel"))

    # gather_quantize: one client's pull set out of the whole table
    table = rand(cap, hidden)
    rows = np.random.default_rng(5).choice(num_vertices, size=n_pull,
                                           replace=False)
    for r in (rows, rows[:0], rows[:257]):
        v, sc = ops.gather_quantize(table, r)
        rv, rsc = ref.gather_quantize(table, torch.from_numpy(r).to(dev))
        check(torch.equal(v, rv) and torch.equal(sc, rsc),
              f"gather_quantize differs from plain for {len(r)} rows")
    idx = ops.row_index(rows, cap, dev, check=True)
    entry("gather_quantize", "src/repro_torch/csrc/quantize_rows.cu",
          "src/repro/kernels/exchange_fused.py:105", 0.0,
          (cap, hidden, n_pull),
          time_ms(torch, lambda: fused.gather_quantize(table, idx)),
          time_ms(torch, lambda: ref.gather_quantize(table, idx)),
          n_pull * 4 + n_pull * hidden * 4 + n_pull * hidden + n_pull * 4,
          entry_ms=time_ms(torch, lambda: ops.gather_quantize(table, rows)),
          device_ms=device_ms(torch, lambda: fused.gather_quantize(table, idx),
                              "quantize_rows_kernel"))

    # dequant_scatter: set (unique rows, plus a dropped sentinel) and add
    pub_rows = np.random.default_rng(6).choice(num_vertices, size=n_local,
                                               replace=False)
    pv, ps = ops.quantize_int8(rand(n_local, hidden))
    t_k, t_p = table.clone(), table.clone()
    with_sentinel = pub_rows.copy()
    with_sentinel[0] = cap                        # out of range: dropped
    ops.dequant_scatter_(t_k, with_sentinel, pv, ps)
    ref.dequant_scatter_(t_p, torch.from_numpy(with_sentinel).to(dev), pv, ps)
    check(torch.equal(t_k, t_p), "dequant_scatter (set) differs from plain")
    ops.dequant_scatter_(t_k, pub_rows, pv, ps, accumulate=True)
    ref.dequant_scatter_(t_p, torch.from_numpy(pub_rows).to(dev), pv, ps,
                         accumulate=True)
    check(torch.equal(t_k, t_p),
          "dequant_scatter (add, unique rows) differs from plain")
    # duplicate rows: atomics add in no fixed order, so the difference is
    # held to TOL times the summed magnitudes of each row's terms
    dup = np.random.default_rng(7).integers(0, n_local // 2, size=n_local)
    dup_t = torch.from_numpy(dup).to(dev)
    mag = ref.dequant_scatter_(t_p.abs(), dup_t, pv.abs(), ps,
                               accumulate=True)
    ops.dequant_scatter_(t_k, dup, pv, ps, accumulate=True)
    ref.dequant_scatter_(t_p, dup_t, pv, ps, accumulate=True)
    add_err = max_err(t_k, t_p)
    check(bool(((t_k - t_p).abs() <= TOL * mag + TOL).all()),
          f"dequant_scatter (add, duplicate rows) off by {add_err}")
    pidx = ops.row_index(pub_rows, cap, dev, check=False)
    entry("dequant_scatter", "src/repro_torch/csrc/dequantize_rows.cu",
          "src/repro/kernels/exchange_fused.py:180", add_err,
          (cap, hidden, n_local),
          time_ms(torch, lambda: fused.dequant_scatter_(t_k, pidx, pv, ps)),
          time_ms(torch, lambda: ref.dequant_scatter_(t_p, pidx, pv, ps)),
          n_local * 4 + n_local * hidden + n_local * 4
          + n_local * hidden * 4,
          entry_ms=time_ms(torch, lambda: ops.dequant_scatter_(
              t_k, pub_rows, pv, ps)),
          device_ms=device_ms(torch, lambda: fused.dequant_scatter_(
              t_k, pidx, pv, ps), "dequantize_rows_kernel"))

    # gnn_aggregate: layer 1 of full_propagate on one client's shard
    arr = shard_to_arrays(sh, dev)
    remote = arr["src_is_remote"]
    feats = arr["features"]
    src_tbl = torch.cat([feats, torch.zeros((1, feats.shape[1]),
                                            device=dev)], 0)
    src_idx = torch.where(remote, sh.num_local, arr["edge_src"])
    mask = ~remote
    e_dst = arr["edge_dst"]
    # The kernel sums each row in ascending edge order; the plain version
    # run on a CPU copy of the same inputs adds in that order too, while
    # on the card its index_add_ uses atomics in no fixed order.  So the
    # kernel is held to the CPU run at TOL, and its difference from the
    # card run is reported beside it.
    def agg_check(what, args, n_dst):
        got, cnt = ops.gnn_aggregate(*args, n_dst)
        want, wcnt = ref.segment_mean(*[a.cpu() for a in args], n_dst)
        card, _ = ref.segment_mean(*args, n_dst)
        err = max_err(got.cpu(), want)
        check(torch.equal(cnt.cpu(), wcnt),
              f"gnn_aggregate counts differ from plain ({what})")
        check(torch.allclose(got.cpu(), want, rtol=TOL, atol=TOL),
              f"gnn_aggregate off by {err} ({what})")
        return err, max_err(got, card)

    agg_err, card_err = agg_check("layer 1", (src_tbl, src_idx, e_dst, mask),
                                  n_local)
    # a serving-style block: padded tail with dst=0 and the mask off
    e = 5000
    bs = torch.randint(0, 700, (e,), generator=gen)
    bd = torch.sort(torch.randint(0, 300, (e,), generator=gen)).values
    bm = torch.rand(e, generator=gen) < 0.8
    pad = 1000
    bs = torch.cat([bs, torch.zeros(pad, dtype=bs.dtype)]).to(dev)
    bd = torch.cat([bd, torch.zeros(pad, dtype=bd.dtype)]).to(dev)
    bm = torch.cat([bm, torch.zeros(pad, dtype=torch.bool)]).to(dev)
    errs = agg_check("padded block", (rand(700, hidden), bs, bd, bm), 384)
    agg_err, card_err = max(agg_err, errs[0]), max(card_err, errs[1])
    indptr, indices = agg_mod.csr_from_edges(src_tbl.shape[0], src_idx, e_dst,
                                             mask, n_local)
    n_edges = int(indices.shape[0])
    e_all = int(src_idx.shape[0])
    gathered = src_tbl[indices.long()]
    dst_kept = e_dst[mask].long()
    f = src_tbl.shape[1]
    lib_out = torch.zeros((n_local, f), device=dev)
    entry("gnn_aggregate", "src/repro_torch/csrc/segment_mean_csr.cu",
          "src/repro/kernels/gnn_aggregate.py:69", agg_err,
          (tuple(src_tbl.shape), e_all, n_local),
          time_ms(torch, lambda: ops.gnn_aggregate(src_tbl, src_idx, e_dst,
                                                   mask, n_local)),
          time_ms(torch, lambda: ref.segment_mean(src_tbl, src_idx, e_dst,
                                                  mask, n_local)),
          # the table, every edge's mask byte, the int32 ids of the kept
          # edges only (a masked edge's ids do not change the result), and
          # the mean and count out
          src_tbl.numel() * 4 + e_all + n_edges * (4 + 4)
          + n_local * (f + 1) * 4,
          library_ms=time_ms(torch, lambda: lib_out.index_reduce_(
              0, dst_kept, gathered, "mean", include_self=False)),
          kernel_ms=time_ms(torch, lambda: agg_mod.segment_mean_csr(
              src_tbl, indptr, indices)),
          kept_edges=n_edges, max_abs_err_vs_card_plain=card_err,
          device_ms=device_ms(torch, lambda: agg_mod.segment_mean_csr(
              src_tbl, indptr, indices), "segment_mean_csr_kernel"))
    torch.cuda.synchronize()
    return report


# -- phases 3 and 4: publish and serve ---------------------------------------

def publish(torch, g, part, shards, device: str):
    """Seeded model, transport, bootstrap push and export; returns the
    bundle and the seconds of each step (device work synchronised)."""
    from repro_torch.core.federated import (export_for_serving, pretrain_push,
                                            setup_exchange)
    from repro_torch.exchange import make_transport
    from repro_torch.models.gnn import init_gnn

    secs = {}
    t0 = time.perf_counter()
    gen = torch.Generator(device="cpu").manual_seed(0)
    model = init_gnn("graphconv", g.feat_dim, 32, g.num_classes, 3,
                     generator=gen, device=device)
    tr = make_transport(3, 32, device=device)
    setup_exchange(shards, part, tr)
    secs["setup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pretrain_push(model, shards, tr, "int8", device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    secs["pretrain_push_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bundle = export_for_serving(model, shards, part, tr, "int8",
                                device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    secs["export_s"] = time.perf_counter() - t0
    return bundle, secs


def zipf_queries(np, num_vertices: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_vertices)
    ranks = rng.zipf(1.2, size=n)
    vids = perm[(ranks - 1) % num_vertices]
    thrs = np.where(np.arange(n) % 2 == 0, 1.0, 0.5)
    return vids, thrs


def offline_ref(np, plane, vids) -> dict:
    by_owner: dict[int, list] = {}
    for v in sorted(set(int(v) for v in vids)):
        by_owner.setdefault(int(plane.part[v]), []).append(v)
    out = {}
    for ci, vs in by_owner.items():
        eng = plane.engines[ci]
        for i in range(0, len(vs), eng.batch_size):
            chunk = vs[i: i + eng.batch_size]
            preds = eng.offline_predict(
                np.array([eng.local_id(v) for v in chunk], np.int64))
            out.update({v: int(p) for v, p in zip(chunk, preds)})
    return out


def reference_phase(torch, np) -> None:
    """The same seeded publish + serve on the card and on the CPU."""
    from repro_torch.gnnserve import build_serving
    from repro_torch.graphs import (bfs_partition, make_client_shards,
                                    make_graph)

    results = {}
    for device in ("cuda", "cpu"):
        g = make_graph("reddit", scale=0.5, seed=1)
        part = bfs_partition(g, 4, seed=0)
        shards = make_client_shards(g, part)
        bundle, _ = publish(torch, g, part, shards, device)
        plane = build_serving(bundle, cache_rows=512, serve_fanout=10,
                              batch_size=64, depth_schedule=[1, 3],
                              device=device)
        vids, thrs = zipf_queries(np, g.num_vertices, 256, 3)
        for v, t in zip(vids, thrs):
            plane.submit(int(v), float(t))
        res = {r.rid: r for r in plane.drain()}
        server = bundle["transport"].server
        gids = np.arange(g.num_vertices)
        tables = [t.cpu() for t in server.gather(gids)]
        results[device] = (res, tables)
    (res_g, tab_g), (res_c, tab_c) = results["cuda"], results["cpu"]
    step = max(float(t.abs().max()) for t in tab_c) / 127.0
    for a, b in zip(tab_g, tab_c):
        err = float((a - b).abs().max())
        check(err <= step + 1e-6,
              f"published tables differ by {err} (> one int8 step {step})")
    agree = np.mean([res_g[r].pred == res_c[r].pred for r in res_c])
    check(sorted(res_g) == sorted(res_c), "reference: rid sets differ")
    check(agree >= 0.99, f"reference: only {agree:.3f} of predictions agree")
    print(f"reference: card vs CPU tables within one int8 step, "
          f"prediction agreement {agree:.4f}", flush=True)


@contextlib.contextmanager
def timed(owner, name: str, log: list, args_log: list | None = None):
    """Within the block, each call of ``owner.name`` (a module's function,
    a class's method or an instance's bound method) appends its host
    seconds to ``log`` and, given ``args_log``, its positional
    arguments."""
    inner = getattr(owner, name)
    own = name in vars(owner)

    def wrapper(*args, **kw):
        t = time.perf_counter()
        out = inner(*args, **kw)
        log.append(time.perf_counter() - t)
        if args_log is not None:
            args_log.append(args)
        return out
    setattr(owner, name, wrapper)
    try:
        yield
    finally:
        if own:
            setattr(owner, name, inner)
        else:
            delattr(owner, name)   # the class's method shows through again


def breakdown(torch, np, plane, num_vertices: int, n: int) -> dict:
    """Serve ``n`` fresh queries with host timers around each forward,
    each host plan and each cache lookup: where the serving time goes.
    Kept apart from the timed drain so that queries/s and latency are
    measured on the path users run."""
    fwd_s: list[float] = []
    plan_s: list[float] = []
    cache_s: list[float] = []
    vids, thrs = zipf_queries(np, num_vertices, n, 12)
    with contextlib.ExitStack() as stack:
        for eng in plane.engines.values():
            stack.enter_context(timed(eng, "predict_at_depth", fwd_s))
            stack.enter_context(timed(eng, "_plan", plan_s))
        stack.enter_context(timed(plane.cache, "get", cache_s))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for v, t in zip(vids, thrs):
            plane.submit(int(v), float(t))
        plane.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fwd = np.array(fwd_s) * 1e3
    return {"queries": n, "window_s": wall, "forwards": len(fwd),
            "forward_ms_p50": float(np.percentile(fwd, 50)),
            "forward_ms_p99": float(np.percentile(fwd, 99)),
            "forward_s_total": float(fwd.sum() / 1e3),
            "plan_s_total": float(sum(plan_s)),
            "cache_get_s_total": float(sum(cache_s))}


def device_busy(torch, np, plane, num_vertices: int, n: int) -> dict:
    """Serve ``n`` more queries under torch.profiler: the share of the
    window's wall time the card spent in kernels and copies, and the top
    items (device-side events only: the host ops that launched them
    carry the same time again)."""
    vids, thrs = zipf_queries(np, num_vertices, n, 13)
    wall: list[float] = []

    def run():
        t0 = time.perf_counter()
        for v, t in zip(vids, thrs):
            plane.submit(int(v), float(t))
        plane.drain()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    evs = device_events(torch, run)
    return {"window_s": wall[0], **busy_share(evs, wall[0])}


def slice_phase(torch, np, g, part, shards) -> dict:
    from repro_torch.gnnserve import build_serving
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bundle, pub_secs = publish(torch, g, part, shards, "cuda")
    publish_s = time.perf_counter() - t0

    plane = build_serving(bundle, cache_rows=100_000, serve_fanout=10,
                          batch_size=64, depth_schedule=[1, 3],
                          device="cuda")
    vids, thrs = zipf_queries(np, g.num_vertices, N_QUERIES, 11)
    t0 = time.perf_counter()
    rids = [plane.submit(int(v), float(t)) for v, t in zip(vids, thrs)]
    results = plane.drain()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    st = plane.stats()
    lat = np.array([r.latency for r in results]) * 1e3

    by_rid: dict[int, object] = {}
    for r in results:
        check(r.rid not in by_rid, f"request {r.rid} answered twice")
        by_rid[r.rid] = r
    check(sorted(by_rid) == sorted(rids), "requests lost or invented")
    for name in SERVE_KERNELS:
        check(counts[name] > 0, f"kernel {name} never launched on the slice")
    confs = np.array([r.conf for r in results])
    check(bool(np.all(np.isfinite(confs)) and np.all(confs > 0)
               and np.all(confs <= 1.0)), "confidences out of (0, 1]")
    full = [(rid, int(v)) for rid, v, t in zip(rids, vids, thrs) if t == 1.0]
    ref = offline_ref(np, plane, [v for _, v in full])
    bad = [rid for rid, v in full if by_rid[rid].pred != ref[v]]
    check(not bad, f"{len(bad)} threshold-1.0 answers differ from "
                   "offline_predict")
    parts = breakdown(torch, np, plane, g.num_vertices, N_QUERIES)
    busy = device_busy(torch, np, plane, g.num_vertices, 256)
    torch.cuda.synchronize()
    return {
        "vertices": g.num_vertices, "edges": g.num_edges,
        "publish_s": publish_s, **pub_secs, "queries": N_QUERIES,
        "serve_s": serve_s, "queries_per_s": N_QUERIES / serve_s,
        "forwards": st["forwards"],
        "request_latency_ms_p50": float(np.percentile(lat, 50)),
        "request_latency_ms_p99": float(np.percentile(lat, 99)),
        "exits_by_depth": st["exits_by_depth"],
        "cache_hit_rate": st["cache_hit_rate"],
        "offline_checked": len(full),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "timed_serve": parts,
        "profiled_serve": busy,
        "launches": counts,
    }


# -- phases 6-8: training ------------------------------------------------------

def opg_int8():
    from repro_torch.core.strategies import default_strategies

    return dataclasses.replace(default_strategies()["OPG"], codec="int8",
                               score_kind="degree")


def with_bound(case: dict) -> dict:
    """A kernel case's numbers with its bytes turned into ``bound_ms``."""
    out = {k: v for k, v in case.items() if k != "nbytes"}
    out["bound_ms"] = bound_ms(case["nbytes"])
    return out


def percentiles(np, xs) -> dict:
    a = np.asarray(xs, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)), "mean": float(a.mean())}


def train_slice_phase(torch, np, g, part) -> tuple[dict, object, list]:
    """Build the trainer, bootstrap, and run one short round through the
    trainer's own code; returns the measurements, the trainer and the
    scores of client 0's first ``top_fraction`` call."""
    from repro_torch.core import federated as fed
    from repro_torch.gnnserve import build_serving
    from repro_torch.kernels import ops
    from repro_torch.models.gnn import init_gnn

    setup: dict[str, list] = {k: [] for k in (
        "shards_s", "scores_s", "top_fraction_s", "client_state_s",
        "eval_state_s")}
    topf_args: list = []
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t_main = time.perf_counter()
    with contextlib.ExitStack() as stack:
        T = fed.FederatedGNNTrainer
        for owner, name, key, args in (
                (fed, "make_client_shards", "shards_s", None),
                (fed, "score_remote_nodes", "scores_s", None),
                (fed, "top_fraction", "top_fraction_s", topf_args),
                (T, "_build_client_state", "client_state_s", None),
                (T, "_build_eval_state", "eval_state_s", None)):
            stack.enter_context(timed(owner, name, setup[key], args))
        model = init_gnn("graphconv", g.feat_dim, 32, g.num_classes, 3,
                         generator=torch.Generator().manual_seed(0),
                         device=DEV)
        trainer = T(g, 4, opg_int8(), part=part, model=model,
                    device=DEV)
        torch.cuda.synchronize()
    construct_s = time.perf_counter() - t_main
    t0 = time.perf_counter()
    trainer.pretrain_round()
    torch.cuda.synchronize()
    pretrain_s = time.perf_counter() - t0

    sample_ms, copy_ms, compute_ms, step_ms = [], [], [], []
    copied: list = []
    inner_copy = fed.blocks_to_arrays

    def copy_blocks(mb, device):
        t = time.perf_counter()
        out = inner_copy(mb, device)
        torch.cuda.synchronize()
        copy_ms.append((time.perf_counter() - t) * 1e3)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        copied.append(ev)
        return out

    results, losses, fill_s, push_s, iters = [], {}, [], [], {}
    fed.blocks_to_arrays = copy_blocks
    try:
        t_loop = time.perf_counter()
        for ci in range(4):
            t0 = time.perf_counter()
            trainer._fill_cache(ci)
            torch.cuda.synchronize()
            fill_s.append(time.perf_counter() - t0)
            it = iters[ci] = trainer.samplers[ci].epoch()
            params = copy.deepcopy(trainer.model)
            opt_state = trainer.opt.init(params.leaves())
            ls = []
            for _ in range(TRAIN_STEPS):
                t_step = time.perf_counter()
                mb = next(it)
                sample_ms.append((time.perf_counter() - t_step) * 1e3)
                params, opt_state, out = trainer.train_minibatches(
                    ci, params, opt_state, [mb])
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                end.synchronize()
                compute_ms.append(copied[-1].elapsed_time(end))
                step_ms.append((time.perf_counter() - t_step) * 1e3)
                ls += out
            t0 = time.perf_counter()
            plan, _, _ = trainer._compute_push(ci, params)
            torch.cuda.synchronize()
            push_s.append(time.perf_counter() - t0)
            losses[ci] = [float(x) for x in ls]
            results.append(fed.ClientRoundResult(
                client_id=ci, params=params, phases=fed.PhaseTimes(),
                rpc_sizes=[], push_plan=plan,
                weight=float(len(trainer.shards[ci].train_vertices())),
                loss=losses[ci][-1], client_time=0.0))
        loop_s = time.perf_counter() - t_loop
    finally:
        fed.blocks_to_arrays = inner_copy
    t0 = time.perf_counter()
    for res in results:
        if res.push_plan is not None:
            trainer.ex_clients[res.client_id].apply_push(res.push_plan)
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t0
    eval_s: list = []
    with timed(trainer, "evaluate", eval_s):
        t0 = time.perf_counter()
        acc = trainer.aggregate(results)
        torch.cuda.synchronize()
        aggregate_s = time.perf_counter() - t0
    main_s = time.perf_counter() - t_main
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    for ci, ls in losses.items():
        check(all(np.isfinite(ls)), f"client {ci}: a loss is not finite")
        first, last = np.mean(ls[:8]), np.mean(ls[-8:])
        check(last < first, f"client {ci}: loss did not fall "
                            f"({first:.4f} -> {last:.4f})")
    for name, c in counts.items():
        check(c > 0, f"kernel {name} never launched on the training slice")
    check(np.isfinite(acc) and 0.0 <= acc <= 1.0, f"accuracy {acc}")

    # device busy share over PROFILED_STEPS steps of client 0, batches
    # sampled beforehand (the window holds the copy and the step only)
    batches = [next(iters[0]) for _ in range(PROFILED_STEPS)]
    params = copy.deepcopy(trainer.model)
    opt_state = trainer.opt.init(params.leaves())
    wall: list[float] = []

    def run():
        t0 = time.perf_counter()
        trainer.train_minibatches(0, params, opt_state, batches)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    evs = device_events(torch, run)
    window = {"steps": PROFILED_STEPS, "window_s": wall[0],
              **busy_share(evs, wall[0])}

    # does the trained model answer any query at depth 1 yet?
    plane = build_serving(trainer.export_for_serving(), cache_rows=100_000,
                          serve_fanout=10, batch_size=64,
                          depth_schedule=[1, 3], device=DEV)
    vids, _ = zipf_queries(np, g.num_vertices, 512, 21)
    for v in vids:
        plane.submit(int(v), 0.5)
    served = plane.drain()
    check(len(served) == len(vids), "trained model: requests lost")
    torch.cuda.synchronize()

    n_steps = len(step_ms)
    out = {
        "strategy": opg_int8().describe(),
        "setup_s": {"construct_s": construct_s,
                    **{k: float(sum(v)) for k, v in setup.items()},
                    "shard_builds": len(setup["shards_s"]),
                    "pretrain_round_s": pretrain_s},
        "shards": [{"local": sh.num_local, "remote": sh.num_remote,
                    "all_remote": len(sh.all_pull_nodes),
                    "push": len(sh.push_nodes),
                    "train": len(sh.train_vertices()),
                    "edges": int(sh.indptr[-1])} for sh in trainer.shards],
        "steps": n_steps,
        "step_ms": percentiles(np, step_ms),
        "sample_ms": percentiles(np, sample_ms),
        "copy_ms": percentiles(np, copy_ms),
        "fwd_bwd_adam_ms": percentiles(np, compute_ms),
        "steps_per_s": n_steps / sum(step_ms) * 1e3,
        "train_loop_s": loop_s,
        "fill_cache_s": fill_s, "push_compute_s": push_s,
        "apply_push_s": apply_s, "aggregate_s": aggregate_s,
        "fedavg_s": aggregate_s - eval_s[0], "evaluate_s": eval_s[0],
        "main_path_s": main_s, "accuracy": acc,
        "loss_first8": {ci: float(np.mean(v[:8])) for ci, v in losses.items()},
        "loss_last8": {ci: float(np.mean(v[-8:])) for ci, v in losses.items()},
        "peak_mem_gb": peak_gb,
        "profiled_steps": window,
        "trained_serving_exits_at_0.5": plane.stats()["exits_by_depth"],
    }
    return out, counts, trainer, topf_args[0][0]


def train_kernel_phase(torch, np, trainer, scores0) -> list[dict]:
    """The aggregation's backward and the top-k count kernel against their
    plain versions at the training slice's shapes."""
    from repro_torch.core.pruning import top_fraction
    from repro_torch.kernels import gnn_aggregate as agg_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.models.gnn import blocks_to_arrays

    dev = DEV
    gen = torch.Generator(device="cpu").manual_seed(4321)
    hidden = trainer.hidden
    report: list = []

    def bwd_case(n_src, e_src, e_dst, mask, n_dst):
        indptr, indices = agg_mod.csr_from_edges(n_src, e_src, e_dst, mask,
                                                 n_dst)
        cnt = (indptr[1:] - indptr[:-1]).to(torch.float32)
        g = torch.randn((n_dst, hidden), generator=gen).to(dev)
        got = agg_mod.segment_mean_csr_bwd(g, indptr, indices, cnt, n_src)
        want = ref.segment_mean_backward(g, e_src, e_dst, mask, cnt, n_src)
        mag = ref.segment_mean_backward(g.abs(), e_src, e_dst, mask, cnt,
                                        n_src)
        err = max_err(got, want)
        check(bool(((got - want).abs() <= TOL * mag + TOL).all()),
              f"segment_mean_csr_bwd off by {err} at {n_src}->{n_dst}")
        kept = int(indices.shape[0])
        scaled = (g / cnt.clamp_min(1.0)[:, None])[e_dst[mask].long()]
        src_kept = indices.long()
        lib_out = torch.zeros((n_src, hidden), device=dev)
        return {
            "err": err, "shape": (n_src, hidden, n_dst, int(e_src.shape[0])),
            "kept_edges": kept,
            "ms": time_ms(torch, lambda: agg_mod.segment_mean_csr_bwd(
                g, indptr, indices, cnt, n_src)),
            "plain_ms": time_ms(torch, lambda: ref.segment_mean_backward(
                g, e_src, e_dst, mask, cnt, n_src)),
            "library_ms": time_ms(torch, lambda: lib_out.index_add_(
                0, src_kept, scaled)),
            "device_ms": device_ms(torch, lambda: agg_mod.segment_mean_csr_bwd(
                g, indptr, indices, cnt, n_src),
                "segment_mean_csr_bwd_kernel"),
            # grad_mean and cnt read once, indptr and the kept edges'
            # int32 ids, grad_src written once
            "nbytes": n_dst * hidden * 4 + n_dst * 4 + (n_dst + 1) * 8
            + kept * 4 + n_src * hidden * 4,
        }

    # layer 2 of a full-width minibatch (the train step's shape)
    mb = next(iter(trainer.samplers[0].epoch()))
    blk = blocks_to_arrays(mb, dev)["blocks"][1]
    b = mb.blocks[1]
    step = bwd_case(b.p_src, blk["edge_src"], blk["edge_dst"],
                    blk["edge_mask"], b.p_dst)
    # layer 2 of full_propagate on client 0 (local rows + cached remotes)
    arr = trainer.shard_arrays[0]
    n_src = arr["num_local"] + trainer._caches[0][0].shape[0]
    full = bwd_case(n_src, arr["edge_src"], arr["edge_dst"],
                    torch.ones_like(arr["src_is_remote"]), arr["num_local"])
    add_entry(report, "segment_mean_bwd",
              "src/repro_torch/csrc/segment_mean_csr_bwd.cu",
              "src/repro/kernels/gnn_aggregate.py:69 (backward of)",
              max(step["err"], full["err"]), step["shape"], step["ms"],
              step["plain_ms"], step["nbytes"],
              library_ms=step["library_ms"], device_ms=step["device_ms"],
              kept_edges=step["kept_edges"],
              full_propagate=with_bound(full))
    print("kernel segment_mean_bwd at full_propagate: "
          + json.dumps(report[-1]["full_propagate"]), flush=True)

    def topk_case(scores_np, frac, iters):
        n = len(scores_np)
        k = int(np.ceil(frac * n))
        s = torch.from_numpy(scores_np.astype(np.float32)).to(dev)
        got = ops.topk_mask(s, k)
        check(torch.equal(got, ref.topk_mask(s, k)),
              f"topk_mask differs from plain at n={n}")
        thr = s[n // 3].reshape(())
        check(int(ops.count_ge(s, thr)) == int((s >= thr).sum()),
              f"count_ge differs from plain at n={n}")
        sel = top_fraction(scores_np, frac, device=dev)
        order = np.lexsort((np.arange(n), -scores_np))
        check(np.array_equal(sel, np.sort(order[:k])),
              f"top_fraction differs from the lexsort selection at n={n}")
        lib_mask = torch.zeros(n, dtype=torch.bool, device=dev)
        return {
            "shape": (n, k), "candidates": int(got.sum()),
            "ms": time_ms(torch, lambda: ops.topk_mask(s, k), iters=iters),
            "plain_ms": time_ms(torch, lambda: ref.topk_mask(s, k),
                                iters=iters),
            "library_ms": time_ms(torch, lambda: lib_mask.scatter_(
                0, torch.topk(s, k).indices, True), iters=iters),
            "device_ms": device_ms(torch, lambda: ops.topk_mask(s, k),
                                   "count_ge_kernel", per_call=True),
            "count_ms": time_ms(torch, lambda: ops.count_ge(s, thr),
                                iters=iters),
            "count_device_ms": device_ms(torch, lambda: ops.count_ge(s, thr),
                                         "count_ge_kernel"),
            "count_bound_ms": bound_ms(n * 4),
            "nbytes": 25 * n * 4,      # 25 counting passes over the scores
        }

    frac = trainer.strategy.scored_prune_frac
    mine = topk_case(np.asarray(scores0), frac, 50)
    rng = np.random.default_rng(40)
    papers = np.minimum(rng.zipf(2.0, PAPERS_SCORES), 10**6).astype(
        np.float64)
    big = topk_case(papers, frac, 10)
    add_entry(report, "count_ge", "src/repro_torch/csrc/count_ge.cu",
              "src/repro/kernels/topk_mask.py:46", 0.0, mine["shape"],
              mine["ms"], mine["plain_ms"], mine["nbytes"],
              library_ms=mine["library_ms"], device_ms=mine["device_ms"],
              entry="topk_mask (25 count launches)",
              candidates=mine["candidates"], count_ms=mine["count_ms"],
              count_device_ms=mine["count_device_ms"],
              count_bound_ms=mine["count_bound_ms"],
              papers_40m=with_bound(big))
    print("kernel count_ge at 40M: " + json.dumps(report[-1]["papers_40m"]),
          flush=True)
    torch.cuda.synchronize()
    return report


def train_reference_phase(torch, np) -> dict:
    """One round of OPG + int8 on a small graph, on the card and on the
    CPU (plain versions), from the same seeded model."""
    from repro_torch.core.federated import FederatedGNNTrainer
    from repro_torch.graphs import make_graph
    from repro_torch.models.gnn import init_gnn

    out = {}
    for device in (DEV, "cpu"):
        g = make_graph("reddit", scale=0.5, seed=1)
        model = init_gnn("graphconv", g.feat_dim, 32, g.num_classes, 3,
                         generator=torch.Generator().manual_seed(0),
                         device=device)
        tr = FederatedGNNTrainer(g, 4, opg_int8(), model=model,
                                 device=device)
        s = tr.train(1)[0]
        log = tr.exchange.log
        out[device] = (s, (log.bytes, log.rpcs, log.embeddings))
    (sg, lg), (sc, lc) = out[DEV], out["cpu"]
    check(lg == lc, f"training reference: transfer logs differ {lg} {lc}")
    check(sg.pull_rpc_sizes == sc.pull_rpc_sizes
          and sg.embeddings_stored == sc.embeddings_stored,
          "training reference: RPC sizes or stored rows differ")
    check(abs(sg.train_loss - sc.train_loss) <= 1e-2 * sc.train_loss,
          f"training reference: loss {sg.train_loss} vs {sc.train_loss}")
    check(abs(sg.accuracy - sc.accuracy) <= 0.02,
          f"training reference: accuracy {sg.accuracy} vs {sc.accuracy}")
    res = {"loss_cuda": sg.train_loss, "loss_cpu": sc.train_loss,
           "acc_cuda": sg.accuracy, "acc_cpu": sc.accuracy,
           "log_bytes_rpcs_embeddings": lg}
    print(f"training reference: {json.dumps(res)}", flush=True)
    return res


def main() -> int:
    if len(sys.argv) > 1:
        raise SmokeFailure("chip_smoke.py takes no arguments")
    src = pathlib.Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        raise SmokeFailure(f"no port package under {src}")
    sys.path.insert(0, str(src))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.graphs import (bfs_partition, make_client_shards,
                                    make_graph)
    from repro_torch.kernels import _build

    t_all = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"build: {_build.build_all():.2f} s (nvcc, one per source, "
          "in parallel)", flush=True)
    t0 = time.perf_counter()
    g = make_graph("reddit", scale=SCALE, seed=0)
    part = bfs_partition(g, 4, seed=0)
    shards = make_client_shards(g, part)
    print(f"graph: reddit scale {SCALE}: {g.num_vertices} vertices, "
          f"{g.num_edges} edges, 4 shards, built on the host in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    report = kernel_phase(torch, np, shards, g.num_vertices)
    reference_phase(torch, np)
    res = slice_phase(torch, np, g, part, shards)
    print("slice: " + json.dumps({k: v for k, v in res.items()
                                  if k != "launches"}), flush=True)
    train, train_counts, trainer, scores0 = train_slice_phase(
        torch, np, g, part)
    print("training slice: " + json.dumps(train), flush=True)
    report += train_kernel_phase(torch, np, trainer, scores0)
    del trainer
    train_reference_phase(torch, np)
    for row in report:
        row["launches_serve"] = res["launches"].get(row["name"], 0)
        row["launches_train"] = train_counts[row["name"]]
        row["launches"] = row["launches_serve"] + row["launches_train"]
    print(f"launches: serve {json.dumps(res['launches'])} train "
          f"{json.dumps(train_counts)}", flush=True)
    print(f"total: {time.perf_counter() - t_all:.1f} s", flush=True)
    torch.cuda.synchronize()
    print(json.dumps({"kernels": report}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
