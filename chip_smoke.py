#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

It takes no arguments: it always runs the one configuration below.

Phases, each of which fails the run:

1. Setup: print the card's name and power limit, build every CUDA kernel
   from ``src/repro_torch/csrc`` (one nvcc per source, in parallel)
   while the host builds the reddit-preset graph, its partition and
   client shards.
2. Kernels: each kernel entry point against its plain PyTorch version on
   the card, at the slice's shapes and on edge cases: the int8 codec
   (the encode also on a column slice and at an odd float, plain and
   gathered), gather and scatter-set bit-exact; the scatter-add with
   duplicate rows bit-equal to the plain version on a CPU copy (a
   sequential ``index_add_``) and to itself; the segment mean, over the
   CSR built on the host and over the glue's, bit-equal to its plain
   version run on a CPU copy of the inputs (which adds in the kernel's
   order), with the kept-degree statistics of layer 1 printed.  Each is
   timed with CUDA events beside its plain version, the one PyTorch call
   that computes the same function where there is one, and its bound
   (bytes moved over 3.35 TB/s); the host pieces of one
   ``dequantize_int8`` call are printed on one line
   (``tools/launch_pieces.py``).
3. Reference: publish and serve a small graph on the card and on the CPU
   (plain versions) from the same seed; published tables agree within
   one int8 step and predictions agree.
4. Slice: the reddit preset, 4 clients, Strategy E (no pruning),
   GraphConv L=3 hidden 32 from a seeded init, in-process transport on
   the card with the int8 codec: bootstrap push, export for serving,
   then 2048 Zipf queries (half at threshold 1.0, half at 0.5)
   through the batched early-exit serving plane.  Here and in step 6
   every aggregation runs over the CSRs built on the host with the
   blocks and shards: a call of the card's CSR glue fails the run.  The launch counters
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
   scored pruning runs the top-k selection kernel) and read after one short
   round: bootstrap push; per client a cache fill, the first 32
   minibatches of its sampler's epoch through ``train_minibatches`` and
   the push plan; then the pushes, FedAvg and evaluation.  Every loss
   must be finite, each client's last 8 losses must average below its
   first 8, and the seven kernels of serving and training must have
   launched.  Every aggregation launch of the round is also tallied by
   where it ran (a minibatch block or ``full_propagate``) and at what
   shape, from the launch counter across each of the model's
   aggregation calls; the tally must account for all of them.  Set-up seconds by phase, per-step sampling / block copy /
   forward+backward+Adam times, the device's busy share over 16 profiled
   steps and the peak memory are printed; the trained model is then
   published and served once to count early exits.
7. Training kernels: one training step's forward and backward and two
   ``full_propagate`` calls run under ``set_sync_debug_mode("error")``
   (no aggregation call waits on the card); the aggregation forward at
   each of a minibatch's three blocks (row 5'' is layer 2's) bit-equal
   to its plain version on a CPU copy, each with the launches the round
   made at its shape (the tally); the aggregation's backward and the top-k selection
   against their plain versions at the slice's shapes (a minibatch's
   layer-2 block, layer 2 of ``full_propagate`` on client 0, client 0's
   101,526 scores) and at a Papers-like 40M scores: the backward
   bit-equal to its plain version on a CPU copy (which adds in the
   kernel's order) and to itself over two launches, the masks bit-equal
   to the plain version on the card and on the CPU, the single-pass
   ``count_ge`` (on no path) exact, ``top_fraction`` equal to an
   ``np.lexsort`` selection.
8. Training reference: one round of the same strategy on a small graph
   on the card and on the CPU (plain versions) from the same seed; byte
   counts and RPC sizes equal, loss within 1 % and accuracy within 2
   points.
9. Pull then aggregate (before step 8): client 0's layer-2
   ``full_propagate`` source rows (85,185 × 32) written to an embedding
   server on the card, pulled back in int8 with ``gather_quantized`` and
   aggregated by ``dequant_aggregate`` over the edge set's CSR built on
   the host (counters zeroed just before, read just after; a call of the
   CSR glue or a host sync in the aggregation fails the run); bit-equal
   to ``gnn_aggregate(dequantize_int8)`` over the host CSR and over the
   glue's, to its own call over the glue's CSR, and within 1e-6 of the
   plain version on a CPU copy, then timed over the host CSR beside the
   call over the edge lists alone, with the kept-degree statistics
   printed.
10. Decode attention kernel: ``swa_attention_decode`` against its plain
   version, fp32 within 2e-5 at the JAX tests' shapes (wrapped rings
   with part of each ring in the future) plus ``window=None`` with a
   fully masked row, T = 5 (below the cluster's size) and G 12 with dh
   128 and 256; bf16 at the serving path's shape (8 lanes, 8192 slots,
   5 kv heads, G 3, dh 64, window 8192, wrapped rings with the query at
   the newest position, a tenth of the slots invalid) and at a batch of
   one (row 8'), each within one bf16 rounding of its plain version
   (2^-7 of each element plus 1e-5) and equal to itself over two
   launches, timed beside one ``scaled_dot_product_attention`` call.
   The cluster sizes and the registers and shared memory of the path's
   variant are printed.
11. LM decode: smollm-360m at full width in bf16 under long_500k
   (sliding window 8192), seeded random weights on the card, 8 lanes, a
   cache of 8192 slots that has seen 8128 tokens with seeded K/V, then
   128 greedy steps read back as the serve launcher does (the ring
   wraps at step 64; with 8192 slots for a window of 8192 the ring's
   overwrite, not the window mask, then keeps the window); counters zeroed just before, and the decode attention
   must have launched 128 × 32 times.  Tokens/s, step p50 / p99 (CUDA
   events), the decode attention's device time per step, the device's
   idle share over 8 profiled steps and the peak memory are printed.
   Then ``ContinuousBatcher`` with 8 lanes serves 8 requests of 64-token
   prompts and 64 new tokens each: every request
   completes once with all its tokens.
12. LM reference: the same model in fp32 on the card and on the CPU
   (plain versions) from one set of parameters and one cache (8188 of
   8192 slots seen), 8 teacher-forced steps; logits within 1e-3 of the
   largest logit at every step, TF32 off.
13. Sharded training (after step 8): the reddit preset at scale 8
   (32,000 vertices; cut from step 4's 58, whose 4-shard set-up rebuilt
   every client shard in 33-44 s), BFS-partitioned, 4 clients, OPG + int8 + degree scores over 4 embedding-server shards
   with pull-frequency placement (``rebalance_round=1``), AdamW lr 1e-2,
   2 epochs a round, each client's epochs cut to 16 minibatches, tracing
   on.  Built and run through the trainer's own code: construct,
   ``pretrain_round``, ``run_round(0)`` and ``run_round(1)``, which
   re-places the rows by observed pulls before its pulls.  Launch
   counters are zeroed before the trainer is built and read after each
   round (before that round's checks, and zeroed after them).  Fails
   unless: every loss is finite, each client's last 8 losses average
   below its first 8, accuracies lie in [0, 1]; every training kernel
   launched; the fused pulls' and pushes' launches equal one a non-empty
   shard and layer of each call, and all of the window's; after each
   round every registered gid, read through the sharded pull (once
   under ``set_sync_debug_mode("error")``) and gather, is bit-equal to an
   in-process transport holding the same rows; the rebalance keeps
   every row's values and LPT's fullest shard holds no more pull mass
   than ``gid % 4``'s; the spans number clients x rounds (pulls, push
   computes), clients x epochs x rounds (epochs) and rounds
   (aggregates); the exported model serves a 512-query burst with the
   threshold-1.0 answers equal to ``offline_predict`` and the
   ``pt_gnnserve.*`` metrics moved by the plane's stats; SGD and
   Adafactor lower client 0's loss in 16 steps; and one step of SGD,
   AdamW and Adafactor on the card equals the CPU's within 1e-6
   relative.  It prints the set-up seconds, steps/s and step times split
   as step 6, fill / push / aggregate seconds, the shard logs of each
   round, the fullest shard's pull mass under hash and LPT, the modelled
   pull of one server against 4 shards, the spans' seconds, a trace-off
   / trace-on step timing in turns, and rows 3 and 4 at the per-shard
   shapes; the Chrome trace goes to ``build/sharded_trace.json``.

14. The TCP deployment (after step 12).  (a) In threads: the reddit
   preset at scale 1 (4,000 vertices), 4 clients, OPG + int8 + degree
   scores, 2 epochs, 2 rounds; two port embed servers on the card
   (``serve_in_thread``, loopback TCP), a port coordinator and two port
   ``FedWorker``s of two clients each.  Fails unless the final leaves
   are within 1e-6 of the port's in-process trainer over 2 shards from
   the same RunConfig (max |Δ| printed) and the accuracies equal; each
   shard's payload bytes equal ``embedding_bytes`` of its RPCs; the
   codec counters' change across the window (zeroed before the
   coordinator and workers are built) equals the launches the RPCs call
   for (one a non-empty shard RPC and layer: row 3 a pull, row 4 a push
   on the servers, rows 1 and 2 on the clients); and ``obs_dump``
   scrapes five endpoints whose ``pt_exchange`` RPC counts equal the
   ledgers'.  Then a short run with the int8 weight codec and its error
   feedback (Strategy D, scale 0.5, 1 epoch, 2 rounds): the
   coordinator's decoded updates bit-equal to the workers' local round
   trips, 1 B a scalar plus 4 B a leaf; rows 1 and 2 at its largest leaf, (1, 3072), timed
   (``weight_leaf``).  (b) As processes, through the launchers: two
   ``embed_server``s, a ``fed_coordinator`` and two ``fed_worker``s
   (clients 0-1, 2-3) at scale 4 (16,000 vertices: at 58 the phase
   took 208 s, and 8 left no room for steps 15-16), one epoch, one
   round, tracing on,
   each address read from the child's "listening on" line (port 0),
   every wait bounded; every child exits 0, the coordinator prints
   DONE, and one ``obs_dump`` scrape of the five endpoints holds each
   worker's ``pt_exchange`` counts to its ledger.  It prints set-up
   seconds, the round's wall seconds, each client's pull, train and
   push seconds (measured, and modelled for the wire), measured against
   modelled RPC seconds, the fitted ``NetworkModel`` and the span
   seconds by name; the merged trace goes to ``build/tcp_trace.json``.
15. The graph store (after step 14).  ``launch.build_store`` builds the
   reddit preset at scale 8 (32,000 vertices) as an mmap store in a
   child process, with its LDG partition and P_4 shards for 4 clients
   baked.  Fails unless every array equals ``make_graph``'s byte for
   byte, the partition is ``ldg_partition``'s and each baked shard equals
   ``make_client_shards``' over it (push sets reciprocal); one round of
   ``RunConfig(graph="store:...")`` (OPG + int8 + degree scores,
   GraphConv L=3 hidden 32, fanout 5, batch 64, each client cut to 16
   minibatches) on the card over the prebuilt mmap'd shards equals the
   in-memory trainer over the same partition bit for bit (leaves, loss,
   accuracy), with every training kernel launched (counters zeroed before
   the store trainer is built, read after its round); a shard-local
   trainer (``only_clients=[1]``) holds only client 1's shard, mmap'd,
   and trains it.  It prints the store's bytes, the build's stats line,
   LDG's and BFS's edge cuts and the set-up seconds with and without
   prebuilt shards.
16. Serving over TCP.  (b)'s processes start first and train while (a)
   runs.  (a) In threads: two port embed servers;
   ``build_plane_from_cfg`` trains phase 15's RunConfig over the store
   with their addresses (each client's epoch cut to 16 minibatches, as
   in step 15), exports, and the plane, whose cache refreshes through
   ``PT_OP_VGATHER``, goes behind ``serve_in_thread``; four
   ``GnnServeClient`` threads send 512 Zipf queries each (half at
   threshold 1.0) in RPCs of 32.  Fails unless the TCP trainer's leaves
   equal phase 15's store-backed trainer's (the same RunConfig in
   process) and every answer equals that trainer's exported plane's;
   the threshold-1.0 answers equal ``offline_predict``; SSTATS and an
   ``obs_dump`` scrape count the queries and PREDICT RPCs sent; and rows
   2 and 3 launched once for each non-empty shard layer of the VGATHER
   RPCs (counters zeroed before the training and again before the
   queries).  It prints queries/s and RPC p50 / p99 beside phase 4's
   in-process figures.  (b) As processes: two ``embed_server``
   launchers and ``gnn_serve --graph store:...`` with their addresses
   (run by ``CUT_GNN_SERVE``, which cuts its epochs the same way); the
   same queries must get (a)'s answers, and every process must exit 0.
17. Graph growth (after step 16).  (a) In process: ``GrowthSchedule``
   (RMAT scale 16, edge factor 8, seed 0, half the vertices in the base,
   4 events before rounds 1-4, 41 classes, 96 features) builds its base
   store, and ``RunConfig(growth=...)`` (phase 15's strategy and model,
   LDG admission with one restreaming pass an event, each client's
   epoch cut to 16 minibatches) trains one round on the base and one
   after each event on the card, counters zeroed before the trainer is
   built.  Fails unless after each event the graph and partition have
   the frontier's size, the server holds exactly the union of the
   boundary sets registered so far and ``pt_dyngraph.boundary_
   registrations`` moved by the new rows counted here; every training
   kernel launched, rows 3 and 4 in the last round over the grown table;
   ``EmbeddingServer.push`` then ``pull`` of the last event's fresh rows
   equals ``gather``; and the final overlay compacts byte-equal to
   ``build_full``.  It prints, per event, the apply, restream and
   refresh seconds (shards, register, client state, eval), the fresh
   registrations, the table's reallocations and the edge cut after
   admission and after the restreaming pass; steps/s before and after
   growth; compaction seconds beside ``build_full``'s.  (b) In threads:
   the same schedule at scale 12, two port embed servers, a port
   coordinator with the growth barrier and two port workers of two
   clients each; the accuracy history and leaves equal the in-process
   grown trainer's over 2 shards, bit for bit.
18. The LM zoo: phi3.5-moe cut to 2 layers (its 78 GiB of bf16 weights
   fit no card), deepseek-v2-lite to 3 (the dense head layer and 2 MoE
   layers), llama-3.2-vision to one super-block (4 self-attention
   layers, the gated cross layer, the tail), mamba2-1.3b, hymba-1.5b and
   whisper-tiny at full depth; all at published widths in bf16 with
   seeded random weights on the card.  (a) Prefill: ``lm.forward`` over
   2 prompts of 1024 tokens (whisper 448) from ``synthetic_batches``,
   with (2, 1600, 1280) vision and (2, 1500, 384) frame inputs: finite
   logits; prefill tokens/s by CUDA events after a warm-up, peak memory
   and the device's idle share over one profiled forward.  (b) Decode: 4
   lanes, a 1024-slot cache that has seen 992 tokens with every floating
   leaf seeded, 32 greedy steps read back; counters zeroed just before:
   the decode attention must launch steps × (self + cross layers) times
   (none for mamba2), each ring advance a slot a step and each SSM state
   move; tokens/s and step p50 / p99.  (c) ``ContinuousBatcher`` on
   mamba2 and deepseek, 8 requests on 4 lanes: each completes once with
   all its tokens.  (d) Each family in fp32 with 2 layers (the VLM one
   super-block) on the card and the CPU from one set of parameters: the
   forward over 2 × 8 tokens and 8 teacher-forced decode steps over a
   wrapped 16-slot ring, within 1e-3 of the largest logit.  (e) The
   decode attention at the zoo's shapes (rows 8M: MLA, dh 192; 8H:
   hymba, G 5; 8X: the VLM's cross-decode, 1600 slots; 8W: whisper's,
   1500), checked and timed as in step 10, their launches from (b) by
   shape.
19. LM training: (a) smollm-360m at published width and depth in bf16
   with remat, train_4k's 4096-token sequences at a global batch of 4
   (cut from 256) in ``default_microbatches`` = 4 slices,
   ``make_optimizer``'s AdamW(3e-4), ``synthetic_batches(seed=0)``: one
   warm-up step and 3 steps timed by CUDA events; tokens/s, MFU (model
   FLOPs 6·N·T + 12·L·H·dh·S·T over 989 TFLOP/s), peak memory, and the
   device's idle share and top five kernels over one profiled
   microbatch; every loss finite and the first batch's loss lower after
   the steps.  (b) deepseek-v2-lite cut to 3 layers and mamba2-1.3b to 4
   at published widths in bf16: 3 AdamW steps of 2 × 1024 tokens,
   finite losses, moved parameters.  (c) Every reduced config in fp32:
   the loss and each gradient leaf of one step on the card within 1e-4
   of the CPU's (of the leaf's largest |g|), and the same step twice on
   the card, bit-equal or not (where not, the leaves and the ops that
   ``use_deterministic_algorithms`` names).  (d) ``save_pytree`` of (a)'s
   params and AdamW state, ``load_pytree`` on the card: bit-equal, paths
   in JAX's naming, seconds and GB/s each way.  (e) ``FederatedLMTrainer``
   on smollm-360m: 2 silos, 2 local steps of 2 × 1024 tokens, top-10 %
   deltas with stale aggregation, 2 rounds: round 1 leaves the anchor
   bit-unchanged, round 2 moves it, comm fraction 0.1 and
   ``comm_bytes_per_round`` 10 % of the anchor's bytes.  The launch
   counters are zeroed before the phase and must read zero after it.
20. The pod tooling.  (b) and (c) start first, as processes of their
   own that never touch the card (a ``fake`` world of 256 or 512 CPU
   ranks, meta-device shards): ``python -m repro_torch.launch.dryrun``
   for smollm-360m decode_32k on the single-pod and the multi-pod mesh,
   and ``python -m repro_torch.launch.fedrun`` for smollm-360m with 1
   local step, batch 32, sequence 256 and top-10 % deltas (cut from 4,
   64 and 1024).  Meanwhile (a) lays out the host mesh on the card,
   (data=1, model=1) over an NCCL world of one, and runs smollm-360m at
   full width and depth in bf16 through ``launch.steps.build_step``: one
   train step of 2 × 1024 tokens (AdamW, 2 microbatches, remat), a
   prefill of 2 × 1024 and 32 greedy decode steps at 8 lanes × 8192
   slots (a seeded ring that has seen all but one slot), each beside the
   unsharded port on the same inputs (max |Δ|, expected 0; the train
   step's parameters within 2·lr plus a bf16 step, the logits within
   1e-5 of the largest); the decode attention must launch 32 × 32 times
   in the sharded decode.  Then (b)'s and (c)'s records are read: ok on
   256 and 512 ranks, FLOPs and collective bytes counted.
21. The port's lint and the four examples.  (a) ``python -m
   repro_torch.launch.lint --format json`` over the repo, as a process
   of its own beside (b) (this machine has no JAX): exit 0, no findings;
   the files scanned, the pairs verified and its seconds.  (b) Each
   ``examples/*_torch.py``'s ``main`` in this process, on the card, with
   the launch counters zeroed before and read after and the CSR glue
   failing the run: ``quickstart_torch`` at its defaults (reddit at
   scale 0.3, 10 rounds, D, E and OPP: every loss finite; the paper's
   ordering, D < E ≈ OPP in accuracy and OPP's rounds faster than E's,
   printed and not held), ``train_federated_e2e_torch`` (products at
   scale 0.4, 4 clients, E and OPG) at ``E2E_ROUNDS`` rounds, and
   ``serve_llm_torch`` and ``federated_llm_torch`` at their defaults
   (reduced configs): finite losses and tokens/s; each one's wall
   seconds.

Each kernel's row (and its other shapes) is then printed as in
``PERF.md`` §6: launches, ms, dev, plain, lib, bound and share.  The
line before the last is the card's name and power limit; the one
before it is the kernels' JSON report; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without it.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import importlib.util
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
TOL = 1e-6
DEV = "cuda"
SCALE = 58.0                  # reddit preset scale: 232,000 vertices
N_QUERIES = 2048
TRAIN_STEPS = 32              # minibatches per client in the short round
PROFILED_STEPS = 16
#: the kernels the serving path runs; training adds the aggregation's
#: backward and the top-k selection
SERVE_KERNELS = ("quantize_int8", "dequantize_int8", "gather_quantize",
                 "dequant_scatter", "gnn_aggregate")
TRAIN_KERNELS = SERVE_KERNELS + ("segment_mean_bwd", "topk_mask")
PAPERS_SCORES = 40_000_000    # remote-vertex scores at Papers scale
LM_ARCH = "smollm-360m"       # the serve launcher's default, full width
LM_LANES = 8
LM_DECODE_STEPS = 128         # the ring wraps after the first 64
LM_PROFILED_STEPS = 8
LM_REQUESTS = 8               # batcher: 64-token prompts, 64 new tokens
LM_PROMPT = 64
LM_NEW = 64
LM_REF_STEPS = 8              # card vs CPU, fp32, teacher-forced
SHARDS = 4                    # embedding-server shards of the sharded phase
SHARDED_SCALE = 8.0           # its graph: 32,000 vertices (cut from 58)
SHARDED_STEPS = 16            # minibatches per client epoch there
SHARDED_EPOCHS = 2            # the overlapped push runs after epoch 1
SHARDED_QUERIES = 512
TCP_THREAD_SCALE = 1.0        # phase 14a: 4,000 vertices
TCP_WEIGHT_SCALE = 0.5        # its weight-codec run: 2,000 vertices
TCP_PROCESS_SCALE = 4.0       # phase 14b: 16,000 vertices (cut from 58)
TCP_EPOCHS = 2                # local epochs a round in 14a (14b: one)
STORE_SCALE = 8.0             # phases 15-16: the store, 32,000 vertices
STORE_STEPS = 16              # minibatches a client in phase 15's round
SERVE_TCP_QUERIES = 512       # Zipf queries a client in phase 16a
SERVE_TCP_RPC = 32            # queries a PREDICT RPC there


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
    torch.profiler, tracing the device activity alone: host-op tracing
    would stretch the window that an idle share divides by.  The card's
    CUPTI tracing has come back empty in some runs, so up to
    ``sessions`` sessions are tried before giving up (an empty list:
    "not measured")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    """The least time to move ``nbytes`` at the card's memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def max_err(a, b) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def add_entry(report: list, name, source, replaces, err, shape, ms,
              plain_ms, nbytes, library_ms=None, **extra) -> None:
    """One kernel's row of the JSON report (launches filled in later)."""
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "shape": shape, "launches": 0,
           "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
           "library_ms": library_ms, **extra}
    print(f"kernel {name}: shape {shape} max|d| {err:.3g} "
          f"ms {ms:.4f} device_ms {extra['device_ms']} plain_ms "
          f"{plain_ms:.4f} bound_ms {row['bound_ms']:.4f} library_ms "
          f"{library_ms}", flush=True)
    report.append(row)


def print_rows(report: list) -> None:
    """Each kernel's row as in ``PERF.md`` §6, then its other shapes:
    launches, ms, dev, plain, lib, bound and share (bound ÷ dev)."""
    def line(name, case, launches):
        dev = case.get("device_ms")
        share = case["bound_ms"] / dev if dev else None
        print(f"row {name}: shape {case['shape']} launches {launches} "
              f"ms {case['ms']:.4f} dev {dev} plain {case['plain_ms']:.4f} "
              f"lib {case['library_ms']} bound {case['bound_ms']:.6f} "
              f"share {share}", flush=True)

    for row in report:
        line(row["name"], row, row["launches"])
        for key, case in row.items():
            if isinstance(case, dict) and "bound_ms" in case:
                line(f"{row['name']} {key}", case,
                     case.get("launches", "(not on a path)"))


# -- phase 2: kernels against their plain versions ---------------------------

#: Row 2's host pieces, µs per call, on the launch path before it was made
#: lean (checks reading ``device.type``, ``torch.empty``,
#: ``torch.cuda.current_stream().cuda_stream``, one ctypes conversion per
#: argument): ``tools/launch_pieces.py --src`` on that tree, NVIDIA H100
#: 80GB HBM3 at 700.00 W (PERF.md §6), printed beside this run's.
BEFORE_HOST_US = {"dispatch": 0.54, "empty": 7.11, "checks": 2.74,
                  "stream": 6.26, "args": 1.36, "ctypes": 7.74,
                  "launch": 19.42, "wrapper": 36.13, "call": 37.45,
                  "lib": 7.61}


def host_pieces(torch) -> dict:
    """The host pieces of one ``ops.dequantize_int8`` call at 59,803 x 32
    (``tools/launch_pieces.py``), printed on one line beside those of the
    launch path before it was made lean (BEFORE_HOST_US)."""
    import importlib.util

    path = pathlib.Path(__file__).resolve().parent / "tools" \
        / "launch_pieces.py"
    spec = importlib.util.spec_from_file_location("launch_pieces", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    us = mod.measure(torch)
    pairs = ", ".join(f"{k} {BEFORE_HOST_US[k]:.2f} -> {us[k]:.2f}"
                      for k in BEFORE_HOST_US)
    print(f"row 2 host pieces (us per call, the earlier path as recorded "
          f"-> this run): {pairs}", flush=True)
    return us


def kept_degree(np, indptr) -> dict:
    """Max, p99 and mean of a CSR's kept edges per row."""
    deg = np.diff(indptr.cpu().numpy())
    return {"max": int(deg.max()), "p99": float(np.percentile(deg, 99)),
            "mean": float(deg.mean())}


def agg_bytes(src, n_dst: int, kept: int) -> int:
    """The aggregation's compulsory bytes as the path calls it, over the
    host-built CSR, counted as in ``PERF.md`` §6: the table, the int64 row
    pointer, the kept edges' int32 source ids, the int32 row order, and
    the mean and count out."""
    return src.numel() * 4 + (n_dst + 1) * 8 + kept * 4 + n_dst * 4 \
        + n_dst * (src.shape[1] + 1) * 4


def agg_edge_list_bytes(src, e_all: int, kept: int, n_dst: int) -> int:
    """The bytes a call over the padded edge lists alone must move (the
    earlier count of row 5's bound): the table, every edge's mask byte, the
    kept edges' int32 source and destination ids, and the mean and count
    out."""
    return src.numel() * 4 + e_all + kept * (4 + 4) \
        + n_dst * (src.shape[1] + 1) * 4


def agg_int8_bytes(values, n_dst: int, kept: int) -> int:
    """Row 6's compulsory bytes as the path calls it, over the host-built
    CSR: the int8 table, its fp32 scales, the int64 row pointer, the kept
    edges' int32 source ids, the int32 row order and the fp32 mean out."""
    n_src, f = values.shape
    return n_src * f + n_src * 4 + (n_dst + 1) * 8 + kept * 4 + n_dst * 4 \
        + n_dst * f * 4


def agg_int8_edge_list_bytes(values, e_all: int, kept: int,
                             n_dst: int) -> int:
    """The bytes a call of row 6 over the padded edge lists alone must
    move (its earlier count): the int8 table and scales, every edge's mask
    byte, the kept edges' int32 source and destination ids, the mean
    out."""
    n_src, f = values.shape
    return n_src * f + n_src * 4 + e_all + kept * (4 + 4) + n_dst * f * 4


def agg_check(torch, what: str, src, edges: tuple, n_dst: int, csr):
    """The aggregation over the host-built ``csr`` and over the glue's,
    each bit-equal to the plain version on a CPU copy of the inputs (which
    adds in the kernel's edge order; on the card the plain version's
    index_add_ adds with atomics in no fixed order).  Returns the max
    difference from the CPU run (0) and from the plain version on the
    card."""
    from repro_torch.kernels import ops, ref

    want, wcnt = ref.segment_mean(src.cpu(), *[a.cpu() for a in edges],
                                  n_dst)
    for prebuilt in (csr, None):
        got, cnt = ops.gnn_aggregate(src, *edges, n_dst, prebuilt)
        how = "the host CSR" if prebuilt is not None else "the glue's CSR"
        check(torch.equal(cnt.cpu(), wcnt),
              f"gnn_aggregate counts differ from plain ({what}, {how})")
        check(torch.equal(got.cpu(), want),
              f"gnn_aggregate off its plain version on the CPU by "
              f"{max_err(got.cpu(), want)} ({what}, {how})")
    card, _ = ref.segment_mean(src, *edges, n_dst)
    return max_err(got.cpu(), want), max_err(got, card)


def kernel_phase(torch, np, shards, num_vertices: int) -> list[dict]:
    from repro_torch.kernels import exchange_fused as fused
    from repro_torch.kernels import gnn_aggregate as agg_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.models.gnn import shard_to_arrays, to_device

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
    for n, h in ((n_local, hidden), (257, 100), (300, 16), (0, hidden),
                 (300, 3), (1, hidden)):
        x = rand(n, h)
        q, s = ops.quantize_int8(x)
        rq, rs = ref.quantize_int8(x)
        check(torch.equal(q, rq) and torch.equal(s, rs),
              f"quantize_int8 differs from plain at {(n, h)}")
        d = ops.dequantize_int8(q, s)
        check(torch.equal(d, ref.dequantize_int8(rq, rs)),
              f"dequantize_int8 differs from plain at {(n, h)}")
        # a view that starts one row in: its q stays 4-byte aligned where
        # h % 4 == 0 (the four-values-a-thread kernel); h = 3 takes the
        # warp-per-row kernel
        check(torch.equal(ops.dequantize_int8(q[1:], s[1:]),
                          ref.dequantize_int8(rq[1:], rs[1:])),
              f"dequantize_int8 differs from plain on a view at {(n, h)}")
        # q at an odd byte of its storage: the warp-per-row kernel at any h
        flat = torch.empty(n * h + 1, dtype=torch.int8, device=dev)
        odd = flat[1:].view(n, h)
        odd.copy_(q)
        check(torch.equal(ops.dequantize_int8(odd, s),
                          ref.dequantize_int8(rq, rs)),
              f"dequantize_int8 differs from plain at an odd byte, {(n, h)}")
    # the encode of a column slice (rows h + 8 floats apart, 16-byte
    # aligned) and of a table at an odd float, each plain and gathered
    for h in (3, 4, 32, 100, 128):
        wide = rand(300, h + 8)
        rows_h = torch.from_numpy(np.random.default_rng(h).integers(
            0, 300, 517)).to(dev)
        flat = torch.empty(300 * h + 1, device=dev)
        odd = flat[1:].view(300, h)
        odd.copy_(wide[:, :h])
        for view in (wide[:, 4:4 + h], odd):
            for got, want in ((ops.quantize_int8(view),
                               ref.quantize_int8(view)),
                              (ops.gather_quantize(view, rows_h.cpu()),
                               ref.gather_quantize(view, rows_h))):
                check(torch.equal(got[0], want[0])
                      and torch.equal(got[1], want[1]),
                      f"the encode differs from plain on a view at h = {h}")
    x = rand(n_local, hidden)
    q, s = ops.quantize_int8(x)
    n = n_local
    entry("quantize_int8", "src/repro_torch/csrc/quantize_rows.cu",
          "src/repro/kernels/quantize.py:151", 0.0, (n, hidden),
          time_ms(torch, lambda: ops.quantize_int8(x)),
          time_ms(torch, lambda: ref.quantize_int8(x)),
          n * hidden * 4 + n * hidden + n * 4,
          device_ms=device_ms(torch, lambda: ops.quantize_int8(x),
                              "quantize_quads_kernel"))
    entry("dequantize_int8", "src/repro_torch/csrc/dequantize_rows.cu",
          "src/repro/kernels/quantize.py:191", 0.0, (n, hidden),
          time_ms(torch, lambda: ops.dequantize_int8(q, s)),
          time_ms(torch, lambda: ref.dequantize_int8(q, s)),
          n * hidden + n * 4 + n * hidden * 4,
          library_ms=time_ms(torch, lambda: torch.mul(q, s)),
          device_ms=device_ms(torch, lambda: ops.dequantize_int8(q, s),
                              "dequantize_quads_kernel"),
          host_us=host_pieces(torch))

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
                              "quantize_quads_kernel"))

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
    # duplicate rows (and a dropped id) add in index order, as the plain
    # version's index_add_ does on the CPU: equal bit for bit, and the
    # same bytes launch after launch
    dup = np.random.default_rng(7).integers(0, n_local // 2, size=n_local)
    dup[1] = -1
    before = t_k.clone()
    want_add = ref.dequant_scatter_(t_p.cpu(), torch.from_numpy(dup),
                                    pv.cpu(), ps.cpu(), accumulate=True)
    ops.dequant_scatter_(t_k, dup, pv, ps, accumulate=True)
    add_err = max_err(t_k.cpu(), want_add)
    check(torch.equal(t_k.cpu(), want_add),
          f"dequant_scatter (add, duplicate rows) off the plain version on "
          f"the CPU by {add_err}")
    check(torch.equal(ops.dequant_scatter_(before, dup, pv, ps,
                                           accumulate=True), t_k),
          "dequant_scatter (add, duplicate rows): two launches differ")
    t_p.copy_(t_k)
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
              t_k, pidx, pv, ps), "scatter_quads_kernel"))

    # gnn_aggregate: layer 1 of full_propagate on one client's shard, over
    # the CSR of its local edges built on the host (the path's call)
    arr = shard_to_arrays(sh, dev)
    feats = arr["features"]
    src_tbl = torch.cat([feats, torch.zeros((1, feats.shape[1]),
                                            device=dev)], 0)
    local = arr["local"]
    edges = (local["edge_src"], local["edge_dst"], local["edge_mask"])
    csr = local["csr"]
    agg_err, card_err = agg_check(torch, "layer 1", src_tbl, edges, n_local,
                                  csr)
    # a serving-style block: padded tail with dst=0 and the mask off
    e = 5000
    bs = torch.randint(0, 700, (e,), generator=gen)
    bd = torch.sort(torch.randint(0, 300, (e,), generator=gen)).values
    bm = torch.rand(e, generator=gen) < 0.8
    pad = 1000
    bs = torch.cat([bs, torch.zeros(pad, dtype=bs.dtype)])
    bd = torch.cat([bd, torch.zeros(pad, dtype=bd.dtype)])
    bm = torch.cat([bm, torch.zeros(pad, dtype=torch.bool)])
    blk_csr = to_device(agg_mod.csr_arrays(700, bs.numpy(), bd.numpy(),
                                           bm.numpy(), 384), dev)
    errs = agg_check(torch, "padded block", rand(700, hidden),
                     tuple(a.to(dev) for a in (bs, bd, bm)), 384, blk_csr)
    agg_err, card_err = max(agg_err, errs[0]), max(card_err, errs[1])
    n_edges = int(csr.indices.shape[0])
    e_all = int(edges[0].shape[0])
    gathered = src_tbl[csr.indices.long()]
    dst_kept = edges[1][edges[2]].long()
    f = src_tbl.shape[1]
    lib_out = torch.zeros((n_local, f), device=dev)
    degree = kept_degree(np, csr.indptr)
    print(f"gnn_aggregate layer 1: kept degree {json.dumps(degree)}",
          flush=True)
    entry("gnn_aggregate", "src/repro_torch/csrc/segment_mean_csr.cu",
          "src/repro/kernels/gnn_aggregate.py:69", agg_err,
          (tuple(src_tbl.shape), e_all, n_local),
          time_ms(torch, lambda: ops.gnn_aggregate(src_tbl, *edges, n_local,
                                                   csr)),
          time_ms(torch, lambda: ref.segment_mean(src_tbl, *edges, n_local)),
          agg_bytes(src_tbl, n_local, n_edges),
          library_ms=time_ms(torch, lambda: lib_out.index_reduce_(
              0, dst_kept, gathered, "mean", include_self=False)),
          kernel_ms=time_ms(torch, lambda: agg_mod.segment_mean_csr(
              src_tbl, csr.indptr, csr.indices, csr.order)),
          # the same call over the edge lists alone: the CSR built by
          # torch glue on the card, two host syncs
          edge_list_ms=time_ms(torch, lambda: ops.gnn_aggregate(
              src_tbl, *edges, n_local)),
          # bound_ms counts the bytes of the call over the host CSR; this,
          # those of a call over the edge lists alone (the earlier count)
          bound_edge_list_ms=bound_ms(agg_edge_list_bytes(
              src_tbl, e_all, n_edges, n_local)),
          kept_edges=n_edges, kept_degree=degree,
          max_abs_err_vs_card_plain=card_err,
          device_ms=device_ms(torch, lambda: ops.gnn_aggregate(
              src_tbl, *edges, n_local, csr), "segment_mean_csr_kernel"))
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
def timed(owner, name: str, log: list, args_log: list | None = None,
          sync=None):
    """Within the block, each call of ``owner.name`` (a module's function,
    a class's method or an instance's bound method) appends its host
    seconds to ``log`` (after ``sync()``, where given) and, given
    ``args_log``, its positional arguments."""
    inner = getattr(owner, name)
    own = name in vars(owner)

    def wrapper(*args, **kw):
        t = time.perf_counter()
        out = inner(*args, **kw)
        if sync is not None:
            sync()
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


@contextlib.contextmanager
def agg_launches_by_shape(tally: dict):
    """Within the block, each call of ``models/gnn.py``'s ``_aggregate``
    (the one caller of ``ops.gnn_aggregate`` on the paths) adds the change
    of the ``gnn_aggregate`` launch counter across the call to
    ``tally[(where, n_src, f, n_dst)]``: ``where`` is "block" for a
    minibatch or serving block and "propagate" for ``full_propagate``'s
    edge sets."""
    from repro_torch.kernels import ops
    from repro_torch.models import gnn as gnn_mod

    inner = gnn_mod._aggregate

    def counted(h_src, edges, n_dst):
        before = ops.launch_counts()["gnn_aggregate"]
        out = inner(h_src, edges, n_dst)
        key = ("block" if "dst_remote_mask" in edges else "propagate",
               *h_src.shape, n_dst)
        tally[key] = (tally.get(key, 0)
                      + ops.launch_counts()["gnn_aggregate"] - before)
        return out
    gnn_mod._aggregate = counted
    try:
        yield tally
    finally:
        gnn_mod._aggregate = inner


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
    # the launches of the window, and the aggregation's by where and shape
    agg_tally: dict = {}
    with agg_launches_by_shape(agg_tally):
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t_main = time.perf_counter()
        with contextlib.ExitStack() as stack:
            T = fed.FederatedGNNTrainer
            for owner, name, key, args in (
                    (fed, "build_client_shards", "shards_s", None),
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
    for name in TRAIN_KERNELS:
        check(counts[name] > 0,
              f"kernel {name} never launched on the training slice")
    check(sum(agg_tally.values()) == counts["gnn_aggregate"],
          f"gnn_aggregate launched {counts['gnn_aggregate']} times, "
          f"{sum(agg_tally.values())} of them through the model's aggregation")
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
        "gnn_aggregate_launches": [
            {"where": k[0], "shape": k[1:], "launches": v}
            for k, v in sorted(agg_tally.items())],
        "profiled_steps": window,
        "trained_serving_exits_at_0.5": plane.stats()["exits_by_depth"],
    }
    return out, counts, trainer, topf_args[0][0]


def sync_free_check(torch, trainer, batch) -> dict:
    """One training step's forward and backward over ``batch`` (its blocks
    carrying their host-built CSRs) and ``full_propagate`` over both of
    client 0's edge sets, under ``set_sync_debug_mode("error")``: no
    aggregation call on the path waits on the card.  Returns the
    launches."""
    from repro_torch.kernels import ops
    from repro_torch.models.gnn import loss_fn

    model = trainer.model
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = loss_fn(model, batch, trainer.feats[0], trainer._caches[0],
                       trainer.labels[0])
        torch.autograd.grad(loss, model.leaves())
        model.full_propagate(trainer.shard_arrays[0], trainer._caches[0])
        model.full_propagate(trainer.shard_arrays[0], None)
    except RuntimeError as e:
        raise SmokeFailure(f"an aggregation call waited on the card: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    L = model.num_layers
    check(counts.get("gnn_aggregate") == 3 * L
          and counts.get("segment_mean_bwd") == L - 1,
          f"sync-free check: launches {counts}")
    print(f"no host sync in one training step's aggregations and two "
          f"full_propagate calls: launches {json.dumps(counts)}", flush=True)
    return counts


def train_kernel_phase(torch, np, trainer, scores0, agg_launches: list
                       ) -> tuple[list[dict], dict]:
    """The aggregation's backward and the top-k selection kernel against
    their plain versions at the training slice's shapes; the aggregation
    forward at each minibatch block's shape (row 5'' is layer 2's),
    returned apart, each with the launches the training slice made at
    that shape (``agg_launches``, from the launch counter); and the
    sync-free check of the path's aggregation calls."""
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
        t_indptr, t_dst = agg_mod.transpose_csr(indptr, indices, n_src)
        cnt = (indptr[1:] - indptr[:-1]).to(torch.float32)
        g = torch.randn((n_dst, hidden), generator=gen).to(dev)
        got = agg_mod.segment_mean_csr_bwd(g, t_indptr, t_dst, cnt, n_src)
        again = agg_mod.segment_mean_csr_bwd(g, t_indptr, t_dst, cnt, n_src)
        check(torch.equal(got, again), "segment_mean_csr_bwd: two launches "
              f"differ at {n_src}->{n_dst}")
        # the plain version on the CPU adds edge by edge in index order,
        # the kernel's order, so the two must agree bit for bit
        want = ref.segment_mean_backward(
            *[a.cpu() for a in (g, e_src, e_dst, mask, cnt)], n_src)
        err = max_err(got.cpu(), want)
        check(torch.equal(got.cpu(), want), f"segment_mean_csr_bwd off its "
              f"plain version on the CPU by {err} at {n_src}->{n_dst}")
        kept = int(indices.shape[0])
        src_kept = indices.long()
        dst_kept = e_dst[mask].long()
        lib_out = torch.zeros((n_src, hidden), device=dev)
        scaled = (g / cnt.clamp_min(1.0)[:, None])[dst_kept]

        def lib_sequence():
            out = torch.zeros((n_src, hidden), device=dev)
            per_dst = g / cnt.clamp_min(1.0)[:, None]
            return out.index_add_(0, src_kept, per_dst[dst_kept])

        return {
            "err": err, "bit_equal_to_cpu_plain": True,
            "deterministic": True,
            "shape": (n_src, hidden, n_dst, int(e_src.shape[0])),
            "kept_edges": kept,
            # the most edges one source row (one warp) adds in order
            "max_src_edges": int((t_indptr[1:] - t_indptr[:-1]).max()),
            # the Function's backward (only grad_mean checked)
            "ms": time_ms(torch, lambda: agg_mod._segment_mean_bwd(
                g, t_indptr, t_dst, cnt, n_src)),
            # the raw entry, every input checked
            "entry_ms": time_ms(torch, lambda: agg_mod.segment_mean_csr_bwd(
                g, t_indptr, t_dst, cnt, n_src)),
            "plain_ms": time_ms(torch, lambda: ref.segment_mean_backward(
                g, e_src, e_dst, mask, cnt, n_src)),
            "library_ms": time_ms(torch, lib_sequence),
            "library": "sequence of PyTorch calls: zeros, quotient, row "
                       "gather, index_add_",
            "library_index_add_ms": time_ms(torch, lambda: lib_out.index_add_(
                0, src_kept, scaled)),
            # both launches of one call: the quotients, then the gather
            "device_ms": device_ms(torch, lambda: agg_mod._segment_mean_bwd(
                g, t_indptr, t_dst, cnt, n_src), "segment_mean_csr_bwd",
                per_call=True),
            # the transposed CSR the forward builds for this backward
            "transpose_ms": time_ms(torch, lambda: agg_mod.transpose_csr(
                indptr, indices, n_src)),
            # grad_mean and cnt read once, t_indptr and the kept edges'
            # int32 destinations, grad_src written once
            "nbytes": n_dst * hidden * 4 + n_dst * 4 + (n_src + 1) * 8
            + kept * 4 + n_src * hidden * 4,
        }

    # the blocks of a full-width minibatch (the train step's shapes)
    mb = next(iter(trainer.samplers[0].epoch()))
    batch = blocks_to_arrays(mb, dev)
    sync_counts = sync_free_check(torch, trainer, batch)
    launches_at = {(a["where"], *a["shape"]): a["launches"]
                   for a in agg_launches}

    def block_case(j: int, f: int) -> tuple[dict, tuple]:
        """The forward at block ``j``: p_src x f -> p_dst, over the CSR
        the block carries (its padded edge lists from the sampler)."""
        b = mb.blocks[j]
        bcsr = batch["blocks"][j]["csr"]
        edges = tuple(torch.from_numpy(np.asarray(a).astype(t)).to(dev)
                      for a, t in ((b.edge_src, np.int32),
                                   (b.edge_dst, np.int32),
                                   (b.edge_mask, bool)))
        h = torch.randn((b.p_src, f), generator=gen).to(dev)
        err, card_err = agg_check(torch, f"training block {j + 1}", h,
                                  edges, b.p_dst, bcsr)
        kept = int(bcsr.indices.shape[0])
        gathered = h[bcsr.indices.long()]
        dst_kept = edges[1][edges[2]].long()
        lib_out = torch.zeros((b.p_dst, f), device=dev)
        launches = launches_at.get(("block", b.p_src, f, b.p_dst), 0)
        check(launches > 0, f"no gnn_aggregate launch at training block "
                            f"{j + 1}'s shape {(b.p_src, f, b.p_dst)}")
        case = with_bound({
            "shape": (b.p_src, f, b.p_dst, len(b.edge_src)),
            "err": err, "max_abs_err_vs_card_plain": card_err,
            "kept_edges": kept, "kept_degree": kept_degree(np, bcsr.indptr),
            # the training slice's launches at this shape (counted)
            "launches": launches,
            "ms": time_ms(torch, lambda: ops.gnn_aggregate(
                h, *edges, b.p_dst, bcsr)),
            "plain_ms": time_ms(torch, lambda: ref.segment_mean(
                h, *edges, b.p_dst)),
            "library_ms": time_ms(torch, lambda: lib_out.index_reduce_(
                0, dst_kept, gathered, "mean", include_self=False)),
            "kernel_ms": time_ms(torch, lambda: agg_mod.segment_mean_csr(
                h, bcsr.indptr, bcsr.indices, bcsr.order)),
            "edge_list_ms": time_ms(torch, lambda: ops.gnn_aggregate(
                h, *edges, b.p_dst)),
            "device_ms": device_ms(torch, lambda: ops.gnn_aggregate(
                h, *edges, b.p_dst, bcsr), "segment_mean_csr_kernel"),
            "nbytes": agg_bytes(h, b.p_dst, kept)})
        case["bound_edge_list_ms"] = bound_ms(agg_edge_list_bytes(
            h, len(b.edge_src), kept, b.p_dst))
        print(f"kernel gnn_aggregate at training block {j + 1}: "
              + json.dumps(case), flush=True)
        return case, edges

    L = len(mb.blocks)
    feat = trainer.feats[0].shape[1]
    blocks = [block_case(j, feat if j == 0 else hidden) for j in range(L)]
    # row 5'': layer 2, the block the backward below also runs at
    forward_block, edges = blocks[1]
    b = mb.blocks[1]
    other_blocks = {f"training_block_{j + 1}": blocks[j][0]
                    for j in range(L) if j != 1}
    step = bwd_case(b.p_src, *edges, b.p_dst)
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
              **{k: step[k] for k in (
                  "library", "library_index_add_ms", "entry_ms",
                  "transpose_ms", "kept_edges", "max_src_edges",
                  "bit_equal_to_cpu_plain",
                  "deterministic")},
              full_propagate=with_bound(full))
    print("kernel segment_mean_bwd at full_propagate: "
          + json.dumps(report[-1]["full_propagate"]), flush=True)

    def topk_case(scores_np, frac, iters):
        n = len(scores_np)
        k = int(np.ceil(frac * n))
        s = torch.from_numpy(scores_np.astype(np.float32)).to(dev)
        ops.reset_launch_counts()
        got = ops.topk_mask(s, k)
        check(ops.launch_counts()["topk_mask"] == 1,
              f"topk_mask: {ops.launch_counts()} launches at n={n}")
        check(torch.equal(got, ref.topk_mask(s, k)),
              f"topk_mask differs from plain at n={n}")
        check(torch.equal(got.cpu(), ref.topk_mask(s.cpu(), k)),
              f"topk_mask differs from plain on the CPU at n={n}")
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
                                   "topk_select_kernel"),
            "count_ms": time_ms(torch, lambda: ops.count_ge(s, thr),
                                iters=iters),
            "count_device_ms": device_ms(torch, lambda: ops.count_ge(s, thr),
                                         "count_ge_kernel"),
            "count_bound_ms": bound_ms(n * 4),
            "nbytes": n * 4 + n,       # scores read once, mask written once
        }

    frac = trainer.strategy.scored_prune_frac
    mine = topk_case(np.asarray(scores0), frac, 50)
    rng = np.random.default_rng(40)
    papers = np.minimum(rng.zipf(2.0, PAPERS_SCORES), 10**6).astype(
        np.float64)
    big = topk_case(papers, frac, 10)
    add_entry(report, "topk_mask", "src/repro_torch/csrc/topk_select.cu",
              "src/repro/kernels/topk_mask.py:46", 0.0, mine["shape"],
              mine["ms"], mine["plain_ms"], mine["nbytes"],
              library_ms=mine["library_ms"], device_ms=mine["device_ms"],
              library="torch.topk + scatter_",
              candidates=mine["candidates"],
              count_ge="csrc/count_ge.cu, one counting pass, on no path",
              count_ms=mine["count_ms"],
              count_device_ms=mine["count_device_ms"],
              count_bound_ms=mine["count_bound_ms"],
              papers_40m=with_bound(big))
    print("kernel topk_mask at 40M: " + json.dumps(report[-1]["papers_40m"]),
          flush=True)
    torch.cuda.synchronize()
    return report, {"training_block": forward_block, **other_blocks,
                    "sync_free_launches": sync_counts}


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


# -- phase 9: the int8 pull fed straight into the aggregation ---------------

def pull_aggregate_phase(torch, np, trainer) -> tuple[dict, list[dict]]:
    """The JAX package's consumer chain (``tests/test_exchange.py``'s
    pull-then-aggregate test) at layer 2 of client 0's
    ``full_propagate``: the source rows (local + cached remote) are
    written to an embedding server on the card, pulled back in int8 wire
    form with ``gather_quantized`` and aggregated by
    ``ops.dequant_aggregate`` over the CSR of the edge set built on the
    host with the shard.  The launch counters are zeroed just before the
    pull and read just after the aggregation, which runs with the card's
    CSR glue watched and under ``set_sync_debug_mode("error")``: a glue
    call or a host sync fails the run.  Then the kernel is held bit-equal
    to the port's decode followed by its fp32 aggregation (over the host
    CSR and over the glue's), to its own call over the glue's CSR and to
    itself, and to the plain version on a CPU copy within TOL."""
    from repro_torch.exchange import make_transport
    from repro_torch.kernels import gnn_aggregate as agg_mod
    from repro_torch.kernels import ops, ref

    arr = trainer.shard_arrays[0]
    n_dst = arr["num_local"]
    n_src = n_dst + trainer._caches[0][0].shape[0]
    hidden = trainer.hidden
    every = arr["every"]
    e_src, e_dst, mask = every["edge_src"], every["edge_dst"], \
        every["edge_mask"]
    csr = every["csr"]
    gen = torch.Generator(device=DEV).manual_seed(99)
    tr = make_transport(3, hidden, device=DEV)
    gids = np.arange(n_src)
    tr.register(gids)
    tr.write(gids, [torch.randn((n_src, hidden), generator=gen, device=DEV)
                    for _ in range(2)])
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    values, scales = tr.gather_quantized(gids, [1])[0]
    glue: list = []
    with timed(agg_mod, "csr_from_edges", glue):
        torch.cuda.set_sync_debug_mode("error")
        try:
            mean = ops.dequant_aggregate(values, scales, e_src, e_dst, mask,
                                         n_dst, csr)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(not glue, "the CSR glue ran on the pull chain's aggregation")
    check(counts["dequant_aggregate"] == 1 and counts["gather_quantize"] == 1,
          f"pull-then-aggregate launches {counts}")

    args = (values, scales, e_src, e_dst, mask)
    decoded = ops.dequantize_int8(values, scales)
    for prebuilt in (csr, None):
        how = "host" if prebuilt is not None else "glue"
        two_step, _ = ops.gnn_aggregate(decoded, e_src, e_dst, mask, n_dst,
                                        prebuilt)
        check(torch.equal(mean, two_step), "dequant_aggregate is not "
              "bit-equal to gnn_aggregate(dequantize_int8) at row 5b' "
              f"shape ({how} CSR)")
        check(torch.equal(ops.dequant_aggregate(*args, n_dst, prebuilt),
                          mean),
              f"dequant_aggregate over the {how} CSR: another launch "
              "differs")
    want = ref.dequant_aggregate(*[a.cpu() for a in args], n_dst)
    err = max_err(mean.cpu(), want)
    check(torch.allclose(mean.cpu(), want, rtol=TOL, atol=TOL),
          f"dequant_aggregate off its plain version by {err}")
    check(bool(torch.isfinite(mean).all()), "dequant_aggregate: not finite")
    degree = kept_degree(np, csr.indptr)
    print(f"pull-then-aggregate: {n_src}x{hidden} int8 -> {n_dst} rows, "
          f"kept degree {json.dumps(degree)}, no glue and no host sync, "
          f"bit-equal to gnn_aggregate(dequantize_int8), plain max|d| "
          f"{err:.3g}", flush=True)

    kept = int(csr.indices.shape[0])
    e_all = int(e_src.shape[0])
    gathered = ref.dequantize_int8(values, scales)[csr.indices.long()]
    dst_kept = e_dst[mask].long()
    lib_out = torch.zeros((n_dst, hidden), device=DEV)
    report: list = []
    add_entry(report, "dequant_aggregate",
              "src/repro_torch/csrc/segment_mean_csr_int8.cu",
              "src/repro/kernels/gnn_aggregate.py:134", err,
              (n_src, hidden, n_dst, e_all),
              time_ms(torch, lambda: ops.dequant_aggregate(*args, n_dst,
                                                           csr)),
              time_ms(torch, lambda: ref.dequant_aggregate(*args, n_dst)),
              agg_int8_bytes(values, n_dst, kept),
              library_ms=time_ms(torch, lambda: lib_out.index_reduce_(
                  0, dst_kept, gathered, "mean", include_self=False)),
              # the same call over the edge lists alone: the CSR built by
              # torch glue on the card, two host syncs
              edge_list_ms=time_ms(torch, lambda: ops.dequant_aggregate(
                  *args, n_dst)),
              # bound_ms counts the bytes of the call over the host CSR;
              # this, those of a call over the edge lists alone
              bound_edge_list_ms=bound_ms(agg_int8_edge_list_bytes(
                  values, e_all, kept, n_dst)),
              # the two-step chain it fuses, the codec's decode then the
              # fp32 aggregation over the same host CSR, and the device
              # time of that aggregation
              two_step_ms=time_ms(torch, lambda: ops.gnn_aggregate(
                  ops.dequantize_int8(values, scales), e_src, e_dst, mask,
                  n_dst, csr)),
              two_step_agg_device_ms=device_ms(
                  torch, lambda: ops.gnn_aggregate(decoded, e_src, e_dst,
                                                   mask, n_dst, csr),
                  "segment_mean_csr_kernel"),
              kept_edges=kept, kept_degree=degree,
              bit_equal_to_two_step=True,
              device_ms=device_ms(torch, lambda: ops.dequant_aggregate(
                  *args, n_dst, csr), "segment_mean_csr_int8_group_kernel"))
    return counts, report


# -- phase 13: sharded training with pull-frequency placement -----------------

def sharded_strategy():
    """OPG + int8 + degree scores over 4 embedding-server shards, rows
    re-placed by observed pull frequency before round 1's pulls."""
    return dataclasses.replace(opg_int8(), num_server_shards=SHARDS,
                               shard_placement="pull_frequency",
                               rebalance_round=1)


@contextlib.contextmanager
def shard_launch_tally(np, tr, tally: dict):
    """Within the block, each fused pull (``gather_quantized``) and push
    apply (``write_quantized``) of the sharded transport ``tr`` adds to
    ``tally[kind]`` the launches of its kernel across the call
    (``counted``), the launches its non-empty shards call for (one a
    shard and layer: ``want``) and each shard's rows."""
    from repro_torch.kernels import ops

    def wrap(kind, counter, inner):
        entry = tally.setdefault(kind, {"calls": 0, "want": 0, "counted": 0,
                                        "rows": {}})

        def run(global_ids, arg=None):
            gids = np.asarray(global_ids, np.int64)
            layers = len(arg) if kind == "push" else \
                (tr.num_layers - 1 if arg is None else len(arg))
            split = tr._split(gids)
            before = ops.launch_counts()[counter]
            out = inner(global_ids, arg)
            entry["calls"] += 1
            entry["counted"] += ops.launch_counts()[counter] - before
            entry["want"] += len(split) * layers
            for sh, pos in split:
                entry["rows"].setdefault(sh, []).append(len(pos))
            return out
        return run

    tr.gather_quantized = wrap("pull", "gather_quantize",
                               tr.gather_quantized)
    tr.write_quantized = wrap("push", "dequant_scatter", tr.write_quantized)
    try:
        yield tally
    finally:
        del tr.gather_quantized, tr.write_quantized


def registered_gids(np, tr):
    return np.unique(np.concatenate([np.nonzero(sv._gid2row >= 0)[0]
                                     for sv in tr.shards]))


def recombination_check(torch, np, tr, when: str) -> dict:
    """Every registered gid, in a seeded permutation, read through the
    sharded transport's fused int8 pull and its fp32 gather; the fp32
    rows written into an in-process transport on the card, whose pull
    must give the same int8 values and scales and rows, bit for bit.
    One sharded pull runs under ``set_sync_debug_mode("error")``.  Pull
    tallies are off meanwhile (these reads are not the path's)."""
    from repro_torch.exchange import InProcessTransport

    track, tr.track_pulls = tr.track_pulls, False
    try:
        gids = registered_gids(np, tr)
        perm = np.random.default_rng(len(gids)).permutation(gids)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            # the class's method: a tally wrapped around the instance's
            # counts the path's pulls only
            pulled = type(tr).gather_quantized(tr, perm)
        except RuntimeError as e:
            raise SmokeFailure(f"the sharded pull waited on the card ({when}):"
                               f" {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        rows = tr.gather(perm)
        one = InProcessTransport(tr.num_layers, tr.hidden, device=DEV)
        one.register(perm)
        one.write(perm, rows)
        for (v, s), (ov, os_), r, o in zip(pulled, one.gather_quantized(perm),
                                           rows, one.gather(perm)):
            check(torch.equal(v, ov) and torch.equal(s, os_),
                  f"sharded int8 pull differs from one server's ({when})")
            check(torch.equal(r, o),
                  f"sharded fp32 gather differs from one server's ({when})")
    finally:
        tr.track_pulls = track
    return {"gids": len(perm), "sync_free": True, "bit_equal": True}


def log_rows(logs) -> list:
    return [{"bytes": lg.bytes, "rpcs": lg.rpcs, "seconds": lg.seconds}
            for lg in logs]


def sharded_kernel_cases(torch, np, trainer, tally: dict) -> dict:
    """Rows 3 and 4 at the sharded path's per-shard shapes, timed as
    ``kernel_phase`` times them: client 0's pull rows and push rows that
    land on the shard holding most of them, on that shard's table."""
    from repro_torch.kernels import exchange_fused as fused
    from repro_torch.kernels import ops, ref

    tr = trainer.exchange
    sh = trainer.shards[0]
    hidden = tr.hidden
    out = {}
    for kind, gids in (("pull", sh.pull_nodes), ("push", sh.push_nodes)):
        split = tr._split(np.asarray(gids, np.int64))
        s, pos = max(split, key=lambda sp: len(sp[1]))
        server = tr.shards[s]
        table = server._bufs[0]
        rows = server._rows(np.asarray(gids, np.int64)[pos])
        n = len(rows)
        launches = tally[kind]["counted"]
        per_shard = {f"shard_{k}": int(np.sum(v))
                     for k, v in sorted(tally[kind]["rows"].items())}
        if kind == "pull":
            idx = ops.row_index(rows, server._cap, DEV, check=True)
            got = fused.gather_quantize(table, idx)
            want = ref.gather_quantize(table, idx)
            check(torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                               want[1]),
                  "gather_quantize differs from plain at the shard's shape")
            out["pull_per_shard"] = with_bound({
                "shape": (int(table.shape[0]), hidden, n), "shard": int(s),
                "launches": launches, "rows_by_shard": per_shard,
                "ms": time_ms(torch, lambda: fused.gather_quantize(table,
                                                                   idx)),
                "plain_ms": time_ms(torch, lambda: ref.gather_quantize(
                    table, idx)),
                "library_ms": None,
                "device_ms": device_ms(torch, lambda: fused.gather_quantize(
                    table, idx), "quantize_quads_kernel"),
                "nbytes": n * 4 + n * hidden * 4 + n * hidden + n * 4})
        else:
            gen = torch.Generator(device=DEV).manual_seed(77)
            pv, ps = ops.quantize_int8(torch.randn((n, hidden),
                                                   generator=gen,
                                                   device=DEV))
            idx = ops.row_index(rows, server._cap, DEV, check=False)
            t_k, t_p = table.clone(), table.clone()
            fused.dequant_scatter_(t_k, idx, pv, ps)
            ref.dequant_scatter_(t_p, idx, pv, ps)
            check(torch.equal(t_k, t_p),
                  "dequant_scatter differs from plain at the shard's shape")
            out["push_per_shard"] = with_bound({
                "shape": (int(table.shape[0]), hidden, n), "shard": int(s),
                "launches": launches, "rows_by_shard": per_shard,
                "ms": time_ms(torch, lambda: fused.dequant_scatter_(
                    t_k, idx, pv, ps)),
                "plain_ms": time_ms(torch, lambda: ref.dequant_scatter_(
                    t_p, idx, pv, ps)),
                "library_ms": None,
                "device_ms": device_ms(torch, lambda: fused.dequant_scatter_(
                    t_k, idx, pv, ps), "scatter_quads_kernel"),
                "nbytes": n * 4 + n * hidden + n * 4 + n * hidden * 4})
    torch.cuda.synchronize()
    return out


def optimizer_checks(torch, np, trainer, batches) -> dict:
    """SGD (momentum 0.9) and Adafactor each take 16 steps of client 0
    from the seeded initial parameters, and the loss on the first batch
    must fall; then one step of SGD, AdamW and Adafactor on the card from
    one set of leaves and gradients must equal the same step on the CPU
    within 1e-6 relative (TF32 off)."""
    from repro_torch.models.gnn import blocks_to_arrays, init_gnn, loss_fn
    from repro_torch.optim import adafactor, adamw, sgd

    g = trainer.g
    feats, caches, labels = trainer.feats[0], trainer._caches[0], \
        trainer.labels[0]
    first = blocks_to_arrays(batches[0], DEV)

    def fresh():
        return init_gnn("graphconv", g.feat_dim, trainer.hidden,
                        g.num_classes, trainer.L,
                        generator=torch.Generator().manual_seed(0),
                        device=DEV)

    out = {}
    saved = trainer.opt
    try:
        for name, opt in (("sgd", sgd(0.05, momentum=0.9)),
                          ("adafactor", adafactor(1e-2))):
            trainer.opt = opt
            params = fresh()
            with torch.no_grad():
                before = float(loss_fn(params, first, feats, caches, labels))
            params, _, losses = trainer.train_minibatches(
                0, params, opt.init(params.leaves()), batches)
            with torch.no_grad():
                after = float(loss_fn(params, first, feats, caches, labels))
            ls = [float(x) for x in losses]
            check(all(np.isfinite(ls)) and after < before,
                  f"{name}: the loss did not fall ({before} -> {after})")
            out[name] = {"first_batch_loss": [before, after],
                         "step_losses": ls}
    finally:
        trainer.opt = saved

    params = fresh()
    leaves = params.leaves()
    grads = torch.autograd.grad(loss_fn(params, first, feats, caches,
                                        labels), leaves)
    errs = {}
    for name, opt in (("sgd", sgd(0.05, momentum=0.9)),
                      ("adamw", adamw(1e-2)), ("adafactor", adafactor(1e-2))):
        card, _ = opt.step([p.detach() for p in leaves], list(grads),
                           opt.init(leaves))
        host = [p.detach().cpu() for p in leaves]
        cpu, _ = opt.step(host, [x.cpu() for x in grads], opt.init(host))
        worst = 0.0
        for a, b in zip(card, cpu):
            a = a.cpu()
            check(bool(torch.all((a - b).abs() <= 1e-6 * b.abs() + 1e-8)),
                  f"{name}: a step on the card is off the CPU's by "
                  f"{max_err(a, b)}")
            worst = max(worst, max_err(a, b))
        errs[name] = worst
    out["card_vs_cpu_max_abs_err"] = errs
    print(f"optimizers on the card: {json.dumps(out)}", flush=True)
    return out


def trace_overhead(torch, np, trainer, batches) -> dict:
    """Client 0's steps over the same pre-sampled batches with the trace
    disabled and enabled, in turns (off, on, on, off, ...), each turn one
    epoch span around ``train_minibatches``: ms a step for each side."""
    from repro_torch.obsv.trace import TRACE

    was = TRACE.enabled
    per = {False: [], True: []}
    params = copy.deepcopy(trainer.model)
    state = trainer.opt.init(params.leaves())
    try:
        for on in (False, True, True, False) * 2:
            TRACE.enabled = on
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with TRACE.span("client.train_epoch",
                            args={"client": 0, "epoch": 0}):
                trainer.train_minibatches(0, params, state, batches)
                torch.cuda.synchronize()
            per[on].append((time.perf_counter() - t0) * 1e3 / len(batches))
    finally:
        TRACE.enabled = was
    return {"steps_each": len(batches) * len(per[False]),
            "off_ms_per_step": per[False], "on_ms_per_step": per[True]}


def sharded_train_phase(torch, np, g, part) -> tuple[dict, dict, list]:
    """The sharded path through the trainer's own code: construct (OPG +
    int8 over 4 shards, pull-frequency placement, AdamW, 2 epochs a
    round), ``pretrain_round``, ``run_round(0)`` and ``run_round(1)``
    (which rebalances before its pulls), each client's epochs cut to
    SHARDED_STEPS minibatches.  Tracing is on.  Returns the measurements,
    the launches of the path and the per-shard kernel cases."""
    import itertools

    from repro_torch.core import federated as fed
    from repro_torch.core.cost_model import NetworkModel
    from repro_torch.exchange import ShardedTransport, get_codec
    from repro_torch.gnnserve import build_serving
    from repro_torch.kernels import ops
    from repro_torch.models.gnn import init_gnn
    from repro_torch.obsv.metrics import REGISTRY
    from repro_torch.obsv.trace import TRACE
    from repro_torch.optim import adamw

    clients, rounds = 4, 2
    TRACE.clear()
    TRACE.enable()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = init_gnn("graphconv", g.feat_dim, 32, g.num_classes, 3,
                     generator=torch.Generator().manual_seed(0), device=DEV)
    trainer = fed.FederatedGNNTrainer(
        g, clients, sharded_strategy(), part=part, model=model,
        optimizer=adamw(1e-2), epochs_per_round=SHARDED_EPOCHS, device=DEV)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    tr = trainer.exchange
    check(isinstance(tr, ShardedTransport) and tr.num_shards == SHARDS
          and tr.track_pulls, f"the trainer built {type(tr).__name__}")

    # each client's epoch yields SHARDED_STEPS minibatches, each timed
    sample_ms: list = []

    def cut(inner):
        def epoch():
            it = inner()
            for _ in range(SHARDED_STEPS):
                t = time.perf_counter()
                mb = next(it)
                sample_ms.append((time.perf_counter() - t) * 1e3)
                yield mb
        return epoch
    for smp in trainer.samplers:
        smp.epoch = cut(smp.epoch)
    # every step's loss, by client, for the check that they fall
    step_losses: dict = {ci: [] for ci in range(clients)}
    inner_train = trainer.train_minibatches

    def train_minibatches(ci, params, opt_state, batches):
        out = inner_train(ci, params, opt_state, batches)
        step_losses[ci] += out[2]
        return out
    trainer.train_minibatches = train_minibatches

    # per step: the block copy (synchronised), then forward + backward +
    # AdamW up to the optimizer step's end (CUDA events), host ms
    copy_ms, compute_ms, step_ms, copied, started = [], [], [], [], []
    inner_copy = fed.blocks_to_arrays

    def copy_blocks(mb, device):
        started.append(time.perf_counter())
        out = inner_copy(mb, device)
        torch.cuda.synchronize()
        copy_ms.append((time.perf_counter() - started[-1]) * 1e3)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        copied.append(ev)
        return out
    inner_step = trainer.opt.step

    def opt_step(params, grads, state):
        out = inner_step(params, grads, state)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        compute_ms.append(copied[-1].elapsed_time(end))
        step_ms.append((time.perf_counter() - started[-1]) * 1e3)
        return out
    trainer.opt = dataclasses.replace(trainer.opt, step=opt_step)

    tally: dict = {}
    launches: dict = {}
    fill_s: list = []
    push_s: list = []
    agg_s: list = []
    rebalance: list = []
    stats = []
    logs_by_round = []
    sync = torch.cuda.synchronize
    inner_rebalance = tr.rebalance_by_pulls

    def rebalanced():
        """The path's rebalance, with every registered gid read before
        and after (fp32, tallies off): rows move, values do not."""
        gids = registered_gids(np, tr)
        tr.track_pulls = False
        before = tr.gather(gids)
        tr.track_pulls = True
        t = time.perf_counter()
        placement = inner_rebalance()
        sync()
        rebalance.append(time.perf_counter() - t)
        tr.track_pulls = False
        after = tr.gather(gids)
        tr.track_pulls = True
        check(placement is not None, "no pull was tallied before round 1")
        check(all(torch.equal(a, b) for a, b in zip(before, after)),
              "the rebalance changed a row's values")
        check(registered_gids(np, tr).tolist() == gids.tolist(),
              "the rebalance lost or invented a row")
        return placement
    tr.rebalance_by_pulls = rebalanced

    checks = {}
    fed.blocks_to_arrays = copy_blocks
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(shard_launch_tally(np, tr, tally))
            for name, log in (("_fill_cache", fill_s),
                              ("_compute_push", push_s),
                              ("aggregate", agg_s)):
                stack.enter_context(timed(trainer, name, log, sync=sync))
            t0 = time.perf_counter()
            trainer.pretrain_round()
            sync()
            pretrain_s = time.perf_counter() - t0
            cum = 0.0
            for r in range(rounds):
                t0 = time.perf_counter()
                st = trainer.run_round(r, cum)
                sync()
                cum = st.cum_time
                stats.append((st, time.perf_counter() - t0))
                logs_by_round.append(log_rows(tr.shard_logs))
                counts = ops.launch_counts()
                for k, v in counts.items():
                    launches[k] = launches.get(k, 0) + v
                # launches of the checks below are not the path's
                checks[f"after_round_{r}"] = recombination_check(
                    torch, np, tr, f"after round {r}")
                ops.reset_launch_counts()
    finally:
        fed.blocks_to_arrays = inner_copy
        trainer.opt = dataclasses.replace(trainer.opt, step=inner_step)
        del tr.rebalance_by_pulls, trainer.train_minibatches
        for smp in trainer.samplers:
            del smp.epoch
    events = list(TRACE.events)
    spans: dict = {}
    for name, _, _, _, dur, _ in events:
        n, secs = spans.get(name, (0, 0.0))
        spans[name] = (n + 1, secs + dur)
    want_spans = {"client.pull": clients * rounds,
                  "client.train_epoch": clients * SHARDED_EPOCHS * rounds,
                  "client.push_compute": clients * rounds,
                  "round.aggregate": rounds}
    for name, n in want_spans.items():
        check(spans.get(name, (0,))[0] == n,
              f"span {name}: {spans.get(name, (0,))[0]} recorded, {n} due")
    trace_path = pathlib.Path(__file__).resolve().parent / "build" \
        / "sharded_trace.json"
    trace_path.parent.mkdir(exist_ok=True)
    TRACE.write_chrome_trace(str(trace_path))
    TRACE.disable()

    for s_, _ in stats:
        check(np.isfinite(s_.train_loss), f"round {s_.round_idx}: loss "
                                          f"{s_.train_loss}")
        check(np.isfinite(s_.accuracy) and 0.0 <= s_.accuracy <= 1.0,
              f"round {s_.round_idx}: accuracy {s_.accuracy}")
    per_client = SHARDED_STEPS * SHARDED_EPOCHS * rounds
    for ci, ls in step_losses.items():
        ls = [float(x) for x in ls]
        check(len(ls) == per_client and all(np.isfinite(ls)),
              f"client {ci}: {len(ls)} losses of {per_client}, or not finite")
        first, last = np.mean(ls[:8]), np.mean(ls[-8:])
        check(last < first, f"client {ci}: loss did not fall "
                            f"({first:.4f} -> {last:.4f})")
        step_losses[ci] = (float(first), float(last))
    for name in TRAIN_KERNELS:
        check(launches.get(name, 0) > 0,
              f"kernel {name} never launched on the sharded path")
    for kind, counter in (("pull", "gather_quantize"),
                          ("push", "dequant_scatter")):
        t = tally[kind]
        check(t["counted"] == t["want"] == launches[counter],
              f"sharded {kind}: {launches[counter]} {counter} launches, "
              f"{t['counted']} in {t['calls']} calls, {t['want']} due to "
              "their non-empty shards")

    # the placement: pull mass of the fullest shard, hash against LPT
    counts = tr._pull_counts
    hot = np.nonzero(counts > 0)[0]
    lpt = np.bincount(tr._placement[hot], weights=counts[hot],
                      minlength=SHARDS)
    hashed = np.bincount(hot % SHARDS, weights=counts[hot], minlength=SHARDS)
    check(lpt.max() <= hashed.max(),
          f"LPT's fullest shard holds {lpt.max()} pulls, hash's "
          f"{hashed.max()}")
    # modelled pull time: 4 shards against one server, at the same sets
    net = NetworkModel()
    bps = get_codec("int8").bytes_per_scalar(tr.hidden)
    pull_model = [{"client": ci, "rows": len(sh.pull_nodes),
                   "one_server_s": net.transfer_time(len(sh.pull_nodes), 32,
                                                     2, bytes_per_scalar=bps),
                   "sharded_s": tr.transfer_time(sh.pull_nodes, 2, bps)}
                  for ci, sh in enumerate(trainer.shards)]

    # the sharded export serves; the plane's metrics move by its stats
    t0 = time.perf_counter()
    bundle = trainer.export_for_serving()
    sync()
    export_s = time.perf_counter() - t0
    plane = build_serving(bundle, cache_rows=100_000, serve_fanout=10,
                          batch_size=64, depth_schedule=[1, 3], device=DEV)
    vids, thrs = zipf_queries(np, g.num_vertices, SHARDED_QUERIES, 31)
    m0 = REGISTRY.snapshot("pt_gnnserve.")
    t0 = time.perf_counter()
    rids = [plane.submit(int(v), float(t)) for v, t in zip(vids, thrs)]
    served = {r.rid: r for r in plane.drain()}
    sync()
    serve_s = time.perf_counter() - t0
    moved = REGISTRY.delta(REGISTRY.snapshot("pt_gnnserve."), m0)
    check(sorted(served) == sorted(rids), "sharded serving: requests lost")
    pst = plane.stats()
    want_metrics = {"served": pst["served"], "forwards": pst["forwards"],
                    **{f"cache.{k}": pst["cache"][k] for k in (
                        "hits", "misses", "stale_refreshes", "evictions")}}
    got_metrics = {k: moved.get(f"pt_gnnserve.{k}", 0) for k in want_metrics}
    check(got_metrics == want_metrics,
          f"pt_gnnserve metrics {got_metrics} != the plane's {want_metrics}")
    full = [(rid, int(v)) for rid, v, t in zip(rids, vids, thrs) if t == 1.0]
    offline = offline_ref(np, plane, [v for _, v in full])
    bad = [rid for rid, v in full if served[rid].pred != offline[v]]
    check(not bad, f"sharded serving: {len(bad)} threshold-1.0 answers "
                   "differ from offline_predict")

    kernels = sharded_kernel_cases(torch, np, trainer, tally)
    # 16 minibatches of client 0, sampled beforehand, for the last checks
    it = trainer.samplers[0].epoch()
    batches = list(itertools.islice(it, SHARDED_STEPS))
    overhead = trace_overhead(torch, np, trainer, batches)
    opts = optimizer_checks(torch, np, trainer, batches)

    n_steps = len(step_ms)
    steps = [a + b for a, b in zip(sample_ms, step_ms)]
    out = {
        "strategy": sharded_strategy().describe(),
        "optimizer": trainer.opt.name,
        "setup_s": setup_s, "pretrain_round_s": pretrain_s,
        "rounds": [{"round": s_.round_idx, "wall_s": w,
                    "accuracy": s_.accuracy, "train_loss": s_.train_loss,
                    "modelled_pull_s": s_.phases.pull,
                    "modelled_round_s": s_.round_time,
                    "embeddings_stored": s_.embeddings_stored}
                   for s_, w in stats],
        "steps": n_steps,
        "steps_per_s": n_steps / sum(steps) * 1e3,
        "step_ms": percentiles(np, steps),
        "sample_ms": percentiles(np, sample_ms),
        "copy_ms": percentiles(np, copy_ms),
        "fwd_bwd_adamw_ms": percentiles(np, compute_ms),
        "fill_s": fill_s, "push_compute_s": push_s, "aggregate_s": agg_s,
        "rebalance_s": rebalance,
        "loss_first8_last8": step_losses,
        "shard_logs_round_0": logs_by_round[0],
        "shard_logs_round_1_alone": [
            {k: b[k] - a[k] for k in b}
            for a, b in zip(logs_by_round[0], logs_by_round[1])],
        "fullest_shard_pulls": {"hash": float(hashed.max()),
                                "lpt": float(lpt.max()),
                                "hash_by_shard": hashed.tolist(),
                                "lpt_by_shard": lpt.tolist()},
        "modelled_pull_one_server_vs_sharded": pull_model,
        "tally": {k: {kk: vv for kk, vv in v.items() if kk != "rows"}
                  for k, v in tally.items()},
        "recombination": checks,
        "spans": {k: {"count": n, "seconds": secs}
                  for k, (n, secs) in sorted(spans.items())},
        "trace_file": str(trace_path.relative_to(trace_path.parents[1])),
        "export_s": export_s, "queries": SHARDED_QUERIES,
        "serve_s": serve_s, "queries_per_s": SHARDED_QUERIES / serve_s,
        "metrics_delta": got_metrics, "offline_checked": len(full),
        "trace_overhead": overhead, "optimizers": opts,
        "memory_bytes": tr.memory_bytes(),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    return out, launches, kernels

# -- phases 10-13: LM decode serving ------------------------------------------

def swa_inputs(torch, np, B, T, Hkv, G, dh, seed, dtype, *,
               at_head: bool = False):
    """q/K/V from a seeded numpy stream; every sequence's ring has
    wrapped (positions rotated past the capacity) and a tenth of its
    slots are invalid.  The query sits at a random point of the ring, so
    the slots after it are in the future, or with ``at_head`` at the
    newest position, as on the serving path."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
    q = t(rng.standard_normal((B, Hkv * G, dh), np.float32)).to(dtype)
    k = t(rng.standard_normal((B, T, Hkv, dh), np.float32)).to(dtype)
    v = t(rng.standard_normal((B, T, Hkv, dh), np.float32)).to(dtype)
    shift = rng.integers(0, T, B)
    pos = np.stack([np.roll(np.arange(T), s) + T for s in shift])
    valid = rng.random((B, T)) < 0.9
    qpos = pos.max(axis=1) if at_head else 2 * T - 1 - shift
    return (q, k, v, t(pos.astype(np.int32)), t(valid),
            t(qpos.astype(np.int32)))


def swa_case(torch, args, window) -> dict:
    """The decode attention at one bf16 shape (``window`` None: causal
    only): held to one bf16 step of each element of its plain version
    (2^-7 of it, plus 1e-5 near zero) and to its own bytes over two
    launches, then timed beside the plain version and one
    ``scaled_dot_product_attention`` call.  The bound counts K and V of
    the kept slots only: a masked slot's V row has weight 0 and its K
    row's score is replaced."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    q, k, v, pos, valid, qpos = args
    B, T, Hkv, dh = k.shape
    got = ops.swa_attention_decode(*args, window=window)
    check(torch.equal(got, ops.swa_attention_decode(*args, window=window)),
          f"swa not deterministic at {tuple(k.shape)}: two launches differ")
    got = got.float()
    want = ref.swa_attention_decode(*args, window).float()
    err = max_err(got, want)
    over = float(((got - want).abs()
                  / (2.0 ** -7 * want.abs() + 1e-5)).max())
    check(over <= 1.0, f"swa bf16 off by {err} at {tuple(k.shape)}, "
                       f"{over:.3g} of one bf16 step")
    keep = valid & (pos <= qpos[:, None])
    if window is not None:
        keep &= pos > qpos[:, None] - window
    mask = keep[:, None, None, :]
    qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    lib = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                         enable_gqa=True)[:, :, 0]
    kept = int(keep.sum())
    return {"shape": (B, T, Hkv, q.shape[1] // Hkv, dh), "err": err,
            "bf16_steps_off": over, "deterministic": True,
            "max_want": float(want.abs().max()),
            "ms": time_ms(torch, lambda: ops.swa_attention_decode(
                *args, window=window)),
            "plain_ms": time_ms(torch, lambda: ref.swa_attention_decode(
                *args, window)),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True)),
            "library_max_abs_err": max_err(lib, got),
            "device_ms": device_ms(torch, lambda: ops.swa_attention_decode(
                *args, window=window), "swa_decode_kernel"),
            "kept_slots": kept,
            # q, the kept slots' K and V rows, positions and validity,
            # q_pos in; out
            "nbytes": q.numel() * 2 + kept * Hkv * dh * 2 * 2
            + pos.numel() * 4 + valid.numel() + B * 4 + q.numel() * 2}


def swa_kernel_phase(torch, np) -> list[dict]:
    """The decode attention kernel against its plain version: fp32 at the
    JAX tests' shapes, with ``window=None`` and a fully masked row, T
    below the cluster size, G 12 with dh 128 and 256 (within 2e-5); bf16
    at the serving path's shape and at a batch of one (row 8'), each
    checked and timed by ``swa_case``.  Prints the cluster size and what
    the card compiled for the path's variant."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import swa_attention as swa_mod

    worst = 0.0
    for B, T, Hkv, G, dh, window in ((2, 64, 2, 3, 16, 32),
                                     (1, 128, 1, 1, 64, 128),
                                     (3, 256, 4, 2, 32, 100),
                                     (2, 48, 1, 12, 128, None),
                                     (2, 5, 2, 3, 64, None),
                                     (1, 200, 2, 12, 256, 150)):
        q, k, v, pos, valid, qpos = swa_inputs(torch, np, B, T, Hkv, G, dh,
                                               B * T, torch.float32)
        if window is None:
            valid[0] = False
        err = max_err(ops.swa_attention_decode(q, k, v, pos, valid, qpos,
                                               window=window),
                      ref.swa_attention_decode(q, k, v, pos, valid, qpos,
                                               window))
        check(err <= 2e-5, f"swa fp32 off by {err} at {(B, T, Hkv, G, dh)}")
        worst = max(worst, err)
    T, Hkv, G, dh, window = 8192, 5, 3, 64, 8192
    path = swa_case(torch, swa_inputs(torch, np, LM_LANES, T, Hkv, G, dh, 8,
                                      torch.bfloat16, at_head=True), window)
    one = swa_case(torch, swa_inputs(torch, np, 1, T, Hkv, G, dh, 9,
                                     torch.bfloat16, at_head=True), window)
    info = swa_mod.kernel_info(torch.bfloat16, dh, G)
    cluster = {b: swa_mod.default_cluster(b * Hkv, torch.device(DEV))
               for b in (LM_LANES, 1)}
    print(f"swa_attention_decode: clusters of {cluster[LM_LANES]} blocks "
          f"share a sequence's slots at batch {LM_LANES}, of {cluster[1]} at "
          f"batch 1; the path's variant: {json.dumps(info)}", flush=True)
    print(f"swa_attention_decode: fp32 max|d| {worst:.3g} (<= 2e-5), "
          f"bf16 max|d| {path['err']:.3g} with max|want| "
          f"{path['max_want']:.3g}, {path['bf16_steps_off']:.3g} of one "
          "bf16 step (<= 1); two launches equal", flush=True)
    report: list = []
    add_entry(report, "swa_attention_decode",
              "src/repro_torch/csrc/swa_decode.cu",
              "src/repro/kernels/swa_attention.py:55",
              max(worst, path["err"], one["err"]), path["shape"],
              path["ms"], path["plain_ms"], path["nbytes"],
              library_ms=path["library_ms"],
              library_max_abs_err=path["library_max_abs_err"],
              fp32_max_abs_err=worst, kept_slots=path["kept_slots"],
              bf16_steps_off=path["bf16_steps_off"], deterministic=True,
              cluster=cluster[LM_LANES], cluster_batch_1=cluster[1],
              variant=info,
              device_ms=path["device_ms"],
              batch_1=with_bound({k: one[k] for k in (
                  "shape", "err", "bf16_steps_off", "ms", "plain_ms",
                  "library_ms", "device_ms", "kept_slots", "nbytes")}))
    print("kernel swa_attention_decode at batch 1: "
          + json.dumps(report[-1]["batch_1"]), flush=True)
    return report


def lm_config(dtype: str = "bfloat16"):
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.steps import cache_capacity, shape_variant

    cfg = dataclasses.replace(
        shape_variant(get_config(LM_ARCH), SHAPES["long_500k"]),
        param_dtype=dtype)
    return cfg, cache_capacity(cfg, SHAPES["long_500k"])


def fill_kv(torch, cache: dict, seed: int) -> None:
    """Seeded normal K/V in every slot of every layer, drawn on the card,
    so the kernel reads real data rather than zeros."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    for name in ("k", "v"):
        cache["blocks"][name].normal_(generator=gen)


def tree_to(tree, device):
    """A copy of a nested dict or list of tensors (None leaves kept) on
    ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return None if tree is None else tree.to(device, copy=True)


def lm_decode_phase(torch, np) -> tuple[dict, dict, object, object]:
    """The launch/serve path at full width under long_500k: seeded random
    bf16 parameters on the card, LM_LANES lanes, a cache of 8192 slots
    that has seen 8192 - 64 tokens (K/V filled from a seeded generator),
    then LM_DECODE_STEPS greedy steps, each read back to the host as the
    launcher does.  The launch counters are zeroed just before the steps
    and read just after."""
    from repro_torch.data import synthetic_request_stream
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    cfg, cap = lm_config()
    prefill = cap - 64
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(
        cfg, generator=torch.Generator(device=DEV).manual_seed(0), device=DEV)
    cache = lm.init_cache(cfg, LM_LANES, cap, prefill_len=prefill,
                          device=DEV)
    fill_kv(torch, cache, 1)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    serve_step = lm.make_serve_step(cfg)
    toks = torch.from_numpy(next(synthetic_request_stream(
        cfg, batch=LM_LANES, prompt_len=1, seed=0))).to(DEV)

    ops.reset_launch_counts()
    events = []
    t0 = time.perf_counter()
    for _ in range(LM_DECODE_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, cache = serve_step(params, toks, cache)
        toks = torch.argmax(logits, dim=-1)
        end.record()
        toks[:, 0].cpu()                    # the launcher reads each token
        events.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = LM_DECODE_STEPS * cfg.num_layers
    check(counts["swa_attention_decode"] == want,
          f"swa_attention_decode launched {counts['swa_attention_decode']} "
          f"times in {LM_DECODE_STEPS} steps, expected {want}")
    check(bool(torch.isfinite(logits.float()).all()), "LM logits not finite")
    length = cache["blocks"]["length"]
    check(bool((length == prefill + LM_DECODE_STEPS).all())
          and bool((cache["blocks"]["index"]
                    == (prefill + LM_DECODE_STEPS) % cap).all()),
          "the ring's bookkeeping did not advance one slot per step")
    step_ms = [s.elapsed_time(e) for s, e in events]

    wall_w: list[float] = []

    def run():
        nonlocal toks, cache
        t1 = time.perf_counter()
        for _ in range(LM_PROFILED_STEPS):
            logits, cache = serve_step(params, toks, cache)
            toks = torch.argmax(logits, dim=-1)
            toks[:, 0].cpu()
        torch.cuda.synchronize()
        wall_w.append(time.perf_counter() - t1)
    evs = device_events(torch, run, sessions=2)
    swa = [e for e in evs if "swa_decode_kernel" in e.name]
    window = {"steps": LM_PROFILED_STEPS, "window_s": wall_w[-1],
              **busy_share(evs, wall_w[-1]),
              "device_events_per_step": len(evs) / LM_PROFILED_STEPS
              if evs else None,
              "swa_device_ms_per_step":
              sum(e.time_range.elapsed_us() for e in swa) / 1e3
              / LM_PROFILED_STEPS if evs else None}
    out = {"arch": cfg.name, "dtype": cfg.param_dtype,
           "sliding_window": cfg.sliding_window, "lanes": LM_LANES,
           "capacity": cap, "prefill_len": prefill,
           "params": lm.param_count(params), "setup_s": setup_s,
           "steps": LM_DECODE_STEPS, "wall_s": wall,
           "tokens_per_s": LM_DECODE_STEPS * LM_LANES / wall,
           "step_ms": percentiles(np, step_ms),
           "host_step_ms_mean": wall / LM_DECODE_STEPS * 1e3,
           "swa_launches": counts["swa_attention_decode"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "profiled_steps": window}
    print("LM long-window decode: " + json.dumps(out), flush=True)
    return out, counts, cfg, params


def lm_batcher_phase(torch, np, cfg, params) -> dict:
    """ContinuousBatcher at full width: LM_LANES lanes, LM_REQUESTS
    requests of LM_PROMPT-token prompts from the seeded request stream,
    LM_NEW new tokens each; every request must complete once with all
    its tokens."""
    from repro_torch.core.serving import ContinuousBatcher
    from repro_torch.data import synthetic_request_stream
    from repro_torch.kernels import ops

    cap = min(LM_PROMPT + LM_NEW, cfg.sliding_window)
    bat = ContinuousBatcher(cfg, params, lanes=LM_LANES, capacity=cap,
                            device=DEV)
    prompts = next(synthetic_request_stream(cfg, batch=LM_REQUESTS,
                                            prompt_len=LM_PROMPT, seed=0))
    rids = [bat.submit(p, max_new=LM_NEW) for p in prompts]
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = bat.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    got = [r.rid for r in done]
    check(len(got) == len(set(got)) and sorted(got) == sorted(rids),
          f"batcher: {len(got)} completions for {len(rids)} requests")
    check(all(len(r.generated) == LM_NEW for r in done),
          "batcher: a request did not get all its tokens")
    check(counts["swa_attention_decode"] == bat.steps * cfg.num_layers,
          f"batcher: {counts['swa_attention_decode']} swa launches in "
          f"{bat.steps} steps")
    out = {"lanes": LM_LANES, "capacity": cap, "requests": len(done),
           "prompt": LM_PROMPT, "max_new": LM_NEW, "steps": bat.steps,
           "wall_s": wall,
           "generated_tokens_per_s": LM_REQUESTS * LM_NEW / wall,
           "processed_tokens_per_s":
           LM_REQUESTS * (LM_PROMPT + LM_NEW - 1) / wall,
           "swa_launches": counts["swa_attention_decode"]}
    print("LM batcher: " + json.dumps(out), flush=True)
    return out


def lm_reference_phase(torch, np) -> dict:
    """The full-width model in fp32 on the card (kernels) and on the CPU
    (plain versions), from one set of parameters and the same cache
    contents (LM_REF_STEPS short of a full ring of 8192), teacher-forced
    for LM_REF_STEPS steps so the ring wraps; TF32 is off.  No greedy
    feedback: random weights leave near-ties over 49,152 tokens."""
    from repro_torch.data import synthetic_request_stream
    from repro_torch.models import lm

    cfg, cap = lm_config("float32")
    params = lm.init_params(
        cfg, generator=torch.Generator(device=DEV).manual_seed(2), device=DEV)
    params_cpu = tree_to(params, "cpu")
    cache = lm.init_cache(cfg, 2, cap, prefill_len=cap - 4, device=DEV)
    fill_kv(torch, cache, 3)
    cache_cpu = tree_to(cache, "cpu")
    toks = next(synthetic_request_stream(cfg, batch=2,
                                         prompt_len=LM_REF_STEPS, seed=2))
    worst = 0.0
    t0 = time.perf_counter()
    for t in range(LM_REF_STEPS):
        tk = torch.from_numpy(toks[:, t: t + 1])
        lg, cache = lm.decode_step(params, cfg, tk.to(DEV), cache)
        lc, cache_cpu = lm.decode_step(params_cpu, cfg, tk, cache_cpu)
        rel = max_err(lg.cpu(), lc) / float(lc.abs().max())
        check(rel <= 1e-3, f"LM card vs CPU: step {t} logits off by "
                           f"{rel:.3g} of max|logit|")
        worst = max(worst, rel)
    out = {"dtype": "float32", "lanes": 2, "capacity": cap,
           "prefill_len": cap - 4, "steps": LM_REF_STEPS,
           "max_rel_err": worst, "seconds": time.perf_counter() - t0}
    print("LM card vs CPU reference: " + json.dumps(out), flush=True)
    return out


# -- phase 14: the TCP deployment ---------------------------------------------

def tcp_config(scale: float, rounds: int, **over):
    """The phase's RunConfig: the reddit preset, 4 clients, OPG + int8 +
    degree scores, GraphConv L=3 hidden 32, TCP_EPOCHS local epochs."""
    from repro_torch.fedsvc.runtime import RunConfig

    return RunConfig(graph="reddit", scale=scale, graph_seed=0,
                     num_clients=4, strategy="OPG",
                     overrides={"codec": "int8", "score_kind": "degree",
                                **over},
                     epochs_per_round=TCP_EPOCHS, rounds=rounds, seed=0)


def implied_launches(transports) -> dict:
    """The codec launches the RPCs of ``transports`` call for: one a
    layer of every non-empty shard RPC, on the client (row 1 encodes a
    write, row 2 decodes a gather's reply) and on the server (row 4
    applies the write, row 3 answers the gather)."""
    want = {"quantize_int8": 0, "dequantize_int8": 0, "gather_quantize": 0,
            "dequant_scatter": 0}
    for t in transports:
        for r in t.rpc_samples:
            if r.n_rows == 0:
                continue
            if r.op == "write":
                want["quantize_int8"] += r.layers
                want["dequant_scatter"] += r.layers
            elif r.op == "gather":
                want["dequantize_int8"] += r.layers
                want["gather_quantize"] += r.layers
    return want


def weight_wire_run(torch, np, dev: str, scale: float) -> dict:
    """A short deployment in threads with the int8 weight codec and its
    error feedback (Strategy D, no embedding plane): what the
    coordinator decodes from every update is bit-equal to the worker's
    local round trip (the view its EF committed), and an update is 1 B a
    scalar plus 4 B a leaf."""
    from repro_torch.exchange import codec as tcodec
    from repro_torch.exchange.delta import LeafErrorFeedback
    from repro_torch.fedsvc.coordinator import serve_in_thread
    from repro_torch.fedsvc.runtime import make_coordinator_state
    from repro_torch.fedsvc.worker import FedWorker, run_in_thread
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(
        tcp_config(scale, 2, weight_codec="int8",
                   weight_error_feedback=True), strategy="D",
        epochs_per_round=1)
    committed, received = [], []
    commit = LeafErrorFeedback.commit

    def spy_commit(self, compensated, decoded):
        committed.append([np.asarray(d).copy() for d in decoded])
        return commit(self, compensated, decoded)

    LeafErrorFeedback.commit = spy_commit
    try:
        state = make_coordinator_state(cfg, device=dev)
        update = state._op_update

        def spy_update(conn_id, header, tensors):
            received.append((header, [np.asarray(t).copy()
                                      for t in tensors]))
            return update(conn_id, header, tensors)

        state._op_update = spy_update
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with serve_in_thread(state) as coord:
            workers = [FedWorker(cfg, [2 * i, 2 * i + 1], coord.address,
                                 device=dev) for i in range(2)]
            threads = [run_in_thread(w) for w in workers]
            check(coord.join(timeout=300), "weight-wire run: no DONE")
            for t in threads:
                t.join(60)
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
    finally:
        LeafErrorFeedback.commit = commit
    check(len(state.history) == 2 and len(received) == 8,
          f"weight-wire run: {len(state.history)} rounds, "
          f"{len(received)} updates")
    n_params = sum(int(np.prod(l.shape)) for l in state.leaves)
    n_leaves = len(state.leaves)
    sizes = [sum(t.nbytes for t in ts) for _, ts in received]
    check(all(s == n_params + 4 * n_leaves for s in sizes),
          f"update payloads {sorted(set(sizes))} B, want "
          f"{n_params} + 4 x {n_leaves}")
    decoded = [tcodec.decode_leaves("int8", t, h["shapes"], device=dev)
               for h, t in received]
    ours = sorted(x.tobytes() for d in decoded for x in d)
    theirs = sorted(x.tobytes() for d in committed for x in d)
    check(ours == theirs, "the coordinator's decoded updates differ from "
                          "the workers' local round trips")
    largest = max(int(np.prod(l.shape)) for l in state.leaves)
    return {"rounds": len(state.history), "updates": len(received),
            "params": n_params, "leaves": n_leaves, "largest_leaf": largest,
            "update_payload_bytes": sizes[0],
            "weight_bytes_by_round": [h["weight_bytes"]
                                      for h in state.history],
            "accuracy": [h["accuracy"] for h in state.history],
            "wall_s": wall, "launches": launches}


def leaf_kernel_cases(torch, np, size: int, launches: dict) -> dict:
    """Rows 1 and 2 at the weight wire's largest leaf, one (1, size) row
    (the encode's one-warp-a-row branch, the decode's four values a
    thread), against their plain versions."""
    from repro_torch.kernels import ops, ref

    x = torch.randn((1, size), generator=torch.Generator(
        device=DEV).manual_seed(5), device=DEV)
    q, s = ops.quantize_int8(x)
    rq, rs = ref.quantize_int8(x)
    check(torch.equal(q, rq) and torch.equal(s, rs),
          f"quantize_int8 differs from plain at (1, {size})")
    check(torch.equal(ops.dequantize_int8(q, s), ref.dequantize_int8(q, s)),
          f"dequantize_int8 differs from plain at (1, {size})")
    enc = with_bound({
        "shape": (1, size), "launches": launches.get("quantize_int8", 0),
        "ms": time_ms(torch, lambda: ops.quantize_int8(x)),
        "plain_ms": time_ms(torch, lambda: ref.quantize_int8(x)),
        "library_ms": None,
        "device_ms": device_ms(torch, lambda: ops.quantize_int8(x),
                               "quantize_rows_kernel"),
        "nbytes": size * 4 + size + 4})
    dec = with_bound({
        "shape": (1, size), "launches": launches.get("dequantize_int8", 0),
        "ms": time_ms(torch, lambda: ops.dequantize_int8(q, s)),
        "plain_ms": time_ms(torch, lambda: ref.dequantize_int8(q, s)),
        "library_ms": time_ms(torch, lambda: torch.mul(q, s)),
        "device_ms": device_ms(torch, lambda: ops.dequantize_int8(q, s),
                               "dequantize_quads_kernel"),
        "nbytes": size + 4 + size * 4})
    return {"quantize_int8": enc, "dequantize_int8": dec}


def tcp_thread_phase(torch, np, dev: str = DEV,
                     scale: float = TCP_THREAD_SCALE) -> tuple[dict, dict]:
    """14a: two port embed servers, a port coordinator and two port
    workers of two clients each, in threads over loopback TCP, held to
    the port's in-process trainer over 2 shards from the same RunConfig.
    Returns the measurements and the launches of the deployment's
    window."""
    from repro_torch.core.cost_model import NetworkModel
    from repro_torch.exchange import get_codec
    from repro_torch.fedsvc.coordinator import serve_in_thread
    from repro_torch.fedsvc.runtime import make_coordinator_state
    from repro_torch.fedsvc.worker import FedWorker, run_in_thread
    from repro_torch.kernels import ops
    from repro_torch.launch import embed_server, obs_dump
    from repro_torch.obsv import teleserve
    from repro_torch.obsv.trace import TRACE

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    ref = tcp_config(scale, 2, num_server_shards=2).build_trainer(device=dev)
    ref_stats = ref.train(2)
    sync()
    ref_s = time.perf_counter() - t0

    TRACE.clear()
    TRACE.enable()
    servers = [embed_server.serve_in_thread(3, 32, device=dev)
               for _ in range(2)]
    cfg = tcp_config(scale, 2)
    cfg.embed_addrs = [f"{h.host}:{h.port}" for h in servers]
    obs = [teleserve.serve_telemetry() for _ in range(2)]
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state = make_coordinator_state(cfg, device=dev)
        with serve_in_thread(state) as coord:
            workers = [FedWorker(cfg, [2 * i, 2 * i + 1], coord.address,
                                 worker_id=f"w{i}", device=dev)
                       for i in range(2)]
            setup_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            threads = [run_in_thread(w) for w in workers]
            check(coord.join(timeout=600), "14a: the coordinator never "
                                           "finished")
            for t in threads:
                t.join(60)
            sync()
            run_s = time.perf_counter() - t1
            launches = ops.launch_counts()
            check(all(not t.is_alive() for t in threads)
                  and all(not w.dropped and not w.disconnected
                          for w in workers), "14a: a worker did not finish")
            doc, table = obs_dump.dump(
                [("coordinator", coord.address)]
                + [(f"embed{i}", h.address) for i, h in enumerate(servers)]
                + [(f"worker{i}", h.address) for i, h in enumerate(obs)])
    finally:
        TRACE.disable()
        for h in servers + obs:
            h.stop()
    transports = [w.trainer.exchange for w in workers]

    # the model: leaves and accuracies as the in-process trainer's
    leaf_err = max(float(np.abs(a - b).max()) for a, b in
                   zip(ref.params_leaves(), state.leaves))
    print(f"14a: max |leaf - in-process leaf| {leaf_err:.3g}", flush=True)
    check(leaf_err <= TOL, f"14a: leaves differ from the in-process "
                           f"trainer's by {leaf_err}")
    accs = [h["accuracy"] for h in state.history]
    check(accs == [s.accuracy for s in ref_stats],
          f"14a: accuracies {accs} != in-process "
          f"{[s.accuracy for s in ref_stats]}")
    # the wire: each shard's payload bytes are the model's bytes
    bps = get_codec("int8").bytes_per_scalar(32)
    net = NetworkModel()
    shard_bytes = [0, 0]
    for t in transports:
        for s, lg in enumerate(t.wire_logs):
            want = sum(net.embedding_bytes(r.n_rows, 32, r.layers,
                                           bytes_per_scalar=bps)
                       for r in t.rpc_samples
                       if r.shard == s and r.op != "register")
            check(lg.bytes == want, f"14a: shard {s} carried {lg.bytes} B, "
                                    f"the model's bytes are {want}")
            shard_bytes[s] += lg.bytes
    # the kernels: the codec launches are those the RPCs call for
    want = implied_launches(transports)
    got = {k: launches.get(k, 0) for k in want}
    check(got == want, f"14a: codec launches {got}, the RPCs call for "
                       f"{want}")
    # the scrape: five endpoints; the RPC histograms count the ledgers
    metrics = {}
    for block in table.split("# ")[1:]:
        label = block.split(" ", 1)[0]
        metrics[label] = {ln.split(" ", 1)[0]: ln.split(" ", 1)[1]
                          for ln in block.splitlines()[1:] if ln}
    check(len([e for e in doc["traceEvents"] if e["ph"] == "M"]) == 5,
          "14a: obs_dump did not scrape five endpoints")
    rpc_hist = sum(int(v.split()[0].split("=")[1])
                   for k, v in metrics["worker0"].items()
                   if k.startswith("pt_exchange.latency_s."))
    rpc_log = sum(t.wire_log.rpcs for t in transports)
    check(rpc_hist == rpc_log, f"14a: pt_exchange counts {rpc_hist} RPCs, "
                               f"the TransferLogs {rpc_log}")
    wire_log = [t.wire_log for t in transports]
    return {
        "scale": scale, "clients": 4, "rounds": 2, "epochs": TCP_EPOCHS,
        "reference_s": ref_s, "setup_s": setup_s, "run_s": run_s,
        "accuracy": accs, "max_leaf_err": leaf_err,
        "round_wall_s": [h["wall_s"] for h in state.history],
        "shard_payload_bytes": shard_bytes,
        "rpcs": rpc_log, "rpc_histogram_count": rpc_hist,
        "measured_rpc_s": sum(w.measured_seconds for w in wire_log),
        "modelled_rpc_s": sum(w.seconds for w in wire_log),
        "codec_launches": got,
    }, launches


class Child:
    """One launcher process: its stdout read line by line on a thread,
    so the script can wait, with a timeout, for a line it expects."""

    def __init__(self, name: str, argv: list, env: dict, stdin=None):
        self.name = name
        self.t0 = time.perf_counter()
        # argv: a module and its flags, or "-c", a body and its flags
        cmd = argv if argv[0] == "-c" else ["-m"] + argv
        self.proc = subprocess.Popen(
            [sys.executable] + cmd, env=env, text=True,
            stdin=stdin, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        self.lines: list[str] = []
        self._cv = threading.Condition()
        threading.Thread(target=self._read,
                                       daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            with self._cv:
                self.lines.append(line.rstrip("\n"))
                self._cv.notify_all()
        with self._cv:
            self.lines.append(None)
            self._cv.notify_all()

    def wait_line(self, prefix: str, timeout: float) -> str:
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                for ln in self.lines:
                    if ln is not None and ln.startswith(prefix):
                        return ln
                left = deadline - time.monotonic()
                if None in self.lines or left <= 0:
                    tail = "\n".join(str(x) for x in self.lines[-30:])
                    raise SmokeFailure(f"{self.name}: no {prefix!r} line "
                                       f"(exit {self.proc.poll()}):\n{tail}")
                self._cv.wait(min(left, 1.0))

    def finish(self, timeout: float) -> int:
        try:
            return self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(10)
            raise SmokeFailure(f"{self.name} did not exit within {timeout} s")


def tcp_process_phase(torch, np, dev: str = DEV,
                      scale: float = TCP_PROCESS_SCALE) -> dict:
    """14b: the deployment through the launchers, as processes: two
    embed servers, a coordinator, two workers of two clients each, the
    reddit preset at ``scale``, one round of one epoch, tracing
    on; then one obs_dump scrape of the five endpoints."""
    from repro_torch.exchange import wire
    from repro_torch.exchange.socket_transport import parse_address
    from repro_torch.launch import obs_dump

    src = pathlib.Path(__file__).resolve().parent / "src"
    env = {**os.environ, "PYTHONPATH": str(src),
           "REPRO_TRACE": "1"}
    out_dir = pathlib.Path(__file__).resolve().parent / "build"
    out_dir.mkdir(exist_ok=True)
    hist_path = out_dir / "tcp_history.json"
    children: list[Child] = []
    try:
        t0 = time.perf_counter()
        embeds = [Child(f"embed{i}", ["repro_torch.launch.embed_server",
                                      "--port", "0", "--device", dev],
                        env) for i in range(2)]
        children += embeds
        addrs, setup = [], {}
        for c in embeds:
            ln = c.wait_line("embed_server listening on", 120)
            addrs.append(ln.split()[3])
            setup[c.name] = time.perf_counter() - c.t0
        common = ["--graph", "reddit", "--scale", str(scale),
                  "--graph-seed", "0", "--clients", "4", "--strategy", "OPG",
                  "--set", "codec=int8", "--set", "score_kind=degree",
                  "--epochs", "1", "--rounds", "1",
                  "--device", dev] + sum((["--embed", a] for a in addrs), [])
        coord = Child("coordinator", ["repro_torch.launch.fed_coordinator",
                                      "--port", "0", "--timeout", "600",
                                      "--linger", "8", "--out",
                                      str(hist_path)] + common, env)
        children.append(coord)
        ln = coord.wait_line("fed_coordinator listening on", 300)
        caddr = ln.split()[3]
        setup["coordinator"] = float(ln.split("setup ")[1].split()[0])
        workers = [Child(f"worker{i}", ["repro_torch.launch.fed_worker",
                                        "--coordinator", caddr,
                                        "--client-ids", f"{2 * i},{2 * i + 1}",
                                        "--obs-port", "0",
                                        "--obs-linger", "120"] + common,
                         env, stdin=subprocess.PIPE) for i in range(2)]
        children += workers
        obs_addrs = []
        for w in workers:
            obs_addrs.append(w.wait_line("fed_worker telemetry on", 300)
                             .split()[3])
            ln = w.wait_line("fed_worker worker-", 300)
            setup[w.name] = float(ln.split("setup ")[1].split()[0])
        coord.wait_line("fed_coordinator DONE", 900)
        wires = {}
        for i, w in enumerate(workers):
            w.wait_line(f"fed_worker worker-{2 * i}-{2 * i + 1} DONE", 120)
            wires[w.name] = json.loads(w.wait_line(
                f"fed_worker worker-{2 * i}-{2 * i + 1} wire", 10)
                .split(" wire ", 1)[1])
        wall = time.perf_counter() - t0
        doc, table = obs_dump.dump(
            [("coordinator", caddr)]
            + [(f"embed{i}", a) for i, a in enumerate(addrs)]
            + [(f"worker{i}", a) for i, a in enumerate(obs_addrs)])
        # release everyone: workers on stdin's close, the servers by RPC
        for w in workers:
            w.proc.stdin.close()
        for a in addrs:
            with socket.create_connection(parse_address(a), timeout=10) as s:
                wire.send_frame(s, wire.build_shutdown())
                wire.parse_response(wire.recv_frame(s))
        codes = {c.name: c.finish(120) for c in children}
    finally:
        for c in children:
            if c.proc.poll() is None:
                c.proc.kill()
                c.proc.wait(10)
    check(all(v == 0 for v in codes.values()), f"14b: exit codes {codes}")
    history = json.loads(hist_path.read_text())
    check(len(history) == 1 and 0.0 <= history[0]["accuracy"] <= 1.0,
          f"14b: history {history}")
    records = {}
    for i, w in enumerate(workers):
        recs = [json.loads(ln) for ln in w.lines
                if ln and ln.startswith("{")]
        check(len(recs) == 1, f"14b: {w.name} printed {len(recs)} rounds")
        records[w.name] = recs[0]
    # the trace: five tracks, each with spans; seconds by span name
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    check(len(meta) == 5 and {e["pid"] for e in spans} ==
          {e["pid"] for e in meta}, "14b: obs_dump lacks a process's spans")
    by_name: dict = {}
    for e in spans:
        n, s_ = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, s_ + e["dur"] / 1e6)
    trace_path = out_dir / "tcp_trace.json"
    trace_path.write_text(json.dumps(doc))
    # each worker's scraped RPC histograms count its own ledger
    blocks = {b.split(" ", 1)[0]: b for b in table.split("# ")[1:]}
    for i, w in enumerate(workers):
        counted = sum(int(ln.split("count=")[1].split()[0])
                      for ln in blocks[f"worker{i}"].splitlines()
                      if ln.startswith("pt_exchange.latency_s."))
        logged = sum(o["rpcs"] for o in wires[w.name]["ops"].values())
        check(counted == logged, f"14b: {w.name} scraped {counted} RPCs, "
                                 f"its ledger {logged}")
    return {
        "scale": scale, "clients": 4, "rounds": 1, "epochs": 1,
        "setup_s": setup, "wall_s": wall,
        "round_wall_s": history[0]["wall_s"],
        "round_measured_s": history[0]["round_measured_s"],
        "round_modelled_s": history[0]["round_modelled_s"],
        "accuracy": history[0]["accuracy"],
        "phases": {w: r["phases"] for w, r in records.items()},
        "wire": wires,
        "spans": {k: {"count": n, "seconds": s_}
                  for k, (n, s_) in sorted(by_name.items())},
        "trace_file": "build/tcp_trace.json",
    }


# -- phase 15: the graph store ------------------------------------------------

def store_config(path, **kw):
    """Phases 15 and 16's RunConfig over the store at ``path``: 4 clients,
    OPG + int8 + degree scores, GraphConv L=3 hidden 32 (fanout 5, batch
    64: the RunConfig defaults), one round of one epoch."""
    from repro_torch.fedsvc.runtime import RunConfig

    return RunConfig(graph=f"store:{path}", num_clients=4, strategy="OPG",
                     overrides={"codec": "int8", "score_kind": "degree"},
                     epochs_per_round=1, rounds=1, seed=0, **kw)


#: ``python -c`` body that runs the ``gnn_serve`` launcher with every
#: sampler epoch cut to its first ``%d`` minibatches, as in the process
CUT_GNN_SERVE = (
    "import itertools, runpy, sys\n"
    "from repro_torch.graphs.sampler import NeighborSampler as S\n"
    "epoch = S.epoch\n"
    "S.epoch = lambda self: itertools.islice(epoch(self), %d)\n"
    "sys.argv[0] = 'gnn_serve'\n"
    "runpy.run_module('repro_torch.launch.gnn_serve', run_name='__main__')\n")


@contextlib.contextmanager
def cut_epochs(steps: int):
    """Within the block, every sampler epoch yields its first ``steps``
    minibatches (``CUT_GNN_SERVE`` does the same in a child)."""
    import itertools

    from repro_torch.graphs.sampler import NeighborSampler

    epoch = NeighborSampler.epoch
    NeighborSampler.epoch = \
        lambda self: itertools.islice(epoch(self), steps)
    try:
        yield
    finally:
        NeighborSampler.epoch = epoch


def tree_nbytes(root: pathlib.Path) -> int:
    return sum(p.stat().st_size for p in root.rglob("*") if p.is_file())


def store_phase(torch, np, dev: str = DEV, scale: float = STORE_SCALE,
                steps: int = STORE_STEPS) -> tuple[dict, dict, str, object]:
    """15: the reddit preset at ``scale`` built as an mmap store by the
    ``build_store`` launcher in a child process (LDG partition, P_4 shards
    for 4 clients), held byte for byte to ``make_graph`` and to
    ``make_client_shards`` over the same partition; then one round (each
    client's epoch cut to ``steps`` minibatches) of ``RunConfig(graph=
    "store:...")`` on the card, over the prebuilt mmap'd shards, against
    the in-memory trainer over the same partition (leaves, losses and
    accuracy bit-equal), and a shard-local trainer that mmaps only client
    1's shard.  Returns the measurements, the store-backed window's
    launches, the store's directory and the store-backed trainer."""
    import shutil

    from repro_torch.core.federated import FederatedGNNTrainer, assign_push_sets
    from repro_torch.graphs import (bfs_partition, edge_cut,
                                    make_client_shards, make_graph)
    from repro_torch.graphstore import ldg_partition, open_store
    from repro_torch.kernels import ops

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    root = pathlib.Path(__file__).resolve().parent
    out = root / "build" / f"store_reddit_{scale:g}"
    shutil.rmtree(out, ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    t0 = time.perf_counter()
    child = Child("build_store", ["repro_torch.launch.build_store", "--out",
                                  str(out), "--preset", "reddit", "--scale",
                                  str(scale), "--graph-seed", "0", "--seed",
                                  "0", "--clients", "4", "--retention", "4"],
                  env)
    code = child.finish(600)
    build_wall = time.perf_counter() - t0
    check(code == 0, "15: build_store exited %s:\n%s" % (
        code, "\n".join(str(x) for x in child.lines[-20:])))
    stats = json.loads([ln for ln in child.lines
                        if ln and ln.startswith("{")][-1])
    st = open_store(str(out))

    # the store: the in-memory generator's arrays, byte for byte
    t0 = time.perf_counter()
    g = make_graph("reddit", scale=scale, seed=0)
    make_s = time.perf_counter() - t0
    for f in ("indptr", "indices", "features", "labels", "train_mask"):
        a, b = getattr(st, f), getattr(g, f)
        check(a.dtype == b.dtype and a.shape == b.shape
              and np.array_equal(a, b), f"15: the store's {f} differs "
                                         "from make_graph's")
    check(st.num_classes == g.num_classes, "15: num_classes differs")
    part = st.load_partition(4, 0)
    t0 = time.perf_counter()
    check(part is not None and np.array_equal(
        part, ldg_partition(g, 4, seed=0)), "15: the baked partition is "
                                            "not LDG's")
    ldg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mem = make_client_shards(g, part, retention_limit=4, seed=0)
    assign_push_sets(mem, part)
    shard_mem_s = time.perf_counter() - t0
    fields = ("indptr", "indices", "global_ids", "features", "labels",
              "train_mask", "pull_nodes", "push_nodes", "all_pull_nodes")
    for sh in mem:
        baked = st.load_shard(sh.client_id, 4, 0, 4)
        for f in fields:
            check(np.array_equal(getattr(baked, f), getattr(sh, f)),
                  f"15: baked shard {sh.client_id} {f} differs from "
                  "make_client_shards'")
    del mem
    bfs = bfs_partition(g, 4, seed=0)
    cuts = {"ldg": edge_cut(g, part), "bfs": edge_cut(g, bfs)}

    # training off the store (prebuilt shards) against the in-memory graph
    cfg = store_config(out)
    runs, trainers = {}, {}
    ops.reset_launch_counts()
    sync()
    with cut_epochs(steps):
        for name in ("store", "memory"):
            t0 = time.perf_counter()
            if name == "store":
                tr = cfg.build_trainer(device=dev)
                check(tr._prebuilt_shards is not None and all(
                    isinstance(sh.features, np.memmap) for sh in tr.shards),
                    "15: the store trainer did not take the prebuilt shards")
            else:
                tr = FederatedGNNTrainer(g, 4, cfg.build_strategy(),
                                         part=part, epochs_per_round=1,
                                         seed=0, device=dev)
            sync()
            setup_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            s = tr.train(1)[0]
            sync()
            runs[name] = {"setup_s": setup_s,
                          "round_s": time.perf_counter() - t0,
                          "accuracy": s.accuracy, "loss": s.train_loss,
                          "leaves": tr.params_leaves()}
            if name == "store":
                launches = ops.launch_counts()
            trainers[name] = tr
    del trainers["memory"]
    a, b = runs["store"], runs["memory"]
    check(a["accuracy"] == b["accuracy"] and a["loss"] == b["loss"],
          f"15: store round {a['accuracy']}, {a['loss']} != in-memory "
          f"{b['accuracy']}, {b['loss']}")
    check(all(np.array_equal(x, y) for x, y in zip(a["leaves"], b["leaves"])),
          "15: the store trainer's leaves differ from the in-memory one's")
    check(0.0 <= a["accuracy"] <= 1.0 and np.isfinite(a["loss"]),
          f"15: accuracy {a['accuracy']}, loss {a['loss']}")
    if dev == "cuda":
        for name in TRAIN_KERNELS:
            check(launches.get(name, 0) > 0,
                  f"15: kernel {name} never launched off the store")

    # a shard-local worker: only client 1's shard, mmap'd
    t0 = time.perf_counter()
    local = cfg.build_trainer(only_clients=[1], device=dev)
    sync()
    local_setup = time.perf_counter() - t0
    check(local.shards[0] is None and local.samplers[0] is None
          and isinstance(local.shards[1].features, np.memmap)
          and local.eval_arrays is None, "15: the shard-local trainer "
                                         "holds more than its shard")
    for f in ("indptr", "indices", "global_ids", "pull_nodes"):
        check(np.array_equal(getattr(local.shards[1], f),
                             getattr(trainers["store"].shards[1], f)),
              f"15: the shard-local trainer's {f} differs")
    with cut_epochs(steps):
        local.pretrain_round()
        res = local.client_round(1)
    sync()
    check(np.isfinite(res.loss), f"15: shard-local loss {res.loss}")
    del local
    return {
        "scale": scale, "vertices": st.num_vertices, "edges": st.num_edges,
        "store_bytes": tree_nbytes(out),
        "graph_bytes": sum((out / f).stat().st_size for f in os.listdir(out)
                           if f.endswith(".npy")),
        "build_child_wall_s": build_wall, "build": stats,
        "make_graph_s": make_s, "ldg_s": ldg_s,
        "shards_in_memory_s": shard_mem_s,
        "edge_cut": cuts, "part_sizes": np.bincount(part).tolist(),
        "steps_per_client": steps,
        "setup_s": {"prebuilt_shards": a["setup_s"],
                    "in_memory": b["setup_s"],
                    "shard_local_client_1": local_setup},
        "round_s": {"store": a["round_s"], "in_memory": b["round_s"]},
        "accuracy": a["accuracy"], "loss": a["loss"],
        "shard_local_loss": res.loss,
    }, launches, str(out), trainers["store"]


# -- phase 16: serving over TCP -----------------------------------------------

SERVE_KW = dict(cache_rows=100_000, serve_fanout=10, batch_size=64,
                depth_schedule=[1, 3])


def serve_tcp_phase(torch, np, store: str, ref_trainer, dev: str = DEV,
                    per_client: int = SERVE_TCP_QUERIES,
                    steps: int = STORE_STEPS) -> tuple[dict, dict, dict]:
    """16: serving phase 15's store over TCP.  (b)'s processes start
    first, two ``embed_server`` launchers and then ``gnn_serve --graph
    store:...`` with their addresses (its epochs cut to ``steps``
    minibatches by ``CUT_GNN_SERVE``), and train while (a) runs: two port
    embed servers in threads, ``build_plane_from_cfg`` with their
    addresses (the plane's cache refreshes through PT_OP_VGATHER) behind
    ``serve_in_thread``, and four ``GnnServeClient`` threads sending
    ``per_client`` Zipf queries each (half at threshold 1.0) in RPCs of
    SERVE_TCP_RPC, held to phase 15's trainer (the same RunConfig and
    cut, in process) and its exported plane.  Then (b) gets the same
    queries and must give (a)'s answers, and every process must exit 0.
    Returns (a)'s measurements and launches (training and serving
    windows), and (b)'s measurements."""
    from repro_torch.exchange import wire
    from repro_torch.exchange.socket_transport import TcpTransport, parse_address
    from repro_torch.gnnserve import (GnnServeClient, build_serving,
                                      serve_in_thread)
    from repro_torch.kernels import ops
    from repro_torch.launch import embed_server, obs_dump
    from repro_torch.launch.gnn_serve import build_plane_from_cfg
    from repro_torch.obsv.metrics import REGISTRY

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    root = pathlib.Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    children: list[Child] = []
    servers: list = []
    try:
        t_b = time.perf_counter()
        embeds = [Child(f"embed{i}", ["repro_torch.launch.embed_server",
                                      "--port", "0", "--device", dev], env)
                  for i in range(2)]
        children += embeds
        addrs = [c.wait_line("embed_server listening on", 120).split()[3]
                 for c in embeds]
        serve = Child("gnn_serve", [
            "-c", CUT_GNN_SERVE % steps, "--port", "0", "--graph",
            f"store:{store}", "--clients", "4", "--strategy", "OPG", "--set",
            "codec=int8", "--set", "score_kind=degree", "--epochs", "1",
            "--rounds", "1", "--seed", "0", "--cache-rows", "100000",
            "--serve-fanout", "10", "--serve-batch", "64",
            "--depth-schedule", "1,3", "--device", dev]
            + sum((["--embed", a] for a in addrs), []), env)
        children.append(serve)

        # (a) in threads
        t0 = time.perf_counter()
        ref_plane = build_serving(ref_trainer.export_for_serving(),
                                  device=dev, **SERVE_KW)
        sync()
        ref_s = time.perf_counter() - t0
        servers = [embed_server.serve_in_thread(3, 32, device=dev)
                   for _ in range(2)]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with cut_epochs(steps):
            tr, plane = build_plane_from_cfg(
                store_config(store, embed_addrs=[f"{h.host}:{h.port}"
                                                 for h in servers]),
                quiet=True, device=dev, **SERVE_KW)
        sync()
        build_s = time.perf_counter() - t0
        train_launches = ops.launch_counts()
        check(isinstance(tr.exchange, TcpTransport),
              f"16a: the plane's transport is {type(tr.exchange).__name__}")
        check(all(np.array_equal(x, y) for x, y in
                  zip(tr.params_leaves(), ref_trainer.params_leaves())),
              "16a: training over TCP differs from phase 15's round")
        n = 4 * per_client
        vids, thrs = zipf_queries(np, len(plane.part), n, 21)
        before_samples = len(tr.exchange.rpc_samples)
        rpcs_before = REGISTRY.snapshot("pt_gnnserve.").get(
            "pt_gnnserve.predict_rpcs", 0)
        answers: dict = {}
        lat_ms: list = []
        lock = threading.Lock()
        ops.reset_launch_counts()
        with serve_in_thread(plane) as h:
            def client(i):
                lo = i * per_client
                with GnnServeClient(h.address) as cli:
                    for a in range(lo, lo + per_client, SERVE_TCP_RPC):
                        b = a + SERVE_TCP_RPC
                        t = time.perf_counter()
                        got = cli.predict(vids[a:b], thrs[a:b])
                        dt = (time.perf_counter() - t) * 1e3
                        with lock:
                            answers[a] = got
                            lat_ms.append(dt)
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(4)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
            wall = time.perf_counter() - t0
            sync()
            serve_launches = ops.launch_counts()
            check(not any(t.is_alive() for t in threads),
                  "16a: a client did not finish")
            with GnnServeClient(h.address) as cli:
                stats = cli.stats()
            doc, table = obs_dump.dump(
                [("serve", h.address)]
                + [(f"embed{i}", s.address) for i, s in enumerate(servers)])
        samples = list(tr.exchange.rpc_samples)[before_samples:]
        # offline_predict reads the embed servers too
        full = np.nonzero(thrs == 1.0)[0]
        offline = offline_ref(np, plane, vids[full])
        for s in servers:
            s.stop()
        servers = []

        # (b) the launchers, trained meanwhile: the same queries
        addr = serve.wait_line("gnn_serve listening on", 600).split()[3]
        ready_s = time.perf_counter() - t_b
        t0 = time.perf_counter()
        got_b = []
        with GnnServeClient(addr) as cli:
            for a in range(0, n, 256):
                got_b.append(cli.predict(vids[a:a + 256], thrs[a:a + 256]))
            stats_b = cli.stats()
        serve_b_s = time.perf_counter() - t0
        GnnServeClient(addr).shutdown()
        for a in addrs:
            with socket.create_connection(parse_address(a), timeout=10) as s:
                wire.send_frame(s, wire.build_shutdown())
                wire.parse_response(wire.recv_frame(s))
        codes = {c.name: c.finish(120) for c in children}
    finally:
        for s in servers:
            s.stop()
        for c in children:
            if c.proc.poll() is None:
                c.proc.kill()
                c.proc.wait(10)

    n_rpcs = n // SERVE_TCP_RPC
    check(sorted(answers) == list(range(0, n, SERVE_TCP_RPC))
          and all(len(x[0]) == SERVE_TCP_RPC for x in answers.values()),
          "16a: an RPC went unanswered or short")
    preds, confs, depths = (np.concatenate([answers[a][i]
                                            for a in sorted(answers)])
                            for i in range(3))
    # the same queries through phase 15's plane (same RunConfig, in process)
    rids = [ref_plane.submit(int(v), float(t)) for v, t in zip(vids, thrs)]
    done = {r.rid: r for r in ref_plane.drain()}
    check(sorted(done) == sorted(rids), "16a: the in-process plane lost "
                                        "requests")
    ref_pred = np.array([done[r].pred for r in rids], np.int32)
    ref_conf = np.array([done[r].conf for r in rids], np.float32)
    ref_depth = np.array([done[r].depth for r in rids], np.int32)
    check(np.array_equal(preds, ref_pred) and np.array_equal(depths, ref_depth)
          and np.array_equal(confs, ref_conf),
          "16a: answers over TCP differ from the in-process plane's "
          f"({int((preds != ref_pred).sum())} predictions, max |dconf| "
          f"{float(np.abs(confs - ref_conf).max())})")
    check(all(preds[i] == offline[int(vids[i])] for i in full),
          "16a: threshold-1.0 answers differ from offline_predict")
    check(stats["served"] == n, f"16a: SSTATS served {stats['served']}, "
                                f"{n} sent")
    got_rpcs = stats["metrics"].get("pt_gnnserve.predict_rpcs", 0) \
        - rpcs_before
    check(got_rpcs == n_rpcs and all(k.startswith("pt_gnnserve.")
                                     for k in stats["metrics"]),
          f"16a: SSTATS counts {got_rpcs} PREDICT RPCs, {n_rpcs} sent")
    blocks = {b.split(" ", 1)[0]: b for b in table.split("# ")[1:]}
    scraped = [float(ln.split()[1]) for ln in blocks["serve"].splitlines()
               if ln.startswith("pt_gnnserve.predict_rpcs ")]
    check(len(scraped) == 1 and scraped[0] - rpcs_before == n_rpcs,
          f"16a: the scrape counts {scraped} PREDICT RPCs, {n_rpcs} sent")
    vg = [r for r in samples if r.op == "vgather"]
    want = sum(r.layers for r in vg if r.n_rows)
    if dev == "cuda":
        got = {k: serve_launches.get(k, 0)
               for k in ("dequantize_int8", "gather_quantize")}
        check(got == {"dequantize_int8": want, "gather_quantize": want},
              f"16a: serving launched {got}; the VGATHER RPCs' non-empty "
              f"shard layers are {want}")
        check(serve_launches.get("gnn_aggregate", 0) > 0,
              "16a: the serving forward never aggregated on the card")

    # (b) the launchers' answers are (a)'s
    check(all(v == 0 for v in codes.values()), f"16b: exit codes {codes}")
    for mine, theirs in zip((preds, confs, depths),
                            (np.concatenate([x[i] for x in got_b])
                             for i in range(3))):
        check(np.array_equal(mine, theirs), "16b: the launcher's answers "
                                            "differ from 16a's")
    check(stats_b["served"] == n, f"16b: served {stats_b['served']}")
    last = [ln for ln in serve.lines if ln and ln.startswith("{")]
    check(bool(last) and json.loads(last[-1])["served"] == n,
          "16b: gnn_serve printed no stats line on exit")

    lat = np.array(lat_ms)
    launches = {k: train_launches.get(k, 0) + serve_launches.get(k, 0)
                for k in set(train_launches) | set(serve_launches)}
    return {
        "queries": n, "clients": 4, "rpc_size": SERVE_TCP_RPC,
        "rpcs": n_rpcs, "steps_per_client": steps,
        "reference_export_s": ref_s, "train_export_build_s": build_s,
        "serve_s": wall, "queries_per_s": n / wall,
        "rpc_latency_ms_p50": float(np.percentile(lat, 50)),
        "rpc_latency_ms_p99": float(np.percentile(lat, 99)),
        "vgather_rpcs": len(vg), "vgather_rows": sum(r.n_rows for r in vg),
        "vgather_measured_s": sum(r.measured_s for r in vg),
        "exits_by_depth": stats["exits_by_depth"],
        "cache_hit_rate": stats["cache_hit_rate"],
        "serve_launches": {k: v for k, v in serve_launches.items() if v},
    }, launches, {
        "queries": n, "rpc_size": 256,
        "ready_s_from_phase_start": ready_s, "serve_s": serve_b_s,
        "queries_per_s": n / serve_b_s,
        "trained_line": next((ln for ln in serve.lines
                              if ln and ln.startswith("trained")), None)}


# -- phase 17: graph growth ---------------------------------------------------

#: phase 17's growth schedule: 65,536 vertices at the end (half of them in
#: the base), four events before rounds 1-4, reddit's feature and class
#: widths
GROWTH_SCHEDULE = dict(scale=16, edge_factor=8, seed=0, base_frac=0.5,
                       num_events=4, start_round=1, every_rounds=1,
                       num_classes=41, feat_dim=96)


def growth_config(path, schedule, rounds: int, **over):
    """Phase 17's RunConfig over the base store at ``path``: 4 clients,
    OPG + int8 + degree scores (phase 15's strategy), GraphConv L=3
    hidden 32, one epoch a round, LDG admission with one restreaming pass
    an event, growing by ``schedule``."""
    from repro_torch.fedsvc.runtime import RunConfig

    return RunConfig(graph=f"store:{path}", num_clients=4, strategy="OPG",
                     overrides={"codec": "int8", "score_kind": "degree",
                                "restream_passes": 1, **over},
                     epochs_per_round=1, rounds=rounds, seed=0,
                     growth=schedule.to_dict())


def boundary_union(np, tr):
    """The union of the owned shards' pull and push sets."""
    return np.unique(np.concatenate(
        [np.zeros(0, np.int64)]
        + [a for ci in tr.owned
           for a in (tr.shards[ci].pull_nodes, tr.shards[ci].push_nodes)]))


def add_counts(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def growth_phase(torch, np, dev: str = DEV, sched_kw: dict = GROWTH_SCHEDULE,
                 steps: int = STORE_STEPS) -> tuple[dict, dict]:
    """17a: the schedule's base store, then one round on it and one round
    after each of its events (``RunConfig(growth=...)``, each client's
    epoch cut to ``steps`` minibatches), on the card.  After each event:
    the graph and partition have the frontier's size, the server holds
    exactly the union of every boundary set registered so far, and
    ``pt_dyngraph.boundary_registrations`` moved by the new rows counted
    here; the rounds after the last event launch rows 3 and 4 over the
    grown table; ``EmbeddingServer.push`` then ``pull`` of the last
    event's fresh rows returns what ``gather`` returns; and the final
    overlay compacts byte-equal to ``build_full``.  Returns the
    measurements and the launches of the training window."""
    import shutil

    from repro_torch.dyngraph import (GraphOverlay, GrowthSchedule, admit,
                                      compact, edge_cut_stream)
    from repro_torch.dyngraph import runtime as rt_mod
    from repro_torch.kernels import ops
    from repro_torch.obsv.metrics import REGISTRY

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    counter = "pt_dyngraph.boundary_registrations"

    def registrations():
        return REGISTRY.snapshot("pt_dyngraph.").get(counter, 0)

    sched = GrowthSchedule(**sched_kw)
    rounds = sched.num_events + 1
    root = pathlib.Path(__file__).resolve().parent / "build" / \
        f"growth_{sched.scale}"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    base = sched.build_base(str(root / "base"))
    base_s = time.perf_counter() - t0
    cfg = growth_config(root / "base", sched, rounds)

    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    tr = cfg.build_trainer(device=dev)
    sync()
    setup_s = time.perf_counter() - t0
    server = tr.exchange.server
    seen = boundary_union(np, tr)
    check(tr.g.num_vertices == sched.base_vertices and np.array_equal(
        np.nonzero(server._gid2row >= 0)[0], seen),
        "17a: the base trainer's registered rows are not its boundary sets")
    base_rows = len(seen)
    step_s: list = []
    step_args: list = []
    events, per_round = [], []
    cum = 0.0
    with cut_epochs(steps), timed(tr, "train_minibatches", step_s,
                                  step_args, sync=sync):
        tr.pretrain_round()
        for r in range(rounds):
            part_before = tr.part
            logs = {k: [] for k in ("apply", "restream", "cut", "shards",
                                    "register", "client_state", "eval")}
            before = registrations()
            reallocs = server._reallocs
            t0 = time.perf_counter()
            with timed(GraphOverlay, "apply", logs["apply"]), \
                    timed(rt_mod, "repartition", logs["restream"]), \
                    timed(rt_mod, "edge_cut_stream", logs["cut"]), \
                    timed(tr, "_build_shard_state", logs["shards"]), \
                    timed(tr, "_register_shard_nodes", logs["register"]), \
                    timed(tr, "_build_client_state", logs["client_state"],
                          sync=sync), \
                    timed(tr, "_build_eval_state", logs["eval"], sync=sync):
                jumped = tr.apply_growth(tr.growth.epoch_for_round(r), r)
            sync()
            grow_s = time.perf_counter() - t0
            check(jumped == (r >= sched.start_round),
                  f"17a: round {r} jumped {jumped}")
            if jumped:
                e = tr.growth.applied_epoch
                v = sched.frontier(e)
                check(tr.g.num_vertices == v and len(tr.part) == v,
                      f"17a: event {e}: {tr.g.num_vertices} vertices, "
                      f"partition of {len(tr.part)}, frontier {v}")
                now = boundary_union(np, tr)
                fresh = np.setdiff1d(now, seen)
                seen = np.union1d(seen, now)
                check(registrations() - before == len(fresh),
                      f"17a: event {e}: {counter} moved by "
                      f"{registrations() - before}, {len(fresh)} new rows")
                check(np.array_equal(np.nonzero(server._gid2row >= 0)[0],
                                     seen), f"17a: event {e}: the server's "
                      "rows are not the boundary sets registered so far")
                cfg_r = tr.growth.restream_cfg
                events.append({
                    "epoch": e, "vertices": v, "edges": tr.g.num_edges,
                    "apply_s": sum(logs["apply"]),
                    "restream_s": sum(logs["restream"]),
                    "edge_cut_s": sum(logs["cut"]),
                    "refresh_s": {k: sum(logs[k]) for k in
                                  ("shards", "register", "client_state",
                                   "eval")},
                    "grow_s": grow_s,
                    "fresh_registrations": len(fresh),
                    "reallocations": server._reallocs - reallocs,
                    "capacity_rows": server._cap,
                    "edge_cut_admit": edge_cut_stream(
                        tr.g, admit(tr.g, part_before, 4, cfg_r)),
                    "edge_cut_restream": edge_cut_stream(tr.g, tr.part),
                })
                print(f"17a event: {json.dumps(events[-1])}", flush=True)
                last_fresh = fresh
            n0 = len(step_s)
            counts0 = ops.launch_counts()
            t0 = time.perf_counter()
            s = tr.run_round(r, cum)
            sync()
            cum = s.cum_time
            n_steps = sum(len(a[3]) for a in step_args[n0:])
            moved = {k: v - counts0.get(k, 0)
                     for k, v in ops.launch_counts().items()}
            per_round.append({
                "round": r, "epoch": tr.growth.applied_epoch,
                "round_s": time.perf_counter() - t0, "steps": n_steps,
                "steps_per_s": n_steps / max(sum(step_s[n0:]), 1e-12),
                "accuracy": s.accuracy, "loss": s.train_loss,
                "pull_push_launches": {k: moved.get(k, 0) for k in
                                       ("gather_quantize",
                                        "dequant_scatter")}})
            check(np.isfinite(s.train_loss) and 0.0 <= s.accuracy <= 1.0,
                  f"17a: round {r}: accuracy {s.accuracy}, loss "
                  f"{s.train_loss}")
    launches = ops.launch_counts()
    check(tr.growth.applied_epoch == sched.num_events
          and tr.g.num_vertices == sched.num_vertices
          and len(tr.eval_gids) == sched.num_vertices,
          "17a: the run did not grow to the full graph")
    check(server._next_row == len(seen) > base_rows,
          f"17a: the table holds {server._next_row} rows, the boundary "
          f"sets {len(seen)} (base {base_rows})")
    if dev == "cuda":
        for name in TRAIN_KERNELS:
            check(launches.get(name, 0) > 0,
                  f"17a: kernel {name} never launched in the grown run")
        last = per_round[-1]["pull_push_launches"]
        check(all(n > 0 for n in last.values()),
              f"17a: rows 3 and 4 over the grown table: {last}")

    # EmbeddingServer.push then pull of the last event's fresh rows
    vals = [v + 1.0 for v in server.gather(last_fresh)]
    t_push = server.push(last_fresh, vals)
    got, t_pull = server.pull(last_fresh)
    again = server.gather(last_fresh)
    check(t_push > 0 and t_pull > 0 and server.log.rpcs == 2
          and all(torch.equal(a, b) and torch.equal(a, c)
                  for a, b, c in zip(got, again, vals)),
          "17a: push then pull of the fresh rows is not what gather reads")

    # the final overlay compacts to the from-scratch build
    t0 = time.perf_counter()
    compact(tr.g, str(root / "compacted"), name="dyn_full")
    compact_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sched.build_full(str(root / "full"))
    full_s = time.perf_counter() - t0
    for f in ("indptr", "indices", "features", "labels", "train_mask"):
        check((root / "compacted" / f"{f}.npy").read_bytes()
              == (root / "full" / f"{f}.npy").read_bytes(),
              f"17a: the compacted {f} differs from build_full's")
    out = {
        "schedule": sched.to_dict(), "base_vertices": base.num_vertices,
        "base_edges": base.num_edges, "base_build_s": base_s,
        "setup_s": setup_s, "steps_per_client": steps, "rounds": rounds,
        "events": events, "per_round": per_round,
        "base_rows": base_rows, "final_rows": int(server._next_row),
        "reallocations": server._reallocs,
        "steps_per_s_base": per_round[0]["steps_per_s"],
        "steps_per_s_grown": per_round[-1]["steps_per_s"],
        "compact_s": compact_s, "build_full_s": full_s,
        "final_vertices": tr.g.num_vertices, "final_edges": tr.g.num_edges,
        "fresh_push_pull_s": [t_push, t_pull],
    }
    del tr
    shutil.rmtree(root, ignore_errors=True)
    return out, launches


def growth_fedsvc_phase(torch, np, dev: str = DEV, scale: int = 12,
                        steps: int = STORE_STEPS) -> tuple[dict, dict]:
    """17b: phase 17's schedule at ``scale``, two port embed servers, a
    port coordinator with the growth barrier and two port workers of two
    clients each, in threads over loopback TCP: the accuracy history and
    leaves equal the port's in-process grown trainer's over 2 shards
    from the same RunConfig, bit for bit.  Returns the measurements and
    the deployment window's launches."""
    import shutil

    from repro_torch.dyngraph import GrowthSchedule
    from repro_torch.fedsvc.coordinator import serve_in_thread
    from repro_torch.fedsvc.runtime import make_coordinator_state
    from repro_torch.fedsvc.worker import FedWorker, run_in_thread
    from repro_torch.kernels import ops
    from repro_torch.launch import embed_server

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    sched = GrowthSchedule(**dict(GROWTH_SCHEDULE, scale=scale))
    rounds = sched.num_events + 1
    root = pathlib.Path(__file__).resolve().parent / "build" / \
        f"growth_fed_{scale}"
    shutil.rmtree(root, ignore_errors=True)
    sched.build_base(str(root / "base"))
    t0 = time.perf_counter()
    with cut_epochs(steps):
        ref = growth_config(root / "base", sched, rounds,
                            num_server_shards=2).build_trainer(device=dev)
        ref_stats = ref.train(rounds)
    sync()
    ref_s = time.perf_counter() - t0
    servers = [embed_server.serve_in_thread(3, 32, device=dev)
               for _ in range(2)]
    cfg = growth_config(root / "base", sched, rounds)
    cfg.embed_addrs = [f"{h.host}:{h.port}" for h in servers]
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state = make_coordinator_state(cfg, device=dev)
        with cut_epochs(steps), serve_in_thread(state) as coord:
            workers = [FedWorker(cfg, [2 * i, 2 * i + 1], coord.address,
                                 worker_id=f"w{i}", device=dev)
                       for i in range(2)]
            threads = [run_in_thread(w) for w in workers]
            check(coord.join(timeout=600), "17b: the coordinator never "
                                           "finished")
            for t in threads:
                t.join(60)
        sync()
        run_s = time.perf_counter() - t0
        launches = ops.launch_counts()
    finally:
        for h in servers:
            h.stop()
    check(all(not t.is_alive() for t in threads)
          and all(not w.dropped and not w.disconnected for w in workers),
          "17b: a worker did not finish")
    accs = [h["accuracy"] for h in state.history]
    check(accs == [s.accuracy for s in ref_stats],
          f"17b: accuracies {accs} != in-process "
          f"{[s.accuracy for s in ref_stats]}")
    leaf_err = max(float(np.abs(a - np.asarray(b)).max())
                   for a, b in zip(ref.params_leaves(), state.leaves))
    check(leaf_err == 0.0, f"17b: leaves differ from the in-process grown "
                           f"trainer's by {leaf_err}")
    for w in workers:
        check(w.trainer.growth.applied_epoch == sched.num_events
              and w.trainer.g.num_vertices == sched.num_vertices,
              f"17b: worker {w.worker_id} did not grow to the full graph")
    shutil.rmtree(root, ignore_errors=True)
    return {"scale": scale, "vertices": sched.num_vertices,
            "rounds": rounds, "reference_s": ref_s, "run_s": run_s,
            "accuracy": accs, "max_leaf_err": leaf_err,
            "round_wall_s": [h["wall_s"] for h in state.history]}, launches


# -- phase 18: the LM zoo -----------------------------------------------------

#: phase 18's architectures at published widths: arch id → the depth run
#: (None: the published depth).  Phi-3.5-MoE does not fit one card
#: (78 GiB of bf16 weights); deepseek keeps its dense head layer and two
#: MoE layers; the VLM one super-block (4 self-attention layers, the
#: cross layer and the tail).
ZOO = {"phi3.5-moe-42b-a6.6b": 2, "deepseek-v2-lite-16b": 3,
       "mamba2-1.3b": None, "hymba-1.5b": None,
       "llama-3.2-vision-11b": 5, "whisper-tiny": None}
ZOO_BATCH = 2                 # prefill: 2 prompts of 1024 tokens
ZOO_PROMPT = 1024
ZOO_WHISPER_PROMPT = 448      # whisper's decoder context
ZOO_LANES = 4                 # decode: 4 lanes, 1024 slots, 992 seen
ZOO_CAPACITY = 1024
ZOO_STEPS = 32
ZOO_BATCHER = ("mamba2-1.3b", "deepseek-v2-lite-16b")
ZOO_REQUESTS = 8              # batcher: 8 requests on the 4 lanes
ZOO_REQ_PROMPT = 8
ZOO_REQ_NEW = 8
ZOO_REF_STEPS = 8             # card vs CPU, fp32, 2 layers (VLM: 5)
#: rows of the report at the zoo's decode-attention shapes: (row, name,
#: batch, slots, kv heads, G, dh, window, cross-attention)
ZOO_SWA = (
    ("8M", "swa_attention_decode/mla", 4, 1024, 16, 1, 192, None, False),
    ("8H", "swa_attention_decode/hymba", 4, 1024, 5, 5, 64, 8192, False),
    ("8X", "swa_attention_decode/cross_vlm", 4, 1600, 8, 4, 128, None,
     True),
    ("8W", "swa_attention_decode/cross_whisper", 4, 1500, 6, 1, 64, None,
     True))


def zoo_config(arch: str, depth: int | None, dtype: str = "bfloat16"):
    """The published config in ``dtype``, cut to ``depth`` layers (the
    audio encoder too)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    over: dict = {"param_dtype": dtype}
    if depth is not None:
        over["num_layers"] = depth
        if cfg.family == "audio":
            over["encoder_layers"] = depth
    return dataclasses.replace(cfg, **over)


def zoo_attention_layers(cfg) -> int:
    """Decode-attention launches a decode step makes: the self-attention
    layers (MLA and hybrid included) plus the cross layers."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "vlm":        # inner self layers, the tail, the cross
        return cfg.num_layers // cfg.cross_attn_every \
            * (cfg.cross_attn_every + 1)
    if cfg.family == "audio":
        return 2 * cfg.num_layers
    return cfg.num_layers


def named_leaves(tree, name: str):
    """Every tensor stored under key ``name`` in a nested cache tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == name and not isinstance(v, (dict, list)):
                yield v
            else:
                yield from named_leaves(v, name)
    elif isinstance(tree, list):
        for v in tree:
            yield from named_leaves(v, name)


def fill_cache(torch, cache, seed: int) -> None:
    """Seeded normal values, drawn on the card, in every floating leaf of
    a cache tree: K/V, MLA latents, cross K/V, SSM state and windows."""
    gen = torch.Generator(device=DEV).manual_seed(seed)

    def fill(tree):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            if isinstance(v, (dict, list)):
                fill(v)
            elif v.is_floating_point():
                v.normal_(generator=gen)
    fill(cache)


@contextlib.contextmanager
def swa_launches_by_shape(tally: dict):
    """Within the block, each call of the decode attention's CUDA wrapper
    adds the change of the ``swa_attention_decode`` launch counter to
    ``tally[(T, Hkv, G, dh)]``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import swa_attention as swa_mod

    inner = swa_mod.swa_attention_decode

    def counted(q, k, *args, **kw):
        before = ops.launch_counts()["swa_attention_decode"]
        out = inner(q, k, *args, **kw)
        key = (k.shape[1], k.shape[2], q.shape[1] // k.shape[2], k.shape[3])
        tally[key] = (tally.get(key, 0)
                      + ops.launch_counts()["swa_attention_decode"] - before)
        return out
    swa_mod.swa_attention_decode = counted
    try:
        yield tally
    finally:
        swa_mod.swa_attention_decode = inner


def zoo_prefill(torch, cfg, params, card: str) -> dict:
    """18a: ``lm.forward`` over 2 prompts from ``synthetic_batches`` (with
    the VLM's vision and audio's frames inputs): the first call's
    seconds, then the forward's ms by CUDA events (mean of 2), prefill
    tokens/s, the peak memory and the device's idle share over one
    profiled forward; the logits must be finite."""
    from repro_torch.data import synthetic_batches
    from repro_torch.models import lm

    S = ZOO_WHISPER_PROMPT if cfg.family == "audio" else ZOO_PROMPT
    batch = next(synthetic_batches(cfg, batch=ZOO_BATCH, seq=S, seed=0,
                                   device=DEV))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, aux = lm.forward(params, cfg, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    check(tuple(logits.shape) == (ZOO_BATCH, S, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"18a {cfg.name}: prefill logits {tuple(logits.shape)} not finite "
          "or of the wrong shape")
    del logits
    ms = time_ms(torch, lambda: lm.forward(params, cfg, batch), iters=2,
                 warmup=0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    wall: list[float] = []

    def run():
        t1 = time.perf_counter()
        lm.forward(params, cfg, batch)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t1)
    evs = device_events(torch, run, sessions=2)
    busy = busy_share(evs, wall[-1])
    return {"batch": ZOO_BATCH, "prompt": S, "first_call_s": first_s,
            "forward_ms": ms,
            "prefill_tokens_per_s": ZOO_BATCH * S / ms * 1e3,
            "peak_mem_gb": peak, "aux": float(aux),
            "profiled_forward_s": wall[-1],
            "device_idle_share": busy["device_idle_share"],
            "top_device_ms": dict(list(busy["top_device_ms"].items())[:4]),
            "card": card}


def zoo_decode(torch, np, cfg, params, tally: dict, card: str
               ) -> tuple[dict, int]:
    """18b: 4 lanes, a cache of 1024 slots that has seen 992 tokens with
    every floating leaf filled from a seeded generator, then 32 greedy
    steps, each token read back as the launcher does; counters zeroed
    just before and read just after.  The decode attention must launch
    steps × (self-attention + cross layers) times, every ring advance one
    slot a step, every SSM state move."""
    from repro_torch.data import synthetic_request_stream
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    seen = ZOO_CAPACITY - ZOO_STEPS
    cache = lm.init_cache(cfg, ZOO_LANES, ZOO_CAPACITY, prefill_len=seen,
                          device=DEV)
    fill_cache(torch, cache, 1)
    states = [t.clone() for t in named_leaves(cache, "state")]
    serve_step = lm.make_serve_step(cfg)
    toks = torch.from_numpy(next(synthetic_request_stream(
        cfg, batch=ZOO_LANES, prompt_len=1, seed=0))).to(DEV)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    events = []
    t0 = time.perf_counter()
    with swa_launches_by_shape(tally):
        for _ in range(ZOO_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits, cache = serve_step(params, toks, cache)
            toks = torch.argmax(logits, dim=-1)
            end.record()
            toks[:, 0].cpu()                # the launcher reads each token
            events.append((start, end))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()["swa_attention_decode"]
    want = ZOO_STEPS * zoo_attention_layers(cfg)
    check(launches == want, f"18b {cfg.name}: swa_attention_decode launched "
                            f"{launches} times, expected {want}")
    check(bool(torch.isfinite(logits).all()),
          f"18b {cfg.name}: decode logits not finite")
    for t in named_leaves(cache, "length"):
        check(bool((t == seen + ZOO_STEPS).all()),
              f"18b {cfg.name}: a ring's length did not advance")
    for t in named_leaves(cache, "index"):
        check(bool((t == (seen + ZOO_STEPS) % ZOO_CAPACITY).all()),
              f"18b {cfg.name}: a ring's write slot did not advance")
    for a, b in zip(states, named_leaves(cache, "state")):
        check(bool((a != b).any()) and bool(torch.isfinite(b).all()),
              f"18b {cfg.name}: an SSM state did not move or is not finite")
    step_ms = [s.elapsed_time(e) for s, e in events]
    return {"lanes": ZOO_LANES, "capacity": ZOO_CAPACITY, "seen": seen,
            "steps": ZOO_STEPS, "wall_s": wall,
            "tokens_per_s": ZOO_STEPS * ZOO_LANES / wall,
            "step_ms": percentiles(np, step_ms),
            "swa_launches": launches,
            "ssm_states": len(states), "card": card}, launches


def zoo_batcher(torch, cfg, params, card: str) -> dict:
    """18c: ``ContinuousBatcher`` with 4 lanes serving 8 requests (lane
    resets: the SSM's windows and state, MLA's latent ring); each
    request must complete once with all its tokens, and the decode
    attention launch once a step for each attention layer."""
    from repro_torch.core.serving import ContinuousBatcher
    from repro_torch.data import synthetic_request_stream
    from repro_torch.kernels import ops

    bat = ContinuousBatcher(cfg, params, lanes=ZOO_LANES,
                            capacity=ZOO_REQ_PROMPT + ZOO_REQ_NEW,
                            device=DEV)
    prompts = next(synthetic_request_stream(
        cfg, batch=ZOO_REQUESTS, prompt_len=ZOO_REQ_PROMPT, seed=0))
    rids = [bat.submit(p, max_new=ZOO_REQ_NEW) for p in prompts]
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = bat.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = [r.rid for r in done]
    check(len(got) == len(set(got)) and sorted(got) == sorted(rids),
          f"18c {cfg.name}: {len(got)} completions for {len(rids)} requests")
    check(all(len(r.generated) == ZOO_REQ_NEW for r in done),
          f"18c {cfg.name}: a request did not get all its tokens")
    launches = ops.launch_counts()["swa_attention_decode"]
    check(launches == bat.steps * zoo_attention_layers(cfg),
          f"18c {cfg.name}: {launches} swa launches in {bat.steps} steps")
    return {"lanes": ZOO_LANES, "requests": len(done), "steps": bat.steps,
            "wall_s": wall, "generated_tokens_per_s":
            ZOO_REQUESTS * ZOO_REQ_NEW / wall, "swa_launches": launches,
            "card": card}


def zoo_reference(torch, arch: str, card: str) -> dict:
    """18d: the family at full width but 2 layers (the VLM one
    super-block), fp32 with TF32 off, from one set of parameters on the
    card and a CPU copy: the forward's logits over 2 prompts of 8 tokens,
    then 8 teacher-forced decode steps over a 16-slot ring that has seen
    12 tokens (every cache leaf filled from a seeded generator), each
    within 1e-3 of the largest logit of the CPU's."""
    from repro_torch.data import synthetic_batches
    from repro_torch.models import lm

    cfg = zoo_config(arch, 5 if arch == "llama-3.2-vision-11b" else 2,
                     "float32")
    t0 = time.perf_counter()
    params = lm.init_params(
        cfg, generator=torch.Generator(device=DEV).manual_seed(2), device=DEV)
    if cfg.family == "vlm":
        params["blocks"]["gate"] += 0.5     # tanh(0) hides the cross branch
    params_cpu = tree_to(params, "cpu")
    batch_cpu = next(synthetic_batches(cfg, batch=2, seq=ZOO_REF_STEPS,
                                       seed=2, device="cpu"))
    batch = tree_to(batch_cpu, DEV)

    def rel(card_logits, cpu_logits, what):
        r = max_err(card_logits.cpu(), cpu_logits) \
            / float(cpu_logits.abs().max())
        check(r <= 1e-3, f"18d {cfg.name}: {what} off by {r:.3g} of "
                         "max|logit|")
        return r
    worst = rel(lm.forward(params, cfg, batch)[0],
                lm.forward(params_cpu, cfg, batch_cpu)[0], "the forward")
    forward_err = worst
    cache = lm.init_cache(cfg, 2, 16, prefill_len=12, device=DEV)
    fill_cache(torch, cache, 3)
    cache_cpu = tree_to(cache, "cpu")
    for t in range(ZOO_REF_STEPS):
        tk = batch_cpu["tokens"][:, t: t + 1]
        lg, cache = lm.decode_step(params, cfg, tk.to(DEV), cache)
        lc, cache_cpu = lm.decode_step(params_cpu, cfg, tk, cache_cpu)
        worst = max(worst, rel(lg, lc, f"decode step {t}"))
    return {"arch": arch, "layers": cfg.num_layers,
            "forward_max_rel_err": forward_err, "max_rel_err": worst,
            "seconds": time.perf_counter() - t0, "card": card}


def zoo_swa_rows(torch, np, card: str) -> list[dict]:
    """18e: the decode attention at the zoo's new shapes (rows 8M, 8H, 8X,
    8W), each checked and timed by ``swa_case``: self-attention over a
    wrapped ring with the query at its head, cross-attention with every
    slot valid at position 0 and the query at 0."""
    report: list = []
    for row, name, B, T, Hkv, G, dh, window, cross in ZOO_SWA:
        args = swa_inputs(torch, np, B, T, Hkv, G, dh, T + dh,
                          torch.bfloat16, at_head=True)
        if cross:
            q, k, v = args[:3]
            args = (q, k, v,
                    torch.zeros((B, T), dtype=torch.int32, device=DEV),
                    torch.ones((B, T), dtype=torch.bool, device=DEV),
                    torch.zeros((B,), dtype=torch.int32, device=DEV))
        case = swa_case(torch, args, window)
        add_entry(report, name, "src/repro_torch/csrc/swa_decode.cu",
                  "src/repro/kernels/swa_attention.py:55", case["err"],
                  case["shape"], case["ms"], case["plain_ms"],
                  case["nbytes"], library_ms=case["library_ms"],
                  library_max_abs_err=case["library_max_abs_err"],
                  kept_slots=case["kept_slots"],
                  bf16_steps_off=case["bf16_steps_off"],
                  deterministic=True, device_ms=case["device_ms"],
                  row=row, window=window, cross=cross, card=card)
    return report


def zoo_phase(torch, np, card: str) -> tuple[dict, dict, list]:
    """18: the LM zoo's six new families at published widths in bf16
    (depths in ``ZOO``): for each, seeded parameters on the card, the
    prefill (18a) and the decode (18b), and the batcher for mamba2 and
    deepseek (18c); then each family in fp32 on the card against the CPU
    (18d) and the decode attention at the zoo's shapes (18e).  Returns
    the phase's summary, the decode's launches by report row (the four
    new rows' shapes counted apart, the rest under row 8) and the new
    rows."""
    from repro_torch.models import lm

    out: dict = {}
    tally: dict = {}
    total = 0
    for arch, depth in ZOO.items():
        t0 = time.perf_counter()
        cfg = zoo_config(arch, depth)
        params = lm.init_params(
            cfg, generator=torch.Generator(device=DEV).manual_seed(0),
            device=DEV)
        torch.cuda.synchronize()
        res = {"layers": cfg.num_layers, "params": lm.param_count(params),
               "init_s": time.perf_counter() - t0}
        res["prefill"] = zoo_prefill(torch, cfg, params, card)
        res["decode"], launches = zoo_decode(torch, np, cfg, params, tally,
                                             card)
        total += launches
        if arch in ZOO_BATCHER:
            res["batcher"] = zoo_batcher(torch, cfg, params, card)
        del params
        torch.cuda.empty_cache()
        res["seconds"] = time.perf_counter() - t0
        out[arch] = res
        print(f"18 {arch}: " + json.dumps(res), flush=True)
    check(sum(tally.values()) == total,
          f"18: the shape tally holds {sum(tally.values())} of {total} "
          "decode-attention launches")
    counts = {name: tally.get((T, Hkv, G, dh), 0)
              for _, name, _, T, Hkv, G, dh, _, _ in ZOO_SWA}
    counts["swa_attention_decode"] = total - sum(counts.values())
    refs = {}
    for arch in ZOO:
        refs[arch] = zoo_reference(torch, arch, card)
        print(f"18d {arch}: " + json.dumps(refs[arch]), flush=True)
        torch.cuda.empty_cache()
    out["reference"] = refs
    rows = zoo_swa_rows(torch, np, card)
    for row in rows:
        check(counts[row["name"]] > 0,
              f"18: no decode launch at {row['name']}'s shape on the path")
    return out, counts, rows


# -- phase 19: LM training -----------------------------------------------------

TRAIN_ARCH = "smollm-360m"    # 19a: published width and depth
TRAIN_SHAPE = "train_4k"      # 4096 tokens a sequence
TRAIN_BATCH = 4               # global batch (cut from train_4k's 256)
TRAIN_TIMED_STEPS = 3         # after one warm-up step
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (data sheet)
#: 19b: two more families at published width, cut in depth
TRAIN_CUT = {"deepseek-v2-lite-16b": 3, "mamba2-1.3b": 4}
TRAIN_CUT_SEQ = 1024
TRAIN_CUT_BATCH = 2
TRAIN_CUT_STEPS = 3
TRAIN_REF_TOL = 1e-4          # 19c: a gradient leaf, of its largest |g|
FED_SILOS = 2                 # 19e: smollm-360m, top-10 % stale deltas
FED_LOCAL_STEPS = 2
FED_SEQ = 1024
FED_BATCH = 2
FED_FRAC = 0.1
FED_ROUNDS = 2


def batch_loss(torch, cfg, params, batch) -> float:
    from repro_torch.models import lm

    with torch.no_grad():
        return float(lm.loss_fn(params, cfg, batch)[1]["loss"])


def train_smollm(torch, np, card: str):
    """19a: smollm-360m at published width and depth in bf16 with remat,
    train_4k's 4096-token sequences at a global batch of 4 in
    ``default_microbatches`` = 4 slices, ``make_optimizer``'s AdamW, from
    ``synthetic_batches(seed=0)``: one warm-up step, then
    TRAIN_TIMED_STEPS steps timed by CUDA events; tokens/s, MFU, peak
    memory, and the device's idle share and top kernels over one profiled
    microbatch.  Every loss must be finite, and the first batch's loss
    lower after the steps than before.  Returns the summary, the params
    and the optimizer state (19d saves them)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import synthetic_batches
    from repro_torch.launch.steps import default_microbatches, make_optimizer
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves

    cfg = get_config(TRAIN_ARCH)
    shape = SHAPES[TRAIN_SHAPE]
    check(cfg.remat and cfg.dtype == torch.bfloat16,
          "19a: smollm-360m should train in bf16 with remat")
    mb = default_microbatches(cfg, shape)
    opt = make_optimizer(cfg)
    check(mb == 4 and opt.name == "adamw(lr=0.0003)",
          f"19a: {mb} microbatches, {opt.name}")
    t0 = time.perf_counter()
    params = lm.init_params(
        cfg, generator=torch.Generator(device=DEV).manual_seed(0), device=DEV)
    state = opt.init(tree_leaves(params))
    gen = synthetic_batches(cfg, batch=TRAIN_BATCH, seq=shape.seq_len,
                            seed=0, device=DEV)
    batches = [next(gen) for _ in range(1 + TRAIN_TIMED_STEPS)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_before = batch_loss(torch, cfg, params, batches[0])
    loss_eval_s = time.perf_counter() - t0
    step = lm.make_train_step(cfg, opt, microbatches=mb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, state, m = step(params, state, batches[0])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    losses = [float(m["loss"])]
    step_ms = []
    for b in batches[1:]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, m = step(params, state, b)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(losses)), f"19a: a loss is not finite: {losses}")
    loss_after = batch_loss(torch, cfg, params, batches[0])
    check(loss_after < loss_before,
          f"19a: the first batch's loss went {loss_before} -> {loss_after}")

    N = lm.param_count(params)
    T = TRAIN_BATCH * shape.seq_len
    L, H, dh, S = (cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim,
                   shape.seq_len)
    flops = 6 * N * T + 12 * L * H * dh * S * T
    step_s = float(np.mean(step_ms)) / 1e3

    micro = {k: v[: TRAIN_BATCH // mb] for k, v in batches[1].items()}
    wall: list[float] = []

    def run():
        t1 = time.perf_counter()
        lm.loss_and_grads(params, cfg, micro)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t1)
    t0 = time.perf_counter()
    evs = device_events(torch, run, sessions=2)
    busy = busy_share(evs, wall[-1])
    profile_s = time.perf_counter() - t0
    res = {"arch": TRAIN_ARCH, "params": N, "layers": L, "seq": S,
           "global_batch": TRAIN_BATCH, "microbatches": mb,
           "optimizer": opt.name, "remat": cfg.remat, "init_s": init_s,
           "loss_eval_s": loss_eval_s, "warmup_step_s": warm_s,
           "step_ms": step_ms,
           "tokens_per_s": T / step_s, "model_flops_per_step": flops,
           "mfu": flops / step_s / PEAK_BF16_FLOPS,
           "mfu_formula": "(6*N*T + 12*L*H*dh*S*T) / step_s / 989e12, "
                          "N params, T tokens a step, no remat recompute",
           "peak_mem_gb": peak, "losses": losses,
           "first_batch_loss": [loss_before, loss_after],
           "profiled_microbatch_s": wall[-1], "profile_s": profile_s,
           "device_idle_share": busy["device_idle_share"],
           "top5_device_ms": dict(list(busy["top_device_ms"].items())[:5]),
           "card": card}
    return res, cfg, params, state


def train_cut(torch, np, card: str) -> dict:
    """19b: deepseek-v2-lite (MLA, the MoE dispatch and its aux loss in the
    backward) and mamba2-1.3b (the SSD scan's backward) at published
    width in bf16, cut in depth (``TRAIN_CUT``): TRAIN_CUT_STEPS AdamW
    steps of TRAIN_CUT_BATCH × TRAIN_CUT_SEQ tokens; finite losses and
    moved parameters."""
    from repro_torch.data import synthetic_batches
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves

    out = {}
    for arch, depth in TRAIN_CUT.items():
        t0 = time.perf_counter()
        cfg = zoo_config(arch, depth)
        params = lm.init_params(
            cfg, generator=torch.Generator(device=DEV).manual_seed(0),
            device=DEV)
        opt = make_optimizer(cfg)
        state = opt.init(tree_leaves(params))
        step = lm.make_train_step(cfg, opt)
        gen = synthetic_batches(cfg, batch=TRAIN_CUT_BATCH, seq=TRAIN_CUT_SEQ,
                                seed=0, device=DEV)
        batches = [next(gen) for _ in range(TRAIN_CUT_STEPS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        p, st, losses, aux = params, state, [], []
        for b in batches:
            p, st, m = step(p, st, b)
            losses.append(float(m["loss"]))
            aux.append(float(m["aux"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        check(all(np.isfinite(losses + aux)),
              f"19b {arch}: a loss is not finite: {losses} {aux}")
        check(any(not torch.equal(a, b) for a, b in zip(
            tree_leaves(params), tree_leaves(p))),
            f"19b {arch}: the parameters did not move")
        if cfg.num_experts:
            check(min(aux) > 0, f"19b {arch}: no MoE aux loss")
        out[arch] = {"layers": depth, "params": lm.param_count(params),
                     "steps": TRAIN_CUT_STEPS, "batch": TRAIN_CUT_BATCH,
                     "seq": TRAIN_CUT_SEQ, "losses": losses, "aux": aux,
                     "wall_s": wall, "tokens_per_s": TRAIN_CUT_STEPS
                     * TRAIN_CUT_BATCH * TRAIN_CUT_SEQ / wall,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                     "seconds": time.perf_counter() - t0, "card": card}
        del params, state, p, st
        torch.cuda.empty_cache()
    return out


def nondeterministic_ops(torch, run) -> list[str]:
    """The ops that ``torch.use_deterministic_algorithms`` names while
    ``run()`` runs (cuBLAS's workspace notice left out)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            run()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(" does not have")[0][:80]
                   for w in caught if "does not have a deterministic"
                   in str(w.message)})


def train_reference(torch, np, card: str) -> dict:
    """19c: every arch's reduced config in fp32 (TF32 off): the loss and
    each gradient leaf of one step on the card against the CPU from the
    same parameters and batch, each leaf within TRAIN_REF_TOL of its
    largest |g| on the CPU (floored at 1e-3 of the largest |g| of the
    whole gradient, for leaves that are zero in exact arithmetic); then
    the same step twice on the card, bit-equal or not, and where not the
    leaves that differ and the ops ``use_deterministic_algorithms``
    names."""
    from repro_torch.configs import get_reduced, list_archs
    from repro_torch.data import synthetic_batches
    from repro_torch.models import lm
    from repro_torch.tree import tree_paths

    out = {}
    for arch in list_archs():
        cfg = get_reduced(arch)
        S = cfg.ssm_chunk if cfg.family in ("ssm", "hybrid") else 8
        params = lm.init_params(cfg, generator=torch.Generator()
                                .manual_seed(0), device="cpu")
        if cfg.family == "vlm":
            params["blocks"]["gate"] += 0.5  # tanh(0) hides the cross branch
        batch = next(synthetic_batches(cfg, batch=2, seq=S, seed=0,
                                       device="cpu"))
        batch["labels"][0, :3] = -1
        p_dev, b_dev = tree_to(params, DEV), tree_to(batch, DEV)
        loss_c, _, g_c = lm.loss_and_grads(params, cfg, batch)
        loss_d, _, g_d = lm.loss_and_grads(p_dev, cfg, b_dev)
        loss_d2, _, g_d2 = lm.loss_and_grads(p_dev, cfg, b_dev)
        loss_err = abs(float(loss_d) - float(loss_c))
        check(loss_err <= 1e-5 * max(1.0, abs(float(loss_c))),
              f"19c {arch}: loss {float(loss_d)} on the card, "
              f"{float(loss_c)} on the CPU")
        floor = 1e-3 * max(float(g.abs().max()) for g in g_c)
        worst = 0.0
        for path, a, b in zip(tree_paths(params), g_d, g_c):
            r = max_err(a.cpu(), b) / max(float(b.abs().max()), floor)
            check(r <= TRAIN_REF_TOL, f"19c {arch}: gradient {path} off by "
                                      f"{r:.3g} of its largest |g|")
            worst = max(worst, r)
        same = [torch.equal(a, b) for a, b in zip(g_d, g_d2)]
        res = {"loss_abs_err": loss_err, "grad_max_rel_err": worst,
               "bit_equal_run_to_run": bool(torch.equal(loss_d, loss_d2)
                                            and all(same))}
        if not res["bit_equal_run_to_run"]:
            res["leaves_differing"] = [
                p for p, s in zip(tree_paths(params), same) if not s]
            res["nondeterministic_ops"] = nondeterministic_ops(
                torch, lambda: lm.loss_and_grads(p_dev, cfg, b_dev))
        out[arch] = res
    out["card"] = card
    return out


def checkpoint_round_trip(torch, params, state, card: str) -> dict:
    """19d: ``save_pytree`` of 19a's params and AdamW state (bf16 stored
    as fp32) to a directory under ``build/``, then ``load_pytree`` on the
    card: every leaf bit-equal, the paths in JAX's naming; seconds and
    GB/s each way; the directory is removed."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.tree import tree_leaves

    build = pathlib.Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="ckpt_", dir=build))
    try:
        tree = {"params": params, "opt": state}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_pytree(tmp / "smollm", tree, step=1 + TRAIN_TIMED_STEPS,
                    extra={"arch": TRAIN_ARCH})
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in tmp.iterdir())
        t0 = time.perf_counter()
        got, manifest = load_pytree(tmp / "smollm", tree, device=DEV)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        want = tree_leaves(tree)
        check(all(a.dtype == b.dtype and torch.equal(a, b)
                  for a, b in zip(want, tree_leaves(got))),
              "19d: a restored leaf differs")
        n = len(tree_leaves(params))
        paths = manifest["paths"]
        check(len(paths) == 3 * n + 1 and paths[0] == "opt/.mu/blocks/attn/wk"
              and paths[2 * n] == "opt/.count"
              and "opt/.nu/embed" in paths and paths[-1] == "params/final_norm"
              and paths[2 * n + 1] == "params/blocks/attn/wk",
              f"19d: paths not in JAX's naming: {paths[:3]} ...")
    finally:
        shutil.rmtree(tmp)
    return {"leaves": len(want), "bytes": nbytes, "save_s": save_s,
            "save_gb_per_s": nbytes / save_s / 1e9, "load_s": load_s,
            "load_gb_per_s": nbytes / load_s / 1e9, "card": card}


def fedopt_phase(torch, np, card: str) -> dict:
    """19e: ``FederatedLMTrainer`` on smollm-360m at published width (bf16,
    AdamW): FED_SILOS silos of FED_LOCAL_STEPS steps of FED_BATCH ×
    FED_SEQ tokens, top-10 % deltas with stale aggregation, FED_ROUNDS
    rounds.  Round 1 must leave the anchor bit-unchanged and round 2
    move it; the comm fraction is 0.1 and ``comm_bytes_per_round`` 10 %
    of the anchor's bytes.  Round seconds and the sparsifier's (a sort of
    each leaf's magnitudes)."""
    from repro_torch.configs import get_config
    from repro_torch.core import fedopt as fedopt_mod
    from repro_torch.data import synthetic_batches
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.tree import tree_leaves

    cfg = get_config(TRAIN_ARCH)
    fed = fedopt_mod.FedOptConfig(num_silos=FED_SILOS,
                                  local_steps=FED_LOCAL_STEPS,
                                  delta_topk_frac=FED_FRAC,
                                  stale_aggregation=True)
    t0 = time.perf_counter()
    tr = fedopt_mod.FederatedLMTrainer(
        cfg, make_optimizer(cfg), fed,
        generator=torch.Generator(device=DEV).manual_seed(0), device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    anchor_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(tr.anchor))
    rounds, sparsify_s = [], []
    for r in range(FED_ROUNDS):
        gens = [synthetic_batches(cfg, batch=FED_BATCH, seq=FED_SEQ,
                                  seed=10 * r + s, device=DEV)
                for s in range(FED_SILOS)]
        per = [[next(g) for _ in range(FED_LOCAL_STEPS)] for g in gens]
        batches = {k: torch.stack([torch.stack([b[k] for b in s])
                                   for s in per]) for k in per[0][0]}
        before = [t.clone() for t in tree_leaves(tr.anchor)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timed(fedopt_mod, "_topk_sparsify", sparsify_s,
                   sync=torch.cuda.synchronize):
            m = tr.round(batches)
        torch.cuda.synchronize()
        rounds.append({"seconds": time.perf_counter() - t0, **m})
        moved = [not torch.equal(a, b) for a, b in
                 zip(before, tree_leaves(tr.anchor))]
        check(np.isfinite(m["loss"]), f"19e: round {r + 1} loss {m['loss']}")
        check(abs(m["comm_fraction"] - FED_FRAC) < 1e-9,
              f"19e: comm fraction {m['comm_fraction']}")
        if r == 0:
            check(not any(moved), "19e: stale round 1 moved the anchor")
        else:
            check(any(moved), "19e: round 2 left the anchor as it was")
        del before
    kept = tr.pending_delta
    nnz = sum(int((t != 0).sum()) for t in tree_leaves(kept)
              if t.dim() > 0)
    total = sum(t.numel() for t in tree_leaves(kept) if t.dim() > 0)
    check(tr.comm_bytes_per_round() == int(anchor_bytes * FED_FRAC),
          f"19e: comm_bytes_per_round {tr.comm_bytes_per_round()} for "
          f"{anchor_bytes} anchor bytes")
    out = {"silos": FED_SILOS, "local_steps": FED_LOCAL_STEPS,
           "batch": FED_BATCH, "seq": FED_SEQ, "topk_frac": FED_FRAC,
           "stale": True, "init_s": init_s, "rounds": rounds,
           "sparsify_s": sparsify_s, "sparsified_values": total,
           "kept_share_of_last_delta": nnz / total,
           "comm_bytes_per_round": tr.comm_bytes_per_round(),
           "anchor_bytes": anchor_bytes, "card": card}
    del tr
    torch.cuda.empty_cache()
    return out


def lm_train_phase(torch, np, card: str) -> dict:
    """19: LM training: 19a smollm-360m train_4k, 19b deepseek and mamba2
    cut in depth, 19c card against CPU per reduced config, 19d the
    checkpoint of 19a's state, 19e fedopt.  The launch counters are
    zeroed just before and read just after: the path runs no kernel of
    the port (its attention is the blocked recurrence in plain PyTorch)."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    out: dict = {}
    t0 = time.perf_counter()
    out["19a"], cfg, params, state = train_smollm(torch, np, card)
    out["19a"]["phase_s"] = time.perf_counter() - t0
    print("19a: " + json.dumps(out["19a"]), flush=True)
    out["19d"] = checkpoint_round_trip(torch, params, state, card)
    print("19d: " + json.dumps(out["19d"]), flush=True)
    del params, state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["19b"] = train_cut(torch, np, card)
    print(f"19b ({time.perf_counter() - t0:.1f} s): "
          + json.dumps(out["19b"]), flush=True)
    t0 = time.perf_counter()
    out["19c"] = train_reference(torch, np, card)
    print(f"19c ({time.perf_counter() - t0:.1f} s): "
          + json.dumps(out["19c"]), flush=True)
    t0 = time.perf_counter()
    out["19e"] = fedopt_phase(torch, np, card)
    out["19e"]["phase_s"] = time.perf_counter() - t0
    print("19e: " + json.dumps(out["19e"]), flush=True)
    counts = ops.launch_counts()
    print("19 launches: " + json.dumps(counts), flush=True)
    check(not any(counts.values()),
          f"19: the training path launched a kernel of the port: {counts}")
    return out


# -- phase 20: the pod tooling ------------------------------------------------

POD_ARCH = "smollm-360m"      # full width and depth, bf16
POD_TRAIN = (2, 1024)         # 20a: one train step of 2 × 1024 tokens
POD_MICROBATCHES = 2
POD_PREFILL = (2, 1024)       # 20a: prefill of 2 × 1024 tokens
POD_LANES = 8                 # 20a: decode, 8 lanes × 8192 slots
POD_SLOTS = 8192
POD_STEPS = 32
POD_LR = 3e-4                 # make_optimizer's AdamW
#: 20c: fedrun cut from its defaults (4 local steps, batch 64, seq 1024)
POD_FED_ARGS = ("--local-steps", "1", "--batch", "32", "--seq", "256",
                "--topk", "0.1")
POD_TIMEOUT = 300             # seconds for each CLI process


def _full(t):
    """A DTensor's global value, a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _max_abs(torch, a, b) -> float:
    return float((_full(a).float() - _full(b).float()).abs().max())


def pod_cli_start(root: pathlib.Path) -> dict:
    """20b and 20c as processes of their own (each a fake world of 256 or
    512 CPU ranks; they never touch the card): ``repro_torch.launch.
    dryrun`` for smollm-360m decode_32k on each production mesh and
    ``repro_torch.launch.fedrun`` at :data:`POD_FED_ARGS`."""
    out_dir = root / "build" / "pod"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    cmds = {f"dryrun_{m}": ["-m", "repro_torch.launch.dryrun", "--arch",
                            POD_ARCH, "--shape", "decode_32k", "--mesh", m,
                            "--out", str(out_dir / f"dryrun_{m}.json")]
            for m in ("single", "multi")}
    cmds["fedrun"] = ["-m", "repro_torch.launch.fedrun", "--arch", POD_ARCH,
                      *POD_FED_ARGS, "--out", str(out_dir / "fedrun.json")]
    procs = {}
    for name, args in cmds.items():
        (out_dir / f"{name}.json").unlink(missing_ok=True)
        procs[name] = subprocess.Popen(
            [sys.executable, *args], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return {"procs": procs, "t0": time.perf_counter()}


def pod_cli_finish(started: dict) -> dict:
    """The records 20b and 20c printed as their last lines: each process
    must exit 0 with ``ok`` records, the fedrun's with FLOPs counted."""
    out = {}
    try:
        for name, proc in started["procs"].items():
            stdout, stderr = proc.communicate(timeout=POD_TIMEOUT)
            check(proc.returncode == 0,
                  f"20: {name} exited {proc.returncode}: {stderr[-2000:]}")
            rec = json.loads(stdout.strip().splitlines()[-1])
            out[name] = rec
    finally:
        for proc in started["procs"].values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for m in ("single", "multi"):
        rec = out[f"dryrun_{m}"]
        check(rec["ok"], f"20b: the dry-run on the {m} mesh failed: "
                         f"{rec.get('error')}")
        check(rec["devices"] == (256 if m == "single" else 512),
              f"20b: {rec['devices']} ranks on the {m} mesh")
        check(rec["census"]["flops"] > 0, f"20b: no FLOPs on the {m} mesh")
    check(out["fedrun"]["census_flops"] > 0
          and out["fedrun"]["collective_total"] > 0,
          "20c: the federated round counted no FLOPs or no collective")
    out["wall_s"] = time.perf_counter() - started["t0"]
    return out


def pod_host_phase(torch, np, card: str, cfg=None, dev: str = DEV,
                   sizes: dict | None = None) -> tuple[dict, int]:
    """20a: ``build_step`` on the host mesh, (data=1, model=1) over a
    world of one (NCCL on the card), for ``cfg`` (smollm-360m at full
    width and depth in bf16): one train step (AdamW, 2 microbatches with
    remat), a prefill and greedy decode steps over a seeded ring cache
    that has seen all but one slot, each beside the unsharded port on the
    same inputs on the card (max |Δ|; expected 0).  The decode
    attention's launches are counted over the sharded decode only.
    Returns (the record, those launches)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import synthetic_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_step, make_optimizer
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves

    sizes = sizes or {"train": POD_TRAIN, "prefill": POD_PREFILL,
                      "lanes": POD_LANES, "slots": POD_SLOTS,
                      "steps": POD_STEPS}
    cfg = cfg or get_config(POD_ARCH)
    t_phase = time.perf_counter()
    mesh = make_host_mesh(dev)
    out: dict = {"backend": dist.get_backend(), "mesh": str(mesh),
                 "arch": cfg.name, "card": card}
    try:
        params = lm.init_params(cfg, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)

        B, S = sizes["train"]
        t0 = time.perf_counter()
        train = build_step(cfg, InputShape("pod", "train", S, B), mesh,
                           microbatches=POD_MICROBATCHES)
        opt = make_optimizer(train.cfg)
        state = opt.init(tree_leaves(params))
        batch = next(synthetic_batches(train.cfg, batch=B, seq=S, seed=0,
                                       device=dev))
        p1, s1, m1 = train.run(params, state, batch)
        loss1 = float(_full(m1["loss"]))
        out["train_s"] = time.perf_counter() - t0
        p0, s0, m0 = lm.make_train_step(
            train.cfg, opt, microbatches=POD_MICROBATCHES)(params, state,
                                                           batch)
        loss0 = float(m0["loss"])
        errs = [_max_abs(torch, a, b) for a, b in
                zip(tree_leaves(p1), tree_leaves(p0))]
        scale = max(float(p.float().abs().max())
                    for p in tree_leaves(p0))
        out["train"] = {"loss": loss1, "loss_unsharded": loss0,
                        "params_max_abs_diff": max(errs),
                        "leaves_bit_equal": sum(e == 0 for e in errs),
                        "leaves": len(errs)}
        check(np.isfinite(loss1) and abs(loss1 - loss0)
              <= 1e-5 * max(1.0, abs(loss0)),
              f"20a: the sharded train step's loss {loss1} against {loss0}")
        # AdamW's first step moves an entry by about lr·sign(g): where the
        # card's backward adds in another order a gradient near zero may
        # flip, never more than 2·lr plus a bf16 step of the largest |p|
        check(max(errs) <= 2 * POD_LR + 2.0 ** -7 * scale,
              f"20a: sharded parameters off by {max(errs)}")
        del p1, s1, p0, s0, state

        B, S = sizes["prefill"]
        t0 = time.perf_counter()
        prefill = build_step(cfg, InputShape("pod", "prefill", S, B), mesh)
        fwd = {"tokens": next(synthetic_batches(
            prefill.cfg, batch=B, seq=S, seed=1, device=dev))["tokens"]}
        with torch.no_grad():
            l1 = prefill.run(params, fwd)
            out["prefill_s"] = time.perf_counter() - t0
            l0, _ = lm.forward(params, prefill.cfg, fwd)
        err = _max_abs(torch, l1, l0)
        top = float(l0.float().abs().max())
        out["prefill"] = {"logits_max_abs_diff": err, "max_abs_logit": top}
        check(bool(torch.isfinite(_full(l1)).all()) and err <= 1e-5 * top,
              f"20a: sharded prefill logits off by {err} (largest {top})")
        del l1, l0

        lanes, slots = sizes["lanes"], sizes["slots"]
        decode = build_step(cfg, InputShape("pod", "decode", slots, lanes),
                            mesh)
        c1 = lm.init_cache(decode.cfg, lanes, slots,
                           prefill_len=slots - 1, device=dev)
        gen = torch.Generator(device=dev).manual_seed(2)
        for leaf in tree_leaves(c1):
            if leaf.is_floating_point():
                leaf.normal_(generator=gen)
        c0 = tree_to(c1, dev)
        toks = [torch.randint(0, cfg.vocab_size, (lanes, 1), generator=gen,
                              device=dev, dtype=torch.int32)]
        errs, logits1 = [], []
        with torch.no_grad():
            t0 = time.perf_counter()
            ops.reset_launch_counts()
            for _ in range(sizes["steps"]):          # greedy, sharded
                lg, c1 = decode.run(params, toks[-1], c1)
                logits1.append(_full(lg))
                toks.append(logits1[-1].argmax(-1).to(torch.int32))
            if dev == "cuda":
                torch.cuda.synchronize()
            launches = ops.launch_counts()["swa_attention_decode"]
            out["decode_s"] = time.perf_counter() - t0
            for tok, lg1 in zip(toks, logits1):      # the same tokens
                lg0, c0 = lm.decode_step(params, decode.cfg, tok, c0)
                errs.append(_max_abs(torch, lg1, lg0))
        top = max(float(t.float().abs().max()) for t in logits1)
        out["decode"] = {"steps": sizes["steps"], "lanes": lanes,
                         "slots": slots, "logits_max_abs_diff": max(errs),
                         "max_abs_logit": top,
                         "swa_attention_decode_launches": launches}
        check(max(errs) <= 1e-5 * top,
              f"20a: sharded decode logits off by {max(errs)}")
        want = sizes["steps"] * cfg.num_layers if dev == "cuda" else 0
        check(launches == want, f"20a: the decode attention launched "
                                f"{launches} times, expected {want}")
    finally:
        dist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - t_phase
    return out, launches


def pod_phase(torch, np, card: str, root: pathlib.Path) -> tuple[dict, int]:
    """20: the pod tooling.  20b and 20c start as processes, 20a runs on
    the card meanwhile; then their records are read."""
    t0 = time.perf_counter()
    started = pod_cli_start(root)
    try:
        host, launches = pod_host_phase(torch, np, card)
    except BaseException:
        for proc in started["procs"].values():
            proc.kill()
            proc.wait()
        raise
    print("20a: " + json.dumps(host), flush=True)
    cli = pod_cli_finish(started)
    for name in ("dryrun_single", "dryrun_multi", "fedrun"):
        print(f"20{'c' if name == 'fedrun' else 'b'} {name}: "
              + json.dumps(cli[name]), flush=True)
    return {"20a": host, "20bc": cli,
            "phase_s": time.perf_counter() - t0}, launches


# -- phase 21: the port's lint and the four examples --------------------------

E2E_ROUNDS = 10               # train_federated_e2e_torch's (cut from 30)
#: the examples on the port and the arguments 21b gives each (none but
#: the rounds: their defaults, on the card)
EXAMPLES = (("quickstart_torch", []),
            ("train_federated_e2e_torch", ["--rounds", str(E2E_ROUNDS)]),
            ("serve_llm_torch", []),
            ("federated_llm_torch", []))
LINT_TIMEOUT = 300            # seconds for the lint's process


def lint_run(root: pathlib.Path) -> dict:
    """21a: ``python -m repro_torch.launch.lint --format json`` over the
    repo at ``root``; it must exit 0 with no findings."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.lint", "--format",
         "json"], cwd=root, env=env, capture_output=True, text=True,
        timeout=LINT_TIMEOUT)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"21a: the lint exited {proc.returncode}: {proc.stdout[-2000:]}"
          f"{proc.stderr[-2000:]}")
    out = json.loads(proc.stdout)
    check(out["findings"] == [], f"21a: lint findings {out['findings']}")
    return {"exit_code": proc.returncode, "findings": 0,
            "files_scanned": out["stats"]["files_scanned"],
            "pairs_verified": len(out["stats"]["pairs_verified"]),
            "seconds": seconds}


def load_example(root: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", root / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def finite(np, xs) -> bool:
    return bool(len(xs)) and bool(np.isfinite(np.asarray(xs)).all())


def example_summary(np, name: str, res) -> dict:
    """21b: what one example returned, checked: finite losses (and
    tokens/s) for every strategy, variant or architecture."""
    if name in ("quickstart_torch", "train_federated_e2e_torch"):
        want = ["D", "E", "OPP"] if name == "quickstart_torch" \
            else ["E", "OPG"]
        check(list(res) == want, f"21b: {name} ran {list(res)}")
        out = {}
        for strat, stats in res.items():
            losses = [s.train_loss for s in stats]
            check(finite(np, losses), f"21b: {name} {strat}: losses {losses}")
            out[strat] = {
                "rounds": len(stats),
                "peak_accuracy": max(s.accuracy for s in stats),
                "median_round_s": float(np.median(
                    [s.round_time for s in stats])),
                "final_loss": losses[-1]}
        return out
    if name == "serve_llm_torch":
        check(len(res) == 3 and finite(np, list(res.values()))
              and min(res.values()) > 0, f"21b: serve_llm tokens/s {res}")
        return {"tokens_per_s": res}
    check(list(res) == ["dense", "pruned", "stale"]
          and all(finite(np, v) for v in res.values()),
          f"21b: federated_llm losses {res}")
    return {"losses": res}


def examples_phase(torch, np, root: pathlib.Path) -> tuple[dict, dict]:
    """21b: each example's ``main`` on the card, in this process, the
    launch counters zeroed just before and read just after; returns (the
    record, the launches)."""
    from repro_torch.kernels import gnn_aggregate as agg_mod
    from repro_torch.kernels import ops

    out: dict = {}
    glue: list = []
    ops.reset_launch_counts()
    with timed(agg_mod, "csr_from_edges", glue), \
            timed(agg_mod, "transpose_csr", glue):
        for name, args in EXAMPLES:
            print(f"21b: {name} {' '.join(args)}", flush=True)
            t0 = time.perf_counter()
            res = load_example(root, name).main(list(args))
            torch.cuda.synchronize()
            out[name] = {"args": list(args),
                         "wall_s": time.perf_counter() - t0,
                         **example_summary(np, name, res)}
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    check(not glue, f"21b: the CSR glue ran {len(glue)} times")
    q = out["quickstart_torch"]
    out["paper_ordering"] = {
        "accuracy_D_below_E_and_OPP": q["D"]["peak_accuracy"]
        < min(q["E"]["peak_accuracy"], q["OPP"]["peak_accuracy"]),
        "accuracy_E_minus_OPP": q["E"]["peak_accuracy"]
        - q["OPP"]["peak_accuracy"],
        "round_OPP_faster_than_E": q["OPP"]["median_round_s"]
        < q["E"]["median_round_s"]}
    return out, counts


def lint_and_examples_phase(torch, np, root: pathlib.Path
                            ) -> tuple[dict, dict]:
    """21: the lint's process runs beside the examples."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        linted = pool.submit(lint_run, root)
        examples, counts = examples_phase(torch, np, root)
        lint = linted.result()
    return {"21a": lint, "21b": examples,
            "phase_s": time.perf_counter() - t0}, counts


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
    from repro_torch.kernels import gnn_aggregate as agg_mod

    t_all = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    # the nvcc processes run while the host builds the graph
    with ThreadPoolExecutor(1) as pool:
        build = pool.submit(_build.build_all)
        t0 = time.perf_counter()
        g = make_graph("reddit", scale=SCALE, seed=0)
        part = bfs_partition(g, 4, seed=0)
        shards = make_client_shards(g, part)
        graph_s = time.perf_counter() - t0
        build_s = build.result()
    print(f"build: {build_s:.2f} s (nvcc, one per source, in parallel, "
          "beside the graph's build)", flush=True)
    print(f"graph: reddit scale {SCALE}: {g.num_vertices} vertices, "
          f"{g.num_edges} edges, 4 shards, built on the host in "
          f"{graph_s:.1f} s; both done {time.perf_counter() - t0:.1f} s "
          "after the build started", flush=True)

    report = kernel_phase(torch, np, shards, g.num_vertices)
    reference_phase(torch, np)
    # the serving and training paths aggregate over the CSRs built on the
    # host with their blocks and shards: the card's glue never runs there
    glue: list = []
    with timed(agg_mod, "csr_from_edges", glue), \
            timed(agg_mod, "transpose_csr", glue):
        res = slice_phase(torch, np, g, part, shards)
        print("slice: " + json.dumps({k: v for k, v in res.items()
                                      if k != "launches"}), flush=True)
        train, train_counts, trainer, scores0 = train_slice_phase(
            torch, np, g, part)
        print("training slice: " + json.dumps(train), flush=True)
    check(not glue, f"the CSR glue ran {len(glue)} times on the serving and "
                    "training paths")
    print("serving and training paths: no CSR glue on the card", flush=True)
    rows, extra = train_kernel_phase(torch, np, trainer, scores0,
                                     train["gnn_aggregate_launches"])
    report += rows
    next(r for r in report if r["name"] == "gnn_aggregate").update(extra)
    pull_counts, rows = pull_aggregate_phase(torch, np, trainer)
    report += rows
    del trainer
    train_reference_phase(torch, np)
    t0 = time.perf_counter()
    with timed(agg_mod, "csr_from_edges", glue), \
            timed(agg_mod, "transpose_csr", glue):
        g_sh = make_graph("reddit", scale=SHARDED_SCALE, seed=0)
        sharded, sharded_counts, sharded_cases = sharded_train_phase(
            torch, np, g_sh, bfs_partition(g_sh, 4, seed=0))
        del g_sh
    check(not glue, f"the CSR glue ran {len(glue)} times on the sharded "
                    "training path")
    sharded["phase_s"] = time.perf_counter() - t0
    print("sharded training: " + json.dumps(sharded), flush=True)
    for name, key in (("gather_quantize", "pull_per_shard"),
                      ("dequant_scatter", "push_per_shard")):
        next(r for r in report if r["name"] == name)[key] = \
            sharded_cases[key]
    report += swa_kernel_phase(torch, np)
    lm_res, lm_counts, cfg, params = lm_decode_phase(torch, np)
    lm_batcher_phase(torch, np, cfg, params)
    del params
    lm_reference_phase(torch, np)
    t0 = time.perf_counter()
    tcp, tcp_counts = tcp_thread_phase(torch, np)
    weight = weight_wire_run(torch, np, DEV, TCP_WEIGHT_SCALE)
    for name, case in leaf_kernel_cases(torch, np, weight["largest_leaf"],
                                        weight["launches"]).items():
        next(r for r in report if r["name"] == name)["weight_leaf"] = case
    tcp["weight_wire"] = {k: v for k, v in weight.items()
                          if k != "launches"}
    tcp["phase_s"] = time.perf_counter() - t0
    print("tcp deployment in threads: " + json.dumps(tcp), flush=True)
    t0 = time.perf_counter()
    procs = tcp_process_phase(torch, np)
    procs["phase_s"] = time.perf_counter() - t0
    print("tcp deployment as processes: " + json.dumps(procs), flush=True)
    t0 = time.perf_counter()
    with timed(agg_mod, "csr_from_edges", glue), \
            timed(agg_mod, "transpose_csr", glue):
        store, store_counts, store_dir, store_tr = store_phase(torch, np)
    check(not glue, f"the CSR glue ran {len(glue)} times off the store")
    store["phase_s"] = time.perf_counter() - t0
    print("graph store: " + json.dumps(store), flush=True)
    t0 = time.perf_counter()
    serve_tcp, serve_tcp_counts, serve_procs = serve_tcp_phase(
        torch, np, store_dir, store_tr)
    del store_tr
    serve_tcp["in_process_slice"] = {
        k: res[k] for k in ("queries_per_s", "request_latency_ms_p50",
                            "request_latency_ms_p99")}
    serve_tcp["phase_s"] = time.perf_counter() - t0
    print("serving over tcp in threads: " + json.dumps(serve_tcp), flush=True)
    print("serving over tcp as processes: " + json.dumps(serve_procs),
          flush=True)
    t0 = time.perf_counter()
    with timed(agg_mod, "csr_from_edges", glue), \
            timed(agg_mod, "transpose_csr", glue):
        growth, growth_counts = growth_phase(torch, np)
        growth["phase_a_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        growth_fed, fed_counts = growth_fedsvc_phase(torch, np)
    check(not glue, f"the CSR glue ran {len(glue)} times on the growth path")
    growth_fed["phase_s"] = time.perf_counter() - t1
    growth_counts = add_counts(growth_counts, fed_counts)
    print("graph growth: " + json.dumps(growth), flush=True)
    print("graph growth under fedsvc in threads: " + json.dumps(growth_fed),
          flush=True)
    t0 = time.perf_counter()
    zoo, zoo_counts, rows = zoo_phase(torch, np, card)
    report += rows
    summary = {arch: {"prefill_tokens_per_s":
                      zoo[arch]["prefill"]["prefill_tokens_per_s"],
                      "decode_tokens_per_s":
                      zoo[arch]["decode"]["tokens_per_s"],
                      "card_vs_cpu": zoo["reference"][arch]["max_rel_err"]}
               for arch in ZOO}
    print(f"18: LM zoo in {time.perf_counter() - t0:.1f} s on {card}: "
          + json.dumps(summary), flush=True)
    t0 = time.perf_counter()
    trained = lm_train_phase(torch, np, card)
    summary = {"smollm_train_4k": {k: trained["19a"][k] for k in (
        "step_ms", "tokens_per_s", "mfu", "peak_mem_gb",
        "device_idle_share")},
        "cut": {a: r["tokens_per_s"] for a, r in trained["19b"].items()},
        "card_vs_cpu_grad_max_rel_err": max(
            r["grad_max_rel_err"] for a, r in trained["19c"].items()
            if a != "card"),
        "checkpoint_gb_per_s": [trained["19d"]["save_gb_per_s"],
                                trained["19d"]["load_gb_per_s"]],
        "fedopt_round_s": [r["seconds"] for r in trained["19e"]["rounds"]]}
    print(f"19: LM training in {time.perf_counter() - t0:.1f} s on {card}: "
          + json.dumps(summary), flush=True)
    pod, pod_launches = pod_phase(torch, np, card,
                                  pathlib.Path(__file__).resolve().parent)
    summary = {"20a": {k: pod["20a"][k] for k in (
        "train_s", "prefill_s", "decode_s", "phase_s")},
        "20a_max_abs_diff": {
            "train_params": pod["20a"]["train"]["params_max_abs_diff"],
            "prefill_logits": pod["20a"]["prefill"]["logits_max_abs_diff"],
            "decode_logits": pod["20a"]["decode"]["logits_max_abs_diff"]},
        "20b_trace_s": {m: pod["20bc"][f"dryrun_{m}"]["trace_s"]
                        for m in ("single", "multi")},
        "20c_trace_s": pod["20bc"]["fedrun"]["trace_s"],
        "cli_wall_s": pod["20bc"]["wall_s"]}
    print(f"20: pod tooling in {pod['phase_s']:.1f} s on {card}: "
          + json.dumps(summary), flush=True)
    tail, examples_counts = lint_and_examples_phase(
        torch, np, pathlib.Path(__file__).resolve().parent)
    print("21a: " + json.dumps(tail["21a"]), flush=True)
    print("21b: " + json.dumps(tail["21b"]), flush=True)
    summary = {"lint_s": tail["21a"]["seconds"],
               "files_scanned": tail["21a"]["files_scanned"],
               "examples_wall_s": {n: r["wall_s"] for n, r in
                                   tail["21b"].items() if "wall_s" in r}}
    print(f"21: lint and examples in {tail['phase_s']:.1f} s on {card}: "
          + json.dumps(summary), flush=True)
    for row in report:
        name = row["name"]
        row["launches_serve"] = res["launches"].get(name, 0)
        row["launches_train"] = train_counts.get(name, 0)
        row["launches_pull"] = pull_counts.get(name, 0)
        row["launches_lm"] = lm_counts.get(name, 0)
        row["launches_sharded"] = sharded_counts.get(name, 0)
        row["launches_tcp"] = tcp_counts.get(name, 0)
        row["launches_store"] = store_counts.get(name, 0)
        row["launches_serve_tcp"] = serve_tcp_counts.get(name, 0)
        row["launches_growth"] = growth_counts.get(name, 0)
        row["launches_zoo"] = zoo_counts.get(name, 0)
        row["launches_pod"] = pod_launches \
            if name == "swa_attention_decode" else 0
        row["launches_examples"] = examples_counts.get(name, 0)
        row["launches"] = (row["launches_serve"] + row["launches_train"]
                           + row["launches_pull"] + row["launches_lm"]
                           + row["launches_sharded"] + row["launches_tcp"]
                           + row["launches_store"]
                           + row["launches_serve_tcp"]
                           + row["launches_growth"] + row["launches_zoo"]
                           + row["launches_pod"]
                           + row["launches_examples"])
        check(row["launches"] > 0, f"kernel {name} never launched on a path")
    print_rows(report)
    print(f"launches: serve {json.dumps(res['launches'])} train "
          f"{json.dumps(train_counts)} pull {json.dumps(pull_counts)} lm "
          f"{json.dumps(lm_counts)} sharded {json.dumps(sharded_counts)} "
          f"tcp {json.dumps(tcp_counts)} store {json.dumps(store_counts)} "
          f"serve_tcp {json.dumps(serve_tcp_counts)} growth "
          f"{json.dumps(growth_counts)} zoo {json.dumps(zoo_counts)} pod "
          f"{json.dumps({'swa_attention_decode': pod_launches})} examples "
          f"{json.dumps(examples_counts)}", flush=True)
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
