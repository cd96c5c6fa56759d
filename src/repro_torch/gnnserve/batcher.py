"""Continuous batcher for GNN vertex queries (copy of
``repro/gnnserve/batcher.py``; its metrics carry the port's ``pt_``
prefix, its span the JAX name).

The GNN analog of ``core/serving.py``'s lane-based ContinuousBatcher:
queries arrive one at a time, the batcher coalesces them into
fixed-size forward batches, and — because serving is depth-escalating —
a "lane" here is a (request, pending depth) pair.  Each :meth:`step`
picks the depth with the most waiting requests and runs ONE forward for
up to ``batch_size`` of them: confident requests retire, the rest
re-queue at the next depth in the schedule.  Fresh arrivals therefore
mix freely with escalated survivors, exactly like new sequences joining
in-flight decodes in the LLM batcher.

No request is ever dropped or duplicated: a request id lives in exactly
one depth queue until a step returns its result and records it in
``completed`` (pinned by the JAX package's bursty-drain test and this
port's serving test); :meth:`QueryBatcher.pop_completed` drains that
record.
"""

from __future__ import annotations

import collections
import dataclasses
import time

from repro_torch.obsv.metrics import REGISTRY
from repro_torch.obsv.trace import TRACE

_SERVED = REGISTRY.counter("pt_gnnserve.served")
_QWAIT = REGISTRY.histogram("pt_gnnserve.queue_wait_s")
_OCCUPANCY = REGISTRY.histogram("pt_gnnserve.lane_occupancy",
                                lo=1.0, hi=4096.0, factor=2.0)


@dataclasses.dataclass
class ServedResult:
    rid: int
    vid: int
    pred: int
    conf: float
    depth: int          # depth the request exited at
    t_submit: float
    t_done: float

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit


class QueryBatcher:
    """Batches queries for ONE shard's engine (route per-shard queries
    here via :class:`repro_torch.gnnserve.engine.ServingPlane`)."""

    def __init__(self, engine):
        self.engine = engine
        self.batch_size = engine.batch_size
        # one FIFO per schedule depth; entries (rid, local_id, vid,
        # threshold, t_submit)
        self._queues = {d: collections.deque()
                        for d in engine.depth_schedule}
        self._next_rid = 0
        self.completed: dict[int, ServedResult] = {}
        self.served = 0
        self.exits_by_depth: dict[int, int] = {}

    def submit(self, vid: int, threshold: float = 1.0, *,
               rid: int | None = None) -> int:
        """Enqueue one query; returns its request id."""
        if rid is None:
            rid = self._next_rid
            self._next_rid = rid + 1
        lid = self.engine.local_id(vid)
        d0 = self.engine.depth_schedule[0]
        self._queues[d0].append((rid, lid, int(vid), float(threshold),
                                 time.perf_counter()))
        return rid

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def step(self) -> list[ServedResult]:
        """One fixed-size forward at the busiest depth.  Returns the
        requests that retired this step (confident, or at full depth)."""
        depth = max(self._queues, key=lambda d: len(self._queues[d]))
        q = self._queues[depth]
        if not q:
            return []
        # depth-lane occupancy at pick time: how full the chosen lane
        # was, and a live per-lane depth gauge for scrapes
        _OCCUPANCY.observe(len(q))
        for d, lane in self._queues.items():
            # bounded by model depth (≤ a handful of lanes)
            REGISTRY.gauge(f"pt_gnnserve.lane_depth.d{d}").set(len(lane))  # repro-lint: disable=TL001
        take = [q.popleft() for _ in range(min(self.batch_size, len(q)))]
        t_step = time.perf_counter()
        for t in take:
            _QWAIT.observe(t_step - t[4])     # submit → batch pick
        seeds = [t[1] for t in take]
        thrs = [t[3] for t in take]
        with TRACE.span("gnnserve.forward_batch",
                        args={"depth": depth, "n": len(take)}):
            preds, confs, depths = self.engine.predict_at_depth(
                seeds, thrs, depth)
        now = time.perf_counter()
        out = []
        sched = self.engine.depth_schedule
        for i, (rid, lid, vid, thr, t0) in enumerate(take):
            if depths[i] >= 0:       # retired at `depth`
                res = ServedResult(rid=rid, vid=vid, pred=int(preds[i]),
                                   conf=float(confs[i]), depth=depth,
                                   t_submit=t0, t_done=now)
                self.completed[rid] = res
                self.served += 1
                self.exits_by_depth[depth] = \
                    self.exits_by_depth.get(depth, 0) + 1
                _SERVED.inc()
                # bounded by model depth (≤ a handful of exit lanes)
                REGISTRY.counter(f"pt_gnnserve.exits.d{depth}").inc()  # repro-lint: disable=TL001
                out.append(res)
            else:                    # escalate to the next schedule depth
                nxt = sched[sched.index(depth) + 1]
                self._queues[nxt].append((rid, lid, vid, thr, t0))
        return out

    def run_to_completion(self) -> list[ServedResult]:
        """Step until no request is waiting; every retired result."""
        out = []
        while self.pending():
            out.extend(self.step())
        return out

    def pop_completed(self) -> list[ServedResult]:
        """The results retired since the last call, in retirement
        order."""
        out = list(self.completed.values())
        self.completed.clear()
        return out
