"""Batched serving runtime: continuous batching over the zoo's decode step.

Counterpart of ``repro/core/serving.py``.  A fixed number of *lanes* (the
decode batch) each carry one in-flight request; every :meth:`step` runs
one decode for the whole batch, finished lanes retire at once and the
next queued request takes the lane.  The lane's cache is reset by its
ring-buffer bookkeeping (validity, write index, length), so there is no
idle bubble waiting for the longest request.

The port resets lanes and writes cache slots **in place** (the JAX
package builds a new cache tree each time).  Only attention caches are
ported: an SSM cache key raises ``NotImplementedError``.  As in the JAX
package, each step reads the batch's argmax back to the host once.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm

_SSM_KEYS = ("state", "conv_x", "conv_BC")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (L,) token ids
    max_new: int
    generated: list[int] = dataclasses.field(default_factory=list)
    pos: int = 0                # tokens consumed from the prompt

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new


def _reset_lane(cache, lane: int):
    """Zero one lane's bookkeeping in a cache tree, in place; returns the
    tree.  Leading layer-stack dims broadcast; the lane is the last axis
    of ``index`` / ``length`` and the one before the slots of ``valid``."""
    if isinstance(cache, dict):
        for name, leaf in cache.items():
            if name in _SSM_KEYS:
                raise NotImplementedError(
                    "SSM caches are not ported yet (ROADMAP Queue A item 4)")
            if name in ("index", "length"):
                leaf[..., lane] = 0
            elif name == "valid":
                leaf[..., lane, :] = False
            elif isinstance(leaf, (dict, list)):
                _reset_lane(leaf, lane)
    elif isinstance(cache, list):
        for sub in cache:
            _reset_lane(sub, lane)
    return cache


class ContinuousBatcher:
    def __init__(self, cfg: ModelConfig, params, *, lanes: int,
                 capacity: int, device: str = "cuda"):
        self.cfg = cfg
        self.params = params
        self.lanes = lanes
        self.capacity = capacity
        self.device = torch.device(device)
        self.cache = lm.init_cache(cfg, lanes, capacity, device=device)
        self._decode = lm.make_serve_step(cfg)
        self.queue: deque[Request] = deque()
        self.active: list[Optional[Request]] = [None] * lanes
        self._next_rid = 0
        self.completed: list[Request] = []
        self.steps = 0

    # -- API -------------------------------------------------------------

    def submit(self, prompt: np.ndarray, *, max_new: int) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, np.asarray(prompt, np.int64),
                                  max_new))
        return rid

    def _fill_lanes(self):
        for lane in range(self.lanes):
            if self.active[lane] is None and self.queue:
                self.active[lane] = self.queue.popleft()
                self.cache = _reset_lane(self.cache, lane)

    def step(self) -> list[tuple[int, int]]:
        """One decode tick.  Returns [(rid, emitted_token)] for lanes that
        produced a generation token this tick."""
        self._fill_lanes()
        if not any(self.active):
            return []
        toks = np.zeros((self.lanes, 1), np.int64)
        for lane, req in enumerate(self.active):
            if req is None:
                continue
            if req.pos < len(req.prompt):
                toks[lane, 0] = req.prompt[req.pos]           # teacher-force
            else:
                toks[lane, 0] = req.generated[-1] if req.generated else 0
        logits, self.cache = self._decode(
            self.params, torch.from_numpy(toks).to(self.device), self.cache)
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        out = []
        self.steps += 1
        for lane, req in enumerate(self.active):
            if req is None:
                continue
            if req.pos < len(req.prompt):
                req.pos += 1
                if req.pos == len(req.prompt):
                    req.generated.append(int(nxt[lane]))
                    out.append((req.rid, int(nxt[lane])))
            else:
                req.generated.append(int(nxt[lane]))
                out.append((req.rid, int(nxt[lane])))
            if req.done:
                self.completed.append(req)
                self.active[lane] = None
        return out

    def run_to_completion(self, *, max_steps: int = 100_000
                          ) -> list[Request]:
        while (any(self.active) or self.queue) and self.steps < max_steps:
            self.step()
        return self.completed
