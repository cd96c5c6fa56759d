"""The reference's federated rounds.

:class:`Federation` replays what the configuration states from the
benchmark's inputs: the shards of the strategy, each client's sampler,
the §3.2.1 bootstrap push, and rounds in which every client pulls its
remote rows through the codec (the server is static within a round),
trains its cut epochs with Adam from the global model, computes its push
rows (after the last epoch, or after the one before it when the push
overlaps the last epoch, §4.2), after which the pushes are stored in
client order, the models averaged by train-vertex count and the average
evaluated.

``fault`` plants one of the run's faults in the reference for the
readings that set a limit's upper end: ``"frozen"`` (a step returns the
parameters unchanged), ``"half"`` (the loss over the first half of each
batch's seeds), ``"no_exchange"`` (pulls read zeros) or ``"answer"``
(every evaluated prediction moved to the next class).
"""

from __future__ import annotations

import numpy as np
import torch

from . import model as M
from .sampler import Sampler
from .shards import build_shards, eval_vertices, induced_edges


class Federation:
    def __init__(self, g: dict, part: np.ndarray, cfg: dict, strategy: dict,
                 init: list, seed: int, device, *,
                 prec: M.Precision = M.Precision(), fault: str | None = None):
        m = cfg["model"]
        self.L, self.hidden = m["num_layers"], m["hidden"]
        self.epochs = m["epochs_per_round"]
        self.opt = m["optimizer"]
        self.st = strategy
        self.prec, self.fault = prec, fault
        self.dev = torch.device(device)
        self.codec = M.Codec(strategy.get("codec", "fp32"))
        self.params = [t.detach().clone().to(self.dev) for t in init]
        self.shards = build_shards(g, part, strategy, seed)
        self.samplers = [Sampler(sh, m["fanout"], self.L, m["batch_size"],
                                 seed, cfg["minibatches_per_epoch"])
                         for sh in self.shards]
        self.dev_shards = [self._to_dev(sh) for sh in self.shards]
        self.table = [torch.zeros((len(part), self.hidden), device=self.dev)
                      for _ in range(self.L - 1)]
        self.evaluator = Evaluator(g, cfg, seed, device, prec=prec,
                                   fault=fault)

    def _to_dev(self, sh: dict) -> dict:
        deg = np.diff(sh["indptr"])
        return {"feats": torch.from_numpy(np.asarray(sh["features"],
                                                     np.float32)).to(self.dev),
                "labels": torch.from_numpy(sh["labels"].astype(np.int64)
                                           ).to(self.dev),
                "e_src": torch.from_numpy(sh["indices"]).to(self.dev),
                "e_dst": torch.from_numpy(np.repeat(
                    np.arange(sh["num_local"]), deg)).to(self.dev)}

    # -- the exchange -----------------------------------------------------

    def pull(self, ci: int) -> list[torch.Tensor]:
        """Client ``ci``'s remote rows h^1..h^{L-1} as they cross the
        wire (one zero row when it has none)."""
        sh = self.shards[ci]
        if not self.st["use_embeddings"] or len(sh["pull_nodes"]) == 0 \
                or self.fault == "no_exchange":
            n = max(1, len(sh["pull_nodes"]))
            return [torch.zeros((n, self.hidden), device=self.dev)
                    for _ in range(self.L - 1)]
        ids = torch.from_numpy(sh["pull_nodes"]).to(self.dev)
        return [self.codec.roundtrip(t[ids]) for t in self.table]

    def store(self, gids: np.ndarray, rows: list[torch.Tensor]) -> None:
        """The server keeps what it decodes of a push."""
        ids = torch.from_numpy(gids).to(self.dev)
        for t, r in zip(self.table, rows):
            t[ids] = self.codec.roundtrip(r)

    def _propagate(self, params, ci: int, caches):
        d, sh = self.dev_shards[ci], self.shards[ci]
        return M.propagate(params, self.L, d["feats"], d["e_src"],
                           d["e_dst"], sh["num_local"], caches, self.prec)

    def push_rows(self, params, ci: int, caches) -> list[torch.Tensor]:
        outs = self._propagate(params, ci, caches)
        rows = torch.from_numpy(self.shards[ci]["push_rows"]).to(self.dev)
        return [outs[l][rows] for l in range(self.L - 1)]

    def pretrain(self) -> None:
        """§3.2.1: push rows from the unexpanded local subgraphs."""
        if not self.st["use_embeddings"]:
            return
        for ci, sh in enumerate(self.shards):
            if len(sh["push_nodes"]):
                self.store(sh["push_nodes"], self.push_rows(self.params, ci,
                                                            None))

    # -- training ---------------------------------------------------------

    def loss(self, params, ci: int, mb, caches) -> torch.Tensor:
        layers, edges = mb
        d, sh = self.dev_shards[ci], self.shards[ci]
        h0 = M.input_features(d["feats"], layers[-1], sh["num_local"])
        logits = M.forward_blocks(params, self.L, layers, edges, h0, caches,
                                  sh["num_local"], self.prec)
        seeds = torch.from_numpy(layers[0]).to(self.dev)
        labels = d["labels"][seeds]
        if self.fault == "half":
            n = max(1, len(layers[0]) // 2)
            logits, labels = logits[:n], labels[:n]
        return M.nll(logits, labels)

    def client(self, ci: int, caches, rec: dict | None):
        """One client's local epochs from the global model: its trained
        leaves, its last loss and its push rows."""
        o = self.opt
        params = [p.clone().requires_grad_(True) for p in self.params]
        adam = M.Adam(params, o["lr"], o["b1"], o["b2"], o["eps"])
        batches = [self.samplers[ci].epoch() for _ in range(self.epochs)]
        overlap = self.st["use_embeddings"] and self.st.get("overlap_push") \
            and self.epochs >= 2
        push, last, step = None, None, 0
        for e, epoch in enumerate(batches, start=1):
            for mb in epoch:
                loss = self.loss(params, ci, mb, caches)
                grads = torch.autograd.grad(loss, params)
                step += 1
                if self.fault != "frozen":
                    new = adam.step(params, grads)
                    params = [p.detach().requires_grad_(True) for p in new]
                last = loss.detach()
                if rec is not None and step <= 3:
                    rec["loss"].append(float(last))
                    if step == 1:
                        rec["grad_norms"] = [float(torch.linalg.vector_norm(g))
                                             for g in grads]
                    if step == 3:
                        rec["step3_norms"] = [
                            float(torch.linalg.vector_norm(p.detach() - p0))
                            for p, p0 in zip(params, self.params)]
            if overlap and e == self.epochs - 1:
                push = self.push_rows([p.detach() for p in params], ci, caches)
        params = [p.detach() for p in params]
        if self.st["use_embeddings"] and not overlap:
            push = self.push_rows(params, ci, caches)
        return params, float(last), push

    def round(self, rec: dict | None = None) -> dict:
        """One federated round; with ``rec``, client 0's first three
        steps are recorded into it."""
        caches = [self.pull(ci) for ci in range(len(self.shards))]
        results = [self.client(ci, caches[ci], rec if ci == 0 else None)
                   for ci in range(len(self.shards))]
        for ci, (_, _, push) in enumerate(results):
            if push is not None and len(self.shards[ci]["push_nodes"]):
                self.store(self.shards[ci]["push_nodes"], push)
        weights = [float(sh["train_mask"].sum()) for sh in self.shards]
        start = self.params
        self.params = M.fedavg([r[0] for r in results], weights)
        out = {"acc": self.evaluate(),
               "round_norms": [float(torch.linalg.vector_norm(p - p0))
                               for p, p0 in zip(self.params, start)]}
        if self.st["use_embeddings"]:
            out["table"] = self.table_rows()
        return out

    def first_round(self) -> dict:
        """The bootstrap and the first round with its records."""
        self.pretrain()
        rec = {"loss": []}
        rec.update(self.round(rec))
        return rec

    def table_rows(self) -> list[np.ndarray]:
        """The server's rows of every pushed vertex, ascending."""
        gids = np.unique(np.concatenate([sh["push_nodes"]
                                         for sh in self.shards]))
        ids = torch.from_numpy(gids).to(self.dev)
        return [t[ids].cpu().numpy() for t in self.table]

    def evaluate(self, params: list | None = None) -> float:
        """The test accuracy of ``params`` (default the global model)."""
        return self.evaluator(self.params if params is None else params)


class Evaluator:
    """The trainer's evaluation: the test accuracy of a model's full
    propagation over the evaluation subgraph (the whole graph, or a
    seeded vertex sample whose in-edges fit ``eval_max_edges``)."""

    def __init__(self, g: dict, cfg: dict, seed: int, device, *,
                 prec: M.Precision = M.Precision(), fault: str | None = None):
        self.L = cfg["model"]["num_layers"]
        self.prec, self.fault = prec, fault
        self.dev = torch.device(device)
        sel = eval_vertices(g, cfg["model"]["eval_max_edges"], seed)
        es, ed = induced_edges(g, sel)
        self.feats = torch.from_numpy(g["features"][sel]).to(self.dev)
        self.e_src = torch.from_numpy(es).to(self.dev)
        self.e_dst = torch.from_numpy(ed).to(self.dev)
        self.n, self.labels = len(sel), g["labels"][sel]
        self.test = np.nonzero(~g["train_mask"][sel])[0]

    def __call__(self, params: list) -> float:
        params = [p.detach().to(self.dev) for p in params]
        outs = M.propagate(params, self.L, self.feats, self.e_src,
                           self.e_dst, self.n, None, self.prec)
        pred = torch.argmax(outs[-1], dim=-1).cpu().numpy()
        if self.fault == "answer":
            pred = (pred + 1) % outs[-1].shape[1]
        t = self.test
        return float((pred[t] == self.labels[t]).mean())
