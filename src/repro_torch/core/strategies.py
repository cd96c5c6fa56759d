"""Declarative strategy configurations (paper §5.2 notation).

Copy of ``repro/core/strategies.py``.  The port's trainer runs the
in-process knobs, one embedding server or sharded, and refuses
``transport="tcp"`` (see
:class:`repro_torch.core.federated.FederatedGNNTrainer`).

D    — default federated GNN, no embedding exchange (P_0).
E    — EmbC baseline: full expansion, blocking pull/push each round.
O    — E + push overlap (§4.2).
P    — E + uniform random pruning with retention limit (§4.1.1).
OP   — O + P.
OPP  — OP + scored pull pre-fetch (§4.3).
OPG  — OP + score-based graph pruning to top-f% (§4.1.2).

All knobs are explicit so ablations (P_i sweeps, Tf sweeps, R25/B25/D25)
are just constructor calls.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Strategy:
    name: str
    use_embeddings: bool = True            # False ⇒ default federated GNN
    overlap_push: bool = False             # §4.2
    retention_limit: Optional[int] = None  # §4.1.1 P_i; None = P_inf
    scored_prune_frac: Optional[float] = None  # §4.1.2 top-f%; None = off
    prefetch_frac: Optional[float] = None  # §4.3 x%; None = pull-all upfront
    score_kind: str = "frequency"          # frequency | degree | bridge
    random_subset: bool = False            # R25-style ablation selector
    # Measured contention: concurrent push slows the final epoch (paper
    # reports +14–32%, Papers +80s).  Applied when overlap_push is on.
    overlap_interference: float = 1.18
    # -- exchange subsystem (repro.exchange) --------------------------------
    codec: str = "fp32"                    # wire codec: fp32 | fp16 | int8
    delta_threshold: Optional[float] = None  # τ delta pushes; None = full
    num_server_shards: int = 1             # hashed embedding-server shards
    # transport kind: auto | inprocess | sharded | tcp.  "auto" infers
    # from num_server_shards / the trainer's transport_addrs; "tcp"
    # needs live embed_server listeners (repro.launch.embed_server) and
    # the trainer's transport_addrs pointing at them.
    transport: str = "auto"
    # -- embedding-shard placement (ShardedTransport) ------------------------
    # hash — static gid % S (historical).  pull_frequency — after round
    # `rebalance_round` the transport re-places rows by observed per-gid
    # pull counts (greedy LPT onto the least-loaded shard), falling back
    # to hash placement for unseen ids or when no pulls were logged.
    shard_placement: str = "hash"
    rebalance_round: int = 1
    # EF-SGD style error feedback: accumulate the codec quantization
    # residual client-side and fold it into the next push, so lossy
    # codecs (fp16/int8) stop biasing converged embeddings.
    error_feedback: bool = False
    # -- adaptive τ (delta_threshold schedule) ------------------------------
    # constant — τ fixed at delta_threshold every round (historical)
    # linear   — τ ramps 0 → delta_threshold over delta_rounds rounds
    #            (push everything early, when embeddings move fast)
    # plateau  — τ = 0 until the best accuracy stops improving by more
    #            than plateau_eps over plateau_window rounds, then
    #            delta_threshold
    delta_schedule: str = "constant"
    delta_rounds: int = 10
    plateau_window: int = 3
    plateau_eps: float = 2e-3
    # -- control plane (repro.fedsvc) ---------------------------------------
    # aggregation: sync — barriered FedAvg, bit-compatible with the
    # in-process run_round; async — FedBuff-style buffered aggregation:
    # the coordinator folds every `buffer_size` client deltas into the
    # global model, each scaled by staleness_decay ** staleness.
    aggregation: str = "sync"
    buffer_size: int = 2
    staleness_decay: float = 0.5
    # -- weight-wire compression (coordinator ↔ worker model exchange) ------
    # None — raw fp32 full leaves both directions (bit-compatible with
    # the in-process trainer).  "fp32" | "fp16" | "int8" — the exchange
    # codec stack applied to the *weight* plane: worker→coordinator
    # updates ship codec-encoded deltas (local − base) with per-client
    # error-feedback residual carry, and coordinator→worker get_model
    # serves version-diff deltas against the worker's last-served view
    # (full model only on first fetch / re-join).
    weight_codec: Optional[str] = None
    weight_error_feedback: bool = True     # EF on the weight deltas
    # -- coordinator-driven client sampling (sync rounds) -------------------
    # FedBuff-style per-round participation: each sync round the
    # coordinator samples ceil(sample_frac·K) clients (min 1) and the
    # pull barrier + FedAvg trigger consider only the sampled subset;
    # unsampled workers skip straight to the next round's get_model.
    # None — every client participates every round (historical).
    sample_frac: Optional[float] = None
    # -- dynamic graphs (repro.dyngraph) ------------------------------------
    # restream: scoring used when growth events admit new vertices into
    # the existing partition — "ldg" (capacity-penalised affinity) or
    # "fennel" (α·γ·|P|^{γ−1} marginal-cost).  restream_passes: warm
    # re-assignment passes over *all* vertices after each event (0 =
    # admit-only, the single-pass incremental baseline).
    restream: str = "ldg"
    restream_passes: int = 0

    def delta_for_round(self, round_idx: int,
                        accuracies: Sequence[float] = ()) -> Optional[float]:
        """τ in effect for ``round_idx`` given accuracies of *finished*
        rounds — the adaptive-τ schedule (ROADMAP follow-up)."""
        if self.delta_threshold is None:
            return None
        if self.delta_schedule == "constant":
            return self.delta_threshold
        if self.delta_schedule == "linear":
            frac = min(1.0, round_idx / max(1, self.delta_rounds))
            return self.delta_threshold * frac
        if self.delta_schedule == "plateau":
            w = self.plateau_window
            if len(accuracies) < w + 1:
                return 0.0
            recent = max(accuracies[-w:])
            before = max(accuracies[:-w])
            return self.delta_threshold \
                if recent - before < self.plateau_eps else 0.0
        raise ValueError(
            f"unknown delta_schedule {self.delta_schedule!r}; "
            "expected constant | linear | plateau")

    def describe(self) -> str:
        bits = [self.name]
        if not self.use_embeddings:
            bits.append("no-embeddings")
        if self.codec != "fp32":
            bits.append(self.codec)
        if self.delta_threshold is not None:
            bits.append(f"delta_tau={self.delta_threshold:g}")
            if self.delta_schedule != "constant":
                bits.append(f"tau_sched={self.delta_schedule}")
        if self.error_feedback:
            bits.append("ef")
        if self.aggregation != "sync":
            bits.append(f"agg={self.aggregation}"
                        f"(m={self.buffer_size},"
                        f"decay={self.staleness_decay:g})")
        if self.weight_codec is not None:
            ef = "+ef" if self.weight_error_feedback else ""
            bits.append(f"wcodec={self.weight_codec}{ef}")
        if self.sample_frac is not None:
            bits.append(f"sample={self.sample_frac:g}")
        if self.num_server_shards > 1:
            bits.append(f"shards={self.num_server_shards}")
        if self.shard_placement != "hash":
            bits.append(f"place={self.shard_placement}")
        if self.transport != "auto":
            bits.append(f"wire={self.transport}")
        if self.retention_limit is not None:
            bits.append(f"P_{self.retention_limit}")
        if self.scored_prune_frac is not None:
            sel = "R" if self.random_subset else "T"
            bits.append(f"{sel}{int(self.scored_prune_frac * 100)}:{self.score_kind}")
        if self.prefetch_frac is not None:
            bits.append(f"prefetch_x={int(self.prefetch_frac * 100)}%")
        if self.overlap_push:
            bits.append("overlap")
        if self.restream != "ldg":
            bits.append(f"restream={self.restream}")
        if self.restream_passes:
            bits.append(f"repass={self.restream_passes}")
        return " ".join(bits)


def default_strategies(*, retention: int = 4, f: float = 0.25,
                       x: float = 0.25) -> dict[str, Strategy]:
    """The seven strategies of Figs. 6–9 with paper-default knobs
    (P_4 for uniform pruning, f=x=25%)."""
    return {
        "D": Strategy("D", use_embeddings=False),
        "E": Strategy("E"),
        "O": Strategy("O", overlap_push=True),
        "P": Strategy("P", retention_limit=retention),
        "OP": Strategy("OP", overlap_push=True, retention_limit=retention),
        "OPP": Strategy("OPP", overlap_push=True, retention_limit=retention,
                        prefetch_frac=x),
        "OPG": Strategy("OPG", overlap_push=True, retention_limit=retention,
                        scored_prune_frac=f),
    }
