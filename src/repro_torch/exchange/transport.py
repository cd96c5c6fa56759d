"""Transports: where remote-embedding bytes travel.

Port of ``repro/exchange/transport.py``.  A :class:`Transport` separates
the *storage* of shared embeddings (the EmbeddingServer tables) from the
*wire model* that charges for moving them.  Two implementations, both
with their tables on the device, so the fused int8 surface is always
available:

  InProcessTransport — one embedding server behind one NetworkModel, the
      seed topology of §5.1.
  ShardedTransport   — vertex ids hashed (or placed by observed pull
      frequency) across S embedding-server shards, each with its own
      NetworkModel and TransferLog.  Shards serve in parallel, so the
      modelled wall time is the max over shards while bytes and RPCs
      accumulate per shard.

The third, :class:`~repro_torch.exchange.socket_transport.TcpTransport`,
moves the codec bytes across live TCP embedding-server shards.

Time accounting is split into the pure :meth:`Transport.transfer_time`
query (a push is priced when planned, applied later) and
:meth:`Transport.account`, which also records into the shard logs.
"""

from __future__ import annotations

import abc
import heapq

import numpy as np
import torch

from repro_torch.core.cost_model import NetworkModel, TransferLog
from repro_torch.core.embedding_server import EmbeddingServer
from repro_torch.kernels import ops


class Transport(abc.ABC):
    """Storage + modelled wire for one federated deployment."""

    num_layers: int
    hidden: int
    device: torch.device

    #: True when :meth:`gather` / :meth:`write` move codec bytes across
    #: a real wire (TcpTransport): ExchangeClient then skips its
    #: simulated codec round trip, keeping the numerics bit-identical
    #: to the modelled transports.
    wire_is_real: bool = False

    @abc.abstractmethod
    def register(self, global_ids: np.ndarray) -> None: ...

    @abc.abstractmethod
    def write(self, global_ids: np.ndarray, layer_values: list) -> None:
        """Raw store of decoded fp32 rows (no accounting)."""

    @abc.abstractmethod
    def gather(self, global_ids: np.ndarray,
               layers: list[int] | None = None) -> list[torch.Tensor]:
        """Raw read (no accounting), original id order."""

    @abc.abstractmethod
    def gather_quantized(self, global_ids: np.ndarray,
                         layers: list[int] | None = None) -> list[tuple]:
        """Fused pull response: per selected layer, (values int8
        (n, hidden), scales fp32 (n, 1)) in original id order."""

    @abc.abstractmethod
    def write_quantized(self, global_ids: np.ndarray,
                        layer_payloads: list[tuple]) -> None:
        """Fused push apply: store int8 payload rows via decode+scatter."""

    @abc.abstractmethod
    def gather_versioned(
        self, global_ids: np.ndarray, have_versions: np.ndarray,
        layers: list[int] | None = None,
    ) -> tuple[np.ndarray, np.ndarray, list[torch.Tensor]]:
        """Conditional gather for serving-side caches (no accounting):
        ``(versions, stale_pos, layer_values)``."""

    @abc.abstractmethod
    def transfer_time(self, global_ids: np.ndarray, layers: int,
                      bytes_per_scalar: float) -> float:
        """Pure time query for one batched transfer (no logging)."""

    @abc.abstractmethod
    def account(self, global_ids: np.ndarray, layers: int,
                bytes_per_scalar: float) -> float:
        """Record one batched transfer in the shard logs, return time."""

    # -- telemetry ---------------------------------------------------------

    @property
    @abc.abstractmethod
    def shard_logs(self) -> list[TransferLog]: ...

    @property
    def log(self) -> TransferLog:
        """Read-only aggregate over all shard logs: a fresh snapshot on
        each access, so writes to it are discarded.  Record traffic via
        :meth:`account`; per-shard state lives in :attr:`shard_logs`."""
        total = TransferLog()
        for lg in self.shard_logs:
            total.add(bytes=lg.bytes, rpcs=lg.rpcs,
                      embeddings=lg.embeddings, seconds=lg.seconds,
                      measured_seconds=lg.measured_seconds)
        return total

    @property
    @abc.abstractmethod
    def num_embeddings_stored(self) -> int: ...

    @abc.abstractmethod
    def memory_bytes(self) -> int: ...


def _layers(num_layers: int, layers) -> list[int]:
    return list(range(1, num_layers)) if layers is None else list(layers)


class InProcessTransport(Transport):
    """Single embedding server behind a single modelled link."""

    def __init__(self, num_layers: int, hidden: int,
                 net: NetworkModel | None = None, *, device: str = "cuda"):
        self.num_layers = num_layers
        self.hidden = hidden
        self.net = net or NetworkModel()
        self.server = EmbeddingServer(num_layers, hidden, device=device)
        self.device = self.server.device
        self._log = TransferLog()

    def register(self, global_ids):
        self.server.register(global_ids)

    def write(self, global_ids, layer_values):
        self.server.write(global_ids, layer_values)

    def gather(self, global_ids, layers=None):
        return self.server.gather(global_ids, layers)

    def gather_quantized(self, global_ids, layers=None):
        return self.server.gather_quantized(global_ids, layers)

    def write_quantized(self, global_ids, layer_payloads):
        self.server.write_quantized(global_ids, layer_payloads)

    def gather_versioned(self, global_ids, have_versions, layers=None):
        return self.server.gather_if_stale(global_ids, have_versions, layers)

    def transfer_time(self, global_ids, layers, bytes_per_scalar):
        if len(global_ids) == 0 or layers == 0:
            return 0.0
        return self.net.transfer_time(len(global_ids), self.hidden, layers,
                                      bytes_per_scalar=bytes_per_scalar)

    def account(self, global_ids, layers, bytes_per_scalar):
        t = self.transfer_time(global_ids, layers, bytes_per_scalar)
        if t == 0.0:
            return 0.0
        self._log.add(
            bytes=self.net.embedding_bytes(len(global_ids), self.hidden,
                                           layers,
                                           bytes_per_scalar=bytes_per_scalar),
            rpcs=1, embeddings=len(global_ids) * layers, seconds=t)
        return t

    @property
    def shard_logs(self):
        return [self._log]

    @property
    def num_embeddings_stored(self) -> int:
        return self.server.num_embeddings_stored

    def memory_bytes(self) -> int:
        return self.server.memory_bytes()


class HashShardedWire:
    """Hash placement + per-shard modelled accounting.

    Expects ``num_shards``, ``hidden``, ``nets`` (one NetworkModel per
    shard) and ``_logs`` (one TransferLog per shard) on the instance."""

    num_shards: int
    hidden: int
    nets: list[NetworkModel]
    _logs: list[TransferLog]
    #: optional gid → shard override (pull-frequency rebalancing); ids
    #: beyond the map, or mapped to -1, fall back to hashing
    _placement: np.ndarray | None = None

    def shard_of(self, global_ids: np.ndarray) -> np.ndarray:
        """Vertex id → shard: the placement map where one exists
        (Strategy.shard_placement='pull_frequency'), else ``gid % S``."""
        gids = np.asarray(global_ids, np.int64)
        owner = gids % self.num_shards
        pl = self._placement
        if pl is not None and len(pl):
            inb = gids < len(pl)
            mapped = np.where(inb, pl[np.minimum(gids, len(pl) - 1)], -1)
            owner = np.where(mapped >= 0, mapped, owner)
        return owner

    def _split(self, global_ids: np.ndarray):
        """→ [(shard, positions-into-global_ids)] for non-empty shards."""
        owner = self.shard_of(global_ids)
        return [(s, np.nonzero(owner == s)[0])
                for s in range(self.num_shards)
                if np.any(owner == s)]

    def _shard_times(self, global_ids, layers, bytes_per_scalar):
        """[(shard, positions, modelled time)]: the single source both
        transfer_time and account price from."""
        return [(s, pos,
                 self.nets[s].transfer_time(len(pos), self.hidden, layers,
                                            bytes_per_scalar=bytes_per_scalar))
                for s, pos in self._split(global_ids)]

    def transfer_time(self, global_ids, layers, bytes_per_scalar):
        """Shards serve concurrently: wall time is the slowest shard."""
        if len(global_ids) == 0 or layers == 0:
            return 0.0
        return max(t for _, _, t in
                   self._shard_times(global_ids, layers, bytes_per_scalar))

    def account(self, global_ids, layers, bytes_per_scalar):
        if len(global_ids) == 0 or layers == 0:
            return 0.0
        t_max = 0.0
        for s, pos, t in self._shard_times(global_ids, layers,
                                           bytes_per_scalar):
            self._logs[s].add(
                bytes=self.nets[s].embedding_bytes(
                    len(pos), self.hidden, layers,
                    bytes_per_scalar=bytes_per_scalar),
                rpcs=1, embeddings=len(pos) * layers, seconds=t)
            t_max = max(t_max, t)
        return t_max

    @property
    def shard_logs(self):
        return list(self._logs)


class ShardedTransport(HashShardedWire, Transport):
    """Vertex ids hashed across S embedding-server shards on one device.

    ``nets`` gives one NetworkModel per shard (heterogeneous links); a
    single model (or None) is replicated.  Every codec is
    row-independent, so splitting rows across shards never changes the
    values: sharding moves only the time and byte accounting.

    A pull or a push never reads the device back to the host: each
    shard's rows go through that shard's fused kernels and are
    recombined in id order on the device (``index_copy_`` into one
    output per layer, or ``index_select`` of a push's payload rows), at
    positions copied to the device once per call and shard."""

    def __init__(self, num_layers: int, hidden: int, num_shards: int,
                 nets: list[NetworkModel] | NetworkModel | None = None, *,
                 device: str = "cuda"):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_layers = num_layers
        self.hidden = hidden
        self.num_shards = num_shards
        if nets is None or isinstance(nets, NetworkModel):
            nets = [nets or NetworkModel()] * num_shards
        if len(nets) != num_shards:
            raise ValueError(f"{len(nets)} NetworkModels for {num_shards} "
                             "shards: give one per shard")
        self.nets = list(nets)
        self.shards = [EmbeddingServer(num_layers, hidden, device=device)
                       for _ in self.nets]
        self.device = self.shards[0].device
        self._logs = [TransferLog() for _ in range(num_shards)]
        #: per-gid gather tally, fed to rebalance_by_pulls.  Off by
        #: default: the trainer turns it on for
        #: Strategy.shard_placement='pull_frequency', so hash-placed runs
        #: never pay the tally on the gather path.
        self.track_pulls = False
        self._pull_counts = np.zeros(0, np.int64)

    def _count_pulls(self, global_ids) -> None:
        if not self.track_pulls:
            return
        gids = np.asarray(global_ids, np.int64)
        if len(gids) == 0:
            return
        need = int(gids.max()) + 1
        if need > len(self._pull_counts):
            grown = np.zeros(max(need, 2 * len(self._pull_counts)),
                             np.int64)
            grown[: len(self._pull_counts)] = self._pull_counts
            self._pull_counts = grown
        np.add.at(self._pull_counts, gids, 1)

    def rebalance_by_pulls(self) -> np.ndarray | None:
        """Re-place rows by observed pull frequency.

        Greedy LPT: the hottest gid goes onto the least-loaded shard,
        load being the pull mass already placed there, so two hot
        vertices that hash together stop serialising on one link.  Rows
        migrate between the shard servers (read, forgotten, written into
        their new shard); values are untouched, so numerics never change,
        only the per-shard byte and time ledgers.  Returns the new
        placement map, or None (hash placement stays) when no pull was
        ever logged."""
        counts = self._pull_counts
        hot = np.nonzero(counts > 0)[0]
        if len(hot) == 0:
            return None
        order = hot[np.argsort(-counts[hot], kind="stable")]
        old_owner = self.shard_of(order)
        placement = np.full(len(counts), -1, np.int32)
        # a heap of (load, shard): pops break ties on the lowest shard
        heap = [(0, s) for s in range(self.num_shards)]
        for gid in order:
            load, s = heapq.heappop(heap)
            placement[gid] = s
            heapq.heappush(heap, (load + int(counts[gid]), s))
        new_owner = placement[order]
        self._placement = placement
        for s_old in range(self.num_shards):
            moved = order[(old_owner == s_old) & (new_owner != s_old)]
            if len(moved) == 0:
                continue
            vals = self.shards[s_old].gather(moved)
            self.shards[s_old].forget(moved)
            for s_new, pos in self._split(moved):
                at = ops.host_to_device(pos, self.device)
                self.shards[s_new].register(moved[pos])
                self.shards[s_new].write(moved[pos],
                                         [v.index_select(0, at)
                                          for v in vals])
        return placement

    def register(self, global_ids):
        gids = np.asarray(global_ids, np.int64)
        for s, pos in self._split(gids):
            self.shards[s].register(gids[pos])

    def write(self, global_ids, layer_values):
        gids = np.asarray(global_ids, np.int64)
        vals = [torch.as_tensor(v, dtype=torch.float32).to(self.device)
                for v in layer_values]
        for s, pos in self._split(gids):
            at = ops.host_to_device(pos, self.device)
            self.shards[s].write(gids[pos],
                                 [v.index_select(0, at) for v in vals])

    def _combine(self, global_ids, layers, read, dtypes):
        """Each non-empty shard's ``read(shard, gids, layers)`` (one tuple
        of tensors per layer) copied into id order on the device: one
        output per layer and tuple member, of ``dtypes`` and width
        ``hidden`` (or 1 for a scale), ``index_copy_`` at the shard's
        positions."""
        self._count_pulls(global_ids)
        sel = _layers(self.num_layers, layers)
        gids = np.asarray(global_ids, np.int64)
        n = len(gids)
        out = [tuple(torch.empty((n, w), dtype=dt, device=self.device)
                     for dt, w in dtypes) for _ in sel]
        for s, pos in self._split(gids):
            at = ops.host_to_device(pos, self.device)
            for dst, part in zip(out, read(self.shards[s], gids[pos], sel)):
                for o, p in zip(dst, part):
                    o.index_copy_(0, at, p)
        return out

    def gather(self, global_ids, layers=None):
        out = self._combine(global_ids, layers,
                            lambda sv, g, sel: [(v,) for v in
                                                sv.gather(g, sel)],
                            [(torch.float32, self.hidden)])
        return [o for (o,) in out]

    def gather_quantized(self, global_ids, layers=None):
        """Per-shard fused gather + encode (row 3's kernel on each shard's
        own rows), recombined in id order on the device.  The codec is
        row-independent, so quantize-then-combine equals
        combine-then-quantize: sharding cannot change the wire values."""
        return self._combine(global_ids, layers,
                             lambda sv, g, sel: sv.gather_quantized(g, sel),
                             [(torch.int8, self.hidden),
                              (torch.float32, 1)])

    def write_quantized(self, global_ids, layer_payloads):
        """Each shard's payload rows, selected on the device, through
        that shard's fused decode + scatter (row 4's kernel)."""
        gids = np.asarray(global_ids, np.int64)
        for s, pos in self._split(gids):
            at = ops.host_to_device(pos, self.device)
            self.shards[s].write_quantized(
                gids[pos], [(v.index_select(0, at), sc.index_select(0, at))
                            for v, sc in layer_payloads])

    def gather_versioned(self, global_ids, have_versions, layers=None):
        sel = _layers(self.num_layers, layers)
        gids = np.asarray(global_ids, np.int64)
        have = np.asarray(have_versions, np.int64)
        ver = np.zeros(len(gids), np.int64)
        stale_parts, val_parts = [], []
        for s, pos in self._split(gids):
            v, st, vals = self.shards[s].gather_if_stale(gids[pos],
                                                         have[pos], sel)
            ver[pos] = v
            stale_parts.append(pos[st])
            val_parts.append(vals)
        if not stale_parts:
            return (ver, np.zeros(0, np.int64),
                    [torch.zeros((0, self.hidden), dtype=torch.float32,
                                 device=self.device) for _ in sel])
        stale = np.concatenate(stale_parts).astype(np.int64)
        order = np.argsort(stale, kind="stable")
        at = ops.host_to_device(order, self.device)
        vals = [torch.cat([vp[j] for vp in val_parts]).index_select(0, at)
                for j in range(len(sel))]
        return ver, stale[order], vals

    @property
    def num_embeddings_stored(self) -> int:
        return sum(s.num_embeddings_stored for s in self.shards)

    def memory_bytes(self) -> int:
        return sum(s.memory_bytes() for s in self.shards)


def make_transport(num_layers: int, hidden: int, *, kind: str = "auto",
                   num_shards: int = 1,
                   nets: list[NetworkModel] | NetworkModel | None = None,
                   addrs=None, codec: str = "fp32",
                   device: str = "cuda") -> Transport:
    """The transport a deployment uses, its rows on ``device``.

    ``kind`` selects the wire: ``"inprocess"`` (one modelled link, the
    seed topology), ``"sharded"`` (hashed in-process shards with
    per-shard modelled links; ``nets`` one model or one per shard) or
    ``"tcp"`` (live embedding-server shards at ``addrs``, speaking the
    :mod:`repro_torch.exchange.wire` protocol with ``codec`` payloads).
    The default ``"auto"`` infers: addresses given → tcp, ``num_shards``
    > 1 → sharded, else in-process."""
    if kind == "auto":
        kind = "tcp" if addrs else \
            ("sharded" if num_shards > 1 else "inprocess")
    if kind == "tcp":
        from .socket_transport import TcpTransport   # lazy: socket machinery
        if not addrs:
            raise ValueError("kind='tcp' needs addrs=[(host, port), ...] "
                             "— one embed_server listener per shard")
        if num_shards > 1 and len(addrs) != num_shards:
            raise ValueError(f"num_shards={num_shards} but {len(addrs)} "
                             "tcp addresses given")
        return TcpTransport(num_layers, hidden, addrs, codec=codec,
                            nets=nets, device=device)
    if addrs:
        raise ValueError(f"addrs only apply to kind='tcp', got {kind!r}")
    if kind == "inprocess":
        if num_shards > 1:
            raise ValueError("kind='inprocess' is single-shard; use "
                             "kind='sharded' for num_shards > 1")
        if isinstance(nets, list):
            if len(nets) != 1:
                raise ValueError(f"{len(nets)} NetworkModels for a "
                                 "single-shard transport")
            nets = nets[0]
        return InProcessTransport(num_layers, hidden, nets, device=device)
    if kind == "sharded":
        return ShardedTransport(num_layers, hidden, num_shards, nets,
                                device=device)
    raise ValueError(f"unknown transport kind {kind!r}; "
                     "expected inprocess | sharded | tcp")
