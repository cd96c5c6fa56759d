"""TcpTransport: a Transport whose bytes cross a socket.

Port of ``repro/exchange/socket_transport.py``.  It speaks the
:mod:`repro_torch.exchange.wire` protocol against one embedding-server
listener per shard (``repro_torch.launch.embed_server``, or the JAX
package's, which speaks the same bytes).  Vertex ids hash across shards
as in :class:`ShardedTransport` (``gid % S``), and every codec is
row-independent, so the stored state, and the training numerics, are
bit-identical to the in-process transports.

On the device: a gather copies each shard's reply to the device once
and decodes it there (the int8 decode kernel on the card), so it returns
device tensors like the other transports; a write encodes each shard's
rows on the device (the int8 encode kernel) and copies each layer block
to the host once for the frame.

Connection pooling: one persistent socket per shard, opened lazily and
reopened on failure.  Multi-shard RPCs are pipelined: every shard's
request frame is written before any response is read, so shards serve
concurrently as the modelled max-over-shards wall time assumes.

Two ledgers per shard, kept apart:

  ``shard_logs``  — the modelled ledger, written by :meth:`account` with
      NetworkModel prices, as the in-process transports keep it.
  ``wire_logs``   — the measured ledger: every real RPC records its
      payload bytes, its measured wall time (``measured_seconds``) and
      the NetworkModel's time for the same payload (``seconds``).

Per-RPC samples land in :attr:`rpc_samples` (:class:`RpcSample`), which
:func:`repro_torch.core.cost_model.fit_network_model` calibrates from;
only ``fanout == 1`` samples carry clean per-RPC timing.
"""

from __future__ import annotations

import dataclasses
import socket
import time

import numpy as np
import torch

from repro_torch.core.cost_model import NetworkModel, TransferLog
from repro_torch.kernels import ops
from repro_torch.obsv.metrics import SampleWindow

from . import wire
from .codec import WireCodec, get_codec
from .transport import HashShardedWire, Transport, _layers


@dataclasses.dataclass(frozen=True)
class RpcSample:
    """One real RPC: what moved, what it cost, what the model says.

    ``measured_s`` is clean per-RPC time only when ``fanout == 1``: in a
    pipelined multi-shard fan-out, responses are read in shard order, so
    a later shard's clock includes earlier shards' read time."""
    op: str                    # register | write | gather | vgather
    shard: int
    fanout: int                # shards in this RPC's pipelined fan-out
    n_rows: int
    layers: int
    payload_bytes: int         # codec payload only (== embedding_bytes)
    frame_bytes: int           # full frames incl. headers/gids, both ways
    measured_s: float          # wall time, send-start → response-read
    modelled_s: float          # NetworkModel.transfer_time for the payload


def parse_address(addr) -> tuple[str, int]:
    """('host', port) | 'host:port' | ':port' → ('host', port)."""
    if isinstance(addr, (tuple, list)):
        host, port = addr
        return (host or "127.0.0.1", int(port))
    host, _, port = str(addr).rpartition(":")
    return (host or "127.0.0.1", int(port))


#: rpc_samples window: enough for any calibration sweep, bounded so a
#: long training run cannot grow memory linearly with rounds.
MAX_RPC_SAMPLES = 65536


class TcpTransport(HashShardedWire, Transport):
    """Embedding storage behind live TCP embedding-server shards; the
    rows it returns and takes are tensors on ``device``."""

    wire_is_real = True

    def __init__(self, num_layers: int, hidden: int, addrs,
                 *, codec: WireCodec | str = "fp32",
                 nets: list[NetworkModel] | NetworkModel | None = None,
                 connect_timeout: float = 5.0, device: str = "cuda"):
        if not addrs:
            raise ValueError("TcpTransport needs at least one "
                             "(host, port) shard address")
        self.num_layers = num_layers
        self.hidden = hidden
        self.device = torch.device(device)
        self.addrs = [parse_address(a) for a in addrs]
        self.num_shards = len(self.addrs)
        self.codec = get_codec(codec)
        if nets is None or isinstance(nets, NetworkModel):
            nets = [nets or NetworkModel()] * self.num_shards
        if len(nets) != self.num_shards:
            raise ValueError(f"{len(nets)} NetworkModels for "
                             f"{self.num_shards} shards: give one per shard")
        self.nets = list(nets)
        self.connect_timeout = connect_timeout
        self._socks: list[socket.socket | None] = [None] * self.num_shards
        self._logs = [TransferLog() for _ in range(self.num_shards)]
        self._wire_logs = [TransferLog() for _ in range(self.num_shards)]
        # one bookkeeping point for calibration (the window) and the
        # OP_METRICS scrape (pt_exchange.latency_s.<op> / .bytes.<op>)
        self.rpc_samples = SampleWindow("pt_exchange", MAX_RPC_SAMPLES)
        self._validate_servers()

    def _validate_servers(self) -> None:
        """Fail fast on a (num_layers, hidden) mismatch instead of a
        confusing payload-size error mid-round."""
        for s, st in enumerate(self._stats()):
            if (st["num_layers"], st["hidden"]) != (self.num_layers,
                                                    self.hidden):
                raise ValueError(
                    f"embed-server shard {s} at "
                    f"{self.addrs[s][0]}:{self.addrs[s][1]} serves "
                    f"L={st['num_layers']}, hidden={st['hidden']} but "
                    f"this transport expects L={self.num_layers}, "
                    f"hidden={self.hidden} — relaunch the server with "
                    "matching --num-layers/--hidden")

    # -- connection pool ---------------------------------------------------

    def _conn(self, s: int) -> socket.socket:
        sock = self._socks[s]
        if sock is not None:
            return sock
        sock = socket.create_connection(self.addrs[s],
                                        timeout=self.connect_timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(None)
        self._socks[s] = sock
        return sock

    def _drop(self, s: int) -> None:
        if self._socks[s] is not None:
            try:
                self._socks[s].close()
            except OSError:
                pass
            self._socks[s] = None

    def close(self) -> None:
        for s in range(self.num_shards):
            self._drop(s)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def shutdown_servers(self) -> None:
        """Ask every shard listener to exit (tests and teardown)."""
        for s in range(self.num_shards):
            try:
                wire.parse_response(self._roundtrip(s, wire.build_shutdown()))
            except (ConnectionError, OSError, RuntimeError):
                pass
        self.close()

    # -- framing -----------------------------------------------------------

    def _roundtrip(self, s: int, body: bytes):
        """Single-shard RPC with one transparent reconnect: a pooled
        socket may have died since the last round."""
        for attempt in (0, 1):
            try:
                sock = self._conn(s)
                wire.send_frame(sock, body)
                resp = wire.recv_frame(sock)
                if resp is None:
                    raise ConnectionError("server closed connection")
                return resp
            except (ConnectionError, OSError):
                self._drop(s)
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def _rpc_many(self, reqs: list[tuple[int, bytes]]) -> list[tuple]:
        """Pipelined fan-out: write every shard's request frame, then read
        the responses in order → [(response body, measured s)].

        On any send/recv error every socket of the fan-out is dropped (a
        pooled socket with an unread response would answer the next RPC
        with stale bytes) and the whole fan-out is retried once:
        register, write and gather are idempotent."""
        for attempt in (0, 1):
            try:
                return self._rpc_many_once(reqs)
            except (ConnectionError, OSError):
                for s, _ in reqs:
                    self._drop(s)
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def _rpc_many_once(self, reqs: list[tuple[int, bytes]]) -> list[tuple]:
        t0: dict[int, float] = {}
        for s, body in reqs:
            t0[s] = time.perf_counter()
            wire.send_frame(self._conn(s), body)
        out = []
        for s, _ in reqs:
            resp = wire.recv_frame(self._socks[s])
            if resp is None:
                raise ConnectionError(
                    f"embed-server shard {s} {self.addrs[s]} closed "
                    "connection")
            out.append((resp, time.perf_counter() - t0[s]))
        return out

    # -- ledgers -----------------------------------------------------------

    def _record(self, op: str, s: int, n: int, layers: int,
                payload_bytes: int, frame_bytes: int,
                measured_s: float, fanout: int = 1) -> None:
        if op == "register":
            # ids only, no embedding payload: per-RPC overhead plus the
            # raw id bytes on the wire
            modelled = self.nets[s].rpc_overhead_s \
                + 8 * n / self.nets[s].bandwidth_bytes_per_s
        else:
            modelled = self.nets[s].transfer_time(
                n, self.hidden, layers,
                bytes_per_scalar=self.codec.bytes_per_scalar(self.hidden))
        self._wire_logs[s].add(bytes=payload_bytes, rpcs=1,
                               embeddings=n * layers, seconds=modelled,
                               measured_seconds=measured_s)
        self.rpc_samples.observe(RpcSample(
            op=op, shard=s, fanout=fanout, n_rows=n, layers=layers,
            payload_bytes=payload_bytes, frame_bytes=frame_bytes,
            measured_s=measured_s, modelled_s=modelled))

    def _fan_out(self, op: str, parts, reqs, layers: int, payloads=None):
        """Send ``reqs``, check each reply's status, record each RPC →
        [reply payload] in ``parts`` order."""
        resps = self._rpc_many(reqs)
        out = []
        for i, ((s, pos), (_, body), (resp, dt)) in enumerate(
                zip(parts, reqs, resps)):
            payload = wire.parse_response(resp)
            out.append(payload)
            nbytes = len(payload) if payloads is None else payloads[i]
            self._record(op, s, len(pos), layers, nbytes,
                         wire.frame_nbytes(len(body))
                         + wire.frame_nbytes(len(resp)), dt,
                         fanout=len(parts))
        return out

    # -- storage surface ---------------------------------------------------

    def register(self, global_ids):
        gids = np.asarray(global_ids, np.int64)
        if len(gids) == 0:
            return
        parts = self._split(gids)
        self._fan_out("register", parts,
                      [(s, wire.build_register(gids[pos]))
                       for s, pos in parts], 0, payloads=[0] * len(parts))

    def write(self, global_ids, layer_values):
        """Encode each shard's rows on the device, one host copy a layer
        block, and store them on the shard."""
        gids = np.asarray(global_ids, np.int64)
        if len(gids) == 0:
            return
        name = self.codec.name
        vals = [torch.as_tensor(v, dtype=torch.float32).to(self.device)
                for v in layer_values]
        parts = self._split(gids)
        reqs, payloads = [], []
        for s, pos in parts:
            if len(parts) == 1:
                rows = vals
            else:
                at = ops.host_to_device(pos, self.device)
                rows = [v.index_select(0, at) for v in vals]
            blocks = [wire.encode_block(name, self.codec.encode(r))
                      for r in rows]
            payloads.append(sum(len(b) for b in blocks))
            reqs.append((s, wire.build_write(name, gids[pos], blocks)))
        self._fan_out("write", parts, reqs, len(layer_values),
                      payloads=payloads)

    def _decode_rows(self, s: int, blob, n: int, count: int,
                     what: str) -> list[torch.Tensor]:
        """``count`` layer blocks of ``n`` rows from shard ``s``'s reply,
        each copied to the device once and decoded there."""
        name = self.codec.name
        block = wire.payload_nbytes(name, n, self.hidden)
        if len(blob) != block * count:
            raise ConnectionError(
                f"{what} reply from shard {s} carries {len(blob)} B of "
                f"rows, expected {block * count} B ({n} rows × "
                f"{count} layers)")
        return [self.codec.decode(wire.decode_block(
                    name, blob[i * block:(i + 1) * block], n, self.hidden,
                    self.device))
                for i in range(count)]

    def gather(self, global_ids, layers=None):
        sel = _layers(self.num_layers, layers)
        gids = np.asarray(global_ids, np.int64)
        n = len(gids)
        if n == 0 or not sel:
            return [torch.zeros((n, self.hidden), dtype=torch.float32,
                                device=self.device) for _ in sel]
        parts = self._split(gids)
        replies = self._fan_out(
            "gather", parts,
            [(s, wire.build_gather(self.codec.name, gids[pos], sel))
             for s, pos in parts], len(sel))
        if len(parts) == 1:
            s, pos = parts[0]
            return self._decode_rows(s, replies[0], n, len(sel), "gather")
        out = [torch.empty((n, self.hidden), dtype=torch.float32,
                           device=self.device) for _ in sel]
        for (s, pos), blob in zip(parts, replies):
            at = ops.host_to_device(pos, self.device)
            for o, part in zip(out, self._decode_rows(s, blob, len(pos),
                                                      len(sel), "gather")):
                o.index_copy_(0, at, part)
        return out

    def gather_versioned(self, global_ids, have_versions, layers=None):
        sel = _layers(self.num_layers, layers)
        gids = np.asarray(global_ids, np.int64)
        have = np.asarray(have_versions, np.int64)
        empty = [torch.zeros((0, self.hidden), dtype=torch.float32,
                             device=self.device) for _ in sel]
        if len(gids) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64), empty
        parts = self._split(gids)
        reqs = [(s, wire.build_vgather(self.codec.name, gids[pos],
                                       have[pos], sel))
                for s, pos in parts]
        resps = self._rpc_many(reqs)
        ver = np.zeros(len(gids), np.int64)
        stale_parts, val_parts = [], []
        for (s, pos), (_, body), (resp, dt) in zip(parts, reqs, resps):
            payload = wire.parse_response(resp)
            n = len(pos)
            v = np.frombuffer(payload, np.int64, n).copy()
            ver[pos] = v
            # both ends recompute the stale set from the version vectors
            st = np.nonzero(v != have[pos])[0]
            blob = payload[n * 8:]
            val_parts.append(self._decode_rows(s, blob, len(st), len(sel),
                                               "vgather"))
            stale_parts.append(pos[st])
            self._record("vgather", s, len(st), len(sel), len(blob),
                         wire.frame_nbytes(len(body))
                         + wire.frame_nbytes(len(resp)), dt,
                         fanout=len(parts))
        stale = np.concatenate(stale_parts).astype(np.int64)
        order = np.argsort(stale, kind="stable")
        at = ops.host_to_device(order, self.device)
        vals = [torch.cat([vp[j] for vp in val_parts]).index_select(0, at)
                for j in range(len(sel))]
        return ver, stale[order], vals

    def gather_quantized(self, global_ids, layers=None):
        raise NotImplementedError(
            "TcpTransport has no fused quantized surface: its gather "
            "carries the codec bytes itself")

    def write_quantized(self, global_ids, layer_payloads):
        raise NotImplementedError(
            "TcpTransport has no fused quantized surface: its write "
            "carries the codec bytes itself")

    # -- telemetry ---------------------------------------------------------

    @property
    def wire_logs(self) -> list[TransferLog]:
        """Measured per-shard ledgers (real RPCs; payload bytes only)."""
        return list(self._wire_logs)

    @property
    def wire_log(self) -> TransferLog:
        total = TransferLog()
        for lg in self._wire_logs:
            total.add(bytes=lg.bytes, rpcs=lg.rpcs,
                      embeddings=lg.embeddings, seconds=lg.seconds,
                      measured_seconds=lg.measured_seconds)
        return total

    def _stats(self) -> list[dict]:
        return [wire.parse_stats_payload(bytes(wire.parse_response(
                    self._roundtrip(s, wire.build_stats()))))
                for s in range(self.num_shards)]

    @property
    def num_embeddings_stored(self) -> int:
        return sum(st["rows"] * (st["num_layers"] - 1)
                   for st in self._stats())

    def memory_bytes(self) -> int:
        return sum(st["memory_bytes"] for st in self._stats())
