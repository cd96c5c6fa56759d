"""Coordinator wire protocol: JSON headers + raw tensor blocks.

Port of ``repro/fedsvc/protocol.py``, the same bytes.  It reuses the
length-prefixed framing of :mod:`repro_torch.exchange.wire` (one
``uint32 LE length | body`` frame per RPC, ``uint8 status`` responses)
with its own opcode space.  Every request/response body is::

    uint8 opcode (request) / status (response)
    uint32 LE header length | UTF-8 JSON header
    tensor blocks (wire.build_tensors)

JSON carries the small stuff (round indices, weights, losses, phase
timings); tensors carry model leaves byte-exactly, so a model served,
trained and re-submitted round-trips bit for bit.

Blocking semantics live server-side: ``get_model`` and ``wait_pulled``
do not answer until their condition holds (each worker connection has a
dedicated server thread).

Opcodes 16–31 belong to this plane.  They keep the JAX values under
``PT_OP_*`` names (a second module defining ``OP_*`` names would shadow
the JAX plane's, the analyzer's WP006); a test holds them equal.
"""

from __future__ import annotations

import json
import socket
import struct

import numpy as np

from repro_torch.exchange import wire

# -- opcodes (the JAX values under PT_ names; see the module docstring) -------

PT_OP_HELLO = 16        # register worker + client ids, optionally seed model
PT_OP_GET_MODEL = 17    # blocking in sync mode: current global model
PT_OP_PULLED = 18       # sync: this worker's clients filled their caches
PT_OP_WAIT_PULLED = 19  # sync: block until every active client pulled
PT_OP_UPDATE = 20       # submit one client's trained params / async delta
PT_OP_COORD_STATS = 21        # coordinator telemetry snapshot (JSON)
PT_OP_COORD_SHUTDOWN = 22     # stop the service

_U32 = struct.Struct("<I")


# -- body build/parse ---------------------------------------------------------

def build_body(op_or_status: int, header: dict,
               tensors=()) -> bytes:
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    return (bytes([op_or_status]) + _U32.pack(len(blob)) + blob
            + (wire.build_tensors(tensors) if tensors else b""))


def parse_body(body: bytes) -> tuple[int, dict, list[np.ndarray]]:
    """→ (opcode/status, header, tensors).  Tensors absent → []."""
    view = memoryview(body)
    op = view[0]
    (hlen,) = _U32.unpack_from(view, 1)
    off = 1 + _U32.size
    header = json.loads(bytes(view[off:off + hlen]).decode("utf-8"))
    off += hlen
    tensors: list[np.ndarray] = []
    if off < len(view):
        tensors, _ = wire.parse_tensors(view, off)
    return op, header, tensors


STATUS_OK = wire.STATUS_OK
STATUS_ERR = wire.STATUS_ERR


def build_ok(header: dict | None = None, tensors=()) -> bytes:
    return build_body(STATUS_OK, header or {}, tensors)


def build_err(message: str) -> bytes:
    return build_body(STATUS_ERR, {"error": message})


def parse_reply(body: bytes) -> tuple[dict, list[np.ndarray]]:
    status, header, tensors = parse_body(body)
    if status != STATUS_OK:
        raise RuntimeError(f"coordinator error: {header.get('error', '?')}")
    return header, tensors


# -- client stub --------------------------------------------------------------

class CoordinatorClient:
    """One worker's connection to the coordinator.

    A single persistent socket; RPCs are strictly sequential (a worker
    is single-threaded), and the blocking calls (:meth:`get_model`,
    :meth:`wait_pulled`) park on the socket read until the coordinator
    answers — no client-side polling."""

    def __init__(self, addr, *, connect_timeout: float = 10.0):
        from repro_torch.exchange.socket_transport import parse_address
        self.addr = parse_address(addr)
        self.sock = socket.create_connection(self.addr,
                                             timeout=connect_timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock.settimeout(None)      # blocking RPCs can span a round

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _rpc(self, op: int, header: dict,
             tensors=()) -> tuple[dict, list[np.ndarray]]:
        wire.send_frame(self.sock, build_body(op, header, tensors))
        resp = wire.recv_frame(self.sock)
        if resp is None:
            raise ConnectionError("coordinator closed connection")
        return parse_reply(resp)

    # -- RPC surface -------------------------------------------------------

    def hello(self, worker_id: str, client_ids: list[int],
              init_leaves=None) -> dict:
        """Register (or *re*-register: a re-hello with the same
        ``worker_id``/``client_ids`` on a fresh connection is a worker
        re-join, and catches up from the current model).  The first
        worker to carry ``init_leaves`` seeds the global model (every
        worker inits identically from the shared seed, so any of them
        is authoritative).  ``has_init`` is true only for a *non-empty*
        leaf list — an empty list is "no init", not a zero-parameter
        model."""
        leaves = list(init_leaves) if init_leaves is not None else []
        h, _ = self._rpc(PT_OP_HELLO,
                         {"worker_id": worker_id,
                          "client_ids": [int(c) for c in client_ids],
                          "has_init": len(leaves) > 0},
                         leaves)
        return h

    def get_model(self, round_idx: int, *,
                  have_version: int = -1) -> tuple[dict, list[np.ndarray]]:
        """Sync: blocks until round ``round_idx`` is open (the previous
        round aggregated).  Async: returns the latest model at once.
        ``have_version`` is the serial of the model view this worker
        already holds (-1 = none): when the coordinator runs a weight
        codec and its served-view record matches, the response is a
        codec-encoded version diff (header kind="delta") instead of the
        full model.  Header carries {round, version, serial, done,
        kind, [codec, shapes], [sampled]}."""
        return self._rpc(PT_OP_GET_MODEL, {"round": int(round_idx),
                                        "have_version": int(have_version)})

    def pulled(self, round_idx: int, client_ids: list[int]) -> None:
        self._rpc(PT_OP_PULLED, {"round": int(round_idx),
                              "client_ids": [int(c) for c in client_ids]})

    def wait_pulled(self, round_idx: int) -> None:
        """Blocks until every active client reported pulled for the
        round — the all-pulled-before-anyone-pushes barrier that keeps
        the embedding plane static within a sync round."""
        self._rpc(PT_OP_WAIT_PULLED, {"round": int(round_idx)})

    def update(self, header: dict, leaves) -> dict:
        """Submit one client's update.  Sync headers carry
        {round, client_id, weight, loss, modelled_s, measured_s} with
        full param leaves; async carries {version, ...} with delta
        leaves (kind="delta")."""
        h, _ = self._rpc(PT_OP_UPDATE, header, leaves)
        return h

    def stats(self) -> dict:
        h, _ = self._rpc(PT_OP_COORD_STATS, {})
        return h

    def shutdown(self) -> None:
        try:
            self._rpc(PT_OP_COORD_SHUTDOWN, {})
        except (ConnectionError, OSError, RuntimeError):
            pass
        self.close()
