"""Growth-control wire format, on the port's exchange framing.

Port of ``repro/dyngraph/wire.py``: the same frames, byte for byte, so a
port worker reports its growth epoch to a JAX coordinator and the
reverse.  One opcode, ``PT_OP_GROWTH``, carries a worker's growth-epoch
barrier report to the coordinator as a JSON header (the fedsvc body
layout, ``u8 op | u32 len | JSON``, so the two planes share a socket)::

    PT_OP_GROWTH  request:  u8 op | u32 header length | UTF-8 JSON header
                  response: ok (empty payload)

The header is ``{"worker_id", "round", "epoch", "num_vertices",
"num_edges"}``: the worker has applied every delta up to ``epoch`` and
its merged view has the given shape.  The coordinator withholds the
reply until every active worker reports the same epoch, so no worker
trains round ``r`` against a graph another worker has not grown to yet.

Opcodes 48–63 belong to this plane.  The opcode keeps the JAX value
under a ``PT_OP_*`` name: a second module defining ``OP_*`` names would
shadow the JAX plane's (the analyzer's WP006), and a test holds the
value equal to the JAX one.
"""

from __future__ import annotations

import json
import struct

from repro_torch.exchange.wire import (  # noqa: F401  (re-exported)
    build_err, build_ok, parse_response, recv_frame, send_frame,
)

PT_OP_GROWTH = 48

#: numeric band reserved for growth-control opcodes (48..63); servers
#: route any opcode in the band here without naming individual ops.
GROWTH_LO = 48
GROWTH_HI = 63

_U8 = struct.Struct("<B")
_U32 = struct.Struct("<I")


def build_growth(header: dict) -> bytes:
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    return _U8.pack(PT_OP_GROWTH) + _U32.pack(len(blob)) + blob


def parse_growth_request(body) -> tuple[int, dict]:
    view = memoryview(body)
    (op,) = _U8.unpack_from(view, 0)
    if op == PT_OP_GROWTH:
        (hlen,) = _U32.unpack_from(view, 1)
        off = 1 + _U32.size
        header = json.loads(bytes(view[off:off + hlen]).decode("utf-8"))
        return op, header
    raise ValueError(f"unknown growth opcode {op}")


def growth_rpc(sock, header: dict) -> None:
    """Send one growth barrier report and block on the reply."""
    send_frame(sock, build_growth(header))
    resp = recv_frame(sock)
    if resp is None:
        raise ConnectionError("coordinator closed connection")
    parse_response(resp)
