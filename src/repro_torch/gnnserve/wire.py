"""Scoring-frontend wire format, on the port's exchange framing.

Port of ``repro/gnnserve/wire.py``: the same frames, byte for byte, so a
JAX client queries a port frontend and the reverse.  It reuses the
exchange plane's length-prefixed frames, status bytes and struct helpers
(:mod:`repro_torch.exchange.wire`); the serving opcodes live at 32+ so
the dispatch tables never collide (the embedding plane owns 1..15, the
federated control plane 16..31).  Shutdown is the exchange plane's
``PT_OP_EMBED_SHUTDOWN``: same semantics, same byte.

    PT_OP_PREDICT  request:  u8 op | u64 n | n×i64 vids | n×f32 thresholds
                   response: ok | u64 n | n×i32 preds | n×f32 confs
                                  | n×i32 exit depths
    PT_OP_SSTATS   request:  u8 op
                   response: ok | UTF-8 JSON stats blob

The opcodes keep the JAX values under ``PT_OP_*`` names: a second
module defining ``OP_*`` names would shadow the JAX plane's (the
analyzer's WP006), and a test holds every value equal to the JAX one.
"""

from __future__ import annotations

import json

import numpy as np

from repro_torch.exchange.wire import (  # noqa: F401  (re-exported)
    _U8, _U64, PT_OP_EMBED_SHUTDOWN, build_err, build_ok, parse_response,
    recv_frame, send_frame,
)

PT_OP_PREDICT = 32
PT_OP_SSTATS = 33


def build_predict(vids: np.ndarray, thresholds: np.ndarray) -> bytes:
    assert len(vids) == len(thresholds)
    return (_U8.pack(PT_OP_PREDICT) + _U64.pack(len(vids))
            + np.ascontiguousarray(vids, np.int64).tobytes()
            + np.ascontiguousarray(thresholds, np.float32).tobytes())


def build_sstats() -> bytes:
    return _U8.pack(PT_OP_SSTATS)


def build_shutdown() -> bytes:
    return _U8.pack(PT_OP_EMBED_SHUTDOWN)


def parse_serve_request(body: bytes) -> tuple[int, dict]:
    view = memoryview(body)
    (op,) = _U8.unpack_from(view, 0)
    if op == PT_OP_PREDICT:
        (n,) = _U64.unpack_from(view, 1)
        off = 1 + _U64.size
        vids = np.frombuffer(view, np.int64, n, offset=off)
        thr = np.frombuffer(view, np.float32, n, offset=off + 8 * n)
        return op, {"vids": vids, "thresholds": thr}
    if op in (PT_OP_SSTATS, PT_OP_EMBED_SHUTDOWN):
        return op, {}
    raise ValueError(f"unknown serving opcode {op}")


def build_predict_payload(preds: np.ndarray, confs: np.ndarray,
                          depths: np.ndarray) -> bytes:
    return (_U64.pack(len(preds))
            + np.ascontiguousarray(preds, np.int32).tobytes()
            + np.ascontiguousarray(confs, np.float32).tobytes()
            + np.ascontiguousarray(depths, np.int32).tobytes())


def parse_predict_payload(payload) -> tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
    view = memoryview(payload)
    (n,) = _U64.unpack_from(view, 0)
    off = _U64.size
    preds = np.frombuffer(view, np.int32, n, offset=off).copy()
    confs = np.frombuffer(view, np.float32, n, offset=off + 4 * n).copy()
    depths = np.frombuffer(view, np.int32, n, offset=off + 8 * n).copy()
    return preds, confs, depths


def build_stats_payload(stats: dict) -> bytes:
    return json.dumps(stats).encode("utf-8")


def parse_stats_payload(payload) -> dict:
    return json.loads(bytes(payload).decode("utf-8"))
