"""Length-prefixed binary wire protocol for the embedding server.

Port of ``repro/exchange/wire.py``: the same frames, byte for byte, so a
port process and a JAX process speak to each other.  One frame per RPC,
in both directions::

    uint32 LE body length | body

Request body: ``uint8 opcode`` + opcode-specific payload.  Response
body: ``uint8 status`` (0 ok / 1 error) + payload (UTF-8 message on
error).  All integers little-endian; all arrays C-order raw bytes.

The embedding payload blocks are the codec wire format itself, the
exact bytes :meth:`NetworkModel.embedding_bytes` charges for:

    fp32 — n·hidden·4 B            (raw float32 rows)
    fp16 — n·hidden·2 B            (raw float16 rows)
    int8 — n·hidden·1 B + n·4 B    (int8 rows + per-row fp32 scales)

Frame headers, opcodes and vertex-id vectors are not payload: the
analytic model folds them into ``rpc_overhead_s``.

The blocks carry the bytes of device tensors.  Building a block copies
it from the device to the host once (the int8 values and scales are
joined on the device first); parsing one copies it to the device once
(:func:`repro_torch.kernels.ops.host_to_device`).

The opcodes keep the JAX values under ``PT_OP_*`` names: a second
module defining ``OP_*`` names would shadow the JAX plane's (the
analyzer's WP006), and a test holds every value equal to the JAX one.
Opcodes 1–15 belong to this plane, 14/15 being the telemetry scrapes
every plane answers (:mod:`repro_torch.obsv.teleserve`).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from repro_torch.kernels import ops

# -- opcodes / status ---------------------------------------------------------

PT_OP_REGISTER = 1
PT_OP_WRITE = 2
PT_OP_GATHER = 3
PT_OP_EMBED_STATS = 4
PT_OP_EMBED_SHUTDOWN = 5
PT_OP_VGATHER = 6       # conditional gather: versions always, rows if stale
PT_OP_METRICS = 14      # → JSON metrics-registry snapshot + clock handshake
PT_OP_TRACE = 15        # → JSON trace-ring snapshot + clock handshake

STATUS_OK = 0
STATUS_ERR = 1

CODEC_IDS = {"fp32": 0, "fp16": 1, "int8": 2}
CODEC_NAMES = {v: k for k, v in CODEC_IDS.items()}

_LEN = struct.Struct("<I")
_U8 = struct.Struct("<B")
_U16 = struct.Struct("<H")
_U64 = struct.Struct("<Q")
_STATS = struct.Struct("<IIQQ")        # num_layers, hidden, rows, mem_bytes

MAX_FRAME = 1 << 30                    # 1 GiB sanity bound per frame


# -- codec payload blocks -----------------------------------------------------

def payload_nbytes(codec: str, n: int, hidden: int) -> int:
    """Wire bytes of one (n, hidden) layer block for ``codec``."""
    if codec == "fp32":
        return n * hidden * 4
    if codec == "fp16":
        return n * hidden * 2
    if codec == "int8":
        return n * hidden + n * 4
    raise ValueError(f"unknown wire codec {codec!r}")


def _raw(t, dtype: torch.dtype) -> torch.Tensor:
    """``t`` (a tensor or an array) as a flat contiguous uint8 tensor of
    its ``dtype`` bytes, on the device it lies on."""
    t = torch.as_tensor(t).to(dtype).contiguous()
    if t.numel() == 0:                 # an empty view has no unit stride
        return torch.empty(0, dtype=torch.uint8, device=t.device)
    return t.reshape(-1).view(torch.uint8)


def encode_block(codec: str, payload) -> bytes:
    """Codec payload (``WireCodec.encode`` output) → wire bytes, with one
    device-to-host copy."""
    if codec == "fp32":
        raw = _raw(payload, torch.float32)
    elif codec == "fp16":
        raw = _raw(payload, torch.float16)
    elif codec == "int8":
        values, scales = payload
        raw = torch.cat([_raw(values, torch.int8),
                         _raw(scales, torch.float32)])
    else:
        raise ValueError(f"unknown wire codec {codec!r}")
    return raw.cpu().numpy().tobytes()


def decode_block(codec: str, buf, n: int, hidden: int, device="cuda"):
    """Wire bytes → codec payload (``WireCodec.decode`` input) on
    ``device``, with one host-to-device copy."""
    if n * hidden == 0:
        empty = [torch.empty((n, w), dtype=dt, device=device) for dt, w in (
            ({"fp32": torch.float32, "fp16": torch.float16}.get(
                codec, torch.int8), hidden), (torch.float32, 1))]
        return tuple(empty) if codec == "int8" else empty[0]
    host = np.frombuffer(buf, np.uint8, payload_nbytes(codec, n, hidden))
    if not host.flags.writeable:       # torch takes only writable arrays
        host = host.copy()
    raw = ops.host_to_device(host, device)
    if codec == "fp32":
        return raw.view(torch.float32).reshape(n, hidden)
    if codec == "fp16":
        return raw.view(torch.float16).reshape(n, hidden)
    values = raw[: n * hidden].view(torch.int8).reshape(n, hidden)
    scales = raw[n * hidden:]
    if (n * hidden) % 4:               # a float view needs 4-byte alignment
        scales = scales.clone()
    return values, scales.view(torch.float32).reshape(n, 1)


# -- framing ------------------------------------------------------------------

def recv_exact(sock, n: int) -> bytearray:
    """Read exactly n bytes into one writable buffer; raises
    ConnectionError on EOF mid-message."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(n - got, 1 << 20))
        if not k:
            raise ConnectionError(
                f"peer closed mid-frame ({got}/{n} bytes)")
        got += k
    return buf


def send_frame(sock, body: bytes) -> None:
    sock.sendall(_LEN.pack(len(body)) + body)


def recv_frame(sock) -> bytearray | None:
    """One framed body, or None on a clean EOF at a frame boundary."""
    hdr = b""
    while len(hdr) < _LEN.size:
        chunk = sock.recv(_LEN.size - len(hdr))
        if not chunk:
            if hdr:
                raise ConnectionError("peer closed mid-header")
            return None
        hdr += chunk
    (length,) = _LEN.unpack(hdr)
    if length > MAX_FRAME:
        raise ConnectionError(f"frame of {length} bytes exceeds MAX_FRAME")
    return recv_exact(sock, length)


def frame_nbytes(body_len: int) -> int:
    return _LEN.size + body_len


# -- tensor lists -------------------------------------------------------------
#
# dtype/shape-tagged array framing of the federated control plane
# (repro_torch.fedsvc.protocol): model leaves travel as host arrays with
# their own headers, since the coordinator infers no shapes.

def build_tensors(arrays) -> bytes:
    """[np.ndarray] → self-describing wire bytes (dtype, shape, raw)."""
    out = [_U16.pack(len(arrays))]
    for a in arrays:
        a = np.asarray(a)
        if a.ndim:                 # ascontiguousarray promotes 0-d to 1-d
            a = np.ascontiguousarray(a)
        dt = a.dtype.str.encode("ascii")            # e.g. b'<f4'
        out.append(_U8.pack(len(dt)) + dt)
        out.append(_U8.pack(a.ndim))
        out.extend(_U64.pack(d) for d in a.shape)
        out.append(a.tobytes())
    return b"".join(out)


def parse_tensors(view: memoryview, offset: int = 0
                  ) -> tuple[list[np.ndarray], int]:
    """Wire bytes → ([arrays], next offset).  Arrays are copies: they
    outlive the frame buffer."""
    (count,) = _U16.unpack_from(view, offset)
    offset += _U16.size
    out = []
    for _ in range(count):
        (dlen,) = _U8.unpack_from(view, offset)
        offset += _U8.size
        dtype = np.dtype(bytes(view[offset:offset + dlen]).decode("ascii"))
        offset += dlen
        (ndim,) = _U8.unpack_from(view, offset)
        offset += _U8.size
        shape = []
        for _ in range(ndim):
            (d,) = _U64.unpack_from(view, offset)
            shape.append(d)
            offset += _U64.size
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize \
            if shape else dtype.itemsize
        a = np.frombuffer(view, dtype, nbytes // dtype.itemsize,
                          offset=offset).reshape(shape).copy()
        offset += nbytes
        out.append(a)
    return out, offset


def tensors_nbytes(arrays) -> int:
    """Wire size of :func:`build_tensors` output (headers included)."""
    total = _U16.size
    for a in arrays:
        a = np.asarray(a)
        total += _U8.size + len(a.dtype.str) + _U8.size \
            + _U64.size * a.ndim + a.nbytes
    return total


# -- requests (client side) -------------------------------------------------

def _gid_bytes(global_ids: np.ndarray) -> bytes:
    return np.ascontiguousarray(global_ids, np.int64).tobytes()


def build_register(global_ids: np.ndarray) -> bytes:
    return (_U8.pack(PT_OP_REGISTER) + _U64.pack(len(global_ids))
            + _gid_bytes(global_ids))


def build_write(codec: str, global_ids: np.ndarray,
                blocks: list[bytes]) -> bytes:
    head = (_U8.pack(PT_OP_WRITE) + _U8.pack(CODEC_IDS[codec])
            + _U16.pack(len(blocks)) + _U64.pack(len(global_ids))
            + _gid_bytes(global_ids))
    return head + b"".join(blocks)


def build_gather(codec: str, global_ids: np.ndarray,
                 layers: list[int]) -> bytes:
    return (_U8.pack(PT_OP_GATHER) + _U8.pack(CODEC_IDS[codec])
            + _U16.pack(len(layers))
            + b"".join(_U16.pack(l) for l in layers)
            + _U64.pack(len(global_ids)) + _gid_bytes(global_ids))


def build_vgather(codec: str, global_ids: np.ndarray,
                  have_versions: np.ndarray, layers: list[int]) -> bytes:
    """Conditional gather: ``have_versions[i]`` is the client's cached
    version for ``global_ids[i]`` (-1 = never seen).  The response is
    ``n×int64`` current versions followed by codec blocks holding rows
    only for positions whose version differs — both ends recompute the
    stale set from the version vectors, so it is never sent."""
    if len(have_versions) != len(global_ids):
        raise ValueError(f"{len(have_versions)} versions for "
                         f"{len(global_ids)} ids")
    return (_U8.pack(PT_OP_VGATHER) + _U8.pack(CODEC_IDS[codec])
            + _U16.pack(len(layers))
            + b"".join(_U16.pack(l) for l in layers)
            + _U64.pack(len(global_ids)) + _gid_bytes(global_ids)
            + np.ascontiguousarray(have_versions, np.int64).tobytes())


def build_stats() -> bytes:
    return _U8.pack(PT_OP_EMBED_STATS)


def build_shutdown() -> bytes:
    return _U8.pack(PT_OP_EMBED_SHUTDOWN)


# -- request parsing (server side) --------------------------------------------

def _layer_list(view: memoryview) -> tuple[list[int], int]:
    (nsel,) = _U16.unpack_from(view, 2)
    layers = [_U16.unpack_from(view, 4 + 2 * i)[0] for i in range(nsel)]
    return layers, 4 + 2 * nsel


def parse_request(body) -> tuple[int, dict]:
    """→ (opcode, fields).  Payload blocks stay as a memoryview tail so
    the server decodes them against its own (num_layers, hidden)."""
    view = memoryview(body)
    (op,) = _U8.unpack_from(view, 0)
    if op == PT_OP_REGISTER:
        (n,) = _U64.unpack_from(view, 1)
        gids = np.frombuffer(view, np.int64, n, offset=1 + _U64.size)
        return op, {"global_ids": gids}
    if op == PT_OP_WRITE:
        (codec_id,) = _U8.unpack_from(view, 1)
        (layers,) = _U16.unpack_from(view, 2)
        (n,) = _U64.unpack_from(view, 4)
        off = 4 + _U64.size
        gids = np.frombuffer(view, np.int64, n, offset=off)
        off += n * 8
        return op, {"codec": CODEC_NAMES[codec_id], "num_blocks": layers,
                    "global_ids": gids, "payload": view[off:]}
    if op in (PT_OP_GATHER, PT_OP_VGATHER):
        (codec_id,) = _U8.unpack_from(view, 1)
        layers, off = _layer_list(view)
        (n,) = _U64.unpack_from(view, off)
        off += _U64.size
        gids = np.frombuffer(view, np.int64, n, offset=off)
        req = {"codec": CODEC_NAMES[codec_id], "layers": layers,
               "global_ids": gids}
        if op == PT_OP_VGATHER:
            req["have_versions"] = np.frombuffer(view, np.int64, n,
                                                 offset=off + n * 8)
        return op, req
    if op in (PT_OP_EMBED_STATS, PT_OP_EMBED_SHUTDOWN):
        return op, {}
    raise ValueError(f"unknown opcode {op}")


# -- responses ----------------------------------------------------------------

def build_ok(payload: bytes = b"") -> bytes:
    return _U8.pack(STATUS_OK) + payload


def build_err(message: str) -> bytes:
    return _U8.pack(STATUS_ERR) + message.encode("utf-8", "replace")


def build_stats_payload(num_layers: int, hidden: int, rows: int,
                        memory_bytes: int) -> bytes:
    return _STATS.pack(num_layers, hidden, rows, memory_bytes)


def parse_stats_payload(payload) -> dict:
    num_layers, hidden, rows, mem = _STATS.unpack(payload)
    return {"num_layers": num_layers, "hidden": hidden,
            "rows": rows, "memory_bytes": mem}


def parse_response(body) -> memoryview:
    """→ response payload; raises RuntimeError on an error status."""
    view = memoryview(body)
    (status,) = _U8.unpack_from(view, 0)
    if status == STATUS_OK:
        return view[1:]
    raise RuntimeError(bytes(view[1:]).decode("utf-8", "replace"))
