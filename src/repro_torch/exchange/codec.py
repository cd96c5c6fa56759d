"""Wire codecs for remote-embedding exchange, on torch tensors.

Port of the row codecs of ``repro/exchange/codec.py``.  A codec defines
what an (n, hidden) fp32 block of embedding rows looks like on the wire:
its encoded payload, the fp32 values the receiver reconstructs, and the
effective bytes per scalar the NetworkModel charges.  All codecs are
row-independent and deterministic, so splitting rows across servers
never changes what the receiver reconstructs.

Payloads stay on the device of their input: on the card the int8 codec
runs the hand-written encode/decode kernels.  :func:`encode_leaves` /
:func:`decode_leaves` are the weight wire's leaf-list form.

Codecs:
  fp32 — passthrough, 4 B/scalar
  fp16 — IEEE half precision, 2 B/scalar
  int8 — per-row symmetric quantization, 1 B/scalar plus an amortized
         4 B/row fp32 scale; max abs error ≤ row absmax / 254
"""

from __future__ import annotations

import abc

import numpy as np
import torch

from repro_torch.kernels import ops


class WireCodec(abc.ABC):
    """Encode/decode one (n, hidden) fp32 layer block for the wire."""

    name: str = "?"
    wire_arrays: int = 1       # tensors per encoded block (int8: values+scales)

    @abc.abstractmethod
    def encode(self, x: torch.Tensor):
        """fp32 (n, hidden) → wire payload (codec-specific)."""

    @abc.abstractmethod
    def decode(self, payload) -> torch.Tensor:
        """wire payload → fp32 (n, hidden) as reconstructed by the
        receiver."""

    @abc.abstractmethod
    def bytes_per_scalar(self, hidden: int) -> float:
        """Effective wire bytes per fp32 scalar (row overheads amortized
        over ``hidden``) — drives NetworkModel byte accounting."""

    def roundtrip(self, x: torch.Tensor) -> torch.Tensor:
        """The values the far side sees after one wire crossing."""
        return self.decode(self.encode(x))

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class Fp32Codec(WireCodec):
    """Raw fp32 rows, lossless."""

    name = "fp32"

    def encode(self, x):
        return x.to(torch.float32)

    def decode(self, payload):
        return payload

    def bytes_per_scalar(self, hidden: int) -> float:
        return 4.0


class Fp16Codec(WireCodec):
    """IEEE half-precision rows: 2 B/scalar, exact on fp16-representable
    values, relative error ≤ 2^-11 otherwise."""

    name = "fp16"

    def encode(self, x):
        return x.to(torch.float16)

    def decode(self, payload):
        return payload.to(torch.float32)

    def bytes_per_scalar(self, hidden: int) -> float:
        return 2.0


class Int8Codec(WireCodec):
    """Per-row symmetric int8 quantization (scale = row absmax / 127)."""

    name = "int8"
    wire_arrays = 2

    def encode(self, x):
        return ops.quantize_int8(x.to(torch.float32).contiguous())

    def decode(self, payload):
        values, scales = payload
        return ops.dequantize_int8(values.contiguous(), scales.contiguous())

    def bytes_per_scalar(self, hidden: int) -> float:
        return 1.0 + 4.0 / hidden          # int8 row + one fp32 scale


_CODECS = {
    "fp32": Fp32Codec,
    "fp16": Fp16Codec,
    "int8": Int8Codec,
}


def available_codecs() -> list[str]:
    return sorted(_CODECS)


def get_codec(name: str | WireCodec) -> WireCodec:
    """Resolve a codec by name or pass one through."""
    if isinstance(name, WireCodec):
        return name
    try:
        return _CODECS[name]()
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r}; available: {available_codecs()}"
        ) from None


# -- leaf-list form (the weight wire) -----------------------------------------
#
# The federated weight plane moves flat leaf lists whose shapes vary per
# leaf, so each leaf is flattened to a single (1, size) row and run
# through the same codec: for int8 one scale per leaf.  The codec runs
# on ``device`` (on the card the int8 encode and decode kernels); the
# wire tensors and the decoded leaves are host arrays that ride the
# control plane's ``wire.build_tensors`` framing, as in the JAX package.

def encode_leaves(codec: str | WireCodec, leaves, *, device: str = "cuda"
                  ) -> tuple[list, list]:
    """fp32 leaf list → (wire tensors, shapes).

    ``shapes`` travel beside the tensors (the JSON header of a
    control-plane RPC) so :func:`decode_leaves` can restore the leaf
    shapes; the tensor list holds ``codec.wire_arrays`` arrays per leaf
    in leaf order."""
    codec = get_codec(codec)
    tensors: list = []
    shapes: list[list[int]] = []
    for leaf in leaves:
        leaf = np.asarray(leaf, np.float32)
        shapes.append([int(d) for d in leaf.shape])
        row = ops.host_to_device(leaf.reshape(1, -1), device)
        payload = codec.encode(row)
        parts = payload if isinstance(payload, tuple) else (payload,)
        tensors.extend(p.cpu().numpy() for p in parts)
    return tensors, shapes


def decode_leaves(codec: str | WireCodec, tensors, shapes, *,
                  device: str = "cuda") -> list[np.ndarray]:
    """Inverse of :func:`encode_leaves`: the fp32 leaves the receiver
    reconstructs (bit-identical to the sender's local round trip —
    codecs are deterministic)."""
    codec = get_codec(codec)
    per = codec.wire_arrays
    if len(tensors) != per * len(shapes):
        raise ValueError(
            f"{codec.name} leaf payload carries {len(tensors)} arrays "
            f"for {len(shapes)} leaves (expected {per} per leaf)")
    out = []
    for i, shape in enumerate(shapes):
        block = [ops.host_to_device(np.asarray(t), device)
                 for t in tensors[per * i: per * (i + 1)]]
        payload = tuple(block) if per > 1 else block[0]
        out.append(codec.decode(payload).cpu().numpy()
                   .astype(np.float32, copy=False).reshape(shape))
    return out
