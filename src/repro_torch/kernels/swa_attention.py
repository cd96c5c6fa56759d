"""CUDA wrapper of the sliding-window decode attention.

Counterpart of ``repro/kernels/swa_attention.py``.  The JAX kernel holds
one (batch, kv-head) window of K and V in VMEM and takes ``window`` as a
required int; the port's kernel (``csrc/swa_decode.cu``) splits T across
the blocks of a thread-block cluster, stages K and V through shared
memory with ``cp.async`` and merges the blocks' online-softmax states
through distributed shared memory in one launch, so any T fits, and
takes ``window=None`` for plain causal decode as
``layers.decode_attention`` does.  It computes what ``decode_attention``
computes (the function on the path): ``q·scale`` first, the fp32 dot
with K, masked scores set to the finite ``-1e30``, an fp32 softmax and
``p·V`` in fp32, cast to q's dtype.  The plain version is
:func:`repro_torch.kernels.ref.swa_attention_decode`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ._build import launch, library
from .quantize import check_cuda

#: Widest head the kernel takes (each lane holds up to 8 of its dims).
MAX_HEAD_DIM = 256
#: Blocks of a cluster that share one (sequence, kv head)'s slots, and
#: warps per block (fewer where a wide row's ring would not fit in shared
#: memory); chosen from a sweep on the H100 (``tools/swa_sweep.py``).
#: Where CLUSTER blocks per (sequence, kv head) would not give every SM a
#: block (a batch of one), the kernel takes the largest cluster instead.
CLUSTER = 8
MAX_CLUSTER = 16
WARPS = 4


def swa_attention_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_pos: torch.Tensor, kv_valid: torch.Tensor,
                         q_pos: torch.Tensor, *, window: int | None
                         ) -> torch.Tensor:
    """q (B, H, dh); k/v (B, T, Hkv, dh), all bf16 or all fp32 on the
    card; kv_pos int32 and kv_valid bool (B, T); q_pos int32 (B,) →
    (B, H, dh) in q's dtype.  A cluster of :func:`default_cluster` blocks
    of WARPS warps shares each (sequence, kv head)'s slots."""
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    check_cuda(q, q.dtype, "q", 3)
    check_cuda(k, q.dtype, "k", 4)
    check_cuda(v, q.dtype, "v", 4)
    B, H, dh = q.shape
    _, T, Hkv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != dh or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} outside [1, {MAX_HEAD_DIM}]")
    if T == 0:
        raise ValueError("an empty cache has nothing to attend to")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid's 65535 rows")
    check_cuda(kv_pos, torch.int32, "kv_pos", 2)
    check_cuda(kv_valid, torch.bool, "kv_valid", 2)
    check_cuda(q_pos, torch.int32, "q_pos", 1)
    if kv_pos.shape != (B, T) or kv_valid.shape != (B, T) \
            or q_pos.shape != (B,):
        raise ValueError(f"positions {tuple(kv_pos.shape)}, validity "
                         f"{tuple(kv_valid.shape)} and q_pos "
                         f"{tuple(q_pos.shape)} for a ({B}, {T}) cache")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    launch("swa_attention_decode", "swa_decode", q, k, v, kv_pos, kv_valid,
           q_pos, B, T, Hkv, H // Hkv, dh,
           -1 if window is None else int(window),
           int(q.dtype == torch.bfloat16), default_cluster(B * Hkv, q.device),
           WARPS, float(1.0 / np.sqrt(dh)), out)
    return out


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def default_cluster(pairs: int, device: torch.device) -> int:
    """The cluster size for ``pairs`` (sequence, kv head) pairs: CLUSTER,
    or MAX_CLUSTER where CLUSTER would leave SMs of the card without a
    block."""
    return CLUSTER if pairs * CLUSTER >= _sm_count(device) else MAX_CLUSTER


def kernel_info(dtype: torch.dtype, dh: int, groups: int) -> dict[str, int]:
    """What the card compiled for the variant that a launch at (dtype,
    dh, groups) takes: registers per thread, static and dynamic shared
    bytes per block, local (spilled) bytes per thread and warps per
    block.  Builds the library if needed; launches nothing."""
    fn = library("swa_decode").swa_decode_info
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 5)()
    code = fn(int(dtype == torch.bfloat16), dh, groups, WARPS, info)
    if code != 0:
        raise RuntimeError(f"swa_decode_info failed: CUDA error {code}")
    return dict(zip(("registers", "static_smem", "local_bytes", "warps",
                     "dynamic_smem"), info))
