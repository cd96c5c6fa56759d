"""Mamba2 SSD (state-space duality) blocks. [arXiv:2405.21060]

Counterpart of ``repro/models/ssm.py``.  Prefill runs the chunked dual
form: a quadratic, attention-like product inside chunks of
``cfg.ssm_chunk`` tokens and a linear recurrence across chunks carrying
the (B, H, P, N) state.  Decode is the O(1) recurrent update, which
writes the layer's cache in place.

The projections are kept apart as in the JAX package (``in_zx``,
``in_BC``, ``in_dt``).  ``A_log``, ``D`` and ``dt_bias`` and the
recurrent state are fp32 whatever the config's dtype.  The JAX
package's three- and four-operand einsums are spelled out as pairwise
products here, so no (B, nc, Q, Q, H, P) intermediate forms.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

from .layers import const_like, dense_init, gated_rms_norm, pad_dim


def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(d_inner, SSD heads, conv channels)."""
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    conv_ch = d_in + 2 * cfg.ssm_state
    return d_in, nheads, conv_ch


def ssm_shapes(cfg: ModelConfig) -> dict:
    """Leaf shapes of :func:`init_ssm`'s tree."""
    D = cfg.d_model
    d_in, H, _ = ssm_dims(cfg)
    N, W = cfg.ssm_state, cfg.ssm_conv_width
    return {"in_zx": (D, 2 * d_in), "in_BC": (D, 2 * N), "in_dt": (D, H),
            "conv_x": (W, d_in), "conv_x_b": (d_in,), "conv_BC": (W, 2 * N),
            "conv_BC_b": (2 * N,), "A_log": (H,), "D": (H,),
            "dt_bias": (H,), "norm_w": (d_in,), "out_proj": (d_in, D)}


def init_ssm(cfg: ModelConfig, *, generator: torch.Generator | None = None,
             device: str = "cuda") -> dict:
    """Seeded projections (normal/sqrt(fan in)) and conv taps
    (normal·0.5); conv biases zeros; A_log 0, D 1, dt_bias −2 in fp32;
    the norm's weight ones."""
    gen = generator if generator is not None \
        else torch.Generator(device=device).manual_seed(0)
    s = ssm_shapes(cfg)
    dt = cfg.dtype

    def init(k, scale=None):
        return dense_init(s[k], dt, generator=gen, device=device,
                          scale=scale)

    def full(k, value, dtype):
        return torch.full(s[k], value, dtype=dtype, device=device)

    return {"in_zx": init("in_zx"), "in_BC": init("in_BC"),
            "in_dt": init("in_dt"), "conv_x": init("conv_x", 0.5),
            "conv_x_b": full("conv_x_b", 0.0, dt),
            "conv_BC": init("conv_BC", 0.5),
            "conv_BC_b": full("conv_BC_b", 0.0, dt),
            "A_log": full("A_log", 0.0, torch.float32),
            "D": full("D", 1.0, torch.float32),
            "dt_bias": full("dt_bias", -2.0, torch.float32),
            "norm_w": full("norm_w", 1.0, dt), "out_proj": init("out_proj")}


def _causal_conv(x: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of width W, then SiLU.  x: (B, S, CH)."""
    W, S = conv_w.shape[0], x.shape[1]
    pad = pad_dim(x, 1, W - 1, 0)
    out = pad[:, 0:S] * conv_w[0]
    for i in range(1, W):
        out = out + pad[:, i: i + S] * conv_w[i]
    return F.silu(out + conv_b)


def _segsum_decay(dA_chunk: torch.Tensor) -> torch.Tensor:
    """exp(cumsum difference), lower triangular.  dA_chunk: (..., Q, H)
    → (..., Qi, Qj, H)."""
    Q = dA_chunk.shape[-2]
    cs = torch.cumsum(dA_chunk, dim=-2)
    diff = cs[..., :, None, :] - cs[..., None, :, :]
    tri = const_like(dA_chunk, torch.tril(torch.ones(
        (Q, Q), dtype=torch.bool, device=dA_chunk.device)))
    return torch.exp(torch.where(tri[..., None], diff, float("-inf")))


def ssd_scan(cfg: ModelConfig, xs: torch.Tensor, dt: torch.Tensor,
             Bc: torch.Tensor, Cc: torch.Tensor, A: torch.Tensor,
             D_skip: torch.Tensor, init_state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  xs: (B, S, H, P); dt: (B, S, H) fp32; Bc / Cc:
    (B, S, N) fp32.  Returns (y (B, S, H, P) in xs's dtype, final state
    (B, H, P, N) fp32)."""
    B_, S, H, P = xs.shape
    N = Bc.shape[-1]
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {Q}")
    nc = S // Q
    f32 = torch.float32

    dA = dt * A                                          # (B, S, H) < 0
    x32 = xs.to(f32).reshape(B_, nc, Q, H, P)
    dt_c = dt.reshape(B_, nc, Q, H)
    dA_c = dA.reshape(B_, nc, Q, H)
    B_c = Bc.reshape(B_, nc, Q, N)
    C_c = Cc.reshape(B_, nc, Q, N)
    u = (dt_c[..., None] * x32).permute(0, 1, 3, 2, 4)   # (B,nc,H,Q,P)

    # intra-chunk (dual, attention-like) term: per head, scores (Qi × Qj)
    # times dt·x (Qj × P)
    decay = _segsum_decay(dA_c)                          # (B,nc,Qi,Qj,H)
    scores = (C_c @ B_c.transpose(-1, -2))[..., None] * decay
    y_intra = (scores.permute(0, 1, 4, 2, 3) @ u)        # (B,nc,H,Qi,P)

    # chunk-final states: (decay_to_end·dt·x)ᵀ B over the chunk's tokens
    cum = torch.cumsum(dA_c, dim=2)                      # (B,nc,Q,H)
    total = cum[:, :, -1:]                               # (B,nc,1,H)
    w = torch.exp(total - cum).permute(0, 1, 3, 2)[..., None]  # (..,Q,1)
    chunk_states = (w * u).transpose(-1, -2) @ B_c[:, :, None]  # (..,P,N)

    # inter-chunk recurrence
    chunk_decay = torch.exp(total[:, :, 0])              # (B, nc, H)
    state = torch.zeros_like(chunk_states[:, 0]) \
        if init_state is None else init_state.to(f32)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)               # (B,nc,H,P,N)

    # inter-chunk term: C · previous state, scaled by exp(cum)
    y_inter = (C_c[:, :, None] @ prev_states.transpose(-1, -2)) \
        * torch.exp(cum).permute(0, 1, 3, 2)[..., None]  # (B,nc,H,Q,P)
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(B_, S, H, P)
    y = y + D_skip[None, None, :, None] * xs
    return y.to(xs.dtype), state


def ssm_forward(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                init_state: torch.Tensor | None = None):
    """Full-sequence Mamba2 block.  x: (B, S, D) → (y, ((conv tail of x,
    conv tail of BC), final state)); the tails are the raw (pre-conv)
    last W − 1 rows a decode cache carries."""
    d_in, H, _ = ssm_dims(cfg)
    P, N, W = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv_width
    Bsz, S, _ = x.shape
    z, xs_raw = torch.split(x @ p["in_zx"], [d_in, d_in], dim=-1)
    BC_raw = x @ p["in_BC"]
    dt = x @ p["in_dt"]
    xs = _causal_conv(xs_raw, p["conv_x"], p["conv_x_b"])
    BC = _causal_conv(BC_raw, p["conv_BC"], p["conv_BC_b"])
    Bc, Cc = torch.split(BC, [N, N], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, state = ssd_scan(cfg, xs.reshape(Bsz, S, H, P), dt,
                        Bc.to(torch.float32), Cc.to(torch.float32), A,
                        p["D"], init_state=init_state)
    y = gated_rms_norm(y.reshape(Bsz, S, d_in), z, p["norm_w"],
                       cfg.norm_eps)
    tails = (xs_raw[:, -(W - 1):], BC_raw[:, -(W - 1):]) if W > 1 else (
        x.new_zeros((Bsz, 0, d_in)), x.new_zeros((Bsz, 0, 2 * N)))
    return y @ p["out_proj"], (tails, state)


def _conv_step(window: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """einsum("bwc,wc->bc") over the conv window, summed in fp32 and
    rounded once, then the bias and SiLU."""
    out = (window.to(torch.float32) * w.to(torch.float32)).sum(dim=1)
    return F.silu(out.to(window.dtype) + b)


def ssm_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
               cache: dict) -> tuple[torch.Tensor, dict]:
    """Single-token recurrent update.  x: (B, 1, D); cache: {"conv_x":
    (B, W−1, d_in), "conv_BC": (B, W−1, 2N), "state": (B, H, P, N)},
    updated in place.  Returns (y, cache)."""
    d_in, H, _ = ssm_dims(cfg)
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    Bsz = x.shape[0]
    z, xs = torch.split(x[:, 0] @ p["in_zx"], [d_in, d_in], dim=-1)
    BC = x[:, 0] @ p["in_BC"]
    dt = x[:, 0] @ p["in_dt"]

    wx = torch.cat([cache["conv_x"], xs[:, None]], dim=1)
    xs = _conv_step(wx, p["conv_x"], p["conv_x_b"])
    wbc = torch.cat([cache["conv_BC"], BC[:, None]], dim=1)
    Bc, Cc = torch.split(_conv_step(wbc, p["conv_BC"], p["conv_BC_b"]),
                         [N, N], dim=-1)

    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])    # (B, H)
    dA = torch.exp(dt * -torch.exp(p["A_log"]))
    xh = xs.reshape(Bsz, H, P).to(torch.float32)
    state = cache["state"] * dA[:, :, None, None] \
        + dt[:, :, None, None] * xh[..., None] * Bc[:, None, None, :]
    y = (state @ Cc.to(torch.float32)[:, None, :, None])[..., 0]
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(Bsz, 1, d_in).to(x.dtype)
    y = gated_rms_norm(y, z[:, None], p["norm_w"], cfg.norm_eps)
    cache["conv_x"].copy_(wx[:, 1:])
    cache["conv_BC"].copy_(wbc[:, 1:])
    cache["state"].copy_(state)
    return y @ p["out_proj"], cache


def init_ssm_cache(cfg: ModelConfig, batch: int, *,
                   device: str = "cuda") -> dict:
    """Zero conv windows (the config's dtype) and an fp32 zero state."""
    d_in, H, _ = ssm_dims(cfg)
    W = cfg.ssm_conv_width
    return {
        "conv_x": torch.zeros((batch, W - 1, d_in), dtype=cfg.dtype,
                              device=device),
        "conv_BC": torch.zeros((batch, W - 1, 2 * cfg.ssm_state),
                               dtype=cfg.dtype, device=device),
        "state": torch.zeros((batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                             dtype=torch.float32, device=device),
    }
