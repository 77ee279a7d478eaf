"""Mamba2 (SSD — state space duality) block, chunked (port of the JAX
package's ``models/mamba2.py``).

Prefill uses the chunked SSD decomposition (Dao & Gu 2024): the sequence
is split into chunks of length Q; within a chunk the contribution is a
masked-decay quadratic form, and across chunks one recurrent state
[H, N, P] is carried by a loop over the chunks.  Decode is the O(1)
recurrence ``S' = a·S + dt·(B ⊗ x); y = C·S' + D_skip·x``.

Scalar-A per head (Mamba2 convention), single B/C group, depthwise causal
conv over (x, B, C) with kernel size ``conv_dim``.  The decay exponent is
masked with -inf before the ``exp``, as in the reference; softplus is
the reference's (``layers.softplus``) and the within-chunk prefix sum
adds in XLA's order (``layers.scan_cumsum``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.arch_config import ArchConfig
from repro_torch.models.layers import dense_init, scan_cumsum, softplus, \
    truncated_normal
from repro_torch.models.trips import pad, trips


class MambaCache(NamedTuple):
    conv: torch.Tensor   # [B, conv_dim - 1, di + 2N] rolling conv window
    ssd: torch.Tensor    # [B, H, N, P] recurrent state


def mamba_init(generator, cfg: ArchConfig, dtype, device="cuda") -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * n
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # projections: z (gate), x, B, C, dt
        "in_proj": dense_init(generator, d, 2 * di + 2 * n + h, dtype,
                              device),
        "conv_w": truncated_normal(generator, (cfg.conv_dim, conv_ch), dtype,
                                   0.5, device),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "dt_bias": torch.zeros((h,), **f32),
        "d_skip": torch.ones((h,), **f32),
        "out_proj": dense_init(generator, di, d, dtype, device),
        "norm_z": torch.zeros((di,), dtype=dtype, device=device),
    }


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype,
                     device="cuda") -> MambaCache:
    di, n, h, p = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                   cfg.ssm_head_dim)
    return MambaCache(
        conv=torch.zeros((batch, cfg.conv_dim - 1, di + 2 * n), dtype=dtype,
                         device=device),
        ssd=torch.zeros((batch, h, n, p), dtype=torch.float32,
                        device=device))


def _causal_conv(u, w, b, history=None):
    """Depthwise causal conv1d. u: [B, S, C]; w: [K, C].

    `history` [B, K-1, C] prepends past context (decode/prefill
    continuity).  K shifted adds, as in the reference (K is 4).
    """
    k = w.shape[0]
    if history is None:
        history = u.new_zeros((u.shape[0], k - 1, u.shape[2]))
    full = torch.cat([history, u], dim=1)
    out = torch.zeros_like(u)
    s = u.shape[1]
    for j in range(k):
        out = out + full[:, j:j + s, :] * w[j]
    return F.silu(out + b), full[:, -(k - 1):, :]


def _split_proj(cfg: ArchConfig, proj):
    di, n = cfg.d_inner, cfg.ssm_state
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * n]
    dt = proj[..., di + di + 2 * n:]
    return z, xbc, dt


def _gated_norm(z, x, scale, eps: float = 1e-6):
    """RMSNorm(x) * silu(z) — the Mamba2 output gate."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return (xf * F.silu(z.float())).to(x.dtype)


def mamba_apply(params, cfg: ArchConfig, u, *,
                cache: Optional[MambaCache] = None,
                ) -> Tuple[torch.Tensor, MambaCache]:
    """Prefill path. u: [B, S, D] with S a multiple of ssm_chunk (or
    smaller than it).  Starts from `cache` if given.  Returns (y, final
    cache)."""
    b, s, d = u.shape
    di, n, h, p = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                   cfg.ssm_head_dim)
    q = min(cfg.ssm_chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of chunk {q}")
    nc = s // q

    proj = u @ params["in_proj"]
    z, xbc, dt_raw = _split_proj(cfg, proj)
    hist = cache.conv if cache is not None else None
    xbc, conv_hist = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                  hist)
    xh = xbc[..., :di].reshape(b, s, h, p)
    bb = xbc[..., di:di + n]                     # [B, S, N]
    cc = xbc[..., di + n:]                       # [B, S, N]

    a = -torch.exp(params["a_log"])                               # [H]
    dt = softplus(dt_raw.float() + params["dt_bias"])             # [B, S, H]
    la = dt * a                                                   # log decay

    # chunked SSD
    xc = xh.reshape(b, nc, q, h, p).float()
    bc = bb.reshape(b, nc, q, n).float()
    cc_ = cc.reshape(b, nc, q, n).float()
    lac = la.reshape(b, nc, q, h)
    dtc = dt.reshape(b, nc, q, h)

    cum = scan_cumsum(lac, 2)                                     # [B,nc,Q,H]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]           # li - lj
    tri = torch.ones((q, q), dtype=torch.bool, device=u.device).tril()
    # mask the *exponent* (not the result), as the reference does
    decay = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                                  float("-inf")))

    # intra-chunk: Y[i] = sum_j C_i·B_j decay(i,j) dt_j x_j
    cb = torch.einsum("bcin,bcjn->bcij", cc_, bc)                 # [B,nc,Q,Q]
    w = cb[..., None] * decay * dtc[:, :, None, :, :]             # [..,Q,Q,H]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xc)

    # chunk-boundary states and inter-chunk recurrence
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)                  # to the end
    xdt = xc * dtc[..., None] * dec_end[..., None]                # [..,Q,H,P]
    s_chunk = torch.einsum("bcjn,bcjhp->bchnp", bc, xdt)      # [B,nc,H,N,P]
    a_chunk = torch.exp(cum[:, :, -1, :])                         # [B,nc,H]

    s_prev = (cache.ssd if cache is not None
              else torch.zeros((b, h, n, p), dtype=torch.float32,
                               device=u.device))
    s_prevs = []
    for ci in trips("ssd.chunks", nc):
        s_prevs.append(s_prev)
        s_prev = a_chunk[:, ci, :, None, None] * s_prev + s_chunk[:, ci]
    s_prevs = torch.stack(pad(s_prevs, nc), dim=1)            # [B,nc,H,N,P]

    y_inter = torch.einsum("bcin,bchnp->bcihp", cc_, s_prevs) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, s, h, p)
    y = y + params["d_skip"][None, None, :, None] * xh.float()
    y = _gated_norm(z, y.reshape(b, s, di).to(u.dtype), params["norm_z"])
    out = y @ params["out_proj"]
    conv_dtype = cache.conv.dtype if cache is not None else u.dtype
    return out, MambaCache(conv=conv_hist.to(conv_dtype), ssd=s_prev)


def mamba_decode(params, cfg: ArchConfig, u, cache: MambaCache
                 ) -> Tuple[torch.Tensor, MambaCache]:
    """O(1) decode step. u: [B, 1, D]."""
    b = u.shape[0]
    di, n, h, p = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                   cfg.ssm_head_dim)
    proj = u @ params["in_proj"]
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc, conv_hist = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                  cache.conv)
    xh = xbc[:, 0, :di].reshape(b, h, p)
    bb = xbc[:, 0, di:di + n].float()
    cc = xbc[:, 0, di + n:].float()

    a = -torch.exp(params["a_log"])
    dt = softplus(dt_raw[:, 0].float() + params["dt_bias"])      # [B, H]
    decay = torch.exp(dt * a)                                    # [B, H]

    bx = torch.einsum("bn,bhp->bhnp", bb, xh.float() * dt[..., None])
    s_new = decay[:, :, None, None] * cache.ssd + bx
    y = torch.einsum("bn,bhnp->bhp", cc, s_new)
    y = y + params["d_skip"][None, :, None] * xh.float()
    y = _gated_norm(z, y.reshape(b, 1, di).to(u.dtype), params["norm_z"])
    out = y @ params["out_proj"]
    return out, MambaCache(conv=conv_hist.to(cache.conv.dtype), ssd=s_new)
