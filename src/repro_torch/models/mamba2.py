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

Under a data row's tensor parallelism (``dist.sharding.Blocks``
parameters) each position projects its columns of ``in_proj``; its
blocks cut across the z | xBC | dt fields, so the row gathers the
projection on its home, which runs the conv and the gates.  Position j
then runs the SSD for its heads (``even_bounds``) and its share of the
C·B products (the state dim split, partial products summed, as GSPMD
splits it), and the row's gated norm feeds ``out_proj``'s row blocks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import even_bounds, home, row_split
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

    tp = row_split(params["in_proj"])
    z, xbc, dt_raw = _split_proj(cfg, _in_proj(params, u))
    hist = cache.conv if cache is not None else None
    xbc, conv_hist = _causal_conv(xbc, home(params["conv_w"]),
                                  home(params["conv_b"]), hist)
    xh = xbc[..., :di].reshape(b, s, h, p)
    bb = xbc[..., di:di + n]                     # [B, S, N]
    cc = xbc[..., di + n:]                       # [B, S, N]

    a = -torch.exp(home(params["a_log"]))                         # [H]
    dt = softplus(dt_raw.float() + home(params["dt_bias"]))       # [B, S, H]
    la = dt * a                                                   # log decay

    # chunked SSD
    xc = xh.reshape(b, nc, q, h, p).float()
    bc = bb.reshape(b, nc, q, n).float()
    cc_ = cc.reshape(b, nc, q, n).float()
    lac = la.reshape(b, nc, q, h)
    dtc = dt.reshape(b, nc, q, h)
    s0 = (cache.ssd if cache is not None
          else torch.zeros((b, h, n, p), dtype=torch.float32,
                           device=u.device))
    if tp is None:
        y, s_prev = _ssd(xc, bc, cc_, lac, dtc, s0)
    else:
        y, s_prev = _ssd_split(tp, xc, bc, cc_, lac, dtc, s0)
    y = y.reshape(b, s, h, p)
    y = y + home(params["d_skip"])[None, None, :, None] * xh.float()
    y = _gated_norm(z, y.reshape(b, s, di).to(u.dtype),
                    home(params["norm_z"]))
    out = _out_proj(params, y)
    conv_dtype = cache.conv.dtype if cache is not None else u.dtype
    return out, MambaCache(conv=conv_hist.to(conv_dtype), ssd=s_prev)


def _in_proj(params, u):
    """``u @ in_proj``, on the home (gathered over a row's positions)."""
    tp = row_split(params["in_proj"])
    if tp is None:
        return u @ params["in_proj"]
    return tp.columns_product(u, params["in_proj"])


def _out_proj(params, y):
    """``y @ out_proj``: over a row's positions, each its row block."""
    tp = row_split(params["out_proj"])
    if tp is None:
        return y @ params["out_proj"]
    return tp.rows_product(y, params["out_proj"])


def _ssd(xc, bc, cc_, lac, dtc, s_prev, cb=None):
    """The chunked SSD over the heads of ``xc`` [B, nc, Q, H, P], ``lac``,
    ``dtc`` [B, nc, Q, H] and ``s_prev`` [B, H, N, P] (the state before
    the first chunk); ``cb`` the C·B products [B, nc, Q, Q] (None:
    computed here).  Returns (y [B, nc, Q, H, P], the final state)."""
    b, nc, q, h, p = xc.shape
    n = bc.shape[-1]
    cum = scan_cumsum(lac, 2)                                     # [B,nc,Q,H]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]           # li - lj
    tri = torch.ones((q, q), dtype=torch.bool, device=xc.device).tril()
    # mask the *exponent* (not the result), as the reference does
    decay = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                                  float("-inf")))

    # intra-chunk: Y[i] = sum_j C_i·B_j decay(i,j) dt_j x_j
    if cb is None:
        cb = torch.einsum("bcin,bcjn->bcij", cc_, bc)             # [B,nc,Q,Q]
    w = cb[..., None] * decay * dtc[:, :, None, :, :]             # [..,Q,Q,H]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xc)

    # chunk-boundary states and inter-chunk recurrence
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)                  # to the end
    xdt = xc * dtc[..., None] * dec_end[..., None]                # [..,Q,H,P]
    s_chunk = torch.einsum("bcjn,bcjhp->bchnp", bc, xdt)      # [B,nc,H,N,P]
    a_chunk = torch.exp(cum[:, :, -1, :])                         # [B,nc,H]

    s_prevs = []
    for ci in trips("ssd.chunks", nc):
        s_prevs.append(s_prev)
        s_prev = a_chunk[:, ci, :, None, None] * s_prev + s_chunk[:, ci]
    s_prevs = torch.stack(pad(s_prevs, nc), dim=1)            # [B,nc,H,N,P]

    y_inter = torch.einsum("bcin,bchnp->bcihp", cc_, s_prevs) \
        * torch.exp(cum)[..., None]
    return y_intra + y_inter, s_prev


def _ssd_split(tp, xc, bc, cc_, lac, dtc, s0):
    """``_ssd`` over a row's positions: the C·B products over the state
    dim's blocks, summed, then each position's heads; y and the state
    gathered on the home."""
    h, n = xc.shape[3], bc.shape[-1]
    nb = tp.even(n)
    if nb is None:
        cb = torch.einsum("bcin,bcjn->bcij", cc_, bc)
    else:
        cs, bs = tp.scatter(cc_, nb, -1), tp.scatter(bc, nb, -1)
        cb = tp.sum([torch.einsum("bcin,bcjn->bcij", c_, b_)
                     for c_, b_ in zip(cs, bs)])
    hb = even_bounds(h, tp.m)
    parts = zip(tp.scatter(xc, hb, 3), tp.spread(bc), tp.spread(cc_),
                tp.scatter(lac, hb, 3), tp.scatter(dtc, hb, 3),
                tp.scatter(s0, hb, 1), tp.spread(cb))
    ys, ss = [], []
    for (x_, b_, c_, la_, dt_, s_, cb_), (h0, h1) in zip(parts, hb):
        if h1 > h0:
            y_, s_ = _ssd(x_, b_, c_, la_, dt_, s_, cb_)
            ys.append(y_)
            ss.append(s_)
    return tp.gather(ys, 3), tp.gather(ss, 1)


def mamba_decode(params, cfg: ArchConfig, u, cache: MambaCache
                 ) -> Tuple[torch.Tensor, MambaCache]:
    """O(1) decode step. u: [B, 1, D]."""
    b = u.shape[0]
    di, n, h, p = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                   cfg.ssm_head_dim)
    tp = row_split(params["in_proj"])
    z, xbc, dt_raw = _split_proj(cfg, _in_proj(params, u))
    xbc, conv_hist = _causal_conv(xbc, home(params["conv_w"]),
                                  home(params["conv_b"]), cache.conv)
    xh = xbc[:, 0, :di].reshape(b, h, p)
    bb = xbc[:, 0, di:di + n].float()
    cc = xbc[:, 0, di + n:].float()

    a = -torch.exp(home(params["a_log"]))
    dt = softplus(dt_raw[:, 0].float() + home(params["dt_bias"]))  # [B, H]
    decay = torch.exp(dt * a)                                    # [B, H]

    xdt = xh.float() * dt[..., None]
    if tp is None:
        y, s_new = _ssd_step(bb, cc, xdt, decay, cache.ssd)
    else:
        hb = even_bounds(h, tp.m)
        ys, ss = [], []
        for args, (h0, h1) in zip(zip(
                tp.spread(bb), tp.spread(cc), tp.scatter(xdt, hb, 1),
                tp.scatter(decay, hb, 1), tp.scatter(cache.ssd, hb, 1)), hb):
            if h1 > h0:
                y_, s_ = _ssd_step(*args)
                ys.append(y_)
                ss.append(s_)
        y, s_new = tp.gather(ys, 1), tp.gather(ss, 1)
    y = y + home(params["d_skip"])[None, :, None] * xh.float()
    y = _gated_norm(z, y.reshape(b, 1, di).to(u.dtype),
                    home(params["norm_z"]))
    out = _out_proj(params, y)
    return out, MambaCache(conv=conv_hist.to(cache.conv.dtype), ssd=s_new)


def _ssd_step(bb, cc, xdt, decay, ssd):
    """One token of the recurrence over the heads of ``xdt`` [B, H, P],
    ``decay`` [B, H] and ``ssd`` [B, H, N, P]: (y [B, H, P], new state)."""
    bx = torch.einsum("bn,bhp->bhnp", bb, xdt)
    s_new = decay[:, :, None, None] * ssd + bx
    return torch.einsum("bn,bhnp->bhp", cc, s_new), s_new
