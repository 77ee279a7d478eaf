"""xLSTM blocks: mLSTM (matrix memory, parallel form) and sLSTM (scalar
memory, true recurrence), per Beck et al. 2024 (arXiv:2405.04517); port
of the JAX package's ``models/xlstm.py``.

* **mLSTM** prefills with a flash-style chunked parallel form: the gate
  matrix D̃[i,j] = F_i − F_j + I_j splits into a row and a column term,
  so the running-max chunk recurrence of flash attention applies, with
  the exponential weights multiplying the raw qkᵀ scores and the
  normalizer max(|row-sum|, exp(−m)).  The final recurrent state is
  handed to decode, the O(1) recurrence C' = f·C + i·v kᵀ.
* **sLSTM** has recurrent weights (R·h_{t−1} feeds the gates), so
  prefill is a loop over time, one step a token, stabilized with the
  running max-state m.

The score and PV products ask for f32 results in the reference
(``preferred_element_type``): their operands are upcast here.  The
forget gates' prefix sum adds in XLA's order (``layers.scan_cumsum``);
``log_sigmoid`` is the reference's (``layers.log_sigmoid``).

Under a data row's tensor parallelism (``dist.sharding.Blocks``
parameters) each position projects its columns of q, k, v (mLSTM) and
of the gate inputs (``w_if``, ``w_x``); the gate fields cut across
the blocks, so the row gathers them on its home.  Position j runs the
recurrences of its heads (``even_bounds``): the mLSTM chunks and state,
and each sLSTM step's recurrent product, whose outputs the home gathers
for the cell.  ``wo``'s row blocks end the mLSTM.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.dist.sharding import even_bounds, home, row_split
from repro_torch.models.arch_config import ArchConfig
from repro_torch.models.layers import dense_init, log_sigmoid, \
    scan_cumsum, truncated_normal
from repro_torch.models.trips import pad, trips


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTMCache(NamedTuple):
    c: torch.Tensor   # [B, H, P, P] matrix memory
    n: torch.Tensor   # [B, H, P] normalizer
    m: torch.Tensor   # [B, H] stabilizer


def mlstm_init(generator, cfg: ArchConfig, dtype, device="cuda") -> dict:
    d, h = cfg.d_model, cfg.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wq": dense_init(generator, d, d, dtype, device),
        "wk": dense_init(generator, d, d, dtype, device),
        "wv": dense_init(generator, d, d, dtype, device),
        "w_if": truncated_normal(generator, (d, 2 * h), torch.float32,
                                 d ** -0.5, device),
        "b_if": torch.cat([torch.zeros((h,), **f32),
                           torch.full((h,), 3.0, **f32)]),
        "wo": dense_init(generator, d, d, dtype, device),
    }


def init_mlstm_cache(cfg: ArchConfig, batch: int,
                     device="cuda") -> MLSTMCache:
    h, p = cfg.n_heads, cfg.d_model // cfg.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMCache(c=torch.zeros((batch, h, p, p), **f32),
                      n=torch.zeros((batch, h, p), **f32),
                      m=torch.zeros((batch, h), **f32))


def mlstm_apply(params, cfg: ArchConfig, x, *, chunk: int = 256
                ) -> Tuple[torch.Tensor, MLSTMCache]:
    """Parallel (prefill) path. x: [B, S, D], S % chunk == 0 (or S
    smaller than chunk).  Returns (y, the final recurrent state)."""
    b, s, d = x.shape
    h = cfg.n_heads
    p = d // h
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of chunk {q}")
    tp = row_split(params["wq"])
    gates = _gates(params, x, "w_if") + home(params["b_if"])
    li = gates[..., :h]                                   # log input gate
    lf = log_sigmoid(gates[..., h:])                      # log forget gate
    f_cum = scan_cumsum(lf, 1)                            # [B, S, H]
    if tp is None:
        qh, kh, vh = ((x @ params[k]).reshape(b, s, h, p)
                      for k in ("wq", "wk", "wv"))
        y, state = _mlstm_heads(qh, kh, vh, li, f_cum, q, x.dtype)
        return y @ params["wo"], state
    hb = even_bounds(h, tp.m)
    qkv = _head_parts(tp, params, x, hb, p)
    lis, fs = tp.scatter(li, hb, 2), tp.scatter(f_cum, hb, 2)
    ys, states = [], []
    for j, (h0, h1) in enumerate(hb):
        if h1 == h0:
            ys.append(qkv[0][j].new_zeros((b, s, 0)).to(x.dtype))
            continue
        y, st = _mlstm_heads(*(t[j].reshape(b, s, h1 - h0, p) for t in qkv),
                             lis[j], fs[j], q, x.dtype)
        ys.append(y)
        states.append(st)
    y = tp.rows_product(ys, params["wo"], [(h0 * p, h1 * p) for h0, h1 in hb])
    return y, MLSTMCache(*(tp.gather([st[i] for st in states], 1)
                           for i in range(3)))


def _gates(params, x, name: str):
    """``x @ params[name]`` in float32, on the home (gathered over a row's
    positions: the gate fields cut across the column blocks)."""
    w = params[name]
    tp = row_split(w)
    if tp is None:
        return x.float() @ w.float()
    return tp.columns_product(x, w, f32=True)


def _head_parts(tp, params, x, hb, p: int):
    """Each position's heads ``hb[j]`` of x @ wq, wk, wv."""
    xs = tp.spread(x)
    out = []
    for name in ("wq", "wk", "wv"):
        w = params[name]
        out.append(tp.columns([xs[j] @ w.block(j) for j in range(tp.m)], w,
                              [(h0 * p, h1 * p) for h0, h1 in hb]))
    return out


def _mlstm_heads(qh, kh, vh, li, f_cum, q: int, dtype):
    """The chunked parallel form over the heads of ``qh``, ``kh``, ``vh``
    [B, S, H, P] with their gates ``li``, ``f_cum`` [B, S, H]: (y [B, S,
    H P] in ``dtype``, the final state)."""
    b, s, h, p = qh.shape
    nc = s // q
    dev = qh.device
    col = li - f_cum                                      # I_j - F_j

    qc = (qh * p ** -0.5).reshape(b, nc, q, h, p).float()
    kc = kh.reshape(b, nc, q, h, p).float()
    vc = vh.reshape(b, nc, q, h, p)
    rowc = f_cum.reshape(b, nc, q, h).transpose(2, 3)     # [B,nc,H,q] F_i
    colc = col.reshape(b, nc, q, h).transpose(2, 3)
    pos = torch.arange(q, device=dev)

    outs = []
    for qi in trips("mlstm.q", nc):
        m = torch.full((b, h, q), float("-inf"), dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, h, q), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, q, p), dtype=torch.float32, device=dev)
        for ki in trips("mlstm.k", nc):
            score = torch.einsum("bqhp,bkhp->bhqk", qc[:, qi], kc[:, ki])
            bias = rowc[:, qi, :, :, None] + colc[:, ki, :, None, :]
            causal = (pos[:, None] + qi * q) >= (pos[None, :] + ki * q)
            bias = torch.where(causal[None, None], bias, float("-inf"))
            m_new = torch.maximum(m, bias.amax(-1))
            w = score * torch.exp(bias - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + w.sum(-1)
            vx = vc[:, ki]
            pv = torch.einsum("bhqk,bkhp->bhqp", w.to(vx.dtype).float(),
                              vx.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        denom = torch.maximum(l.abs(), torch.exp(-m))
        outs.append((acc / denom[..., None]).transpose(1, 2))  # [B,q,H,p]
    y = torch.cat(pad(outs, nc), dim=1).reshape(b, s, h * p).to(dtype)

    # final recurrent state (for prefill -> decode handoff)
    m_fin = f_cum[:, -1, :, None] - f_cum.transpose(1, 2) \
        + li.transpose(1, 2)                              # [B,H,S]
    m_last = m_fin.amax(-1)
    w_fin = torch.exp(m_fin - m_last[..., None])
    kf = kh.float()
    c_fin = torch.einsum("bhs,bshq->bhsq", w_fin, kf)
    c_fin = torch.einsum("bhsp,bshq->bhpq", c_fin, vh.float())
    n_fin = torch.einsum("bhs,bshp->bhp", w_fin, kf)
    return y, MLSTMCache(c=c_fin, n=n_fin, m=m_last)


def mlstm_decode(params, cfg: ArchConfig, x, cache: MLSTMCache
                 ) -> Tuple[torch.Tensor, MLSTMCache]:
    """O(1) decode. x: [B, 1, D]."""
    b, _, d = x.shape
    h = cfg.n_heads
    p = d // h
    tp = row_split(params["wq"])
    gates = _gates(params, x, "w_if")[:, 0] + home(params["b_if"])
    li, lf = gates[..., :h], log_sigmoid(gates[..., h:])
    if tp is None:
        qh, kh, vh = ((x @ params[k]).reshape(b, h, p)
                      for k in ("wq", "wk", "wv"))
        y, state = _mlstm_step(qh, kh, vh, li, lf, cache)
        return y.reshape(b, 1, d).to(x.dtype) @ params["wo"], state
    hb = even_bounds(h, tp.m)
    qkv = _head_parts(tp, params, x, hb, p)
    parts = zip(tp.scatter(li, hb, 1), tp.scatter(lf, hb, 1),
                *(tp.scatter(c, hb, 1) for c in cache))
    ys, states = [], []
    for j, ((h0, h1), (li_, lf_, *st)) in enumerate(zip(hb, parts)):
        if h1 == h0:
            ys.append(qkv[0][j].new_zeros((b, 1, 0)).to(x.dtype))
            continue
        y, st = _mlstm_step(*(t[j].reshape(b, h1 - h0, p) for t in qkv),
                            li_, lf_, MLSTMCache(*st))
        ys.append(y.reshape(b, 1, -1).to(x.dtype))
        states.append(st)
    y = tp.rows_product(ys, params["wo"], [(h0 * p, h1 * p) for h0, h1 in hb])
    return y, MLSTMCache(*(tp.gather([st[i] for st in states], 1)
                           for i in range(3)))


def _mlstm_step(qh, kh, vh, li, lf, cache: MLSTMCache):
    """One token of the recurrence over the heads of ``qh``, ``kh``,
    ``vh`` [B, H, P] and their gates and state: (y [B, H, P] float32,
    the new state)."""
    p = qh.shape[-1]
    m_new = torch.maximum(lf + cache.m, li)
    f_eff = torch.exp(lf + cache.m - m_new)[..., None]
    i_eff = torch.exp(li - m_new)[..., None]
    kf = kh.float()
    vf = vh.float()
    c_new = f_eff[..., None] * cache.c \
        + i_eff[..., None] * kf[..., :, None] * vf[..., None, :]
    n_new = f_eff * cache.n + i_eff * kf
    qf = qh.float() * p ** -0.5
    num = torch.einsum("bhp,bhpq->bhq", qf, c_new)
    den = torch.maximum(torch.einsum("bhp,bhp->bh", qf, n_new).abs(),
                        torch.exp(-m_new))
    return num / den[..., None], MLSTMCache(c=c_new, n=n_new, m=m_new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTMCache(NamedTuple):
    c: torch.Tensor   # [B, D]
    n: torch.Tensor   # [B, D]
    h: torch.Tensor   # [B, D]
    m: torch.Tensor   # [B, D]


def slstm_init(generator, cfg: ArchConfig, dtype, device="cuda") -> dict:
    d, h = cfg.d_model, cfg.n_heads
    p = d // h
    bias = torch.zeros((4 * d,), dtype=torch.float32, device=device)
    bias[2 * d:3 * d] = 3.0                    # forget-gate bias
    return {
        # z, i, f, o gates from input ...
        "w_x": dense_init(generator, d, 4 * d, dtype, device),
        # ... and block-diagonal recurrent connections per head
        "r_h": truncated_normal(generator, (h, p, 4 * p), torch.float32,
                                p ** -0.5, device),
        "bias": bias,
    }


def init_slstm_cache(cfg: ArchConfig, batch: int,
                     device="cuda") -> SLSTMCache:
    z = dict(dtype=torch.float32, device=device)
    d = cfg.d_model
    return SLSTMCache(*(torch.zeros((batch, d), **z) for _ in range(4)))


def _slstm_cell(params, cfg: ArchConfig, xt, cache: SLSTMCache):
    """One sLSTM step. xt: [B, 4*D] pre-projected gate inputs (f32)."""
    b = xt.shape[0]
    d = xt.shape[1] // 4
    h = cfg.n_heads
    p = d // h
    hh = cache.h.reshape(b, h, p)
    r_h = params["r_h"]
    tp = row_split(r_h)
    if tp is None:
        rec = torch.einsum("bhp,hpq->bhq", hh, r_h)
    else:                  # each position its heads' recurrent product
        hb = even_bounds(h, tp.m)
        rec = tp.gather([torch.einsum("bhp,hpq->bhq", hh_, r_h.block(j)[
            h0:h1]) for j, (hh_, (h0, h1)) in enumerate(zip(
                tp.scatter(hh, hb, 1), hb)) if h1 > h0], 1)
    g = xt + rec.reshape(b, 4 * d) + home(params["bias"])
    z = torch.tanh(g[:, :d])
    li = g[:, d:2 * d]                       # log-space input gate
    lf = log_sigmoid(g[:, 2 * d:3 * d])
    o = torch.sigmoid(g[:, 3 * d:])

    m_new = torch.maximum(lf + cache.m, li)
    i_eff = torch.exp(li - m_new)
    f_eff = torch.exp(lf + cache.m - m_new)
    c_new = f_eff * cache.c + i_eff * z
    n_new = f_eff * cache.n + i_eff
    h_new = o * c_new / torch.clamp(n_new, min=1.0)
    return SLSTMCache(c=c_new, n=n_new, h=h_new, m=m_new)


def slstm_apply(params, cfg: ArchConfig, x, *,
                cache: Optional[SLSTMCache] = None
                ) -> Tuple[torch.Tensor, SLSTMCache]:
    """A loop over time (sLSTM is a true RNN). x: [B, S, D]."""
    b, s, d = x.shape
    if cache is None:
        cache = init_slstm_cache(cfg, b, x.device)
    xg = _gates(params, x, "w_x")
    hs = []
    for t in trips("slstm.steps", s):
        cache = _slstm_cell(params, cfg, xg[:, t], cache)
        hs.append(cache.h)
    return torch.stack(pad(hs, s), dim=1).to(x.dtype), cache


def slstm_decode(params, cfg: ArchConfig, x, cache: SLSTMCache
                 ) -> Tuple[torch.Tensor, SLSTMCache]:
    xg = _gates(params, x, "w_x")[:, 0]
    new = _slstm_cell(params, cfg, xg, cache)
    return new.h[:, None, :].to(x.dtype), new
