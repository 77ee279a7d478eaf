"""Attention: GQA/MQA with RoPE, logit soft-capping, sliding windows,
flash-style chunked computation, and KV-cache decode (port of the JAX
package's ``models/attention.py``).

* Prefill and teacher-forcing attention is two nested loops over query
  and key/value chunks with running (max, sum) accumulators in f32 — the
  flash recurrence, with the reference's chunk sizes and its ``_NEG``
  mask — so the S×S score matrix is never materialized.
* Decode is a single-token query against the cache; each row writes its
  own position (continuous batching).
* The reference's score and PV products ask for f32 results
  (``preferred_element_type``): their operands are upcast to f32 here,
  so the products come out unrounded as there.  Where the reference
  rounds (``p`` to the value dtype before PV, cos/sin to the activation
  dtype in RoPE), so does the port.
* A cache is written in place and returned: the counterpart of the
  reference's donated caches.
* On a mesh a KV cache may hold its sequence dim over ``model``
  (``launch.serve.cache_leaf_spec``): a data row then sees each leaf as
  ``SeqBlocks``, its positions' S blocks in place.  Prefill writes each
  block its part of the prompt; decode writes the new K/V into the block
  that owns each row's position, every block scores and sums over its
  own keys, and the row combines the blocks' (max, sum, output)
  statistics by log-sum-exp (distributed flash decode).
* Under a data row's tensor parallelism (the parameters are
  ``dist.sharding.Blocks``) each position projects its own columns of q,
  k and v and its rows of ``wo`` (the row sums the partial outputs).
  Position j attends over heads ``head_bounds``'s j-th range with the
  kv groups they read: where its column blocks hold just those heads and
  groups they stay on its device, else (a block of part of a head, as a
  single kv head split four ways) the row gathers the projection and
  hands each position its heads.  Prefill writes the cache from k and v
  gathered on the row's home; decode against a sequence-split cache
  scores every block with q gathered; a cache held whole on the home
  hands each position its groups' slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.dist.sharding import even_bounds, link_kind, row_split
from repro_torch.models.arch_config import ArchConfig
from repro_torch.models.layers import dense_init
from repro_torch.models.trips import pad, trips

_NEG = -1e30


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, positions):
    """[..., head_dim//2] cos/sin tables for integer positions."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    inv = 1.0 / torch.pow(theta, exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: [B, S, ..., head_dim]; cos/sin: [B|1, S, half].

    Head axes between S and head_dim are broadcast (the grouped 5-D query
    [B, S, G, Hg, d] and the 4-D key [B, S, G, d] alike).
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    bshape = tuple(cos.shape[:2]) + (1,) * (x.ndim - 3) + (half,)
    c = cos.reshape(bshape).to(x.dtype)
    s = sin.reshape(bshape).to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def attn_init(generator, cfg: ArchConfig, dtype, device="cuda") -> dict:
    return {
        "wq": dense_init(generator, cfg.d_model, cfg.q_dim, dtype, device),
        "wk": dense_init(generator, cfg.d_model, cfg.kv_dim, dtype, device),
        "wv": dense_init(generator, cfg.d_model, cfg.kv_dim, dtype, device),
        "wo": dense_init(generator, cfg.q_dim, cfg.d_model, dtype, device),
    }


class KVCache(NamedTuple):
    """Per-layer decode cache. k/v: [B, S_max, n_kv, head_dim]."""
    k: torch.Tensor
    v: torch.Tensor


class SeqBlocks:
    """A cache leaf split along its sequence dim into blocks that live on
    their positions' devices: ``parts[m]`` holds sequence positions
    [offsets[m], offsets[m] + parts[m].shape[dim]) in place.  Indexing
    takes a repetition of a stacked ``[R, ...]`` leaf from every block."""

    def __init__(self, parts, offsets, dim: int):
        self.parts, self.offsets, self.dim = list(parts), list(offsets), dim

    def __getitem__(self, r: int) -> "SeqBlocks":
        return SeqBlocks([p[r] for p in self.parts], self.offsets,
                         self.dim - 1)

    @property
    def dtype(self):
        return self.parts[0].dtype

    def write_prefix(self, value) -> None:
        """Positions [0, S) of a [B, S, ...] leaf from ``value``."""
        s = value.shape[1]
        for part, off in zip(self.parts, self.offsets):
            n = min(part.shape[1], s - off)
            if n > 0:
                part[:, :n] = value[:, off:off + n].to(part.device,
                                                       part.dtype)


def _decode_blocks(cache: KVCache, q, k, v, idx, window, softcap):
    """Decode against a sequence-split cache (``SeqBlocks`` leaves):
    write each row's new K/V into the block that owns its position, then
    each block's (max, sum, f32 output) over its keys on its own device,
    combined on ``q``'s device in block order by log-sum-exp."""
    ck, cv = cache
    b, _, g, hg, hd = q.shape
    qs = (q * hd ** -0.5).float()
    stats = []
    for pk, pv, off in zip(ck.parts, cv.parts, ck.offsets):
        dev, n = pk.device, pk.shape[1]
        rows = torch.arange(b, device=dev)
        li = idx.to(dev) - off
        mine = ((li >= 0) & (li < n))[:, None, None]
        li = li.clamp(0, n - 1)
        pk[rows, li] = torch.where(mine, k[:, 0].to(dev, pk.dtype),
                                   pk[rows, li])
        pv[rows, li] = torch.where(mine, v[:, 0].to(dev, pv.dtype),
                                   pv[rows, li])
        s = torch.einsum("bqghd,bkgd->bghqk", qs.to(dev), pk.float())
        s = _softcap(s, softcap)
        kpos = torch.arange(off, off + n, device=dev)
        i = idx.to(dev)
        valid = kpos[None, :] <= i[:, None]
        if window is not None:
            valid &= kpos[None, :] > (i[:, None] - window)
        s = torch.where(valid[:, None, None, None, :], s, _NEG)
        m = s.amax(-1)                                   # [B, G, Hg, 1]
        p = torch.exp(s - m[..., None])
        o = torch.einsum("bghqk,bkgd->bghqd", p, pv.float())
        with link_kind("all-reduce"):
            stats.append(tuple(t.to(q.device) for t in (m, p.sum(-1), o)))
    m_all = stats[0][0]
    for m, _, _ in stats[1:]:
        m_all = torch.maximum(m_all, m)
    l_all = torch.zeros_like(m_all)
    acc = torch.zeros_like(stats[0][2])
    for m, l, o in stats:
        corr = torch.exp(m - m_all)
        l_all = l_all + l * corr
        acc = acc + o * corr[..., None]
    out = acc / l_all[..., None]                         # [B, G, Hg, 1, d]
    return out.permute(0, 3, 1, 2, 4).to(cv.dtype)


def _decode_dense(q, ck, cv, idx, window, softcap):
    """One query a row against a whole cache [B, S, g, hd] (its new K/V
    written): softmax over the positions up to ``idx``."""
    hd = q.shape[-1]
    scores = torch.einsum("bqghd,bkgd->bghqk", (q * hd ** -0.5).float(),
                          ck.float())
    scores = _softcap(scores, softcap)
    kpos = torch.arange(ck.shape[1], device=q.device)
    valid = kpos[None, :] <= idx[:, None]              # [B, S]
    if window is not None:
        valid &= kpos[None, :] > (idx[:, None] - window)
    scores = torch.where(valid[:, None, None, None, :], scores, _NEG)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bghqk,bkgd->bqghd", p.to(cv.dtype), cv)


def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype,
               device="cuda") -> KVCache:
    shape = (batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# flash-style chunked attention (prefill / teacher forcing)
# ---------------------------------------------------------------------------

def _softcap(scores, cap: Optional[float]):
    if cap:
        return cap * torch.tanh(scores / cap)
    return scores


def _divisor_near(s: int, target: int) -> int:
    """Largest divisor of s that is <= target (chunk sizes must tile the
    sequence exactly — whisper's 1500-frame encoder is not a power of 2)."""
    t = min(s, target)
    for d in range(t, 0, -1):
        if s % d == 0:
            return d
    return 1


def chunked_attention(q, k, v, *, causal: bool, window: Optional[int],
                      softcap: Optional[float], q_chunk: int = 512,
                      kv_chunk: int = 1024, q_offset: int = 0):
    """softmax(QK^T/sqrt(d) [+mask]) V without materializing S×S.

    q: [B, Sq, G, Hg, d]  (G = kv groups, Hg = heads per group)
    k,v: [B, Sk, G, d]
    returns [B, Sq, G, Hg, d] in q.dtype; accumulation in f32.
    """
    b, sq, g, hg, d = q.shape
    sk = k.shape[1]
    q_chunk = _divisor_near(sq, q_chunk)
    kv_chunk = _divisor_near(sk, kv_chunk)
    nq, nk = sq // q_chunk, sk // kv_chunk
    dev = q.device

    qs = (q * d ** -0.5).reshape(b, nq, q_chunk, g, hg, d)
    ks = k.reshape(b, nk, kv_chunk, g, d)
    vs = v.reshape(b, nk, kv_chunk, g, d)
    q_pos_base = torch.arange(q_chunk, device=dev) + q_offset
    k_pos_base = torch.arange(kv_chunk, device=dev)

    outs = []
    for qi in trips("attention.q", nq):
        qc = qs[:, qi].float()
        q_pos = q_pos_base + qi * q_chunk
        m = torch.full((b, g, hg, q_chunk), _NEG, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, g, hg, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, g, hg, q_chunk, d), dtype=torch.float32,
                          device=dev)
        for ki in trips("attention.kv", nk):
            vc = vs[:, ki]
            k_pos = k_pos_base + ki * kv_chunk
            s = torch.einsum("bqghd,bkgd->bghqk", qc, ks[:, ki].float())
            s = _softcap(s, softcap)
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                mask &= q_pos[:, None] - k_pos[None, :] < window
            s = torch.where(mask, s, _NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bghqk,bkgd->bghqd",
                              p.to(vc.dtype).float(), vc.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]   # [B,G,Hg,qc,d]
        outs.append(out.permute(0, 3, 1, 2, 4))            # [B,qc,G,Hg,d]
    return torch.cat(pad(outs, nq), dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# attention block (train / prefill / decode)
# ---------------------------------------------------------------------------

def attn_apply(params, cfg: ArchConfig, x, *, causal: bool = True,
               window: Optional[int] = None, positions=None,
               cache: Optional[KVCache] = None, cache_len=None,
               kv_x=None, chunk_offset: Optional[int] = None):
    """Full attention block.

    * training / prefill: x [B, S, D]; returns y [B, S, D] (+ the cache
      if `cache` is given — prefill fills positions [0, S)).
    * decode: x [B, 1, D], cache given, `positions` [B, 1] per row;
      returns (y, cache).
    * chunked prefill: x [B, W, D] with `chunk_offset` (an int) — writes
      K/V at [offset, offset+W) and attends over the whole cache with the
      causal mask anchored at the true positions.
    * cross-attention: kv_x [B, Sk, D] supplies keys/values (no cache, no
      causal mask) — the whisper decoder over the encoder output.

    The cache is written in place and returned.  `cache_len` is accepted
    for the reference's signature and unused, as there.
    """
    b, s, _ = x.shape
    g = cfg.n_kv_heads
    hg = cfg.n_heads // max(cfg.n_kv_heads, 1)
    hd = cfg.head_dim

    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
        if chunk_offset is not None:
            positions = positions + chunk_offset

    if row_split(params["wq"]) is not None:
        return _attn_split(params, cfg, x, causal, window, positions, cache,
                           kv_x, chunk_offset)

    q = (x @ params["wq"]).reshape(b, s, g, hg, hd)
    src = x if kv_x is None else kv_x
    sk = src.shape[1]
    k = (src @ params["wk"]).reshape(b, sk, g, hd)
    v = (src @ params["wv"]).reshape(b, sk, g, hd)

    if kv_x is None:  # self-attention: rotary on q and k
        cos, sin = rope_freqs(hd, cfg.rope_theta, positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k.reshape(b, sk, g, 1, hd), cos, sin).reshape(
            b, sk, g, hd)

    if cache is not None and s == 1 and isinstance(cache.k, SeqBlocks):
        out = _decode_blocks(cache, q, k, v, positions[:, 0].long(), window,
                             cfg.logit_softcap)
    elif cache is not None and s == 1:
        # ---- decode: write one position per row, attend over the cache ----
        idx = positions[:, 0].long()                        # [B]
        rows = torch.arange(b, device=x.device)
        ck, cv = cache
        ck[rows, idx] = k[:, 0].to(ck.dtype)
        cv[rows, idx] = v[:, 0].to(cv.dtype)
        out = _decode_dense(q, ck, cv, idx, window, cfg.logit_softcap)
    elif chunk_offset is not None and cache is not None:
        # ---- chunked prefill: append W positions, attend over the cache --
        ck, cv = cache
        ck[:, chunk_offset:chunk_offset + s] = k.to(ck.dtype)
        cv[:, chunk_offset:chunk_offset + s] = v.to(cv.dtype)
        # causal masking vs true positions: cache slots beyond off+W have
        # k_pos > q_pos and mask out automatically
        out = chunked_attention(
            q, ck.to(q.dtype), cv.to(q.dtype), causal=True, window=window,
            softcap=cfg.logit_softcap, q_offset=chunk_offset)
    else:
        if isinstance(cache, KVCache) and isinstance(cache.k, SeqBlocks):
            cache.k.write_prefix(k)
            cache.v.write_prefix(v)
        elif cache is not None:  # prefill: populate cache [0, S)
            cache.k[:, :s] = k.to(cache.k.dtype)
            cache.v[:, :s] = v.to(cache.v.dtype)
        out = chunked_attention(
            q, k, v, causal=causal and kv_x is None, window=window,
            softcap=cfg.logit_softcap)

    y = out.reshape(b, s, cfg.q_dim) @ params["wo"]
    return y, cache


# ---------------------------------------------------------------------------
# tensor parallelism over a data row's ``model`` positions
# ---------------------------------------------------------------------------

def head_bounds(n_heads: int, n_kv: int, m: int):
    """Each of ``m`` positions' query heads [h0, h1) (``even_bounds``)
    and the kv groups [g0, g1) they read.  A position's heads lie in one
    group or cover whole groups; anything else raises."""
    hg = n_heads // max(n_kv, 1)
    out = []
    for h0, h1 in even_bounds(n_heads, m):
        if h0 == h1:
            out.append(((h0, h1), (h0 // hg, h0 // hg)))
            continue
        g0, g1 = h0 // hg, (h1 - 1) // hg + 1
        if g1 - g0 > 1 and (h0 % hg or h1 % hg):
            raise ValueError(f"heads [{h0}, {h1}) span part of a kv group "
                             f"of {hg} heads")
        out.append(((h0, h1), (g0, g1)))
    return out


def _attn_split(params, cfg: ArchConfig, x, causal, window, positions,
                cache, kv_x, chunk_offset):
    """``attn_apply`` over a row's positions (module docstring)."""
    tp = row_split(params["wq"])
    b, s, _ = x.shape
    hd = cfg.head_dim
    hg = cfg.n_heads // max(cfg.n_kv_heads, 1)
    src = x if kv_x is None else kv_x
    sk = src.shape[1]
    xs = tp.spread(x)
    srcs = xs if kv_x is None else tp.spread(kv_x)
    heads = head_bounds(cfg.n_heads, cfg.n_kv_heads, tp.m)
    hb, gb = [h for h, _ in heads], [g for _, g in heads]

    def project(name, inputs, bounds):
        w = params[name]
        return tp.columns([inputs[j] @ w.block(j) for j in range(tp.m)], w,
                          [(lo * hd, hi * hd) for lo, hi in bounds])

    q = [t.reshape(b, s, max(g1 - g0, 1), (h1 - h0) // max(g1 - g0, 1),
                   hd) for t, (h0, h1), (g0, g1) in
         zip(project("wq", xs, hb), hb, gb)]
    k = [t.reshape(b, sk, g1 - g0, hd) for t, (g0, g1) in
         zip(project("wk", srcs, gb), gb)]
    v = [t.reshape(b, sk, g1 - g0, hd) for t, (g0, g1) in
         zip(project("wv", srcs, gb), gb)]
    if kv_x is None:                   # self-attention: rotary on q and k
        cos, sin = rope_freqs(hd, cfg.rope_theta, positions)
        cs, ss = tp.spread(cos), tp.spread(sin)
        q = [apply_rope(t, c_, s_) for t, c_, s_ in zip(q, cs, ss)]
        k = [apply_rope(t[:, :, :, None], c_, s_)[:, :, :, 0]
             for t, c_, s_ in zip(k, cs, ss)]

    def whole(parts, bounds):
        """The gathered kv groups (or heads) from the positions' parts,
        each group once."""
        seen, keep = set(), []
        for t, (lo, hi) in zip(parts, bounds):
            if hi > lo and (lo, hi) not in seen:
                seen.add((lo, hi))
                keep.append(t)
        return tp.gather(keep, 2)

    if cache is not None and s == 1 and isinstance(cache.k, SeqBlocks):
        qw = whole([t.flatten(2, 3) for t in q], hb)
        out = _decode_blocks(cache, qw.reshape(b, s, cfg.n_kv_heads, hg, hd),
                             whole(k, gb), whole(v, gb),
                             positions[:, 0].long(), window,
                             cfg.logit_softcap)
        y = tp.rows_product(out.reshape(b, s, cfg.q_dim), params["wo"])
        return y, cache
    if cache is not None:
        kw, vw = whole(k, gb), whole(v, gb)
        if s == 1 or chunk_offset is not None:   # a cache on the home
            ck, cv = cache
            if s == 1:
                idx = positions[:, 0].long()
                rows = torch.arange(b, device=x.device)
                ck[rows, idx] = kw[:, 0].to(ck.dtype)
                cv[rows, idx] = vw[:, 0].to(cv.dtype)
            else:
                ck[:, chunk_offset:chunk_offset + s] = kw.to(ck.dtype)
                cv[:, chunk_offset:chunk_offset + s] = vw.to(cv.dtype)
            k = tp.scatter(ck, gb, 2)
            v = tp.scatter(cv, gb, 2)
        elif isinstance(cache.k, SeqBlocks):
            cache.k.write_prefix(kw)
            cache.v.write_prefix(vw)
        else:                                    # prefill: [0, S)
            cache.k[:, :s] = kw.to(cache.k.dtype)
            cache.v[:, :s] = vw.to(cache.v.dtype)
    o = []
    for j in range(tp.m):
        if hb[j][0] == hb[j][1]:
            o.append(q[j].new_zeros((b, s, 0)))
            continue
        if cache is not None and s == 1:
            idx = positions[:, 0].long().to(q[j].device)
            oj = _decode_dense(q[j], k[j], v[j], idx, window,
                               cfg.logit_softcap)
        elif cache is not None and chunk_offset is not None:
            oj = chunked_attention(
                q[j], k[j].to(q[j].dtype), v[j].to(q[j].dtype),
                causal=True, window=window, softcap=cfg.logit_softcap,
                q_offset=chunk_offset)
        else:
            oj = chunked_attention(
                q[j], k[j], v[j], causal=causal and kv_x is None,
                window=window, softcap=cfg.logit_softcap)
        o.append(oj.reshape(b, s, -1))
    return tp.rows_product(o, params["wo"], [(h0 * hd, h1 * hd)
                                             for h0, h1 in hb]), cache
