"""Shared layers: norms, gated MLPs, embeddings, initializers (port of
the JAX package's ``models/layers.py``).

Parameters are plain nested dicts of tensors with the reference's tree
paths; layer stacks carry a leading ``[reps]`` axis.  Every function
keeps the reference's rounding points: a product of two tensors of the
activation dtype rounds to that dtype, a norm works in float32 and
rounds once at the end.  Draws come from an explicit
``torch.Generator``; they cannot match ``jax.random``'s bits, only its
distributions.

Under a data row's tensor parallelism (``dist.sharding.RowSplit``: the
parameters are ``Blocks``) each position computes its own blocks: an
MLP's gate and up columns and its ``wo`` rows (the row sums the partial
outputs), a vocab-split table's rows for a lookup (summed) and for the
logits (gathered).  A leaf whose ``model`` split was dropped
(``sanitize_spec``) is computed whole on every position, as SPMD does,
and the home's copy is kept.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import home, row_split
from repro_torch.models.arch_config import ArchConfig

#: the standard normal's CDF at the truncation points -2 and 2
_CDF_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_CDF_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


def truncated_normal(generator, shape, dtype, stddev: float,
                     device="cuda") -> torch.Tensor:
    """N(0, stddev) truncated to +-2 sigma, drawn in float32 by inverting
    the CDF of a uniform draw, then cast to ``dtype``."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    p = _CDF_LO + u * (_CDF_HI - _CDF_LO)
    z = torch.erfinv(2.0 * p - 1.0) * math.sqrt(2.0)
    return (z.clamp_(-2.0, 2.0) * stddev).to(dtype)


def dense_init(generator, d_in: int, d_out: int, dtype,
               device="cuda") -> torch.Tensor:
    return truncated_normal(generator, (d_in, d_out), dtype, d_in ** -0.5,
                            device)


def scan_cumsum(x, dim: int):
    """Inclusive prefix sum along ``dim``, added in the order XLA on the
    CPU adds it: runs of 16 summed left to right, the runs' totals
    prefix-summed the same way (recursively) and added to each later
    run.  ``torch.cumsum`` adds in another order (in float64 on the CPU),
    which parts the SSD decays from the reference's by more than
    rounding."""
    x = x.movedim(dim, -1)
    return _cumsum_runs(x).movedim(-1, dim)


def _cumsum_runs(x):
    n = x.shape[-1]
    if n <= 16:
        cols = [x[..., 0]]
        for i in range(1, n):
            cols.append(cols[-1] + x[..., i])
        return torch.stack(cols, dim=-1)
    runs = F.pad(x, (0, (-n) % 16)).reshape(*x.shape[:-1], -1, 16)
    inner = _cumsum_runs(runs)
    carry = F.pad(_cumsum_runs(inner[..., -1])[..., :-1], (1, 0))
    return (inner + carry[..., None]).flatten(-2)[..., :n]


def softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))
    (``F.softplus`` rounds another way)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(cfg: ArchConfig, dtype, device="cuda") -> torch.Tensor:
    return torch.zeros((cfg.d_model,), dtype=dtype, device=device)


def apply_norm(scale, x, kind: str = "rmsnorm", eps: float = 1e-6):
    """RMSNorm (gemma convention: weight stored as scale-1) or LayerNorm,
    in f32."""
    scale = home(scale)
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(-1, keepdim=True)
        xf = xf * torch.rsqrt(var + eps)
    else:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        xf = (xf - mu) * torch.rsqrt(var + eps)
    out = xf * (1.0 + scale.float())
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# gated MLPs
# ---------------------------------------------------------------------------

def mlp_init(generator, cfg: ArchConfig, dtype, d_ff: int | None = None,
             device="cuda") -> dict:
    d_ff = d_ff or cfg.d_ff
    p = {}
    if cfg.act in ("swiglu", "geglu"):   # plain 'gelu' has no gate matrix
        p["wi_gate"] = dense_init(generator, cfg.d_model, d_ff, dtype, device)
    p["wi_up"] = dense_init(generator, cfg.d_model, d_ff, dtype, device)
    p["wo"] = dense_init(generator, d_ff, cfg.d_model, dtype, device)
    return p


def apply_mlp(params, x, act: str = "swiglu"):
    tp = row_split(params["wo"])
    if tp is None:
        return _mlp(params, x, act)
    xs = tp.spread(x)
    parts = [_mlp({k: w.block(j) for k, w in params.items()}, xs[j], act)
             for j in range(tp.m)]
    return parts[0] if params["wo"].dim is None else tp.sum(parts)


def _mlp(params, x, act: str):
    up = x @ params["wi_up"]
    if act == "swiglu":
        h = F.silu(x @ params["wi_gate"]) * up
    elif act == "geglu":
        h = F.gelu(x @ params["wi_gate"], approximate="tanh") * up
    elif act == "gelu":          # plain 2-matrix MLP (whisper)
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(f"unknown act {act}")
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embed_init(generator, cfg: ArchConfig, dtype, device="cuda"):
    # N(0, d^-1/2): keeps tied logits O(1); archs with embed_scale
    # (gemma) multiply activations back up by sqrt(d) at lookup time.
    return truncated_normal(generator, (cfg.vocab_padded, cfg.d_model),
                            dtype, cfg.d_model ** -0.5, device)


def embed_apply(embed, tokens, scale_by_dim: bool = True,
                mode: str = "take"):
    """Token embedding lookup.

    mode="take": a gather.  mode="onehot": the reference's lookup for a
    vocab-sharded table under a mesh, a one-hot matrix (an iota
    comparison, in the table's dtype) times the table: a contraction in
    both directions, and bit-equal to the gather (each output is one
    product by 1.0 and zeros).

    A vocab-split ``Blocks`` table: each position looks up the tokens of
    its own vocab range (a masked gather, or the one-hot product over its
    rows) and the row sums the positions' parts, each output one value
    and zeros."""
    tp = row_split(embed)
    if tp is not None and embed.dim == 0:
        toks = tp.spread(tokens)
        parts = [_lookup(embed.block(j), toks[j], mode, embed.bounds[j][0])
                 for j in range(tp.m)]
        x = tp.sum(parts)
    else:
        x = _lookup(home(embed), tokens, mode)
    if scale_by_dim:
        # sqrt(d) is rounded to the activation dtype before the multiply
        # (45.25 in bf16 for d=2048), as the reference does
        x = x * torch.tensor(embed.shape[-1] ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _lookup(embed, tokens, mode: str, lo=None):
    """The table's rows for ``tokens``; where ``embed`` holds only rows
    [lo, lo + len) of it, zeros for a token outside them."""
    hi = embed.shape[0] + (lo or 0)
    if mode == "onehot":
        vids = torch.arange(lo or 0, hi, dtype=torch.int32,
                            device=tokens.device)
        onehot = (tokens[..., None] == vids).to(embed.dtype)
        return onehot @ embed
    if mode != "take":
        raise ValueError(f"unknown embedding mode {mode!r}")
    if lo is None:
        return embed[tokens.long()]
    mine = (tokens >= lo) & (tokens < hi)
    rows = embed[(tokens.long() - lo).clamp(0, hi - lo - 1)]
    return torch.where(mine[..., None], rows, 0)


def unembed_apply(cfg: ArchConfig, params, x):
    """Logits over the padded vocab (tied or separate head), f32."""
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    tp = row_split(table)
    if tp is None:
        logits = (x @ table.T).float()
    else:
        xs = tp.spread(x)
        parts = [(xs[j] @ table.block(j).T).float() for j in range(tp.m)]
        logits = parts[0] if table.dim is None else tp.gather(parts, -1)
    if cfg.final_softcap:
        c = cfg.final_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# ---------------------------------------------------------------------------
# the training loss
# ---------------------------------------------------------------------------

def softmax_xent(logits, labels, vocab: int):
    """Mean token cross-entropy; positions with label < 0 are masked and
    the padded vocab columns (index >= ``vocab``) are set to -1e30.

    The gold logit is a ``torch.gather``; the reference sums a one-hot
    ``where`` (a form that shards over the vocab axis), which gives the
    same float32 value: a sum of zeros and one term is exact."""
    vp = logits.shape[-1]
    if vp > vocab:
        vids = torch.arange(vp, device=logits.device)
        logits = torch.where(vids >= vocab, -1e30, logits)
    mask = labels >= 0
    safe = torch.clamp(labels, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)
