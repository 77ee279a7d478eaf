"""Model assembly: heterogeneous block stacks, teacher-forcing forward,
prefill and decode, for every assigned architecture family (port of the
JAX package's ``models/transformer.py``).

* **Pattern groups.** The stack is ``pattern_reps`` repetitions of
  ``layer_pattern`` (gemma2 "LG", zamba2 "MMMMMA").  Parameters and
  decode caches keep the reference's ``[reps, ...]`` leaves; its
  ``lax.scan`` over the repetitions is a Python loop over that index
  here, each block reading its slice of every leaf.
* **Shared attention ('A')** — zamba2-style: one attention weight set,
  reused by every group.
* **Caches are written in place** and returned (the reference donates
  them): attention writes its K/V into the stacked cache; a recurrent
  block's new state is copied into its slice.
* **Remat.** Under ``cfg.remat == "full"`` the reference wraps each
  pattern group's scan body in ``jax.checkpoint``; here each group runs
  under ``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` in
  the training forward while grad is enabled, so the backward keeps one
  activation per group and recomputes the rest.
* The reference's sharding annotations (``shard``,
  ``shard_activation_sp``) and its gradient-transparent optimization
  barrier have no counterpart: layout is owned by placement
  (``repro_torch.dist``).  Under ``use_mesh`` (the mesh steps of
  ``launch/train.py`` and ``launch/serve.py`` run a data row's share of
  the batch through these functions) an untied table is looked up
  one-hot (``_embed_mode``) and an MoE layer runs expert-parallel.
* **Tensor parallelism.**  The serving steps on a mesh pass a data
  row's ``dist.sharding.Blocks`` view of the placed parameters: each
  block function then computes its own blocks on the row's positions
  (``layers``, ``attention``, ``moe``, ``mamba2``, ``xlstm``).  A
  group's slice of a stacked leaf (and the shared attention, each group
  anew) is read when the group runs and freed with it; a leaf outside
  the stack when it is used.

Serving entry points (``prefill``, ``prefill_chunked``, ``decode_step``)
run under ``torch.inference_mode()``; ``forward`` and ``loss_fn`` keep
autograd for training (``repro_torch.launch.train``).  ``Model`` owns a
parameter tree as an ``nn.Module``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import (Blocks, current_context,
                                       current_mesh, entered, row_split)
from repro_torch.models import mamba2, moe, xlstm
from repro_torch.models.arch_config import ArchConfig
from repro_torch.models.attention import (attn_apply, attn_init,
                                          head_bounds, init_cache)
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_apply,
                                       embed_init, mlp_init, norm_init,
                                       softmax_xent, unembed_apply)
from repro_torch.models.trips import trips

ATTN_KINDS = ("G", "L", "A")


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _embed_mode(cfg: ArchConfig) -> str:
    """One-hot lookups for untied tables under a mesh; a gather
    elsewhere (``layers.embed_apply``)."""
    if not cfg.tie_embeddings and current_mesh() is not None:
        return "onehot"
    return "take"


# ---------------------------------------------------------------------------
# trees of tensors (nested dicts, NamedTuples and tuples)
# ---------------------------------------------------------------------------

def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [tree_map(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _tree_stack(trees):
    """One tree of [len(trees), ...] leaves from trees of equal shape."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _slice(tree, r: int):
    """The r-th repetition's view of every [reps, ...] leaf."""
    return tree_map(lambda a: a[r], tree)


def _write_back(views, new):
    """Copy a block's returned cache into its slice of the stacked cache
    where the block returned new tensors (attention wrote in place)."""
    for v, n in zip(views, new):
        if n is not v:
            v.copy_(n)


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def _block_init(generator, cfg: ArchConfig, kind: str, dtype,
                device) -> Dict[str, Any]:
    """Parameters of one block of the given kind (un-stacked)."""
    p: Dict[str, Any] = {"norm": norm_init(cfg, dtype, device)}
    if kind in ("G", "L"):
        p["attn"] = attn_init(generator, cfg, dtype, device)
    if kind in ATTN_KINDS:  # attention kinds carry an FFN sub-block
        p["norm2"] = norm_init(cfg, dtype, device)
        if cfg.family == "moe":
            p["moe"] = moe.moe_init(generator, cfg, dtype, device)
        else:
            p["mlp"] = mlp_init(generator, cfg, dtype, device=device)
    elif kind == "M":
        p["mamba"] = mamba2.mamba_init(generator, cfg, dtype, device)
    elif kind == "X":
        p["mlstm"] = xlstm.mlstm_init(generator, cfg, dtype, device)
    elif kind == "S":
        p["slstm"] = xlstm.slstm_init(generator, cfg, dtype, device)
    return p


def _stack_init(generator, cfg: ArchConfig, pattern: str, reps: int, dtype,
                device):
    """Stacked parameters: for each pattern position, [reps, ...] leaves."""
    return {f"p{i}": _tree_stack([_block_init(generator, cfg, kind, dtype,
                                              device) for _ in range(reps)])
            for i, kind in enumerate(pattern)}


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator],
                device="cuda") -> Dict[str, Any]:
    """Random parameters with the reference's tree, shapes, dtypes and
    distributions, drawn from ``generator`` (which lies on ``device``)."""
    dtype = _dtype(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(generator, cfg, dtype, device),
        "final_norm": norm_init(cfg, dtype, device),
        "stack": _stack_init(generator, cfg, cfg.layer_pattern,
                             cfg.pattern_reps, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(generator, cfg, dtype, device)
    if "A" in cfg.layer_pattern:
        params["shared_attn"] = attn_init(generator, cfg, dtype, device)
    if cfg.enc_dec:
        params["enc_stack"] = _stack_init(generator, cfg, "G",
                                          cfg.n_enc_layers, dtype, device)
        params["enc_final_norm"] = norm_init(cfg, dtype, device)
        # cross-attention per decoder layer, stacked with the decoder reps
        params["cross"] = _tree_stack([
            {"attn": attn_init(generator, cfg, dtype, device),
             "norm": norm_init(cfg, dtype, device)}
            for _ in range(cfg.pattern_reps)])
    return params


def param_count(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _apply_block(bp, cfg: ArchConfig, kind: str, x, *, shared_attn=None,
                 mode: str = "train", cache=None, pos=None,
                 window_override=None):
    """One block: pre-norm core + residual (+ FFN sub-block for attention).

    ``mode`` is "train" (no cache), "prefill", "chunk" (``pos`` is the
    chunk's offset) or "decode" (``pos`` [B] per-row positions).
    Returns (x, new_cache, aux_loss).
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(bp["norm"], x, cfg.norm)
    new_cache = cache

    if kind in ATTN_KINDS:
        ap = shared_attn if kind == "A" else bp["attn"]
        window = cfg.window if kind == "L" else window_override
        if mode == "decode":
            y, new_cache = attn_apply(ap, cfg, h, window=window,
                                      positions=pos[:, None], cache=cache)
        elif mode == "chunk":
            y, new_cache = attn_apply(ap, cfg, h, window=window,
                                      cache=cache, chunk_offset=pos)
        else:
            y, new_cache = attn_apply(ap, cfg, h, window=window, cache=cache)
        x = x + y
        h2 = apply_norm(bp["norm2"], x, cfg.norm)
        if cfg.family == "moe":
            y2, aux = moe.moe_apply(bp["moe"], cfg, h2)
        else:
            y2 = apply_mlp(bp["mlp"], h2, cfg.act)
        x = x + y2
    elif kind == "M":
        if mode == "decode":
            y, new_cache = mamba2.mamba_decode(bp["mamba"], cfg, h, cache)
        else:
            y, new_cache = mamba2.mamba_apply(bp["mamba"], cfg, h,
                                              cache=cache)
        x = x + y
    elif kind == "X":
        if mode == "decode":
            y, new_cache = xlstm.mlstm_decode(bp["mlstm"], cfg, h, cache)
        else:
            y, new_cache = xlstm.mlstm_apply(bp["mlstm"], cfg, h)
        x = x + y
    elif kind == "S":
        if mode == "decode":
            y, new_cache = xlstm.slstm_decode(bp["slstm"], cfg, h, cache)
        else:
            y, new_cache = xlstm.slstm_apply(bp["slstm"], cfg, h,
                                             cache=cache)
        x = x + y
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    return x, new_cache, aux


def _enc_dec_layer(gp, cfg: ArchConfig, x, mode: str, cache, pos, enc_out,
                   xkv):
    """Whisper-style decoder layer: self-attn -> cross-attn -> MLP."""
    bp = gp["p0"]
    cp = gp["cross"]
    h = apply_norm(bp["norm"], x, cfg.norm)
    if mode == "decode":
        y, nc = attn_apply(bp["attn"], cfg, h, positions=pos[:, None],
                           cache=cache)
    else:
        y, nc = attn_apply(bp["attn"], cfg, h, cache=cache)
    x = x + y

    hc = apply_norm(cp["norm"], x, cfg.norm)
    if mode == "decode":
        yc, _ = _cross_decode(cp["attn"], cfg, hc, xkv)
    else:
        yc, _ = attn_apply(cp["attn"], cfg, hc, kv_x=enc_out, causal=False)
    x = x + yc

    h2 = apply_norm(bp["norm2"], x, cfg.norm)
    x = x + apply_mlp(bp["mlp"], h2, cfg.act)
    return x, nc


def _group(cfg: ArchConfig, params, r: int, x, aux, mode: str, caches,
           pos, enc_out):
    """Pattern group ``r`` (the reference's scan body).  Returns
    (x, aux)."""
    shared = params.get("shared_attn")
    if shared is not None:
        shared = tree_map(lambda w: w.again() if isinstance(w, Blocks)
                          else w, shared)
    gp = _slice(params["stack"], r)
    if cfg.enc_dec:
        gp["cross"] = _slice(params["cross"], r)
    for i, kind in enumerate(cfg.layer_pattern):
        c = None if caches is None else _slice(caches[f"p{i}"], r)
        if cfg.enc_dec:
            xkv = (None if caches is None or "xkv" not in caches
                   else _slice(caches["xkv"], r))
            x, nc = _enc_dec_layer(gp, cfg, x, mode, c, pos, enc_out, xkv)
        else:
            x, nc, a = _apply_block(gp[f"p{i}"], cfg, kind, x,
                                    shared_attn=shared, mode=mode, cache=c,
                                    pos=pos)
            aux = aux + a
        if c is not None:
            _write_back(c, nc)
    return x, aux


def _apply_stack(cfg: ArchConfig, params, x, mode: str, caches=None,
                 pos=None, enc_out=None):
    """The decoder stack, one pattern group per repetition (the
    reference's scan), each group recomputed in the backward under
    ``cfg.remat == "full"``.  Returns (x, summed aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = (cfg.remat == "full" and mode == "train"
             and torch.is_grad_enabled())
    # the recompute runs where the backward runs (on a CUDA device, an
    # autograd worker thread): it re-enters the forward's mesh context
    ctx = current_context()
    contexts = lambda: (contextlib.nullcontext(), entered(ctx))  # noqa: E731
    for r in trips("groups", cfg.pattern_reps):
        if remat:
            x, aux = checkpoint(_group, cfg, params, r, x, aux, mode, None,
                                pos, enc_out, use_reentrant=False,
                                context_fn=contexts)
        else:
            x, aux = _group(cfg, params, r, x, aux, mode, caches, pos,
                            enc_out)
    return x, aux


def _cross_decode(ap, cfg: ArchConfig, h, cross_cache):
    """Decode-time cross-attention against precomputed encoder K/V."""
    b, s, _ = h.shape
    g = cfg.n_kv_heads
    hg = cfg.n_heads // max(g, 1)
    hd = cfg.head_dim
    ck, cv = cross_cache
    tp = row_split(ap["wq"])
    if tp is None:
        q = (h @ ap["wq"]).reshape(b, s, g, hg, hd)
        return _cross_scores(q, ck, cv).reshape(b, s, cfg.q_dim) \
            @ ap["wo"], None
    # each position its heads against its kv groups of the cross cache
    heads = head_bounds(cfg.n_heads, g, tp.m)
    hs = tp.spread(h)
    qs = tp.columns([hs[j] @ ap["wq"].block(j) for j in range(tp.m)],
                    ap["wq"], [(h0 * hd, h1 * hd) for (h0, h1), _ in heads])
    cks = tp.scatter(ck, [gr for _, gr in heads], 2)
    cvs = tp.scatter(cv, [gr for _, gr in heads], 2)
    outs = []
    for j, ((h0, h1), (g0, g1)) in enumerate(heads):
        if h1 == h0:
            outs.append(qs[j].new_zeros((b, s, 0)))
            continue
        q = qs[j].reshape(b, s, g1 - g0, (h1 - h0) // (g1 - g0), hd)
        outs.append(_cross_scores(q, cks[j], cvs[j]).reshape(b, s, -1))
    return tp.rows_product(outs, ap["wo"], [(h0 * hd, h1 * hd)
                                            for (h0, h1), _ in heads]), None


def _cross_scores(q, ck, cv):
    hd = q.shape[-1]
    scores = torch.einsum("bqghd,bkgd->bghqk", (q * hd ** -0.5).float(),
                          ck.float())
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bghqk,bkgd->bqghd", p.to(cv.dtype), cv)


# ---------------------------------------------------------------------------
# encoder (whisper)
# ---------------------------------------------------------------------------

def encode(cfg: ArchConfig, params, frames):
    """Bidirectional encoder over stub frame embeddings [B, Se, D]."""
    x = frames.to(_dtype(cfg))
    x = x + _sinusoid(frames.shape[1], cfg.d_model, x.dtype, x.device)
    for r in trips("encoder.layers", cfg.n_enc_layers):
        bp = _slice(params["enc_stack"], r)["p0"]
        h = apply_norm(bp["norm"], x, cfg.norm)
        y, _ = attn_apply(bp["attn"], cfg, h, causal=False)
        x = x + y
        h2 = apply_norm(bp["norm2"], x, cfg.norm)
        x = x + apply_mlp(bp["mlp"], h2, cfg.act)
    return apply_norm(params["enc_final_norm"], x, cfg.norm)


def _sinusoid(s: int, d: int, dtype, device="cuda"):
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)],
                     dim=-1).to(dtype)[None]


# ---------------------------------------------------------------------------
# teacher-forcing forward, the training loss
# ---------------------------------------------------------------------------

def _embed(cfg: ArchConfig, params, tokens, prefix_embeds=None):
    x = embed_apply(params["embed"], tokens, cfg.embed_scale,
                    mode=_embed_mode(cfg))
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def forward(cfg: ArchConfig, params, tokens, *, prefix_embeds=None,
            enc_frames=None):
    """Teacher-forcing forward. Returns (logits, aux_loss).

    tokens [B, S]; prefix_embeds [B, Tp, D] (VLM stub frontend);
    enc_frames [B, Se, D] (audio stub frontend, enc_dec only).
    """
    x = _embed(cfg, params, tokens, prefix_embeds)
    cross_x = None
    if cfg.enc_dec:
        if enc_frames is None:
            raise ValueError("an enc_dec arch needs enc_frames")
        cross_x = encode(cfg, params, enc_frames)
    x, aux = _apply_stack(cfg, params, x, "train", enc_out=cross_x)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return unembed_apply(cfg, params, x), aux


def loss_fn(cfg: ArchConfig, params, batch):
    """The training loss: token cross-entropy plus the MoE aux loss.  A
    VLM's labels are padded with -1 over its prefix (loss on text only).
    Returns (loss, {"xent", "aux"})."""
    logits, aux = forward(
        cfg, params, batch["tokens"],
        prefix_embeds=batch.get("prefix_embeds"),
        enc_frames=batch.get("enc_frames"))
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:   # vlm prefix: loss on text only
        pad = torch.full((labels.shape[0], logits.shape[1] - labels.shape[1]),
                         -1, dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    xent = softmax_xent(logits, labels, cfg.vocab)
    return xent + aux, {"xent": xent, "aux": aux}


# ---------------------------------------------------------------------------
# decode state / prefill / decode step
# ---------------------------------------------------------------------------

def init_decode_caches(cfg: ArchConfig, batch: int, s_max: int,
                       device="cuda"):
    """Cache tree stacked [reps, ...] per pattern position (zeros)."""
    dtype = _dtype(cfg)

    def one(kind: str):
        if kind in ATTN_KINDS:
            return init_cache(cfg, batch, s_max, dtype, device)
        if kind == "M":
            return mamba2.init_mamba_cache(cfg, batch, dtype, device)
        if kind == "X":
            return xlstm.init_mlstm_cache(cfg, batch, device)
        if kind == "S":
            return xlstm.init_slstm_cache(cfg, batch, device)
        raise ValueError(kind)

    reps = cfg.pattern_reps
    return {f"p{i}": tree_map(
        lambda x: x.expand((reps,) + tuple(x.shape)).clone(), one(kind))
        for i, kind in enumerate(cfg.layer_pattern)}


@torch.inference_mode()
def prefill(cfg: ArchConfig, params, tokens, caches, *, enc_frames=None,
            prefix_embeds=None):
    """Populate caches for positions [0, S); returns (last_logits, caches).

    Attention blocks write K/V for the whole prompt; SSM / xLSTM blocks
    run the chunked parallel form and store the final recurrent state.
    Enc-dec archs get the cross K/V as ``caches["xkv"]``.
    """
    x = _embed(cfg, params, tokens, prefix_embeds)
    enc_out, xkv = None, None
    if cfg.enc_dec:
        enc_out, xkv = _precompute_cross(cfg, params,
                                         encode(cfg, params, enc_frames))
    x, _ = _apply_stack(cfg, params, x, "prefill", caches=caches,
                        enc_out=enc_out)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = unembed_apply(cfg, params, x[:, -1:, :])
    if cfg.enc_dec:
        caches = {**caches, "xkv": xkv}       # [R, B, Se, g, hd] pair
    return logits, caches


@torch.inference_mode()
def prefill_chunked(cfg: ArchConfig, params, tokens, caches, *,
                    chunk_len: int = 2048):
    """Chunked prefill: a loop over prompt chunks, appending to the
    caches, so peak activation memory is O(chunk_len).  Needs
    cache-continuable blocks: attention, Mamba2 and sLSTM carry state
    across chunks; mLSTM ('X') does not, and enc-dec archs are refused
    too, as in the reference.

    Returns (last-token logits [B, 1, V], caches).
    """
    if "X" in cfg.layer_pattern or cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: chunked prefill needs cache-continuable blocks")
    s = tokens.shape[1]
    if s % chunk_len:
        raise ValueError(f"prompt {s} is not a multiple of chunk {chunk_len}")
    for i in trips("prefill.chunks", s // chunk_len):
        off = i * chunk_len
        x = _embed(cfg, params, tokens[:, off:off + chunk_len])
        x, _ = _apply_stack(cfg, params, x, "chunk", caches=caches, pos=off)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return unembed_apply(cfg, params, x[:, -1:, :]), caches


def _precompute_cross(cfg: ArchConfig, params, enc_out):
    """Per-decoder-layer cross K/V from encoder output: [R, B, Se, g, hd]."""
    b, se, _ = enc_out.shape
    shape = (cfg.pattern_reps, b, se, cfg.n_kv_heads, cfg.head_dim)
    attn = params["cross"]["attn"]
    tp = row_split(attn["wk"])
    if tp is None:
        k = torch.einsum("bsd,rdk->rbsk", enc_out, attn["wk"]).reshape(shape)
        v = torch.einsum("bsd,rdk->rbsk", enc_out, attn["wv"]).reshape(shape)
        return enc_out, (k, v)
    # a layer at a time, each position its columns, gathered on the home
    return enc_out, tuple(torch.stack([
        tp.columns_product(enc_out, attn[name][r])
        for r in range(cfg.pattern_reps)]).reshape(shape)
        for name in ("wk", "wv"))


@torch.inference_mode()
def decode_step(cfg: ArchConfig, params, token, caches, pos):
    """One decode step. token [B, 1] int; pos [B] per-row positions.

    Returns (logits [B, 1, V], caches), the caches written in place.  For
    enc_dec archs the caches carry "xkv" (the cross K/V from prefill),
    read and passed through unchanged.
    """
    x = embed_apply(params["embed"], token, cfg.embed_scale,
                    mode=_embed_mode(cfg))
    x, _ = _apply_stack(cfg, params, x, "decode", caches=caches, pos=pos)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return unembed_apply(cfg, params, x), caches


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

class _Tree(nn.Module):
    """A nested dict of tensors as nested modules; each leaf a frozen
    parameter whose state_dict key is its tree path ("stack.p0.attn.wq")."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))

    def params(self) -> Dict[str, Any]:
        """The parameter tree (the module's current tensors)."""
        out: Dict[str, Any] = dict(self._parameters)
        out.update({k: m.params() for k, m in self._modules.items()})
        return out


class Model(_Tree):
    """One architecture's parameters, owned for ``.to()`` and
    ``state_dict()``, with the module functions bound to them.

    ``params`` (the reference's tree, e.g. from ``interop``) is adopted
    as given; without it the parameters are drawn by ``init_params`` from
    ``generator`` (a fresh one seeded 0 if None) on ``device``.
    """

    def __init__(self, cfg: ArchConfig, *, params=None,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        if params is None:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            params = init_params(cfg, generator, device)
        super().__init__(params)
        self.cfg = cfg

    def forward(self, tokens, *, prefix_embeds=None, enc_frames=None):
        return forward(self.cfg, self.params(), tokens,
                       prefix_embeds=prefix_embeds, enc_frames=enc_frames)

    def init_decode_caches(self, batch: int, s_max: int):
        return init_decode_caches(self.cfg, batch, s_max,
                                  self.embed.device)

    def prefill(self, tokens, caches, *, enc_frames=None,
                prefix_embeds=None):
        return prefill(self.cfg, self.params(), tokens, caches,
                       enc_frames=enc_frames, prefix_embeds=prefix_embeds)

    def prefill_chunked(self, tokens, caches, *, chunk_len: int = 2048):
        return prefill_chunked(self.cfg, self.params(), tokens, caches,
                               chunk_len=chunk_len)

    def decode_step(self, token, caches, pos):
        return decode_step(self.cfg, self.params(), token, caches, pos)
