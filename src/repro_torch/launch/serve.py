"""Serving steps: prefill and decode, on one device or on a mesh (port
of the JAX package's ``launch/serve.py``).

Each step runs under ``torch.inference_mode()`` and writes the caches it
is given in place, returning them: the counterpart of the reference's
jitted steps, which donate their caches.

**Layouts** are the reference's: ``params_shardings`` (model-parallel
plus the ``data`` dim, FSDP-style) and ``cache_shardings``
(``cache_leaf_spec``: batch over ``data``, a KV cache's sequence dim
over ``model``, else the last divisible feature dim).

**On a mesh** (``make_prefill_step(cfg, mesh=)``,
``make_decode_step(cfg, mesh=)``, the parameters and caches placed by
those shardings) each data row, one after another, runs its batch shard
through the model under ``use_mesh`` with the reference's tensor
parallelism over ``model`` (``dist.sharding.RowSplit``): each of the
row's positions computes its own column, row, vocab and expert blocks on
its device, reading its block of a pattern group's weights when the
group runs, and the row's first position (its home) keeps the residual
stream; no position holds a ``model``-split leaf whole (but the
expert-parallel router, which the reference's ``shard_map`` replicates).
A sequence-split KV cache is seen in place as
``attention.SeqBlocks`` (prefill writes each position's S block; decode
writes the new K/V into the position that owns ``pos`` and combines the
positions' partial softmax statistics, the distributed flash decode the
reference's ``cache_leaf_spec`` asks of GSPMD); every other cache leaf
(SSM and xLSTM states, a cache whose S dim does not split) is gathered
for the step and written back to its shards, and handed to the positions
by heads where they need it.  The logits come back whole on the mesh's
first device.  The chunked prefill on a mesh
(``make_chunked_prefill_step(cfg, mesh=)``) gathers each row's cache
rows whole onto the row's device, runs ``prefill_chunked`` there and
writes them back: its chunks append at any offset, which the sequence
blocks of ``SeqBlocks`` do not take.

``lower_serve_step`` and ``lower_prefill_step`` build a step and its
placed fake arguments for the dry run (``launch/dryrun.py``).
"""

from __future__ import annotations

import torch

from repro_torch.dist.sharding import (Mesh, NamedSharding, P, RowSplit,
                                       Sharded, batch_axes, full_box, place,
                                       row_scope, rows, tree_map2,
                                       tree_map_with_path, use_mesh)
from repro_torch.launch.mesh import Lowered, fake_mode, placed, positions
from repro_torch.launch.train import param_spec, sanitize_spec, zero1_spec
from repro_torch.models import transformer as tf
from repro_torch.models.arch_config import ArchConfig
from repro_torch.models.attention import KVCache, SeqBlocks
from repro_torch.models.trips import each_row


def cache_leaf_spec(shape, mesh: Mesh) -> P:
    """[reps, B, ...]: B -> data; for 5-D KV caches [R, B, S, g, hd],
    prefer sharding the SEQUENCE dim over `model` (QK scores and PV then
    reduce locally per shard and only the softmax statistics cross:
    distributed flash decode).  Falls back to the last divisible feature
    dim (e.g. SSM states, odd sequence lengths)."""
    m = mesh.shape["model"] if "model" in mesh.axis_names else 1
    parts = [None] * len(shape)
    if len(shape) >= 2:
        d = mesh.shape.get("data", 1)
        if shape[1] % d == 0 and shape[1] >= d:
            parts[1] = "data"
    if len(shape) == 5 and shape[2] % m == 0 and shape[2] >= m:
        parts[2] = "model"     # the sequence dim of [R, B, S, g, hd]
        return P(*parts)
    # fall back: the last dim divisible by the model axis (feature-most)
    for i in range(len(shape) - 1, 1, -1):
        if shape[i] % m == 0 and shape[i] >= m:
            parts[i] = "model"
            break
    return P(*parts)


def cache_shardings(cfg: ArchConfig, mesh: Mesh, caches_shape):
    return tf.tree_map(
        lambda s: NamedSharding(mesh, cache_leaf_spec(s.shape, mesh)),
        caches_shape)


def params_shardings(cfg: ArchConfig, mesh: Mesh, params_shape):
    """Serving weights: model-parallel + data-dim sharding (FSDP-style),
    so that a data replica does not hold params / model."""
    def one(path, s):
        ps = param_spec(path, s, tied=cfg.tie_embeddings)
        return NamedSharding(mesh, zero1_spec(sanitize_spec(
            ps, s.shape, mesh), s.shape, mesh))
    return tree_map_with_path(one, params_shape)


def _xkv_builder(cfg: ArchConfig, batch: int):
    """The cross-attention K/V pair an enc-dec arch's prefill adds to its
    caches ([R, B, enc_seq, g, hd] each), as shapes (``meta``)."""
    def build():
        k = torch.zeros((cfg.pattern_reps, batch, cfg.enc_seq,
                         cfg.n_kv_heads, cfg.head_dim), dtype=tf._dtype(cfg),
                        device="meta")
        return (k, k)
    return build


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def make_decode_step(cfg: ArchConfig, mesh: Mesh = None):
    if mesh is not None:
        return _mesh_step(cfg, mesh, "decode")

    def serve_step(params, caches, token, pos):
        return tf.decode_step(cfg, params, token, caches, pos)
    return serve_step


def make_prefill_step(cfg: ArchConfig, mesh: Mesh = None):
    if mesh is not None:
        return _mesh_step(cfg, mesh, "prefill")

    def prefill_step(params, caches, tokens, **extras):
        return tf.prefill(cfg, params, tokens, caches, **extras)
    return prefill_step


def make_chunked_prefill_step(cfg: ArchConfig, chunk_len: int = 2048,
                              mesh: Mesh = None):
    """The prefill step over chunks of ``chunk_len`` tokens (the
    reference's ``lower_prefill_step(..., chunked=True)``), on one
    device or on a mesh.  As there, it takes no frontend extras: any
    given are ignored."""
    if mesh is not None:
        return _mesh_step(cfg, mesh, "chunked", chunk_len)

    def prefill_step(params, caches, tokens, **_):
        return tf.prefill_chunked(cfg, params, tokens, caches,
                                  chunk_len=chunk_len)
    return prefill_step


# ---------------------------------------------------------------------------
# the steps on a mesh
# ---------------------------------------------------------------------------

def _row_span(b: int, mesh: Mesh, r: int):
    """The batch rows data row ``r`` computes where the batch splits over
    the rows, else all of it on row 0 (and none elsewhere).  The rows of
    one ``data`` index (one a pod) take that index's block of the batch,
    pod by pod: a cache splits its batch over ``data`` alone
    (``cache_leaf_spec``), so each row's cache rows lie on its own
    positions and their replicas in the other pods."""
    n_rows = len(rows(mesh))
    if b % n_rows:
        return (0, b) if r == 0 else (0, 0)
    k, n_data = b // n_rows, mesh.shape.get("data", 1)
    pod, d = divmod(r, n_data)
    lo = (d * (n_rows // n_data) + pod) * k
    return lo, lo + k


def _on_home(x, home):
    """A step input (token ids, positions, frontend extras) whole on the
    mesh's first device, from which each row takes its rows: a row's
    rows need not be the block it holds (``_row_span``)."""
    return x.read(device=home) if isinstance(x, Sharded) else x


def _seq_view(x: Sharded, lo: int, hi: int, mine=()):
    """A KV cache leaf [R, B, S, g, hd] whose S dim is split over ``model`` alone
    (and B over the batch axes or not at all), as ``SeqBlocks`` over rows
    [lo, hi) of their holders (the positions ``mine`` first, then in
    position order), in place; None for any other leaf.  The other
    holders of the same blocks (replicas) are returned too, to be brought
    level after the step."""
    if x.ndim != 5 or tuple(x.sharding._parts(5)[2:]) != ("model", None,
                                                            None):
        return None
    parts, offsets, replicas = [], [], []
    seen = {}
    holders = list(mine) + [p for p in range(x.mesh.size) if p not in mine]
    for p in holders:
        blk = x.block(p)
        if not (blk[1].start <= lo and hi <= blk[1].stop):
            continue
        key = blk[2].start
        sub = x.shards[p][:, lo - blk[1].start:hi - blk[1].start]
        if key in seen:
            replicas.append((seen[key], sub))
            continue
        seen[key] = sub
        parts.append(sub)
        offsets.append(key)
    order = sorted(range(len(parts)), key=lambda i: offsets[i])
    return (SeqBlocks([parts[i] for i in order],
                      [offsets[i] for i in order], 2), replicas)


def _row_caches(caches, lo: int, hi: int, row, kind: str):
    """A data row's view of placed caches (rows [lo, hi) of the batch: a
    sequence-split leaf's blocks on the row's own positions where it
    holds them), and what to do after its step: (view tree, write-backs,
    replicas).
    An enc-dec arch's cross K/V (``"xkv"``) is read whole by decode and
    left out of prefill, which makes it anew."""
    back, reps = [], []

    def box_of(x):
        box = full_box(x.shape)
        return box[:1] + (slice(lo, hi),) + box[2:]

    device = row.device

    def one(x, kv: bool):
        seq = (_seq_view(x, lo, hi, row.positions)
               if kv and kind != "chunked" else None)
        if seq is not None:
            reps.extend(seq[1])
            return seq[0]
        t = x.read(box_of(x), device)
        back.append((x, box_of(x), t))
        return t

    view = {k: KVCache(*(one(x, True) for x in v)) if isinstance(v, KVCache)
            else tf.tree_map(lambda x: one(x, False), v)
            for k, v in caches.items() if k != "xkv"}
    if "xkv" in caches and kind == "decode":
        view["xkv"] = tf.tree_map(lambda x: x.read(box_of(x), device),
                                  caches["xkv"])
    return view, back, reps


def _mesh_step(cfg: ArchConfig, mesh: Mesh, kind: str, chunk_len=None):
    data_rows = rows(mesh)
    home = mesh.devices[0]
    if not batch_axes(mesh):
        raise ValueError(f"a mesh without a data axis: {mesh}")

    @torch.inference_mode()
    def step(params, caches, tokens, pos=None, **extras):
        b = tokens.shape[0]
        tokens, pos = _on_home(tokens, home), _on_home(pos, home)
        extras = {k: _on_home(v, home) for k, v in extras.items()}
        # each row writes its part of the outputs, made whole up front
        logits = torch.empty((b, 1, cfg.vocab_padded), dtype=torch.float32,
                             device=home)
        xkv = None
        if kind == "prefill" and cfg.enc_dec:
            xkv = tuple(torch.empty(
                (cfg.pattern_reps, b, cfg.enc_seq, cfg.n_kv_heads,
                 cfg.head_dim), dtype=tf._dtype(cfg), device=home)
                for _ in range(2))
        for row in each_row(data_rows):
            lo, hi = _row_span(b, mesh, row.index)
            if lo == hi:
                continue
            view = RowSplit(row).view(params)
            toks = tokens[lo:hi].to(row.device)
            cview, back, reps = _row_caches(caches, lo, hi, row, kind)
            with use_mesh(mesh), row_scope(row):
                if kind == "decode":
                    out, cview = tf.decode_step(
                        cfg, view, toks, cview,
                        pos[lo:hi].to(row.device))
                elif kind == "chunked":
                    out, cview = tf.prefill_chunked(cfg, view, toks, cview,
                                                    chunk_len=chunk_len)
                else:
                    out, cview = tf.prefill(
                        cfg, view, toks, cview,
                        **{k: v[lo:hi].to(row.device)
                           for k, v in extras.items()})
            for x, box, t in back:
                x.write(box, t)
            for src, dst in reps:
                dst.copy_(src.to(dst.device))
            if xkv is not None:
                for whole, part in zip(xkv, cview["xkv"]):
                    whole[:, lo:hi] = part.to(home)
            logits[lo:hi] = out.to(home)
            del view
        if xkv is not None:
            sh = NamedSharding(mesh, cache_leaf_spec(xkv[0].shape, mesh))
            caches = {**caches, "xkv": tuple(place(t, sh) for t in xkv)}
        return logits, caches

    if kind == "decode":
        def serve_step(params, caches, token, pos):
            return step(params, caches, token, pos)
        return serve_step

    if kind == "chunked":
        def chunked_step(params, caches, tokens, **_):
            return step(params, caches, tokens)
        return chunked_step

    def prefill_step(params, caches, tokens, **extras):
        return step(params, caches, tokens, **extras)
    return prefill_step


# ---------------------------------------------------------------------------
# the lowerings for the dry run
# ---------------------------------------------------------------------------

def _token_sharding(mesh: Mesh, shape) -> NamedSharding:
    bax = ("pod", "data") if "pod" in mesh.axis_names else "data"
    return NamedSharding(mesh, sanitize_spec(P(bax, *([None] * (len(shape)
                                                                - 1))),
                                             shape, mesh))


def _placed_tree(mesh, device, shapes, shardings):
    if mesh is None:
        return tf.tree_map(lambda s: placed(None, device, s.shape, s.dtype),
                           shapes)
    return tree_map2(lambda s, n: placed(mesh, device, s.shape, s.dtype, n),
                     shapes, shardings)


def lower_serve_step(cfg: ArchConfig, mesh: Mesh, *, batch: int,
                     seq_len: int, specs, device="cpu:0"):
    """One decode step and its placed fake arguments, for the dry run:
    the parameters by ``params_shardings``, the caches (``seq_len``
    long, with an enc-dec arch's cross K/V) by ``cache_shardings``, the
    token and position over the batch axes where they divide.  ``mesh``
    None is the one-device step on ``device``.  Returns a
    ``launch.mesh.Lowered``."""
    params_shape = tf.init_params(cfg, None, "meta")
    caches_shape = tf.init_decode_caches(cfg, batch, seq_len, device="meta")
    if cfg.enc_dec:
        caches_shape = {**caches_shape, "xkv": _xkv_builder(cfg, batch)()}
    mode = fake_mode()
    with mode:
        p_sh = c_sh = t_sh = pos_sh = None
        if mesh is not None:
            p_sh = params_shardings(cfg, mesh, params_shape)
            c_sh = cache_shardings(cfg, mesh, caches_shape)
            t_sh = _token_sharding(mesh, specs["token"][0])
            pos_sh = _token_sharding(mesh, specs["pos"][0])
        params = _placed_tree(mesh, device, params_shape, p_sh)
        caches = _placed_tree(mesh, device, caches_shape, c_sh)
        token = placed(mesh, device, *specs["token"], t_sh)
        pos = placed(mesh, device, *specs["pos"], pos_sh)
    return Lowered("decode", make_decode_step(cfg, mesh),
                   (params, caches, token, pos), {}, mesh,
                   positions(mesh, device), mode)


def lower_prefill_step(cfg: ArchConfig, mesh: Mesh, *, batch: int,
                       seq_len: int, specs, chunked: bool = False,
                       chunk_len: int = 2048, device="cpu:0"):
    """The prefill step (over chunks of ``chunk_len`` where ``chunked``)
    and its placed fake arguments, for the dry run: caches sized to the
    prompt (``seq_len`` plus a ViT front end's tokens, as the reference
    sizes them), the tokens and frontend extras over the batch axes.
    ``mesh`` None is the one-device step on ``device``.  Returns a
    ``launch.mesh.Lowered``."""
    params_shape = tf.init_params(cfg, None, "meta")
    cache_len = seq_len + (cfg.frontend_tokens if cfg.frontend == "vit"
                           else 0)
    caches_shape = tf.init_decode_caches(cfg, batch, cache_len,
                                         device="meta")
    mode = fake_mode()
    with mode:
        p_sh = c_sh = None
        if mesh is not None:
            p_sh = params_shardings(cfg, mesh, params_shape)
            c_sh = cache_shardings(cfg, mesh, caches_shape)
        params = _placed_tree(mesh, device, params_shape, p_sh)
        caches = _placed_tree(mesh, device, caches_shape, c_sh)
        inputs = {k: placed(mesh, device, s, dt,
                            None if mesh is None else _token_sharding(mesh, s))
                  for k, (s, dt) in specs.items()}
    tokens = inputs.pop("tokens")
    step = (make_chunked_prefill_step(cfg, chunk_len, mesh) if chunked
            else make_prefill_step(cfg, mesh))
    return Lowered("prefill", step, (params, caches, tokens), inputs, mesh,
                   positions(mesh, device), mode)
