"""The training step, on one device or on a mesh (port of the JAX
package's ``launch/train.py``).

* **Microbatches.** The global batch is split into ``n = min(n_micro,
  b)`` contiguous blocks of ``b // n`` rows, run one after another: each
  block's gradients come out of autograd in the parameter dtype and are
  added, as float32 divided by ``n``, into one float32 buffer; the loss
  is summed as ``loss / n``.  This bounds logits and activation memory,
  as the reference's microbatch scan does.
* **The update.** The cosine learning rate at ``state.opt.step``, then
  ``adamw_update`` or, under ``opt_8bit``, ``adamw8_update``.  The step
  updates the state's tensors in place and returns them, as the
  reference's jitted step donates its state.
* **Layouts.** ``param_spec``, ``sanitize_spec``, ``zero1_spec``,
  ``train_param_specs``, ``state_shardings`` and ``batch_specs`` are the
  reference's, over the port's trees (a leaf's path is its dict keys, as
  ``jax.tree_util`` sees them).  On one device ``zero1``, ``fsdp`` and
  ``sequence_parallel`` are ignored, as the reference ignores them.

**On a mesh** (``make_train_step(cfg, tcfg, mesh)``, the state placed by
``state_shardings``, the batch by ``batch_specs`` or given whole), what
GSPMD derives for the reference is done by hand:

* each data row (the positions along (``pod``,) ``data``) runs the
  microbatch loop on its batch shard, one row after another: it gathers
  every parameter from its shards onto the row's device (FSDP), and
  frees them before the next row; under ``use_mesh`` an untied table is
  looked up one-hot and an MoE layer runs expert-parallel over the row's
  ``model`` positions (``moe_apply_dist``);
* the row's pieces of the batch are the reference's groups: the
  reference splits each of its ``n`` microbatches over the rows, so a
  row processes ``chunk = b / (n * rows)`` rows at a time (``b / n``
  where that does not split); each piece's loss is weighted so that the
  sum over rows is the reference's loss: the mean of each microbatch's
  token cross-entropy over its valid labels, plus its aux loss averaged
  over the rows (the reference's ``pmean``);
* after every piece the row's gradients are reduce-scattered into the
  ZeRO-1 layout (``param_spec`` -> ``sanitize_spec`` -> ``zero1_spec``):
  each position adds its block, as float32, into its own buffer; no
  position keeps a whole float32 gradient tree;
* the clip norm is a sum over positions of per-block sums of squares,
  each block counted once, leaf by leaf in the reference's order; then
  each distinct block of the moments is updated once (AdamW8: whole rows
  of the last dim, where its quantization blocks run) and written to
  every position that holds it, parameters included.

Dense tensor parallelism over ``model`` is not written by hand: a row
computes dense blocks on its gathered weights.

``lower_train_step`` builds the step and its placed fake arguments for
the dry run (``launch/dryrun.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.dist.sharding import (RULES_2D, RULES_3D, Mesh,
                                       NamedSharding, P, Sharded, axes_of,
                                       batch_axes, full_box, link_kind,
                                       row_scope, rows, sp_rules, tree_map2,
                                       tree_map_with_path, use_mesh, zeros)
from repro_torch.launch.mesh import Lowered, fake_mode, placed, positions
from repro_torch.models import transformer as tf
from repro_torch.models.arch_config import ArchConfig
from repro_torch.models.trips import each_copy, each_row, trips
from repro_torch.optim import (AdamW8State, AdamWState, adamw8_init,
                               adamw8_update, adamw_init, adamw_update,
                               cosine_schedule)
from repro_torch.optim._tree import sorted_paths
from repro_torch.optim.adamw import adamw_leaf, bias_corrections
from repro_torch.optim.adamw8 import adamw8_leaf


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_micro: int = 8
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # ZeRO-1: f32 moments (and always the f32 gradient buffer) sharded
    # over `data` as well
    zero1: bool = True
    # FSDP: parameters sharded over `data` as well (gathered per row)
    fsdp: bool = True
    # sequence parallelism on the residual carry: a layout knob of the
    # reference's lowering; the port's rows compute it unsharded
    sequence_parallel: bool = False
    # 8-bit Adam moments (repro_torch.optim.adamw8)
    opt_8bit: bool = False


class TrainState(NamedTuple):
    params: Any
    opt: Any          # AdamWState or AdamW8State


# ---------------------------------------------------------------------------
# parameter / state sharding rules
# ---------------------------------------------------------------------------

_COL = {"wq", "wk", "wv", "wi_gate", "wi_up", "in_proj", "w_x", "w_if",
        "router"}   # [d_in, d_out-sharded]
_ROW = {"wo", "out_proj"}  # [d_in-sharded, d_out]
_EMBED = {"embed", "unembed"}


def _leaf_name(path) -> str:
    """The last dict key of a path (tuple positions are skipped, as the
    reference skips NamedTuple fields and sequence indices)."""
    for p in reversed(path):
        if isinstance(p, str):
            return p
    return ""


def _stacked(path) -> bool:
    return bool(path) and path[0] in ("stack", "enc_stack", "cross")


def param_spec(path, leaf, *, tied: bool = True) -> P:
    """Logical partitioning of one parameter leaf on a (data, model) mesh:
    embeddings vocab-sharded (an untied arch looks them up one-hot), the
    column and row projections and the experts over ``model``, a stacked
    leaf's leading reps dim unsharded."""
    name = _leaf_name(path)
    nd = len(leaf.shape)
    extra = 1 if _stacked(path) else 0   # leading reps axis of the stack

    if name in _EMBED:
        return P("model", None)
    core = nd - extra
    if name in _COL and core == 2:
        spec = (None, "model")
    elif name in _ROW and core == 2:
        spec = ("model", None)
    elif name in ("wi_gate", "wi_up", "wo") and core == 3:  # MoE experts
        spec = ("model", None, None)
    else:
        spec = (None,) * core
    return P(*((None,) * extra + spec))


def sanitize_spec(spec: P, shape, mesh: Mesh) -> P:
    """Drop sharding axes whose size does not divide the dim (e.g. tiny
    gate projections like xLSTM's [D, 2H] with 2H=8 on a 16-way model
    axis)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for p, n in zip(parts, shape):
        keep = []
        prod = 1
        for a in axes_of(p):
            if a in mesh.shape and n % (prod * mesh.shape[a]) == 0:
                keep.append(a)
                prod *= mesh.shape[a]
        out.append(tuple(keep) if len(keep) > 1 else
                   (keep[0] if keep else None))
    return P(*out)


def zero1_spec(spec: P, shape, mesh: Mesh) -> P:
    """Add the `data` axis to the first unsharded, divisible dim (ZeRO-1).

    Idempotent: specs already carrying `data` (e.g. FSDP-sharded params)
    are returned unchanged.  Handles tuple axes like ('model', 'data').
    """
    if "data" not in mesh.axis_names:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    if any("data" in axes_of(p) for p in parts):
        return spec
    d = mesh.shape["data"]
    for i, (p, n) in enumerate(zip(parts, shape)):
        cur = 1
        for a in axes_of(p):
            cur *= mesh.shape[a]
        local = n // cur
        if n % cur == 0 and local % d == 0 and local >= d:
            parts[i] = "data" if p is None else axes_of(p) + ("data",)
            return P(*parts)
    return spec


_NO_FSDP = _EMBED | {"router"}
# embed/unembed: FSDP over the vocab dim turns every token lookup into a
# cross-(model x data) gather in the reference's lowering; router: the
# expert-parallel path wants it replicated and it is ~2 MB.


def train_param_specs(cfg: ArchConfig, tcfg: TrainConfig, mesh: Mesh,
                      params_shape):
    """PartitionSpec tree for params (model-parallel + optional FSDP)."""
    def one(path, s):
        ps = sanitize_spec(param_spec(path, s, tied=cfg.tie_embeddings),
                           s.shape, mesh)
        if tcfg.fsdp and _leaf_name(path) not in _NO_FSDP:
            ps = zero1_spec(ps, s.shape, mesh)
        return ps
    return tree_map_with_path(one, params_shape)


def state_shardings(cfg: ArchConfig, tcfg: TrainConfig, mesh: Mesh,
                    state_shape) -> TrainState:
    """NamedShardings for a TrainState (of meta tensors, e.g.
    ``init_train_state(cfg, None, tcfg, device="meta")``)."""
    pspecs = train_param_specs(cfg, tcfg, mesh, state_shape.params)

    def opt_spec(ps, shape):
        spec = sanitize_spec(ps, shape.shape, mesh)
        if tcfg.zero1:
            spec = zero1_spec(spec, shape.shape, mesh)
        return spec

    def specs_map(fn, shapes):
        return tree_map2(lambda s, ps: fn(ps, s), shapes, pspecs)

    opt_shape = state_shape.opt
    params_sh = tree_map2(lambda s, ps: NamedSharding(mesh, ps),
                          state_shape.params, pspecs)
    if hasattr(opt_shape, "q_mu"):   # AdamW8State
        # int8 moments share the param layout; blockwise scales drop the
        # last dim (keep the leading dims of the param spec)
        def scale_spec(ps, s):
            return opt_spec(P(*list(ps)[:max(len(s.shape) - 1, 0)]), s)

        def sh(fn, shapes):
            return specs_map(lambda ps, s: NamedSharding(mesh, fn(ps, s)),
                             shapes)
        return TrainState(params=params_sh, opt=AdamW8State(
            step=NamedSharding(mesh, P()),
            q_mu=sh(opt_spec, opt_shape.q_mu),
            s_mu=sh(scale_spec, opt_shape.s_mu),
            q_nu=sh(opt_spec, opt_shape.q_nu),
            s_nu=sh(scale_spec, opt_shape.s_nu)))

    def moments(shapes):
        return specs_map(lambda ps, s: NamedSharding(mesh, opt_spec(ps, s)),
                         shapes)
    return TrainState(params=params_sh, opt=AdamWState(
        step=NamedSharding(mesh, P()), mu=moments(opt_shape.mu),
        nu=moments(opt_shape.nu)))


def batch_specs(cfg: ArchConfig, mesh: Mesh) -> Dict[str, NamedSharding]:
    bax = ("pod", "data") if "pod" in mesh.axis_names else "data"
    out = {"tokens": NamedSharding(mesh, P(bax, None)),
           "labels": NamedSharding(mesh, P(bax, None))}
    if cfg.frontend == "vit":
        out["prefix_embeds"] = NamedSharding(mesh, P(bax, None, None))
    if cfg.frontend == "audio":
        out["enc_frames"] = NamedSharding(mesh, P(bax, None, None))
    return out


def grad_shardings(cfg: ArchConfig, mesh: Mesh, params_shape):
    """The float32 gradient buffer's layout (the reference's
    ``constrain_grads``): ``param_spec`` -> ``sanitize_spec`` ->
    ``zero1_spec``, whatever ``fsdp`` and ``zero1`` say."""
    def one(path, s):
        ps = sanitize_spec(param_spec(path, s, tied=cfg.tie_embeddings),
                           s.shape, mesh)
        return NamedSharding(mesh, zero1_spec(ps, s.shape, mesh))
    return tree_map_with_path(one, params_shape)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def init_train_state(cfg: ArchConfig, generator: Optional[torch.Generator],
                     tcfg: Optional[TrainConfig] = None,
                     device="cuda") -> TrainState:
    """Parameters drawn by ``tf.init_params`` from ``generator`` on
    ``device``, and the optimizer's zero state."""
    params = tf.init_params(cfg, generator, device)
    opt8 = tcfg is not None and tcfg.opt_8bit
    return TrainState(params=params,
                      opt=adamw8_init(params) if opt8 else adamw_init(params))


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tf.tree_map(lambda _: next(it), tree)


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig,
                    mesh: Optional[Mesh] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``, with
    ``metrics = {"loss", "grad_norm", "lr"}`` as 0-dim float32 tensors.
    ``batch`` holds ``tokens`` and ``labels`` [B, S], and
    ``prefix_embeds`` / ``enc_frames`` where the arch's frontend takes
    them: tensors on the parameters' device, or on a mesh ``Sharded``
    leaves placed by ``batch_specs`` (or whole tensors).  On a mesh the
    state's leaves are ``Sharded``, placed by ``state_shardings``."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.dist Mesh (make_mesh), "
                        f"not {type(mesh).__name__}")
    if mesh is not None and not mesh.empty:
        return _mesh_train_step(cfg, tcfg, mesh)

    def accum_grads(params, batch):
        b = batch["tokens"].shape[0]
        n = min(tcfg.n_micro, b)
        micro = {k: v.reshape((n, b // n) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        leaves = tf.tree_leaves(params)
        live = tf.tree_map(lambda t: t.detach().requires_grad_(), params)
        inputs = tf.tree_leaves(live)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in trips("microbatches", n):
            loss, _ = tf.loss_fn(cfg, live, {k: v[i] for k, v in
                                             micro.items()})
            grads = torch.autograd.grad(loss, inputs, allow_unused=True)
            for a, g in zip(acc, grads):
                if g is not None:
                    a.add_(g.float() / n)
            del grads
            total = total + loss.detach() / n
        return _unflatten(params, acc), total

    def train_step(state: TrainState, batch):
        grads, loss = accum_grads(state.params, batch)
        lr = cosine_schedule(state.opt.step, peak_lr=tcfg.peak_lr,
                             warmup=tcfg.warmup, total=tcfg.total_steps)
        update = adamw8_update if tcfg.opt_8bit else adamw_update
        params, opt, metrics = update(
            state.params, grads, state.opt, lr=lr,
            weight_decay=tcfg.weight_decay, clip_norm=tcfg.clip_norm)
        metrics["loss"] = loss
        return TrainState(params, opt), metrics

    return train_step


# ---------------------------------------------------------------------------
# the step on a mesh
# ---------------------------------------------------------------------------

def _batch_rows(x, lo: int, hi: int, device) -> torch.Tensor:
    """Rows [lo, hi) of a batch leaf (``Sharded`` or whole) on ``device``."""
    if isinstance(x, Sharded):
        return x.read((slice(lo, hi),) + full_box(x.shape)[1:], device)
    return x[lo:hi].to(device)


def _pieces(b: int, n_micro: int, n_rows: int):
    """(n, rows of a microbatch, rows of a piece): the reference's ``n``
    microbatches, each split over the mesh's rows where it divides."""
    n = min(n_micro, b)
    if b % n or b % n_rows:
        raise ValueError(f"a batch of {b} rows does not split into {n} "
                         f"microbatches over {n_rows} data rows")
    mb = b // n
    piece = mb // n_rows if mb % n_rows == 0 else mb
    if (b // n_rows) % piece:
        raise ValueError(f"microbatches of {mb} rows do not tile the "
                         f"{b // n_rows} rows of a data row")
    return n, mb, piece


def scatter_add(acc: Sharded, g: torch.Tensor) -> None:
    """One row's contribution to the ZeRO-1 reduce-scatter: each
    position adds its block of ``g``, as float32, into its shard."""
    blocks = acc.layout.blocks
    with link_kind("reduce-scatter"):
        for p, s in each_copy(enumerate(acc.shards)):
            s.add_(g[blocks[p]].float().to(s.device))


def sharded_grad_norm(grads, device) -> torch.Tensor:
    """sqrt(sum of squares + 1e-20) over every leaf of a ``Sharded``
    tree, each distinct block counted once, the leaves in the reference's
    order, on ``device``."""
    total = torch.zeros((), dtype=torch.float32, device=device)
    with link_kind("all-reduce"):
        for _, g in sorted_paths(grads):
            leaf = torch.zeros((), dtype=torch.float32, device=device)
            for p in g.owners():
                leaf = leaf + torch.sum(torch.square(g.shards[p])).to(device)
            total = total + leaf
    return torch.sqrt(total + 1e-20)


def _regions(x: Sharded, whole_last: bool = False):
    """The distinct blocks of ``x`` (with the last dim whole where
    ``whole_last``), each with the device of a position that holds it
    (``dist.sharding.Layout.regions``, found once per layout)."""
    devices = x.mesh.devices
    return [(box, devices[p]) for box, p in
            x.layout.regions(x.shape, whole_last and x.ndim > 0)]


def _sharded_update(params, grads, opt, *, tcfg: TrainConfig, lr, gnorm,
                    b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8):
    """The AdamW (or AdamW8) update of placed state, in place: each
    distinct block of the moments computed once on a device that holds
    it and written to every position that holds any of it."""
    step_sh = opt.step
    for s in step_sh.shards:
        s.add_(1)
    step = step_sh.shards[0]
    scale = torch.clamp(tcfg.clip_norm / gnorm, max=1.0)
    b1c, b2c = bias_corrections(step, b1, b2)
    kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=tcfg.weight_decay)

    def consts(dev):
        return dict(scale=scale.to(dev), lr=lr.to(dev), b1c=b1c.to(dev),
                    b2c=b2c.to(dev), **kw)

    if tcfg.opt_8bit:
        for p, g, qm, sm, qn, sn in zip(*(tf.tree_leaves(t) for t in (
                params, grads, opt.q_mu, opt.s_mu, opt.q_nu, opt.s_nu))):
            for box, dev in _regions(qm, whole_last=True):
                sbox = box[:-1] + (slice(0, sm.shape[-1]),)
                pr, gr = p.read(box, dev), g.read(box, dev)
                qmr, qnr = qm.read(box, dev), qn.read(box, dev)
                smr, snr = sm.read(sbox, dev), sn.read(sbox, dev)
                adamw8_leaf(pr, gr, qmr, smr, qnr, snr, **consts(dev))
                for dst, b_, v in ((p, box, pr), (qm, box, qmr),
                                   (qn, box, qnr), (sm, sbox, smr),
                                   (sn, sbox, snr)):
                    dst.write(b_, v)
        return
    for p, g, m, v in zip(*(tf.tree_leaves(t) for t in (
            params, grads, opt.mu, opt.nu))):
        for box, dev in _regions(m):
            pr, gr = p.read(box, dev), g.read(box, dev)
            mr, vr = m.read(box, dev), v.read(box, dev)
            adamw_leaf(pr, gr, mr, vr, **consts(dev))
            for dst, val in ((p, pr), (m, mr), (v, vr)):
                dst.write(box, val)


class _Shape:
    """A leaf's shape alone, for the layout functions (which read
    ``.shape``): the step makes no tensor to stand for one."""

    __slots__ = ("shape",)

    def __init__(self, shape):
        self.shape = shape


def _mesh_train_step(cfg: ArchConfig, tcfg: TrainConfig, mesh: Mesh):
    data_rows = rows(mesh)
    home = mesh.devices[0]
    if not batch_axes(mesh):
        raise ValueError(f"a mesh without a data axis: {mesh}")

    def train_step(state: TrainState, batch):
        tokens = batch["tokens"]
        b = tokens.shape[0]
        n, mb, piece = _pieces(b, tcfg.n_micro, len(data_rows))
        per_row = b // len(data_rows)
        # each piece's weight: its valid labels over its microbatch's, / n
        valid = (_batch_rows(batch["labels"], 0, b, home) >= 0).sum(1)
        micro_n = valid.reshape(n, mb).sum(1).clamp(min=1)
        piece_n = valid.reshape(b // piece, piece).sum(1).clamp(min=1)
        w_xent = (piece_n.float() / micro_n.repeat_interleave(
            mb // piece).float()) / n
        w_aux = 1.0 / (n * (mb // piece))

        shapes = tf.tree_map(lambda s: _Shape(s.shape), state.params)
        acc = tree_map2(lambda s, sh: zeros(s.shape, torch.float32, sh),
                        shapes, grad_shardings(cfg, mesh, shapes))
        acc_leaves = tf.tree_leaves(acc)
        loss = torch.zeros((), dtype=torch.float32, device=home)
        for row in each_row(data_rows):
            live = tf.tree_map(lambda s: s.read(device=row.device)
                               .requires_grad_(), state.params)
            inputs = tf.tree_leaves(live)
            for j in trips("pieces", per_row // piece):
                lo = row.index * per_row + j * piece
                c = lo // piece
                part = {k: _batch_rows(v, lo, lo + piece, row.device)
                        for k, v in batch.items()}
                with use_mesh(mesh), row_scope(row):
                    _, terms = tf.loss_fn(cfg, live, part)
                    weighted = (terms["xent"] * w_xent[c].to(row.device)
                                + terms["aux"] * w_aux)
                    grads = torch.autograd.grad(weighted, inputs,
                                                allow_unused=True)
                for a, g in zip(acc_leaves, grads):
                    if g is not None:
                        scatter_add(a, g)
                del grads
                loss = loss + weighted.detach().to(home)
            del live, inputs
        gnorm = sharded_grad_norm(acc, home)
        lr = cosine_schedule(state.opt.step.shards[0], peak_lr=tcfg.peak_lr,
                             warmup=tcfg.warmup, total=tcfg.total_steps)
        _sharded_update(state.params, acc, state.opt, tcfg=tcfg, lr=lr,
                        gnorm=gnorm)
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step



# ---------------------------------------------------------------------------
# the lowering for the dry run
# ---------------------------------------------------------------------------

def lower_train_step(cfg: ArchConfig, tcfg: TrainConfig,
                     mesh: Optional[Mesh], specs, *, device="cpu:0"):
    """The train step and its placed fake arguments, for the dry run
    (nothing allocated, nothing traced yet): the state by
    ``state_shardings``, the batch by ``batch_specs`` (``specs``: name ->
    (shape, dtype), as ``configs.shapes.input_specs`` gives them), under
    ``RULES_2D`` / ``RULES_3D`` or their ``sp_rules``, as the reference
    lowers it.  The port's layouts do not read those rules (placement
    owns layout, ``dist.sharding.shard`` is an identity), so
    ``sequence_parallel`` traces the same program.  ``mesh`` None is
    the one-device step on ``device``.  Returns a
    ``launch.mesh.Lowered``."""
    rules = None
    if mesh is not None:
        base = RULES_3D if "pod" in mesh.axis_names else RULES_2D
        rules = sp_rules(base) if tcfg.sequence_parallel else base
    shape = init_train_state(cfg, None, tcfg, device="meta")
    mode = fake_mode()
    with mode:
        if mesh is None:
            state = tf.tree_map(lambda s: placed(None, device, s.shape,
                                                 s.dtype), shape)
            batch = {k: placed(None, device, s, dt)
                     for k, (s, dt) in specs.items()}
        else:
            with use_mesh(mesh, rules):
                st_sh = state_shardings(cfg, tcfg, mesh, shape)
                b_sh = batch_specs(cfg, mesh)
            state = tree_map2(lambda s, n: placed(mesh, device, s.shape,
                                                  s.dtype, n), shape, st_sh)
            batch = {k: placed(mesh, device, s, dt, b_sh[k])
                     for k, (s, dt) in specs.items()}
    return Lowered("train", make_train_step(cfg, tcfg, mesh),
                   (state, batch), {}, mesh, positions(mesh, device), mode,
                   rules)
