"""Mixture-of-Experts FFN: token-choice top-k routing with capacity (port
of the JAX package's ``models/moe.py``, single device).

Dispatch is sort-based: assignments are ranked within their expert by a
segment rank, dropped beyond capacity, and the dispatched activations
[E, C, D] are built with one gather and one scatter.  The per-expert
FFNs run as batched matrix products over the expert axis.  The router
runs in f32; an auxiliary load-balance loss (Switch-style) is returned
for the trainer.

Under a mesh with a ``model`` axis that divides the experts,
``moe_apply`` takes the reference's expert-parallel path,
``moe_apply_dist``: each ``model`` position of a data row runs
``_moe_local`` on its own device over its expert shard and the row's
tokens, and the partial outputs are summed over ``model``.

Under a serving step's tensor parallelism (the parameters are
``dist.sharding.Blocks``) each position reads its own experts' block and
the router whole, as the reference's ``shard_map`` takes it (replicated,
``in_specs`` ``P()``): every position routes the row's tokens.

Matching the reference's semantics where torch's defaults differ:

* ``lax.top_k`` breaks ties toward the lower index: a stable descending
  sort does too (``torch.topk`` promises no order among ties);
* the ``mode="drop"`` dispatch scatter drops the out-of-capacity slot:
  here it lands on one spill row that is sliced off;
* the combine adds a token's k contributions in ``x.dtype``, in order
  (``ft`` is ``repeat(arange(t), k)``): the k slices are summed in
  order, where ``index_add_`` on the card would add them atomically in
  no fixed order.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import (Blocks, Mesh, current_mesh,
                                       current_row, home, link_kind, pmean,
                                       row_split, rows, spec)
from repro_torch.models.arch_config import ArchConfig
from repro_torch.models.layers import truncated_normal


def moe_init(generator, cfg: ArchConfig, dtype, device="cuda") -> dict:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_expert
    return {
        "router": truncated_normal(generator, (d, e), torch.float32,
                                   d ** -0.5, device),
        "wi_gate": truncated_normal(generator, (e, d, f), dtype, d ** -0.5,
                                    device),
        "wi_up": truncated_normal(generator, (e, d, f), dtype, d ** -0.5,
                                  device),
        "wo": truncated_normal(generator, (e, f, d), dtype, f ** -0.5,
                               device),
    }


def capacity(cfg: ArchConfig, tokens: int) -> int:
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(4, (c + 3) // 4 * 4)


def moe_apply(params, cfg: ArchConfig, x) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """x: [B, S, D] -> (y [B, S, D], aux_loss scalar).

    Under an active mesh with a `model` axis that divides the experts
    this routes through the expert-parallel path (moe_apply_dist);
    otherwise it runs the local sort-based dispatch directly."""
    mesh = current_mesh()
    if mesh is not None and "model" in mesh.axis_names \
            and cfg.n_experts % mesh.shape["model"] == 0:
        return moe_apply_dist(params, cfg, x, mesh)
    return _moe_local({k: home(w) for k, w in params.items()}, cfg, x)


def _moe_local(params, cfg: ArchConfig, x,
               experts_slice=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based capacity dispatch on local tensors.

    experts_slice=(lo, n_local): compute only experts [lo, lo+n_local)
    (``params``' expert leaves hold just that shard); the other experts'
    assignments contribute 0 and the caller sums over the shards."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(cfg, t)
    dev = x.device
    xt = x.reshape(t, d)

    # ---- routing (f32) ----
    probs = torch.softmax(xt.float() @ params["router"], dim=-1)
    srt, sidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = srt[:, :k], sidx[:, :k]                # [T, k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # ---- load-balance aux (Switch): E * sum_e f_e * p_e ----
    me = probs.mean(0)                                 # mean router prob
    fe = eidx.reshape(-1)                              # [T*k]
    ce = torch.zeros((e,), dtype=torch.float32, device=dev).index_add_(
        0, fe, torch.full((t * k,), 1.0 / (t * k), dtype=torch.float32,
                          device=dev))                 # token fraction
    aux = e * torch.sum(me * ce) * cfg.router_aux_weight

    # ---- capacity ranks: segment-rank of each assignment in its expert ----
    ft = torch.arange(t, device=dev).repeat_interleave(k)
    fg = gate.reshape(-1)
    se, order = torch.sort(fe, stable=True)
    first = torch.searchsorted(se, se, side="left")
    rank = torch.empty_like(fe)
    rank[order] = torch.arange(t * k, device=dev) - first
    keep = rank < c

    # expert-parallel slice: this shard computes experts [lo, lo + ne)
    if experts_slice is not None:
        lo, ne = experts_slice
        mine = keep & (fe >= lo) & (fe < lo + ne)
        slot = torch.where(mine, (fe - lo) * c + rank, ne * c)
    else:
        ne, mine = e, keep
        slot = torch.where(mine, fe * c + rank, e * c)  # e * c: dropped

    # ---- dispatch: gather tokens into [E, C, D] (row ne * c spills) ----
    xd = torch.zeros((ne * c + 1, d), dtype=x.dtype, device=dev)
    xd[slot] = xt[ft]
    xd = xd[:ne * c].reshape(ne, c, d)

    # ---- per-expert FFN: batched products over the expert axis ----
    h = F.silu(torch.bmm(xd, params["wi_gate"])) * torch.bmm(
        xd, params["wi_up"])
    yd = torch.bmm(h, params["wo"]).reshape(ne * c, d)

    # ---- combine: each token's k weighted contributions, in order ----
    contrib = yd[slot.clamp(max=ne * c - 1)] * fg[:, None].to(x.dtype)
    contrib = torch.where(mine[:, None], contrib, 0).reshape(t, k, d)
    y = torch.zeros((t, d), dtype=x.dtype, device=dev)
    for j in range(k):
        y = y + contrib[:, j]
    return y.reshape(b, s, d), aux


def _ep_row(params, cfg: ArchConfig, x, devices, n_local: int):
    """One data row: each of its ``model`` positions (``devices``, in
    ``model`` order) runs ``_moe_local`` over its expert shard and the
    row's tokens on its own device; the partial outputs are summed in
    position order on ``x``'s device (the psum over ``model``).  Every
    position routes the same tokens, so the row's aux is position 0's.
    ``Blocks`` parameters (a serving step's row split): position m's
    experts are its own block, which must be [lo, lo + n_local)."""
    tp = row_split(params["wi_gate"])
    if tp is not None:
        return _ep_blocks(params, cfg, x, tp, n_local)
    ys, aux = [], None
    for m, dev in enumerate(devices):
        lo = m * n_local
        local = {"router": params["router"].to(dev)}
        for name in ("wi_gate", "wi_up", "wo"):
            local[name] = params[name][lo:lo + n_local].to(dev)
        y, a = _moe_local(local, cfg, x.to(dev), experts_slice=(lo, n_local))
        with link_kind("all-reduce"):
            ys.append(y.to(x.device))
            aux = a.to(x.device) if aux is None else aux
    y = ys[0]
    for part in ys[1:]:
        y = y + part
    return y, aux


def _ep_blocks(params, cfg: ArchConfig, x, tp, n_local: int):
    """``_ep_row`` on a row split's ``Blocks``."""
    xs = tp.spread(x)
    ys, aux = [], None
    for m in range(tp.m):
        lo = m * n_local
        local = {"router": params["router"].whole_at(m)}
        for name in ("wi_gate", "wi_up", "wo"):
            w: Blocks = params[name]
            if w.dim != 0 or w.bounds[m] != (lo, lo + n_local):
                raise ValueError(f"{name}: position {m}'s block is not "
                                 f"experts [{lo}, {lo + n_local})")
            local[name] = w.block(m)
        y, a = _moe_local(local, cfg, xs[m], experts_slice=(lo, n_local))
        ys.append(y)
        aux = a if aux is None else aux
    return tp.sum(ys), aux.to(x.device)


def moe_apply_dist(params, cfg: ArchConfig, x, mesh: Mesh
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism (the reference's ``shard_map`` body, written
    out over positions): the residual stream is replicated over `model`,
    so every model position dispatches its row's tokens to its own
    experts with local gathers; the only traffic is the sum of partial
    outputs over `model`.  ``capacity`` comes from a row's token count,
    and ``aux`` is the mean over rows of each row's aux (the reference's
    ``pmean`` over the axes other than `model`; the Switch loss is not
    linear in the token partition, so it differs from the one-device
    value by a fraction of a percent).

    Inside a data row of a mesh step (``dist.row_scope``) ``x`` is that
    row's batch shard and the row's own aux is returned: the step takes
    the mean over rows in its loss.  Otherwise ``x`` is the whole batch,
    split over the data rows as ``spec("batch")`` splits it."""
    ep = mesh.shape["model"]
    n_local = cfg.n_experts // ep
    row = current_row()
    if row is not None:
        return _ep_row(params, cfg, x, row.devices, n_local)
    data_rows = rows(mesh)
    n = len(data_rows) if spec("batch", None, None)[0] is not None else 1
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not split over "
                         f"{n} data rows")
    k = x.shape[0] // n
    outs = [_ep_row(params, cfg, x[r * k:(r + 1) * k], data_rows[r].devices,
                    n_local) for r in range(n)]
    y = torch.cat([o[0] for o in outs])
    if n == 1:
        return y, outs[0][1]
    auxes = [None] * mesh.size
    for r, row in enumerate(data_rows):
        for p in row.positions:
            auxes[p] = outs[r][1]
    other = tuple(a for a in mesh.axis_names if a != "model")
    return y, pmean(auxes, mesh, other)[0].to(x.device)
