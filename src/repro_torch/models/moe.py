"""Mixture-of-Experts FFN: token-choice top-k routing with capacity (port
of the JAX package's ``models/moe.py``, single device).

Dispatch is sort-based: assignments are ranked within their expert by a
segment rank, dropped beyond capacity, and the dispatched activations
[E, C, D] are built with one gather and one scatter.  The per-expert
FFNs run as batched matrix products over the expert axis.  The router
runs in f32; an auxiliary load-balance loss (Switch-style) is returned
for the trainer.

The reference's expert-parallel path (``moe_apply_dist``, under a mesh
with a ``model`` axis) is not ported: on one device the reference runs
``_moe_local`` too.

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
    """x: [B, S, D] -> (y [B, S, D], aux_loss scalar)."""
    return _moe_local(params, cfg, x)


def _moe_local(params, cfg: ArchConfig, x) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Sort-based capacity dispatch on one device."""
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
    slot = torch.where(keep, fe * c + rank, e * c)     # e * c: dropped

    # ---- dispatch: gather tokens into [E, C, D] (row e * c spills) ----
    xd = torch.zeros((e * c + 1, d), dtype=x.dtype, device=dev)
    xd[slot] = xt[ft]
    xd = xd[:e * c].reshape(e, c, d)

    # ---- per-expert FFN: batched products over the expert axis ----
    h = F.silu(torch.bmm(xd, params["wi_gate"])) * torch.bmm(
        xd, params["wi_up"])
    yd = torch.bmm(h, params["wo"]).reshape(e * c, d)

    # ---- combine: each token's k weighted contributions, in order ----
    contrib = yd[slot.clamp(max=e * c - 1)] * fg[:, None].to(x.dtype)
    contrib = torch.where(keep[:, None], contrib, 0).reshape(t, k, d)
    y = torch.zeros((t, d), dtype=x.dtype, device=dev)
    for j in range(k):
        y = y + contrib[:, j]
    return y.reshape(b, s, d), aux
