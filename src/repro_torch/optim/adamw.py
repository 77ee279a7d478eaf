"""AdamW with float32 moments over (possibly) bfloat16 parameters (port
of the JAX package's ``optim/adamw.py``).

All the math is in float32, in the reference's order of operations: the
gradient norm sums the leaves in the reference's leaf order (dict keys
sorted), ``b1 ** step`` is a float32 power.  The update is written in
place: the parameter tensors and the moments given are updated and
returned, as the reference's jitted step donates them; a caller keeps
no other use of the old state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.optim._tree import sorted_leaves


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: dict
    nu: dict


def adamw_init(params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def grad_norm(grads) -> torch.Tensor:
    """sqrt(sum of squares + 1e-20) over every leaf in float32, the leaves
    in the reference's order."""
    total = sum(torch.sum(torch.square(g.float()))
                for g in sorted_leaves(grads))
    return torch.sqrt(total + 1e-20)


def bias_corrections(step, b1: float, b2: float):
    """1 - b1 ** step and 1 - b2 ** step, float32 powers."""
    s = step.float()
    f32 = dict(dtype=torch.float32, device=s.device)
    return (1.0 - torch.pow(torch.tensor(b1, **f32), s),
            1.0 - torch.pow(torch.tensor(b2, **f32), s))


def adamw_update(params, grads, state: AdamWState, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """Returns (new_params, new_state, metrics), the parameters and
    moments updated in place. All math in f32."""
    step = state.step + 1
    gnorm = grad_norm(grads)
    scale = torch.clamp(clip_norm / gnorm, max=1.0)
    b1c, b2c = bias_corrections(step, b1, b2)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        adamw_leaf(p, g, m, v, scale=scale, lr=lr, b1=b1, b2=b2, b1c=b1c,
                   b2c=b2c, eps=eps, weight_decay=weight_decay)
    return params, AdamWState(step, state.mu, state.nu), {
        "grad_norm": gnorm, "lr": lr}


def adamw_leaf(p, g, m, v, *, scale, lr, b1, b2, b1c, b2c, eps,
               weight_decay) -> None:
    """One leaf's update in place (any box of it: every operation is
    elementwise), the clip ``scale`` and bias corrections given."""
    g = g.float() * scale
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * torch.square(g))
    u = (m / b1c) / (torch.sqrt(v / b2c) + eps) + weight_decay * p.float()
    p.copy_((p.float() - lr * u).to(p.dtype))
