"""int8 error-feedback gradient compression for the cross-pod reduction
(port of the JAX package's ``optim/compress.py``).

Each position compresses its gradient leaves to int8 with a scale shared
over the reduced axis (the ``pmax`` of the positions' per-leaf absmax /
127), so that the int8 payloads sum exactly in int32; the quantization
residual is kept in an error-feedback buffer and added back next step
(EF-SGD).  The reference calls it under ``shard_map`` over the ``pod``
axis; here it takes the per-position lists that the mesh's collectives
take (``dist.sharding``), in position order.  The reference's train step
does not call it, and neither does the port's.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from repro_torch.dist.sharding import Mesh, pmax, psum
from repro_torch.models.transformer import tree_leaves, tree_map


class CompressState(NamedTuple):
    error: dict     # per-leaf f32 error-feedback buffers


def compress_init(grads) -> CompressState:
    return CompressState(error=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads))


def _quantize(x):
    scale = torch.clamp(torch.max(torch.abs(x)) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(grads: List, states: List[CompressState], mesh: Mesh,
                    axis: str):
    """int8 all-reduce over ``axis`` with error feedback.  ``grads`` and
    ``states`` hold one tree per mesh position.  Returns (reduced f32
    gradient trees, new states), one per position."""
    n_pos = mesh.size
    flat_g = [tree_leaves(g) for g in grads]
    flat_e = [tree_leaves(s.error) for s in states]
    red = [[] for _ in range(n_pos)]
    err = [[] for _ in range(n_pos)]
    for i in range(len(flat_g[0])):
        x = [flat_g[p][i].float() + flat_e[p][i] for p in range(n_pos)]
        # a shared scale (the pmax of a scalar) lets the int8 payloads sum
        # exactly in int32 across the axis
        scale = pmax([torch.clamp(torch.max(torch.abs(v)) / 127.0,
                                  min=1e-12) for v in x], mesh, axis)
        q = [torch.clamp(torch.round(v / s), -127, 127).to(torch.int8)
             for v, s in zip(x, scale)]
        cnt = psum([torch.ones((), dtype=torch.float32, device=v.device)
                    for v in x], mesh, axis)
        total = psum([c.to(torch.int32) for c in q], mesh, axis)
        for p in range(n_pos):
            # x - q * scale rounded once, as the reference's fused
            # multiply-add gives it: in float64 the product (8 x 24 bits)
            # and the difference are exact
            err[p].append((x[p].double() - q[p].double() * scale[p].double())
                          .float())
            red[p].append(total[p].float() * scale[p] / cnt[p])

    def unflatten(tree, leaves):
        it = iter(leaves)
        return tree_map(lambda _: next(it), tree)

    return ([unflatten(grads[p], red[p]) for p in range(n_pos)],
            [CompressState(error=unflatten(states[p].error, err[p]))
             for p in range(n_pos)])
