"""8-bit AdamW: blockwise-quantized moments (Dettmers-style; port of the
JAX package's ``optim/adamw8.py``).

Quantization is per block of 256 along the last axis (scales keep the
leading axes).  The first moment is linear signed absmax int8; the
second, nonnegative, is stored as uint8 codes q = 255·(nu/max)^(1/4),
which keep resolution near zero.  Each step dequantizes, runs the AdamW
math in float32 and requantizes; ``torch.round`` rounds half to even, as
``jnp.round`` does.  Parameters and the state's tensors are updated in
place and returned (the reference donates them).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.optim.adamw import bias_corrections, grad_norm

BLOCK = 256


class AdamW8State(NamedTuple):
    step: torch.Tensor
    q_mu: dict       # int8, param-shaped
    s_mu: dict       # f32 scales, shape[:-1] + (blocks,)
    q_nu: dict       # uint8, param-shaped
    s_nu: dict


def _nblocks(n: int) -> int:
    return (n + BLOCK - 1) // BLOCK


def _blocked(x):
    n = x.shape[-1]
    nb = _nblocks(n)
    xp = F.pad(x, (0, nb * BLOCK - n))
    return xp.reshape(x.shape[:-1] + (nb, BLOCK)), n


def _unblocked(xb, n):
    return xb.reshape(xb.shape[:-2] + (-1,))[..., :n]


def _quantize(x):
    """Linear signed absmax quantization (first moment).

    x: [..., n] f32 -> (q int8 [..., n], scales f32 [..., nb])."""
    xb, n = _blocked(x)
    scale = torch.clamp(xb.abs().amax(-1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127)
    return _unblocked(q, n).to(torch.int8), scale


def _dequantize(q, scale):
    xb, n = _blocked(q.float())
    return _unblocked(xb * scale[..., None], n)


def _quantize_nu(x):
    """4th-root quantization of the nonnegative second moment."""
    xb, n = _blocked(x)
    scale = torch.clamp(xb.amax(-1), min=1e-20)
    ratio = torch.clamp(xb / scale[..., None], 0.0, 1.0)
    q = torch.round(255.0 * torch.sqrt(torch.sqrt(ratio)))
    return _unblocked(q, n).to(torch.uint8), scale


def _dequantize_nu(q, scale):
    xb, n = _blocked(q.float())
    r = xb / 255.0
    return _unblocked(torch.square(torch.square(r)) * scale[..., None], n)


def adamw8_init(params) -> AdamW8State:
    def qz(p, dtype):
        return torch.zeros(p.shape, dtype=dtype, device=p.device)

    def sz(p):
        return torch.zeros(tuple(p.shape[:-1]) + (_nblocks(p.shape[-1]),),
                           dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    return AdamW8State(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        q_mu=tree_map(lambda p: qz(p, torch.int8), params),
        s_mu=tree_map(sz, params),
        q_nu=tree_map(lambda p: qz(p, torch.uint8), params),
        s_nu=tree_map(sz, params))


def adamw8_update(params, grads, state: AdamW8State, *, lr,
                  b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                  weight_decay: float = 0.1, clip_norm: float = 1.0):
    """Returns (new_params, new_state, metrics), the parameters and the
    state's codes and scales updated in place."""
    step = state.step + 1
    gnorm = grad_norm(grads)
    scale = torch.clamp(clip_norm / gnorm, max=1.0)
    b1c, b2c = bias_corrections(step, b1, b2)
    for p, g, q_mu, s_mu, q_nu, s_nu in zip(
            tree_leaves(params), tree_leaves(grads),
            tree_leaves(state.q_mu), tree_leaves(state.s_mu),
            tree_leaves(state.q_nu), tree_leaves(state.s_nu)):
        adamw8_leaf(p, g, q_mu, s_mu, q_nu, s_nu, scale=scale, lr=lr, b1=b1,
                    b2=b2, b1c=b1c, b2c=b2c, eps=eps,
                    weight_decay=weight_decay)
    return params, AdamW8State(step, state.q_mu, state.s_mu, state.q_nu,
                               state.s_nu), {"grad_norm": gnorm, "lr": lr}


def adamw8_leaf(p, g, q_mu, s_mu, q_nu, s_nu, *, scale, lr, b1, b2, b1c,
                b2c, eps, weight_decay) -> None:
    """One leaf's update in place: any box of it that holds whole rows of
    the last dim (the quantization blocks run along it), its scales'
    box beside it."""
    g = g.float() * scale
    mu = b1 * _dequantize(q_mu, s_mu) + (1 - b1) * g
    nu = b2 * _dequantize_nu(q_nu, s_nu) + (1 - b2) * torch.square(g)
    u = (mu / b1c) / (torch.sqrt(nu / b2c) + eps) + weight_decay * p.float()
    p.copy_((p.float() - lr * u).to(p.dtype))
    for dst, src in zip((q_mu, s_mu), _quantize(mu)):
        dst.copy_(src)
    for dst, src in zip((q_nu, s_nu), _quantize_nu(nu)):
        dst.copy_(src)
