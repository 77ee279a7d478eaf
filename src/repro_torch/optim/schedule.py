"""Learning-rate schedules (port of the JAX package's
``optim/schedule.py``)."""

from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total: int = 10_000, floor: float = 0.1):
    """Linear warmup then cosine decay to floor * peak, in float32 (a
    0-dim tensor on ``step``'s device).  At step 0 with any warmup the
    rate is 0."""
    s = torch.as_tensor(step).float()
    warm = peak_lr * s / max(warmup, 1)
    t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup, warm, cos)
