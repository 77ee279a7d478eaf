"""Adaptive policies of the combined queue (PyTorch port).

Only the paper's moveHead sizing (§2.1) lives here so far: the tick needs
it.  The workload controller of the JAX package's ``core/adaptive.py``
waits for its own slice of the port.
"""

from __future__ import annotations

import torch

from repro_torch.core.config import PQConfig


def update_detach(cfg: PQConfig, detach_n, ins_since_move):
    """New detach size after a moveHead event (paper §2.1).

    "If more than N insertions (e.g. N = 1000) occurred in the
    sequential part since the last SL::moveHead(), we halve the number
    of elements moved; otherwise, if less than M insertions (e.g.
    M = 100) were made, we double this number."  Between the thresholds
    the size holds (dead band); results clamp to
    [detach_min, detach_max].  Elementwise over int32 tensors.
    """
    detach_n = torch.as_tensor(detach_n, dtype=torch.int32)
    ins_since_move = torch.as_tensor(ins_since_move, dtype=torch.int32,
                                     device=detach_n.device)
    halved = (detach_n // 2).clamp(min=cfg.detach_min)
    doubled = (detach_n * 2).clamp(max=cfg.detach_max)
    return torch.where(
        ins_since_move > cfg.halve_threshold,
        halved,
        torch.where(ins_since_move < cfg.double_threshold, doubled,
                    detach_n),
    )
