"""Roofline terms against the card's peaks (port of the JAX package's
``roofline/analysis.py``).

The reference also parses XLA's optimized HLO for collective payloads
(``collective_bytes``); the port has no HLO.  In its place
:mod:`repro_torch.roofline.trace_stats` counts the bytes of every copy
between devices of a traced step, by collective kind (the dry run), and
:mod:`repro_torch.roofline.traffic` counts the mesh queue's one
cross-position transfer, ``core.distributed._all_gather``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.roofline import hw


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_accessed: float
    coll_bytes: float
    dominant: str

    @staticmethod
    def from_measurements(flops_per_dev: float, bytes_per_dev: float,
                          coll_bytes_per_dev: float,
                          link_bw: float = hw.ICI_BW) -> "Roofline":
        c = flops_per_dev / hw.PEAK_FLOPS
        m = bytes_per_dev / hw.HBM_BW
        n = coll_bytes_per_dev / link_bw
        dom = max((("compute", c), ("memory", m), ("collective", n)),
                  key=lambda kv: kv[1])[0]
        return Roofline(c, m, n, flops_per_dev, bytes_per_dev,
                        coll_bytes_per_dev, dom)

    def bound_step_time(self) -> float:
        """Lower-bound step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def mfu(self, model_flops_per_dev: float) -> float:
        """MODEL_FLOPS utilization against the bound step time."""
        t = self.bound_step_time()
        if t <= 0:
            return 0.0
        return model_flops_per_dev / (t * hw.PEAK_FLOPS)


def model_flops(cfg, shape_kind: str, tokens: int) -> float:
    """6·N·D (dense) or 6·N_active·D (MoE) for training; forward-only
    passes (prefill, decode) count 2·N·D per processed token."""
    n = cfg.active_param_count()
    if shape_kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens
