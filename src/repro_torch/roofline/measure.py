"""Fold a measured wall time into a roofline record (port of the JAX
package's ``roofline/measure.py``).

The reference lowers the jitted tick and reads FLOPs and bytes off its
HLO; the port takes the count from :mod:`repro_torch.roofline.traffic`,
which needs only the config and shapes.  The record keeps the reference
record's fields:

* the peaks are the H100 SXM's (``peak_ref: "h100_sxm"``, hw.py);
  ``device`` is where the measured tensors lived, and a CPU time folded
  in here is not a device number;
* ``flops`` is null: a queue tick's work is comparisons;
* ``hbm_bytes_adj`` equals ``hbm_bytes``: the count already takes each
  byte once, so no residency adjustment applies;
* ``frac_peak_bw`` is the bound's share of the measured time; it cannot
  exceed 1 on a correct count and a correct clock.
"""

from __future__ import annotations

import torch

from repro_torch.roofline import hw
from repro_torch.roofline.analysis import Roofline
from repro_torch.roofline.traffic import Traffic


def record_from_traffic(count: Traffic, wall_s: float, n_ticks: int = 1,
                        device=None) -> dict:
    """Fold (per-tick traffic, measured wall seconds over ``n_ticks``
    ticks) into a roofline record; ``device`` is a ``torch.device``, a
    tensor, or a spelling of one."""
    if isinstance(device, torch.Tensor):
        device = device.device
    device = torch.device(device if device is not None else "cpu")
    wall = max(float(wall_s), 1e-12)
    hbm = count.hbm_bytes * int(n_ticks)
    link = count.link_bytes * int(n_ticks)
    roof = Roofline.from_measurements(0.0, hbm, link)
    ach_b = hbm / wall
    rec = {
        "device": str(device),
        "peak_ref": "h100_sxm",
        "n_ticks": int(n_ticks),
        "wall_s": wall,
        # static facts of the work (machine-independent)
        "flops": None,
        "hbm_bytes": hbm,
        "hbm_bytes_adj": hbm,
        "collective_bytes": link,
        "arith_intensity": None,
        "ridge_intensity": hw.PEAK_FLOPS / hw.HBM_BW,
        "bound": roof.dominant,
        "bound_s": roof.bound_step_time(),
        # achieved vs the card's roof (machine-dependent)
        "achieved_flops_per_s": None,
        "achieved_bytes_per_s": ach_b,
        "frac_peak_flops": None,
        "frac_peak_bw": ach_b / hw.HBM_BW,
        "frac_bound": roof.bound_step_time() / wall,
    }
    if device.type == "cuda":
        rec["device_name"] = torch.cuda.get_device_name(device)
    return rec
