"""Batch elimination matching (paper §2.2), standalone (PyTorch port of
the JAX package's ``core/elimination.py``).

The sharded queue's pre-route pass matches the tick's adds against its
removeMin allocation with :func:`eliminate_batch_unsorted` before
anything is routed; :func:`eliminate_batch` is the sorted variant.  Both
work on one [a] batch and keep the reference's dtypes and arithmetic, so
they agree with it bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.config import EMPTY_VAL
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ops import arange_i32

INF = float("inf")
_I32 = torch.int32
_F32 = torch.float32


class ElimUnsortedResult(NamedTuple):
    n_matched: torch.Tensor       # pairs eliminated
    matched_keys: torch.Tensor    # [a] dense prefix of matched keys (INF pad)
    matched_vals: torch.Tensor    # [a]
    residual_mask: torch.Tensor   # [a] bool: surviving adds, SLOT ORDER
    residual_rm: torch.Tensor     # scalar: surviving removeMin count


def eliminate_batch_unsorted(add_keys, add_vals, add_mask, rm_count,
                             min_value) -> ElimUnsortedResult:
    """Slot-order immediate elimination, with no sort of the batch.

    Matches the FIRST adds in slot order with ``key <= min_value``
    against up to ``rm_count`` removes; the residual adds keep their
    slots (their mask bits cleared).  Every matched key is <= min_value,
    so serving it cannot displace a smaller stored key."""
    a = add_keys.shape[0]
    rm_count = torch.as_tensor(rm_count, dtype=_I32, device=add_keys.device)
    k = torch.where(add_mask, add_keys.to(_F32), INF)
    v = torch.where(add_mask, add_vals.to(_I32), EMPTY_VAL)
    elig = add_mask & (k <= min_value)
    ecum = torch.cumsum(elig, 0, dtype=_I32)
    n_elig = ecum[a - 1]
    n_matched = torch.minimum(n_elig, rm_count)
    taken = elig & (ecum <= n_matched)

    # the j-th matched key sits at the first slot whose eligible-cumsum
    # reaches j+1 (ecum is nondecreasing)
    j = arange_i32(a, k)
    src = kops.searchsorted_last(ecum, j + 1, side="left").clamp(0, a - 1)
    in_pref = j < n_matched
    matched_keys = torch.where(in_pref, k[src.long()], INF)
    matched_vals = torch.where(in_pref, v[src.long()], EMPTY_VAL)
    return ElimUnsortedResult(n_matched, matched_keys, matched_vals,
                              add_mask & ~taken, rm_count - n_matched)


class ElimResult(NamedTuple):
    n_matched: torch.Tensor       # pairs eliminated
    matched_keys: torch.Tensor    # [a_max] keys handed to removes (INF pad)
    matched_vals: torch.Tensor    # [a_max]
    residual_keys: torch.Tensor   # [a_max] surviving adds, sorted, INF pad
    residual_vals: torch.Tensor   # [a_max]
    residual_rm: torch.Tensor     # scalar: surviving removeMin count


def eliminate_batch(add_keys, add_vals, add_mask, rm_count,
                    min_value) -> ElimResult:
    """Immediate elimination: match add(v <= min_value) with removes, 1:1,
    smallest eligible adds first.  add_keys need not be sorted; the
    residual adds come back sorted by a stable float sort, which ties
    -0.0 with 0.0 (slot order), as the reference's ``jnp.argsort``."""
    a = add_keys.shape[0]
    rm_count = torch.as_tensor(rm_count, dtype=_I32, device=add_keys.device)
    k = torch.where(add_mask, add_keys.to(_F32), INF)
    v = torch.where(add_mask, add_vals.to(_I32), EMPTY_VAL)
    order = torch.sort(k, stable=True).indices
    k, v = k[order], v[order]
    n_adds = add_mask.sum(dtype=_I32)
    idx = arange_i32(a, k)
    valid = idx < n_adds

    n_elig = ((k <= min_value) & valid).sum(dtype=_I32)
    n_matched = torch.minimum(n_elig, rm_count)

    matched = idx < n_matched
    matched_keys = torch.where(matched, k, INF)
    matched_vals = torch.where(matched, v, EMPTY_VAL)

    sidx = idx + n_matched
    src = sidx.clamp(0, a - 1).long()
    residual_keys = torch.where(sidx < a, k[src], INF)
    residual_vals = torch.where(sidx < a, v[src], EMPTY_VAL)
    return ElimResult(n_matched, matched_keys, matched_vals,
                      residual_keys, residual_vals, rm_count - n_matched)
