"""Plain PyTorch oracles of the kernel ops: the twin of the JAX package's
``kernels/ref.py``.

Each function computes what the JAX oracle of the same name computes, on
the same dtypes, with float comparisons (so -0.0 ties 0.0, as the
reference's float sort does).  The tests hold the port's kernels and
their compositions against these.
"""

from __future__ import annotations

import torch

INF = float("inf")


def _gather(x, order):
    return torch.gather(x, -1, order)


def _as_k(k, like):
    """``k`` as a tensor on ``like``'s device: a Python int becomes a fill
    on the device rather than a blocking copy from the host."""
    if isinstance(k, torch.Tensor):
        return k.to(like.device)
    return torch.full((), k, device=like.device)


def ref_sort_kvf(keys, vals, flags):
    """Co-sort rows of (keys, vals, flags) by key ascending (stable)."""
    order = torch.sort(keys, dim=-1, stable=True).indices
    return _gather(keys, order), _gather(vals, order), _gather(flags, order)


def ref_merge_sorted(ak, av, af, bk, bv, bf):
    """Merge two sorted (INF-padded) 1-D streams; ties resolve a-first.

    Returns merged (keys, vals, flags) of length len(a)+len(b)."""
    n, m = ak.shape[0], bk.shape[0]
    dev = ak.device
    pa = torch.arange(n, device=dev) + torch.searchsorted(bk, ak)
    pb = torch.arange(m, device=dev) + torch.searchsorted(ak, bk, right=True)

    def place(x, y):
        out = torch.zeros(n + m, dtype=x.dtype, device=dev)
        out[pa] = x
        out[pb] = y
        return out

    return place(ak, bk), place(av, bv), place(af, bf)


def ref_select_threshold(keys, k):
    """(tau, n_below): tau = k-th smallest key; n_below = #{keys < tau}.

    Selecting all keys < tau plus (k - n_below) keys == tau yields exactly
    the k smallest (INF-padded input; k <= len(keys)).  Leading dims are
    independent streams, with ``k`` a scalar or one per stream."""
    k = _as_k(k, keys).expand(keys.shape[:-1])
    skeys = torch.sort(keys, dim=-1, stable=True).values
    idx = (k - 1).clamp(0, keys.shape[-1] - 1).long()
    tau = torch.gather(skeys, -1, idx[..., None])[..., 0]
    tau = torch.where(k > 0, tau, -INF)
    n_below = (keys < tau[..., None]).sum(-1, dtype=torch.int32)
    return tau, n_below


def ref_select_k(keys, vals, k, k_max: int):
    """The k smallest (key, val) pairs of each stream, sorted, padded to
    k_max with INF (vals with -1)."""
    order = torch.sort(keys, dim=-1, stable=True).indices
    idx = torch.arange(k_max, device=keys.device)
    src = order.gather(-1, idx.clamp(0, keys.shape[-1] - 1).expand(
        keys.shape[:-1] + (k_max,)))
    take = idx < _as_k(k, keys)[..., None]
    return (torch.where(take, _gather(keys, src), INF),
            torch.where(take, _gather(vals, src), -1))


def ref_extract_k_bucketed(keys2d, vals2d, counts, k, k_max: int):
    """Oracle for ops.extract_k_bucketed's *extracted* stream: the full
    sort of the masked flat store (the surviving store's slot layout is
    implementation-defined)."""
    slot = torch.arange(keys2d.shape[1], device=keys2d.device)[None, :]
    valid = slot < counts[:, None]
    flat = torch.where(valid, keys2d, INF).reshape(-1)
    flatv = torch.where(valid, vals2d, -1).reshape(-1)
    k = torch.minimum(_as_k(k, keys2d), counts.sum()).clamp(max=k_max)
    return ref_select_k(flat, flatv, k, k_max)
