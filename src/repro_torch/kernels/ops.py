"""Plain PyTorch twins of the queue's batched search, sort, merge and
extract primitives.

Each function here is the PyTorch form of the jnp branch of the same name
in the JAX package's ``kernels/ops.py``: the same arithmetic on the same
dtypes, so the two agree bit for bit on the same inputs.  They run on any
device and carry no backend argument: the only hand-written kernel on the
tick's path (``kernels/lane_tick.py``) is chosen by the config, not per
call.

Every function accepts any leading dims (lane-major batches) and works
along the last axis.  Index arithmetic stays in int32, the JAX package's
index dtype; gathers widen to int64 only at the ``torch.gather`` call,
and every gather index is clipped first (``torch.gather`` raises out of
range where JAX clamps).
"""

from __future__ import annotations

import math

import torch

INF = float("inf")
_I32 = torch.int32


def take_last(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(arr, idx, axis=-1)`` with broadcast leading dims.
    ``idx`` must already lie in ``[0, arr.shape[-1])``."""
    lead = torch.broadcast_shapes(arr.shape[:-1], idx.shape[:-1])
    a = arr.expand(lead + arr.shape[-1:])
    i = idx.expand(lead + idx.shape[-1:]).long()
    return torch.gather(a, -1, i)


def arange_i32(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=like.device)


def searchsorted_last(a: torch.Tensor, v: torch.Tensor, side: str = "left"):
    """Batched ``searchsorted`` along the last axis.

    ``a``: [..., n] rows sorted ascending; ``v``: [..., m] queries with
    equal (or broadcastable) leading dims.  Returns i32 insertion points
    in [0, n].  Small problems count with one broadcast compare, larger
    ones binary-search; both are exact on sorted rows and agree."""
    n, m = a.shape[-1], v.shape[-1]
    lead = torch.broadcast_shapes(a.shape[:-1], v.shape[:-1])
    if math.prod(lead) * n * m <= (1 << 17):
        return _searchsorted_compare_all(a, v, side=side)
    af = a.expand(lead + (n,)).contiguous()
    vf = v.expand(lead + (m,)).contiguous()
    return torch.searchsorted(af, vf, right=(side == "right"),
                              out_int32=True)


def _searchsorted_compare_all(a, v, side: str = "left"):
    """pos = #{a < v} (left) / #{a <= v} (right) as one broadcast compare."""
    cmp = (a[..., None, :] < v[..., :, None] if side == "left"
           else a[..., None, :] <= v[..., :, None])
    return cmp.sum(-1, dtype=_I32)


def _to_sortable_u32(x: torch.Tensor) -> torch.Tensor:
    """The monotone float -> uint32 map (negative floats bit-invert,
    positives set the sign bit), held in int64 because ``>>`` is not
    implemented for uint32 on the CPU.  Total order matches float order
    except that -0.0 maps strictly below 0.0; INF maps above every
    finite key."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = (u >> 31) != 0
    return torch.where(neg, u ^ 0xFFFFFFFF, u | 0x80000000)


def argsort_f32_last(keys: torch.Tensor) -> torch.Tensor:
    """Stable argsort of float rows along the last axis, on the u32 map
    (so -0.0 orders before 0.0).  Keys must be NaN-free.  Returns i32."""
    order = torch.sort(_to_sortable_u32(keys), dim=-1, stable=True).indices
    return order.to(_I32)


def sort_kvf(keys, vals, flags):
    """Co-sort (keys, vals, flags) by key ascending along the last axis
    (stable, u32 order)."""
    order = argsort_f32_last(keys)
    return take_last(keys, order), take_last(vals, order), \
        take_last(flags, order)


def _merge_sorted_corank(ak, av, af, bk, bv, bf):
    """Gather-only rank merge of two sorted INF-padded streams, ties
    a-first: a[i] lands at rank i + #{b < a[i]}, and each output rank
    recovers its source with one searchsorted against those ranks."""
    n, m = ak.shape[-1], bk.shape[-1]
    lead = ak.shape[:-1]
    pa = arange_i32(n, ak) + searchsorted_last(bk, ak, side="left")
    j = arange_i32(n + m, ak).expand(lead + (n + m,))
    na = searchsorted_last(pa, j, side="right")
    ia = (na - 1).clamp(0, n - 1)
    from_a = take_last(pa, ia) == j
    src = torch.where(from_a, ia, n + (j - na).clamp(0, m - 1))

    def cat(x, y):
        return torch.cat([x, y], dim=-1).expand(lead + (n + m,))

    return (take_last(cat(ak, bk), src), take_last(cat(av, bv), src),
            take_last(cat(af, bf), src))


def merge_sorted(ak, av, af, bk, bv, bf):
    """Merge two sorted INF-padded (key, val, flag) streams; ties
    resolve a-first.  Any equal leading dims."""
    return _merge_sorted_corank(ak, av, af, bk, bv, bf)


def sorted_runs_gather(keys2d, vals2d, counts, out_len: int):
    """The first ``out_len`` global ranks of a range-partitioned bucket
    store, as a gather over its per-row sorted runs.

    Rows are sorted independently; bucket key ranges are disjoint and
    ordered, so each sorted run is a contiguous block of global ranks
    starting at its row's cumulative count.  Returns (out_k INF-padded,
    out_v -1-padded, rk, rv) with rk/rv the row-sorted store."""
    nb, bc = keys2d.shape[-2:]
    lead = keys2d.shape[:-2]
    slot = arange_i32(bc, keys2d)
    live = slot < counts[..., None]
    mk = torch.where(live, keys2d, INF)
    mv = torch.where(live, vals2d, -1).to(_I32)
    order = argsort_f32_last(mk)
    rk = take_last(mk, order)
    rv = take_last(mv, order)
    cum = torch.cumsum(counts, dim=-1, dtype=_I32)
    offs = cum - counts
    j = arange_i32(out_len, keys2d).expand(lead + (out_len,))
    row = searchsorted_last(cum, j, side="right").clamp(0, nb - 1)
    col = (j - take_last(offs, row)).clamp(0, bc - 1)
    in_run = j < cum[..., nb - 1:nb]
    flat_idx = row * bc + col
    out_k = torch.where(in_run, take_last(rk.reshape(lead + (nb * bc,)),
                                          flat_idx), INF)
    out_v = torch.where(in_run, take_last(rv.reshape(lead + (nb * bc,)),
                                          flat_idx), -1)
    return out_k, out_v, rk, rv


def extract_k_bucketed(keys2d, vals2d, counts, k, k_max: int):
    """Extract (select + delete) the k smallest pairs from a bucket store
    whose rows hold disjoint, ordered key ranges.

    Each row is sorted on its own, the k smallest are a gather over the
    run windows, and deletion shifts each run left by its selected
    prefix.  ``k`` (a scalar or one per leading index) is clamped to the
    live total and ``k_max``.

    Returns (out_k [..., k_max] ascending INF-padded, out_v -1-padded,
    new_keys2d, new_vals2d, new_counts)."""
    bc = keys2d.shape[-1]
    slot = arange_i32(bc, keys2d)
    total = counts.sum(-1, dtype=_I32)
    k = torch.as_tensor(k, dtype=_I32, device=keys2d.device)
    k = torch.minimum(k, total).clamp(max=k_max)

    out_k, out_v, rk, rv = sorted_runs_gather(keys2d, vals2d, counts, k_max)
    j = arange_i32(k_max, keys2d)
    out_k = torch.where(j < k[..., None], out_k, INF)
    out_v = torch.where(j < k[..., None], out_v, -1)
    offs = torch.cumsum(counts, dim=-1, dtype=_I32) - counts
    nsel = torch.minimum((k[..., None] - offs).clamp(min=0), counts)
    new_counts = counts - nsel
    keep = slot < new_counts[..., None]
    src = (slot + nsel[..., None]).clamp(0, bc - 1)
    new_k = torch.where(keep, take_last(rk, src), INF)
    new_v = torch.where(keep, take_last(rv, src), -1)
    return out_k, out_v, new_k, new_v, new_counts
