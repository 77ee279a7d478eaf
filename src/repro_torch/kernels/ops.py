"""The kernel ops of the port: batched search, sort, merge, select and
extract, each with its plain PyTorch branch and, where the JAX package
has a Pallas kernel, a branch through the port's hand-written kernel.

Backend selection mirrors the reference's ``KernelBackend`` /
``resolve_backend``, in the port's vocabulary (the same as
``PQConfig.backend``):

* ``"cuda"`` (the default, as the reference's ``"auto"`` takes the
  accelerator's kernel) — the kernel compositions of the reference's
  Pallas branches: ``sort_kvf`` through K2 (``bitonic.py``),
  ``merge_sorted`` through K1 (``merge_consume.py``), ``select_threshold``
  through K4 (``radix_select.py``), ``select_k_smallest`` and
  ``extract_k_bucketed`` through K4 then K2.  CUDA tensors launch the
  kernels; CPU tensors take each kernel's plain version inside the same
  composition.
* ``"torch"`` — the plain branches, the twins of the reference's jnp
  branches: the same arithmetic on the same dtypes, so the two agree bit
  for bit on the same inputs.

Call sites pass a resolved :class:`KernelBackend` (``CUDA`` / ``TORCH`` or
``resolve_backend(...)``), never a string.  The engine's passes pass
``TORCH``: in the reference every engine path runs these ops on the jnp
branch, and the engine's only kernel is the lane tick (``lane_tick.py``).

Every function accepts any leading dims (lane-major batches) and works
along the last axis.  Index arithmetic stays in int32, the JAX package's
index dtype; gathers widen to int64 only at the ``torch.gather`` call,
and every gather index is clipped first (``torch.gather`` raises out of
range where JAX clamps).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import ref

INF = float("inf")
_I32 = torch.int32

#: spellings resolve_backend accepts
BACKENDS = ("cuda", "torch")


@dataclasses.dataclass(frozen=True)
class KernelBackend:
    """Resolved kernel-dispatch choice: ``kind`` is "cuda" (the kernel
    compositions) or "torch" (the plain branches).  Frozen and hashable."""

    kind: str

    @property
    def is_cuda(self) -> bool:
        return self.kind == "cuda"


def resolve_backend(backend) -> KernelBackend:
    """Validate and resolve a backend spelling, once, at the caller."""
    if isinstance(backend, KernelBackend):
        return backend
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown kernel backend {backend!r} (have {BACKENDS})")
    return KernelBackend(backend)


CUDA = resolve_backend("cuda")
TORCH = resolve_backend("torch")


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


def minimum_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise minimum of NaN-free floats as the reference takes it
    (XLA's ``minimum``): -0.0 orders below 0.0.  ``torch.minimum`` may
    return either zero."""
    return torch.where((a < b) | ((a == b) & torch.signbit(a)), a, b)


def amin_f32(x: torch.Tensor, dim) -> torch.Tensor:
    """Minimum of NaN-free floats over ``dim`` as the reference takes it:
    a zero minimum is -0.0 if any zero of the slice is.  ``amin`` picks
    either zero, by the order of its reduction."""
    m = x.amin(dim)
    neg_zero = ((x == 0) & torch.signbit(x)).any(dim)
    return torch.where((m == 0) & neg_zero, m.abs().neg(), m)


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


def sort_kvf(keys, vals, flags, *, backend=CUDA):
    """Co-sort (keys, vals, flags) by key ascending along the last axis
    (stable, u32 order: -0.0 before 0.0).

    "cuda": the leading dims flatten onto the rows of K2
    (``bitonic.bitonic_sort_kvf``), with vals and flags as int32, as the
    reference's Pallas branch casts them."""
    if not resolve_backend(backend).is_cuda:
        order = argsort_f32_last(keys)
        return take_last(keys, order), take_last(vals, order), \
            take_last(flags, order)
    # imported here: the kernel modules import this one for their plain
    # versions
    from repro_torch.kernels.bitonic import bitonic_sort_kvf
    lead, n = keys.shape[:-1], keys.shape[-1]
    out = bitonic_sort_kvf(*(x.reshape(-1, n).contiguous()
                             for x in (keys, vals.to(_I32), flags.to(_I32))))
    return tuple(o.reshape(lead + (n,)) for o in out)


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


def merge_sorted(ak, av, af, bk, bv, bf, *, backend=CUDA):
    """Merge two sorted INF-padded (key, val, flag) streams; ties
    resolve a-first.  Any equal leading dims.

    "cuda": the leading dims flatten onto K1's batch
    (``merge_consume.merge_sorted_kvf``), vals and flags as int32; no
    payload bound and no length limit."""
    if not resolve_backend(backend).is_cuda:
        return _merge_sorted_corank(ak, av, af, bk, bv, bf)
    from repro_torch.kernels.merge_consume import merge_sorted_kvf
    lead, n, m = ak.shape[:-1], ak.shape[-1], bk.shape[-1]
    a = (x.reshape(-1, n).contiguous() for x in (ak, av.to(_I32),
                                                 af.to(_I32)))
    b = (x.reshape(-1, m).contiguous() for x in (bk, bv.to(_I32),
                                                 bf.to(_I32)))
    out = merge_sorted_kvf(*a, *b)
    return tuple(o.reshape(lead + (n + m,)) for o in out)


def _device_k(k, device):
    """``k`` as an int32 tensor on ``device``.  A Python int becomes a
    fill on the device, not a copy from the host, which would block the
    host until the device's queue drains."""
    if isinstance(k, torch.Tensor):
        return k.to(device=device, dtype=_I32)
    return torch.full((), k, dtype=_I32, device=device)


def _per_stream_k(k, lead, device):
    """``k`` (a scalar or one per leading index) as an int32 [rows]
    tensor on ``device``; it never leaves the device."""
    return _device_k(k, device).expand(lead).reshape(-1).contiguous()


def select_threshold(keys, k, *, backend=CUDA):
    """(tau, n_below): tau the k-th smallest key of each stream (the last
    axis, INF-padded) and n_below = #{keys < tau}; ``k`` is a scalar or
    one per leading index.

    "torch" is the reference's oracle ``ref_select_threshold`` (float
    order: -0.0 ties 0.0); "cuda" is K4 (``radix_select``), which orders
    -0.0 below 0.0 as the reference's Pallas kernel does.  Unlike the
    reference, 2-D keys are two streams, not one: flatten a bucket store
    first."""
    if not resolve_backend(backend).is_cuda:
        return ref.ref_select_threshold(keys, k)
    from repro_torch.kernels.radix_select import radix_select_threshold
    lead, length = keys.shape[:-1], keys.shape[-1]
    tau, n_below = radix_select_threshold(
        keys.reshape(-1, length).contiguous(),
        _per_stream_k(k, lead, keys.device))
    return tau.reshape(lead), n_below.reshape(lead)


def _scatter_drop(src, pos, width: int, fill):
    """``full(width, fill).at[pos].set(src, mode="drop")`` along the last
    axis, for ``pos`` in [0, width]: slot ``width`` is the spare that
    takes every dropped write."""
    out = torch.full(src.shape[:-1] + (width + 1,), fill, dtype=src.dtype,
                     device=src.device)
    out.scatter_(-1, pos.long(), src)
    return out[..., :width].contiguous()


def _radix_select_sorted(flat, flatv, k, k_max: int, cand=None, *,
                         bk: KernelBackend):
    """The kernel selection core over [rows, L] streams: radix threshold
    (K4) -> tie-rank split -> cumsum compaction -> stable sort (K2) of the
    k_max survivors.  ``k`` is [rows] int32.

    ``cand`` optionally masks elements that provably cannot be selected
    (splitter pruning); it never changes the result.  Returns (out_k
    sorted INF-padded, out_v -1-padded, sel, the selected positions)."""
    tau, n_below = select_threshold(flat, k, backend=bk)
    below = flat < tau[:, None]
    eq = flat == tau[:, None]
    if cand is not None:
        below &= cand
        eq &= cand
    eq_rank = torch.cumsum(eq, -1, dtype=_I32) - 1
    sel = below | (eq & (eq_rank < (k - n_below)[:, None]))
    pos = torch.where(sel, torch.cumsum(sel, -1, dtype=_I32) - 1,
                      k_max).clamp(max=k_max)
    out_k = _scatter_drop(flat, pos, k_max, INF)
    out_v = _scatter_drop(flatv.to(_I32), pos, k_max, -1)
    out_k, out_v, _ = sort_kvf(out_k, out_v, torch.zeros_like(out_v),
                               backend=bk)
    return out_k, out_v, sel


def select_k_smallest(keys, vals, k, k_max: int, *, backend=CUDA):
    """The k smallest (key, val) pairs of each stream, sorted ascending,
    INF-padded (vals -1-padded) to k_max.

    "cuda": radix threshold + compaction + a stable sort of the k_max
    survivors, with no full sort of the stream; k_max any width."""
    bk = resolve_backend(backend)
    if not bk.is_cuda:
        return ref.ref_select_k(keys, vals, k, k_max)
    lead, length = keys.shape[:-1], keys.shape[-1]
    k = _per_stream_k(k, lead, keys.device).clamp(max=k_max)
    out_k, out_v, _ = _radix_select_sorted(
        keys.reshape(-1, length), vals.reshape(-1, length), k, k_max, bk=bk)
    return out_k.reshape(lead + (k_max,)), out_v.reshape(lead + (k_max,))


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


def extract_k_bucketed(keys2d, vals2d, counts, k, k_max: int, *,
                       splitters=None, backend=CUDA):
    """Extract (select + delete) the k smallest pairs from a bucket store
    whose rows hold disjoint, ordered key ranges.

    * "torch" — each row is sorted on its own, the k smallest are a
      gather over the run windows, and deletion shifts each run left by
      its selected prefix.
    * "cuda" — radix threshold (K4) over the flattened store, splitter
      pruning of buckets that cannot hold survivors, cumsum compaction,
      one stable sort (K2) of the k_max survivors; each row is compacted
      around its selected slots, survivors keeping their slot order.

    Both hold the same multiset; the survivors' slot layout differs.
    ``k`` (a scalar or one per leading index) is clamped to the live
    total and ``k_max``; ``splitters`` only enables the pruning.

    Returns (out_k [..., k_max] ascending INF-padded, out_v -1-padded,
    new_keys2d, new_vals2d, new_counts)."""
    bc = keys2d.shape[-1]
    slot = arange_i32(bc, keys2d)
    total = counts.sum(-1, dtype=_I32)
    k = torch.minimum(_device_k(k, keys2d.device), total).clamp(max=k_max)

    bk = resolve_backend(backend)
    if bk.is_cuda:
        return _extract_k_bucketed_kernel(keys2d, vals2d, counts, k,
                                          splitters, k_max=k_max, bk=bk)
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


def _extract_k_bucketed_kernel(keys2d, vals2d, counts, k, splitters, *,
                               k_max: int, bk: KernelBackend):
    """The "cuda" branch of :func:`extract_k_bucketed`, every leading
    index at once (the reference's ``_extract_k_bucketed_pallas_1``)."""
    nb, bc = keys2d.shape[-2:]
    lead = keys2d.shape[:-2]
    live = arange_i32(bc, keys2d) < counts[..., None]
    mk = torch.where(live, keys2d, INF)
    mv = torch.where(live, vals2d, -1).to(_I32)
    k = k.expand(lead).reshape(-1)
    cand = None
    if splitters is not None:
        # bucket b's elements all have global rank >= its cumulative
        # start, so a bucket starting at rank >= k holds none of the k
        # smallest; candidates are a prefix of the flat order, so the
        # tie-rank selection is unchanged
        offs = (torch.cumsum(counts, -1, dtype=_I32) - counts).reshape(-1, nb)
        cand = (offs < k[:, None])[:, :, None].expand(-1, nb, bc)
        cand = cand.reshape(-1, nb * bc)
    out_k, out_v, sel = _radix_select_sorted(
        mk.reshape(-1, nb * bc), mv.reshape(-1, nb * bc), k, k_max, cand,
        bk=bk)
    keep = live & ~sel.reshape(lead + (nb, bc))
    cpos = torch.where(keep, torch.cumsum(keep, -1, dtype=_I32) - 1, bc)
    new_k = _scatter_drop(mk, cpos, bc, INF)
    new_v = _scatter_drop(mv, cpos, bc, -1)
    return (out_k.reshape(lead + (k_max,)), out_v.reshape(lead + (k_max,)),
            new_k, new_v, keep.sum(-1, dtype=_I32))
