"""K1: the rank merge of two sorted (key, val, flag) streams.

Replaces the JAX package's Pallas kernel
``kernels/merge_consume.py::merge_sorted_kvf`` with
``csrc/merge_consume.cu``, a merge path: each CTA searches the co-ranks
of its two output diagonals a warp each, stages both windows (keys, vals,
flags) in shared memory with one round of ``cp.async``, merges there and
stores its tile coalesced.  Ties go a-first
and keys compare as floats (-0.0 ties 0.0), so the output is the co-rank
merge's (``ops._merge_sorted_corank``) bit for bit.  Keys and payloads
are copied, not carried through a matmul: no |val| < 2**24 bound, no
tile or even-total limit, and -0.0 stays -0.0.

* :func:`merge_sorted_kvf` — the wrapper.  CPU tensors take the plain
  version; CUDA tensors launch the kernel on the current stream (never a
  fallback) and add one to ``merge_sorted_kvf.launches``.
* :func:`launch_plan` — outputs per CTA and CTAs per row, with rows x
  tiles flattened into one grid dimension.
* :func:`merge_sorted_kvf_plain` — the co-rank gather merge.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ops

_I32 = torch.int32
_F32 = torch.float32


#: the kernel's threads a CTA (kThreads) and the outputs a CTA may take
#: (kThreads x ITEMS, ITEMS 8 or 2), largest first
THREADS = 256
TILES = tuple(THREADS * items for items in (8, 2))

#: CTAs an SM a launch aims at: a grid under 2 x SMs leaves SMs idle
CTAS_PER_SM = 2


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One launch over [rows, n] + [rows, m]: ``tile`` outputs a CTA,
    ``tiles`` CTAs a row, CTA ``b`` of the flat grid taking tile ``b %
    tiles`` of row ``b // tiles``."""

    rows: int
    n: int
    m: int
    tile: int
    tiles: int

    @property
    def grid(self) -> int:
        return self.rows * self.tiles

    def cover(self, b: int) -> tuple:
        """(row, first output, end) of CTA ``b``, as the kernel takes it."""
        row, t = divmod(b, self.tiles)
        d0 = t * self.tile
        return row, d0, min(d0 + self.tile, self.n + self.m)


def launch_plan(rows: int, n: int, m: int, sms: int) -> LaunchPlan:
    """2048 outputs a CTA where that still gives the launch
    :data:`CTAS_PER_SM` CTAs on each of ``sms`` SMs, else 512; so a merge
    of at least 2 x sms x 512 outputs fills every SM twice."""
    total = n + m
    for tile in TILES:
        tiles = -(-total // tile)
        if rows * tiles >= CTAS_PER_SM * sms:
            break
    return LaunchPlan(rows, n, m, tile, tiles)


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (cached per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def merge_sorted_kvf_plain(ak, av, af, bk, bv, bf):
    """The kernel's plain version (``ops.merge_sorted``'s "torch"
    branch)."""
    return ops._merge_sorted_corank(ak, av, af, bk, bv, bf)


def _check(args):
    ak, bk = args[0], args[3]
    if ak.dim() != 2 or bk.dim() != 2 or ak.shape[0] != bk.shape[0]:
        raise ValueError(f"a and b must be [B, n] and [B, m], got "
                         f"{tuple(ak.shape)} and {tuple(bk.shape)}")
    if ak.shape[1] + bk.shape[1] >= 1 << 31:
        raise ValueError("merged length out of range")
    for i, x in enumerate(args):
        like = ak if i < 3 else bk
        dtype = _F32 if i % 3 == 0 else _I32
        if x.device != ak.device:
            raise ValueError(f"input {i} on {x.device}, a on {ak.device}")
        if x.dtype != dtype or x.shape != like.shape:
            raise ValueError(f"input {i}: got {x.dtype} {tuple(x.shape)}, "
                             f"expected {dtype} {tuple(like.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"input {i} is not contiguous")


def merge_sorted_kvf(ak, av, af, bk, bv, bf):
    """Merge sorted INF-padded streams a [B, n] and b [B, m] (keys f32,
    vals and flags i32) row by row; ties resolve a-first.  Returns fresh
    [B, n+m] (keys, vals, flags)."""
    dev = ak.device
    if dev.type == "cpu":
        return merge_sorted_kvf_plain(ak, av, af, bk, bv, bf)
    if dev.type != "cuda":
        raise ValueError(f"merge_sorted_kvf runs on cuda or cpu, got {dev}")
    args = (ak, av, af, bk, bv, bf)
    _check(args)
    rows, n, m = ak.shape[0], ak.shape[1], bk.shape[1]
    ok = torch.empty((rows, n + m), dtype=_F32, device=dev)
    ov = torch.empty((rows, n + m), dtype=_I32, device=dev)
    of = torch.empty((rows, n + m), dtype=_I32, device=dev)
    if ok.numel() == 0:
        return ok, ov, of
    lib = build.load("merge_consume")
    plan = launch_plan(rows, n, m, sm_count(dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.merge_consume_launch(
            *(x.data_ptr() for x in args + (ok, ov, of)), rows, n, m,
            plan.tile, plan.tiles, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError("merge_consume kernel launch failed: "
                           + lib.merge_consume_error_string(err).decode())
    merge_sorted_kvf.launches += 1
    return ok, ov, of


#: wrapper calls that launched the kernel (one CUDA launch each)
merge_sorted_kvf.launches = 0
