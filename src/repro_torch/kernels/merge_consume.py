"""K1: the rank merge of two sorted (key, val, flag) streams.

Replaces the JAX package's Pallas kernel
``kernels/merge_consume.py::merge_sorted_kvf`` with
``csrc/merge_consume.cu``, a merge path: each CTA binary-searches the
co-rank of its output diagonals and merges its tile.  Ties go a-first
and keys compare as floats (-0.0 ties 0.0), so the output is the co-rank
merge's (``ops._merge_sorted_corank``) bit for bit.  Keys and payloads
are copied, not carried through a matmul: no |val| < 2**24 bound, no
tile or even-total limit, and -0.0 stays -0.0.

* :func:`merge_sorted_kvf` — the wrapper.  CPU tensors take the plain
  version; CUDA tensors launch the kernel on the current stream (never a
  fallback) and add one to ``merge_sorted_kvf.launches``.
* :func:`merge_sorted_kvf_plain` — the co-rank gather merge.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ops

_I32 = torch.int32
_F32 = torch.float32


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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.merge_consume_launch(
            *(x.data_ptr() for x in args + (ok, ov, of)), rows, n, m,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError("merge_consume kernel launch failed: "
                           + lib.merge_consume_error_string(err).decode())
    merge_sorted_kvf.launches += 1
    return ok, ov, of


#: wrapper calls that launched the kernel (one CUDA launch each)
merge_sorted_kvf.launches = 0
