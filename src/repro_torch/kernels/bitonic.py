"""K2: the row co-sort of (keys, vals, flags) by key.

Replaces the JAX package's Pallas kernel
``kernels/bitonic.py::bitonic_sort_kvf`` with ``csrc/bitonic.cu``.  The
name stays, but the port's sort is an LSD radix sort, four stable 8-bit
digit passes over the u32-mapped keys, and so it is **stable**, where
the reference's network is not: it yields exactly the stable argsort on
the u32 map (``ops.argsort_f32_last``: -0.0 before 0.0), at any row
length.  A row of up to 4096 keys sorts in one CTA; a longer one in a
multi-CTA onesweep (a histogram launch, then one launch per digit).

* :func:`bitonic_sort_kvf` — the wrapper.  CPU tensors take the plain
  version; CUDA tensors launch the kernel on the current stream (never a
  fallback) and add one to ``bitonic_sort_kvf.launches``.
* :func:`bitonic_sort_kvf_plain` — the same function as a stable
  ``torch.sort`` of the u32 map and three gathers.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ops

_I32 = torch.int32
_F32 = torch.float32


def bitonic_sort_kvf_plain(keys, vals, flags):
    """The kernel's plain version: ``ops.sort_kvf``'s "torch" branch, the
    stable argsort on the u32 map and three gathers."""
    return ops.sort_kvf(keys, vals, flags, backend=ops.TORCH)


def _check(keys, vals, flags):
    for name, x, dtype in (("keys", keys, _F32), ("vals", vals, _I32),
                           ("flags", flags, _I32)):
        if x.device != keys.device:
            raise ValueError(f"{name} on {x.device}, keys on {keys.device}")
        if x.dtype != dtype or x.dim() != 2 or x.shape != keys.shape:
            raise ValueError(f"{name} must be [rows, n] {dtype} like keys "
                             f"{tuple(keys.shape)}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if keys.shape[1] >= 1 << 30:
        raise ValueError(f"row length {keys.shape[1]} out of range")


def bitonic_sort_kvf(keys, vals, flags):
    """Co-sort each row of [rows, n] (keys f32, vals i32, flags i32) by key
    ascending, stably; any n.  Returns fresh (keys, vals, flags)."""
    dev = keys.device
    if dev.type == "cpu":
        return bitonic_sort_kvf_plain(keys, vals, flags)
    if dev.type != "cuda":
        raise ValueError(f"bitonic_sort_kvf runs on cuda or cpu, got {dev}")
    _check(keys, vals, flags)
    rows, n = keys.shape
    ok, ov, of = (torch.empty_like(x) for x in (keys, vals, flags))
    if keys.numel() == 0:
        return ok, ov, of
    lib = build.load("bitonic")
    ws = torch.empty(lib.bitonic_ws_ints(rows, n), dtype=_I32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bitonic_launch(
            keys.data_ptr(), vals.data_ptr(), flags.data_ptr(),
            ok.data_ptr(), ov.data_ptr(), of.data_ptr(), ws.data_ptr(),
            rows, n, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError("bitonic kernel launch failed: "
                           + lib.bitonic_error_string(err).decode())
    bitonic_sort_kvf.launches += 1
    return ok, ov, of


#: wrapper calls that launched the kernel (rows of up to 4096 keys take
#: one CUDA launch; longer rows a histogram launch and four digit passes)
bitonic_sort_kvf.launches = 0
