"""K4: radix threshold selection (the k-th smallest key of each stream).

Replaces the JAX package's Pallas kernel
``kernels/radix_select.py::radix_select_threshold`` with
``csrc/radix_select.cu``: four MSB-first rounds of 8-bit digit histograms
over the monotone float -> uint32 map (the reference takes 32 one-bit
rounds; both find the same k-th smallest u32, so they give the same
bits), then one counting pass for ``n_below``.

* :func:`radix_select_threshold` — the wrapper.  CPU tensors take the
  plain version; CUDA tensors launch the kernel on the current stream
  (never a fallback) and add one to ``radix_select_threshold.launches``.
* :func:`radix_select_threshold_plain` — the same function as a sort of
  the u32 map.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ops

_I32 = torch.int32
_F32 = torch.float32
_ALL_ONES = 0xFFFFFFFF


def _from_sortable_u32(u: torch.Tensor) -> torch.Tensor:
    """Inverse of the u32 map, for u32 values held in int64."""
    bits = torch.where(u < 0x80000000, u ^ _ALL_ONES, u & 0x7FFFFFFF)
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(_I32).view(_F32)


def radix_select_threshold_plain(keys, k):
    """The kernel's plain version.  ``keys`` [B, L] f32, ``k`` [B] int32.

    The prefix is the k-th smallest u32 of each stream; for k > L every
    radix round takes the top digit, so it is all ones (tau NaN, as in
    the reference kernel).  tau maps the prefix back, n_below counts the
    keys strictly below it, and k <= 0 gives (-inf, 0)."""
    u = ops._to_sortable_u32(keys)
    length = keys.shape[-1]
    k = k.to(torch.int64)
    su = torch.sort(u, dim=-1).values
    kth = su.gather(-1, (k - 1).clamp(0, length - 1)[:, None])[:, 0]
    prefix = torch.where(k > length, _ALL_ONES, kth)
    n_below = (u < prefix[:, None]).sum(-1, dtype=_I32)
    tau = torch.where(k > 0, _from_sortable_u32(prefix), -float("inf"))
    return tau, torch.where(k > 0, n_below, 0)


def _check(keys, k):
    if keys.dtype != _F32 or keys.dim() != 2 or not keys.is_contiguous():
        raise ValueError(f"keys must be contiguous [B, L] float32, got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    if k.dtype != _I32 or tuple(k.shape) != keys.shape[:1] \
            or not k.is_contiguous():
        raise ValueError(f"k must be contiguous [B] int32, got {k.dtype} "
                         f"{tuple(k.shape)} for keys {tuple(keys.shape)}")
    if k.device != keys.device:
        raise ValueError(f"k on {k.device}, keys on {keys.device}")
    if keys.shape[1] == 0 or keys.shape[1] >= 1 << 30:
        raise ValueError(f"stream length {keys.shape[1]} out of range")


def radix_select_threshold(keys, k):
    """(tau [B] f32, n_below [B] int32): tau the k-th smallest key of each
    row of ``keys`` [B, L] (a flattened [NB, BCAP] store is one row) and
    n_below = #{keys strictly below tau in u32 order}.  ``k`` is [B]
    int32 or a scalar for every row; it stays on the device.

    Edges, as the reference kernel pins them: k = 0 gives (-inf, 0); an
    all-INF stream gives INF; k past the finite count gives (INF,
    #finite); -0.0 orders below 0.0; ties at tau count strictly below."""
    dev = keys.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"radix_select_threshold runs on cuda or cpu, "
                         f"got {dev}")
    if not isinstance(k, torch.Tensor) or k.dim() == 0:
        k = ops._per_stream_k(k, keys.shape[:1], dev)
    if dev.type == "cpu":
        return radix_select_threshold_plain(keys, k)
    _check(keys, k)
    rows, length = keys.shape
    tau = torch.empty(rows, dtype=_F32, device=dev)
    n_below = torch.empty(rows, dtype=_I32, device=dev)
    lib = build.load("radix_select")
    ws = torch.empty(rows * lib.radix_select_ws_ints(), dtype=_I32,
                     device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.radix_select_launch(
            keys.data_ptr(), k.data_ptr(), tau.data_ptr(),
            n_below.data_ptr(), ws.data_ptr(), rows, length,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError("radix_select kernel launch failed: "
                           + lib.radix_select_error_string(err).decode())
    radix_select_threshold.launches += 1
    return tau, n_below


#: wrapper calls that launched the kernel (one call is seven launches:
#: a memset, four histogram rounds, the count and the finish)
radix_select_threshold.launches = 0
