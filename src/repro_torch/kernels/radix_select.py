"""K4: radix threshold selection (the k-th smallest key of each stream).

Replaces the JAX package's Pallas kernel
``kernels/radix_select.py::radix_select_threshold`` with
``csrc/radix_select.cu``: MSB-first rounds of :data:`DIGIT_BITS`-bit
digit histograms over the monotone float -> uint32 map (the reference
takes 32 one-bit rounds; both find the same k-th smallest u32, so they
give the same bits), in one launch: one CTA a row where the row fits
its shared memory, else a cooperative grid whose CTAs hold the row's
chunks on chip, with a barrier between rounds.  ``n_below`` comes from
the histograms.

* :func:`radix_select_threshold` — the wrapper.  CPU tensors take the
  plain version; CUDA tensors launch the kernel on the current stream
  (never a fallback) and add one to ``radix_select_threshold.launches``.
* :func:`launch_plan` — the kernel, its grid, threads, chunks and shared
  memory, from the shape and the card's limits.
* :func:`digit_rounds` — the (shift, width) of each round, as the kernel
  takes them.
* :func:`radix_select_threshold_plain` — the same function as a sort of
  the u32 map.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build, ops

_I32 = torch.int32
_F32 = torch.float32
_ALL_ONES = 0xFFFFFFFF

#: the digit width of the kernel's rounds (four rounds; kBits in the
#: kernel; 11-bit digits measured slower at every shape, PERF.md)
DIGIT_BITS = 8

#: the longest row one CTA takes (its keys and histograms in shared
#: memory) when there are at least as many rows as SMs, and when there are
#: fewer (then a longer row is faster spread over the card)
ROW_MAX = 48 * 1024
ROW_MAX_FEW = 16 * 1024

#: the fewest keys a CTA of the grid kernel takes
MIN_CHUNK = 1024

#: threads of a grid-kernel CTA (kGridThreads), and of a row CTA at most
GRID_THREADS = 1024

#: bytes of shared memory kept back from a block's opt-in for the kernels'
#: static shared memory
SMEM_RESERVE = 1024


def digit_rounds() -> list:
    """(shift, width) of each MSB-first round of :data:`DIGIT_BITS` bits."""
    return [(32 - DIGIT_BITS * (r + 1), DIGIT_BITS)
            for r in range(32 // DIGIT_BITS)]


#: int32 words of the grid kernel's workspace a row (kWsInts): each
#: round's histogram and the row's barrier counter
WS_INTS = len(digit_rounds()) * (1 << DIGIT_BITS) + 4

#: shared words of one histogram with a spare word every 32 bins
#: (kHistWords); a CTA holds two
HIST_WORDS = (1 << DIGIT_BITS) + (1 << DIGIT_BITS) // 32


def _pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One launch over [rows, length] keys.  ``kernel`` "row": one CTA of
    ``threads`` a row, the row staged in ``smem_bytes``.  "grid": a
    cooperative grid of ``groups`` x ``per_row`` CTAs of
    :data:`GRID_THREADS`; group g takes rows g, g + groups, ...; CTA c of
    a group owns keys [c * chunk, (c + 1) * chunk) of the row, held in
    shared memory if ``staged``."""

    rows: int
    length: int
    kernel: str
    threads: int
    grid: int
    per_row: int
    groups: int
    chunk: int
    staged: bool
    smem_bytes: int

    def chunks(self) -> list:
        """[start, end) of each CTA's keys within its row (grid kernel)."""
        return [(min(c * self.chunk, self.length),
                 min((c + 1) * self.chunk, self.length))
                for c in range(self.per_row)]

    def dims(self) -> list:
        """The plan as radix_select_launch reads it."""
        return [self.rows, self.length, int(self.kernel == "grid"), self.threads, self.grid,
                self.per_row, self.groups, self.chunk, int(self.staged),
                self.smem_bytes]


def launch_plan(rows: int, length: int, sms: int, smem_bytes: int,
                blocks_per_sm: int = 1) -> LaunchPlan:
    """The launch for [rows, length] keys on a card of ``sms`` SMs whose
    blocks may use ``smem_bytes`` of dynamic shared memory, where the grid
    kernel fits ``blocks_per_sm`` CTAs an SM at that much.  A row of at
    most :data:`ROW_MAX` keys (:data:`ROW_MAX_FEW` if there are fewer
    rows than SMs) that fits a CTA's shared memory with its histograms
    takes the row kernel, a thread per 8 keys (per 4 if fewer rows than
    SMs), 128 to 1024; longer rows take the grid kernel, sized to what
    the card holds at once: the rows share sms x blocks_per_sm CTAs, each
    at least :data:`MIN_CHUNK` keys (chunks a multiple of 4 keys), staged
    where the chunk fits shared memory.  (The limits and thread counts
    are the fastest measured on the H100; PERF.md.)"""
    hist = 8 * HIST_WORDS
    few = rows < sms
    if (length <= (ROW_MAX_FEW if few else ROW_MAX)
            and hist + 4 * length <= smem_bytes):
        per_thread = 4 if few else 8
        threads = min(GRID_THREADS,
                      max(128, _pow2(-(-length // per_thread))))
        return LaunchPlan(rows, length, "row", threads, rows, 1,
                          rows, length, True, hist + 4 * length)
    capacity = sms * blocks_per_sm
    groups = min(rows, capacity)
    per_row = max(1, min(capacity // groups, length // MIN_CHUNK))
    chunk = -(-length // per_row)
    chunk = -(-chunk // 4) * 4
    per_row = -(-length // chunk)
    staged = hist + 4 * chunk <= smem_bytes
    return LaunchPlan(rows, length, "grid", GRID_THREADS,
                      groups * per_row, per_row, groups, chunk, staged,
                      hist + (4 * chunk if staged else 0))


@dataclasses.dataclass(frozen=True)
class DeviceLimits:
    """What :func:`launch_plan` needs of a card."""

    sms: int
    smem_bytes: int
    blocks_per_sm: int       # grid-kernel CTAs an SM


_LIMITS: dict = {}


def device_limits(device) -> DeviceLimits:
    """The card's SMs, opt-in shared memory a block (less
    :data:`SMEM_RESERVE`) and the grid kernel's occupancy there, from the
    CUDA runtime; queried once per device, which also lifts both kernels'
    shared memory limit to that size."""
    device = torch.device(device)
    got = _LIMITS.get(device)
    if got is None:
        lib = build.load("radix_select")
        out = (ctypes.c_longlong * 3)()
        with torch.cuda.device(device):
            err = lib.radix_select_device_limits(SMEM_RESERVE, out)
        if err != 0:
            raise RuntimeError("radix_select device query failed: "
                               + lib.radix_select_error_string(err).decode())
        got = DeviceLimits(out[0], out[1], out[2])
        _LIMITS[device] = got
    return got


#: the grid kernel's workspace of each (device, stream): zero between
#: launches (each launch leaves it zero), grown when a launch needs more
_WORKSPACE: dict = {}


def workspace(device, stream: int, ints: int) -> torch.Tensor:
    """At least ``ints`` zeroed int32 words for launches on ``stream``:
    made (zeroed) on first use or when too small, and each launch leaves
    them zero.  One stream runs its launches one after another, so they
    never race; another stream gets its own."""
    key = (torch.device(device), stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws.numel() < ints:
        ws = torch.zeros(ints, dtype=_I32, device=device)
        _WORKSPACE[key] = ws
    return ws


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
    lim = device_limits(dev)
    plan = launch_plan(rows, length, lim.sms, lim.smem_bytes,
                       lim.blocks_per_sm)
    dims = (ctypes.c_longlong * 10)(*plan.dims())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = (workspace(dev, stream, rows * WS_INTS).data_ptr()
              if plan.kernel == "grid" else None)
        err = lib.radix_select_launch(
            keys.data_ptr(), k.data_ptr(), tau.data_ptr(),
            n_below.data_ptr(), ws, dims, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError("radix_select kernel launch failed: "
                           + lib.radix_select_error_string(err).decode())
    radix_select_threshold.launches += 1
    return tau, n_below


#: wrapper calls that launched the kernel (one device launch each: the
#: row kernel or the cooperative grid kernel, no memset)
radix_select_threshold.launches = 0
