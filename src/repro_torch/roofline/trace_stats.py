"""Per-device counts of a traced step: the port's counterpart of the
reference's ``roofline/hlo_stats.py``.

The reference compiles its step and reads FLOPs, bytes and collective
payloads off the optimized HLO, recovering loop trip counts from the
loop conditions.  The port has no HLO: eager PyTorch runs its loops in
Python, so every layer, microbatch and attention chunk dispatches its
ops as it runs (the dry run caps the loops and fits the counts over
their trip counts: ``launch.dryrun.TripCounts``).  ``TraceStats`` is a
``TorchDispatchMode`` that sees each of those aten ops (under fake
devices in the dry run, so no memory is allocated and no arithmetic
done) and charges it to devices:

Every count is an exact integer (a sum of Python ints), so that the dry
run can fit counts across traces exactly (``launch.dryrun``).

* ``flops``: the formulas of ``torch.utils.flop_counter`` (matmul,
  ``bmm``, ``addmm``, convolution, ``scaled_dot_product_*``), with the
  same decomposition of composite ops as ``FlopCounterMode``, so that
  the two count the same program alike.  Charged to the output's device.
* ``hbm_bytes``: every tensor operand's bytes on the operand's device
  and every result's bytes on the result's device, for each op that is
  not a view (an allocation alone moves nothing).  Eager PyTorch does
  not fuse, so each op crosses device memory; L2 hits are not modelled,
  so this is an upper estimate.  The reference's TPU VMEM threshold
  (``hlo_stats.VMEM_RESIDENT``) has no counterpart here.
* ``link_bytes``: the bytes of every copy (``_to_copy``, ``copy_``)
  whose source and destination devices differ, charged to the
  destination, by the collective kind that
  ``repro_torch.dist.sharding.link_kind`` names around it (the port's
  collectives, ``Sharded.read`` / ``write``, the ZeRO-1 scatter); an
  untagged copy between devices counts as ``collective-permute``.
* ``peak_bytes``: the most bytes held live at once on each device: the
  arguments' storages (``argument_bytes``) and every storage an op
  creates, each freed when its last tensor dies (a weak reference to the
  storage).  A storage made before the trace that is not an argument is
  not counted.

Under ``placed`` the counter also keeps what each data row of a mesh
step adds (``rows``: ``models.trips.each_row`` names the row running),
so that the dry run can charge a row it did not run with a row it ran,
moved to the other row's devices (``predict_row``).

In the dry run each mesh position has a fake device of its own
(``launch.mesh.fake_devices``), so per device means per position; where
positions share a device (the one card) it means per device.
"""

from __future__ import annotations

import dataclasses
import itertools
import weakref
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.dist import sharding
from repro_torch.launch.fake import storage_of
from repro_torch.models import trips

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
_PASS = {torch.ops.prim.device.default, _aten.size.default,
         _aten.sym_size.default, _aten.stride.default,
         _aten.sym_stride.default, _aten.storage_offset.default,
         _aten.sym_storage_offset.default, _aten.numel.default,
         _aten.sym_numel.default, _aten.dim.default,
         _aten.is_contiguous.default, _aten.is_contiguous.memory_format,
         _aten.sym_is_contiguous.default,
         _aten.is_strides_like_format.default,
         _aten.is_non_overlapping_and_dense.default,
         torch.ops.prim.layout.default}
_COPY = _aten.copy_.default
_COPIES = {_aten._to_copy.default, _COPY}
# views whose schema does not say so (``reshape`` of a fresh copy)
_ALIASES = {_aten._unsafe_view.default}
_ALLOC = {_aten.empty.memory_format, _aten.empty_strided.default,
          _aten.empty_like.default}


@dataclasses.dataclass
class DeviceStats:
    """One device's counts over a trace."""

    flops: int = 0
    hbm_bytes: int = 0
    link: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVES})
    argument_bytes: int = 0
    live_bytes: int = 0
    peak_bytes: int = 0
    ops: int = 0

    @property
    def link_bytes(self) -> int:
        return sum(self.link.values())


_ADDED = ("flops", "hbm_bytes", "ops")


@dataclasses.dataclass
class RowCounts:
    """What one data row of a mesh step added to a trace
    (``TraceStats.rows``): each device's FLOPs, HBM bytes, ops and link
    bytes by kind (``stats``) and, where the counter keeps one, its
    table by op.  The row's places are those named by its index."""

    stats: Dict[torch.device, DeviceStats]
    per_op: Optional[dict] = None


def _minus(now: DeviceStats, then: Optional[DeviceStats]) -> DeviceStats:
    if then is None:
        return dataclasses.replace(now, link=dict(now.link))
    return DeviceStats(
        flops=now.flops - then.flops,
        hbm_bytes=now.hbm_bytes - then.hbm_bytes,
        link={k: v - then.link[k] for k, v in now.link.items()},
        ops=now.ops - then.ops)


def _tensors(args):
    """The tensors among an op's arguments (one level of lists)."""
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, torch.Tensor):
                    yield b


def tree_tensors(tree):
    """Every tensor of a tree of dicts, tuples, lists and ``Sharded``
    leaves (each position's block)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, sharding.Sharded):
        yield from tree.shards
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tree_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_tensors(v)


class TraceStats(TorchDispatchMode):
    """Counts every aten op dispatched under it, per device (see the
    module docstring).  ``arguments`` is the tree of the step's inputs,
    whose storages count as live from the start; ``per_op`` also keeps
    each device's table of (count, flops, bytes) by op.

    ``placed`` (under ``models.trips.capped``, for the dry run's fit)
    also keeps, in ``places``, the most bytes live on each device right
    after an allocation at each place of the loop nest
    (``models.trips.point``): in the forward, the stretch and the ops
    since; in the backward, the same for the autograd node being run,
    which is named by the place of the forward op that made it.  Each
    op's results' nodes are tagged with its place when the next op
    begins (weak references: the tag keeps nothing alive).  A place is
    (an integer, the data row it lies in or None); ``places`` is keyed
    by (place, device), and ``rows`` holds each data row's
    ``RowCounts``."""

    def __init__(self, arguments=None, per_op: bool = False,
                 placed: bool = False):
        super().__init__()
        self.placed = placed
        self.places: Dict[tuple, int] = {}
        self._place = trips.ARGUMENTS
        self._pending = None
        self._serials = itertools.count()
        self.devices: Dict[torch.device, DeviceStats] = defaultdict(
            DeviceStats)
        self.per_op = per_op
        self.table: Dict[torch.device, Dict[str, list]] = defaultdict(
            lambda: defaultdict(lambda: [0, 0, 0]))
        #: each data row's additions, once the row has ended
        self.rows: Dict[int, RowCounts] = {}
        self._row = None            # the row running, and its start:
        self._row_start = None      # (each device's stats, ops tables)
        self._own: Dict[int, list] = {}
        self._held: Dict[int, weakref.ref] = {}
        self._args: set = set()
        self._infos: Dict[object, tuple] = {}
        if arguments is not None:
            for t in tree_tensors(arguments):
                st = storage_of(t)
                if self._hold(st, t.device):
                    self._args.add(id(st))
                    self.devices[t.device].argument_bytes += st.nbytes()

    # -- storages ---------------------------------------------------------
    def _hold(self, st, device) -> bool:
        key = id(st)
        if key in self._held:
            return False
        n = st.nbytes()
        d = self.devices[device]
        d.live_bytes += n
        if d.live_bytes > d.peak_bytes:
            d.peak_bytes = d.live_bytes
        self._held[key] = weakref.ref(
            st, lambda _, k=key, dev=device, n=n: self._free(k, dev, n))
        if self.placed:
            k = (self._place, device)
            if d.live_bytes > self.places.get(k, -1):
                self.places[k] = d.live_bytes
        return True

    def _free(self, key: int, device, n: int) -> None:
        self._held.pop(key, None)
        self._args.discard(key)
        self.devices[device].live_bytes -= n

    def held_arguments(self, tree) -> Dict[torch.device, int]:
        """Bytes of ``tree``'s storages that are the trace's arguments
        (updated in place: the reference's donated aliases), by device."""
        out: Dict[torch.device, int] = defaultdict(int)
        seen = set()
        for t in tree_tensors(tree):
            st = storage_of(t)
            if id(st) in self._args and id(st) not in seen:
                seen.add(id(st))
                out[t.device] += st.nbytes()
        return out

    # -- data rows ---------------------------------------------------------
    def _row_switch(self, row) -> None:
        """The data row running became ``row`` (None: none): close the
        last one's ``RowCounts`` and open ``row``'s."""
        if self._row is not None:
            then, tables = self._row_start
            stats = {dev: _minus(st, then.get(dev))
                     for dev, st in self.devices.items()}
            per_op = None
            if self.per_op:
                per_op = {}
                for dev, tab in self.table.items():
                    old = tables.get(dev, {})
                    per_op[dev] = {
                        k: [a - b for a, b in zip(v, old.get(k, (0, 0, 0)))]
                        for k, v in tab.items()}
            self.rows[self._row] = RowCounts(stats, per_op)
        self._row = row
        if row is not None:
            self._row_start = (
                {dev: _minus(st, None) for dev, st in self.devices.items()},
                {dev: {k: list(v) for k, v in tab.items()}
                 for dev, tab in self.table.items()} if self.per_op else {})

    def predict_row(self, row: int, like: int, moved) -> None:
        """Charge data row ``row``, which did not run, with what row
        ``like`` added, each device's share on ``moved.get(device,
        device)``: its counts and ops tables added, its places given in
        ``row``'s name, and the peaks with them.  (A place of no row
        that a row's backward reaches, a node named only by its op, is
        not charged again: the dry run's check of every row would show
        it.)"""
        rc = self.rows[like]
        for dev, st in rc.stats.items():
            d = self.devices[moved.get(dev, dev)]
            for f in _ADDED:
                setattr(d, f, getattr(d, f) + getattr(st, f))
            for k, v in st.link.items():
                d.link[k] += v
        if rc.per_op is not None:
            for dev, tab in rc.per_op.items():
                mine = self.table[moved.get(dev, dev)]
                for k, v in tab.items():
                    got = mine[k]
                    for i in range(3):
                        got[i] += v[i]
        own = self._own.get(like)
        if own is None:
            own = self._own[like] = [
                (place[0], dev, v) for (place, dev), v in self.places.items()
                if place[1] == like]
        places, devices = self.places, self.devices
        for h, dev, v in own:
            at = moved.get(dev, dev)
            places[((h, row), at)] = v
            if v > devices[at].peak_bytes:
                devices[at].peak_bytes = v

    # -- places in the loop nest -----------------------------------------
    def enter(self, outs) -> None:
        """Mark the op whose results are ``outs`` (a list of tensors) as
        the one being counted: tag the previous op's results' autograd
        nodes with its place and find this op's (``placed`` only)."""
        pend = self._pending
        if pend is not None:
            for ref in pend[0]:
                t = ref()
                fn = None if t is None else t.grad_fn
                if fn is not None:
                    fn.metadata.setdefault("trip_place", pend[1])
        node = torch._C._current_autograd_node()
        if node is None:
            serial = tag = None
        else:
            meta = node.metadata
            serial = meta.get("trip_serial")
            if serial is None:
                serial = meta["trip_serial"] = next(self._serials)
            tag = meta.get("trip_place") or node.name()
        self._place = trips.point(serial, tag)
        self._pending = ([weakref.ref(t) for t in outs], self._place)

    def view(self, out) -> None:
        """A view ran (counted as nothing): its node is placed as any
        op's."""
        if self.placed:
            self.enter(list(_tensors(out if isinstance(out, (list, tuple))
                                     else (out,))))

    # -- dispatch ---------------------------------------------------------
    def _info(self, func):
        """What the counter does with ``func``, worked out once: (pass
        through uncounted, try its composite decomposition first, a view,
        its FLOP formula or None, writes an operand, only allocates, is
        a copy, its name)."""
        info = self._infos.get(func)
        if info is None:
            packet = func._overloadpacket
            passed = func in _PASS
            info = (passed,
                    not passed and packet not in flop_registry and
                    torch._C._dispatch_has_kernel_for_dispatch_key(
                        func.name(),
                        torch._C.DispatchKey.CompositeImplicitAutograd),
                    func.is_view or func in _ALIASES,
                    flop_registry.get(packet),
                    any(a.alias_info is not None and a.alias_info.is_write
                        for a in func._schema.arguments),
                    func in _ALLOC, func in _COPIES, str(packet))
            self._infos[func] = info
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        info = self._info(func)
        if info[0]:
            return func(*args, **kwargs)
        if info[1]:
            # as FlopCounterMode: a composite op (``einsum``; ``to``
            # under inference mode) is counted by what it decomposes to
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if not info[2]:
            self.observe(info, func, args, kwargs, out)
        else:
            self.view(out)
        return out

    def observe(self, info, func, args, kwargs, out) -> None:
        """Count one op that has run (``info`` is ``_info(func)``, ``out``
        its result): the dispatch above, or ``launch.fake.FakeDevices``
        calling in its own dispatch (one mode instead of two)."""
        _, _, _, flop, mutating, alloc, copy, name = info
        outs = list(_tensors(out if isinstance(out, (list, tuple))
                             else (out,)))
        if not outs:
            return
        if self.placed:
            row = trips.now()
            if row != self._row:
                self._row_switch(row)
            self.enter(outs)
        dev = outs[0].device
        devices = self.devices
        d = devices[dev]
        d.ops += 1
        flops = 0
        if flop is not None:
            flops = int(flop(*args, **kwargs, out_val=out))
            d.flops += flops
        moved = 0
        if not alloc:
            for t in _tensors(args):
                n = t.nbytes
                devices[t.device].hbm_bytes += n
                moved += n
            for t in outs:
                n = t.nbytes
                devices[t.device].hbm_bytes += n
                moved += n
        if copy:
            src = args[1] if func is _COPY else args[0]
            if src.device != dev:
                kind = sharding.current_link_kind() or "collective-permute"
                d.link[kind] += outs[0].nbytes
        if not mutating:
            for t in outs:
                self._hold(storage_of(t), t.device)
        if self.per_op:
            row = self.table[dev][name]
            row[0] += 1
            row[1] += flops
            row[2] += moved

    # -- results ----------------------------------------------------------
    def stats(self, device) -> DeviceStats:
        return self.devices[torch.device(device)]

    def total_flops(self) -> int:
        return sum(d.flops for d in self.devices.values())


def count(step, *args, arguments=None, per_op: bool = False, fake=None,
          placed: bool = False, **kwargs):
    """Run ``step(*args, **kwargs)`` under a ``TraceStats``; returns
    (its output, the counter).  ``arguments`` defaults to the call's.
    ``fake``, the ``launch.fake.FakeDevices`` mode the call runs under,
    counts in its own dispatch (the same counts, one mode fewer a op)."""
    counter = TraceStats((args, kwargs) if arguments is None else arguments,
                         per_op=per_op, placed=placed)
    if fake is None:
        with counter:
            out = step(*args, **kwargs)
    else:
        fake.counter = counter
        try:
            out = step(*args, **kwargs)
        finally:
            fake.counter = None
    if counter._row is not None:
        counter._row_switch(None)
    return out, counter


__all__ = ["COLLECTIVES", "DeviceStats", "RowCounts", "TraceStats",
           "count", "tree_tensors"]
