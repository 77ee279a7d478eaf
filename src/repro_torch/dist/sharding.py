"""Logical-axis sharding over a mesh of positions (port of the JAX
package's ``dist/sharding.py``), and the placement and collectives that
stand in for GSPMD.

Model code names activation axes logically ("batch", "seq", "vocab",
...); a rule table maps logical -> physical mesh axes per topology.
``use_mesh`` installs the (mesh, rules) pair in a context; outside any
mesh every annotation is a no-op.

The port's mesh is one process and an ordered grid of devices, where a
device may repeat (as ``core/distributed.py``'s mesh queue: NCCL refuses
two ranks on one card).  So what GSPMD does for the reference is done
here by hand:

* **Storage.**  ``NamedSharding(mesh, spec)`` gives each position its
  block of a global shape (a dim split over axes (a, b) falls into
  ``mesh[a] * mesh[b]`` blocks, ``a`` outermost, as in jax).
  ``device_put`` turns a tree of tensors into ``Sharded`` leaves, one
  tensor per position holding only its block (a replicated block is a
  copy per position); ``gather`` gives the global tensors back, bit for
  bit.  ``Sharded.read`` / ``write`` move any box of a leaf between its
  blocks and one device.
* **Collectives.**  ``psum``, ``pmax``, ``pmean``, ``all_gather`` and
  ``reduce_scatter`` act on a list of per-position tensors (position
  order, the mesh's row-major order) over a named axis: each group of
  positions that differ only along the axis is reduced on its first
  position's device in position order, and the result is copied to each
  position's device.  No position is skipped for sharing a device.
* **Compute** belongs to the callers (``launch/train.py``,
  ``launch/serve.py``, ``models/moe.py``): they loop over the mesh's
  data rows (``row_scope``) and over a row's ``model`` positions where
  the reference writes a ``shard_map``.  ``shard`` and
  ``shard_activation_sp`` are identities on values: layout is owned by
  placement, not by annotations inside the computation.
* **Tensor parallelism over ``model``** (the serving steps): a data
  row's ``RowSplit`` views a placed parameter tree as ``Blocks``, one a
  leaf, which read position j's block along the leaf's ``model`` dim onto
  j's device, one pattern group of a stacked leaf at a time, when the
  model code first asks for it (a leaf whose spec does not name
  ``model`` is read whole, a copy a position).  The row's first position
  (its home) keeps the residual stream; ``spread``, ``sum``, ``gather``
  and ``scatter`` move a row's activations between the home and its
  positions in position order.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.models.trips import each_copy

# logical -> tuple of physical mesh axes (applied in order, outermost
# first).  "seq" is unsharded by default; sp_rules() flips it to "model"
# (sequence parallelism).
RULES_2D: Dict[str, Tuple[str, ...]] = {
    "batch": ("data",),
    "seq": (),
    "model": ("model",),
    "vocab": ("model",),
    "heads": ("model",),
    "expert": ("model",),
}

RULES_3D: Dict[str, Tuple[str, ...]] = {
    **RULES_2D,
    "batch": ("pod", "data"),
}


def sp_rules(base: Dict[str, Tuple[str, ...]]) -> Dict[str, Tuple[str, ...]]:
    """Sequence-parallel variant: activations shard over `model` along S."""
    return {**base, "seq": ("model",)}


class P(tuple):
    """A partition spec: one entry per dim, each None (replicated), an
    axis name, or a tuple of names (outermost first).  Trailing dims may
    be omitted."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P" + (tuple.__repr__(self) if len(self) != 1
                      else f"({self[0]!r})")


def axes_of(part) -> Tuple[str, ...]:
    """A spec entry as a tuple of axis names."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

class Mesh:
    """A grid of positions with named axes.  ``devices`` is the flat list
    of each position's ``torch.device`` in row-major order (devices may
    repeat), or None for an abstract mesh, which serves the spec
    functions and refuses placement."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[Sequence] = None):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(
                axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names}")
        self.axis_names = axis_names
        self.shape = OrderedDict(zip(axis_names, shape))
        self.size = math.prod(shape)
        if devices is not None:
            devices = [torch.device(d) for d in devices]
            if len(devices) != self.size:
                raise ValueError(f"{len(devices)} devices for a mesh of "
                                 f"{self.size} positions")
        self._devices = devices
        # pure functions of the mesh, worked out once (``groups``,
        # ``NamedSharding.layout``)
        self._groups: Dict[Tuple[str, ...], List[List[int]]] = {}
        self._layouts: Dict[tuple, "Layout"] = {}

    @property
    def empty(self) -> bool:
        return self.size == 0

    @property
    def abstract(self) -> bool:
        return self._devices is None

    @property
    def devices(self) -> List[torch.device]:
        if self._devices is None:
            raise ValueError("an abstract mesh has no devices: build one with "
                             "make_mesh(shape, axes, devices=...)")
        return self._devices

    def coords(self, p: int) -> Dict[str, int]:
        """Position ``p``'s index along each axis."""
        out = {}
        for a in reversed(self.axis_names):
            p, out[a] = divmod(p, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def groups(self, axis) -> List[List[int]]:
        """The positions that differ only along ``axis`` (a name or a
        tuple of names), each group in position order."""
        names = axes_of(axis)
        got = self._groups.get(names)
        if got is None:
            for a in names:
                if a not in self.shape:
                    raise ValueError(f"no axis {a!r} in mesh "
                                     f"{self.axis_names}")
            out: Dict[tuple, List[int]] = {}
            for p in range(self.size):
                c = self.coords(p)
                key = tuple(c[a] for a in self.axis_names if a not in names)
                out.setdefault(key, []).append(p)
            got = self._groups[names] = list(out.values())
        return [list(g) for g in got]

    def __repr__(self) -> str:
        kind = "abstract" if self.abstract else f"on {self._devices}"
        return f"Mesh({dict(self.shape)}, {kind})"


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh of ``prod(shape)`` positions on ``devices`` (row-major; a
    device may repeat: ``["cuda:0"] * 8`` puts eight positions on one
    card).  Without ``devices``, the visible cards, one a position."""
    if devices is None:
        n, have = math.prod(shape), torch.cuda.device_count()
        if have < n:
            raise ValueError(
                f"a mesh of {n} positions needs {n} cuda devices, have "
                f"{have}; pass devices=[...] to place the positions (a "
                "device may repeat)")
        devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(shape, axes, devices)


def abstract_mesh(shape, axes) -> Mesh:
    """Shape and axis names only (the reference's ``AbstractMesh``)."""
    return Mesh(shape, axes)


# ---------------------------------------------------------------------------
# the (mesh, rules) context and the data rows
# ---------------------------------------------------------------------------

class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.rules: Dict[str, Tuple[str, ...]] = RULES_2D
        self.row: Optional["Row"] = None
        self.link: Optional[str] = None


_CTX = _Ctx()


@contextlib.contextmanager
def link_kind(kind: str):
    """Name the collective that the copies between devices in the extent
    make ("all-reduce", "all-gather", "reduce-scatter"), for a counter
    of the link bytes (``roofline.trace_stats``).  An enclosing name
    wins.  It changes no value."""
    prev = _CTX.link
    if prev is None:
        _CTX.link = kind
    try:
        yield
    finally:
        _CTX.link = prev


def current_link_kind() -> Optional[str]:
    return _CTX.link


def current_mesh() -> Optional[Mesh]:
    return _CTX.mesh


def current_rules() -> Dict[str, Tuple[str, ...]]:
    return _CTX.rules


@contextlib.contextmanager
def use_mesh(mesh: Mesh, rules: Optional[Dict[str, Tuple[str, ...]]] = None):
    """Install (mesh, rules) for the dynamic extent; nestable."""
    if rules is None:
        rules = RULES_3D if "pod" in mesh.axis_names else RULES_2D
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield mesh
    finally:
        _CTX.mesh, _CTX.rules = prev


def _resolve(axis, mesh: Mesh) -> Tuple[str, ...]:
    """Logical name -> physical axes present on this mesh."""
    if axis is None:
        return ()
    names = _CTX.rules.get(axis, ())
    return tuple(a for a in names if a in mesh.axis_names)


def spec(*logical) -> P:
    """PartitionSpec for logical axis names under the active rules.

    Unknown names and names whose physical axes are absent from the mesh
    resolve to None (replicated).  Without an active mesh, returns a fully
    replicated spec (same arity).
    """
    mesh = _CTX.mesh
    if mesh is None:
        return P(*([None] * len(logical)))
    parts = []
    for ax in logical:
        phys = _resolve(ax, mesh)
        parts.append(phys if len(phys) > 1 else (phys[0] if phys else None))
    return P(*parts)


def shard(x, *logical):
    """The reference's ``with_sharding_constraint`` by logical names: an
    identity on values here, with or without a mesh (layout is owned by
    placement: ``device_put`` and the steps' row loops)."""
    return x


def shard_activation_sp(x):
    """Sequence-parallel residual constraint for [B, S, D] activations
    (an identity, as ``shard``)."""
    return shard(x, "batch", "seq", None)


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes a batch is split over: (``pod``,) ``data``."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


class Row:
    """One data row of a mesh: the positions that share its (pod, data)
    coordinates, in ``model`` order.  ``index`` counts rows in position
    order, ``device`` is its first position's."""

    def __init__(self, mesh: Mesh, index: int):
        groups = mesh.groups(tuple(a for a in mesh.axis_names
                                   if a not in batch_axes(mesh)))
        self.mesh, self.index = mesh, index
        self.positions = groups[index]
        self.devices = [mesh.devices[p] for p in self.positions]
        self.device = self.devices[0]


def rows(mesh: Mesh) -> List[Row]:
    n = math.prod(mesh.shape[a] for a in batch_axes(mesh))
    return [Row(mesh, r) for r in range(n)]


def current_row() -> Optional[Row]:
    return _CTX.row


def current_context():
    """The installed (mesh, rules, row), to be entered again elsewhere
    (``entered``): autograd may recompute a checkpointed block on
    another thread, where a thread-local context is empty."""
    return (_CTX.mesh, _CTX.rules, _CTX.row)


@contextlib.contextmanager
def entered(ctx):
    prev = current_context()
    _CTX.mesh, _CTX.rules, _CTX.row = ctx
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules, _CTX.row = prev


@contextlib.contextmanager
def row_scope(row: Row):
    """Mark the dynamic extent as one data row's share of a mesh step:
    code that splits the batch itself under a mesh (``moe_apply_dist``)
    then takes its input as this row's shard."""
    prev, _CTX.row = _CTX.row, row
    try:
        yield row
    finally:
        _CTX.row = prev


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

class NamedSharding:
    """A spec on a mesh: where each position's block of a global shape
    lies."""

    def __init__(self, mesh: Mesh, spec_: P):
        self.mesh, self.spec = mesh, P(*spec_)
        for part in self.spec:
            for a in axes_of(part):
                if a not in mesh.shape:
                    raise ValueError(f"axis {a!r} of {self.spec} is not in "
                                     f"the mesh {mesh.axis_names}")

    def _parts(self, ndim: int):
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} for a {ndim}-d leaf")
        return list(self.spec) + [None] * (ndim - len(self.spec))

    def block_index(self, shape, p: int) -> Tuple[Tuple[int, int], ...]:
        """(index, count) of position ``p``'s block along each dim."""
        c = self.mesh.coords(p)
        out = []
        for part in self._parts(len(shape)):
            idx, cnt = 0, 1
            for a in axes_of(part):
                idx, cnt = idx * self.mesh.shape[a] + c[a], cnt * \
                    self.mesh.shape[a]
            out.append((idx, cnt))
        return tuple(out)

    def block(self, shape, p: int) -> Tuple[slice, ...]:
        """Position ``p``'s block of a global ``shape``."""
        out = []
        for n, (idx, cnt) in zip(shape, self.block_index(shape, p)):
            if n % cnt:
                raise ValueError(f"dim {n} does not split into {cnt} blocks "
                                 f"(spec {self.spec}, shape {tuple(shape)})")
            k = n // cnt
            out.append(slice(idx * k, (idx + 1) * k))
        return tuple(out)

    def shard_shape(self, shape) -> Tuple[int, ...]:
        return tuple(s.stop - s.start for s in self.block(shape, 0))

    def layout(self, shape) -> "Layout":
        """Every position's block of a global ``shape``, worked out once
        per (mesh, spec, shape) and kept on the mesh."""
        key = (tuple(self.spec), tuple(shape))
        got = self.mesh._layouts.get(key)
        if got is None:
            got = self.mesh._layouts[key] = Layout(self, tuple(shape))
        return got

    def __repr__(self) -> str:
        return f"NamedSharding({dict(self.mesh.shape)}, {self.spec})"


class Layout:
    """Where each position's block of one global shape lies under one
    spec: ``blocks[p]`` (a box of slices), ``owners`` (one position per
    distinct block, the first that holds it), and the blocks a box
    overlaps, each found once per box (``reads`` over the owners,
    ``writes`` over every position) from the block indices the box
    spans along each dim.  The spec's blocks must tile the shape."""

    def __init__(self, sharding: NamedSharding, shape: Tuple[int, ...]):
        n = sharding.mesh.size
        self.blocks = [sharding.block(shape, p) for p in range(n)]
        index = [sharding.block_index(shape, p) for p in range(n)]
        self._size = [s_.stop - s_.start for s_ in self.blocks[0]] if n \
            else []
        # block index -> the positions that hold it, in position order
        self._holders: Dict[tuple, List[int]] = {}
        for p in range(n):
            self._holders.setdefault(tuple(i for i, _ in index[p]),
                                     []).append(p)
        self.owners = sorted(h[0] for h in self._holders.values())
        self._boxes: Dict[tuple, list] = {}
        self._regions: Dict[bool, list] = {}

    def _overlaps(self, box, owners_only: bool):
        """(position, its part of ``box`` in the box's frame, the same
        part in its block's frame) for each owner (or each position)
        whose block overlaps ``box``, in position order."""
        key = (owners_only, _key(box))
        got = self._boxes.get(key)
        if got is None:
            spans = []
            for sl, k in zip(box, self._size):
                if sl.start >= sl.stop:
                    spans = None
                    break
                spans.append(range(sl.start // k, (sl.stop - 1) // k + 1))
            found = []
            if spans is not None:
                for idx in itertools.product(*spans):
                    held = self._holders.get(idx, ())
                    found.extend(held[:1] if owners_only else held)
            got = []
            for p in sorted(found):
                blk = self.blocks[p]
                ov = _overlap(blk, box)
                got.append((p, _shift(ov, box), _shift(ov, blk)))
            self._boxes[key] = got
        return got

    def reads(self, box):
        return self._overlaps(box, True)

    def writes(self, box):
        return self._overlaps(box, False)

    def regions(self, shape, whole_last: bool = False):
        """The distinct boxes of the owners' blocks (with the last dim
        whole where ``whole_last``), each with the first owner that holds
        it, in owner order."""
        got = self._regions.get(whole_last)
        if got is None:
            seen, got = set(), []
            for p in self.owners:
                box = self.blocks[p]
                if whole_last and box:
                    box = box[:-1] + (slice(0, shape[-1]),)
                key = _key(box)
                if key not in seen:
                    seen.add(key)
                    got.append((box, p))
            self._regions[whole_last] = got
        return got


def _key(box) -> tuple:
    return tuple((s.start, s.stop) for s in box)


def _overlap(a: Tuple[slice, ...], b: Tuple[slice, ...]):
    """The intersection of two boxes, or None."""
    out = []
    for x, y in zip(a, b):
        lo, hi = max(x.start, y.start), min(x.stop, y.stop)
        if lo >= hi:
            return None
        out.append(slice(lo, hi))
    return tuple(out)


def _shift(box, origin):
    return tuple(slice(s.start - o.start, s.stop - o.start)
                 for s, o in zip(box, origin))


def _cut(t: torch.Tensor, box) -> torch.Tensor:
    """``t[box]``, narrowing only the dims the box cuts."""
    for i, sl in enumerate(box):
        if sl.start != 0 or sl.stop != t.shape[i]:
            t = t.narrow(i, sl.start, sl.stop - sl.start)
    return t


def full_box(shape) -> Tuple[slice, ...]:
    return tuple(slice(0, n) for n in shape)


class Sharded:
    """A global tensor stored as one block per mesh position
    (``shards[p]`` on ``mesh.devices[p]``).  Positions whose blocks are
    replicas hold equal, separate tensors."""

    def __init__(self, sharding: NamedSharding, shape, shards):
        self.sharding, self.shape = sharding, torch.Size(shape)
        self.shards = list(shards)
        self.dtype = self.shards[0].dtype

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def layout(self) -> Layout:
        return self.sharding.layout(self.shape)

    def block(self, p: int) -> Tuple[slice, ...]:
        return self.layout.blocks[p]

    def owners(self) -> List[int]:
        """One position per distinct block (the first that holds it)."""
        return list(self.layout.owners)

    def read(self, box=None, device=None) -> torch.Tensor:
        """The ``box`` of the global tensor (all of it by default) on
        ``device`` (the first position's by default), assembled from the
        first holder of each block it overlaps."""
        box = full_box(self.shape) if box is None else tuple(box)
        device = self.mesh.devices[0] if device is None else device
        out = torch.empty(tuple(s.stop - s.start for s in box),
                          dtype=self.dtype, device=device)
        with link_kind("all-gather"):
            for p, dst, src in each_copy(self.layout.reads(box)):
                out[dst] = self.shards[p][src].to(device)
        return out

    def gather_box(self, box, device) -> torch.Tensor:
        """``read`` with each block copied once, straight into its part of
        the result (``copy_`` across devices; no copy of the block on its
        way, and as many ops whether a block is on ``device`` or not): a
        row's block reads (``Blocks``)."""
        box = tuple(box)
        out = torch.empty(tuple(s.stop - s.start for s in box),
                          dtype=self.dtype, device=device)
        with link_kind("all-gather"):
            for p, dst, src in each_copy(self.layout.reads(box)):
                _cut(out, dst).copy_(_cut(self.shards[p], src))
        return out

    def write(self, box, value: torch.Tensor) -> None:
        """Write ``value`` (the shape of ``box``) into every position whose
        block overlaps ``box``."""
        box = tuple(box)
        with link_kind("reduce-scatter"):
            for p, src, part in self.layout.writes(box):
                dst = self.shards[p]
                dst[part] = value[src].to(dst.device, dst.dtype)

    def __repr__(self) -> str:
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, "
                f"{self.sharding})")


def _is_leaf(x) -> bool:
    return isinstance(x, P) or not isinstance(x, (dict, tuple, list))


def tree_map2(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of one structure (dicts by
    key, NamedTuples and tuples by position; a ``P`` is a leaf).  A leaf
    of ``other`` applies to the whole subtree of ``tree`` below it."""
    if _is_leaf(other):
        if isinstance(tree, dict):
            return {k: tree_map2(fn, v, other) for k, v in tree.items()}
        if isinstance(tree, tuple):
            vals = [tree_map2(fn, v, other) for v in tree]
            return (type(tree)(*vals) if hasattr(tree, "_fields")
                    else tuple(vals))
        return fn(tree, other)
    if isinstance(tree, dict):
        return {k: tree_map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [tree_map2(fn, v, o) for v, o in zip(tree, other)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(tree, other)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)``, a path being the tuple of dict keys (str) and
    tuple positions (int) down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [tree_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(path, tree)


def place(x: torch.Tensor, sharding: NamedSharding) -> Sharded:
    """One global tensor split into its positions' blocks (copies): the
    tensor goes whole to each distinct device once, and each position's
    block is cut there."""
    on = {}
    shards = []
    blocks = sharding.layout(x.shape).blocks
    for p, dev in enumerate(sharding.mesh.devices):
        if dev not in on:
            on[dev] = x.to(dev)
        shards.append(on[dev][blocks[p]].clone(
            memory_format=torch.contiguous_format))
    return Sharded(sharding, x.shape, shards)


def zeros(shape, dtype, sharding: NamedSharding) -> Sharded:
    """A global zero tensor placed: each position's block allocated on
    its own device (nothing whole is ever made)."""
    blk = sharding.shard_shape(shape)
    return Sharded(sharding, shape, [
        torch.zeros(blk, dtype=dtype, device=d)
        for d in sharding.mesh.devices])


def device_put(tree, shardings):
    """A tree of tensors placed leaf by leaf by a tree of
    ``NamedSharding`` (or one for every leaf): ``Sharded`` leaves."""
    def put(x, sh):
        if isinstance(x, Sharded):
            x = x.read()
        return place(x, sh)
    return tree_map2(put, tree, shardings)


def gather(tree, device=None):
    """The global tensors of a tree of ``Sharded`` leaves, each on
    ``device`` (its mesh's first device by default); other leaves pass
    through."""
    from repro_torch.models.transformer import tree_map
    return tree_map(lambda x: x.read(device=device)
                    if isinstance(x, Sharded) else x, tree)


def held_bytes(tree, mesh: Mesh) -> List[int]:
    """Bytes each position holds for a tree of ``Sharded`` leaves."""
    from repro_torch.models.transformer import tree_leaves
    out = [0] * mesh.size
    for x in tree_leaves(tree):
        if isinstance(x, Sharded):
            for p, s in enumerate(x.shards):
                out[p] += s.numel() * s.element_size()
    return out


# ---------------------------------------------------------------------------
# collectives over a named axis, on per-position lists
# ---------------------------------------------------------------------------

def _check(xs, mesh: Mesh):
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} values for {mesh.size} positions")


def _fold(vals, op):
    """``vals`` combined by ``op`` in order on the first one's device."""
    acc = vals[0]
    for v in vals[1:]:
        acc = op(acc, v.to(acc.device))
    return acc


def _reduce(xs, mesh: Mesh, axis, op):
    _check(xs, mesh)
    out = [None] * mesh.size
    with link_kind("all-reduce"):
        for g in mesh.groups(axis):
            acc = _fold([xs[p] for p in g], op)
            for p in g:
                out[p] = acc.to(mesh.devices[p], copy=True)
    return out


def psum(xs, mesh: Mesh, axis):
    """Each group's sum, in position order, on every position."""
    return _reduce(xs, mesh, axis, torch.add)


def pmax(xs, mesh: Mesh, axis):
    return _reduce(xs, mesh, axis, torch.maximum)


def pmean(xs, mesh: Mesh, axis):
    n = math.prod(mesh.shape[a] for a in axes_of(axis))
    return [s / n for s in psum(xs, mesh, axis)]


def all_gather(xs, mesh: Mesh, axis, dim: int = 0):
    """Each group's values concatenated along ``dim`` in position order,
    on every position."""
    _check(xs, mesh)
    out = [None] * mesh.size
    with link_kind("all-gather"):
        for g in mesh.groups(axis):
            dev = xs[g[0]].device
            cat = torch.cat([xs[p].to(dev) for p in g], dim)
            for p in g:
                out[p] = cat.to(mesh.devices[p], copy=True)
    return out


def reduce_scatter(xs, mesh: Mesh, axis, dim: int = 0):
    """Each group's sum (position order), split along ``dim``: the k-th
    position of a group takes the k-th block."""
    with link_kind("reduce-scatter"):
        summed = psum(xs, mesh, axis)
    out = [None] * mesh.size
    for g in mesh.groups(axis):
        for k, p in enumerate(g):
            out[p] = summed[p].chunk(len(g), dim)[k].contiguous()
    return out


# ---------------------------------------------------------------------------
# a data row's tensor parallelism over ``model``
# ---------------------------------------------------------------------------

def even_bounds(n: int, m: int) -> List[Tuple[int, int]]:
    """``n`` items over ``m`` positions, contiguous and balanced: position
    j takes [j n // m, (j + 1) n // m) (some take none where n < m)."""
    return [(j * n // m, (j + 1) * n // m) for j in range(m)]


class RowSplit:
    """A data row's ``model`` positions, as its step computes on them:
    ``devices`` in position order, ``home`` the first one's, which keeps
    the residual stream.  ``view`` turns a placed parameter tree into
    ``Blocks``; the rest move activations between the home and the
    positions, naming the collective each stands for."""

    def __init__(self, row: Row):
        self.row = row
        self.devices = list(row.devices)
        self.home = row.device
        self.m = len(self.devices)

    def view(self, params):
        """Each ``Sharded`` leaf of ``params`` as ``Blocks`` (nothing is
        read yet)."""
        from repro_torch.models.transformer import tree_map
        return tree_map(lambda x: Blocks(x, self)
                        if isinstance(x, Sharded) else x, params)

    def spread(self, x) -> List[torch.Tensor]:
        """A home tensor on every position (what the all-reduce before it
        leaves on each position under SPMD)."""
        with link_kind("all-reduce"):
            return [x.to(d) for d in self.devices]

    def sum(self, parts) -> torch.Tensor:
        """The positions' partial products summed on the home in position
        order (a psum over ``model``)."""
        with link_kind("all-reduce"):
            return _fold(list(parts), torch.add).to(self.home)

    def gather(self, parts, dim: int) -> torch.Tensor:
        """The positions' parts concatenated along ``dim`` on the home,
        in position order (an all-gather over ``model``); a position's
        empty part adds nothing."""
        with link_kind("all-gather"):
            return torch.cat([t.to(self.home) for t in parts], dim)

    def scatter(self, x, bounds, dim: int) -> List[torch.Tensor]:
        """Each position's slice ``bounds[j]`` of a home tensor along
        ``dim``, on its device (a re-split between two layouts)."""
        with link_kind("all-to-all"):
            return [x.narrow(dim, lo, hi - lo).to(d)
                    for (lo, hi), d in zip(bounds, self.devices)]

    def columns(self, parts, w: "Blocks", want) -> List[torch.Tensor]:
        """Position j's columns ``want[j]`` of a product whose parts came
        out of ``w``'s column blocks: kept where each block is just those
        columns, else gathered on the home and handed out."""
        if w.dim == len(w.shape) - 1 and w.bounds == list(want):
            return list(parts)
        whole = parts[0] if w.dim is None else self.gather(parts, -1)
        return self.scatter(whole, want, -1)

    def columns_product(self, x, w: "Blocks",
                        f32: bool = False) -> torch.Tensor:
        """``x @ w`` (both in float32 where ``f32``) for a home ``x`` and
        ``w`` split over its columns: each position its columns, gathered
        on the home (for an op that needs the columns whole)."""
        xs = self.spread(x)
        parts = [xs[j].float() @ w.block(j).float() if f32
                 else xs[j] @ w.block(j) for j in range(self.m)]
        return parts[0] if w.dim is None else self.gather(parts, -1)

    def rows_product(self, x, w: "Blocks", have=None) -> torch.Tensor:
        """``x @ w`` for ``w`` split over its rows (the contracted dim):
        each position multiplies its block by its columns of ``x`` and
        the row sums the partial products.  ``x`` is a home tensor, or
        the positions' parts holding its columns ``have[j]``.  A ``w``
        that names no ``model`` is multiplied whole on every position and
        the home's product kept."""
        if have is not None and (w.dim is None or w.bounds != list(have)):
            x, have = self.gather(x, -1), None
        if have is None:
            x = (self.spread(x) if w.dim is None
                 else self.scatter(x, w.bounds, -1))
        parts = [x[j] @ w.block(j) for j in range(self.m)]
        return parts[0] if w.dim is None else self.sum(parts)

    def even(self, n: int) -> Optional[List[Tuple[int, int]]]:
        """``n`` split evenly over the positions, or None if it does not
        divide."""
        return even_bounds(n, self.m) if n % self.m == 0 else None


class Blocks:
    """One placed parameter leaf (of a stacked leaf, one pattern group:
    ``leaf[lead]``) as a data row's positions read it.  ``dim`` is the
    leaf's dim that its spec splits over ``model`` (None: it names no
    ``model``), ``bounds[j]`` position j's block along it.  ``block(j)``
    reads position j's block onto its device across the other axes (the
    FSDP all-gather, ``Sharded.gather_box``), once; a leaf that names no
    ``model`` is read whole (each position its own copy, as SPMD
    replicates it).  Indexing by an integer takes one group of a
    stacked leaf: its own read, unless the spec splits the stacked dim
    (``zero1_spec`` may put ``data`` there), where a group lies on one
    data row and its reads would be local for some groups and not for
    others: then position j reads its block of every group once (what a
    scan over a split dim gathers) and each group is a slice of it.  No
    method reads a ``model``-split leaf whole on one position but
    ``whole_at``, for the expert-parallel router."""

    def __init__(self, leaf: Sharded, split: RowSplit, lead=(),
                 parent: Optional["Blocks"] = None):
        self.leaf, self.split, self.lead = leaf, split, tuple(lead)
        self.parent = parent
        parts = leaf.sharding._parts(leaf.ndim)
        dims = [i for i, p in enumerate(parts) if "model" in axes_of(p)]
        if len(dims) > 1 or (dims and dims[0] < len(self.lead)):
            raise ValueError(f"spec {leaf.sharding.spec} splits the "
                             "stacked dims or two dims over model")
        self.shape = tuple(leaf.shape[len(self.lead):])
        self.dim = dims[0] - len(self.lead) if dims else None
        self.bounds = None
        if self.dim is not None:
            axes = axes_of(parts[dims[0]])
            if axes[0] != "model":
                raise ValueError(f"spec {leaf.sharding.spec}: model is not "
                                 "the outermost axis of its dim")
            self.bounds = even_bounds(self.shape[self.dim], split.m)
        self._got: Dict[int, torch.Tensor] = {}

    def __getitem__(self, r: int) -> "Blocks":
        stacked = self.leaf.sharding._parts(self.leaf.ndim)[len(self.lead)]
        return Blocks(self.leaf, self.split, self.lead + (r,),
                      self if stacked is not None else None)

    def again(self) -> "Blocks":
        """The same view with nothing read yet."""
        return Blocks(self.leaf, self.split, self.lead, self.parent)

    def _read(self, box, j: int) -> torch.Tensor:
        lead = tuple(slice(r, r + 1) for r in self.lead)
        got = self.leaf.gather_box(lead + tuple(box), self.split.devices[j])
        return got[(0,) * len(lead)] if lead else got

    def block(self, j: int) -> torch.Tensor:
        if self.parent is not None:
            return self.parent.block(j)[self.lead[-1]]
        got = self._got.get(j)
        if got is None:
            box = [slice(0, n) for n in self.shape]
            if self.dim is not None:
                box[self.dim] = slice(*self.bounds[j])
            got = self._got[j] = self._read(box, j)
        return got

    def home(self) -> torch.Tensor:
        """A leaf that names no ``model``, whole on the row's home."""
        if self.dim is not None:
            raise ValueError(f"a leaf split over model (spec "
                             f"{self.leaf.sharding.spec}) has no home copy: "
                             "read its blocks")
        return self.block(0)

    def whole_at(self, j: int) -> torch.Tensor:
        """The whole leaf on position j: only the expert-parallel router,
        which the reference's ``shard_map`` takes replicated."""
        if self.parent is not None:
            return self.parent.whole_at(j)[self.lead[-1]]
        return self._read([slice(0, n) for n in self.shape], j)


def row_split(w) -> Optional[RowSplit]:
    """The row split a ``Blocks`` leaf belongs to (None for a tensor)."""
    return w.split if isinstance(w, Blocks) else None


def home(w):
    """A tensor as is; a ``Blocks`` leaf that names no ``model``, whole on
    its row's home."""
    return w.home() if isinstance(w, Blocks) else w


__all__ = ["RULES_2D", "RULES_3D", "sp_rules", "P", "Mesh", "make_mesh",
           "abstract_mesh", "NamedSharding", "Layout", "Sharded", "use_mesh",
           "current_mesh", "current_rules", "spec", "shard",
           "shard_activation_sp", "device_put", "gather", "place", "psum",
           "pmax", "pmean", "all_gather", "reduce_scatter", "rows", "Row",
           "row_scope", "current_row", "batch_axes", "tree_map2",
           "tree_map_with_path", "held_bytes", "axes_of", "full_box",
           "zeros", "link_kind", "current_link_kind", "RowSplit",
           "Blocks", "row_split", "home", "even_bounds"]

