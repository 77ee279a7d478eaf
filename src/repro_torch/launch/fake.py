"""Fake devices for the dry run: tensors that carry a shape, a dtype and
a device name (``cpu:k`` or ``meta:k``, one a mesh position) and no
data.

``FakeDevices`` is a ``TorchDispatchMode`` under which every tensor made
is a ``FakeTensor`` of this module: a wrapper that reports its fake
device and holds a ``meta`` tensor of the same shape, strides and
storage, on which each aten op runs (the meta kernels compute shapes
only).  A result lies on the device the op names (a factory's or a
copy's ``device=``), else on its tensor operands' device; operands on
two different devices raise, as they would on the cards.  A 0-dim tensor
on a device without an index mixes with any device, as a CPU scalar does
in torch: a constant (``torch.tensor(v, device=d)`` is made on the plain
``cpu`` or ``meta`` device, whatever ``d`` names, before it is seen
here).  Autograd, ``torch.utils.checkpoint`` and inference mode run
over these tensors as over any others.  An op that reads values
(``.item()``, a shape that depends on data) fails, since the meta
tensor has none.

``torch._subclasses.fake_tensor.FakeTensorMode`` gives the same shapes
and devices and serves as well (the tests trace with both); it validates
and caches far more per op: gemma-2b's ``decode_32k`` on 16 x 16 (some
265,000 ops) traced in 252 s under it and in 32 s under this mode on
the same CPU.  Fake ``cpu:k`` and ``meta:k`` devices rather than
``cuda:k``: they keep their index and copy between each other on a
CPU-only build of torch as on a CUDA one.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_META = torch.device("meta")
_CPU = torch.device("cpu")
_PRIM_DEVICE = torch.ops.prim.device.default
_COPY = torch.ops.aten.copy_.default


class FakeTensor(torch.Tensor):
    """A fake device's tensor: the device it reports and ``inner``, a
    meta tensor of its shape, strides and storage."""

    @staticmethod
    def __new__(cls, inner: torch.Tensor, device: torch.device):
        r = torch.Tensor._make_wrapper_subclass(
            cls, inner.shape, strides=inner.stride(),
            storage_offset=inner.storage_offset(), dtype=inner.dtype,
            device=device, requires_grad=False)
        r.inner = inner
        return r

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} on a fake-device tensor outside "
                           "FakeDevices")

    def __repr__(self) -> str:
        return (f"FakeTensor({tuple(self.shape)}, {self.dtype}, "
                f"{self.device})")


def storage_of(t: torch.Tensor):
    """The storage a tensor's bytes live in (a fake tensor's meta
    storage)."""
    return (t.inner if isinstance(t, FakeTensor) else t).untyped_storage()


class FakeDevices(TorchDispatchMode):
    """Every tensor made under it is a ``FakeTensor`` (module
    docstring)."""

    def __init__(self):
        super().__init__()
        self.counter = None          # a roofline.trace_stats.TraceStats
        self._returns_self = {}
        self._mutable = {}
        self._shapes = {}
        self._noop = set()

    def _inplace(self, func) -> bool:
        r = self._returns_self.get(func)
        if r is None:
            rets = func._schema.returns
            r = (len(rets) == 1 and rets[0].alias_info is not None
                 and rets[0].alias_info.is_write)
            self._returns_self[func] = r
        return r

    def _cacheable(self, func) -> bool:
        m = self._mutable.get(func)
        if m is None:
            m = not (func.is_view or func._schema.is_mutable)
            self._mutable[func] = m
        return m

    def _run(self, func, a, k):
        """``func`` on meta tensors.  A meta kernel computes shapes in
        Python for most ops (0.2-1.5 ms a pointwise op), so the result's
        shape, strides and dtype are kept per (op, operands' shapes,
        strides and dtypes, other arguments) and made again by
        ``empty_strided``, for ops that neither view nor write their
        operands and whose first run made fresh storage.  An op that
        writes its first operand in place and returns it (``add_``,
        ``copy_``) is run once per such key: where that run left the
        operand's shape, strides and storage as they were, a later call
        with the same key returns the operand as it is (a meta kernel
        only checks shapes)."""
        if not self._cacheable(func):
            if not (self._inplace(func) and not func.is_view):
                return func(*a, **k)
            try:
                key = (func, _key(a), _key(tuple(k.items())))
                if key in self._noop:
                    return a[0]
            except TypeError:
                return func(*a, **k)
            t = a[0]
            before = (t.shape, t.stride(), t.storage_offset(),
                      t.untyped_storage().nbytes())
            out = func(*a, **k)
            if out is t and before == (t.shape, t.stride(),
                                       t.storage_offset(),
                                       t.untyped_storage().nbytes()):
                self._noop.add(key)
            return out
        try:
            key = (func, _key(a), _key(tuple(k.items())))
            spec = self._shapes.get(key)
        except TypeError:          # an argument that does not hash
            return func(*a, **k)
        if spec is not None:
            made = [torch.empty_strided(sh, st, dtype=dt, device=_META)
                    for sh, st, dt in spec[1]]
            return made if spec[0] is list else (
                tuple(made) if spec[0] is tuple else made[0])
        out = func(*a, **k)
        outs = out if isinstance(out, (list, tuple)) else (out,)
        if all(isinstance(o, torch.Tensor) for o in outs):
            ins = {t.untyped_storage()._cdata for t in _flat(a + [k])}
            if not any(o.untyped_storage()._cdata in ins for o in outs):
                self._shapes[key] = (type(out) if isinstance(
                    out, (list, tuple)) else None, [
                    (tuple(o.shape), o.stride(), o.dtype) for o in outs])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is _PRIM_DEVICE:
            return args[0].device
        kwargs = kwargs or {}
        counter = self.counter
        if counter is None:
            return self._fake(func, args, kwargs)
        info = counter._info(func)
        if info[1]:         # counted by what it decomposes to (TraceStats)
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = self._fake(func, args, kwargs)
        if not (info[0] or info[2]):
            counter.observe(info, func, args, kwargs, out)
        elif info[2]:
            counter.view(out)
        return out

    def _fake(self, func, args, kwargs):
        where = [None, True]        # the result's device; seen only scalars

        def un(x):
            if isinstance(x, (list, tuple)):
                return type(x)(un(y) for y in x)
            if not isinstance(x, torch.Tensor):
                return x
            fake = isinstance(x, FakeTensor)
            inner = x.inner if fake else torch.empty_strided(
                x.shape, x.stride(), dtype=x.dtype, device=_META)
            d = x.device
            if d.index is None and inner.dim() == 0:     # a scalar mixes
                if where[0] is None:
                    where[0] = d
            elif where[1]:
                where[0], where[1] = d, False
            elif d != where[0]:
                raise RuntimeError(f"{func}: operands on {where[0]} and {d}")
            return inner

        if func is _COPY:          # copy_(dst, src) may cross devices
            a = [args[0].inner, un(args[1]), *args[2:]]
            where[0] = args[0].device
        else:
            a = [un(x) for x in args]
        if kwargs.get("device") is not None:
            where[0] = torch.device(kwargs["device"])
            kwargs = {**kwargs, "device": _META}
        k = {n: un(v) for n, v in kwargs.items()}
        out = self._run(func, a, k)
        dev = _CPU if where[0] is None else where[0]
        if self._inplace(func) and isinstance(args[0], FakeTensor) \
                and not func.is_view:
            return args[0]
        if not isinstance(out, (torch.Tensor, list, tuple)):
            return out
        # results are made as normal tensors even under inference mode:
        # a view of a normal tensor must take its base's version counter
        with torch._C._InferenceMode(False):
            if isinstance(out, torch.Tensor):
                return FakeTensor(out, dev)
            return type(out)(FakeTensor(o, dev)
                             if isinstance(o, torch.Tensor) else o
                             for o in out)


def _key(x):
    """A hashable stand-in for meta operands: a tensor by its shape,
    strides and dtype."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_key(y) for y in x)
    hash(x)
    return (type(x), x)


def _flat(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _flat(x)
        elif isinstance(x, dict):
            yield from _flat(list(x.values()))


__all__ = ["FakeDevices", "FakeTensor", "storage_of"]
