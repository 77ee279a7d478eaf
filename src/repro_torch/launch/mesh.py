"""Mesh construction (port of the JAX package's ``launch/mesh.py``), and
the fake placement that the dry run traces on.

Functions, not module constants: importing this module touches no
device.  The production meshes are the reference's TPU topologies,
16 x 16 (``data``, ``model``) and 2 x 16 x 16 (``pod``, ``data``,
``model``); they come back abstract (shape and axis names, no devices),
which is what the spec functions need.  The dry run places them on fake
devices (``fake_mesh``): a device of its own for each position
(``fake_devices``: ``cpu:k`` and ``meta:k``) under ``launch.fake``'s
mode, which allocates nothing.  Fake ``cpu`` and ``meta`` devices keep
their index and copy between each other on a CPU-only build as on a
CUDA one; a fake ``cuda:k`` tensor needs the CUDA runtime for autograd.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.dist.sharding import (Mesh, abstract_mesh, make_mesh,
                                       use_mesh, zeros)
from repro_torch.launch.fake import FakeDevices
from repro_torch.roofline.trace_stats import count


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return abstract_mesh(shape, axes)


def make_host_mesh() -> Mesh:
    """Every visible card on a single ``data`` axis."""
    n = torch.cuda.device_count()
    if n == 0:
        raise ValueError("no cuda device is visible: build a mesh with "
                         "make_mesh(shape, axes, devices=[...])")
    return make_mesh((n,), ("data",))


def fake_devices(n: int) -> List[torch.device]:
    """``n`` distinct fake devices, one a position (at most 512).

    A device index is a signed byte, so one device type names at most
    128 devices by a non-negative index: positions 0-127 are ``cpu:p``
    and 128-255 ``meta:p-128``.  Past 256 (the 2 x 16 x 16 mesh) the
    index wraps when the device is built, ``torch.device("cpu", 200)``
    being ``cpu:-56``: positions 256-509 take the wrapped indices of
    both types and the last two the plain ``meta`` and ``cpu`` (the
    index 255 wraps to none).  A 0-dim tensor on a device without an
    index mixes with any device (``launch.fake``), as constants do;
    positions 510 and 511 hold only their blocks (``model`` 14 and 15 of
    their data row), so that moves no count of theirs beyond the
    constants' few bytes."""
    if n > 512:
        raise ValueError(f"{n} positions: fake devices name at most 512")
    out = [torch.device("cpu", p) for p in range(min(n, 128))]
    out += [torch.device("meta", p) for p in range(min(n, 256) - 128)]
    for typ in ("cpu", "meta"):
        out += [torch.device(typ, 128 + j) for j in range(127)]
    out += [torch.device("meta"), torch.device("cpu")]
    return out[:n]


def fake_mesh(mesh: Mesh, devices=None) -> Mesh:
    """``mesh``'s shape and axes on ``devices`` (default: a fake device
    of its own for each position, ``fake_devices``)."""
    if devices is None:
        devices = fake_devices(mesh.size)
    return make_mesh(tuple(mesh.shape.values()), mesh.axis_names, devices)


def fake_mode():
    """The mode the dry run builds and traces under: tensors on any
    device name, no memory, no arithmetic (``launch.fake``)."""
    return FakeDevices()


@dataclasses.dataclass
class Lowered:
    """A step and its placed fake arguments, nothing traced yet (the
    counterpart of the reference's ``jax.stages.Lowered``).  ``devices``
    is each mesh position's device (one entry for a one-device step);
    ``rules`` the logical rules installed around the trace."""

    kind: str                        # "train" | "prefill" | "decode"
    step: Callable
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    mesh: Optional[Mesh]
    devices: List[torch.device]
    mode: Any
    rules: Optional[dict] = None

    def trace(self, per_op: bool = False, placed: bool = False):
        """Run the step once under ``trace_stats.TraceStats`` (``placed``:
        keeping the live bytes at each place of the loop nest); returns
        (its output, the counter)."""
        fused = self.mode if isinstance(self.mode, FakeDevices) else None
        with self.mode, (use_mesh(self.mesh, self.rules) if self.mesh
                         is not None else contextlib.nullcontext()):
            return count(self.step, *self.args, per_op=per_op, fake=fused,
                         placed=placed, **self.kwargs)


def placed(mesh: Optional[Mesh], device, shape, dtype, sharding=None):
    """A zero tensor of ``shape`` placed by ``sharding`` on ``mesh`` (a
    ``Sharded`` leaf), or whole on ``device`` without a mesh."""
    if mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    return zeros(shape, dtype, sharding)


def positions(mesh: Optional[Mesh], device) -> List[torch.device]:
    return list(mesh.devices) if mesh is not None else [torch.device(device)]
