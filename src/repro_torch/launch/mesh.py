"""Mesh construction (port of the JAX package's ``launch/mesh.py``).

Functions, not module constants: importing this module touches no
device.  The production meshes are the reference's TPU topologies,
16 x 16 (``data``, ``model``) and 2 x 16 x 16 (``pod``, ``data``,
``model``); they come back abstract (shape and axis names, no devices),
which is what the spec functions and the dry run's tracing need.
"""

from __future__ import annotations

import torch

from repro_torch.dist.sharding import Mesh, abstract_mesh, make_mesh


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
