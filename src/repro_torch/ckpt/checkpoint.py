"""Integrity-checked checkpoints of a tree of tensors (port of the JAX
package's ``ckpt/checkpoint.py`` on one device).

The on-disk format is the reference's, so that each package reads the
other's checkpoints:

* ``step_<8 digits>/host_0.npz`` holds every leaf, and
  ``manifest.json`` the step, each leaf's shape, dtype, stored form and
  CRC32, and the caller's ``extra``;
* a leaf's key is its path joined by ``::`` as ``jax.tree_util`` prints
  it: a dict key as itself, a NamedTuple field as ``.name``, a tuple
  position as its index (a ``TrainState`` gives ``.params::embed`` and
  ``.opt::.mu::embed``);
* a bfloat16 leaf is stored as its ``uint16`` bit view, tagged
  ``"bfloat16:u16"``, and read back through ``int16`` with
  ``.view(torch.bfloat16)`` (no ``ml_dtypes``).

Writes go to ``<dir>.tmp`` and are renamed, so a crash mid-save never
corrupts the newest complete checkpoint.  ``CheckpointManager`` keeps
the newest K and saves on a thread, after copying every leaf to the
host: the port's optimizers update their tensors in place.  A placed
leaf (``dist.Sharded``) is gathered once, from one holder of each
block, so a checkpoint does not depend on the mesh that wrote it.  On
restore ``shardings=`` (a tree of ``NamedSharding``, as the reference
takes) places every leaf on a mesh, which may differ from the one that
saved; else ``device=`` places every leaf on one device.
"""

from __future__ import annotations

import json
import shutil
import threading
import zlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.dist.sharding import Sharded, place
from repro_torch.models.transformer import tree_map

_SEP = "::"


def _map_keys(fn, tree, path=()):
    """``tree`` with each leaf replaced by ``fn(key, leaf)``, ``key`` the
    reference's: the path joined by ``::``, a dict key as itself, a
    NamedTuple field as ``.name``, a tuple position as its index."""
    if isinstance(tree, dict):
        return {k: _map_keys(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        names = ([f".{f}" for f in tree._fields] if hasattr(tree, "_fields")
                 else [str(i) for i in range(len(tree))])
        vals = [_map_keys(fn, v, path + (n,)) for n, v in zip(names, tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(_SEP.join(path), tree)


def _flatten(tree) -> dict:
    out = {}
    _map_keys(out.__setitem__, tree)
    return out


def _crc32(arr: np.ndarray) -> int:
    """CRC32 of the array's bytes in C order (read in place)."""
    return zlib.crc32(memoryview(np.ascontiguousarray(arr)).cast("B")) \
        & 0xFFFFFFFF


def _host(leaf) -> np.ndarray:
    """A leaf as numpy, a bfloat16 tensor as its uint16 view (tagged by
    the caller)."""
    if isinstance(leaf, Sharded):
        leaf = leaf.read()           # whole on its mesh's first device
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str | Path, step: int, tree,
                    extra: Optional[dict] = None) -> Path:
    """Write checkpoint atomically. Returns the final directory."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    arrays = {}
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for key, leaf in _flatten(tree).items():
        arr = _host(leaf)
        bf16 = isinstance(leaf, (torch.Tensor, Sharded)) and \
            leaf.dtype == torch.bfloat16
        arrays[key] = arr
        manifest["leaves"][key] = {
            "shape": list(arr.shape),
            "dtype": "bfloat16" if bf16 else str(arr.dtype),
            "stored": "bfloat16:u16" if bf16 else str(arr.dtype),
            "crc32": _crc32(arr),
        }
    np.savez(tmp / "host_0.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def _steps(ckpt_dir: Path):
    return sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
                  if not p.name.endswith(".tmp"))


def restore_checkpoint(ckpt_dir: str | Path, tree_like, device=None,
                       step: Optional[int] = None, *, shardings=None):
    """Restore into the structure of ``tree_like`` (the newest step
    unless ``step`` is given).  With ``shardings`` (a tree of
    ``NamedSharding`` of that structure) each leaf is placed on its mesh,
    each position taking only its block; else each leaf goes to
    ``device``, or where ``tree_like``'s leaf lies (its mesh for a placed
    leaf, the CPU for a leaf that is no tensor).  Integrity (CRC32) is
    verified per leaf.  Returns (tree, step)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        steps = _steps(ckpt_dir)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        step = steps[-1]
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())

    def restore(key, like):
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = data[key]
        if _crc32(arr) != meta["crc32"]:
            raise IOError(f"CRC mismatch for {key!r} — corrupt checkpoint")
        if meta["stored"] == "bfloat16:u16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if key in flat_sh:
            return place(t, flat_sh[key])
        if device is None and isinstance(like, Sharded):
            return place(t, like.sharding)
        where = device if device is not None else (
            like.device if isinstance(like, torch.Tensor) else "cpu")
        return t.to(where)

    flat_sh = _flatten(shardings) if shardings is not None else {}
    with np.load(d / "host_0.npz") as data:
        return _map_keys(restore, tree_like), step


class CheckpointManager:
    """Keep-newest-K manager with async (threaded) save."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self._pending: Optional[threading.Thread] = None

    def save(self, step: int, tree, extra: Optional[dict] = None,
             blocking: bool = True) -> None:
        self.wait()
        # copy to the host BEFORE the thread starts: the optimizers
        # update the live tensors in place
        host_tree = tree_map(
            lambda x: x.read().to("cpu") if isinstance(x, Sharded)
            else x.detach().to("cpu", copy=True)
            if isinstance(x, torch.Tensor) else np.array(x), tree)

        def work():
            save_checkpoint(self.dir, step, host_tree, extra)
            self._gc()

        if blocking:
            work()
        else:
            self._pending = threading.Thread(target=work, daemon=True)
            self._pending.start()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def latest_step(self) -> Optional[int]:
        steps = _steps(self.dir)
        return steps[-1] if steps else None

    def restore(self, tree_like, device=None, step=None, *, shardings=None):
        return restore_checkpoint(self.dir, tree_like, device, step,
                                  shardings=shardings)

    def _gc(self) -> None:
        for s in _steps(self.dir)[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
