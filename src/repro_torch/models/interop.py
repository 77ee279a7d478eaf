"""Hand the JAX package's model parameters, decode caches and training
states to the port and back.

Input is a numpy tree of the reference's ``init_params``,
``init_decode_caches`` / ``prefill`` output or ``TrainState`` (dicts by
key, NamedTuples and tuples by position), taken leaf by leaf with
``np.asarray``.  Every
leaf's path, shape and dtype is checked against the port's own tree for
the same config.  A bfloat16 leaf arrives as its ``np.uint16`` bit view
(``ml_dtypes.bfloat16`` is readable by neither torch nor a machine
without JAX) and is read back with ``.view(torch.bfloat16)``;
``to_numpy`` gives bfloat16 leaves back as the same view.  Nothing here
imports JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.dist.sharding import Sharded, place, tree_map2
from repro_torch.models import transformer as tf
from repro_torch.models.arch_config import ArchConfig


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty((), dtype=dtype).numpy().dtype


def _from_numpy(want, got, device, path: str):
    """``want``'s tree (meta tensors) filled from ``got`` (numpy)."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            keys = sorted(got) if isinstance(got, dict) else type(got)
            raise ValueError(f"{path or 'tree'}: keys {keys}, expected "
                             f"{sorted(want)}")
        return {k: _from_numpy(w, got[k], device, f"{path}.{k}".lstrip("."))
                for k, w in want.items()}
    if isinstance(want, tuple):
        if not isinstance(got, (tuple, list)) or len(got) != len(want):
            raise ValueError(f"{path}: expected {len(want)} fields")
        vals = [_from_numpy(w, g, device, f"{path}[{i}]")
                for i, (w, g) in enumerate(zip(want, got))]
        return type(want)(*vals) if hasattr(want, "_fields") else tuple(vals)
    got = np.asarray(got)
    dt = _np_dtype(want.dtype)
    if got.shape != tuple(want.shape) or got.dtype != dt:
        raise ValueError(f"{path}: got {got.dtype} {got.shape}, expected "
                         f"{dt} {tuple(want.shape)} ({want.dtype})")
    t = torch.from_numpy(np.array(got))
    if want.dtype == torch.bfloat16:
        t = t.view(torch.int16).view(torch.bfloat16)
    return t.to(device)


def params_from_numpy(cfg: ArchConfig, tree, device="cuda"):
    """The port's parameter tree from the reference's, checked leaf by
    leaf against ``init_params(cfg, ...)``'s."""
    want = tf.init_params(cfg, None, device="meta")
    return _from_numpy(want, tree, device, "")


def caches_from_numpy(cfg: ArchConfig, tree, batch: int, s_max: int,
                      device="cuda"):
    """The port's decode caches from the reference's, checked against
    ``init_decode_caches(cfg, batch, s_max)`` (plus the cross K/V
    ``"xkv"`` of an enc-dec arch after prefill, where ``tree`` has it)."""
    want = tf.init_decode_caches(cfg, batch, s_max, device="meta")
    if cfg.enc_dec and "xkv" in tree:
        shape = (cfg.pattern_reps, batch, cfg.enc_seq, cfg.n_kv_heads,
                 cfg.head_dim)
        x = torch.empty(shape, dtype=tf._dtype(cfg), device="meta")
        want["xkv"] = (x, x)
    return _from_numpy(want, tree, device, "")


def to_numpy(tree) -> Any:
    """A copy of a tree of the port's tensors as numpy, bfloat16 leaves as
    their ``np.uint16`` bit view (a copy: the port writes caches in
    place).  A placed leaf (``dist.Sharded``) is gathered first."""
    def leaf(t):
        if isinstance(t, Sharded):
            t = t.read(device="cpu")
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy()
        return t.numpy().copy()
    return tf.tree_map(leaf, tree)


def train_state_from_numpy(cfg: ArchConfig, tree, tcfg=None, device="cuda"):
    """The port's ``TrainState`` from the reference's: the parameters and
    the optimizer state of ``tcfg`` (AdamW: ``step`` int32, float32
    ``mu`` / ``nu``; under ``opt_8bit`` AdamW8: int8 ``q_mu``, uint8
    ``q_nu``, float32 ``s_mu`` / ``s_nu``), checked leaf by leaf against
    ``init_train_state(cfg, ..., tcfg)``'s."""
    from repro_torch.launch.train import init_train_state
    want = init_train_state(cfg, None, tcfg, device="meta")
    return _from_numpy(want, tree, device, "")


def placed_from_numpy(tree, shardings):
    """A numpy tree (bfloat16 leaves as their ``np.uint16`` view, as the
    functions above take them) placed on a mesh leaf by leaf by the
    port's tree of ``NamedSharding`` (whose structure the result takes):
    each position gets only its block.  Check the leaves' paths and
    shapes with one of the ``*_from_numpy`` functions where they may
    differ."""
    def one(sh, x):
        x = np.asarray(x)
        t = torch.from_numpy(np.array(x))
        if x.dtype == np.uint16:
            t = t.view(torch.int16).view(torch.bfloat16)
        return place(t, sh)
    return tree_map2(one, shardings, tree)
