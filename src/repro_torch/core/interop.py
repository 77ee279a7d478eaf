"""Hand the same queue to the JAX package and to the port.

A state crosses as its flat list of numpy leaves, in the order of
``jax.tree.leaves`` on the reference's ``PQState`` (the fields in order,
then the 15 stats counters).  A sharded state crosses the same way,
as every leaf of the reference's ``ShardedState`` but ``rng`` (the
packages' router generators differ; the port's is seeded afresh).  The
baselines' ``FCState`` and ``ParState`` cross as all their leaves, in
field order.
Nothing here imports JAX: the caller takes ``np.asarray`` of each
reference leaf.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core import pqueue
from repro_torch.core import sharded as shq
from repro_torch.core.baselines import FCPQ, FCState, ParallelPQ, ParState
from repro_torch.core.config import PQConfig

_N_FIELDS = len(pqueue.PQState._fields) - 1   # every field but stats
_N_STATS = len(pqueue.PQStats._fields)


def state_from_numpy(cfg: PQConfig, leaves: Sequence[np.ndarray],
                     device="cuda") -> pqueue.PQState:
    """The port's PQState from the reference's numpy leaves."""
    leaves = list(leaves)
    if len(leaves) != _N_FIELDS + _N_STATS:
        raise ValueError(f"expected {_N_FIELDS + _N_STATS} leaves, got "
                         f"{len(leaves)}")
    return _fill(pqueue.init(cfg, "cpu"), leaves, device)


def _fill(want, leaves, device):
    """``want``'s tree with its leaves replaced by ``leaves`` (numpy),
    checked leaf by leaf for shape and dtype."""
    tensors = []
    for n, (x, ref) in enumerate(zip(leaves, pqueue.tree_leaves(want))):
        x = np.asarray(x)
        if x.shape != tuple(ref.shape) or x.dtype != np.dtype(
                str(ref.dtype).replace("torch.", "")):
            raise ValueError(f"leaf {n}: got {x.dtype} {x.shape}, expected "
                             f"{ref.dtype} {tuple(ref.shape)}")
        tensors.append(torch.from_numpy(x.copy()).to(device))
    it = iter(tensors)
    return pqueue.tree_map(lambda _: next(it), want)


def state_to_numpy(state) -> List[np.ndarray]:
    """The state's leaves as numpy arrays, in the reference's order (a
    ``PQState``, ``FCState`` or ``ParState``)."""
    return [x.detach().cpu().numpy() for x in pqueue.tree_leaves(state)]


def _sharded_leaves(state: shq.ShardedState):
    """Every leaf but ``rng``, in the reference's order."""
    return [x for name in shq.ShardedState._fields if name != "rng"
            for x in pqueue.tree_leaves(getattr(state, name))]


def sharded_state_from_numpy(cfg: shq.ShardedPQConfig,
                             leaves: Sequence[np.ndarray], device="cuda",
                             *, seed: int = 0) -> shq.ShardedState:
    """The port's ShardedState from the reference's numpy leaves without
    ``rng``; the router's generator starts from ``seed``."""
    want = shq.init(cfg, seed=seed, device="cpu")
    leaves = list(leaves)
    n = len(_sharded_leaves(want))
    if len(leaves) != n:
        raise ValueError(f"expected {n} leaves, got {len(leaves)}")
    got = _fill(want._replace(rng=()), leaves, device)
    return got._replace(rng=want.rng.to(device))


def sharded_state_to_numpy(state: shq.ShardedState) -> List[np.ndarray]:
    """The state's leaves but ``rng`` as numpy arrays, in the reference's
    order."""
    return [x.detach().cpu().numpy() for x in _sharded_leaves(state)]


def _baseline_from_numpy(want, leaves, device):
    leaves = list(leaves)
    n = len(pqueue.tree_leaves(want))
    if len(leaves) != n:
        raise ValueError(f"expected {n} leaves, got {len(leaves)}")
    return _fill(want, leaves, device)


def fc_state_from_numpy(cfg: PQConfig, leaves: Sequence[np.ndarray],
                        device="cuda") -> FCState:
    """The port's FCState (flat-combining baseline) from the reference's
    numpy leaves."""
    return _baseline_from_numpy(FCPQ.init(cfg, "cpu"), leaves, device)


def par_state_from_numpy(cfg: PQConfig, leaves: Sequence[np.ndarray],
                         device="cuda") -> ParState:
    """The port's ParState (parallel baseline) from the reference's numpy
    leaves."""
    return _baseline_from_numpy(ParallelPQ.init(cfg, "cpu"), leaves, device)
