"""Hand the same queue to the JAX package and to the port.

A state crosses as its flat list of numpy leaves, in the order of
``jax.tree.leaves`` on the reference's ``PQState`` (the fields in order,
then the 15 stats counters).  Nothing here imports JAX: the caller takes
``np.asarray`` of each reference leaf.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core import pqueue
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
    want = pqueue.init(cfg, "cpu")
    tensors = []
    for n, (x, ref) in enumerate(zip(leaves, pqueue.tree_leaves(want))):
        x = np.asarray(x)
        if x.shape != tuple(ref.shape) or x.dtype != np.dtype(
                str(ref.dtype).replace("torch.", "")):
            raise ValueError(f"leaf {n}: got {x.dtype} {x.shape}, expected "
                             f"{ref.dtype} {tuple(ref.shape)}")
        tensors.append(torch.from_numpy(x.copy()).to(device))
    return pqueue.PQState(*tensors[:_N_FIELDS],
                          stats=pqueue.PQStats(*tensors[_N_FIELDS:]))


def state_to_numpy(state: pqueue.PQState) -> List[np.ndarray]:
    """The state's leaves as numpy arrays, in the reference's order."""
    return [x.detach().cpu().numpy() for x in pqueue.tree_leaves(state)]
