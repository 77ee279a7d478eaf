"""The combined queue in PyTorch (port of the JAX package's core).

Public API:
    PQConfig, PQState, init, tick        — the elimination+combining queue
    RefPQ                                — sequential specification (oracle)
    EngineSpec, make_engine, QueueEngine — the engine factory ("pqe",
                                           "sharded")
    state_from_numpy, state_to_numpy     — hand a state across packages
    sharded                              — the L-lane relaxed queue
"""

from repro_torch.core.config import EMPTY_VAL, PQConfig, PRODUCTION, SMALL
from repro_torch.core.pqueue import (PQState, PQStats, TickResult, add_batch,
                                     init, peek_min, remove_batch, size, tick,
                                     tick_n)
from repro_torch.core.adaptive import update_detach
from repro_torch.core.factory import EngineSpec, QueueEngine, make_engine
from repro_torch.core.interop import state_from_numpy, state_to_numpy
from repro_torch.core.ref_pq import RefPQ
from repro_torch.core import sharded

__all__ = [
    "EMPTY_VAL", "PQConfig", "PRODUCTION", "SMALL",
    "PQState", "PQStats", "TickResult", "add_batch", "init", "peek_min",
    "remove_batch", "size", "tick", "tick_n",
    "update_detach", "RefPQ",
    "EngineSpec", "QueueEngine", "make_engine",
    "state_from_numpy", "state_to_numpy", "sharded",
]
