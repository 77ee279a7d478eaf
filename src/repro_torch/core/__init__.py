"""The combined queue in PyTorch (port of the JAX package's core).

Public API:
    PQConfig, PQState, init, tick        — the elimination+combining queue
    FCPQ, ParallelPQ                     — the paper's baselines (§4)
    RefPQ                                — sequential specification (oracle)
    eliminate_batch                      — standalone elimination pass
    sharded                              — the L-lane relaxed queue
    EngineSpec, make_engine, QueueEngine — the engine factory (pqe |
                                           sharded | adaptive | the
                                           baselines)
    ControllerConfig, AdaptiveEngine     — the workload controller that
                                           picks the engine at runtime
    state_from_numpy, state_to_numpy     — hand a state across packages
"""

from repro_torch.core.config import EMPTY_VAL, PQConfig, PRODUCTION, SMALL
from repro_torch.core.pqueue import (PQState, PQStats, TickResult, add_batch,
                                     init, peek_min, remove_batch, size, tick,
                                     tick_n)
from repro_torch.core.baselines import FCPQ, ParallelPQ, merge_sorted
from repro_torch.core.elimination import ElimResult, eliminate_batch
from repro_torch.core.adaptive import (AdaptiveEngine, ControllerConfig,
                                       update_detach)
from repro_torch.core.factory import EngineSpec, QueueEngine, make_engine
from repro_torch.core.interop import state_from_numpy, state_to_numpy
from repro_torch.core.ref_pq import RefPQ
from repro_torch.core import sharded

__all__ = [
    "EMPTY_VAL", "PQConfig", "PRODUCTION", "SMALL",
    "PQState", "PQStats", "TickResult", "add_batch", "init", "peek_min",
    "remove_batch", "size", "tick", "tick_n",
    "FCPQ", "ParallelPQ", "merge_sorted",
    "ElimResult", "eliminate_batch", "update_detach", "RefPQ",
    "AdaptiveEngine", "ControllerConfig",
    "EngineSpec", "QueueEngine", "make_engine",
    "state_from_numpy", "state_to_numpy", "sharded",
]
