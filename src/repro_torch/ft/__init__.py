"""Fault tolerance of the port's mesh queue: failure detection, fault
injection, straggler mitigation and the elastic serving loop (the JAX
package's ``ft``, without the trainer)."""

from repro_torch.ft.heartbeat import FailureDetector, HeartbeatTable
from repro_torch.ft.inject import (FaultEvent, FaultInjector, FaultSchedule,
                                   SimClock, lane_weights, parse_chaos)
from repro_torch.ft.straggler import CostEma, StragglerQueue, WorkItem
from repro_torch.ft.elastic import ElasticDistQueue

__all__ = ["FailureDetector", "HeartbeatTable", "SimClock", "FaultEvent",
           "FaultSchedule", "FaultInjector", "parse_chaos", "lane_weights",
           "CostEma", "StragglerQueue", "WorkItem", "ElasticDistQueue"]
