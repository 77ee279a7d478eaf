"""Fault tolerance of the port: failure detection, fault injection,
straggler mitigation, the elastic serving loop of the mesh queue and the
checkpoint/restart trainer (the JAX package's ``ft``)."""

from repro_torch.ft.heartbeat import FailureDetector, HeartbeatTable
from repro_torch.ft.inject import (FaultEvent, FaultInjector, FaultSchedule,
                                   SimClock, lane_weights, parse_chaos)
from repro_torch.ft.straggler import CostEma, StragglerQueue, WorkItem
from repro_torch.ft.elastic import ElasticDistQueue, ElasticTrainer

__all__ = ["FailureDetector", "HeartbeatTable", "SimClock", "FaultEvent",
           "FaultSchedule", "FaultInjector", "parse_chaos", "lane_weights",
           "CostEma", "StragglerQueue", "WorkItem", "ElasticDistQueue",
           "ElasticTrainer"]
