"""The request engine of the port: open-loop arrivals, admission control
and the EDF serving loop on the elastic mesh queue."""

from repro_torch.serving.arrivals import (
    ArrivalProcess, BurstyArrivals, DiurnalArrivals, PoissonArrivals, Request)
from repro_torch.serving.engine import RequestEngine
from repro_torch.serving.scheduler import (
    EXPIRED, SERVED, SHED, SHED_DEPTH, SHED_INFEASIBLE, SHED_RETRY,
    AdmissionController, OverloadPolicy, ShedEvent)
from repro_torch.serving.sla import build_engine, run_sla

__all__ = [
    "ArrivalProcess", "PoissonArrivals", "BurstyArrivals", "DiurnalArrivals",
    "Request", "RequestEngine", "AdmissionController", "OverloadPolicy",
    "ShedEvent", "SERVED", "SHED", "EXPIRED", "SHED_DEPTH",
    "SHED_INFEASIBLE", "SHED_RETRY", "build_engine", "run_sla",
]
