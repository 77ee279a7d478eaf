"""The roofline of the port on one NVIDIA H100: the card's peaks (``hw``),
the roofline terms and ``model_flops`` (``analysis``), the bytes each
queue kernel launch and engine tick must move (``traffic``), the record
that folds a measured time against them (``measure``), the per-device
counter of a traced step (``trace_stats``) and the dry run's table
(``report``)."""

from repro_torch.roofline.analysis import Roofline, model_flops
from repro_torch.roofline.measure import record_from_traffic
from repro_torch.roofline.traffic import Traffic

__all__ = ["Roofline", "model_flops", "record_from_traffic", "Traffic"]
