"""Data side of the port: the synthetic token stream and the
loss-prioritized sampler on the pqe queue."""

from repro_torch.data.synthetic import SyntheticLM, make_batch
from repro_torch.data.priority_sampler import PrioritySampler

__all__ = ["SyntheticLM", "make_batch", "PrioritySampler"]
