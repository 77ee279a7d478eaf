"""Relaxation-quality observability (PyTorch port of the JAX package's
``quality``).

``harness`` measures what the c-relaxed contract only bounds — the
rank-error and staleness distributions of any port engine's served
stream, replayed against the exact reference; ``tuner`` spends the
measurement, widening the lane count until a rank-error budget binds.
The analytic (envelope) inversion of the same budget is
:func:`repro_torch.core.factory.lanes_within_budget`.
"""

from repro_torch.quality.harness import (  # noqa: F401
    RankErrorMeter, SUMMARY_KEYS, measure_engine, replay)
from repro_torch.quality.tuner import (  # noqa: F401
    TuneResult, probe_stream, tune_lanes, warm_keys)
