"""Test configuration.

IMPORTANT: do NOT set --xla_force_host_platform_device_count here — smoke
tests and benches must see 1 device (the dry-run sets 512 itself, in a
subprocess).  Multi-device tests spawn subprocesses with their own flags.

The container may not ship `hypothesis`; when absent we install the
deterministic fallback shim from tests/_hypothesis_fallback.py so the
property tests still run (seeded random examples, no shrinking).
"""

import os
import sys

try:
    import hypothesis
except ImportError:  # gated fallback — no new dependencies allowed
    sys.path.insert(0, os.path.dirname(__file__))
    import _hypothesis_fallback as hypothesis

    sys.modules["hypothesis"] = hypothesis
    sys.modules["hypothesis.strategies"] = hypothesis  # from ... import st
    hypothesis.strategies = hypothesis

hypothesis.settings.register_profile(
    "repro", deadline=None, max_examples=25,
    suppress_health_check=[hypothesis.HealthCheck.too_slow,
                           hypothesis.HealthCheck.data_too_large])
hypothesis.settings.load_profile("repro")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (CUDA); skips where there is none")
