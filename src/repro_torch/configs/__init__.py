"""Assigned-architecture configs (exact constants from the assignment) and
the registry used by ``--arch <id>`` everywhere (launcher, dry-run, tests).
"""

from repro_torch.configs.registry import ALL_ARCHS, get_config, reduced_config

__all__ = ["ALL_ARCHS", "get_config", "reduced_config"]
