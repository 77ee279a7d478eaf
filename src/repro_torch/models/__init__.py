"""The model zoo's configuration (``arch_config.ArchConfig``); the model
code itself is not ported yet."""
