"""Optimizers of the port's training step (the JAX package's
``optim``): AdamW with float32 moments, AdamW with 8-bit block moments,
the cosine learning-rate schedule, and the int8 error-feedback
reduction over a mesh axis (``compress``)."""

from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.adamw8 import AdamW8State, adamw8_init, adamw8_update
from repro_torch.optim.compress import (CompressState, compress_init,
                                        compressed_psum)
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["AdamWState", "adamw_init", "adamw_update", "AdamW8State",
           "adamw8_init", "adamw8_update", "cosine_schedule",
           "CompressState", "compress_init", "compressed_psum"]
