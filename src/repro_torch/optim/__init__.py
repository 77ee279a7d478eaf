"""Optimizers of the port's training step (the JAX package's ``optim``
on one device): AdamW with float32 moments, AdamW with 8-bit block
moments, and the cosine learning-rate schedule.  The reference's
``optim/compress.py`` reduces over a mesh axis and waits for the mesh
slice of the model stack (ROADMAP queue 1, item 3)."""

from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.adamw8 import AdamW8State, adamw8_init, adamw8_update
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["AdamWState", "adamw_init", "adamw_update", "AdamW8State",
           "adamw8_init", "adamw8_update", "cosine_schedule"]
