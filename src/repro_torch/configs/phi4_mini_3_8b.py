"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2412.08905; hf].

Assigned: 32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
Full attention => long_500k skipped.
"""

from repro_torch.models.arch_config import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=200_064,
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    layer_pattern="G",
    skip_shapes=("long_500k",),
)
