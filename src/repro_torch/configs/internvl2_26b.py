"""internvl2-26b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

Assigned: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
The transformer BACKBONE only; the InternViT frontend is a stub —
``input_specs()`` supplies precomputed patch embeddings [B, 256, 6144]
prepended to the token stream (DESIGN.md §5).
Full attention => long_500k is skipped.
"""

from repro_torch.models.arch_config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92553,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,     # InternLM2 long-context rope base
    tie_embeddings=False,
    layer_pattern="G",
    frontend="vit",
    frontend_tokens=256,
    skip_shapes=("long_500k",),
)
