"""gemma-2b [dense] — GeGLU, head_dim=256, MQA [arXiv:2403.08295; hf].

Assigned: 18L d_model=2048 8H (GQA kv=1 — MQA) d_ff=16384 vocab=256000.
Gemma scales embeddings by sqrt(d_model) and ties the unembedding.
Full attention => long_500k skipped.
"""

from repro_torch.models.arch_config import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=256_000,
    act="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    embed_scale=True,
    layer_pattern="G",
    skip_shapes=("long_500k",),
)
