"""gemma2-27b [dense] — local+global alternating, logit softcap
[arXiv:2408.00118; hf].

Assigned: 46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.
Pattern "LG": sliding-window(4096) and global layers alternate; attention
logits soft-capped at 50, final logits at 30; embeddings scaled by sqrt(d).
Full attention (global layers) => long_500k skipped.
"""

from repro_torch.models.arch_config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab=256_000,
    act="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    embed_scale=True,
    layer_pattern="LG",
    window=4096,
    logit_softcap=50.0,
    final_softcap=30.0,
    skip_shapes=("long_500k",),
)
