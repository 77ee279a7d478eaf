"""mistral-nemo-12b [dense] — 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407].

Assigned: 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
head_dim=128 (q_dim 4096 != d_model — Nemo's narrow heads), rope base 1M
for the advertised 128k context.  Full attention => long_500k skipped.
"""

from repro_torch.models.arch_config import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131_072,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    layer_pattern="G",
    skip_shapes=("long_500k",),
)
