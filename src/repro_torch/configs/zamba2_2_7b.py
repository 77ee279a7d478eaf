"""zamba2-2.7b [hybrid] — Mamba2 + shared attention blocks [arXiv:2411.15242; hf].

Assigned: 54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000,
ssm_state=64.

Pattern "MMMMMA" × 9: five Mamba2 (SSD) blocks then one *shared* attention
block (one attention weight set reused by all nine occurrences — the
zamba2 shared-block design; the per-occurrence LoRA deltas of the real
model are omitted, noted in DESIGN.md).  The shared attention uses a 4096
sliding window so the hybrid stays sub-quadratic at long context =>
long_500k RUNS for this arch.
"""

from repro_torch.models.arch_config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab=32000,
    act="swiglu",
    norm="rmsnorm",
    layer_pattern="MMMMMA",
    window=4096,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    tie_embeddings=True,
)
