"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64e top-6
[hf:moonshotai/Moonlight-16B-A3B].

Assigned: 48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840,
MoE 64e top-6.  d_ff is the per-expert width.  Moonlight's first dense
layer + shared expert are simplified to a uniform MoE stack (DESIGN.md).
Full attention => long_500k skipped.
"""

from repro_torch.models.arch_config import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=163_840,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=50_000.0,
    tie_embeddings=False,
    layer_pattern="G",
    n_experts=64,
    top_k=6,
    d_expert=1408,
    skip_shapes=("long_500k",),
)
