"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B
family scaled; assigned constants below].

Assigned: 94L d_model=4096 64H (GQA kv=4) d_ff=1536 vocab=151936,
MoE 128e top-8.  d_ff is the *per-expert* FFN width.  Experts shard over
the `model` mesh axis (expert parallelism).  Qwen3's QK-norm is omitted
(noted in DESIGN.md).  Full attention => long_500k skipped.
"""

from repro_torch.models.arch_config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab=151_936,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    layer_pattern="G",
    n_experts=128,
    top_k=8,
    d_expert=1536,
    skip_shapes=("long_500k",),
)
