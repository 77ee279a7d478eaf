"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

Assigned: 24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304.
Pattern "SX" × 12 (alternating sLSTM / mLSTM, both with O(1) recurrent
decode state) => long_500k RUNS.  d_ff=0: xLSTM blocks have no separate
FFN sub-block.  sLSTM's recurrent weights force a sequential time scan in
training — kept faithful (DESIGN.md §5).
"""

from repro_torch.models.arch_config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab=50_304,
    norm="layernorm",
    tie_embeddings=True,
    layer_pattern="SX",
)
