"""whisper-tiny [audio] — enc-dec, conv frontend stub [arXiv:2212.04356].

Assigned: 4L d_model=384 6H (GQA kv=6) d_ff=1536 vocab=51865.
Encoder-decoder: 4 encoder layers over stub frame embeddings
([B, 1500, 384] supplied by ``input_specs()`` — the log-mel conv frontend
is stubbed per the assignment), 4 decoder layers with cross-attention.
Deviations (DESIGN.md): RoPE replaces learned absolute positions so the
assigned 32k decode shapes are well-defined beyond Whisper's 448-token
decoder context.  Full attention => long_500k skipped.
"""

from repro_torch.models.arch_config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab=51_865,
    act="gelu",
    norm="layernorm",
    tie_embeddings=True,
    layer_pattern="G",
    enc_dec=True,
    n_enc_layers=4,
    enc_seq=1500,
    frontend="audio",
    skip_shapes=("long_500k",),
)
