"""Architecture configuration shared by the whole model zoo (a copy of the
JAX package's ``models/arch_config.py``, which is pure Python).

One frozen dataclass describes every assigned architecture (dense / MoE /
hybrid SSM / xLSTM / encoder-decoder audio / VLM backbone).  Block kinds are
selected per layer by ``layer_pattern`` so heterogeneous stacks (gemma2
local/global alternation, zamba2 mamba+shared-attention) scan over *pattern
groups* with identical parameter shapes, keeping the lowered HLO compact.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# layer kind codes used in `layer_pattern`
#   'G' global attention   'L' local (sliding-window) attention
#   'M' mamba2 (SSD)       'S' sLSTM        'X' mLSTM
#   'A' shared attention (zamba2-style: one weight set reused)
# A pattern like "LG" means the stack repeats [local, global] n_layers/2
# times; "MMMMMA" repeats 5 mamba + 1 shared-attention group.


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | audio | vlm

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int                   # raw vocab (padded to vocab_padded)

    head_dim: Optional[int] = None       # default d_model // n_heads
    act: str = "swiglu"                  # swiglu | geglu | gelu
    norm: str = "rmsnorm"
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    embed_scale: bool = False            # gemma: scale embeddings by sqrt(d)

    # attention extras
    logit_softcap: Optional[float] = None    # gemma2: 50.0
    final_softcap: Optional[float] = None    # gemma2: 30.0
    window: Optional[int] = None             # sliding-window size for 'L'
    layer_pattern: str = "G"                 # repeated to n_layers

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0            # expert FFN width (d_ff of each expert)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM / mamba2
    ssm_state: int = 0           # N (state size per head)
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_dim: int = 4

    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 0             # encoder frames (whisper: 1500)

    # modality frontend stub: None | "vit" | "audio"
    frontend: Optional[str] = None
    frontend_tokens: int = 0     # prefix embedding tokens supplied as input

    # shapes this arch cannot run (full-attention 500k etc.) — see DESIGN.md
    skip_shapes: Tuple[str, ...] = ()

    # training
    dtype: str = "bfloat16"
    remat: str = "full"          # none | full  (activation checkpointing)

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))
        reps, rem = divmod(self.n_layers, max(len(self.layer_pattern), 1))
        if rem:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern {self.layer_pattern!r}")
        if self.family == "moe" and not (self.n_experts and self.top_k):
            raise ValueError(f"{self.name}: moe family needs experts/top_k")

    # ---- derived ------------------------------------------------------------

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256 so it shards over any mesh."""
        return (self.vocab + 255) // 256 * 256

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def pattern_reps(self) -> int:
        return self.n_layers // len(self.layer_pattern)

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Total parameters (used for 6·N·D roofline bookkeeping)."""
        d, v = self.d_model, self.vocab_padded
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        for kind in self.layer_pattern:
            n = self.pattern_reps
            if kind in ("G", "L"):
                total += n * self._attn_params()
                total += n * self._ffn_params()
            elif kind == "A":
                total += self._attn_params()          # shared: counted once
                total += n * self._ffn_params()
            elif kind == "M":
                total += n * self._mamba_params()
            elif kind in ("S", "X"):
                total += n * self._xlstm_params(kind)
            total += n * 2 * d                        # norms
        if self.enc_dec:
            # encoder layers: attention + ffn + cross-attn params in decoder
            total += self.n_enc_layers * (self._attn_params()
                                          + self._ffn_params() + 2 * d)
            total += self.n_layers * self._attn_params()  # cross-attn
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.n_layers * (
            3 * self.n_experts * d * self.d_expert)
        return dense + self.n_layers * 3 * self.top_k * d * self.d_expert

    def _attn_params(self) -> int:
        d = self.d_model
        return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.family == "moe":
            return (self.n_experts * 3 * d * self.d_expert
                    + d * self.n_experts)   # experts + router
        mult = 3 if self.act in ("swiglu", "geglu") else 2
        return mult * d * self.d_ff

    def _mamba_params(self) -> int:
        d, di, n = self.d_model, self.d_inner, self.ssm_state
        h = self.ssm_heads
        # in_proj -> [z(di), x(di), B(n), C(n), dt(h)]; conv over di+2n
        return (d * (2 * di + 2 * n + h)
                + di * d                       # out_proj
                + (self.conv_dim + 1) * (di + 2 * n)  # conv w + b
                + 3 * h + di)                  # a_log, dt_bias, d_skip, norm_z

    def _xlstm_params(self, kind: str) -> int:
        d = self.d_model
        h = self.n_heads
        if kind == "X":  # mLSTM: wq, wk, wv, wo + i/f gates
            return 4 * d * d + d * 2 * h + 2 * h
        # sLSTM: w_x [d,4d] + block-diag recurrent [h,p,4p] + bias
        return 4 * d * d + 4 * d * d // h + 4 * d
