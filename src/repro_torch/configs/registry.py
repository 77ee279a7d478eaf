"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs
(port of the JAX package's ``configs/registry.py``; the model files beside
it are copies)."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.models.arch_config import ArchConfig

_MODULES: Dict[str, str] = {
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}

ALL_ARCHS = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def reduced_config(name: str) -> ArchConfig:
    """Same-family miniature for CPU smoke tests (one pattern group, tiny
    widths/tables — per the assignment: 'small layers/width, few experts,
    tiny embedding tables')."""
    cfg = get_config(name)
    pat = cfg.layer_pattern
    heads = max(2, min(cfg.n_heads, 4))
    kv = 1 if cfg.n_kv_heads == 1 else min(heads, max(1, cfg.n_kv_heads))
    kv = min(kv, heads)
    changes = dict(
        n_layers=len(pat) * (2 if len(pat) == 1 else 1),
        d_model=128,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        remat="none",
    )
    if cfg.family == "moe":
        changes.update(n_experts=8, top_k=2, d_expert=64)
    if "M" in pat:
        changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
    if cfg.enc_dec:
        changes.update(n_enc_layers=2, enc_seq=64)
    if cfg.frontend == "vit":
        changes.update(frontend_tokens=8)
    if cfg.window:
        changes.update(window=16)
    return dataclasses.replace(cfg, **changes)
