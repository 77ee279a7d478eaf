"""Assigned input-shape sets and their (shape, dtype) specs (port of the
JAX package's ``configs/shapes.py``).

Every (arch × shape) cell of the assignment resolves here.  ``decode_*`` /
``long_*`` run ``serve_step`` (one new token against a seq_len KV cache);
``train_*`` runs ``train_step``; ``prefill_*`` runs the prefill step.

``input_specs()`` returns ``(shape, torch.dtype)`` pairs only — no device
allocation — where the reference returns ``jax.ShapeDtypeStruct``s.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.models.arch_config import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

ALL_CELLS = tuple((a, s) for a in range(10) for s in SHAPES)  # symbolic


def cell_is_skipped(cfg: ArchConfig, shape_name: str) -> bool:
    return shape_name in cfg.skip_shapes


def _frontends(cfg: ArchConfig, batch: int, dtype) -> Dict[str, Any]:
    extra: Dict[str, Any] = {}
    if cfg.frontend == "vit":
        extra["prefix_embeds"] = (
            (batch, cfg.frontend_tokens, cfg.d_model), dtype)
    if cfg.frontend == "audio":
        extra["enc_frames"] = ((batch, cfg.enc_seq, cfg.d_model), dtype)
    return extra


def input_specs(cfg: ArchConfig, shape_name: str) -> Dict[str, Any]:
    """(shape, dtype) stand-ins for every model input of the cell.

    train:   {tokens, labels, (frontend extras)}
    prefill: {tokens, (frontend extras)}
    decode:  {token [B,1], pos [B], (cache specs built by the launcher)}
    """
    spec = SHAPES[shape_name]
    if cell_is_skipped(cfg, shape_name):
        raise ValueError(f"{cfg.name} skips {shape_name} (see DESIGN.md)")
    dtype = getattr(torch, cfg.dtype)
    b, s = spec.batch, spec.seq
    tok = torch.int32
    if spec.kind == "train":
        out = {"tokens": ((b, s), tok),
               "labels": ((b, s), tok)}
        out.update(_frontends(cfg, b, dtype))
        return out
    if spec.kind == "prefill":
        out = {"tokens": ((b, s), tok)}
        out.update(_frontends(cfg, b, dtype))
        return out
    if spec.kind == "decode":
        return {"token": ((b, 1), tok),
                "pos": ((b,), tok)}
    raise ValueError(spec.kind)


def cache_seq_len(cfg: ArchConfig, shape_name: str) -> int:
    return SHAPES[shape_name].seq
