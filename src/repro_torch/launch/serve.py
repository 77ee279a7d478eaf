"""Serving steps: prefill and decode on one device (port of the JAX
package's ``launch/serve.py``).

Each step runs under ``torch.inference_mode()`` and writes the caches it
is given in place, returning them: the counterpart of the reference's
jitted steps, which donate their caches.  The reference's cache and
parameter shardings (``cache_leaf_spec``, ``*_shardings``) and its AOT
lowering for the dry run (``lower_*``) belong to the mesh and are not
ported.
"""

from __future__ import annotations

from repro_torch.models import transformer as tf
from repro_torch.models.arch_config import ArchConfig


def make_decode_step(cfg: ArchConfig):
    def serve_step(params, caches, token, pos):
        return tf.decode_step(cfg, params, token, caches, pos)
    return serve_step


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, caches, tokens, **extras):
        return tf.prefill(cfg, params, tokens, caches, **extras)
    return prefill_step


def make_chunked_prefill_step(cfg: ArchConfig, chunk_len: int = 2048):
    """The prefill step over chunks of ``chunk_len`` tokens (the
    reference's ``lower_prefill_step(..., chunked=True)``)."""
    def prefill_step(params, caches, tokens):
        return tf.prefill_chunked(cfg, params, tokens, caches,
                                  chunk_len=chunk_len)
    return prefill_step
