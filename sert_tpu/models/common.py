"""Shared model pieces: pooling, dtype handling, initializers."""

from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp

from sert_tpu.utils.config import ModelConfig

Params = Dict[str, Any]


def compute_dtype(cfg: ModelConfig):
    return jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32


def masked_mean_pool(rows: jax.Array, lengths: jax.Array) -> jax.Array:
    """Masked-mean over pre-gathered window rows: [B, w, d], [B] -> [B, d].

    Positions past each length are padding and excluded; zero-length
    windows (all-OOV input) yield a zero vector rather than NaN. The ONE
    pooling core — masked_mean_embed and the row-sparse step's
    gathered-rows forward (train/sparse.py) must stay numerically
    identical, so both delegate here.
    """
    w = rows.shape[1]
    mask = (jnp.arange(w)[None, :] < lengths[:, None])        # [B, w]
    rows = rows * mask[:, :, None].astype(rows.dtype)
    denom = jnp.maximum(lengths, 1).astype(rows.dtype)[:, None]
    return jnp.sum(rows, axis=1) / denom                      # [B, d]


def masked_mean_embed(word_emb: jax.Array, windows: jax.Array,
                      lengths: jax.Array) -> jax.Array:
    """Masked-mean pooling of word embeddings over a fixed-width window.

    ``windows`` int32[B, w], ``lengths`` int32[B] (<= w; positions past the
    length are padding and excluded). The reference averaged ragged windows
    (SURVEY.md section 1, model descriptions); static jit shapes demand the
    mask formulation.
    """
    return masked_mean_pool(word_emb[windows], lengths)       # [B, d]


def scaled_normal_init(rng: jax.Array, shape, dim: int,
                       dtype=jnp.float32) -> jax.Array:
    """N(0, 1/dim) init — keeps dot products O(1) at init, the standard
    embedding-scale choice for softmax-over-entities models."""
    return jax.random.normal(rng, shape, dtype) * (1.0 / jnp.sqrt(dim))
