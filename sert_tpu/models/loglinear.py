"""Log-linear word-to-entity model (expert finding; WWW 2016).

Architecture (SURVEY.md section 1, model family 1): word embeddings ->
masked-mean window pooling -> affine transformation into candidate space ->
full softmax over all entities. Query-time ranking uses the term-independence
aggregation  log P(c|q) = sum_i log P(c | w_i), each query term scored as a
singleton window.

Sharding notes: ``proj_w`` [d, E] and ``proj_b`` [E] carry the entity axis —
under the (data, model) mesh they are sharded on their last/only axis; the
cross-entropy below is written with log-sum-exp so XLA lowers the reduction
over a sharded entity axis to a ``psum`` (SURVEY.md section 3.3, TP row).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sert_tpu.models.common import (
    Params,
    compute_dtype,
    masked_mean_embed,
    scaled_normal_init,
)
from sert_tpu.utils.config import ModelConfig


def init(rng: jax.Array, cfg: ModelConfig) -> Params:
    k_emb, k_proj = jax.random.split(rng)
    d, V, E = cfg.word_dim, cfg.vocab_size, cfg.num_entities
    pd = jnp.float32 if cfg.param_dtype == "float32" else jnp.bfloat16
    return {
        "word_emb": scaled_normal_init(k_emb, (V, d), d, pd),
        "proj_w": scaled_normal_init(k_proj, (d, E), d, pd),
        "proj_b": jnp.zeros((E,), pd),
    }


def logits(params: Params, windows: jax.Array, lengths: jax.Array,
           cfg: ModelConfig) -> jax.Array:
    """[B, E] unnormalized candidate-space scores for word windows."""
    ct = compute_dtype(cfg)
    pooled = masked_mean_embed(params["word_emb"].astype(ct), windows, lengths)
    out = jnp.dot(pooled, params["proj_w"].astype(ct),
                  preferred_element_type=jnp.float32)
    return out + params["proj_b"].astype(jnp.float32)


def loss(params: Params, batch, cfg: ModelConfig,
         rng: jax.Array = None) -> jax.Array:
    """Mean cross-entropy of the full softmax over entities, written as
    lse(z) - z_y so a sharded entity axis reduces with one collective
    log-sum-exp."""
    del rng  # full softmax needs no sampling randomness
    z = logits(params, batch["windows"], batch["lengths"], cfg)   # [B, E]
    lse = jax.scipy.special.logsumexp(z, axis=-1)                 # [B]
    gold = jnp.take_along_axis(z, batch["entities"][:, None], axis=-1)[:, 0]
    return jnp.mean(lse - gold)


def term_log_probs(params: Params, term_ids: jax.Array,
                   cfg: ModelConfig) -> jax.Array:
    """[T, E] log P(c | w_t) for single query terms (singleton windows)."""
    T = term_ids.shape[0]
    windows = term_ids[:, None]                                   # [T, 1]
    lengths = jnp.ones((T,), jnp.int32)
    z = logits(params, windows, lengths, cfg)
    return jax.nn.log_softmax(z, axis=-1)


def query_scores(params: Params, term_ids: jax.Array, num_terms: jax.Array,
                 cfg: ModelConfig) -> jax.Array:
    """[E] retrieval scores: sum of per-term log-probs over the (padded)
    query term array; ``num_terms`` masks padding so fixed query shapes work
    under jit."""
    lp = term_log_probs(params, term_ids, cfg)                    # [T, E]
    mask = (jnp.arange(term_ids.shape[0]) < num_terms)[:, None]
    return jnp.sum(lp * mask, axis=0)
