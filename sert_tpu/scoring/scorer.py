"""Entity scoring engines: exact dense and streaming chunked top-k.

Math note (why one engine serves both model families):

  * log-linear:  log P(c|q) = sum_t [ z_tc - lse_t ],  z_tc = e_t·W_c + b_c.
    The per-term normalizer lse_t is constant across entities, so ranking
    needs only sum_t z_tc = (sum_t e_t)·W_c + |q|·b_c — a single matvec
    against the entity matrix. The engine still reports EXACT log-probs: an
    online (max, sumexp) accumulator over entity chunks computes every
    lse_t in the same sweep, and the constant is folded into the final
    top-k scores.
  * LSE: score = f(q)·e_c (or cosine) — directly a matvec.

So: scores = R @ M^T + alpha*bias + const(q), with R [Q, d], M [E, d].
``streaming_topk`` scans M in chunks, merging a running top-k; peak memory is
O(Q*(T*chunk)) instead of O(Q*E) — the fixed-memory contract BASELINE.json
demands for the 10M-entity configuration.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from sert_tpu.models import api, lse as lse_model
from sert_tpu.models.common import compute_dtype
from sert_tpu.utils.config import ModelConfig

# Python float, NOT jnp.float32: a module-level concrete array initializes
# the XLA backend at import time, which breaks multi-controller programs
# (jax.distributed.initialize must precede any backend use) and pins the
# platform before callers can choose one. jnp ops weak-type it identically.
NEG_INF = -1e30

# The "exact" engines multiply in fp32 at full precision: on a GPU a
# DEFAULT-precision fp32 product may run in TF32 (~1e-3 relative error).
HIGHEST = jax.lax.Precision.HIGHEST


def _query_reps_and_terms(params, cfg: ModelConfig, term_ids, num_terms,
                          similarity: str):
    """R [Q, d] plus (for log-linear) masked term embeddings [Q, T, d]."""
    ct = compute_dtype(cfg)
    Q, T = term_ids.shape
    mask = (jnp.arange(T)[None, :] < num_terms[:, None])          # [Q, T]
    if cfg.model == "loglinear":
        emb = params["word_emb"].astype(ct)[term_ids]             # [Q, T, d]
        emb = emb * mask[:, :, None].astype(emb.dtype)
        return jnp.sum(emb, axis=1), emb, mask
    reps = lse_model.window_rep(params, term_ids, num_terms, cfg)  # [Q, de]
    if similarity == "cosine":
        reps = reps / jnp.maximum(jnp.linalg.norm(reps, axis=-1, keepdims=True), 1e-9)
    return reps, None, mask


def _entity_matrix(params, cfg: ModelConfig, similarity: str) -> jax.Array:
    M = api.entity_matrix(params, cfg).astype(jnp.float32)        # [E, d]
    if cfg.model != "loglinear" and similarity == "cosine":
        M = M / jnp.maximum(jnp.linalg.norm(M, axis=-1, keepdims=True), 1e-9)
    return M


@functools.partial(jax.jit, static_argnames=("cfg", "similarity"))
def dense_scores(params, cfg: ModelConfig, term_ids: jax.Array,
                 num_terms: jax.Array, similarity: str = "dot") -> jax.Array:
    """Exact [Q, E] scores (log-probs for log-linear, similarity for LSE)."""
    R, term_emb, mask = _query_reps_and_terms(params, cfg, term_ids,
                                              num_terms, similarity)
    M = _entity_matrix(params, cfg, similarity)
    scores = jnp.dot(R.astype(jnp.float32), M.T, precision=HIGHEST,
                     preferred_element_type=jnp.float32)          # [Q, E]
    if cfg.model == "loglinear":
        b = params["proj_b"].astype(jnp.float32)
        scores = scores + num_terms.astype(jnp.float32)[:, None] * b[None, :]
        # exact per-term normalizers
        z = jnp.einsum("qtd,ed->qte", term_emb.astype(jnp.float32), M,
                       precision=HIGHEST) + b
        lse_t = jax.scipy.special.logsumexp(z, axis=-1)           # [Q, T]
        scores = scores - jnp.sum(lse_t * mask, axis=-1)[:, None]
    return scores


def lse_chunk_update(run_max: jax.Array, run_sum: jax.Array, z: jax.Array
                     ) -> Tuple[jax.Array, jax.Array]:
    """One online-logsumexp accumulation over the trailing (entity) axis of
    ``z``: numerically stable merge of the running (max, sumexp) carry with
    a new chunk of logits. THE shared accumulator body — chunked_topk_core,
    ll_log_normalizer's scan engine, and parallel.topk._local_lse must stay
    numerically identical for the exactness claims (streaming == dense,
    distributed == single-device), so they all call this instead of
    hand-rolling the update."""
    m_new = jnp.maximum(run_max, jnp.max(z, axis=-1))
    run_sum = (run_sum * jnp.exp(run_max - m_new)
               + jnp.sum(jnp.exp(z - m_new[..., None]), axis=-1))
    return m_new, run_sum


def chunked_topk_core(R: jax.Array, term_emb: Optional[jax.Array],
                      mask: jax.Array, M: jax.Array,
                      bias: Optional[jax.Array], k: int, chunk: int,
                      is_ll: bool, vary_axes: Tuple[str, ...] = ()
                      ) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """The streaming sweep over an (arbitrary) entity-matrix block ``M``.

    Returns UN-normalized (top_s [Q,k], top_i [Q,k] local row indices,
    run_max [Q,T], run_sum [Q,T]) — the caller applies the log-linear
    normalizer (locally for single-device, after a psum-combine for the
    sharded path). ``k`` entries are always emitted; if M has fewer than k
    rows the tail is NEG_INF-padded (it loses any later merge).

    Shared verbatim by streaming_topk and parallel.topk: the distributed
    engine is this core per shard plus a merge (SURVEY.md section 6,
    distributed scoring row).
    """
    E_rows = M.shape[0]
    Q, T = mask.shape
    n_chunks = max(-(-E_rows // chunk), 1)
    pad = n_chunks * chunk - E_rows
    M_p = jnp.pad(M, ((0, pad), (0, 0)))
    if is_ll:
        b_p = jnp.pad(bias.astype(jnp.float32), (0, pad))
        tm32 = mask.astype(jnp.float32)

    def body(carry, ci):
        top_s, top_i, run_max, run_sum = carry
        lo = ci * chunk
        Mc = jax.lax.dynamic_slice_in_dim(M_p, lo, chunk, axis=0)  # [C, d]
        valid = (lo + jnp.arange(chunk)) < E_rows                  # [C]
        if is_ll:
            bc = jax.lax.dynamic_slice_in_dim(b_p, lo, chunk)
            # term-level logits for the online normalizer
            z = jnp.einsum("qtd,cd->qtc", term_emb.astype(jnp.float32), Mc,
                           precision=HIGHEST) + bc
            z = jnp.where(valid[None, None, :], z, NEG_INF)
            run_max, run_sum = lse_chunk_update(run_max, run_sum, z)
            sc = jnp.sum(z * tm32[:, :, None], axis=1)             # [Q, C]
        else:
            sc = jnp.dot(R.astype(jnp.float32), Mc.T, precision=HIGHEST,
                         preferred_element_type=jnp.float32)       # [Q, C]
        sc = jnp.where(valid[None, :], sc, NEG_INF)
        cand_s = jnp.concatenate([top_s, sc], axis=1)              # [Q, K+C]
        cand_i = jnp.concatenate(
            [top_i, jnp.broadcast_to(lo + jnp.arange(chunk), (Q, chunk))], axis=1)
        new_s, sel = jax.lax.top_k(cand_s, k)
        new_i = jnp.take_along_axis(cand_i, sel, axis=1)
        return (new_s, new_i, run_max, run_sum), None

    init = (jnp.full((Q, k), NEG_INF), jnp.zeros((Q, k), jnp.int32),
            jnp.full((Q, T), NEG_INF), jnp.zeros((Q, T), jnp.float32))
    if vary_axes:
        # Under shard_map the body output varies over the mesh axes (it reads
        # sharded M), so the carry init must be marked varying too.
        init = tuple(jax.lax.pcast(x, vary_axes, to="varying") for x in init)
    (top_s, top_i, run_max, run_sum), _ = jax.lax.scan(
        body, init, jnp.arange(n_chunks))
    return top_s, top_i, run_max, run_sum


def apply_ll_normalizer(top_s: jax.Array, run_max: jax.Array,
                        run_sum: jax.Array, mask: jax.Array) -> jax.Array:
    """Fold the accumulated per-term logsumexp into final log-prob scores."""
    lse_t = run_max + jnp.log(jnp.maximum(run_sum, 1e-30))         # [Q, T]
    const = jnp.sum(lse_t * mask.astype(jnp.float32), axis=-1)     # [Q]
    return top_s - const[:, None]


@functools.partial(jax.jit, static_argnames=("cfg", "chunk", "similarity"))
def ll_log_normalizer(params, cfg: ModelConfig, term_ids: jax.Array,
                      num_terms: jax.Array, chunk: int = 1 << 16,
                      similarity: str = "dot") -> jax.Array:
    """[Q] log-linear normalization constants sum_t logsumexp_c(z_tc): a
    fixed-memory scan over entity chunks. Used by the exact engine, whose
    prefilter ranks by un-normalized sums."""
    R, term_emb, mask = _query_reps_and_terms(params, cfg, term_ids,
                                              num_terms, similarity)
    M = _entity_matrix(params, cfg, similarity)
    b = params["proj_b"].astype(jnp.float32)
    E = M.shape[0]
    n_chunks = -(-E // chunk)
    pad = n_chunks * chunk - E
    M_p = jnp.pad(M, ((0, pad), (0, 0)))
    b_p = jnp.pad(b, (0, pad))
    Q, T = mask.shape

    def body(carry, ci):
        run_max, run_sum = carry
        lo = ci * chunk
        Mc = jax.lax.dynamic_slice_in_dim(M_p, lo, chunk, axis=0)
        bc = jax.lax.dynamic_slice_in_dim(b_p, lo, chunk)
        z = jnp.einsum("qtd,cd->qtc", term_emb.astype(jnp.float32), Mc,
                       precision=HIGHEST) + bc
        z = jnp.where(((lo + jnp.arange(chunk)) < E)[None, None, :], z, NEG_INF)
        return lse_chunk_update(run_max, run_sum, z), None

    init = (jnp.full((Q, T), NEG_INF), jnp.zeros((Q, T), jnp.float32))
    (run_max, run_sum), _ = jax.lax.scan(body, init, jnp.arange(n_chunks))
    lse_t = run_max + jnp.log(jnp.maximum(run_sum, 1e-30))
    return jnp.sum(lse_t * mask.astype(jnp.float32), axis=-1)


def exact_engine_topk(params, cfg: ModelConfig, term_ids: jax.Array,
                      num_terms: jax.Array, k: int = 100,
                      similarity: str = "dot", prep=None,
                      normalize: bool = True,
                      adaptive_bins: int = 0) -> Tuple[jax.Array, jax.Array]:
    """Top-k via the exact bin-max engine (ops.exact_topk).

    For log-linear the prefilter ranks by the rank-equivalent un-normalized
    sum of logits (alpha = |q| scales the entity bias); the exact log-prob
    constant is restored afterwards with one matmul-bound normalizer scan
    (``normalize=False`` skips it — rankings are unaffected).

    ``prep``: pass ops.exact_topk.prepare_entities(entity_matrix) to reuse
    the staged matrix across query batches (score_topics does).
    """
    from sert_tpu.ops.exact_topk import exact_topk_prepared, prepare_entities

    R, term_emb, mask = _query_reps_and_terms(params, cfg, term_ids,
                                              num_terms, similarity)
    if prep is None:
        prep = prepare_entities(_entity_matrix(params, cfg, similarity))
    is_ll = cfg.model == "loglinear"
    bias = params["proj_b"].astype(jnp.float32) if is_ll else None
    alpha = num_terms.astype(jnp.float32) if is_ll else None
    top_s, top_i = exact_topk_prepared(R.astype(jnp.float32), prep,
                                       bias=bias, alpha=alpha, k=k,
                                       adaptive_bins=adaptive_bins)
    if is_ll and normalize:
        const = ll_log_normalizer(params, cfg, term_ids, num_terms,
                                  similarity=similarity)
        top_s = top_s - const[:, None]
    return top_s, top_i


@functools.partial(jax.jit,
                   static_argnames=("cfg", "k", "chunk", "similarity"))
def streaming_topk(params, cfg: ModelConfig, term_ids: jax.Array,
                   num_terms: jax.Array, k: int = 100, chunk: int = 32768,
                   similarity: str = "dot"
                   ) -> Tuple[jax.Array, jax.Array]:
    """Top-k entity (scores [Q,k], indices [Q,k]) at O(Q*chunk) memory.

    Scans the entity matrix in ``chunk``-row blocks; each step is one
    matmul plus a top-k merge of the running best against the block. The
    log-linear normalizer accumulates online (streaming logsumexp) and is
    applied after the scan — identical scores to :func:`dense_scores`.
    """
    E = api.entity_matrix(params, cfg).shape[0]
    k = min(k, E)
    R, term_emb, mask = _query_reps_and_terms(params, cfg, term_ids,
                                              num_terms, similarity)
    M = _entity_matrix(params, cfg, similarity)
    is_ll = cfg.model == "loglinear"
    bias = params["proj_b"] if is_ll else None
    top_s, top_i, run_max, run_sum = chunked_topk_core(
        R, term_emb, mask, M, bias, k, chunk, is_ll)
    if is_ll:
        top_s = apply_ll_normalizer(top_s, run_max, run_sum, mask)
    return top_s, top_i
