"""LSE — Latent Semantic Entities (product search; CIKM 2016).

Architecture (SURVEY.md section 1, model family 2): word embeddings ->
masked-mean pooling -> ``tanh(W x + b)`` projection into entity space ->
similarity against a learned entity-embedding matrix E [num_entities, d_e].
Trained with negative sampling (the word2vec-style sampled contrastive
objective), which is what lets the entity vocabulary scale; a full-softmax
mode exists for small-scale cross-checks (SURVEY.md section 8, hard part 1).

Sharding notes: ``entity_emb`` [E, d_e] carries the entity axis (sharded on
axis 0 under the ``model`` mesh axis). Negative sampling gathers only k
rows per example, so the train step stays collective-light; the full-softmax
cross-check reduces over the sharded axis via log-sum-exp.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from sert_tpu import engines
from sert_tpu.models.common import (
    Params,
    compute_dtype,
    masked_mean_embed,
    scaled_normal_init,
)
from sert_tpu.utils.config import ModelConfig


def init(rng: jax.Array, cfg: ModelConfig) -> Params:
    k_emb, k_w, k_ent = jax.random.split(rng, 3)
    dw, de, V, E = cfg.word_dim, cfg.entity_dim, cfg.vocab_size, cfg.num_entities
    pd = jnp.float32 if cfg.param_dtype == "float32" else jnp.bfloat16
    return {
        "word_emb": scaled_normal_init(k_emb, (V, dw), dw, pd),
        "proj_w": scaled_normal_init(k_w, (dw, de), dw, pd),
        "proj_b": jnp.zeros((de,), pd),
        "entity_emb": scaled_normal_init(k_ent, (E, de), de, pd),
    }


def noise_logits(entity_counts: Optional[jnp.ndarray], cfg: ModelConfig) -> jnp.ndarray:
    """Log-weights of the negative-sampling distribution over entities.

    ``uniform``: all-zeros. ``unigram``: counts**power (word2vec's 3/4
    heuristic applied to entity association frequencies). Returned as logits
    for ``jax.random.categorical``.
    """
    E = cfg.num_entities
    if cfg.negative_distribution == "uniform" or entity_counts is None:
        return jnp.zeros((E,), jnp.float32)
    c = jnp.asarray(entity_counts, jnp.float32)
    return cfg.unigram_power * jnp.log(jnp.maximum(c, 1e-12))


def window_rep(params: Params, windows: jax.Array, lengths: jax.Array,
               cfg: ModelConfig) -> jax.Array:
    """[B, d_e] projected window representations: tanh(W·mean_emb + b)."""
    ct = compute_dtype(cfg)
    pooled = masked_mean_embed(params["word_emb"].astype(ct), windows, lengths)
    h = jnp.dot(pooled, params["proj_w"].astype(ct),
                preferred_element_type=jnp.float32)
    return jnp.tanh(h + params["proj_b"].astype(jnp.float32))


def sample_negatives(rng: jax.Array, noise: jax.Array, batch_size: int,
                     cfg: ModelConfig) -> jax.Array:
    """[B, k] negative entity ids ~ noise distribution, iid with replacement.

    Sampled by inverse-CDF (cumsum + searchsorted), O(E + B*k*log E).
    jax.random.categorical would broadcast Gumbel noise to [B, k, E] —
    8e9 draws PER STEP at B=4096, k=10, E=200k — which made large-entity
    LSE training sampling-bound (caught by the 200k stress run).
    """
    probs = jax.nn.softmax(noise.astype(jnp.float32))
    cdf = jnp.cumsum(probs)
    u = jax.random.uniform(rng, (batch_size, cfg.num_negatives),
                           maxval=cdf[-1])  # guard fp cumsum sum < 1
    idx = jnp.searchsorted(cdf, u)
    return jnp.minimum(idx, cfg.num_entities - 1).astype(jnp.int32)


def loss(params: Params, batch, cfg: ModelConfig, rng: jax.Array = None,
         negatives: Optional[jax.Array] = None,
         noise: Optional[jax.Array] = None) -> jax.Array:
    """Negative-sampling objective:

        -E[ log sigma(rep·e+) + sum_k log sigma(-rep·e-_k) ]

    ``negatives`` may be passed explicitly (parity tests); otherwise they are
    sampled from ``noise`` (default uniform) with ``rng``.
    """
    reps = window_rep(params, batch["windows"], batch["lengths"], cfg)  # [B, de]
    B = reps.shape[0]
    if negatives is None:
        if noise is None:
            # Barrier: a constant zeros table would let XLA constant-fold
            # sample_negatives' softmax+cumsum over [E] at COMPILE time,
            # superlinearly in E (same guard as train/step.py).
            noise = jax.lax.optimization_barrier(
                jnp.zeros((cfg.num_entities,), jnp.float32))
        negatives = sample_negatives(rng, noise, B, cfg)                # [B, k]

    ent = params["entity_emb"].astype(jnp.float32)
    pos_vec = ent[batch["entities"]]                                    # [B, de]
    neg_vec = ent[negatives]                                            # [B, k, de]
    s_pos = jnp.sum(reps * pos_vec, axis=-1)                            # [B]
    s_neg = jnp.einsum("bd,bkd->bk", reps, neg_vec)                     # [B, k]
    ll = jax.nn.log_sigmoid(s_pos) + jnp.sum(jax.nn.log_sigmoid(-s_neg), axis=-1)
    return -jnp.mean(ll)


def sampled_softmax_inputs(params: Params, batch, cfg: ModelConfig,
                           rng: jax.Array = None,
                           negatives: Optional[jax.Array] = None,
                           noise: Optional[jax.Array] = None):
    """Shared prep for the sampled-softmax objective's loss formulations.

    Returns ``(reps [B,de], cand [k,de], corr [k], negatives [k] int,
    pos [B] int, s_pos [B])`` — everything downstream of the pooling
    front and candidate gather, consumed identically by the XLA
    composition, the single-device fused kernel, and the mesh-sharded
    fused loss (parallel/fused_loss.make_sharded_sampled_loss). The
    gathers stay OUT of any kernel/shard_map so GSPMD partitions them
    against a model-sharded entity table on meshes.
    """
    reps = window_rep(params, batch["windows"], batch["lengths"], cfg)  # [B, de]
    if noise is None:
        # Barrier: see loss() — prevents compile-time folding of the
        # sampling pipeline built on a constant table.
        noise = jax.lax.optimization_barrier(
            jnp.zeros((cfg.num_entities,), jnp.float32))
    logq = jax.nn.log_softmax(noise.astype(jnp.float32))                # [E]
    if negatives is None:
        negatives = sample_negatives(rng, noise, 1, cfg)[0]             # [k]
    k = negatives.shape[0]
    ent = params["entity_emb"].astype(jnp.float32)
    pos = batch["entities"]
    cand = ent[negatives]                                               # [k, de]
    s_pos = jnp.sum(reps * ent[pos], axis=-1)                           # [B]
    corr = logq[negatives] + jnp.log(jnp.float32(k))                    # [k]
    return reps, cand, corr, negatives, pos, s_pos


def loss_sampled_softmax(params: Params, batch, cfg: ModelConfig,
                         rng: jax.Array = None,
                         negatives: Optional[jax.Array] = None,
                         noise: Optional[jax.Array] = None) -> jax.Array:
    """Importance-corrected sampled softmax with BATCH-SHARED negatives.

    The binary-NCE objective (``loss``) measurably trails the full softmax
    it approximates on the hard stand-ins (docs/QUALITY.md ablation: NDCG
    0.63 vs 0.72 at E=900, and more negatives do NOT close the gap). This
    is the ranking-calibrated alternative: draw ONE candidate set of k
    negatives per step, score every in-batch positive against it, and use
    the importance-weighted partition estimate

        Z_hat_i = exp(s_pos_i) + (1/k) * sum_j exp(s_neg_ij) / q(neg_j)

    (Bengio & Senecal's sampled softmax; each sampled column's logit is
    corrected by -log(k * q(candidate))). With accidental hits (a negative
    equal to the row's positive) masked out, E[Z_hat] = Z exactly, so the
    loss CONVERGES to the full-softmax cross-entropy as k grows — unlike
    binary NCE, which optimizes a different (classification, not ranking)
    objective at any k. tests/test_models.py checks this convergence
    numerically.

    Consequence of SHARING the negatives: the negative scores are one
    [B, d] x [d, k] matmul instead of B independent [k, d] gathers +
    einsum — so k can be hundreds-to-thousands at small step cost, where
    per-example NCE paid O(B*k) gather rows. Gradients
    still touch only k + B entity rows per step (the scaling story that
    makes LSE viable at large E stays intact).
    """
    reps, cand, corr, negatives, pos, s_pos = sampled_softmax_inputs(
        params, batch, cfg, rng=rng, negatives=negatives, noise=noise)
    k = negatives.shape[0]
    if engines.fused_sampled_lse(cfg.fused_softmax, k):
        # Flash path: the masked lse over the shared candidates comes out
        # of the Triton kernels with no [B, k] logits in device memory; the
        # loss is the algebraically identical softplus form
        #   lse([s_pos, s_neg*]) - s_pos = softplus(lse(s_neg*) - s_pos).
        from sert_tpu.ops.sampled_lse import sampled_lse
        lse_neg = sampled_lse(reps, cand, corr, negatives, pos,
                              dtype=cfg.compute_dtype)                  # [B]
        return jnp.mean(jax.nn.softplus(lse_neg - s_pos))
    # Operands in the compute dtype with fp32 accumulation, as the kernel.
    ct = compute_dtype(cfg)
    s_neg = (jnp.dot(reps.astype(ct), cand.astype(ct).T,
                     preferred_element_type=jnp.float32)
             - corr[None, :])                                           # [B, k]
    hit = negatives[None, :] == pos[:, None]
    s_neg = jnp.where(hit, -1e30, s_neg)
    lse_all = jax.scipy.special.logsumexp(
        jnp.concatenate([s_pos[:, None], s_neg], axis=1), axis=-1)
    return jnp.mean(lse_all - s_pos)


def loss_full_softmax(params: Params, batch, cfg: ModelConfig,
                      rng: jax.Array = None) -> jax.Array:
    """Full-softmax cross-entropy over all entities (small-scale cross-check
    for the sampled objective; also usable as a trainable mode)."""
    del rng
    reps = window_rep(params, batch["windows"], batch["lengths"], cfg)
    ct = compute_dtype(cfg)
    z = jnp.dot(reps.astype(ct), params["entity_emb"].astype(ct).T,
                preferred_element_type=jnp.float32)                     # [B, E]
    lse = jax.scipy.special.logsumexp(z, axis=-1)
    gold = jnp.take_along_axis(z, batch["entities"][:, None], axis=-1)[:, 0]
    return jnp.mean(lse - gold)


def fold_in_entity(params: Params, token_ids, cfg: ModelConfig,
                   window_size: int = 16) -> jax.Array:
    """[d_e] embedding for an UNSEEN entity from its raw encoded text.

    LSE's projection f maps any word window into the entity space (the
    CIKM 2016 paper projects queries and documents with the same f); a new
    entity is represented as the mean of f over sliding windows of its
    associated text — the same f-input distribution training used. This is
    how serving adds entities without retraining (EntitySearcher
    .add_entities). Log-linear has no analogue: candidates exist only as
    learned columns of the projection matrix.
    """
    windows, lengths = _entity_windows(token_ids, window_size)
    # Chunk the dispatches: the window_rep gather materializes
    # [W, window, d_w]; an unbounded text (this is reachable from the
    # serve HTTP endpoint) must not become one multi-GB device allocation.
    CHUNK = 8192
    W = windows.shape[0]
    acc = None
    for lo in range(0, W, CHUNK):
        reps = window_rep(params, jnp.asarray(windows[lo:lo + CHUNK]),
                          jnp.asarray(lengths[lo:lo + CHUNK]), cfg)
        s = jnp.sum(reps, axis=0)
        acc = s if acc is None else acc + s
    return acc / W


def _entity_windows(token_ids, window_size: int):
    """Sliding stride-1 windows + lengths over an entity's encoded text
    (the f-input distribution training used) — shared by both fold-in
    paths."""
    import numpy as np

    ids = np.asarray(token_ids, np.int32)
    if ids.size == 0:
        raise ValueError("fold_in_entity needs at least one in-vocab token")
    n = int(ids.size)
    if n <= window_size:
        return ids[None, :], np.asarray([n], np.int32)
    windows = np.ascontiguousarray(
        np.lib.stride_tricks.sliding_window_view(ids, window_size))
    return windows, np.full(windows.shape[0], window_size, np.int32)


@partial(jax.jit, static_argnames=("steps",))
def _fold_in_opt(pos_reps, pos_w, neg_reps, v0, neg_weight, lr, steps):
    """Optimize one entity embedding v against FROZEN window reps.

    Plain logistic regression in v (the reps do not depend on it), so
    full-batch adam converges in a few hundred cheap [P+N, d] steps:

        L(v) = -sum_p w_p log sigma(pos_p . v)
               - neg_weight * mean_n log sigma(-neg_n . v)

    — exactly entity e's slice of the training NCE objective (models.lse
    .loss), with this entity's text windows as the positive visits and
    lm_stats-synthesized background windows standing in for the windows
    that would have drawn e as a negative. ``pos_w`` masks padding rows.
    """
    import optax

    opt = optax.adam(lr)

    def loss(v):
        s_pos = pos_reps @ v
        s_neg = neg_reps @ v
        return -(jnp.sum(pos_w * jax.nn.log_sigmoid(s_pos))
                 + neg_weight * jnp.mean(jax.nn.log_sigmoid(-s_neg)))

    def step(carry, _):
        v, st = carry
        g = jax.grad(loss)(v)
        up, st = opt.update(g, st, v)
        return (v + up, st), None

    (v, _), _ = jax.lax.scan(step, (v0, opt.init(v0)), None, length=steps)
    return v


def fold_in_entity_gradient(params: Params, token_ids, cfg: ModelConfig,
                            neg_reps: jax.Array, window_size: int = 16,
                            neg_weight: Optional[float] = None,
                            steps: int = 1000, lr: float = 0.05,
                            max_windows: int = 4096,
                            seed: int = 0) -> jax.Array:
    """[d_e] embedding for an unseen entity, optimized INTO the trained
    geometry (the principled fold-in; round-2 VERDICT item 6).

    Where :func:`fold_in_entity` returns the mean f-image (which lives on
    the tanh image manifold, not among trained NCE embeddings, and needs
    affine score calibration downstream), this fits v to the per-entity
    slice of the actual training objective against frozen params: its own
    text windows as positives, ``neg_reps`` (window reps synthesized from
    the collection term distribution, serving._background_reps_raw) as the
    background it must NOT respond to. The result scores on the trained
    index's own scale — no calibration map — so a folded twin of a trained
    entity ranks within tolerance of the original (tests/test_foldin.py).

    ``neg_weight`` defaults to ``cfg.num_negatives`` — training drew k
    negatives per positive window, so the background term carries k times
    one positive's weight. Texts longer than ``max_windows`` windows are
    deterministically subsampled (the estimate is a mean either way).
    """
    import numpy as np

    windows, lengths = _entity_windows(token_ids, window_size)
    W = windows.shape[0]
    if W > max_windows:
        sel = np.random.default_rng(seed).choice(W, size=max_windows,
                                                 replace=False)
        windows, lengths = windows[np.sort(sel)], lengths[np.sort(sel)]
        W = max_windows
    # Pad the positive rows up to a pow2 bucket so repeated serve-time
    # fold-ins re-use one compiled optimizer instead of retracing per text
    # length; padding rows carry zero weight.
    P = max(8, 1 << (W - 1).bit_length())
    pos_w = np.zeros((P,), np.float32)
    pos_w[:W] = 1.0 / W
    pad = np.zeros((P - W, windows.shape[1]), np.int32)
    windows = np.concatenate([windows, pad])
    lengths = np.concatenate([lengths, np.ones((P - W,), np.int32)])
    pos_reps = window_rep(params, jnp.asarray(windows), jnp.asarray(lengths),
                          cfg)
    v0 = jnp.sum(pos_reps * jnp.asarray(pos_w)[:, None], axis=0)  # f-image
    if neg_weight is None:
        neg_weight = float(cfg.num_negatives)
    return _fold_in_opt(pos_reps, jnp.asarray(pos_w),
                        jnp.asarray(neg_reps, jnp.float32),
                        v0, jnp.float32(neg_weight), jnp.float32(lr),
                        steps)


def query_scores(params: Params, term_ids: jax.Array, num_terms: jax.Array,
                 cfg: ModelConfig, similarity: str = "dot") -> jax.Array:
    """[E] scores: project the whole query as one window, then dot/cosine
    against every entity vector (the LSE retrieval rule)."""
    rep = window_rep(params, term_ids[None, :], num_terms[None], cfg)   # [1, de]
    ent = params["entity_emb"].astype(jnp.float32)
    if similarity == "cosine":
        rep = rep / jnp.maximum(jnp.linalg.norm(rep, axis=-1, keepdims=True), 1e-9)
        ent = ent / jnp.maximum(jnp.linalg.norm(ent, axis=-1, keepdims=True), 1e-9)
    return jnp.dot(ent, rep[0])
