"""Exact top-k via bin-max prefilter + gather-rescore.

Algorithm (k-th value = theta, assuming no score ties at theta):
  1. bins = score_binmax(R, M, ...)            # [Q, E/128], fused sweep
  2. Every bin containing a true top-k element has bin-max >= theta, and at
     most k bins have max >= theta (each such bin contributes >= 1 element
     >= theta, of which there are exactly k). Hence the top-k bins BY MAX
     contain every true top-k element.
  3. Take top (k + pad) bins (pad covers the possibly-inflated partial tail
     bin and boundary ties), gather ONLY those bins' entity vectors, rescore
     exactly (fp32), and run one small top-k over [Q, (k+pad)*128].

Cost: one sweep that reads the entity matrix once + one top-k over E/128
bins + one gather of (k+pad)*128 rows per query. The gather grows with k:
at depth 1000 it reads ~1000*128 fp32 rows per query, which is why the
engine choice (sert_tpu/engines.py) looks at k.

Precision caveat (in addition to the exact-tie caveat below): the DEFAULT
prefilter multiplies in bf16, so "exact" holds for score margins above bf16
resolution (~4e-3 relative). When the true k-th/(k+1)-th gap is finer —
tightly clustered trained embeddings — boundary elements can be missed even
though the RETURNED scores are fp32-honest. Mitigations, in cost order:
``pad_bins`` (default 12) absorbs boundary reshuffles; and
``prepare_entities(..., prefilter_dtype="float32")`` makes the prefilter
full-precision (2x prefilter memory). The rescore multiplies in fp32 at
``precision=HIGHEST``: on a GPU a DEFAULT-precision fp32 product may run
in TF32 and carry ~1e-3 relative error into the "exact" scores.

Tie caveat: if MORE than ``pad`` bins tie exactly at theta beyond the k-th,
an element could be missed; with continuous scores this has measure zero,
and duplicate entity vectors (exact ties) can only be missed in favor of an
equal-scoring duplicate — the returned SCORES are still exact.

Related work: screening models for fast softmax inference (Chen et al.,
"Learning to Screen for Fast Softmax Inference", arXiv:1810.12406 — see
PAPERS.md) prune candidates with a LEARNED clusterer; the bin-max prefilter
here achieves the pruning with an exactness guarantee instead, trading a
128x-reduced exact max-reduce for training a screener.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from sert_tpu import engines
from sert_tpu.ops.score_binmax import (LANES, SPAN, _pad_to, binmax_reference,
                                       prepare_binmax_matrix,
                                       score_binmax_prepared)


class PreparedEntities(NamedTuple):
    """Entity matrix staged for repeated exact_topk sweeps: the bf16-padded
    binmax operand plus the bin-major rescore view, both device-resident.
    Registered as a pytree with the sizes as STATIC aux data so jit treats
    them as compile-time constants. ``te`` records the entity-tile size Mp
    was padded for; the sweep MUST use the same value (score_binmax_prepared
    validates), otherwise grid flooring would silently skip the tail rows."""
    Mp: jax.Array        # [Ep, dp] bf16, padded for the sweep
    M_binned: jax.Array  # [n_bins, bin_width, d] rescore-dtype, contiguous
    num_entities: int
    dim: int
    bin_width: int = LANES
    te: int = SPAN
    # layout="clustered": row r of the staged matrix is M[perm[r]] — similar
    # entities made bin-adjacent so one query's winners span FEWER bins
    # (adaptive_bins exploits this; indices are mapped back on return).
    perm: Optional[jax.Array] = None


jax.tree_util.register_pytree_node(
    PreparedEntities,
    lambda p: ((p.Mp, p.M_binned, p.perm),
               (p.num_entities, p.dim, p.bin_width, p.te)),
    lambda aux, ch: PreparedEntities(ch[0], ch[1], *aux, perm=ch[2]),
)


def _cluster_order(M: jax.Array, n_clusters: Optional[int] = None,
                   iters: int = 8, sample: int = 1 << 16,
                   seed: int = 0) -> jax.Array:
    """[E] permutation grouping directionally-similar rows (coarse spherical
    k-means on a subsample, then a stable sort by assignment). One-off at
    staging: the heavy step is the final [E, d] x [d, C] assignment.

    ``n_clusters`` defaults to ~E/bin_width (capped): the layout only
    concentrates a query's winners into few BINS if a cluster is about one
    bin wide. A fixed 256 clusters measured well at E=50k (~1.5 bins per
    cluster: 76 -> 50 mean winner-bins) but did NOTHING at E=1M (each
    cluster spanned ~30 bins; 92 -> 94 mean winner-bins).
    Measured follow-up (round 3): the ~E/128 default does NOT rescue the
    trained 1M hard-mode matrix either (8192 clusters: 92.2 -> 94.9 mean
    winner-bins) — there the spread is intrinsic, a query's top-100 being
    dominated by scattered singletons rather than sibling clusters, so the
    layout stays a 50k-regime tool."""
    E, d = M.shape
    if n_clusters is None:
        n_clusters = min(8192, max(256, E // LANES))

    def assign_chunked(X: jax.Array, C: jax.Array,
                       slab: int = 1 << 15) -> jax.Array:
        """argmax(X @ C.T, axis=1) in row slabs: the full [n, C] score
        matrix at E=1M x 8192 clusters would be a 31GB temp."""
        n = X.shape[0]
        if n <= slab:
            return jnp.argmax(jnp.dot(X, C.T,
                                      preferred_element_type=jnp.float32),
                              axis=1)
        pad = (-n) % slab
        Xp = jnp.pad(X, ((0, pad), (0, 0)))
        a = jax.lax.map(
            lambda xs: jnp.argmax(
                jnp.dot(xs, C.T, preferred_element_type=jnp.float32), axis=1),
            Xp.reshape(-1, slab, X.shape[1]))
        return a.reshape(-1)[:n]

    Xn = M.astype(jnp.float32)
    Xn = Xn / jnp.maximum(jnp.linalg.norm(Xn, axis=-1, keepdims=True), 1e-9)
    key = jax.random.key(seed)
    k1, k2 = jax.random.split(key)
    C = Xn[jax.random.choice(k1, E, (min(n_clusters, E),), replace=False)]
    sub = Xn[jax.random.choice(k2, E, (min(sample, E),), replace=False)]
    for _ in range(iters):
        a = assign_chunked(sub, C)
        tot = jax.ops.segment_sum(sub, a, num_segments=C.shape[0])
        cnt = jax.ops.segment_sum(jnp.ones((sub.shape[0],), jnp.float32), a,
                                  num_segments=C.shape[0])
        Cn = tot / jnp.maximum(cnt[:, None], 1.0)
        # keep empty clusters' previous centroid instead of collapsing to 0
        Cn = jnp.where(cnt[:, None] > 0, Cn, C)
        C = Cn / jnp.maximum(jnp.linalg.norm(Cn, axis=-1, keepdims=True),
                             1e-9)
    assign = assign_chunked(Xn, C)
    return jnp.argsort(assign, stable=True).astype(jnp.int32)


def prepare_entities(M: jax.Array, te: int = SPAN,
                     rescore_dtype: str = "float32",
                     prefilter_dtype: str = "bfloat16",
                     bin_width: int = LANES,
                     layout: str = "natural") -> PreparedEntities:
    """``bin_width``: entities per prefilter/rescore bin. The exactness
    argument is width-independent (top-k spans <= k+pad bins either way);
    64 halves the rescore gather bytes of 128 at twice the bins.

    ``layout="clustered"`` permutes rows so directionally-similar entities
    share bins (coarse spherical k-means order; the permutation is undone
    on returned indices). A query's top-k are mutually similar, so they
    then span FEWER bins — measured on a trained 50k matrix: mean 76
    winner-bins natural vs 50 clustered at k=100 — which is what the
    ``adaptive_bins`` rescore in exact_topk_prepared converts into fewer
    gather bytes. Results are exact under either layout."""
    E, d = M.shape
    rdt = jnp.bfloat16 if rescore_dtype == "bfloat16" else jnp.float32
    pdt = jnp.bfloat16 if prefilter_dtype == "bfloat16" else jnp.float32
    perm = None
    if layout == "clustered":
        perm = _cluster_order(M)
        M = M[perm]
    elif layout != "natural":
        raise ValueError(f"unknown layout {layout!r}")
    M_binned = _pad_to(M.astype(rdt), 0, bin_width).reshape(-1, bin_width, d)
    return PreparedEntities(prepare_binmax_matrix(M, te=te, dtype=pdt),
                            M_binned, E, d, bin_width, te, perm=perm)


def hierarchical_topk(x: jax.Array, k: int, m: Optional[int] = None,
                      group: int = 128) -> Tuple[jax.Array, jax.Array]:
    """Exact top-k over x [Q, N] by per-group top-m, then one small merge.

    A group deeper than its top-m can
    hide a winner only if its m-th value >= the merged k-th value; the
    condition is checked exactly and the rare hit (>= m true winners packed
    into one group) falls back to the flat top_k via lax.cond — results are
    always exact. Returns (values [Q, k], indices into x [Q, k]).
    """
    Q, N = x.shape
    if m is None:
        m = 8 if k <= 256 else 16

    def flat(_):
        vals, idx = jax.lax.top_k(x, k)   # top_k returns a LIST on some paths
        return vals, idx

    n_groups = -(-N // group)
    if n_groups * m < k or N <= group:
        return flat(None)

    pad = n_groups * group - N
    xp = jnp.pad(x, ((0, 0), (0, pad)), constant_values=-jnp.inf)
    v = xp.reshape(Q, n_groups, group)
    tv, tl = jax.lax.top_k(v, m)                            # [Q, G, m]
    cand_s = tv.reshape(Q, n_groups * m)
    # int32 explicitly: under jax_enable_x64 arange would be int64 and the
    # cond branches (flat top_k indices are always int32) would mismatch.
    cand_i = (jnp.arange(n_groups, dtype=jnp.int32)[None, :, None] * group
              + tl).reshape(Q, n_groups * m)
    top_s, sel = jax.lax.top_k(cand_s, k)
    top_i = jnp.take_along_axis(cand_i, sel, axis=1)

    theta = top_s[:, -1]
    suspect = jnp.any(tv[:, :, m - 1] >= theta[:, None])
    return jax.lax.cond(suspect, flat, lambda _: (top_s, top_i), None)


def exact_topk_prepared(R: jax.Array, prep: PreparedEntities,
                        bias: Optional[jax.Array] = None,
                        alpha: Optional[jax.Array] = None,
                        k: int = 100, pad_bins: int = 12,
                        sweep: Optional[str] = None,
                        interpret: Optional[bool] = None,
                        adaptive_bins: int = 0,
                        ) -> Tuple[jax.Array, jax.Array]:
    """(scores [Q, k], entity indices [Q, k]) of R @ M^T (+ alpha*bias).

    ``sweep``: "triton" (the fused kernel, ops/score_binmax.py) or "xla"
    (the same arithmetic left to XLA); None lets engines.binmax_sweep
    choose. The rescore is an XLA bin-row gather with promise_in_bounds +
    optimization_barrier. The entity matrix must be staged ONCE via
    prepare_entities: re-casting it per call costs more than the sweep.

    ``adaptive_bins=na`` (0 < na < k+pad_bins) makes the rescore two-phase:
    rescore only the top ``na`` bins, take the provisional k-th value
    theta, and accept iff EVERY query's (na+1)-th bin-max < theta — any
    element of an unrescored bin is then provably below at least k
    rescored candidates, so the result is exact. One batch-global
    lax.cond falls back to the full k+pad_bins rescore otherwise. Wins
    when winners concentrate in few bins (the ``layout="clustered"``
    staging exists to make that true); the acceptance cut carries an
    explicit prefilter-dtype margin (bf16 bin maxima round; see the module
    caveat) so a near-theta bin falls back to the full rescore instead of
    being silently skipped.
    """
    # Resolved before jit: the choice must key the compile cache.
    interpret = engines.interpret_default(interpret)
    if sweep is None:
        sweep = "triton" if interpret else engines.binmax_sweep()
    return _exact_topk_prepared(R, prep, bias, alpha, k=k,
                                pad_bins=pad_bins, sweep=sweep,
                                interpret=interpret,
                                adaptive_bins=adaptive_bins)


@functools.partial(jax.jit, static_argnames=("k", "pad_bins", "sweep",
                                             "interpret", "adaptive_bins"))
def _exact_topk_prepared(R, prep, bias, alpha, *, k, pad_bins, sweep,
                         interpret, adaptive_bins):
    Q, d = R.shape
    E = prep.num_entities
    bw = prep.bin_width
    k = min(k, E)
    if adaptive_bins > 0 and adaptive_bins * bw < k:
        raise ValueError(
            f"adaptive_bins={adaptive_bins} x bin_width={bw} yields only "
            f"{adaptive_bins * bw} phase-1 candidates < k={k}; raise "
            f"adaptive_bins to at least {-(-k // bw)} (or 0 to disable "
            "the two-phase rescore)")

    # Clustered staging permuted the entity rows; bias arrives in ORIGINAL
    # entity order and pairs with rows inside both kernels — permute it
    # once here so every downstream lookup uses staged positions.
    if prep.perm is not None and bias is not None:
        bias = bias[prep.perm]

    # The sweep tile size comes from the prep stage (prep.te): a mismatched
    # te would floor the grid and silently skip the tail entity rows.
    if sweep == "triton":
        bins = score_binmax_prepared(
            R, prep.Mp, E, bias, alpha, te=prep.te, bin_width=bw,
            interpret=interpret)
    elif sweep == "xla":
        bins = binmax_reference(R, prep.Mp, E, bias, alpha, bin_width=bw)
    else:
        raise ValueError(f"unknown sweep {sweep!r}")
    nb_total = bins.shape[1]
    nb = min(k + pad_bins, nb_total)

    # Bins selection: hierarchical with m=16 (top-16 per 128-bin group +
    # verified-exact fallback); m=8 fired the fallback too often at
    # nb~116 winners over 61 groups.
    bin_vals, bin_idx = hierarchical_topk(bins, nb, m=16)    # [Q, nb]

    def rescore_select(nbx: int):
        """Exact rescore + final selection over the top ``nbx`` bins."""
        bi = bin_idx[:, :nbx]
        ent_idx = (bi[:, :, None] * bw
                   + jnp.arange(bw)[None, None, :]).reshape(Q, nbx * bw)
        valid = ent_idx < E

        safe_idx = jax.lax.optimization_barrier(bi)
        Mg = prep.M_binned.at[safe_idx].get(
            mode="promise_in_bounds")                        # [Q, nbx, bw, d]
        Mg = Mg.reshape(Q, nbx * bw, d)
        sc = jnp.einsum("qd,qnd->qn", R.astype(Mg.dtype), Mg,
                        preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)

        if bias is not None:    # already in staged order (permuted above)
            a = (alpha if alpha is not None
                 else jnp.ones((Q,), jnp.float32))[:, None]
            ent_safe = jnp.minimum(ent_idx, E - 1)
            sc = sc + a * bias.astype(jnp.float32)[ent_safe]
        sc = jnp.where(valid, sc, -jnp.inf)

        # Final selection over the candidates, then positions -> entity ids
        # arithmetically (pos = b*bw + l within the candidate layout; a
        # take_along_axis gather over ent_idx costs more than the
        # selection).
        top_s, pos = hierarchical_topk(sc, k)
        sel_bin = jnp.take_along_axis(bi, pos // bw, axis=1)      # [Q, k]
        return top_s, sel_bin * bw + pos % bw

    if 0 < adaptive_bins < nb:
        top_s1, top_i1 = rescore_select(adaptive_bins)
        theta = top_s1[:, -1]
        # Acceptance slack: bin_vals carry the PREFILTER dtype's rounding
        # while theta is fp32-rescored, so an unrescored bin whose TRUE max
        # sits within that rounding of theta could round BELOW it and be
        # wrongly skipped — the same class of reshuffle pad_bins absorbs in
        # bin selection needs an explicit margin here (there is no pad to
        # hide behind: acceptance is a hard cut). 2^-7 relative doubles the
        # documented ~4e-3 bf16 model for product-rounding headroom; the
        # fp32 prefilter still gets a tiny re-association allowance. A too-
        # wide margin only costs a fallback to the full rescore, never
        # exactness.
        eps = 2.0 ** -7 if prep.Mp.dtype == jnp.bfloat16 else 2.0 ** -20
        scale = jnp.maximum(jnp.abs(bin_vals[:, 0]), jnp.abs(theta))
        need_more = jnp.any(
            bin_vals[:, adaptive_bins:] >= (theta - eps * scale)[:, None])
        top_s, top_i = jax.lax.cond(
            need_more,
            lambda _: rescore_select(nb),
            lambda _: (top_s1, top_i1), None)
    else:
        top_s, top_i = rescore_select(nb)
    if prep.perm is not None:   # undo the clustered staging permutation
        top_i = prep.perm[jnp.minimum(top_i, E - 1)]
    return top_s, top_i


def exact_topk(R: jax.Array, M: jax.Array,
               bias: Optional[jax.Array] = None,
               alpha: Optional[jax.Array] = None,
               k: int = 100, pad_bins: int = 12,
               te: int = SPAN, sweep: Optional[str] = None,
               interpret: Optional[bool] = None,
               rescore_dtype: str = "float32",
               ) -> Tuple[jax.Array, jax.Array]:
    """One-shot convenience: prepare_entities + exact_topk_prepared."""
    prep = prepare_entities(M, te=te, rescore_dtype=rescore_dtype)
    return exact_topk_prepared(R, prep, bias, alpha, k=k, pad_bins=pad_bins,
                               sweep=sweep, interpret=interpret)
