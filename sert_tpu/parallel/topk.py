"""Distributed top-k over the mesh-sharded entity matrix.

Each ``model``-axis device owns a contiguous row-block of the entity matrix
and runs the SAME chunked sweep as the single-chip engine
(sert_tpu.scoring.scorer.chunked_topk_core); only the merge differs:

  * ``"allgather"`` — every device all-gathers the [Q, k] per-shard winners
    (k is small) and locally re-top-ks. One collective, minimal latency.
  * ``"ring"`` — the running top-k carry rotates around the device ring via
    ``ppermute``, merging against each resident shard's winners; after S-1
    hops every device holds the global top-k. Same systolic pattern as ring
    attention, applied to the entity axis (SURVEY.md section 6) — preferable
    when Q*k is large enough that one big all-gather would spike memory.

The log-linear normalizer needs GLOBAL per-term logsumexp: local
(max, sumexp) accumulators combine with a pmax/psum pair before the constant
is applied — exactness is preserved across shardings (tested against the
single-device engine).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from sert_tpu import engines
from sert_tpu.models import api
from sert_tpu.scoring.scorer import (HIGHEST, _entity_matrix,
                                     _query_reps_and_terms,
                                     apply_ll_normalizer, chunked_topk_core,
                                     lse_chunk_update)
from sert_tpu.utils.config import ModelConfig


def _merge_topk(s_a, i_a, s_b, i_b, k):
    s = jnp.concatenate([s_a, s_b], axis=1)
    i = jnp.concatenate([i_a, i_b], axis=1)
    new_s, sel = jax.lax.top_k(s, k)
    return new_s, jnp.take_along_axis(i, sel, axis=1)


def _local_lse(term_emb, mask, M_shard, bias_shard, chunk):
    """Online per-term (max, sumexp) over the LOCAL entity rows — the
    log-linear normalizer contribution of this shard, matmul-bound scan."""
    rows = M_shard.shape[0]
    Q, T = mask.shape
    n_chunks = max(-(-rows // chunk), 1)
    pad = n_chunks * chunk - rows
    M_p = jnp.pad(M_shard, ((0, pad), (0, 0)))
    b_p = jnp.pad(bias_shard, (0, pad))

    def body(carry, ci):
        run_max, run_sum = carry
        lo = ci * chunk
        Mc = jax.lax.dynamic_slice_in_dim(M_p, lo, chunk, axis=0)
        bc = jax.lax.dynamic_slice_in_dim(b_p, lo, chunk)
        z = jnp.einsum("qtd,cd->qtc", term_emb.astype(jnp.float32), Mc,
                       precision=HIGHEST) + bc
        z = jnp.where(((lo + jnp.arange(chunk)) < rows)[None, None, :], z,
                      -jnp.inf)
        return lse_chunk_update(run_max, run_sum, z), None

    init = (jnp.full((Q, T), -jnp.inf), jnp.zeros((Q, T), jnp.float32))
    init = tuple(jax.lax.pcast(x, ("data", "model"), to="varying")
                 for x in init)
    (run_max, run_sum), _ = jax.lax.scan(body, init, jnp.arange(n_chunks))
    return run_max, run_sum


def _local_binmax_topk(R, mask, M_shard, bias_shard, k, is_ll,
                       pad_bins=16, lanes=128):
    """Per-shard top-k via the bin-max prefilter, in partitionable XLA.

    Same algorithm as ops/exact_topk but with the local scores materialized
    once ([Q, rows_local] transient) so candidates are GATHERED from them
    instead of rescored — avoiding the giant top_k is the win on a mesh,
    where rows_local = E / n_shards keeps the transient modest. The XLA
    baseline the fused sweep (ops/score_binmax.py) is timed against. The
    fixed-memory
    alternative remains local_engine="scan"."""
    rows = M_shard.shape[0]
    Q = R.shape[0]
    pad = (-rows) % lanes
    M_p = jnp.pad(M_shard, ((0, pad), (0, 0)))
    z = jnp.dot(R.astype(jnp.float32), M_p.T, precision=HIGHEST,
                preferred_element_type=jnp.float32)          # [Q, rows_p]
    if is_ll:
        b_p = jnp.pad(bias_shard, (0, pad))
        alpha = jnp.sum(mask.astype(jnp.float32), axis=-1)   # |q| per query
        z = z + alpha[:, None] * b_p[None, :]
    col = jnp.arange(rows + pad)
    z = jnp.where(col[None, :] < rows, z, -jnp.inf)

    bins = jnp.max(z.reshape(Q, -1, lanes), axis=-1)         # [Q, n_bins]
    n_bins = bins.shape[1]
    k_local = min(k, rows)
    nb = min(k_local + pad_bins, n_bins)
    _, bin_idx = jax.lax.top_k(bins, nb)                     # [Q, nb]
    ent_idx = (bin_idx[:, :, None] * lanes
               + jnp.arange(lanes)[None, None, :]).reshape(Q, nb * lanes)
    safe = jax.lax.optimization_barrier(ent_idx)
    cand = jnp.take_along_axis(z, safe, axis=1)              # [Q, nb*lanes]
    top_s, sel = jax.lax.top_k(cand, k_local)
    top_i = jnp.take_along_axis(ent_idx, sel, axis=1)
    if k_local < k:  # tiny shard: pad to the global k for the merge
        top_s = jnp.pad(top_s, ((0, 0), (0, k - k_local)),
                        constant_values=-jnp.inf)
        top_i = jnp.pad(top_i, ((0, 0), (0, k - k_local)))
    return top_s, top_i


def _shard_body(R, term_emb, mask, M_shard, bias_shard, *prep_arrays,
                k, chunk, is_ll, merge, axis, local_engine, prep_te=None):
    """Runs on each model-axis device inside shard_map."""
    n_shards = jax.lax.axis_size(axis)
    my = jax.lax.axis_index(axis)
    rows = M_shard.shape[0]
    offset = my * rows

    if local_engine == "exact":
        # The single-card exact engine per shard: fused bin-max sweep +
        # exact rescore of the top bins (ops/exact_topk); scores never
        # materialize in device memory. The staged matrices
        # (prepare_distributed) arrive as extra sharded operands so
        # repeated sweeps do not re-cast/pad the matrix.
        from sert_tpu.ops.exact_topk import PreparedEntities, exact_topk_prepared
        Mp_l, Mb_l = prep_arrays
        prep = PreparedEntities(Mp_l, Mb_l, rows, M_shard.shape[1],
                                Mb_l.shape[1], prep_te)
        alpha = (jnp.sum(mask.astype(jnp.float32), axis=-1) if is_ll
                 else None)
        k_local = min(k, rows)
        top_s, top_i = exact_topk_prepared(
            R.astype(jnp.float32), prep,
            bias=bias_shard.astype(jnp.float32) if is_ll else None,
            alpha=alpha, k=k_local)
        if k_local < k:  # tiny shard: pad to the global k for the merge
            top_s = jnp.pad(top_s, ((0, 0), (0, k - k_local)),
                            constant_values=-jnp.inf)
            top_i = jnp.pad(top_i, ((0, 0), (0, k - k_local)))
        run_max = run_sum = None
        if is_ll:
            run_max, run_sum = _local_lse(term_emb, mask, M_shard,
                                          bias_shard, chunk)
    elif local_engine == "binmax":
        top_s, top_i = _local_binmax_topk(R, mask, M_shard, bias_shard, k,
                                          is_ll)
        run_max = run_sum = None
        if is_ll:
            run_max, run_sum = _local_lse(term_emb, mask, M_shard,
                                          bias_shard, chunk)
    elif local_engine == "scan":
        top_s, top_i, run_max, run_sum = chunked_topk_core(
            R, term_emb, mask, M_shard, bias_shard, k, chunk, is_ll,
            vary_axes=("data", "model"))
    else:
        raise ValueError(f"unknown local engine {local_engine!r}")
    top_i = top_i + offset

    if is_ll:
        # Global per-term logsumexp: combine local (max, sumexp) pairs.
        g_max = jax.lax.pmax(run_max, axis)
        g_sum = jax.lax.psum(run_sum * jnp.exp(run_max - g_max), axis)
        run_max, run_sum = g_max, g_sum

    if merge == "allgather":
        all_s = jax.lax.all_gather(top_s, axis)          # [S, Q, k]
        all_i = jax.lax.all_gather(top_i, axis)
        S, Q, K = all_s.shape
        cand_s = jnp.moveaxis(all_s, 0, 1).reshape(Q, S * K)
        cand_i = jnp.moveaxis(all_i, 0, 1).reshape(Q, S * K)
        top_s, sel = jax.lax.top_k(cand_s, k)
        top_i = jnp.take_along_axis(cand_i, sel, axis=1)
    elif merge == "ring":
        # Rotate a carry of winners around the ring; each hop merges the
        # incoming carry with the local winners. After S-1 hops every
        # device's carry saw every shard.
        perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
        carry_s, carry_i = top_s, top_i
        for _ in range(n_shards - 1):
            carry_s = jax.lax.ppermute(carry_s, axis, perm)
            carry_i = jax.lax.ppermute(carry_i, axis, perm)
            carry_s, carry_i = _merge_topk(carry_s, carry_i, top_s, top_i, k)
        top_s, top_i = carry_s, carry_i
    else:
        raise ValueError(f"unknown merge strategy {merge!r}")

    if is_ll:
        top_s = apply_ll_normalizer(top_s, run_max, run_sum, mask)
    return top_s, top_i


def resolve_local_engine(local_engine: str) -> str:
    """'auto' -> engines.local_engine(). The ONE resolver shared by
    distributed_topk and scoring.run.stage_distributed — if they resolved
    independently, the serve path could stage prep for a different engine
    than direct calls sweep with."""
    if local_engine == "auto":
        return engines.local_engine()
    return local_engine


def prepare_distributed(params, cfg: ModelConfig, mesh: Mesh,
                        similarity: str = "dot", te: Optional[int] = None,
                        rescore_dtype: str = "float32",
                        prefilter_dtype: str = "bfloat16"):
    """Stage the entity matrix for repeated ``local_engine="exact"`` sweeps:
    per-shard prepare_entities under shard_map, with the padded prefilter and
    bin-major rescore views returned as model-axis-sharded globals. Pass the
    result as ``distributed_topk(..., prep=...)`` — one-time cost, exactly
    like the single-card prepare_entities/exact_engine_topk pairing."""
    from sert_tpu.ops.exact_topk import PreparedEntities, prepare_entities
    from sert_tpu.ops.score_binmax import SPAN
    te = te or SPAN

    M = _entity_matrix(params, cfg, similarity)
    E, d = M.shape
    tp = mesh.shape["model"]
    if E % tp:
        raise ValueError(f"num_entities={E} must divide by model axis {tp}")

    def body(M_shard):
        p = prepare_entities(M_shard, te=te, rescore_dtype=rescore_dtype,
                             prefilter_dtype=prefilter_dtype)
        return p.Mp, p.M_binned

    Mp, Mb = jax.shard_map(
        body, mesh=mesh, in_specs=(P("model", None),),
        out_specs=(P("model", None), P("model", None, None)),
        check_vma=False)(M)
    return PreparedEntities(Mp, Mb, E // tp, d, Mb.shape[1], te)


def distributed_topk(params, cfg: ModelConfig, term_ids: jax.Array,
                     num_terms: jax.Array, mesh: Mesh, k: int = 100,
                     chunk: int = 32768, similarity: str = "dot",
                     merge: str = "allgather",
                     local_engine: str = "auto",
                     prep=None
                     ) -> Tuple[jax.Array, jax.Array]:
    """Global top-k over an entity matrix sharded on mesh axis ``model``.

    Queries shard over ``data``; every entity shard sees every query in its
    data-row. Entity count must divide evenly by the model-axis size (pad
    the entity matrix upstream if not — recipes do).

    ``local_engine``: "auto" (engines.local_engine), "exact" (the fused
    bin-max sweep + exact rescore per shard — the single-card engine,
    SURVEY.md section 4.3), "binmax" (same exact prefilter
    algorithm in partitionable XLA, O(Q * E/n_shards) transient) or "scan"
    (fixed-memory chunked sweep with per-chunk top-k merges).
    """
    local_engine = resolve_local_engine(local_engine)
    E = api.entity_matrix(params, cfg).shape[0]
    k = min(k, E)
    n_model = mesh.shape["model"]
    if E % n_model:
        raise ValueError(f"num_entities={E} must divide by model axis {n_model}")

    R, term_emb, mask = _query_reps_and_terms(params, cfg, term_ids,
                                              num_terms, similarity)
    M = _entity_matrix(params, cfg, similarity)
    is_ll = cfg.model == "loglinear"
    bias = params["proj_b"].astype(jnp.float32) if is_ll else jnp.zeros((E,), jnp.float32)
    if term_emb is None:
        term_emb = jnp.zeros(mask.shape + (1,), jnp.float32)  # placeholder

    in_specs = [P("data", None), P("data", None, None), P("data", None),
                P("model", None), P("model")]
    args = [R, term_emb, mask, M, bias]
    prep_te = None
    if local_engine == "exact":
        if prep is None:
            prep = prepare_distributed(params, cfg, mesh,
                                       similarity=similarity)
        prep_te = prep.te   # static: the sweep tile Mp was padded for
        in_specs += [P("model", None), P("model", None, None)]
        args += [prep.Mp, prep.M_binned]
    body = functools.partial(_shard_body, k=k, chunk=chunk, is_ll=is_ll,
                             merge=merge, axis="model",
                             local_engine=local_engine, prep_te=prep_te)
    # check_vma=False: after the all_gather/ring merge every model-axis
    # device holds the same winners, but the static varying-axes analysis
    # cannot see through top_k to infer that replication.
    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(P("data", None), P("data", None)),
        check_vma=False,
    )
    return fn(*args)
