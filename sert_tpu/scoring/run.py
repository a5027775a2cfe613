"""Topics -> TREC run glue: batch queries, score, emit ranked entity names.

Mirrors the reference query CLI (SURVEY.md section 4.3): tokenize/encode each
topic with the training vocabulary, score ALL entities, keep top-k, append to
a run dict. Queries are padded to a fixed term budget (static shapes under
jit); topics whose terms are all OOV yield empty result lists (they score 0
everywhere and would be noise).
"""

from __future__ import annotations

from typing import (Any, Dict, List, Mapping, NamedTuple, Optional, Sequence,
                    Tuple)

import jax
import jax.numpy as jnp
import numpy as np

from sert_tpu import engines
from sert_tpu.scoring.scorer import (_entity_matrix, dense_scores,
                                     exact_engine_topk, streaming_topk)
from sert_tpu.utils.config import ModelConfig, ScoreConfig

ENGINES = ("dense", "streaming", "exact", "approx", "distributed")


def resolve_engine(sc: ScoreConfig, num_entities: int) -> str:
    """Pick the scoring engine: an explicit ``sc.engine``, or for "auto"
    the choice of sert_tpu.engines.scoring_engine."""
    if sc.engine == "auto":
        return engines.scoring_engine(num_entities, sc.top_k,
                                      sc.entity_chunk)
    if sc.engine not in ENGINES:
        raise ValueError(f"unknown scoring engine {sc.engine!r}")
    return sc.engine


class DistStaged(NamedTuple):
    """The distributed engine's one-time staging: params placed on the mesh
    (entity axis over "model"), the per-shard exact-engine prep (when the
    local engine is exact), and the resolved local engine. Build once via
    :func:`stage_distributed` and pass as ``score_topics(..., prep=...)`` —
    re-placing the entity matrix and re-running prepare_distributed per call
    costs more than the sweep."""
    mesh: Any
    params: Any
    prep: Any
    local_engine: str


def stage_distributed(params, cfg: ModelConfig, sc: ScoreConfig) -> DistStaged:
    """Place params on the score mesh and stage the per-shard sweep operands
    for repeated ``engine="distributed"`` calls."""
    from sert_tpu.parallel.mesh import make_mesh
    from sert_tpu.parallel.sharding import state_shardings
    from sert_tpu.parallel.topk import resolve_local_engine
    mesh = make_mesh(sc.mesh_shape)
    sh = state_shardings(params, mesh, cfg)
    params = jax.tree.map(lambda x, s: jax.device_put(x, s), params, sh)
    local_engine = resolve_local_engine(sc.local_engine)
    prep = None
    if local_engine == "exact":
        from sert_tpu.parallel.topk import prepare_distributed
        prep = prepare_distributed(params, cfg, mesh,
                                   similarity=sc.similarity)
    return DistStaged(mesh, params, prep, local_engine)


# The engine's query-term budget (static shapes under jit): longer queries
# truncate. Serving imports this so folded-entity merging and calibration
# probes cap queries identically to the engine.
MAX_QUERY_TERMS = 16


def pad_queries(encoded: Mapping[str, Sequence[int]],
                max_terms: int = MAX_QUERY_TERMS,
                ) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """(qids, term_ids [Q, T], num_terms [Q]); long queries truncate to T."""
    qids = sorted(encoded)
    Q = len(qids)
    term_ids = np.zeros((Q, max_terms), np.int32)
    num_terms = np.zeros((Q,), np.int32)
    for i, qid in enumerate(qids):
        ids = list(encoded[qid])[:max_terms]
        term_ids[i, :len(ids)] = ids
        num_terms[i] = len(ids)
    return qids, term_ids, num_terms


def score_topics(
    params,
    cfg: ModelConfig,
    encoded_topics: Mapping[str, Sequence[int]],
    entity_names: Sequence[str],
    score_cfg: Optional[ScoreConfig] = None,
    max_terms: int = MAX_QUERY_TERMS,
    prep=None,
) -> Dict[str, List[Tuple[str, float]]]:
    """Score every topic against every entity; returns a TREC run dict
    {qid: [(entity_name, score), ...]} with top-k entries per topic.

    ``prep``: the engine's one-time staging, for repeated calls (the serve
    CLI passes it) — ops.exact_topk.prepare_entities for the exact engine,
    :func:`stage_distributed`'s result for the distributed engine. Without
    it each call re-stages (cast/pad, or mesh placement + per-shard prep),
    which costs more than the sweep."""
    sc = score_cfg or ScoreConfig()
    qids, term_ids, num_terms = pad_queries(encoded_topics, max_terms)
    E = len(entity_names)
    run: Dict[str, List[Tuple[str, float]]] = {qid: [] for qid in qids}

    engine = resolve_engine(sc, E)
    mesh = None
    if engine == "exact" and prep is None:
        from sert_tpu.ops.exact_topk import prepare_entities
        rdt = engines.rescore_dtype(sc.rescore_dtype, E, cfg.entity_dim)
        prep = prepare_entities(_entity_matrix(params, cfg, sc.similarity),
                                rescore_dtype=rdt, layout=sc.layout)
    elif engine == "distributed":
        staged = (prep if isinstance(prep, DistStaged)
                  else stage_distributed(params, cfg, sc))
        mesh, params = staged.mesh, staged.params
        prep, local_engine = staged.prep, staged.local_engine

    B = sc.query_batch
    k = min(sc.top_k, E)

    def dispatch(t, m):
        """Queue one device batch; returns device arrays WITHOUT syncing —
        all batches dispatch back-to-back so the device never waits on a
        host fetch between batches."""
        t, m = jnp.asarray(t), jnp.asarray(m)
        if engine == "exact":
            return exact_engine_topk(params, cfg, t, m, k=k,
                                     similarity=sc.similarity, prep=prep,
                                     normalize=sc.normalize_scores,
                                     adaptive_bins=sc.adaptive_bins)
        if engine == "dense":
            scores = dense_scores(params, cfg, t, m,
                                  similarity=sc.similarity)
            return jax.lax.top_k(scores, k)
        if engine == "approx":
            scores = dense_scores(params, cfg, t, m,
                                  similarity=sc.similarity)
            return jax.lax.approx_max_k(scores, k,
                                        recall_target=sc.recall_target)
        if engine == "distributed":
            from sert_tpu.parallel.topk import distributed_topk
            return distributed_topk(params, cfg, t, m, mesh, k=k,
                                    chunk=min(sc.entity_chunk, E),
                                    similarity=sc.similarity, merge=sc.merge,
                                    local_engine=local_engine, prep=prep)
        return streaming_topk(params, cfg, t, m, k=k, chunk=sc.entity_chunk,
                              similarity=sc.similarity)

    pending = []
    for lo in range(0, len(qids), B):
        hi = min(lo + B, len(qids))
        n = hi - lo
        # Pad the last batch to the static batch size.
        t = np.zeros((B, max_terms), np.int32)
        m = np.zeros((B,), np.int32)
        t[:n], m[:n] = term_ids[lo:hi], num_terms[lo:hi]
        pending.append((lo, n, m, dispatch(t, m)))

    for lo, n, m, (top_s, idx) in pending:
        top_s, idx = np.asarray(top_s), np.asarray(idx)   # sync point
        for qi in range(n):
            qid = qids[lo + qi]
            if m[qi] == 0:
                continue  # all-OOV query: no meaningful scores
            order = np.argsort(-top_s[qi], kind="stable")
            run[qid] = [(entity_names[idx[qi, j]], float(top_s[qi, j]))
                        for j in order]
    return run
