"""Query serving: the scorer staged once behind a reusable searcher.

The reference toolkit's only query surface was a batch CLI (topics file ->
run file; SURVEY.md section 4.3). Production deployment also needs a
long-lived server process: load once, stage the entity matrix on-device
once, answer free-text queries repeatedly with no per-query compile or
re-staging. This module provides that as

  * :class:`EntitySearcher` — the load/stage/warmup lifecycle plus a
    thread-safe ``search(text)``; for LSE models, ``add_entities`` folds
    NEW entities into the live index without retraining (the projection
    f applies to any text — models.lse.fold_in_entity);
  * :func:`serve_stdin` — the reference-style interactive loop
    (one query per line, ranked entities out), used by ``serve``;
  * :func:`make_http_server` — a dependency-free JSON HTTP API on the
    stdlib ``ThreadingHTTPServer`` (GET /healthz, GET|POST /search),
    used by ``serve --http PORT``.

Device dispatches are serialized by a lock: JAX dispatch is thread-safe,
but serializing keeps per-query latency predictable instead of letting
concurrent requests queue arbitrarily deep on one card.

Concurrent requests MICRO-BATCH instead of queueing one dispatch each:
the engine's dispatch cost is nearly batch-size-invariant up to
query_batch, so
``search``/``search_many`` submit into a shared queue-drain batcher — the
first free thread becomes the leader, drains every request that arrived
while the previous dispatch was in flight, and answers them all with ONE
engine call. A lone request still dispatches immediately (no collect
window, no added latency); coalescing happens exactly when there is
contention to amortize.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from sert_tpu.scoring.run import MAX_QUERY_TERMS as _MAX_QUERY_TERMS
from sert_tpu.utils.config import RecipeConfig
from sert_tpu.utils.logging import get_logger

log = get_logger("serving")


class _BatchReq:
    """One submission to the micro-batcher: a list of encoded queries
    (empty list = all-OOV placeholder, answered ``None``) and the caller's
    clamped k. Filled in by whichever thread leads the dispatch."""

    __slots__ = ("ids_list", "k", "results", "error", "done")

    def __init__(self, ids_list, k):
        self.ids_list = ids_list
        self.k = k
        self.results = None
        self.error = None
        self.done = False


class EntitySearcher:
    """Load a trained run and answer ranked-entity queries repeatedly.

    Loads checkpoint + vocab + entity registry, resolves the scoring
    engine, stages the entity matrix once (exact engine), and fires one
    warm-up dispatch so the first real query does not pay the compile.
    """

    def __init__(self, recipe: RecipeConfig, data_dir: str, run_dir: str,
                 step: Optional[int] = None, k: int = 10,
                 query_batch: int = 16):
        from sert_tpu import pipeline
        from sert_tpu.data.instances import InstanceDataset
        from sert_tpu.scoring.run import resolve_engine, score_topics
        from sert_tpu.scoring.scorer import _entity_matrix

        ds = InstanceDataset(data_dir)
        self.recipe = pipeline.resolve_model_config(recipe, ds.meta)
        self.params, self.vocab, self.registry = pipeline.load_scorer(
            run_dir, data_dir, self.recipe, step=step)
        # Stage the engine at a k CAP (>= the default) so per-request k
        # overrides up to the cap are a free slice instead of a re-staged
        # engine; requests beyond the cap clamp to it. The cap honors BOTH
        # the constructor's k (e.g. EntitySearcher(k=1000) stages a
        # depth-1000 engine) and the recipe's own top_k (a recipe scored at
        # depth 1000 serves depth 1000), floored at 100 and clamped to E.
        E_total = len(self.registry.names)
        self.default_k = k
        self.k_max = min(max(k, 100, self.recipe.score.top_k), E_total)
        self.score_cfg = dataclasses.replace(
            self.recipe.score, top_k=self.k_max, query_batch=query_batch)
        self.num_entities = len(self.registry.names)
        self._score_topics = score_topics
        # RLock: fold-in holds it across its whole device sequence while
        # its probe re-enters _score (the module invariant is that ALL
        # device dispatches serialize through this one lock).
        self._lock = threading.RLock()
        self.prep = None
        engine = resolve_engine(self.score_cfg, self.num_entities)
        if engine == "exact":
            from sert_tpu import engines
            from sert_tpu.ops.exact_topk import prepare_entities
            rdt = engines.rescore_dtype(self.score_cfg.rescore_dtype,
                                        self.num_entities,
                                        self.recipe.model.entity_dim)
            self.prep = prepare_entities(
                _entity_matrix(self.params, self.recipe.model,
                               self.score_cfg.similarity),
                rescore_dtype=rdt, layout=self.score_cfg.layout)
        elif engine == "distributed":
            # Mesh placement + per-shard staging once, not per query
            # (score_topics otherwise re-stages the entity matrix per call).
            from sert_tpu.scoring.run import stage_distributed
            self.prep = stage_distributed(self.params, self.recipe.model,
                                          self.score_cfg)
            # Drop the pre-placement copy: score_topics only ever uses the
            # staged params on this path, and keeping both doubles HBM for
            # exactly the matrices the distributed engine exists for.
            self.params = self.prep.params
        # Folded-in entities (LSE only): names + vectors appended at serve
        # time without retraining; scored densely per query (n stays small)
        # and merged into the staged engine's top-k.
        self._extra_names: List[str] = []
        self._extra_vecs = None      # np.ndarray [n, d_e] or None
        self._extra_spans = None     # np.ndarray [n, 2]: (floor, top)
        self._extra_raw = None       # np.ndarray [n] bool: gradient fold-in
        # Micro-batcher state: pending requests + a single-leader flag,
        # guarded by one condition variable (see module docstring).
        self._bq_cond = threading.Condition()
        self._bq_pending: List[_BatchReq] = []
        self._bq_busy = False
        # Observability: dispatches = engine calls made by the batcher,
        # batched_queries = live queries answered, max_batch = largest
        # single-dispatch query count (loopback tests assert coalescing).
        self.stats = {"dispatches": 0, "batched_queries": 0, "max_batch": 0}
        self.data_dir = data_dir
        # Warm-up dispatch: compile happens here, not on the first query.
        self._score({"_warmup": self.vocab.encode(["warmup"])})

    def _score(self, encoded):
        return self._score_topics(self.params, self.recipe.model, encoded,
                                  self.registry.names, self.score_cfg,
                                  prep=self.prep)

    def encode(self, text: str) -> List[int]:
        """Query terms -> vocab ids with document preprocessing (OOV
        dropped, reference semantics)."""
        from sert_tpu.data.prepare import encode_queries
        return encode_queries({"q": text}, self.vocab, self.recipe.data)["q"]

    def search(self, text: str, k: Optional[int] = None
               ) -> Optional[List[Tuple[str, float]]]:
        """Ranked ``[(entity_name, score), ...]`` for a free-text query, or
        ``None`` when every query term is out of vocabulary (the caller
        distinguishes "no signal" from "low scores"). Concurrent callers
        coalesce into one engine dispatch (module docstring)."""
        ids = self.encode(text)
        if not ids:
            return None
        return self._submit([ids], self._clamp_k(k))[0]

    def search_many(self, texts: List[str], k: Optional[int] = None
                    ) -> List[Optional[List[Tuple[str, float]]]]:
        """Batched search: one device pipeline for all queries (the
        scorer batches query_batch topics per dispatch, so N queries cost
        far less than N search() calls). Positions whose
        query is entirely out of vocabulary come back as ``None``. Joins
        the same micro-batcher as ``search``, so concurrent multi-query
        posts coalesce too."""
        from sert_tpu.data.prepare import encode_queries
        encoded = encode_queries(
            {str(i): t for i, t in enumerate(texts)},
            self.vocab, self.recipe.data)
        ids_list = [encoded[str(i)] for i in range(len(texts))]
        if not any(ids_list):
            return [None] * len(texts)
        return self._submit(ids_list, self._clamp_k(k))

    # -- micro-batching (queue-drain): one engine call per contention burst --

    def _submit(self, ids_list: List[List[int]], kk: int
                ) -> List[Optional[List[Tuple[str, float]]]]:
        """Submit one request (N encoded queries; empty = OOV -> ``None``)
        and block until answered. The first thread to find no dispatch in
        flight drains the whole pending queue and answers it with one
        engine call; everyone else sleeps on the condition variable."""
        req = _BatchReq(ids_list, kk)
        batch = None
        with self._bq_cond:
            self._bq_pending.append(req)
            while not req.done and self._bq_busy:
                self._bq_cond.wait()
            if not req.done:
                self._bq_busy = True                # become the leader
                batch = self._bq_pending
                self._bq_pending = []
        if batch is not None:
            self._run_batch(batch)
        if req.error is not None:
            raise req.error
        return req.results

    def _answer(self, reqs: List[_BatchReq]) -> None:
        """Score every live query in ``reqs`` with one engine + merge
        dispatch at the staged k cap (per-request k is a free slice of
        that) and distribute results."""
        flat: List[List[int]] = []
        for r in reqs:
            flat.extend(ids for ids in r.ids_list if ids)
        merged = []
        if flat:
            keys = [str(i) for i in range(len(flat))]
            with self._lock:    # the one device-dispatch lock
                run = self._score(dict(zip(keys, flat)))
                merged = self._merge_extra_batch(
                    flat, [run[key] for key in keys], self.k_max)
        it = iter(merged)
        for r in reqs:
            r.results = [next(it)[:r.k] if ids else None
                         for ids in r.ids_list]
        self.stats["dispatches"] += 1
        self.stats["batched_queries"] += len(flat)
        self.stats["max_batch"] = max(self.stats["max_batch"], len(flat))

    def _run_batch(self, batch: List[_BatchReq]) -> None:
        """Leader path: answer the whole drained queue with one dispatch,
        wake the waiters. A coalesced dispatch failing must not surface one
        request's error to unrelated concurrent clients: on failure each
        request is retried ALONE, so only the offending request(s) see an
        exception (and transient device errors get a second chance)."""
        try:
            self._answer(batch)
        except (KeyboardInterrupt, SystemExit) as e:
            for r in batch:
                r.error = e
            raise
        except BaseException as e:
            if len(batch) == 1:
                batch[0].error = e
            else:               # pragma: no cover - isolation retry path
                for r in batch:
                    try:
                        self._answer([r])
                    except BaseException as e_r:
                        r.error = e_r
        finally:
            with self._bq_cond:
                self._bq_busy = False
                for r in batch:
                    r.done = True
                self._bq_cond.notify_all()

    # -- fold-in: add entities at serve time (LSE only) ----------------------

    def add_entities(self, items: List[Tuple[str, str]],
                     method: str = "affine") -> int:
        """Fold (name, associated-text) pairs into the live index WITHOUT
        retraining. Returns the number added. Raises ValueError for
        log-linear models (candidates exist only as trained columns), for
        duplicate names, for text with no in-vocab token, and for an
        unknown ``method``.

        ``method="affine"`` (fast path): the vector is the mean LSE
        projection of the text (models.lse.fold_in_entity — the CIKM
        paper's f applies to any window), plus an affine score map fitted
        at add time. The calibration is a measured necessity: f-images are
        mutually far more similar than trained NCE embeddings are to query
        projections — raw f-cosines of ~0.5 against UNRELATED queries would
        outrank every trained entity. The map sends the vector's background
        response (mean f-cosine against reps of random collection-frequency
        windows) to 0 and a perfect match to the trained index's own top
        score for the entity's text.

        ``method="gradient"`` (principled path): optimize the new entity's
        embedding against the FROZEN trained params on its own slice of
        the training NCE objective — its text windows as positives,
        lm_stats-synthesized background windows as negatives
        (models.lse.fold_in_entity_gradient). The result lives in the
        trained score geometry, so it merges raw, with no calibration map;
        a folded twin of a trained entity ranks within tolerance of the
        original (tests/test_foldin.py). Costs ~300 tiny optimizer steps
        per batch — one extra dispatch."""
        import numpy as np

        from sert_tpu.models import lse as lse_model

        if method not in ("affine", "gradient"):
            raise ValueError(f"unknown fold-in method {method!r}: "
                             "use 'affine' or 'gradient'")
        if not self.recipe.model.model.startswith("lse"):
            raise ValueError(
                "fold-in needs the LSE family: log-linear candidates exist "
                "only as learned projection columns — retrain to add them")
        for name, text in items:
            if not isinstance(name, str) or not isinstance(text, str):
                raise ValueError(
                    "add_entities items must be (str name, str text) pairs")
        if self.score_cfg.similarity != "cosine":
            log.warning(
                "fold-in under similarity=%r: calibration maps folded "
                "scores into [0, probe-top]; trained dot scores are "
                "unbounded, so cross-set ranking is approximate (cosine "
                "recipes are exact)", self.score_cfg.similarity)
        # Hold the lock across the whole device sequence (RLock: the probe
        # _score below re-enters it) — fold-in must serialize with searches
        # like every other dispatch, and the duplicate check must be atomic
        # with the append or concurrent adds could both pass it.
        with self._lock:
            taken = set(self.registry.names) | set(self._extra_names)
            vecs, names, probes = [], [], {}
            for name, text in items:
                if name in taken or name in names:
                    raise ValueError(f"entity name {name!r} already indexed")
                ids = self.encode(text)
                if not ids:
                    raise ValueError(
                        f"entity {name!r}: no in-vocab token in its text")
                if method == "gradient":
                    # The fold must live in the geometry the index was
                    # TRAINED in, which differs by objective (both paths
                    # measured on folded twins of trained entities,
                    # tests/test_foldin.py):
                    # * softmax-family (lse_full / sampled_softmax):
                    #   softmax CE drives each row toward the mean rep of
                    #   its own windows — the f-image IS the trained
                    #   direction (cos 0.94 to the true row at E=900;
                    #   running an optimizer on top only hurts, any
                    #   contrastive refit drifts to 0.27). Fold = f-image
                    #   rescaled to the population median norm, scored
                    #   raw.
                    # * binary NCE: the trained rows are margin
                    #   separators, NOT aligned with the rep cone (f-image
                    #   cos 0.07); refitting the entity's own slice of the
                    #   NCE objective against real collection windows
                    #   recovers the geometry (cos 0.93), then the
                    #   background-moment match places it in the
                    #   population.
                    mcfg = self.recipe.model
                    if (mcfg.model == "lse_full"
                            or mcfg.objective == "sampled_softmax"):
                        v = np.asarray(lse_model.fold_in_entity(
                            self.params, ids, mcfg,
                            window_size=self.recipe.data.window_size))
                        v = v * (self._trained_stats()[0]
                                 / max(float(np.linalg.norm(v)), 1e-9))
                    else:
                        v = np.asarray(lse_model.fold_in_entity_gradient(
                            self.params, ids, mcfg,
                            self._raw_negative_reps(ids),
                            window_size=self.recipe.data.window_size))
                        v = self._match_trained_moments(v)
                else:
                    v = np.asarray(lse_model.fold_in_entity(
                        self.params, ids, self.recipe.model,
                        window_size=self.recipe.data.window_size))
                    v = v / max(float(np.linalg.norm(v)), 1e-9)
                    # The probe is term-capped exactly like real queries
                    # are (pad_queries truncation), so `top` is the trained
                    # index's response to this content AS A QUERY — the
                    # scale searches actually happen on.
                    probes[name] = ids[:_MAX_QUERY_TERMS]
                names.append(name)
                vecs.append(v)
            if probes:   # affine calibration: ONE batched engine call
                # ``method`` is uniform per call, so probes is either all
                # names (affine) or empty (gradient) — names[j] pairs with
                # floors column j directly.
                run = self._score(probes)
                floors = self._background_reps() @ np.stack(vecs).T
            spans = []
            for j, name in enumerate(names):
                if name not in probes:   # gradient: raw trained-geometry
                    spans.append((0.0, 0.0))
                    continue
                probe = run[name]
                # A non-positive probe top means the trained index calls
                # this content noise; folded scores clamp to 0 there (a
                # negative scale would invert the folded ranking).
                top = max(float(probe[0][1]), 0.0) if probe else 0.0
                spans.append((float(floors[:, j].mean()), top))
            # vecs/spans/raw BEFORE names: entries only append, so a
            # concurrent reader pairing names[i] with vecs[i]/spans[i]
            # always sees a consistent prefix.
            stacked = np.stack(vecs)
            spn = np.asarray(spans, np.float64)
            raw = np.asarray([n not in probes for n in names], bool)
            self._extra_vecs = (stacked if self._extra_vecs is None else
                                np.concatenate([self._extra_vecs, stacked]))
            self._extra_spans = (spn if self._extra_spans is None else
                                 np.concatenate([self._extra_spans, spn]))
            self._extra_raw = (raw if self._extra_raw is None else
                               np.concatenate([self._extra_raw, raw]))
            self._extra_names = self._extra_names + names
        return len(names)

    def _background_reps(self, n_windows: int = 64, seed: int = 0,
                         raw: bool = False):
        """[n, d_e] reps of random background windows, sampled from the
        collection term distribution (lm_stats if present, else uniform
        vocab). Deterministic; computed once per variant. Unit-normalized
        by default (the affine calibration's cosine yardstick);
        ``raw=True`` returns 2048 UNNORMALIZED reps — the negative pool the
        gradient fold-in optimizes against, in training's raw-score
        geometry."""
        import numpy as np

        from sert_tpu.models import lse as lse_model
        attr = "_bg_reps_raw" if raw else "_bg_reps"
        if getattr(self, attr, None) is None:
            rng = np.random.default_rng(seed)
            wins = lens = None
            if raw:
                # The gradient fold-in discriminates against the ACTUAL
                # collection — sample real training windows (they carry
                # the sibling structure iid term draws cannot; measured on
                # the twin contract: corr 0.99 vs 0.96 for the synthesized
                # pool once self-overlap is filtered out, see
                # _raw_negative_reps), falling back to lm_stats synthesis
                # if the shards are gone.
                n_windows = max(n_windows, 2048)
                try:
                    from sert_tpu.data.instances import InstanceDataset
                    shard = InstanceDataset(self.data_dir).shard_paths[0]
                    z = np.load(shard)
                    take = min(n_windows, z["windows"].shape[0])
                    sel = rng.choice(z["windows"].shape[0], size=take,
                                     replace=False)
                    wins = z["windows"][np.sort(sel)].astype(np.int32)
                    lens = z["lengths"][np.sort(sel)].astype(np.int32)
                except (FileNotFoundError, KeyError, IndexError):
                    pass
            if wins is None:
                V = len(self.vocab)
                w = self.recipe.data.window_size
                try:
                    from sert_tpu.models.lm import load_lm
                    lm, _, _ = load_lm(self.data_dir)
                    p = lm.stats.collection_counts.astype(np.float64)
                    p = p / p.sum() if p.sum() > 0 else None
                except (FileNotFoundError, ValueError):
                    p = None
                wins = rng.choice(V, size=(n_windows, w), p=p).astype(
                    np.int32)
                lens = np.full(n_windows, w, np.int32)
            reps = np.asarray(lse_model.window_rep(
                self.params, wins, lens, self.recipe.model))
            if not raw:
                # np.asarray of a jax array is a read-only view: divide
                # OUT of place.
                reps = reps / np.maximum(
                    np.linalg.norm(reps, axis=-1, keepdims=True), 1e-9)
            else:
                self._bg_raw_pool = (wins, lens)
            setattr(self, attr, reps)
        return getattr(self, attr)

    def _raw_negative_reps(self, entity_term_ids):
        """The gradient fold-in's negative pool for ONE entity: the cached
        raw background reps MINUS windows that are mostly the entity's own
        text. A real-window pool contains the new entity's positives
        whenever its text (or a twin's) already occurs in the collection;
        using them as negatives repels the embedding from its own
        direction — measured on the folded-twin contract as corr 0.93
        unfiltered vs 0.99 with this filter (>50% in-text terms dropped).
        Keeps a floor of the 64 least-overlapping windows so pathological
        corpora (every window overlaps) never yield an empty pool."""
        import numpy as np
        reps = self._background_reps(raw=True)
        pool = getattr(self, "_bg_raw_pool", None)
        if pool is None:        # synthesized fallback pool: iid draws carry
            return reps         # no entity structure to contaminate
        wins, lens = pool
        member = np.isin(wins, np.fromiter(entity_term_ids, np.int32))
        valid = np.arange(wins.shape[1])[None, :] < lens[:, None]
        frac = (member & valid).sum(1) / np.maximum(lens, 1)
        keep = frac <= 0.5
        if keep.sum() < min(64, len(frac)):
            keep = frac <= np.partition(frac, 63)[63] if len(frac) > 64 \
                else np.ones_like(keep)
        return reps[keep]

    def _trained_stats(self, sample: int = 4096):
        """Population statistics of the trained entity rows (sampled — the
        matrix can be sharded and 10M rows tall), cached: (median row
        norm, median per-row mean background cosine). The yardsticks a
        gradient-folded vector is matched against."""
        import numpy as np

        if getattr(self, "_trained_stats_cache", None) is None:
            E = self.num_entities
            idx = np.linspace(0, E - 1, num=min(sample, E)).astype(np.int64)
            rows = np.asarray(self.params["entity_emb"][idx], np.float32)
            norms = np.linalg.norm(rows, axis=-1)
            rows_n = rows / np.maximum(norms[:, None], 1e-9)
            neg = self._background_reps(raw=True)
            neg_n = neg / np.maximum(
                np.linalg.norm(neg, axis=-1, keepdims=True), 1e-9)
            bg = (neg_n @ rows_n.T).mean(axis=0)       # per-row bg mean cos
            self._trained_stats_cache = (float(np.median(norms)),
                                         float(np.median(bg)))
        return self._trained_stats_cache

    def _match_trained_moments(self, v):
        """Place a gradient-folded vector in the trained POPULATION.

        Two measured mismatches remain after the NCE fit (both checked on
        a folded twin of a trained entity, tests/test_foldin.py):

        * background response: NCE pushes unrelated responses below ~0 but
          not as anti-correlated as training's sibling competition made
          the real rows (bg-cos −0.43 vs the population's −0.53), so a
          folded entity floats ~5-10 ranks high on unrelated queries.
          Fix: shift v against the mean background direction until its
          mean background cosine equals the trained rows' median
          (monotonic in the shift — bisection; the shift also tightens
          direction agreement with the true row, 0.90 → 0.91 cos).
        * norm: full-batch adam converges the free-norm optimum ~3x past
          where SGD left the trained rows, which would inflate
          dot-similarity scores. Fix: rescale to the population median
          norm (no-op for cosine recipes).
        """
        import numpy as np

        norm_med, bg_target = self._trained_stats()
        neg = self._background_reps(raw=True)
        neg_n = neg / np.maximum(
            np.linalg.norm(neg, axis=-1, keepdims=True), 1e-9)
        u = neg_n.mean(axis=0)
        u = u / max(float(np.linalg.norm(u)), 1e-9)
        vn = v / max(float(np.linalg.norm(v)), 1e-9)

        def bg(a):
            w = vn - a * u
            w = w / max(float(np.linalg.norm(w)), 1e-9)
            return float((neg_n @ w).mean())

        lo, hi = 0.0, 4.0
        if bg(lo) > bg_target:          # only shift DOWN toward the target
            for _ in range(30):
                mid = 0.5 * (lo + hi)
                if bg(mid) > bg_target:
                    lo = mid
                else:
                    hi = mid
            vn = vn - 0.5 * (lo + hi) * u
            vn = vn / max(float(np.linalg.norm(vn)), 1e-9)
        return vn * norm_med

    @property
    def num_extra_entities(self) -> int:
        return len(self._extra_names)

    def _merge_extra_batch(self, ids_list, hits_list, kk):
        """Score the folded-in entities for a BATCH of queries (f-image
        cosine, affinely calibrated per entity — see add_entities) and
        merge into each query's engine hits. One window_rep dispatch for
        the whole batch; caller holds the lock. Query ids are term-capped
        exactly like the engine caps them, so trained and folded entities
        are ranked against the same query."""
        names, vecs = self._extra_names, self._extra_vecs   # prefix-stable
        spans, raw_mask = self._extra_spans, self._extra_raw
        if not names:
            return [h[:kk] for h in hits_list]
        import numpy as np

        from sert_tpu.models import lse as lse_model
        capped = [ids[:_MAX_QUERY_TERMS] for ids in ids_list]
        Q = len(capped)
        T = max(max(len(c) for c in capped), 1)
        t = np.zeros((Q, T), np.int32)
        n_t = np.zeros((Q,), np.int32)
        for i, c in enumerate(capped):
            t[i, :len(c)] = c
            n_t[i] = len(c)
        reps_raw = np.asarray(lse_model.window_rep(
            self.params, t, n_t, self.recipe.model))         # [Q, d_e]
        reps = reps_raw / np.maximum(
            np.linalg.norm(reps_raw, axis=-1, keepdims=True), 1e-9)
        n = min(len(names), vecs.shape[0], spans.shape[0], raw_mask.shape[0])
        vecs_n = vecs[:n] / np.maximum(
            np.linalg.norm(vecs[:n], axis=-1, keepdims=True), 1e-9)
        cos = reps @ vecs_n.T                                # [Q, n]
        floor, top = spans[:n, 0], spans[:n, 1]
        side = (np.maximum(cos - floor[None, :], 0.0)
                / np.maximum(1.0 - floor[None, :], 1e-9) * top[None, :])
        # Gradient-folded entities live in the trained geometry: score them
        # exactly as the engine scores trained rows (cosine or raw dot),
        # no calibration map.
        if raw_mask[:n].any():
            raw_side = (cos if self.score_cfg.similarity == "cosine"
                        else reps_raw @ vecs[:n].T)
            side = np.where(raw_mask[:n][None, :], raw_side, side)
        out = []
        for qi, hits in enumerate(hits_list):
            merged = list(hits) + list(zip(names[:n], side[qi].tolist()))
            merged.sort(key=lambda e: -e[1])
            out.append(merged[:kk])
        return out

    def _clamp_k(self, k: Optional[int]) -> int:
        """Requested k -> [1, k_max]; None and non-positive values (a
        negative slice would return ~everything) fall back to the default."""
        if k is None or k < 1:
            return min(self.default_k, self.k_max)
        return min(k, self.k_max)


def serve_stdin(searcher: EntitySearcher, in_stream, out_stream) -> None:
    """One query per line ('qid<TAB>text' or bare text); ranked entities as
    'qid<TAB>rank<TAB>entity<TAB>score' lines; empty line or EOF exits."""
    qn = 0
    for line in in_stream:
        line = line.rstrip("\n")
        if not line.strip():
            break
        if "\t" in line:
            qid, text = line.split("\t", 1)
        else:
            qn += 1
            qid, text = f"q{qn}", line
        hits = searcher.search(text)
        if hits is None:
            print(f"{qid}\t-\t-\t-\t# all terms out of vocabulary",
                  file=out_stream, flush=True)
            continue
        for rank, (name, score) in enumerate(hits, 1):
            print(f"{qid}\t{rank}\t{name}\t{score:.6f}", file=out_stream)
        out_stream.flush()


def _hits_payload(query: str, hits) -> dict:
    if hits is None:
        return {"query": query, "results": [],
                "warning": "all query terms out of vocabulary"}
    return {"query": query,
            "results": [{"rank": r, "entity": name, "score": float(s)}
                        for r, (name, s) in enumerate(hits, 1)]}


def _search_payload(searcher: EntitySearcher, query: str,
                    k: Optional[int]) -> dict:
    return _hits_payload(query, searcher.search(query, k=k))


class _Handler(BaseHTTPRequestHandler):
    # set by make_http_server
    searcher: EntitySearcher = None

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # route through the package logger
        log.debug("http: " + fmt, *args)

    def do_GET(self):
        url = urlparse(self.path)
        if url.path == "/healthz":
            self._reply(200, {
                "status": "ok",
                "entities": self.searcher.num_entities,
                "extra_entities": self.searcher.num_extra_entities,
                "model": self.searcher.recipe.model.model,
                "vocab_size": len(self.searcher.vocab),
                "k_default": self.searcher.default_k,
                "k_max": self.searcher.k_max,
            })
            return
        if url.path == "/search":
            q = parse_qs(url.query)
            query = (q.get("q") or q.get("query") or [""])[0]
            if not query:
                self._reply(400, {"error": "missing q= parameter"})
                return
            try:
                k = int(q["k"][0]) if "k" in q else None
            except ValueError:
                self._reply(400, {"error": "k must be an integer"})
                return
            self._reply(200, _search_payload(self.searcher, query, k))
            return
        self._reply(404, {"error": f"unknown path {url.path!r}; "
                                   "use /healthz or /search"})

    def do_POST(self):
        url = urlparse(self.path)
        if url.path == "/entities":
            # Fold-in: {"entities": [{"name": ..., "text": ...}, ...],
            #           "method": "affine" (default) | "gradient"}
            try:
                n = max(int(self.headers.get("Content-Length", 0)), 0)
                req = json.loads(self.rfile.read(n) or b"{}")
                items = req.get("entities")
                method = req.get("method", "affine")
                if not isinstance(method, str):
                    raise ValueError("'method' must be a string")
                if (not isinstance(items, list) or not items
                        or not all(isinstance(e, dict)
                                   and isinstance(e.get("name"), str)
                                   and e.get("name")
                                   and isinstance(e.get("text"), str)
                                   and e.get("text") for e in items)):
                    raise ValueError(
                        "'entities' must be a non-empty list of "
                        "{name: str, text: str} objects")
                added = self.searcher.add_entities(
                    [(e["name"], e["text"]) for e in items], method=method)
            except (ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
                return
            self._reply(200, {
                "added": added,
                "extra_entities": self.searcher.num_extra_entities})
            return
        if url.path != "/search":
            self._reply(404, {"error": f"unknown path {url.path!r}"})
            return
        try:
            # max(0): a negative Content-Length would read-until-EOF and
            # park this handler thread on a held-open connection.
            n = max(int(self.headers.get("Content-Length", 0)), 0)
            req = json.loads(self.rfile.read(n) or b"{}")
            query = req.get("query") or req.get("q") or ""
            queries = req.get("queries")
            k = req.get("k")
            # bool is an int subclass; floats are rejected, matching the
            # GET path's "k must be an integer" instead of int(2.5) -> 2.
            if k is not None and (isinstance(k, bool)
                                  or not isinstance(k, int)):
                raise ValueError("k must be an integer")
        except (ValueError, json.JSONDecodeError) as e:
            self._reply(400, {"error": f"bad request body: {e}"})
            return
        if queries is not None:
            if (not isinstance(queries, list)
                    or not all(isinstance(q, str) for q in queries)):
                self._reply(400, {"error": "'queries' must be a list of "
                                           "strings"})
                return
            batches = self.searcher.search_many(queries, k=k)
            self._reply(200, {"batched": [
                _hits_payload(q, hits) for q, hits in zip(queries, batches)
            ]})
            return
        if not query:
            self._reply(400, {"error": "missing 'query' or 'queries' field"})
            return
        self._reply(200, _search_payload(self.searcher, query, k))


def make_http_server(searcher: EntitySearcher, host: str = "127.0.0.1",
                     port: int = 0) -> ThreadingHTTPServer:
    """Build (without starting) the HTTP server; ``port=0`` binds an
    ephemeral port (tests). Call ``serve_forever()`` / ``shutdown()``."""
    handler = type("BoundHandler", (_Handler,), {"searcher": searcher})
    return ThreadingHTTPServer((host, port), handler)
