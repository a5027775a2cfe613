"""Entity-scoring throughput benchmark (the BASELINE.json headline metric).

Measures entities scored per second on a 1M-entity LSE matrix: Q queries x
E entities per engine call, timed after a warmup compile, each timed
iteration ending in ``block_until_ready`` (JAX returns before the device
finishes). The engine is the one ``ScoreConfig.engine="auto"`` selects
(sert_tpu/engines.py) unless named. Every result names the device it ran
on; bench.py refuses to report one that is not a GPU.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict

import numpy as np


def measure_entities_per_sec(
    num_entities: int = 1_000_000,
    dim: int = 128,
    num_queries: int = 256,
    num_terms: int = 4,
    vocab: int = 50_000,
    k: int = 100,
    chunk: int = 1 << 15,
    iters: int = 5,
    sweeps_per_iter: int = 10,
    model: str = "lse",
    seed: int = 0,
    engine: str = "auto",   # "auto" | "exact" | "streaming" | "dense"
) -> Dict[str, float]:
    """Median seconds per engine call over ``iters`` timed iterations of
    ``sweeps_per_iter`` back-to-back calls each."""
    import jax
    import jax.numpy as jnp
    from sert_tpu import engines
    from sert_tpu.models import api
    from sert_tpu.scoring.scorer import (_entity_matrix, dense_scores,
                                         exact_engine_topk, streaming_topk)
    from sert_tpu.utils.config import ModelConfig

    if engine == "auto":
        engine = engines.scoring_engine(num_entities, k, chunk)
    cfg = ModelConfig(model=model, vocab_size=vocab,
                      num_entities=num_entities, word_dim=dim,
                      entity_dim=dim)
    params = api.init_params(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    term_ids = jnp.asarray(
        rng.integers(0, vocab, size=(num_queries, num_terms)).astype(np.int32))
    num_terms_arr = jnp.asarray(np.full(num_queries, num_terms, np.int32))

    if engine == "exact":
        from sert_tpu.ops.exact_topk import prepare_entities
        prep = prepare_entities(_entity_matrix(params, cfg, "dot"))

        def call():
            return exact_engine_topk(params, cfg, term_ids, num_terms_arr,
                                     k=k, prep=prep)
    elif engine == "streaming":
        def call():
            return streaming_topk(params, cfg, term_ids, num_terms_arr,
                                  k=k, chunk=chunk)
    elif engine == "dense":
        def call():
            return jax.lax.top_k(dense_scores(params, cfg, term_ids,
                                              num_terms_arr), k)
    else:
        raise ValueError(f"unknown engine {engine!r}")

    jax.block_until_ready(call())  # compile
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        for _ in range(sweeps_per_iter):
            out = call()
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / sweeps_per_iter)
    dt = statistics.median(times)
    dev = jax.devices()[0]
    return {
        "entities_per_sec": num_queries * num_entities / dt,
        "sec_per_batch": dt,
        "num_entities": num_entities,
        "num_queries": num_queries,
        "k": k,
        "engine": engine,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": jax.device_count(),
    }


def measure_train_steps_per_sec(
    num_entities: int = 1100,
    vocab: int = 50_000,
    dim: int = 128,
    batch_size: int = 1024,
    window: int = 8,
    iters: int = 8,
    steps_per_call: int = 16,
    model: str = "loglinear",
    optimizer: str = "adam",
    compute_dtype: str = "float32",
    seed: int = 0,
) -> Dict[str, float]:
    """Steps/s: micro-steps scanned inside one compiled call
    (TrainConfig.steps_per_call, the shipped-recipe configuration), the
    timed window ending in block_until_ready on the whole state."""
    import jax
    from sert_tpu.train.step import init_state, make_train_step
    from sert_tpu.utils.config import ModelConfig, TrainConfig

    cfg = ModelConfig(model=model, vocab_size=vocab, num_entities=num_entities,
                      word_dim=dim, entity_dim=dim,
                      compute_dtype=compute_dtype)
    tcfg = TrainConfig(batch_size=batch_size, learning_rate=1e-3,
                       donate_state=True, optimizer=optimizer,
                       steps_per_call=steps_per_call)
    state = init_state(jax.random.key(seed), cfg, tcfg)
    step = make_train_step(cfg, tcfg)
    rng = np.random.default_rng(seed)
    lead = (steps_per_call,) if steps_per_call > 1 else ()
    batch = {
        "windows": rng.integers(0, vocab, size=lead + (batch_size, window)).astype(np.int32),
        "lengths": np.full(lead + (batch_size,), window, np.int32),
        "entities": rng.integers(0, num_entities, size=lead + (batch_size,)).astype(np.int32),
    }
    batch = {k_: jax.device_put(v) for k_, v in batch.items()}

    state, m = step(state, batch)  # compile
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = step(state, batch)
    jax.block_until_ready(state)
    dt = (time.perf_counter() - t0) / (iters * max(steps_per_call, 1))
    return {
        "steps_per_sec": 1.0 / dt,
        "instances_per_sec": batch_size / dt,
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
    }


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser(description="entity-scoring throughput")
    ap.add_argument("--entities", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--sweeps", type=int, default=50)
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--k", type=int, default=100)
    a = ap.parse_args()
    r = measure_entities_per_sec(
        num_entities=a.entities, num_queries=a.queries, iters=a.iters,
        sweeps_per_iter=a.sweeps, engine=a.engine, k=a.k)
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in r.items()}))
