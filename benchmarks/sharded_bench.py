"""BASELINE.json configuration 5: 10M-entity brute-force scoring at a fixed
memory budget.

One card: the entity matrix lives in bf16 (2.5GB at 10M x 128) and the
engine never materializes [Q, E] scores (exact_topk keeps only bin maxima).
Several cards: the same sweep runs per shard under
parallel.distributed_topk with an all-gather or ppermute-ring merge —
validated numerically in tests/test_parallel.py and on four cards by
``chip_smoke.py --four``.
"""

from __future__ import annotations

import os
import statistics
import sys
import time
from typing import Dict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure_10m(
    num_entities: int = 10_000_000,
    dim: int = 128,
    num_queries: int = 256,
    k: int = 1000,
    iters: int = 10,
    seed: int = 0,
) -> Dict[str, float]:
    import jax
    import jax.numpy as jnp
    from sert_tpu.ops.exact_topk import exact_topk_prepared, prepare_entities

    # Build the matrix directly in bf16 on device, in slabs, to keep peak
    # memory at ~2x matrix size (10M x 128 fp32 would already be 5GB).
    key = jax.random.key(seed)
    slabs = []
    slab_rows = num_entities // 8
    for i in range(8):
        key, sub = jax.random.split(key)
        slabs.append(jax.random.normal(sub, (slab_rows, dim), jnp.bfloat16))
    M = jnp.concatenate(slabs, axis=0)
    del slabs
    prep = prepare_entities(M, rescore_dtype="bfloat16")
    jax.block_until_ready(prep.M_binned)

    key, sub = jax.random.split(key)
    R = jax.random.normal(sub, (num_queries, dim), jnp.float32)

    sweep = jax.jit(lambda R: exact_topk_prepared(R, prep, k=k))
    jax.block_until_ready(sweep(R))  # compile
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(sweep(R))
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    return {
        "entities_per_sec": num_queries * num_entities / dt,
        "sec_per_sweep": dt,
        "num_entities": num_entities,
        "num_queries": num_queries,
        "k": k,
        "matrix_bytes": int(num_entities * dim * 2),
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "device_count": jax.device_count(),
    }


if __name__ == "__main__":
    import json
    print(json.dumps(measure_10m(), indent=2))
