"""Driver benchmark: prints ONE JSON line, on a GPU only.

Metric: entities scored per second per card with the engine that
``ScoreConfig.engine="auto"`` selects (sert_tpu/engines.py) on a 1M-entity
LSE matrix, 256 queries, k=100 — the BASELINE.json headline. The line names
the platform, device kind and device count it was measured on.
``vs_baseline`` is the ratio against the self-measured CPU baseline stored
in benchmarks/cpu_baseline.json (the reference never published throughput;
see BASELINE.md).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    import jax
    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"bench.py: needs a GPU; JAX found "
                         f"{jax.devices()[0].platform!r}")
    from sert_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    from benchmarks.score_bench import measure_entities_per_sec

    r = measure_entities_per_sec(num_entities=1_000_000, num_queries=256,
                                 k=100, iters=5, sweeps_per_iter=20)
    baseline_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "benchmarks", "cpu_baseline.json")
    with open(baseline_path) as fh:
        cpu = json.load(fh)["entities_per_sec"]
    print(json.dumps({
        "metric": "entities_scored_per_sec_per_card",
        "value": round(r["entities_per_sec"], 1),
        "unit": "entities/sec",
        "engine": r["engine"],
        "vs_baseline": round(r["entities_per_sec"] / cpu, 3),
        "device": {"platform": r["platform"], "kind": r["device_kind"],
                   "count": r["device_count"]},
    }))


if __name__ == "__main__":
    main()
