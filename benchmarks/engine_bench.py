"""The crossovers of sert_tpu/engines.py, measured on one card.

1. Scoring engines, dense vs streaming vs exact: for each entity count E
   and depth k, one engine call (Q=64 unit query vectors against E unit
   entity vectors, cosine scoring as the flagship) -> scoring_engine's
   thresholds.
2. The sampled-softmax loss, flash kernel vs the same composition in XLA
   (ops.sampled_lse.sampled_lse_reference), fwd + bwd at B=4096, d=128,
   both with bf16 operands and fp32 accumulation, for a ladder of
   shared-negative counts k -> SAMPLED_LSE_MIN_NEGATIVES.

Alternating, steady-state medians, each timed call ending in
block_until_ready.

    python benchmarks/engine_bench.py [--entities 32768 262144 1000000]

Needs a GPU; prints the card's name and power limit beside the numbers.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--entities", type=int, nargs="+",
                    default=[1 << 15, 1 << 17, 1 << 18, 1 << 19,
                             1_000_000])
    ap.add_argument("--depths", type=int, nargs="+", default=[100, 1000])
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--negatives", type=int, nargs="+",
                    default=[256, 1024, 2048, 4096, 8192, 32768])
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from chip_smoke import _normalized, alternate, check_device
    from sert_tpu.ops.exact_topk import exact_topk_prepared, prepare_entities
    from sert_tpu.scoring.scorer import HIGHEST, chunked_topk_core
    from sert_tpu.utils.cache import enable_compilation_cache

    dev = check_device(jax.devices())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(f"device {dev.device_kind}; nvidia-smi: {smi.stdout.strip()}")
    enable_compilation_cache()
    Q, d = args.queries, 128
    mask = jnp.ones((Q, 1), bool)
    streaming = jax.jit(lambda R, M, k: chunked_topk_core(
        R, None, mask, M, None, k, 1 << 15, False)[:2], static_argnums=2)
    dense = jax.jit(lambda R, M, k: jax.lax.top_k(
        jnp.dot(R, M.T, precision=HIGHEST), k), static_argnums=2)
    for E in args.entities:
        k1, k2 = jax.random.split(jax.random.key(E))
        M, R = _normalized(k1, (E, d)), _normalized(k2, (Q, d))
        prep = prepare_entities(M)
        for k in args.depths:
            t = alternate({
                "dense": lambda: dense(R, M, k),
                "streaming": lambda: streaming(R, M, k),
                "exact": lambda: exact_topk_prepared(R, prep, k=k)},
                rounds=5, iters=10)
            best = min(t, key=t.get)
            print(f"E={E} k={k} Q={Q}: " + " | ".join(
                f"{n} {v * 1e3:.4f} ms" for n, v in t.items())
                + f" -> {best}", flush=True)
        del M, R, prep

    from sert_tpu.ops.sampled_lse import sampled_lse, sampled_lse_reference
    B = 4096
    for K in args.negatives:
        ks = jax.random.split(jax.random.key(K), 4)
        reps = jnp.tanh(jax.random.normal(ks[0], (B, d)))
        cand = jax.random.normal(ks[1], (K, d)) / d ** 0.5
        corr = jax.random.normal(ks[2], (K,))
        ids = jax.random.randint(ks[3], (K,), 0, 1_000_000)
        pos = jnp.arange(B, dtype=jnp.int32)

        def fwd_bwd(f):
            return jax.jit(jax.grad(lambda r, c, co: jnp.sum(f(
                r, c, co, ids, pos, "bfloat16")), argnums=(0, 1, 2)))

        g_kernel, g_xla = fwd_bwd(sampled_lse), fwd_bwd(sampled_lse_reference)
        t = alternate({"kernel": lambda: g_kernel(reps, cand, corr),
                       "xla": lambda: g_xla(reps, cand, corr)},
                      rounds=5, iters=10)
        print(f"sampled loss fwd+bwd B={B} k={K} d={d}: kernel "
              f"{t['kernel'] * 1e3:.4f} ms | xla {t['xla'] * 1e3:.4f} ms",
              flush=True)


if __name__ == "__main__":
    main()
