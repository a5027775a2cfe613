"""Every platform and size decision of the package, in one place.

The scoring engine, the sweep inside the exact engine, the sampled-softmax
loss and the rescore dtype are chosen here, from what the caller can
observe: the backend (GPU or not), the entity count E and depth k (scoring
engine), the shared-negative count k (loss), and the device's memory limit
(rescore dtype). The thresholds are crossovers measured at Q=64 / B=4096,
d=128 on one GPU model, an NVIDIA H100 80GB HBM3, by
``benchmarks/engine_bench.py`` (PERF.md, "Findings"); they are applied on
every GPU.

Kernels compile for the GPU only. A kernel called on another backend
raises unless the caller asked for the Pallas interpreter, by an explicit
``interpret=True`` or inside :func:`interpret_kernels` (the tests' switch).
Nothing infers interpret mode from the backend.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import jax

_interpret = False


@contextlib.contextmanager
def interpret_kernels() -> Iterator[None]:
    """Run every Pallas kernel called inside the block under the
    interpreter (CPU tests of the kernel paths)."""
    global _interpret
    prev, _interpret = _interpret, True
    try:
        yield
    finally:
        _interpret = prev


def interpret_default(interpret: Optional[bool]) -> bool:
    return _interpret if interpret is None else bool(interpret)


def on_gpu() -> bool:
    return jax.default_backend() == "gpu"


def kernels_available() -> bool:
    """True where the Pallas kernels run: compiled on a GPU, or under the
    interpreter when a test asked for it."""
    return on_gpu() or _interpret


def require_kernel_backend(interpret: bool, name: str) -> None:
    """Refuse to run a GPU kernel on a backend it cannot compile for."""
    if not interpret and not on_gpu():
        raise RuntimeError(
            f"the {name} kernel compiles for the GPU only (backend is "
            f"{jax.default_backend()!r}); pass interpret=True to run it "
            "under the Pallas interpreter")


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------

# Largest measured entity count at which the dense engine ([Q, E] scores +
# one lax.top_k) still beats the exact engine on the GPU, by depth. Measured
# at Q=64, d=128 on an H100 at E = 2^15, 2^17, 2^18, 2^19 and 10^6
# (benchmarks/engine_bench.py, PERF.md): at k=100 dense wins at 2^15 and
# exact from 2^17 up; at k=1000 dense wins through 2^18 and exact from 2^19
# (its rescore gather grows with k). Streaming lost at every point.
DENSE_MAX_ENTITIES_SHALLOW = 1 << 15     # k <= SHALLOW_DEPTH
DENSE_MAX_ENTITIES_DEEP = 1 << 18        # deeper
SHALLOW_DEPTH = 100


def scoring_engine(num_entities: int, top_k: int,
                   entity_chunk: int = 1 << 15) -> str:
    """The engine ``ScoreConfig.engine="auto"`` runs.

    On the GPU: dense up to the measured crossover for this depth, else
    the exact bin-max engine (fused sweep, top bins, exact rescore of
    those bins). Elsewhere: dense up to ``entity_chunk`` entities, then
    the fixed-memory streaming scan.
    """
    if on_gpu():
        limit = (DENSE_MAX_ENTITIES_SHALLOW if top_k <= SHALLOW_DEPTH
                 else DENSE_MAX_ENTITIES_DEEP)
        return "dense" if num_entities <= limit else "exact"
    return "dense" if num_entities <= entity_chunk else "streaming"


def binmax_sweep() -> str:
    """"triton" (the fused Pallas kernel) where kernels run, else "xla"
    (ops.score_binmax.binmax_reference)."""
    return "triton" if kernels_available() else "xla"


def local_engine() -> str:
    """Per-shard engine of distributed scoring ("auto")."""
    return "exact" if on_gpu() else "binmax"


def rescore_fp32_limit(bytes_limit: Optional[int] = None) -> Optional[int]:
    """Bytes the exact engine's fp32 rescore copy may take before "auto"
    stages it in bf16: an eighth of the device's memory limit, leaving the
    rest to the prefilter copy, the trained params and the sweep. None
    (no limit) where the device reports no memory limit (the CPU)."""
    if bytes_limit is None:
        stats = jax.devices()[0].memory_stats() or {}
        bytes_limit = stats.get("bytes_limit")
    return None if bytes_limit is None else int(bytes_limit) // 8


def rescore_dtype(choice: str, num_entities: int, dim: int,
                  bytes_limit: Optional[int] = None) -> str:
    """Resolve ``ScoreConfig.rescore_dtype``: "auto" is fp32 while the
    fp32 copy fits :func:`rescore_fp32_limit`, else bf16."""
    if choice == "auto":
        limit = rescore_fp32_limit(bytes_limit)
        if limit is not None and num_entities * dim * 4 > limit:
            return "bfloat16"
        return "float32"
    if choice not in ("float32", "bfloat16"):
        raise ValueError(f"unknown rescore_dtype {choice!r}")
    return choice


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

# Smallest measured count of shared negatives at which the flash
# sampled-softmax kernel beats the same composition in XLA, fwd+bwd at
# B=4096, d=128, both with bf16 operands, on an H100 at k = 256, 1024,
# 2048, 4096, 8192, 32768 (benchmarks/engine_bench.py, PERF.md): XLA wins
# through k=2048, the kernel from k=4096.
SAMPLED_LSE_MIN_NEGATIVES = 4096


def fused_sampled_lse(fused_softmax: str, num_negatives: int) -> bool:
    """Whether the sampled-softmax loss runs the flash kernel
    (ops/sampled_lse.py): "on"/"off" force it, "auto" takes it on the GPU
    from SAMPLED_LSE_MIN_NEGATIVES shared negatives."""
    if fused_softmax == "on":
        return True
    if fused_softmax == "off":
        return False
    if fused_softmax != "auto":
        raise ValueError(f"unknown fused_softmax {fused_softmax!r}")
    return kernels_available() and num_negatives >= SAMPLED_LSE_MIN_NEGATIVES
