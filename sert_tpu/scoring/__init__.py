"""L5 scoring: the dense entity-embedding matrix engine.

The reference's query path (SURVEY.md section 4.3) scored EVERY entity per
query with a compiled (d x |E|) matmul and host-side argsort. Here the engine
is built for an accelerator and for entity counts far beyond the
reference's ~3.5k:

  * ``dense_scores`` — exact [Q, E] scores under jit (small/medium E).
  * ``streaming_topk`` — a ``lax.scan`` over entity chunks with a running
    top-k merge and (for log-linear) online logsumexp normalization, so
    million-entity collections are scored at fixed memory.
  * ``score_topics`` — topics -> TREC run dict glue.

The distributed variant (entity matrix sharded over the mesh) lives in
sert_tpu/parallel; the exact bin-max engine and its fused sweep kernel in
sert_tpu/ops.
"""

from sert_tpu.scoring.scorer import dense_scores, streaming_topk  # noqa: F401
from sert_tpu.scoring.run import score_topics  # noqa: F401
