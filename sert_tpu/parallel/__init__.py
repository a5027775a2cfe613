"""Distribution layer: mesh, shardings, sharded training, distributed top-k.

The reference was single-process/single-device (SURVEY.md section 3.3); every
parallelism here is new capability:

  * mesh axes ``("data", "model")``: batches shard over ``data`` (DP),
    the entity axis — SERT's only real scale axis — shards over ``model``
    (TP over the entity-embedding / candidate-space matrix).
  * training: GSPMD — params carry NamedShardings, the SAME pure step
    function from sert_tpu.train compiles under pjit, XLA inserts the
    psum/all-gather collectives (log-sum-exp over the sharded entity axis,
    DP gradient reduction).
  * scoring: explicit shard_map kernels — per-shard streaming top-k merged
    either by a small all_gather or by rotating winners around a device
    ring with ppermute (SURVEY.md section 6, long-context row: the
    ring/blockwise pattern applied to the entity axis).

Deliberately absent (documented, SURVEY.md section 8): pipeline, sequence,
Ulysses and expert parallelism — the models have no depth, no long
sequences, no heads, no experts.
"""

from sert_tpu.parallel.mesh import make_mesh  # noqa: F401
from sert_tpu.parallel.sharding import (  # noqa: F401
    batch_sharding,
    shard_state,
    state_shardings,
)
from sert_tpu.parallel.train import make_sharded_train_step  # noqa: F401
from sert_tpu.parallel.topk import distributed_topk  # noqa: F401
