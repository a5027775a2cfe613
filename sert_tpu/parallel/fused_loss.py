"""Mesh deployment of the flash sampled-softmax LSE loss.

Builds a loss with the api.loss_fn signature whose masked log-sum-exp over
the shared candidates runs through the Triton kernels (ops/sampled_lse.py)
per shard, stitched with one pmax + one psum, instead of the XLA
composition GSPMD would otherwise partition. parallel/train.py routes to it
whenever the fused sampled loss is selected on a multi-device mesh.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from sert_tpu.utils.config import ModelConfig


def make_sharded_sampled_loss(cfg: ModelConfig, mesh: Mesh,
                              data_axis: str = "data",
                              model_axis: str = "model"):
    """Mesh deployment of the fused sampled-softmax LSE objective.

    The flagship loss (models/lse.loss_sampled_softmax, SURVEY.md section
    3.1 sampled-objective row) shards cleanly on BOTH mesh axes: the batch
    rows over ``data`` and the shared candidate set over ``model``. Each
    device runs the single-device flash kernel (ops/sampled_lse) on its
    [B/dp, k/tp] block — the [B, k] corrected-logits array never exists
    anywhere — and the global masked lse is stitched with one pmax + one
    psum over the model axis.

    Transpose conventions: the body returns a
    PER-SHARD partial loss ([1], fully sharded) scaled by 1/n_model, so the
    shard_map transpose's replicated-axis psums (over ``model`` for
    reps/pos/s_pos, over ``data`` for cand/corr) are exactly the reductions
    the math needs and the kernel's custom VJP returns plain local grads.

    The pooling front, sampling pipeline, and entity-row gathers stay
    OUTSIDE shard_map (lse.sampled_softmax_inputs): word_emb is replicated,
    entity_emb is model-sharded, and GSPMD partitions the gathers/scatter-
    add with no manual collectives.

    Requires ``cfg.num_negatives`` divisible by the model axis (the recipes
    pick power-of-two k) and the batch divisible by the data axis (the
    feeder already emits mesh-divisible batches).
    """
    if cfg.model != "lse" or cfg.objective != "sampled_softmax":
        raise ValueError(
            "sharded fused sampled-lse applies to the lse family's "
            f"sampled_softmax objective only, got model={cfg.model!r} "
            f"objective={cfg.objective!r}")
    tp = mesh.shape[model_axis]
    if cfg.num_negatives % tp:
        raise ValueError(
            f"num_negatives={cfg.num_negatives} must divide the model axis "
            f"({tp}) for the sharded fused sampled-lse; pick a mesh-"
            "divisible candidate count")
    n_model = tp

    def _body(reps_l, cand_l, corr_l, ids_l, pos_l, s_pos_l):
        from sert_tpu.ops.sampled_lse import sampled_lse
        # Local masked lse over this shard's candidate slice. The
        # accidental-hit mask is per (row, candidate) so it is exact on
        # any slice; a slice whose every candidate is masked for a row
        # yields ~-1e30 and vanishes under the exp below.
        lse_l = sampled_lse(reps_l, cand_l, corr_l, ids_l, pos_l,
                            dtype=cfg.compute_dtype)               # [B/dp]
        m = jax.lax.pmax(jax.lax.stop_gradient(lse_l), model_axis)
        s = jax.lax.psum(jnp.exp(lse_l - m), model_axis)
        lse_g = m + jnp.log(s)                 # replicated over model
        # Per-shard partial: lse_g/s_pos are identical on every model
        # shard, so each contributes 1/n_model of its data-rows' sum and
        # the wrapper's global sum reassembles the batch total exactly.
        loc = jnp.sum(jax.nn.softplus(lse_g - s_pos_l)) / n_model
        return loc[None]

    # check_vma=False: pallas_call outputs carry no varying-axes metadata;
    # correctness is pinned by the mesh-vs-single-device value/grad parity
    # tests.
    mapped = jax.shard_map(
        _body, mesh=mesh,
        in_specs=(P(data_axis, None), P(model_axis, None), P(model_axis),
                  P(model_axis), P(data_axis), P(data_axis)),
        out_specs=P((data_axis, model_axis)),
        check_vma=False,
    )

    def loss_fn(params, batch, cfg_: ModelConfig, rng=None,
                noise: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        from sert_tpu.models import lse as lse_mod
        reps, cand, corr, negatives, pos, s_pos = \
            lse_mod.sampled_softmax_inputs(params, batch, cfg_, rng=rng,
                                           noise=noise)
        return jnp.sum(mapped(reps.astype(jnp.float32), cand, corr,
                              negatives.astype(jnp.int32),
                              pos.astype(jnp.int32), s_pos)) / pos.shape[0]

    return loss_fn
