"""The compiled train step.

The reference built a Theano loss graph with adagrad/adam update rules and
compiled it once per run (SURVEY.md section 4.2). Here: one pure function (params, opt_state, rng) x batch -> (new state, metrics),
jitted with donated state so XLA updates parameters in place in device
memory.

The same step function is reused by the distributed path — parallel/ wraps it
in shardings rather than rewriting it (SURVEY.md section 3.3).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from sert_tpu.models import api
from sert_tpu.utils.config import ModelConfig, TrainConfig


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: jax.Array          # int32 scalar
    rng: jax.Array           # PRNG key consumed for negative sampling


def release_opt_state(state: TrainState) -> TrainState:
    """Free the optimizer state's device buffers; returns the state with
    ``opt_state=()``.

    For train-then-score in one process at large E this is the difference
    between fitting and OOM: adam's mu/nu over a [10M, 128] entity table is
    ~5 GB that the scoring engine's staging would otherwise have to coexist
    with (the round-5 10M run hit exactly this). Call it after the final
    checkpoint is written — the returned state can score but NOT resume."""
    for leaf in jax.tree_util.tree_leaves(state.opt_state):
        delete = getattr(leaf, "delete", None)
        if delete is not None:
            try:
                delete()
            except Exception:  # already donated/deleted buffers
                pass
    return state._replace(opt_state=())


def check_optimizer_model_fit(model_cfg: ModelConfig,
                              train_cfg: TrainConfig) -> None:
    """Warn on the measured adafactor/LSE footgun.

    adafactor's factored second moment assumes dense per-step gradients
    (true for the full-softmax families, where dW touches every entity
    column every step). LSE's sampled objective updates only the gathered
    positive/negative rows, so the row/column statistics pool over columns
    that mostly saw zero gradient and infrequent rows get mis-scaled steps.
    Measured on the 200k-entity stress: NDCG@100 0.46-0.52 vs adam's 0.89.
    adam/adagrad keep per-parameter state and are the right fit for sparse
    NCE updates.
    """
    if (train_cfg.optimizer == "adafactor" and model_cfg.model == "lse"):
        import warnings
        warnings.warn(
            "optimizer='adafactor' with the sampled-objective LSE model is "
            "a measured quality trap (NDCG 0.46-0.52 vs adam's 0.89 on the "
            "200k stress — factored second-moment statistics mis-scale "
            "sparse negative-sampling updates). Use "
            "optimizer='adam' for LSE; adafactor fits the dense-gradient "
            "families (loglinear, lse_full).",
            UserWarning, stacklevel=3)
    if (train_cfg.optimizer == "adagrad" and model_cfg.model == "lse"
            and model_cfg.num_entities >= 100_000):
        import warnings
        warnings.warn(
            "optimizer='adagrad' with LSE degrades with scale and is "
            "MEASURED chance-level on the 1M-entity stress (loss pinned "
            "at ln(E) across lr 0.02-0.5, dense and lazy alike, while "
            "adam trains to NDCG 0.77; tiny-scale adagrad reaches only "
            "0.79 vs adam's 0.98). Use "
            "optimizer='adam' for LSE at scale.",
            UserWarning, stacklevel=3)


def make_lr(cfg: TrainConfig):
    """The learning rate as optax consumes it: a float for the constant
    no-warmup case (reference semantics), else a schedule callable
    step_index -> lr. Peak is ``learning_rate``; see TrainConfig for the
    schedule/warmup/horizon fields. Kept separate from make_optimizer so
    the row-sparse lazy step can evaluate the SAME schedule at
    ``state.step`` (optax's count and state.step both count completed
    updates, so the values align exactly)."""
    peak, w = cfg.learning_rate, cfg.lr_warmup_steps
    if cfg.lr_schedule == "constant":
        if w <= 0:
            return peak
        return optax.schedules.join_schedules(
            [optax.schedules.linear_schedule(0.0, peak, w),
             optax.schedules.constant_schedule(peak)], [w])
    if cfg.lr_schedule not in ("cosine", "linear"):
        raise ValueError(f"unknown lr_schedule: {cfg.lr_schedule!r}")
    total = cfg.lr_decay_steps
    if total <= 0:
        raise ValueError(
            f"lr_schedule={cfg.lr_schedule!r} needs lr_decay_steps > 0; "
            "the train loop fills it from num_epochs x batches/epoch — set "
            "it explicitly when building a step outside the loop")
    end = cfg.lr_final_fraction * peak
    if cfg.lr_schedule == "cosine":
        return optax.schedules.warmup_cosine_decay_schedule(
            init_value=0.0 if w > 0 else peak, peak_value=peak,
            warmup_steps=w, decay_steps=total, end_value=end)
    decay = optax.schedules.linear_schedule(peak, end, max(total - w, 1))
    if w <= 0:
        return decay
    return optax.schedules.join_schedules(
        [optax.schedules.linear_schedule(0.0, peak, w), decay], [w])


def make_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    """adagrad / adam / sgd — the reference's optimizer menu (SURVEY.md
    section 3.1 'Optimizers'), plus optional global-norm clipping and
    decoupled weight decay."""
    lr = make_lr(cfg)
    if cfg.optimizer == "adam":
        opt = optax.adam(lr)
    elif cfg.optimizer == "adagrad":
        opt = optax.adagrad(
            lr,
            initial_accumulator_value=getattr(
                cfg, "adagrad_init_accumulator", 0.1),
            eps=getattr(cfg, "adagrad_eps", 1e-7))
    elif cfg.optimizer == "sgd":
        opt = optax.sgd(lr)
    elif cfg.optimizer == "adafactor":
        # Large-E option beyond the reference's adam/adagrad menu: the
        # second moment of the [d, E] matrices is stored FACTORED (row [d]
        # + col [E] instead of dense [d, E]), so optimizer-state traffic
        # per step is O(d + E) instead of O(d * E).
        # Momentum stays off (adafactor default) to keep state O(d + E).
        opt = optax.adafactor(lr,
                              # SERT-style fixed lr semantics: disable the
                              # relative-scale/update-clipping extras so lr
                              # sweeps behave like the other optimizers.
                              multiply_by_parameter_scale=False,
                              clipping_threshold=None)
    else:
        raise ValueError(f"unknown optimizer: {cfg.optimizer!r}")
    chain = []
    if cfg.grad_clip_norm > 0:
        chain.append(optax.clip_by_global_norm(cfg.grad_clip_norm))
    chain.append(opt)
    if cfg.weight_decay > 0:
        chain.append(optax.add_decayed_weights(-cfg.weight_decay))
    return optax.chain(*chain) if len(chain) > 1 else chain[0]


def init_state(rng: jax.Array, model_cfg: ModelConfig,
               train_cfg: TrainConfig,
               sparse_override: Optional[bool] = None) -> TrainState:
    """``sparse_override`` pins the opt_state flavor regardless of what the
    config resolves to — loaders pass ``checkpoint.has_sparse_opt_state`` so
    templates always match the file on disk (checkpoints written before the
    sparse path existed hold dense optax state even for configs that now
    resolve to sparse, and vice versa)."""
    if (getattr(train_cfg, "lr_schedule", "constant") != "constant"
            and train_cfg.lr_decay_steps <= 0):
        # State CONSTRUCTION never evaluates the schedule (optax init only
        # allocates the count leaf), so loaders building shape templates
        # from a recipe whose horizon the train loop fills lazily must not
        # trip make_lr's horizon check here.
        import dataclasses
        train_cfg = dataclasses.replace(
            train_cfg, lr_decay_steps=train_cfg.lr_warmup_steps + 1)
    k_params, k_train = jax.random.split(rng)
    params = api.init_params(k_params, model_cfg)
    from sert_tpu.train import sparse
    use_sparse = (sparse.sparse_enabled(model_cfg, train_cfg)
                  if sparse_override is None else bool(sparse_override))
    if use_sparse:
        opt_state = sparse.init_sparse_opt_state(params, train_cfg)
    else:
        opt_state = make_optimizer(train_cfg).init(params)
    return TrainState(params=params, opt_state=opt_state,
                      step=jnp.zeros((), jnp.int32), rng=k_train)


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                    noise: Optional[jax.Array] = None, jit: bool = True,
                    loss_fn=None):
    """Build the (optionally jitted) train step closure.

    ``noise``: negative-sampling logits over entities (LSE only); closed over
    as a constant so it lives on-device across steps.

    ``loss_fn``: override with api.loss_fn's signature — the sharded path
    substitutes the shard_map-fused sampled softmax here
    (parallel/fused_loss.py).

    With ``train_cfg.steps_per_call > 1`` the returned function takes a
    STACKED batch (leading axis = micro-steps) and scans the step inside one
    compiled call; metrics are the final micro-step's.
    """
    check_optimizer_model_fit(model_cfg, train_cfg)
    from sert_tpu.train import sparse
    if loss_fn is None and sparse.sparse_enabled(model_cfg, train_cfg):
        # Lazy per-row optimizer path for the sampled LSE objectives —
        # same step contract (train/sparse.py). A loss_fn override (the
        # sharded fused path) or an inapplicable config keeps the dense
        # step below.
        return sparse.make_sparse_train_step(model_cfg, train_cfg,
                                             noise=noise, jit=jit)
    opt = make_optimizer(train_cfg)
    if loss_fn is None:
        loss_fn = api.loss_fn

    def step(state: TrainState, batch: Dict[str, jax.Array]
             ) -> Tuple[TrainState, Dict[str, jax.Array]]:
        rng, sub = jax.random.split(state.rng)
        # The closed-over noise is an embedded constant; WITHOUT a barrier
        # XLA constant-folds the sampling pipeline built on it (softmax +
        # cumsum over [E]) at COMPILE time, superlinearly in E — measured
        # 16s of fold at E=65k on CPU, and superlinear beyond. The barrier keeps the (trivial) cumsum at
        # runtime instead.
        nz = (jax.lax.optimization_barrier(noise)
              if noise is not None else None)
        loss, grads = jax.value_and_grad(loss_fn)(
            state.params, batch, model_cfg, rng=sub, noise=nz)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        new_state = TrainState(params=params, opt_state=opt_state,
                               step=state.step + 1, rng=rng)
        metrics = {"loss": loss,
                   "grad_norm": optax.global_norm(grads)}
        return new_state, metrics

    n = train_cfg.steps_per_call
    if n > 1:
        inner = step

        def step(state: TrainState, stacked: Dict[str, jax.Array]
                 ) -> Tuple[TrainState, Dict[str, jax.Array]]:
            state, metrics = jax.lax.scan(inner, state, stacked)
            return state, jax.tree.map(lambda m: m[-1], metrics)

    if not jit:
        return step
    donate = (0,) if train_cfg.donate_state else ()
    return jax.jit(step, donate_argnums=donate)
