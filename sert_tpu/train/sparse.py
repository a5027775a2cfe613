"""Row-sparse (lazy) optimizer path for sampled-objective LSE training.

Motivation (the 1M stress): with E=1M entities the
sampled-softmax gradient touches only B + k entity rows and <= B*w word
rows per step, but ``jax.grad`` materializes DENSE [E, d] / [V, d]
gradient arrays (the scatter-add transpose of the gathers) and optax's
dense adam then reads and rewrites the full moment pair — gigabytes of
HBM traffic per step at E=1M, d=128 that carries no information. This
module computes gradients with respect to the GATHERED rows only,
combines duplicate rows with a sort + segment-sum, and applies lazy
per-row optimizer updates via scatter, so optimizer traffic scales with
the rows actually visited (~(B + k + B*w) rows) instead of with V + E.

Lazy semantics ("skip rows whose gradient this step is zero"):

* sgd / adagrad: results IDENTICAL to the dense update — their update is
  exactly zero wherever the gradient is zero (adagrad's accumulator only
  grows on touched rows). tests/test_train_sparse.py checks leaf-exact
  parity over multiple steps.
* adam: identical for rows touched this step; UNTOUCHED rows keep their
  momentum frozen instead of continuing to decay-drift (the standard
  LazyAdam semantics). Parity tests cover the every-row-touched regime
  where lazy == dense exactly; quality at scale is covered by the
  stress-harness bands.

Applies to ``model="lse"`` with ``objective in ("nce",
"sampled_softmax")`` — the families whose per-step gradients are sparse
by construction (SURVEY.md section 1, model family 2: negative sampling
is what makes LSE scale). The full-softmax families have dense dW every
step and keep the fused-kernel dense path (train/step.py). Single-device
path only: on a mesh the scatter/gather pattern would force GSPMD
collectives per step; the sharded step stays dense (parallel/train.py).

Enable via ``TrainConfig.sparse_update`` ("auto" turns it on exactly for
the applicable configurations).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from sert_tpu.models import lse as lse_model
from sert_tpu.models.common import compute_dtype
from sert_tpu.utils.config import ModelConfig, TrainConfig

_DENSE_KEYS = ("proj_w", "proj_b")
_SPARSE_KEYS = ("word_emb", "entity_emb")


def sparse_applicable(model_cfg: ModelConfig, train_cfg: TrainConfig) -> bool:
    """True when the lazy path exists AND matches dense semantics closely
    enough to be the default (see module docstring)."""
    return (
        model_cfg.model == "lse"
        and model_cfg.objective in ("nce", "sampled_softmax")
        and train_cfg.optimizer in ("adam", "adagrad", "sgd")
        and train_cfg.weight_decay == 0.0
        and tuple(train_cfg.mesh_shape) == (1, 1)
    )


def sparse_enabled(model_cfg: ModelConfig, train_cfg: TrainConfig) -> bool:
    mode = getattr(train_cfg, "sparse_update", "auto")
    if mode == "off":
        return False
    if mode == "auto":
        # adagrad/sgd lazy updates are BIT-IDENTICAL to dense, so auto
        # enables them freely. Lazy adam is standard-lazy (untouched rows
        # skip their momentum decay between visits) — measured on the 1M
        # hard-mode stress that costs 0.034 NDCG@100 / 0.089 recall@100
        # (docs/QUALITY.md), so
        # auto keeps adam dense; "on" still forces lazy adam.
        return (train_cfg.optimizer != "adam"
                and sparse_applicable(model_cfg, train_cfg))
    if mode == "on":
        if not sparse_applicable(model_cfg, train_cfg):
            raise ValueError(
                "sparse_update='on' requires model='lse' with a sampled "
                "objective, optimizer in (adam, adagrad, sgd), "
                "weight_decay=0, and mesh_shape=(1, 1); got "
                f"model={model_cfg.model!r} objective={model_cfg.objective!r} "
                f"optimizer={train_cfg.optimizer!r} "
                f"weight_decay={train_cfg.weight_decay} "
                f"mesh={tuple(train_cfg.mesh_shape)}")
        return True
    raise ValueError(f"unknown sparse_update mode: {mode!r}")


# ---------------------------------------------------------------------------
# Row bookkeeping


def _dedup_rows(ids: jax.Array, grads: jax.Array,
                num_rows: int) -> Tuple[jax.Array, jax.Array]:
    """Combine duplicate row ids: sort + run-boundary segment-sum.

    ``ids`` int32[N], ``grads`` [N, d] (per-SLOT gradients — duplicates not
    yet combined, exactly what autodiff yields for a gather). Returns
    (ids_safe int32[N], g_u [N, d]) where slot j < n_unique holds the j-th
    distinct id with its summed gradient, and every slot >= n_unique holds
    ``num_rows`` (one past the last row) with zero gradient — so callers
    scatter with ``mode="drop"`` and need no separate mask. The summed
    gradients equal the dense scatter-add's rows bit-for-bit up to
    reassociation (segment_sum accumulates in the grad dtype).
    """
    n = ids.shape[0]
    order = jnp.argsort(ids)
    sid = ids[order]
    gs = grads[order]
    first = jnp.concatenate(
        [jnp.ones((1,), bool), sid[1:] != sid[:-1]])
    seg = jnp.cumsum(first) - 1                                   # [N]
    g_u = jax.ops.segment_sum(gs, seg, num_segments=n)
    ids_u = jnp.full((n,), num_rows, sid.dtype).at[seg].set(sid)
    return ids_u, g_u


def _row_state_init(params, train_cfg: TrainConfig) -> Dict:
    """Per-row optimizer state for the sparse params — same shapes and
    dtypes optax would allocate densely (zeros_like / full_like), so the
    checkpoint layout stays pytree-generic."""
    out = {}
    acc0 = getattr(train_cfg, "adagrad_init_accumulator", 0.1)
    for k in _SPARSE_KEYS:
        p = params[k]
        if train_cfg.optimizer == "adam":
            out[k] = {"m": jnp.zeros_like(p), "v": jnp.zeros_like(p)}
        elif train_cfg.optimizer == "adagrad":
            out[k] = {"acc": jnp.full_like(p, acc0)}  # optax scale_by_rss
        else:                                         # sgd: stateless
            out[k] = {}
    return out


def _row_update(train_cfg: TrainConfig, param: jax.Array, st: Dict,
                ids_safe: jax.Array, g_u: jax.Array, lr: float,
                t: jax.Array) -> Tuple[jax.Array, Dict]:
    """Apply one lazy optimizer step to the rows named by ``ids_safe``.

    Mirrors optax's arithmetic exactly (scale_by_adam / scale_by_rss /
    sgd) so the parity tests can demand leaf equality; sentinel ids
    (== param.shape[0]) gather row 0 harmlessly and are DROPPED at
    scatter."""
    optimizer = train_cfg.optimizer
    E = param.shape[0]
    ids_g = jnp.minimum(ids_safe, E - 1)          # safe gather; drop later
    if optimizer == "sgd":
        upd = (-lr * g_u.astype(jnp.float32)).astype(param.dtype)
        return param.at[ids_safe].add(upd, mode="drop"), st
    if optimizer == "adagrad":
        acc_rows = st["acc"][ids_g]
        acc_new = acc_rows + jnp.square(g_u)
        eps = getattr(train_cfg, "adagrad_eps", 1e-7)
        inv = jnp.where(acc_new > 0,
                        jax.lax.rsqrt(acc_new.astype(jnp.float32) + eps),
                        0.0)
        upd = (-lr * g_u.astype(jnp.float32) * inv).astype(param.dtype)
        return (param.at[ids_safe].add(upd, mode="drop"),
                {"acc": st["acc"].at[ids_safe].set(
                    acc_new.astype(st["acc"].dtype), mode="drop")})
    # adam (optax scale_by_adam: b1=0.9, b2=0.999, eps=1e-8, eps_root=0)
    b1, b2, eps = 0.9, 0.999, 1e-8
    tf = t.astype(jnp.float32)
    m_new = b1 * st["m"][ids_g] + (1.0 - b1) * g_u
    v_new = b2 * st["v"][ids_g] + (1.0 - b2) * jnp.square(g_u)
    m_hat = m_new.astype(jnp.float32) / (1.0 - jnp.power(b1, tf))
    v_hat = v_new.astype(jnp.float32) / (1.0 - jnp.power(b2, tf))
    upd = (-lr * m_hat / (jnp.sqrt(v_hat) + eps)).astype(param.dtype)
    return (param.at[ids_safe].add(upd, mode="drop"),
            {"m": st["m"].at[ids_safe].set(m_new.astype(st["m"].dtype),
                                           mode="drop"),
             "v": st["v"].at[ids_safe].set(v_new.astype(st["v"].dtype),
                                           mode="drop")})


# ---------------------------------------------------------------------------
# The loss on gathered rows (mirrors models/lse.py on the same math)


def _forward(dense_p, word_rows, ent_rows, batch, negatives, corr,
             cfg: ModelConfig) -> jax.Array:
    """LSE sampled loss as a function of the GATHERED embedding rows.

    Numerically identical to models/lse.loss / loss_sampled_softmax (the
    dtype casts commute with the gathers); autodiff through this gives
    per-row cotangents instead of dense scatter-adds. ``corr`` is the
    precomputed importance correction logq[negatives] + log k
    (sampled_softmax) or None (nce).
    """
    ct = compute_dtype(cfg)
    from sert_tpu.models.common import masked_mean_pool
    pooled = masked_mean_pool(word_rows.astype(ct),
                              batch["lengths"])                 # [B, dw]
    h = jnp.dot(pooled, dense_p["proj_w"].astype(ct),
                preferred_element_type=jnp.float32)
    reps = jnp.tanh(h + dense_p["proj_b"].astype(jnp.float32))  # [B, de]

    B = reps.shape[0]
    ent = ent_rows.astype(jnp.float32)
    pos_vec = ent[:B]
    s_pos = jnp.sum(reps * pos_vec, axis=-1)                    # [B]
    if cfg.objective == "sampled_softmax":
        cand = ent[B:]                                          # [k, de]
        s_neg = (jnp.dot(reps, cand.T, preferred_element_type=jnp.float32)
                 - corr[None, :])                               # [B, k]
        hit = negatives[None, :] == batch["entities"][:, None]
        s_neg = jnp.where(hit, -1e30, s_neg)
        lse_all = jax.scipy.special.logsumexp(
            jnp.concatenate([s_pos[:, None], s_neg], axis=1), axis=-1)
        return jnp.mean(lse_all - s_pos)
    # nce: per-example binary negative sampling
    neg_vec = ent[B:].reshape(B, cfg.num_negatives, -1)         # [B, k, de]
    s_neg = jnp.einsum("bd,bkd->bk", reps, neg_vec)
    ll = (jax.nn.log_sigmoid(s_pos)
          + jnp.sum(jax.nn.log_sigmoid(-s_neg), axis=-1))
    return -jnp.mean(ll)


# ---------------------------------------------------------------------------
# State + step


def init_sparse_opt_state(params, train_cfg: TrainConfig) -> Dict:
    """{"dense": optax state over (proj_w, proj_b), "rows": per-row state}."""
    dense_p = {k: params[k] for k in _DENSE_KEYS}
    return {"dense": _dense_opt(train_cfg).init(dense_p),
            "rows": _row_state_init(params, train_cfg)}


def _dense_opt(train_cfg: TrainConfig) -> optax.GradientTransformation:
    # Bare optimizer: global-norm clipping is applied manually (the norm
    # must include the row grads), weight decay is rejected upstream.
    # make_lr threads any schedule through optax for the dense leaves;
    # the row path evaluates the same schedule at state.step (the counts
    # align — both count completed updates).
    from sert_tpu.train.step import make_lr
    lr = make_lr(train_cfg)
    if train_cfg.optimizer == "adam":
        return optax.adam(lr)
    if train_cfg.optimizer == "adagrad":
        return optax.adagrad(
            lr,
            initial_accumulator_value=getattr(
                train_cfg, "adagrad_init_accumulator", 0.1),
            eps=getattr(train_cfg, "adagrad_eps", 1e-7))
    return optax.sgd(lr)


def make_sparse_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                           noise: Optional[jax.Array] = None,
                           jit: bool = True):
    """Build the lazy-update train step (same contract as
    train.step.make_train_step, including steps_per_call scanning)."""
    from sert_tpu.train.step import TrainState

    if not sparse_applicable(model_cfg, train_cfg):
        raise ValueError("sparse step built for an inapplicable config; "
                         "see sparse_applicable")
    opt = _dense_opt(train_cfg)
    cfg = model_cfg
    from sert_tpu.train.step import make_lr
    lr_of = make_lr(train_cfg)   # float (constant) or schedule(step) -> lr
    E, V = cfg.num_entities, cfg.vocab_size

    def step(state: TrainState, batch):
        rng, sub = jax.random.split(state.rng)
        # Barrier EITHER way: a constant zeros fallback is just as
        # foldable as a closed-over noise table — XLA constant-folds the
        # softmax+cumsum sampling pipeline over [E] at compile time,
        # superlinearly in E (see train/step.py's identical guard).
        nz = jax.lax.optimization_barrier(
            noise if noise is not None else jnp.zeros((E,), jnp.float32))
        B = batch["windows"].shape[0]
        if cfg.objective == "sampled_softmax":
            negatives = lse_model.sample_negatives(sub, nz, 1, cfg)[0]  # [k]
            k = negatives.shape[0]
            logq = jax.nn.log_softmax(nz.astype(jnp.float32))
            corr = logq[negatives] + jnp.log(jnp.float32(k))
            ent_idx = jnp.concatenate([batch["entities"], negatives])
        else:
            negatives = lse_model.sample_negatives(sub, nz, B, cfg)  # [B, k]
            corr = None
            ent_idx = jnp.concatenate(
                [batch["entities"], negatives.reshape(-1)])

        params = state.params
        word_rows = params["word_emb"][batch["windows"]]     # [B, w, dw]
        ent_rows = params["entity_emb"][ent_idx]             # [B(+...)k, de]
        dense_p = {key: params[key] for key in _DENSE_KEYS}

        loss, (g_dense, g_w, g_e) = jax.value_and_grad(
            _forward, argnums=(0, 1, 2))(
                dense_p, word_rows, ent_rows, batch, negatives, corr, cfg)

        dw = word_rows.shape[-1]
        ids_w, gw_u = _dedup_rows(batch["windows"].reshape(-1),
                                  g_w.reshape(-1, dw), V)
        ids_e, ge_u = _dedup_rows(ent_idx, g_e, E)

        # Global grad norm over the DEDUPED row grads equals the dense
        # path's optax.global_norm (the scatter-add rows are exactly the
        # segment sums); sentinel slots contribute zero.
        gn = jnp.sqrt(
            sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                for g in jax.tree.leaves(g_dense))
            + jnp.sum(jnp.square(gw_u.astype(jnp.float32)))
            + jnp.sum(jnp.square(ge_u.astype(jnp.float32))))
        if train_cfg.grad_clip_norm > 0:
            # optax.clip_by_global_norm: scale by clip / max(gn, clip).
            scale = (train_cfg.grad_clip_norm
                     / jnp.maximum(gn, train_cfg.grad_clip_norm))
            g_dense = jax.tree.map(
                lambda g: (g.astype(jnp.float32) * scale).astype(g.dtype),
                g_dense)
            gw_u = (gw_u.astype(jnp.float32) * scale).astype(gw_u.dtype)
            ge_u = (ge_u.astype(jnp.float32) * scale).astype(ge_u.dtype)

        upd, dense_state = opt.update(g_dense, state.opt_state["dense"],
                                      dense_p)
        dense_new = optax.apply_updates(dense_p, upd)

        t = state.step + 1                      # optax count_inc semantics
        # Schedule value for THIS update: optax's scale_by_schedule reads
        # its count before incrementing, i.e. the completed-update index =
        # state.step — the row path evaluates at the same point.
        lr = (lr_of(state.step).astype(jnp.float32)
              if callable(lr_of) else lr_of)
        rows = state.opt_state["rows"]
        word_new, rw = _row_update(train_cfg, params["word_emb"],
                                   rows["word_emb"], ids_w, gw_u, lr, t)
        ent_new, re_ = _row_update(train_cfg, params["entity_emb"],
                                   rows["entity_emb"], ids_e, ge_u, lr, t)

        new_params = {"word_emb": word_new, "entity_emb": ent_new,
                      **dense_new}
        new_state = TrainState(
            params=new_params,
            opt_state={"dense": dense_state,
                       "rows": {"word_emb": rw, "entity_emb": re_}},
            step=state.step + 1, rng=rng)
        return new_state, {"loss": loss, "grad_norm": gn}

    n = train_cfg.steps_per_call
    if n > 1:
        inner = step

        def step(state, stacked):
            state, metrics = jax.lax.scan(inner, state, stacked)
            return state, jax.tree.map(lambda m: m[-1], metrics)

    if not jit:
        return step
    donate = (0,) if train_cfg.donate_state else ()
    return jax.jit(step, donate_argnums=donate)
