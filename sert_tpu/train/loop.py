"""The epoch loop: feed, step, log, snapshot, resume.

Reference shape (SURVEY.md section 4.2): epoch loop over shuffled instance
batches with async host-side batch construction and per-epoch parameter
snapshots. Here: a PrefetchFeeder overlaps host batch prep with device
compute, metrics stream to JSONL, and checkpoints carry the exact
(epoch, shard, batch) cursor so resume replays nothing and skips nothing.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sert_tpu.data.feeder import PrefetchFeeder
from sert_tpu.data.instances import InstanceDataset
from sert_tpu.models import lse as lse_model
from sert_tpu.train import checkpoint as ckpt
from sert_tpu.train.step import TrainState, init_state, make_train_step
from sert_tpu.utils.config import RecipeConfig, config_to_dict
from sert_tpu.utils.logging import JsonlLogger, get_logger

log = get_logger("train")


def train(
    recipe: RecipeConfig,
    dataset: InstanceDataset,
    out_dir: str,
    entity_counts: Optional[np.ndarray] = None,
    resume: bool = True,
    put_fn: Optional[Callable] = None,
    train_step=None,
    init_fn: Optional[Callable[[], TrainState]] = None,
    deterministic_feed: bool = False,
    init_params_hook: Optional[Callable] = None,
) -> TrainState:
    """Run (or resume) training; returns the final TrainState.

    ``put_fn`` / ``train_step`` / ``init_fn`` hooks let parallel/ inject the
    mesh-sharded variants without changing this loop.

    ``init_params_hook(host_params) -> host_params`` transforms the FRESH
    initialization (e.g. seeding word embeddings from a dump, see
    pipeline.train_from_dir); it is skipped on resume and composes with the
    mesh path (transformed params are re-placed with the template's
    shardings).
    """
    mcfg, tcfg = recipe.model, recipe.train
    os.makedirs(out_dir, exist_ok=True)
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    # Warmup decomposition: cheap perf_counter marks, logged once at the
    # first step of the first epoch.
    t_enter = time.perf_counter()

    # Resume must continue with the opt_state flavor the checkpoint HOLDS:
    # sparse_update="auto" resolving differently than at save time (new
    # default, edited recipe) would otherwise fail template unflattening —
    # or worse, silently restart optimizer moments. Pin the mode to the
    # file before any step/state construction below.
    # full_only: params-only epoch snapshots (epoch_snapshot="params")
    # carry no optimizer state — resume continues from the newest FULL
    # checkpoint instead.
    latest = (ckpt.latest_checkpoint(ckpt_dir, full_only=True)
              if resume else None)
    if latest is not None and train_step is None and init_fn is None:
        from dataclasses import replace as _dc_replace
        from sert_tpu.train import sparse as _sparse
        ckpt_sparse = ckpt.has_sparse_opt_state(latest)
        cfg_sparse = _sparse.sparse_enabled(mcfg, tcfg)
        if ckpt_sparse != cfg_sparse:
            if ckpt_sparse and not _sparse.sparse_applicable(mcfg, tcfg):
                raise ValueError(
                    f"checkpoint {latest} holds row-sparse optimizer state "
                    "but the current config cannot run the sparse step "
                    "(see train/sparse.py sparse_applicable); resume with "
                    "the original optimizer/model settings or start a "
                    "fresh run dir")
            tcfg = _dc_replace(
                tcfg, sparse_update="on" if ckpt_sparse else "off")
            log.warning(
                "resume: pinning sparse_update=%r to match the optimizer "
                "state in %s (config resolved to %r)",
                tcfg.sparse_update, latest, "on" if cfg_sparse else "off")

    if (getattr(tcfg, "lr_schedule", "constant") != "constant"
            and getattr(tcfg, "lr_decay_steps", 0) <= 0):
        # Fill the decay horizon with the run's total step count. Resume
        # recomputes the identical value from the same dataset/config, so
        # the schedule a resumed run continues is the one it started with.
        from dataclasses import replace as _dc_replace
        horizon = max(
            tcfg.num_epochs * dataset.num_batches_per_epoch(tcfg.batch_size),
            1)
        tcfg = _dc_replace(tcfg, lr_decay_steps=horizon)
        log.info("lr_schedule=%s: decay horizon filled to %d steps",
                 tcfg.lr_schedule, horizon)

    noise = None
    if mcfg.model == "lse":
        noise = lse_model.noise_logits(
            entity_counts if mcfg.negative_distribution == "unigram" else None,
            mcfg)

    # Mesh training: recipe.train.mesh_shape > (1,1) builds the sharded
    # step over a ("data", "model") mesh (sert_tpu.parallel); with fewer
    # devices than the mesh asks for, fall back to single-device with a
    # loud warning — recipes stay runnable on one card.
    mesh_size = tcfg.mesh_shape[0] * tcfg.mesh_shape[1]
    feed_batch, readers = tcfg.batch_size, None
    if train_step is None and mesh_size > 1:
        if mesh_size <= jax.device_count():
            from sert_tpu.parallel.mesh import make_mesh
            from sert_tpu.parallel.train import make_sharded_train_step
            mesh = make_mesh(tcfg.mesh_shape)
            n_proc = jax.process_count()
            per_proc = n_proc > 1
            train_step, init_fn, put_fn = make_sharded_train_step(
                mcfg, tcfg, mesh, noise=noise, per_process_feed=per_proc)
            if per_proc:
                # Multi-host ingestion: each process reads ONLY its own
                # instance-shard subset and feeds its local rows of the
                # global batch (data/instances.py reader mode +
                # make_array_from_process_local_data assembly) — host work
                # and feed bytes per process scale with 1/P instead of
                # every host shipping the whole batch.
                if tcfg.batch_size % n_proc:
                    raise ValueError(
                        f"batch_size {tcfg.batch_size} must divide by the "
                        f"process count ({n_proc}) for per-process feeding")
                feed_batch = tcfg.batch_size // n_proc
                readers = (jax.process_index(), n_proc)
                log.info("per-process feed: reader %d/%d, %d local rows "
                         "per global batch", readers[0], n_proc, feed_batch)
            log.info("training on mesh %s", dict(mesh.shape))
        else:
            log.warning("mesh %s needs %d devices, have %d; running "
                        "SINGLE-DEVICE instead", tcfg.mesh_shape, mesh_size,
                        jax.device_count())

    pack_fn = None
    if train_step is None:
        train_step = make_train_step(mcfg, tcfg, noise=noise)
        # Wire-format packing of the feed (data/wirepack.py): id planes
        # travel at their true bit width and unpack inside the jitted
        # step — bit-exact, ~1.8x fewer host->device bytes at 1M-entity
        # scale. Only the loop-built single-device step packs;
        # injected/sharded steps consume the raw planes their put_fn
        # expects.
        from sert_tpu.data import wirepack
        if put_fn is None and wirepack.feed_enabled(
                getattr(tcfg, "packed_feed", "off"),
                mcfg.vocab_size, mcfg.num_entities,
                recipe.data.window_size):
            V, E = mcfg.vocab_size, mcfg.num_entities
            base_step = train_step

            def _unpack_step(s, pb):
                return base_step(s, wirepack.unpack_batch_jnp(pb, V, E))

            train_step = jax.jit(
                _unpack_step,
                donate_argnums=(0,) if tcfg.donate_state else ())

            def pack_fn(b):
                return wirepack.pack_batch(b, V, E)

            log.info("packed feed on (vocab=%d entities=%d): id planes "
                     "ship at true bit width", V, E)
        elif (put_fn is not None
              and getattr(tcfg, "packed_feed", "off") == "on"):
            log.warning("packed_feed='on' ignored: the custom put_fn "
                        "consumes raw batches")
    elif getattr(tcfg, "packed_feed", "off") == "on":
        log.warning("packed_feed='on' ignored: an injected/sharded train "
                    "step consumes raw batches")
    if init_fn is None:
        # ONE jitted program, not ~20 eager dispatches (each RNG normal,
        # each optimizer zeros_like would be its own compile, each too
        # cheap for the persistent cache's entry threshold). Jitted, init
        # is a single cacheable executable: first run pays one compile,
        # repeat processes hit the persistent cache.
        def init_fn():
            return jax.jit(
                lambda: init_state(jax.random.key(tcfg.seed), mcfg, tcfg))()

    t_setup = time.perf_counter()       # noise + step construction done
    state = init_fn()
    jax.block_until_ready(jax.tree_util.tree_leaves(state.params)[0])
    t_init = time.perf_counter()        # device param init materialized
    state_template = state
    start_epoch, cursor = 0, None
    latest = (ckpt.latest_checkpoint(ckpt_dir, full_only=True)
              if resume else None)
    if init_params_hook is not None and latest is None:
        new_params = init_params_hook(jax.device_get(state.params))
        new_params = jax.tree.map(
            lambda t, x: (jax.device_put(np.asarray(x), t.sharding)
                          if hasattr(t, "sharding") else np.asarray(x)),
            state.params, new_params)
        state = state._replace(params=new_params)
    if latest is None and resume:
        any_ckpt = ckpt.latest_checkpoint(ckpt_dir)
        if any_ckpt is not None:
            # epoch_snapshot="params" and a crash before the final epoch:
            # the dir holds only params-only snapshots, which carry no
            # optimizer state. Restarting silently would discard the
            # run's progress without explanation.
            log.warning(
                "resume: %s holds only params-only epoch snapshots (no "
                "full train state) — RESTARTING FROM SCRATCH. Use "
                "checkpoint_every_steps for mid-run full saves if crash "
                "recovery matters at this scale.", ckpt_dir)
    if latest is not None:
        state, meta = ckpt.load_checkpoint(latest, state)
        # Resume guard: continuing with embeddings indexed by a DIFFERENT
        # vocabulary/entity assignment (data dir re-prepared since the
        # checkpoint) silently corrupts the model — the same vocab-hash
        # contract the scoring loaders enforce (pipeline.load_scorer).
        ck_hash = meta.get("vocab_hash")
        ds_hash = dataset.meta.get("vocab_hash")
        if ck_hash and ds_hash and ck_hash != ds_hash:
            raise ValueError(
                f"cannot resume from {latest}: it was trained against a "
                "different vocabulary than the data dir now holds "
                "(re-prepared corpus?); retrain fresh (resume=False / new "
                "out_dir) or restore the original prepared data")
        # Restore the mesh placement the init template had (checkpoints are
        # host-gathered; a sharded step needs sharded inputs back).
        state = jax.tree.map(
            lambda t, x: (jax.device_put(x, t.sharding)
                          if hasattr(t, "sharding") else x),
            state_template, state)
        start_epoch = int(meta.get("epoch", 0))
        cur = meta.get("cursor")
        cursor = tuple(cur) if cur is not None else None
        if cursor is not None and cursor[0] != start_epoch:
            cursor = None
        log.info("resumed from %s (epoch=%d cursor=%s)", latest, start_epoch, cursor)

    meta_common = {
        "recipe": config_to_dict(recipe),
        "vocab_hash": dataset.meta.get("vocab_hash"),
    }

    jlog = JsonlLogger(os.path.join(out_dir, "train_log.jsonl"))
    n_micro = max(tcfg.steps_per_call, 1)
    # Guard against silently training nothing: iter_batches drops each
    # SHARD's tail (static shapes), so the true epoch batch count is the
    # per-shard floor sum — num_instances // batch_size OVERESTIMATES it
    # (e.g. 2 shards x 96 instances at batch 128 is 0 real batches, not 1)
    # and _group_batches additionally drops incomplete micro-step groups.
    n_batches = dataset.num_batches_per_epoch(feed_batch, readers=readers)
    if n_batches == 0:
        raise ValueError(
            f"dataset yields 0 full batches of train.batch_size="
            f"{tcfg.batch_size} ({dataset.num_instances} instances spread "
            f"over {len(dataset.meta['shards'])} shards, tails dropped "
            "per shard"
            + (f", lockstep over {readers[1]} reader processes"
               if readers else "")
            + "); every epoch would train 0 steps — lower "
            "train.batch_size or raise data.instances_per_shard")
    if n_micro > n_batches:
        log.warning(
            "steps_per_call=%d exceeds the %d full batches per epoch; "
            "clamping to %d so epochs are not dropped entirely",
            n_micro, n_batches, n_batches)
        n_micro = n_batches
    # The scanned step (steps_per_call > 1) expects a stacked leading
    # micro-step axis even when the clamped group size is 1.
    stack_groups = tcfg.steps_per_call > 1
    feeders = []
    saver = ckpt.AsyncCheckpointer()
    sync_saves = not tcfg.async_checkpoint
    try:
        for epoch in range(start_epoch, tcfg.num_epochs):
            t_loop0 = time.perf_counter()
            epoch_cursor = cursor if epoch == start_epoch else None
            batches = dataset.iter_batches(feed_batch, epoch=epoch,
                                           start_cursor=epoch_cursor,
                                           readers=readers)
            batches = _group_batches(batches, n_micro, stack=stack_groups)
            feeder = PrefetchFeeder(batches,
                                    put_fn=_batch_put(put_fn, pack_fn),
                                    deterministic=deterministic_feed)
            feeders.append(feeder)  # closed in the finally below
            last_cursor = epoch_cursor
            t_last = time.perf_counter()
            # ONE device fetch per epoch: each dev_batch advances exactly
            # n_micro steps (incomplete groups are dropped by
            # _group_batches), so the counter is tracked host-side — a
            # per-call int(state.step) would serialize the dispatch
            # pipeline (the loop could not enqueue call N+1 until call
            # N's counter came back). Verified against the device at the
            # epoch boundary below.
            prev_step = step_i = int(state.step)
            epoch_losses = []
            last_save_step = -1
            feed_wait = 0.0
            verify_counter = True
            batch_iter = iter(feeder)
            t_first_feed = time.perf_counter()
            t_first = None
            while True:
                t_f = time.perf_counter()
                try:
                    dev_batch, next_cursor = next(batch_iter)
                except StopIteration:
                    break
                feed_wait += time.perf_counter() - t_f
                if t_first is None:
                    t_first = time.perf_counter()
                state, metrics = train_step(state, dev_batch)
                last_cursor = next_cursor
                step_i += n_micro
                if verify_counter:
                    # First call of the epoch: verify the host-tracked
                    # counter against the device BEFORE any mid-epoch
                    # checkpoint stamps step ids with it (an injected
                    # step advancing != 1 per micro-step would otherwise
                    # write misnamed checkpoints all epoch and only trip
                    # the boundary assert afterwards). One sync per epoch.
                    verify_counter = False
                    dev = int(state.step)
                    if dev != step_i:
                        raise AssertionError(
                            f"train_step advanced state.step to {dev}, "
                            f"expected {step_i} (n_micro={n_micro}); the "
                            "loop's host-tracked counter requires one "
                            "increment per micro-step")
                    if epoch == start_epoch:
                        # One-time warmup decomposition: this int() is the
                        # first device sync of the run, so (now - t_first)
                        # covers the first step's compile+execute.
                        now = time.perf_counter()
                        warm = dict(setup_s=round(t_setup - t_enter, 2),
                                    init_s=round(t_init - t_setup, 2),
                                    # resume probe + meta + jlog + batch
                                    # counting, feeder construction, and
                                    # the first int(state.step) device
                                    # sync, separately
                                    pre_loop_s=round(t_loop0 - t_init, 2),
                                    feeder_ctor_s=round(t_last - t_loop0, 2),
                                    step_sync_s=round(t_first_feed - t_last,
                                                      2),
                                    first_batch_s=round(t_first - t_first_feed,
                                                        2),
                                    first_step_s=round(now - t_first, 2))
                        log.info("warmup: %s", warm)
                        jlog.log("warmup", **warm)
                # "crossed a multiple" tests: steps advance n_micro at a time.
                if (tcfg.log_every_steps
                        and step_i % tcfg.log_every_steps < n_micro):
                    t_s = time.perf_counter()
                    loss = float(metrics["loss"])  # device sync point
                    now = time.perf_counter()
                    interval = max(step_i - prev_step, 1)
                    sps = interval / max(now - t_last, 1e-9)
                    t_last, prev_step = now, step_i
                    epoch_losses.append(loss)
                    jlog.log("train_step", step=step_i, epoch=epoch, loss=loss,
                             grad_norm=float(metrics["grad_norm"]),
                             steps_per_sec=sps,
                             instances_per_sec=sps * tcfg.batch_size,
                             # where the interval's wall went, per step:
                             # waiting on the host feed vs waiting for the
                             # device to drain at this sync point.
                             feed_wait_ms=feed_wait * 1e3 / interval,
                             device_sync_ms=(now - t_s) * 1e3)
                    feed_wait = 0.0
                if (tcfg.checkpoint_every_steps
                        and step_i % tcfg.checkpoint_every_steps < n_micro):
                    saver.save(
                        ckpt_dir, step_i, state,
                        {"epoch": epoch, "cursor": list(last_cursor), **meta_common},
                        max_to_keep=tcfg.keep_checkpoints, sync=sync_saves)
                    last_save_step = step_i
            # End of epoch: snapshot (reference's per-epoch dump). The slow
            # device->host fetch runs on the saver's thread over a device
            # copy — the next epoch starts immediately.
            jax.block_until_ready(state.params)
            dev_step = int(state.step)
            if dev_step != step_i:  # host-tracked counter must agree
                raise AssertionError(
                    f"host-tracked step {step_i} != device step {dev_step} "
                    "at epoch end — a batch group advanced an unexpected "
                    "number of micro-steps")
            step_i = dev_step
            if last_save_step == step_i:
                # checkpoint_every_steps aligned with the epoch boundary:
                # the params on disk are ALREADY this state — upgrade the
                # mid-epoch save's sidecar to the epoch snapshot instead of
                # re-fetching and re-writing the multi-GB npz.
                saver.wait()
                ckpt.rewrite_meta(ckpt_dir, step_i,
                                  {"epoch": epoch + 1, "cursor": None,
                                   **meta_common})
            else:
                # epoch_snapshot="params": intermediate epochs dump the
                # reference-format params-only snapshot (1/3 the bytes;
                # optimizer moments never leave the device); the FINAL
                # epoch always writes full state so a finished run is an
                # exact resume/continuation point.
                # epoch_snapshot_every=N skips intermediate snapshots on
                # non-multiple epochs entirely (the final epoch always
                # writes).
                final = epoch + 1 == tcfg.num_epochs
                every = max(1, getattr(tcfg, "epoch_snapshot_every", 1))
                if final or (epoch + 1) % every == 0:
                    # final_snapshot="params" ends the run params-only at
                    # snapshot_dtype (the full adam state is 3x the
                    # params' bytes). The run then has no exact continuation point — the
                    # params-only resume warning above fires on restart.
                    # Each knob governs its OWN epochs: the final epoch's
                    # flavor is final_snapshot alone (a full-snapshot run
                    # can still end params-only for the fetch budget),
                    # intermediates are epoch_snapshot alone.
                    if final:
                        p_only = (getattr(tcfg, "final_snapshot", "full")
                                  == "params")
                    else:
                        p_only = (getattr(tcfg, "epoch_snapshot", "full")
                                  == "params")
                    saver.save(
                        ckpt_dir, step_i, state,
                        {"epoch": epoch + 1, "cursor": None, **meta_common},
                        max_to_keep=tcfg.keep_checkpoints, sync=sync_saves,
                        params_only=p_only,
                        params_dtype=(getattr(tcfg, "snapshot_dtype",
                                              "float32")
                                      if p_only else None))
                else:
                    jlog.log("epoch_snapshot_skipped", epoch=epoch,
                             step=step_i, every=every)
            log.info("epoch %d done at step %d%s", epoch, step_i,
                     (" (mean logged loss %.4f)" % float(np.mean(epoch_losses)))
                     if epoch_losses else "")
            jlog.log("epoch_end", epoch=epoch, step=step_i)
            cursor = None
    finally:
        # Stop prefetch workers even when a step raised mid-epoch (else the
        # worker blocks forever holding device-resident batches).
        for f in feeders:
            f.close()
        jlog.close()
        # train() returning implies the latest snapshot is durable on disk
        # (resume/query load it immediately after). Don't let a writer
        # failure mask the exception already propagating out of the loop.
        if sys.exc_info()[0] is None:
            saver.wait()
        else:
            try:
                saver.wait()
            except BaseException:
                log.exception("async checkpoint save failed during teardown")
    return state


def _group_batches(it, n: int, stack: bool = None):
    """Group n (batch, cursor) pairs into (stacked batch [n, ...], cursor of
    the LAST group member). Incomplete tail groups are dropped (static
    shapes; the caller clamps n to the epoch's batch count so a whole epoch
    is never dropped). With ``stack`` (defaults to n > 1) batches get the
    leading micro-step axis even at n=1 — the scanned step still expects
    it when steps_per_call > 1 was merely clamped down."""
    if stack is None:
        stack = n > 1
    if n <= 1 and not stack:
        yield from it
        return
    buf = []
    for batch, cur in it:
        buf.append((batch, cur))
        if len(buf) == n:
            stacked = {k: np.stack([b[k] for b, _ in buf])
                       for k in buf[0][0]}
            yield stacked, buf[-1][1]
            buf = []


def _batch_put(put_fn: Optional[Callable], pack_fn: Optional[Callable] = None):
    """Lift a device-put over (batch, cursor) pairs, leaving cursors on
    host. ``pack_fn`` (data/wirepack.py) runs host-side on the feeder
    thread BEFORE the transfer — that is the point: fewer bytes cross."""
    if put_fn is None:
        def put_fn(b):
            return jax.device_put({k: jnp.asarray(v) for k, v in b.items()})
    def put(item):
        batch, cur = item
        if pack_fn is not None:
            batch = pack_fn(batch)
        return put_fn(batch), cur
    return put
