"""Training driver tests: step semantics, checkpoint/resume exactness."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sert_tpu.data import Associations, EntityRegistry, InstanceDataset
from sert_tpu.data.prepare import prepare
from sert_tpu.data.synthetic import make_synthetic
from sert_tpu.train import checkpoint as ckpt
from sert_tpu.train.loop import train
from sert_tpu.train.step import init_state, make_optimizer, make_train_step
from sert_tpu.utils.config import (DataConfig, ModelConfig, RecipeConfig,
                                   TrainConfig)

MCFG = ModelConfig(model="loglinear", vocab_size=50, num_entities=7, word_dim=8)
TCFG = TrainConfig(batch_size=16, num_epochs=2, learning_rate=1e-2,
                   log_every_steps=2, donate_state=False)


def _batch(rng, B=16):
    return {"windows": rng.integers(0, 50, size=(B, 4)).astype(np.int32),
            "lengths": np.full(B, 4, np.int32),
            "entities": rng.integers(0, 7, size=B).astype(np.int32)}


def _prepared_dataset(tmp_path, seed=0):
    col = make_synthetic(num_entities=7, vocab_size=200, docs_per_entity=4,
                         doc_len=50, num_topics=4, seed=seed)
    reg = EntityRegistry(col.entities)
    assoc = Associations()
    for d, es in col.doc_entities.items():
        for e in es:
            assoc.add(d, reg.id(e))
    d = str(tmp_path / "data")
    meta = prepare(col.docs, assoc, reg, d,
                   DataConfig(window_size=4, vocab_min_count=1))
    return InstanceDataset(d), meta


class TestStep:
    def test_loss_decreases(self):
        rng = np.random.default_rng(0)
        state = init_state(jax.random.key(0), MCFG, TCFG)
        step = make_train_step(MCFG, TCFG)
        batch = _batch(rng)
        first = None
        for _ in range(30):
            state, m = step(state, batch)
            if first is None:
                first = float(m["loss"])
        assert float(m["loss"]) < first
        assert int(state.step) == 30

    def test_optimizers(self):
        for name in ("adam", "adagrad", "sgd", "adafactor"):
            opt = make_optimizer(TrainConfig(optimizer=name))
            params = {"w": jnp.ones((3,))}
            s = opt.init(params)
            u, _ = opt.update({"w": jnp.ones((3,))}, s, params)
            assert np.all(np.isfinite(np.asarray(u["w"])))
        with pytest.raises(ValueError):
            make_optimizer(TrainConfig(optimizer="nope"))

    def test_grad_clip_and_decay_compose(self):
        opt = make_optimizer(TrainConfig(grad_clip_norm=1.0, weight_decay=0.01))
        params = {"w": jnp.ones((4,))}
        s = opt.init(params)
        u, _ = opt.update({"w": 100.0 * jnp.ones((4,))}, s, params)
        assert np.all(np.isfinite(np.asarray(u["w"])))

    def test_adafactor_lse_warns(self):
        # The measured footgun: factored
        # second-moment stats mis-scale sparse NCE updates. The guard fires
        # for sampled LSE, stays silent for the dense-gradient families.
        import warnings
        mcfg = ModelConfig(model="lse", vocab_size=50, num_entities=7,
                           word_dim=8, entity_dim=8, num_negatives=3)
        tcfg = TrainConfig(optimizer="adafactor", donate_state=False)
        with pytest.warns(UserWarning, match="adafactor"):
            make_train_step(mcfg, tcfg)
        for quiet_model, quiet_opt in (("loglinear", "adafactor"),
                                       ("lse_full", "adafactor"),
                                       ("lse", "adam")):
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                make_train_step(MCFG.replace(model=quiet_model),
                                TrainConfig(optimizer=quiet_opt,
                                            donate_state=False))

    def test_adagrad_lse_at_scale_warns(self):
        # Measured on the 1M stress: adagrad pins LSE at chance (loss =
        # ln E) across learning rates while adam trains to NDCG 0.77
        # Warn at scale; stay silent for
        # small collections (tiny-scale adagrad does learn, just worse)
        # and for the log-linear family where adagrad is the classic fit.
        import warnings
        big = ModelConfig(model="lse", vocab_size=50, num_entities=200_000,
                          word_dim=8, entity_dim=8, num_negatives=3)
        with pytest.warns(UserWarning, match="adagrad"):
            make_train_step(big, TrainConfig(optimizer="adagrad",
                                             donate_state=False))
        small = big.replace(num_entities=500)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            make_train_step(small, TrainConfig(optimizer="adagrad",
                                               donate_state=False))
            make_train_step(MCFG.replace(num_entities=200_000),
                            TrainConfig(optimizer="adagrad",
                                        donate_state=False))

    def test_lse_step_consumes_rng(self):
        mcfg = ModelConfig(model="lse", vocab_size=50, num_entities=7,
                           word_dim=8, entity_dim=8, num_negatives=3)
        state = init_state(jax.random.key(0), mcfg, TCFG)
        step = make_train_step(mcfg, TCFG)
        batch = _batch(np.random.default_rng(1))
        s1, m1 = step(state, batch)
        assert not np.array_equal(np.asarray(jax.random.key_data(s1.rng)),
                                  np.asarray(jax.random.key_data(state.rng)))
        assert np.isfinite(float(m1["loss"]))


class TestCheckpoint:
    def test_roundtrip_exact(self, tmp_path):
        state = init_state(jax.random.key(3), MCFG, TCFG)
        p = ckpt.save_checkpoint(str(tmp_path), 17, state, {"epoch": 1})
        template = init_state(jax.random.key(99), MCFG, TCFG)  # different values
        restored, meta = ckpt.load_checkpoint(p, template)
        assert meta["step"] == 17 and meta["epoch"] == 1
        for a, b in zip(jax.tree_util.tree_leaves(state),
                        jax.tree_util.tree_leaves(restored)):
            if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jax.dtypes.prng_key):
                a, b = jax.random.key_data(a), jax.random.key_data(b)
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_latest_and_list(self, tmp_path):
        state = init_state(jax.random.key(0), MCFG, TCFG)
        for s in (5, 20, 11):
            ckpt.save_checkpoint(str(tmp_path), s, state)
        assert ckpt.latest_checkpoint(str(tmp_path)).endswith("ckpt-00000020.npz")
        assert list(ckpt.list_checkpoints(str(tmp_path))) == [5, 11, 20]
        assert ckpt.latest_checkpoint(str(tmp_path / "nope")) is None

    def test_max_to_keep_prunes(self, tmp_path):
        state = init_state(jax.random.key(0), MCFG, TCFG)
        for s in range(1, 6):
            ckpt.save_checkpoint(str(tmp_path), s, state, max_to_keep=2)
        kept = list(ckpt.list_checkpoints(str(tmp_path)))
        assert kept == [4, 5]
        # JSON sidecars pruned with their npz
        names = os.listdir(tmp_path)
        assert not any(n.startswith("ckpt-00000001") for n in names)

    def test_shape_mismatch_rejected(self, tmp_path):
        state = init_state(jax.random.key(0), MCFG, TCFG)
        p = ckpt.save_checkpoint(str(tmp_path), 1, state)
        bad_template = init_state(
            jax.random.key(0), MCFG.replace(num_entities=9), TCFG)
        with pytest.raises(ValueError):
            ckpt.load_checkpoint(p, bad_template)

    def test_multihost_only_process_zero_writes(self, tmp_path, monkeypatch):
        """Pod semantics (mocked multi-controller): non-zero processes
        participate in the gather, hit the barrier, and return the path
        WITHOUT touching the filesystem; process 0 writes then barriers."""
        state = init_state(jax.random.key(0), MCFG, TCFG)
        barriers = []
        monkeypatch.setattr(ckpt, "_barrier", lambda name: barriers.append(name))

        monkeypatch.setattr(jax, "process_count", lambda: 4)
        monkeypatch.setattr(jax, "process_index", lambda: 2)
        p = ckpt.save_checkpoint(str(tmp_path), 7, state)
        assert p.endswith("ckpt-00000007.npz")
        assert not os.path.exists(p)              # non-writer: no file
        assert barriers == ["ckpt-7"]             # waited for the writer

        monkeypatch.setattr(jax, "process_index", lambda: 0)
        p0 = ckpt.save_checkpoint(str(tmp_path), 7, state)
        assert p0 == p and os.path.exists(p0)     # writer: file + sidecar
        assert os.path.exists(p0[:-len(".npz")] + ".json")
        assert barriers == ["ckpt-7", "ckpt-7"]   # released the others

    def test_multihost_gathers_non_addressable_leaves(self, monkeypatch):
        """_to_host must route non-fully-addressable arrays through the
        process_allgather collective instead of device_get (which raises
        on a real pod)."""
        calls = []

        class FakeShardedArray(jax.Array):
            def __init__(self):  # noqa: D401 - test double
                pass

        fake = object.__new__(FakeShardedArray)
        from jax.experimental import multihost_utils
        monkeypatch.setattr(
            multihost_utils, "process_allgather",
            lambda leaf, tiled: calls.append(tiled) or np.ones((2, 2)))
        monkeypatch.setattr(
            FakeShardedArray, "is_fully_addressable",
            property(lambda self: False), raising=False)
        out = ckpt._to_host(fake)
        np.testing.assert_array_equal(out, np.ones((2, 2)))
        assert calls == [True]

    def test_async_saver_roundtrip_and_ordering(self, tmp_path):
        """AsyncCheckpointer must write the state AS OF save() time (a
        device copy — the caller's buffers may be donated to the next step
        immediately after) and serialize successive saves."""
        state = init_state(jax.random.key(3), MCFG, TCFG)
        saver = ckpt.AsyncCheckpointer()
        saver.save(str(tmp_path), 5, state, {"epoch": 1})
        saver.save(str(tmp_path), 9, state, {"epoch": 2}, max_to_keep=1)
        saver.wait()
        assert list(ckpt.list_checkpoints(str(tmp_path))) == [9]  # pruned
        template = init_state(jax.random.key(99), MCFG, TCFG)
        restored, meta = ckpt.load_checkpoint(
            ckpt.latest_checkpoint(str(tmp_path)), template)
        assert meta["epoch"] == 2
        for a, b in zip(jax.tree_util.tree_leaves(state),
                        jax.tree_util.tree_leaves(restored)):
            if hasattr(a, "dtype") and jnp.issubdtype(a.dtype,
                                                      jax.dtypes.prng_key):
                a, b = jax.random.key_data(a), jax.random.key_data(b)
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_async_saver_copies_before_return(self, tmp_path, monkeypatch):
        """save() must deep-copy the state BEFORE handing it to the worker:
        the snapshot on disk reflects save-time values even if the live
        buffers change while the write is in flight."""
        state = init_state(jax.random.key(0), MCFG, TCFG)
        gate = __import__("threading").Event()
        real_save = ckpt.save_checkpoint

        def slow_save(*a, **kw):
            gate.wait(5.0)          # hold the write until the caller mutates
            return real_save(*a, **kw)

        monkeypatch.setattr(ckpt, "save_checkpoint", slow_save)
        saver = ckpt.AsyncCheckpointer()
        saver.save(str(tmp_path), 1, state)
        expect = np.asarray(state.params["word_emb"]).copy()
        # "Donate" the caller's buffer: delete the live array. The worker
        # must not depend on it.
        state = state._replace(params=dict(state.params, word_emb=None))
        gate.set()
        saver.wait()
        restored, _ = ckpt.load_checkpoint(
            ckpt.latest_checkpoint(str(tmp_path)),
            init_state(jax.random.key(0), MCFG, TCFG))
        np.testing.assert_array_equal(
            np.asarray(restored.params["word_emb"]), expect)

    def test_async_saver_error_reraises_on_wait(self, tmp_path):
        blocker = tmp_path / "not_a_dir"
        blocker.write_text("x")     # os.makedirs inside the worker fails
        state = init_state(jax.random.key(0), MCFG, TCFG)
        saver = ckpt.AsyncCheckpointer()
        saver.save(str(blocker), 1, state)
        with pytest.raises(OSError):
            saver.wait()
        saver.wait()                # error is consumed, not sticky

    def test_async_saver_multiprocess_degrades_to_sync(self, tmp_path,
                                                       monkeypatch):
        """On a pod every process must enter the collective in program
        order — the saver must call save_checkpoint on the CALLING thread."""
        state = init_state(jax.random.key(0), MCFG, TCFG)
        thread_ids = []
        real_save = ckpt.save_checkpoint

        def spy(*a, **kw):
            thread_ids.append(__import__("threading").get_ident())
            return real_save(*a, **kw)

        monkeypatch.setattr(ckpt, "save_checkpoint", spy)
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda: 0)
        monkeypatch.setattr(ckpt, "_barrier", lambda name: None)
        saver = ckpt.AsyncCheckpointer()
        saver.save(str(tmp_path), 3, state)
        assert thread_ids == [__import__("threading").get_ident()]
        assert os.path.exists(ckpt.latest_checkpoint(str(tmp_path)))


class TestLoop:
    def test_train_and_resume_exact(self, tmp_path):
        """Interrupted training resumed from checkpoint must produce params
        bit-identical to an uninterrupted run (SURVEY.md section 6)."""
        ds, _ = _prepared_dataset(tmp_path)
        recipe = RecipeConfig(name="t", model=MCFG, train=TCFG)

        out_a = str(tmp_path / "a")
        full = train(recipe, ds, out_a, deterministic_feed=True)

        # Interrupted: stop mid-epoch-0 via checkpoint_every_steps, new dir.
        out_b = str(tmp_path / "b")
        tcfg_b = TCFG
        recipe_b = RecipeConfig(name="t", model=MCFG,
                                train=tcfg_b)
        n_total = ds.num_batches_per_epoch(TCFG.batch_size) * TCFG.num_epochs

        class StopAfter(Exception):
            pass

        base_step = make_train_step(MCFG, TCFG)
        calls = {"n": 0}
        stop_at = max(2, n_total // 3)

        def limited_step(state, batch):
            if calls["n"] >= stop_at:
                raise StopAfter()
            calls["n"] += 1
            return base_step(state, batch)

        recipe_ckpt = RecipeConfig(
            name="t", model=MCFG,
            train=TCFG.__class__(**{**TCFG.__dict__, "checkpoint_every_steps": 1,
                                    "donate_state": False}))
        try:
            train(recipe_ckpt, ds, out_b, train_step=limited_step,
                  deterministic_feed=True)
        except StopAfter:
            pass
        # Resume with the normal step to completion.
        resumed = train(recipe_ckpt, ds, out_b, deterministic_feed=True)

        for a, b in zip(jax.tree_util.tree_leaves(full.params),
                        jax.tree_util.tree_leaves(resumed.params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=0, atol=0)
        assert os.path.exists(os.path.join(out_a, "train_log.jsonl"))

    def test_steps_per_call_matches_single(self, tmp_path):
        """Scan-unrolled training (steps_per_call=4) must produce the same
        params as one-step-per-dispatch, given the same batch stream."""
        import dataclasses
        ds, _ = _prepared_dataset(tmp_path)
        t1 = dataclasses.replace(TCFG, num_epochs=1)
        t4 = dataclasses.replace(TCFG, num_epochs=1, steps_per_call=4)
        s1 = train(RecipeConfig(name="a", model=MCFG, train=t1), ds,
                   str(tmp_path / "a"), deterministic_feed=True)
        s4 = train(RecipeConfig(name="b", model=MCFG, train=t4), ds,
                   str(tmp_path / "b"), deterministic_feed=True)
        # steps_per_call drops tail groups; compare at the common step count
        n_common = int(s4.step)
        assert n_common > 0 and n_common <= int(s1.step)
        if int(s1.step) == n_common:
            for key in s1.params:
                np.testing.assert_allclose(np.asarray(s1.params[key]),
                                           np.asarray(s4.params[key]),
                                           rtol=1e-5, atol=1e-6)

    def test_steps_per_call_exact_when_divisible(self, tmp_path):
        """With batch count divisible by steps_per_call the runs are
        bit-identical."""
        import dataclasses
        ds, _ = _prepared_dataset(tmp_path)
        n_batches = ds.num_batches_per_epoch(TCFG.batch_size)
        n = 2 if n_batches % 2 == 0 else 1
        t1 = dataclasses.replace(TCFG, num_epochs=1)
        tn = dataclasses.replace(TCFG, num_epochs=1, steps_per_call=n)
        s1 = train(RecipeConfig(name="a", model=MCFG, train=t1), ds,
                   str(tmp_path / "c"), deterministic_feed=True)
        sn = train(RecipeConfig(name="b", model=MCFG, train=tn), ds,
                   str(tmp_path / "d"), deterministic_feed=True)
        assert int(s1.step) == int(sn.step)
        for key in s1.params:
            np.testing.assert_allclose(np.asarray(s1.params[key]),
                                       np.asarray(sn.params[key]),
                                       rtol=1e-6, atol=1e-7)

    def test_resume_exact_with_steps_per_call(self, tmp_path):
        """Interrupt + resume with steps_per_call>1: group boundaries align
        because cursors are only recorded after full groups, so the resumed
        run must be bit-identical to the uninterrupted one."""
        import dataclasses
        ds, _ = _prepared_dataset(tmp_path)
        tcfg = dataclasses.replace(TCFG, steps_per_call=4,
                                   checkpoint_every_steps=1)
        recipe = RecipeConfig(name="s", model=MCFG, train=tcfg)
        full = train(recipe, ds, str(tmp_path / "full"),
                     deterministic_feed=True)

        base_step = make_train_step(MCFG, tcfg)
        calls = {"n": 0}

        class Stop(Exception):
            pass

        def limited(state, batch):
            if calls["n"] >= 3:
                raise Stop()
            calls["n"] += 1
            return base_step(state, batch)

        try:
            train(recipe, ds, str(tmp_path / "resumed"), train_step=limited,
                  deterministic_feed=True)
        except Stop:
            pass
        resumed = train(recipe, ds, str(tmp_path / "resumed"),
                        deterministic_feed=True)
        assert int(resumed.step) == int(full.step)
        for key in full.params:
            np.testing.assert_array_equal(np.asarray(full.params[key]),
                                          np.asarray(resumed.params[key]))

    def test_steps_per_call_clamped_to_epoch_batches(self, tmp_path,
                                                     monkeypatch):
        """A steps_per_call larger than the epoch's batch count must clamp
        (with a warning) instead of silently dropping every batch of every
        epoch — the regression that made small-collection recipes train 0
        steps (the epoch has ~a dozen batches; steps_per_call=1000 would
        drop them all as one incomplete tail group)."""
        import dataclasses
        from sert_tpu.train import loop as loop_mod
        ds, _ = _prepared_dataset(tmp_path)
        n_batches = ds.num_batches_per_epoch(TCFG.batch_size)
        tcfg = dataclasses.replace(TCFG, steps_per_call=n_batches + 1000)
        recipe = RecipeConfig(name="c", model=MCFG, train=tcfg)
        warnings = []
        monkeypatch.setattr(loop_mod.log, "warning",
                            lambda msg, *a: warnings.append(msg % a))
        state = train(recipe, ds, str(tmp_path / "run"),
                      deterministic_feed=True)
        assert int(state.step) == n_batches * tcfg.num_epochs
        assert any("clamping" in w for w in warnings)

        # Clamped run == unclamped run with the same per-epoch coverage.
        ref = train(RecipeConfig(
            name="c2", model=MCFG,
            train=dataclasses.replace(TCFG, steps_per_call=n_batches)),
            ds, str(tmp_path / "ref"), deterministic_feed=True)
        for key in ref.params:
            np.testing.assert_array_equal(np.asarray(ref.params[key]),
                                          np.asarray(state.params[key]))

    def test_batch_size_larger_than_dataset_rejected(self, tmp_path):
        import dataclasses
        ds, _ = _prepared_dataset(tmp_path)
        tcfg = dataclasses.replace(TCFG, batch_size=ds.num_instances + 1)
        recipe = RecipeConfig(name="z", model=MCFG, train=tcfg)
        with pytest.raises(ValueError, match="train 0 steps"):
            train(recipe, ds, str(tmp_path / "run"))

    def test_batch_size_larger_than_every_shard_rejected(self, tmp_path):
        """Regression: iter_batches drops each SHARD's tail, so a batch size
        that exceeds every shard (but not the total instance count) also
        yields 0 batches — the guard must count per-shard floors, not
        num_instances // batch_size."""
        import dataclasses
        col = make_synthetic(num_entities=7, vocab_size=200,
                             docs_per_entity=4, doc_len=50, num_topics=4)
        reg = EntityRegistry(col.entities)
        assoc = Associations()
        for d, es in col.doc_entities.items():
            for e in es:
                assoc.add(d, reg.id(e))
        ddir = str(tmp_path / "data")
        prepare(col.docs, assoc, reg, ddir,
                DataConfig(window_size=4, vocab_min_count=1,
                           instances_per_shard=96))
        ds = InstanceDataset(ddir)
        assert len(ds.meta["shards"]) >= 2
        # Between one shard and the total: old guard saw >= 1 batch, the
        # real epoch yields none.
        tcfg = dataclasses.replace(TCFG, batch_size=120)
        assert ds.num_instances // tcfg.batch_size >= 1
        assert ds.num_batches_per_epoch(tcfg.batch_size) == 0
        recipe = RecipeConfig(name="z2", model=MCFG, train=tcfg)
        with pytest.raises(ValueError, match="train 0 steps"):
            train(recipe, ds, str(tmp_path / "run"))

    def test_epoch_snapshots_written(self, tmp_path):
        ds, _ = _prepared_dataset(tmp_path)
        recipe = RecipeConfig(name="t", model=MCFG, train=TCFG)
        out = str(tmp_path / "run")
        train(recipe, ds, out, deterministic_feed=True)
        cks = ckpt.list_checkpoints(os.path.join(out, "checkpoints"))
        assert len(cks) == TCFG.num_epochs


class TestBf16Checkpoint:
    def test_bf16_params_roundtrip_bit_exact(self, tmp_path):
        """np.savez degrades ml_dtypes.bfloat16 to raw void ('|V2'), which
        made every bf16-params checkpoint UNLOADABLE (and a numeric astype
        from a uint16 carrier would corrupt values). The fix stores a
        uint16 view and restores by bit reinterpretation."""
        mcfg = ModelConfig(model="loglinear", vocab_size=50, num_entities=7,
                           word_dim=8, param_dtype="bfloat16",
                           compute_dtype="bfloat16")
        state = init_state(jax.random.key(1), mcfg, TCFG)
        path = ckpt.save_checkpoint(str(tmp_path), 0, state)
        template = jax.eval_shape(
            lambda: init_state(jax.random.key(0), mcfg, TCFG))
        restored, _ = ckpt.load_checkpoint(path, template)
        for k in state.params:
            assert restored.params[k].dtype == state.params[k].dtype
            np.testing.assert_array_equal(
                np.asarray(restored.params[k]).view(np.uint16),
                np.asarray(state.params[k]).view(np.uint16), err_msg=k)
        # and training continues from the restored state
        step = make_train_step(mcfg, TCFG)
        rng = np.random.default_rng(0)
        _, m = step(restored, {k: jnp.asarray(v)
                               for k, v in _batch(rng).items()})
        assert np.isfinite(float(m["loss"]))


class TestEpochBoundaryCheckpoint:
    def test_aligned_midstep_save_upgraded_not_duplicated(self, tmp_path,
                                                          monkeypatch):
        """checkpoint_every_steps aligned with the epoch boundary must not
        re-fetch and re-write the identical state: the mid-epoch save's
        sidecar is UPGRADED to the epoch snapshot (cursor None)."""
        ds, _ = _prepared_dataset(tmp_path)
        tcfg = TCFG.__class__(**{**TCFG.__dict__,
                                 "checkpoint_every_steps": 1,
                                 "num_epochs": 1,
                                 "async_checkpoint": False})
        recipe = RecipeConfig(name="t", model=MCFG, train=tcfg)

        saves = []
        real_save = ckpt.save_checkpoint

        def spy(ckpt_dir, step, *a, **kw):
            saves.append(int(step))
            return real_save(ckpt_dir, step, *a, **kw)

        monkeypatch.setattr(ckpt, "save_checkpoint", spy)
        out = str(tmp_path / "run")
        final = train(recipe, ds, out, deterministic_feed=True)
        final_step = int(final.step)
        assert saves.count(final_step) == 1     # npz written exactly once
        latest = ckpt.latest_checkpoint(os.path.join(out, "checkpoints"))
        meta = ckpt.load_meta(latest)
        assert meta["step"] == final_step
        assert meta["cursor"] is None           # upgraded to epoch snapshot
        assert meta["epoch"] == 1
        # resume sees a completed epoch and trains the next one exactly
        tcfg2 = tcfg.__class__(**{**tcfg.__dict__, "num_epochs": 2})
        resumed = train(RecipeConfig(name="t", model=MCFG, train=tcfg2),
                        ds, out, deterministic_feed=True)
        assert int(resumed.step) == 2 * final_step


class TestParamsOnlySnapshots:
    def _tcfg(self, **kw):
        return TCFG.__class__(**{**TCFG.__dict__,
                                 "num_epochs": 3,
                                 "epoch_snapshot": "params",
                                 "async_checkpoint": False, **kw})

    def test_intermediate_params_only_final_full(self, tmp_path):
        """epoch_snapshot='params' (the reference's own per-epoch dump
        format): intermediate epochs store params+step only (no optimizer
        leaves in the npz, sidecar flagged); the final epoch stays full."""
        ds, _ = _prepared_dataset(tmp_path)
        recipe = RecipeConfig(name="t", model=MCFG, train=self._tcfg())
        out = str(tmp_path / "run")
        train(recipe, ds, out, deterministic_feed=True)
        cdir = os.path.join(out, "checkpoints")
        paths = ckpt.list_checkpoints(cdir)
        assert len(paths) == 3
        steps = sorted(paths)
        for s in steps[:-1]:
            meta = ckpt.load_meta(paths[s])
            assert meta.get("params_only") is True
            with np.load(paths[s]) as z:
                assert not any(".opt_state" in k for k in z.files)
                assert any(k.startswith(".params") for k in z.files)
        final_meta = ckpt.load_meta(paths[steps[-1]])
        assert not final_meta.get("params_only")
        with np.load(paths[steps[-1]]) as z:
            assert any(".opt_state" in k for k in z.files)
        # resume discovery: full_only lands on the final checkpoint even
        # though it is not the only one
        assert ckpt.latest_checkpoint(cdir, full_only=True) == paths[steps[-1]]

    def test_scoring_and_sweep_read_params_only(self, tmp_path):
        """Intermediate params-only snapshots serve the classic per-epoch
        model-selection workflow (query --step / sweep)."""
        from sert_tpu import pipeline
        from sert_tpu.data.synthetic import make_synthetic as _ms
        col = _ms(num_entities=7, vocab_size=200, docs_per_entity=4,
                  doc_len=50, num_topics=4, seed=0)
        ds, _ = _prepared_dataset(tmp_path)
        recipe = pipeline.resolve_model_config(
            RecipeConfig(name="t", model=MCFG, train=self._tcfg()), ds.meta)
        out = str(tmp_path / "run")
        train(recipe, ds, out, deterministic_feed=True)
        cdir = os.path.join(out, "checkpoints")
        steps = sorted(ckpt.list_checkpoints(cdir))
        # load an INTERMEDIATE (params-only) snapshot for scoring
        params, vocab, registry = pipeline.load_scorer(
            out, str(tmp_path / "data"), recipe, step=steps[0])
        assert set(params) == set(
            jax.device_get(init_state(jax.random.key(0), recipe.model,
                                      recipe.train).params))
        # and the full sweep covers every epoch snapshot
        from sert_tpu.eval.trec import write_qrels, write_topics
        tpath, qpath = str(tmp_path / "t.txt"), str(tmp_path / "q.txt")
        write_topics(col.topics, tpath)
        write_qrels(col.qrels, qpath)
        res = pipeline.sweep_checkpoints(recipe, str(tmp_path / "data"),
                                         out, tpath, qpath)
        assert len(res["per_step"]) == 3

    def test_resume_falls_back_to_newest_full(self, tmp_path):
        """A crash after a params-only epoch snapshot resumes from the
        newest FULL checkpoint, not the params-only one."""
        ds, _ = _prepared_dataset(tmp_path)
        # occasional mid-run full saves via checkpoint_every_steps
        tcfg = self._tcfg(checkpoint_every_steps=80)
        recipe = RecipeConfig(name="t", model=MCFG, train=tcfg)
        out = str(tmp_path / "run")
        train(recipe, ds, out, deterministic_feed=True)
        cdir = os.path.join(out, "checkpoints")
        # simulate a crash right after the LAST params-only epoch
        # snapshot: delete everything written later
        paths = ckpt.list_checkpoints(cdir)
        cut = max(s for s, p in paths.items()
                  if ckpt.load_meta(p).get("params_only"))
        for s, p in paths.items():
            if s > cut:
                os.remove(p)
                os.remove(p[:-4] + ".json")
        newest = ckpt.latest_checkpoint(cdir)
        full = ckpt.latest_checkpoint(cdir, full_only=True)
        assert newest != full
        assert ckpt.load_meta(newest).get("params_only") is True
        assert not ckpt.load_meta(full).get("params_only")
        # resume trains forward from the full checkpoint without error
        resumed = train(recipe, ds, out, deterministic_feed=True)
        assert int(resumed.step) > cut


class TestResumeVocabGuard:
    def test_resume_rejects_foreign_vocab_hash(self, tmp_path):
        """Resuming over a RE-PREPARED data dir (different vocab hash) must
        refuse instead of silently training with permuted embeddings."""
        ds, _ = _prepared_dataset(tmp_path)
        tcfg = TCFG.__class__(**{**TCFG.__dict__, "num_epochs": 1,
                                 "async_checkpoint": False})
        recipe = RecipeConfig(name="t", model=MCFG, train=tcfg)
        out = str(tmp_path / "run")
        train(recipe, ds, out, deterministic_feed=True)
        ds2, _ = _prepared_dataset(tmp_path / "other", seed=5)
        tcfg2 = tcfg.__class__(**{**tcfg.__dict__, "num_epochs": 2})
        with pytest.raises(ValueError, match="different vocabulary"):
            train(RecipeConfig(name="t", model=MCFG, train=tcfg2),
                  ds2, out, deterministic_feed=True)


class TestSnapshotDtypeAndCadence:
    """snapshot_dtype="bfloat16" halves the params-only epoch fetch and
    disk bytes; epoch_snapshot_every=N divides the cadence. Both must
    leave resume and scoring semantics intact."""

    def _tcfg(self, **kw):
        return TCFG.__class__(**{**TCFG.__dict__,
                                 "num_epochs": 3,
                                 "epoch_snapshot": "params",
                                 "async_checkpoint": False, **kw})

    def test_bf16_snapshot_bytes_and_values(self, tmp_path):
        """The bf16 intermediate snapshot stores uint16 carriers (half the
        bytes), records its dtype in the sidecar, and loads back as
        EXACTLY the fp32 state rounded to bf16 — verified against a twin
        fp32-snapshot run with the identical deterministic feed."""
        import ml_dtypes
        ds, _ = _prepared_dataset(tmp_path)
        out_a = str(tmp_path / "run_bf16")
        out_b = str(tmp_path / "run_fp32")
        train(RecipeConfig(name="t", model=MCFG,
                           train=self._tcfg(snapshot_dtype="bfloat16")),
              ds, out_a, deterministic_feed=True)
        train(RecipeConfig(name="t", model=MCFG, train=self._tcfg()),
              ds, out_b, deterministic_feed=True)
        cks_a = ckpt.list_checkpoints(os.path.join(out_a, "checkpoints"))
        cks_b = ckpt.list_checkpoints(os.path.join(out_b, "checkpoints"))
        assert sorted(cks_a) == sorted(cks_b)
        steps = sorted(cks_a)
        for s in steps[:-1]:   # intermediate: bf16 vs fp32 twins
            meta_a = ckpt.load_meta(cks_a[s])
            assert meta_a.get("snapshot_dtype") == "bfloat16"
            with np.load(cks_a[s]) as za, np.load(cks_b[s]) as zb:
                pkeys = [k for k in za.files if k.startswith(".params")]
                assert pkeys
                for k in pkeys:
                    assert za[k].dtype == np.uint16, k   # carrier view
                    assert za[k].nbytes * 2 == zb[k].nbytes, k
                    np.testing.assert_array_equal(
                        za[k].view(ml_dtypes.bfloat16),
                        zb[k].astype(ml_dtypes.bfloat16), err_msg=k)
        # final epoch: FULL fp32 state, knob ignored (exact resume point)
        meta_f = ckpt.load_meta(cks_a[steps[-1]])
        assert not meta_f.get("params_only")
        assert "snapshot_dtype" not in meta_f
        with np.load(cks_a[steps[-1]]) as z:
            assert all(z[k].dtype == np.float32
                       for k in z.files if k.startswith(".params"))
        # the bf16 file loads through an fp32 template (numeric widen)
        template = jax.eval_shape(
            lambda: init_state(jax.random.key(0), MCFG, TCFG))
        restored, _ = ckpt.load_checkpoint(cks_a[steps[0]], template)
        with np.load(cks_b[steps[0]]) as zb:
            for k, v in restored.params.items():
                assert np.asarray(v).dtype == np.float32
                np.testing.assert_array_equal(
                    np.asarray(v),
                    zb[f".params['{k}']"].astype(
                        ml_dtypes.bfloat16).astype(np.float32), err_msg=k)

    def test_scoring_reads_bf16_snapshot(self, tmp_path):
        """load_scorer consumes a bf16 intermediate snapshot and scores —
        the sweep workflow is unchanged by the narrow storage dtype."""
        from sert_tpu import pipeline
        ds, _ = _prepared_dataset(tmp_path)
        recipe = pipeline.resolve_model_config(
            RecipeConfig(name="t", model=MCFG,
                         train=self._tcfg(snapshot_dtype="bfloat16")),
            ds.meta)
        out = str(tmp_path / "run")
        train(recipe, ds, out, deterministic_feed=True)
        steps = sorted(ckpt.list_checkpoints(os.path.join(out,
                                                          "checkpoints")))
        params, vocab, registry = pipeline.load_scorer(
            out, str(tmp_path / "data"), recipe, step=steps[0])
        assert all(np.isfinite(np.asarray(v)).all() for v in params.values())

    def test_epoch_snapshot_every(self, tmp_path):
        """every=2 over 5 epochs writes epochs 2, 4 and the final 5 —
        intermediate non-multiples are skipped, the final always lands,
        and resume falls back to the newest full checkpoint."""
        ds, _ = _prepared_dataset(tmp_path)
        tcfg = self._tcfg(num_epochs=5, epoch_snapshot_every=2)
        out = str(tmp_path / "run")
        train(RecipeConfig(name="t", model=MCFG, train=tcfg),
              ds, out, deterministic_feed=True)
        cdir = os.path.join(out, "checkpoints")
        paths = ckpt.list_checkpoints(cdir)
        epochs = sorted(ckpt.load_meta(p)["epoch"] for p in paths.values())
        assert epochs == [2, 4, 5]
        # the final (epoch-5) checkpoint is full and resume-discoverable
        newest_full = ckpt.latest_checkpoint(cdir, full_only=True)
        assert ckpt.load_meta(newest_full)["epoch"] == 5

    def test_final_snapshot_params(self, tmp_path):
        """final_snapshot="params": the run ends with a params-only
        snapshot at snapshot_dtype and NO full checkpoint exists — the
        E=10M ending, where the full bf16 adam state would be a ~7.8 GB
        device->host fetch. Scoring still loads; resume has no exact
        continuation point (latest full is None)."""
        import ml_dtypes
        from sert_tpu import pipeline
        ds, _ = _prepared_dataset(tmp_path)
        recipe = pipeline.resolve_model_config(
            RecipeConfig(name="t", model=MCFG,
                         train=self._tcfg(snapshot_dtype="bfloat16",
                                          final_snapshot="params")),
            ds.meta)
        out = str(tmp_path / "run")
        train(recipe, ds, out, deterministic_feed=True)
        cdir = os.path.join(out, "checkpoints")
        steps = sorted(ckpt.list_checkpoints(cdir))
        assert len(steps) == 3                      # one per epoch
        assert ckpt.latest_checkpoint(cdir, full_only=True) is None
        last = ckpt.list_checkpoints(cdir)[steps[-1]]
        meta = ckpt.load_meta(last)
        assert meta.get("params_only") is True
        assert meta.get("snapshot_dtype") == "bfloat16"
        with np.load(last) as z:
            assert all(z[k].dtype == np.uint16
                       for k in z.files if k.startswith(".params"))
        params, _, _ = pipeline.load_scorer(
            out, str(tmp_path / "data"), recipe, step=steps[-1])
        assert all(np.isfinite(np.asarray(v)).all()
                   for v in params.values())

    def test_final_snapshot_params_with_full_epochs(self, tmp_path):
        """final_snapshot governs the FINAL epoch's flavor on its own:
        a run whose intermediate snapshots are full resume points can
        still end params-only for the end-of-run fetch budget. (Round-5
        regression: the flavor condition was ANDed with
        epoch_snapshot=="params", so this combination silently wrote a
        full final snapshot.)"""
        ds, _ = _prepared_dataset(tmp_path)
        out = str(tmp_path / "run")
        train(RecipeConfig(name="t", model=MCFG,
                           train=self._tcfg(epoch_snapshot="full",
                                            final_snapshot="params")),
              ds, out, deterministic_feed=True)
        cdir = os.path.join(out, "checkpoints")
        steps = sorted(ckpt.list_checkpoints(cdir))
        last = ckpt.list_checkpoints(cdir)[steps[-1]]
        assert ckpt.load_meta(last).get("params_only") is True
        # intermediates stayed full (resume-discoverable), and the newest
        # FULL checkpoint is the penultimate epoch, not the final one
        newest_full = ckpt.latest_checkpoint(cdir, full_only=True)
        assert newest_full is not None
        assert ckpt.load_meta(newest_full)["epoch"] == 2

    def test_every_one_is_reference_behavior(self, tmp_path):
        ds, _ = _prepared_dataset(tmp_path)
        out = str(tmp_path / "run")
        train(RecipeConfig(name="t", model=MCFG,
                           train=self._tcfg(epoch_snapshot_every=1)),
              ds, out, deterministic_feed=True)
        assert len(ckpt.list_checkpoints(os.path.join(out,
                                                      "checkpoints"))) == 3


class TestReleaseOptState:
    def test_release_frees_and_params_stay_usable(self):
        """release_opt_state (round-5 10M OOM fix): opt buffers deleted,
        params still score, state can no longer step."""
        from sert_tpu.train.step import release_opt_state
        state = init_state(jax.random.key(0), MCFG, TCFG)
        jax.block_until_ready(jax.tree_util.tree_leaves(state.params))
        opt_leaves = [l for l in jax.tree_util.tree_leaves(state.opt_state)
                      if hasattr(l, "is_deleted")]
        assert opt_leaves, "adam state should hold device arrays"
        released = release_opt_state(state)
        assert released.opt_state == ()
        assert all(l.is_deleted() for l in opt_leaves)
        # Params untouched: a forward scoring pass still works.
        from sert_tpu.scoring.scorer import dense_scores
        t = jnp.zeros((2, 3), jnp.int32)
        n = jnp.ones((2,), jnp.int32)
        s = dense_scores(released.params, MCFG, t, n)
        assert np.isfinite(np.asarray(s)).all()
        # Idempotent on an already-released state.
        again = release_opt_state(released)
        assert again.opt_state == ()


class TestJittedInit:
    """The train loop initializes state through ONE jitted program
    (train/loop.py init_fn): each eager init op would be a separate
    compile too cheap for the persistent cache. Jitting must not change
    the init
    distribution: JAX's PRNG is deterministic under trace and zeros are
    zeros — the only deviation is the LAST ULP of the N(0,1/d) scale
    multiply, which XLA fuses into the sampling kernel under jit
    (measured: one float32 ulp on isolated elements). The jitted program
    itself is deterministic across processes, so everything that relies
    on reproducibility (resume exactness, multi-host agreement) compares
    jitted-to-jitted and stays bit-exact."""

    @pytest.mark.parametrize("optimizer", ["adam", "adagrad", "adafactor"])
    def test_jitted_init_matches_eager(self, optimizer):
        tcfg = TrainConfig(batch_size=16, num_epochs=1, optimizer=optimizer,
                           learning_rate=1e-2)
        mcfg = ModelConfig(model="lse", vocab_size=50, num_entities=9,
                           word_dim=8, entity_dim=8,
                           objective="sampled_softmax", num_negatives=4)
        eager = init_state(jax.random.key(11), mcfg, tcfg)
        jitted = jax.jit(
            lambda: init_state(jax.random.key(11), mcfg, tcfg))()
        el = jax.tree_util.tree_leaves_with_path(eager)
        jl = jax.tree_util.tree_leaves_with_path(jitted)
        assert len(el) == len(jl)
        for (pa, a), (pb, b) in zip(el, jl):
            assert pa == pb
            if str(a.dtype).startswith("key"):
                a, b = jax.random.key_data(a), jax.random.key_data(b)
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
                continue
            assert a.dtype == b.dtype
            np.testing.assert_allclose(
                np.asarray(a, np.float64), np.asarray(b, np.float64),
                rtol=3e-7, atol=0,
                err_msg=jax.tree_util.keystr(pa))

    def test_jitted_init_sparse_opt_state(self):
        """The row-sparse lazy flavor (the 10M memory configuration)
        traces too, bitwise-equal to eager."""
        tcfg = TrainConfig(batch_size=16, num_epochs=1, optimizer="adam",
                           learning_rate=1e-2, sparse_update="on")
        mcfg = ModelConfig(model="lse", vocab_size=50, num_entities=9,
                           word_dim=8, entity_dim=8,
                           objective="sampled_softmax", num_negatives=4,
                           param_dtype="bfloat16")
        eager = init_state(jax.random.key(7), mcfg, tcfg)
        jitted = jax.jit(
            lambda: init_state(jax.random.key(7), mcfg, tcfg))()
        for (pa, a), (pb, b) in zip(
                jax.tree_util.tree_leaves_with_path(eager),
                jax.tree_util.tree_leaves_with_path(jitted)):
            assert pa == pb
            if str(a.dtype).startswith("key"):
                a, b = jax.random.key_data(a), jax.random.key_data(b)
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
                continue
            assert a.dtype == b.dtype
            np.testing.assert_allclose(
                np.asarray(a, np.float64), np.asarray(b, np.float64),
                rtol=3e-3 if a.dtype == 'bfloat16' else 3e-7, atol=0,
                err_msg=jax.tree_util.keystr(pa))
