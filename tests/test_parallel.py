"""Sharding equivalence tests on the 8-virtual-device CPU mesh
(SURVEY.md section 5, item 3): N-device results must match 1-device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sert_tpu.models import api
from sert_tpu.parallel.mesh import make_mesh
from sert_tpu.parallel.sharding import shard_state, state_shardings
from sert_tpu.parallel.topk import distributed_topk
from sert_tpu.parallel.train import make_sharded_train_step
from sert_tpu.scoring.scorer import streaming_topk
from sert_tpu.train.step import init_state, make_train_step
from sert_tpu.utils.config import ModelConfig, TrainConfig

CFG_LL = ModelConfig(model="loglinear", vocab_size=50, num_entities=40,
                     word_dim=8)
CFG_LSE = ModelConfig(model="lse", vocab_size=50, num_entities=40,
                      word_dim=8, entity_dim=8, num_negatives=4)
# sparse_update off: this file tests the SHARDED step, which is always
# dense (train/sparse.py is single-device); the 1-device reference must
# run the same dense semantics for the equivalence claims to be exact.
TCFG = TrainConfig(batch_size=16, learning_rate=1e-2, donate_state=False,
                   sparse_update="off")


def _batch(rng, B=16, V=50, E=40):
    return {"windows": rng.integers(0, V, size=(B, 5)).astype(np.int32),
            "lengths": np.full(B, 5, np.int32),
            "entities": rng.integers(0, E, size=B).astype(np.int32)}


def _queries(rng, Q=4, T=3, V=50):
    t = rng.integers(0, V, size=(Q, T)).astype(np.int32)
    m = rng.integers(1, T + 1, size=Q).astype(np.int32)
    return jnp.asarray(t), jnp.asarray(m)


class TestMesh:
    def test_shapes(self):
        m = make_mesh((2, 4))
        assert m.shape == {"data": 2, "model": 4}

    def test_infer(self):
        m = make_mesh((-1, 4))
        assert m.shape["data"] == 2
        with pytest.raises(ValueError):
            make_mesh((4, 4))


class TestShardingRules:
    def test_entity_axis_sharded(self):
        mesh = make_mesh((2, 4))
        state = init_state(jax.random.key(0), CFG_LL, TCFG)
        sh = state_shardings(state, mesh, CFG_LL)
        assert sh.params["proj_w"].spec == jax.sharding.PartitionSpec(None, "model")
        assert sh.params["proj_b"].spec == jax.sharding.PartitionSpec("model")
        assert sh.params["word_emb"].spec == jax.sharding.PartitionSpec(None, None)

    def test_lse_entity_emb_row_sharded(self):
        mesh = make_mesh((2, 4))
        state = init_state(jax.random.key(0), CFG_LSE, TCFG)
        sh = state_shardings(state, mesh, CFG_LSE)
        assert sh.params["entity_emb"].spec == jax.sharding.PartitionSpec("model", None)

    def test_ambiguous_sizes_rejected(self):
        mesh = make_mesh((1, 1))
        cfg = CFG_LL.replace(vocab_size=40)  # == num_entities
        state = init_state(jax.random.key(0), cfg, TCFG)
        with pytest.raises(ValueError):
            state_shardings(state, mesh, cfg)


class TestShardedTraining:
    @pytest.mark.parametrize("cfg", [
        CFG_LL,
        pytest.param(CFG_LSE.replace(model="lse_full"),
                     marks=pytest.mark.slow),
        CFG_LSE],
        ids=["loglinear", "lse_full", "lse"])
    def test_sharded_step_matches_single_device(self, cfg):
        """Identical params after 5 steps on a (2,4) mesh vs 1 device."""
        rng = np.random.default_rng(0)
        batches = [_batch(rng) for _ in range(5)]

        ref_state = init_state(jax.random.key(TCFG.seed), cfg, TCFG)
        ref_step = make_train_step(cfg, TCFG, noise=(
            jnp.zeros((cfg.num_entities,), jnp.float32)
            if cfg.model == "lse" else None))
        for b in batches:
            ref_state, ref_metrics = ref_step(ref_state, b)

        mesh = make_mesh((2, 4))
        noise = (jnp.zeros((cfg.num_entities,), jnp.float32)
                 if cfg.model == "lse" else None)
        step, init_fn, put_fn = make_sharded_train_step(cfg, TCFG, mesh, noise)
        state = init_fn()
        for b in batches:
            state, metrics = step(state, put_fn(b))

        for key in ref_state.params:
            np.testing.assert_allclose(
                np.asarray(jax.device_get(state.params[key])),
                np.asarray(ref_state.params[key]), rtol=2e-4, atol=2e-5,
                err_msg=key)
        assert float(metrics["loss"]) == pytest.approx(
            float(ref_metrics["loss"]), rel=2e-4)

    def test_sharded_adafactor_matches_single_device(self):
        """The factored optimizer's [E] column statistic shards over the
        model axis by the shape rule; 5 sharded steps must match 1 device."""
        import dataclasses
        tcfg = dataclasses.replace(TCFG, optimizer="adafactor")
        rng = np.random.default_rng(3)
        batches = [_batch(rng) for _ in range(5)]

        ref_state = init_state(jax.random.key(tcfg.seed), CFG_LL, tcfg)
        ref_step = make_train_step(CFG_LL, tcfg)
        for b in batches:
            ref_state, _ = ref_step(ref_state, b)

        mesh = make_mesh((2, 4))
        step, init_fn, put_fn = make_sharded_train_step(CFG_LL, tcfg, mesh,
                                                        None)
        state = init_fn()
        for b in batches:
            state, _ = step(state, put_fn(b))

        for key in ref_state.params:
            np.testing.assert_allclose(
                np.asarray(jax.device_get(state.params[key])),
                np.asarray(ref_state.params[key]), rtol=2e-4, atol=2e-5,
                err_msg=key)

    def test_data_only_mesh(self):
        mesh = make_mesh((8, 1))
        step, init_fn, put_fn = make_sharded_train_step(CFG_LL, TCFG, mesh)
        state = init_fn()
        state, m = step(state, put_fn(_batch(np.random.default_rng(1))))
        assert np.isfinite(float(m["loss"]))


class TestMeshTrainLoop:
    def test_loop_uses_mesh_and_matches_single_device(self, tmp_path):
        """A recipe with mesh_shape=(2,4) trained by the SAME loop must give
        params equal to the single-device run (and resume must re-place
        host-loaded checkpoints onto the mesh)."""
        from sert_tpu.data import Associations, EntityRegistry, InstanceDataset
        from sert_tpu.data.prepare import prepare
        from sert_tpu.data.synthetic import make_synthetic
        from sert_tpu.train.loop import train
        from sert_tpu.utils.config import DataConfig, RecipeConfig

        col = make_synthetic(num_entities=8, vocab_size=400, docs_per_entity=3,
                             doc_len=40, num_topics=2, seed=9)
        reg = EntityRegistry(col.entities)
        assoc = Associations()
        for d, es in col.doc_entities.items():
            for e in es:
                assoc.add(d, reg.id(e))
        ddir = str(tmp_path / "d")
        prepare(col.docs, assoc, reg, ddir, DataConfig(window_size=4,
                                                       vocab_min_count=1))
        ds = InstanceDataset(ddir)
        mcfg = ModelConfig(model="loglinear", vocab_size=ds.meta["vocab_size"],
                           num_entities=8, word_dim=8)
        base = TrainConfig(batch_size=16, num_epochs=2, learning_rate=1e-2,
                           donate_state=False, log_every_steps=0)

        r1 = RecipeConfig(name="s", model=mcfg, train=base)
        s1 = train(r1, ds, str(tmp_path / "single"), deterministic_feed=True)

        import dataclasses
        r8 = RecipeConfig(name="m", model=mcfg,
                          train=dataclasses.replace(base, mesh_shape=(2, 4)))
        s8 = train(r8, ds, str(tmp_path / "mesh"), deterministic_feed=True)
        for key in s1.params:
            np.testing.assert_allclose(
                np.asarray(jax.device_get(s8.params[key])),
                np.asarray(s1.params[key]), rtol=2e-4, atol=2e-5)

        # resume on the mesh: re-running is a no-op that must load cleanly
        s8b = train(r8, ds, str(tmp_path / "mesh"), deterministic_feed=True)
        for key in s1.params:
            np.testing.assert_array_equal(
                np.asarray(jax.device_get(s8b.params[key])),
                np.asarray(jax.device_get(s8.params[key])))

    def test_oversized_mesh_falls_back(self, tmp_path, caplog):
        from sert_tpu.data import Associations, EntityRegistry, InstanceDataset
        from sert_tpu.data.prepare import prepare
        from sert_tpu.data.synthetic import make_synthetic
        from sert_tpu.train.loop import train
        from sert_tpu.utils.config import DataConfig, RecipeConfig
        import dataclasses

        col = make_synthetic(num_entities=4, vocab_size=300, docs_per_entity=2,
                             doc_len=30, num_topics=2, seed=10)
        reg = EntityRegistry(col.entities)
        assoc = Associations()
        for d, es in col.doc_entities.items():
            for e in es:
                assoc.add(d, reg.id(e))
        ddir = str(tmp_path / "d")
        prepare(col.docs, assoc, reg, ddir, DataConfig(window_size=4,
                                                       vocab_min_count=1))
        ds = InstanceDataset(ddir)
        mcfg = ModelConfig(model="loglinear", vocab_size=ds.meta["vocab_size"],
                           num_entities=4, word_dim=4)
        tcfg = TrainConfig(batch_size=8, num_epochs=1, mesh_shape=(64, 1),
                           donate_state=False, log_every_steps=0)
        state = train(RecipeConfig(name="f", model=mcfg, train=tcfg), ds,
                      str(tmp_path / "o"), deterministic_feed=True)
        assert int(state.step) > 0  # ran single-device instead of crashing


class TestDistributedTopk:
    # Fast gate: every local engine once, on the harder ring merge with the
    # loglinear scorer; the full (cfg x merge x engine) grid is CI-only —
    # each combination pays its own multi-second fake-device compile.
    @pytest.mark.parametrize("cfg", [
        CFG_LL, pytest.param(CFG_LSE, marks=pytest.mark.slow)],
        ids=["loglinear", "lse"])
    @pytest.mark.parametrize("merge", [
        pytest.param("allgather", marks=pytest.mark.slow), "ring"])
    @pytest.mark.parametrize("local_engine", ["scan", "binmax", "exact"])
    def test_matches_single_device(self, cfg, merge, local_engine):
        mesh = make_mesh((2, 4))
        params = api.init_params(jax.random.key(7), cfg)
        term_ids, num_terms = _queries(np.random.default_rng(7))
        want_s, want_i = streaming_topk(params, cfg, term_ids, num_terms,
                                        k=8, chunk=16)
        got_s, got_i = distributed_topk(params, cfg, term_ids, num_terms,
                                        mesh, k=8, chunk=8, merge=merge,
                                        local_engine=local_engine)
        np.testing.assert_allclose(np.asarray(got_s), np.asarray(want_s),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(got_i), np.asarray(want_i))

    @pytest.mark.parametrize("local_engine", [
        "binmax", pytest.param("exact", marks=pytest.mark.slow)])
    def test_local_engine_k_exceeds_shard(self, local_engine):
        """k larger than a shard's row count: local results pad with -inf
        and the merge still recovers the exact global top-k."""
        mesh = make_mesh((1, 8))
        cfg = CFG_LSE  # E=40 -> 5 rows/shard < k=16
        params = api.init_params(jax.random.key(9), cfg)
        term_ids, num_terms = _queries(np.random.default_rng(9), Q=8)
        want_s, _ = streaming_topk(params, cfg, term_ids, num_terms,
                                   k=16, chunk=16)
        got_s, _ = distributed_topk(params, cfg, term_ids, num_terms, mesh,
                                    k=16, chunk=8, local_engine=local_engine)
        np.testing.assert_allclose(np.asarray(got_s), np.asarray(want_s),
                                   rtol=1e-4, atol=1e-5)

    def test_uneven_shard_rejected(self):
        mesh = make_mesh((1, 8))
        cfg = CFG_LSE.replace(num_entities=42)
        params = api.init_params(jax.random.key(0), cfg)
        term_ids, num_terms = _queries(np.random.default_rng(0), Q=8)
        with pytest.raises(ValueError):
            distributed_topk(params, cfg, term_ids, num_terms, mesh, k=4)

    @pytest.mark.slow
    def test_pallas_prep_te_reaches_tail_rows(self):
        """Regression: prepare_distributed's te must be the te the per-shard
        sweep runs with. With 5000 rows/shard (padded to 6144 under te=2048)
        a sweep at another te would floor the grid and lose the winners
        planted in rows 4096..4999 of every shard."""
        from sert_tpu.parallel.topk import prepare_distributed
        mesh = make_mesh((1, 2))
        cfg = CFG_LSE.replace(num_entities=10_000)
        params = dict(api.init_params(jax.random.key(3), cfg))
        # Plant strong winners in the tail rows of BOTH shards.
        emb = np.asarray(params["entity_emb"], np.float32) * 0.01
        rng = np.random.default_rng(3)
        probe = rng.normal(size=emb.shape[1]).astype(np.float32)
        for shard_lo in (0, 5000):
            emb[shard_lo + 4600: shard_lo + 4604] = probe * 5.0
        params["entity_emb"] = jnp.asarray(emb)
        term_ids, num_terms = _queries(rng, Q=4)
        want_s, want_i = streaming_topk(params, cfg, term_ids, num_terms,
                                        k=8, chunk=512)
        prep = prepare_distributed(params, cfg, mesh, te=2048)
        assert prep.te == 2048
        got_s, got_i = distributed_topk(params, cfg, term_ids, num_terms,
                                        mesh, k=8, chunk=512,
                                        local_engine="exact", prep=prep)
        assert np.isfinite(np.asarray(got_s)).all()
        np.testing.assert_allclose(np.asarray(got_s), np.asarray(want_s),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(got_i), np.asarray(want_i))

    def test_sharded_params_stay_sharded(self):
        """distributed_topk accepts params already placed on the mesh."""
        mesh = make_mesh((2, 4))
        state = init_state(jax.random.key(1), CFG_LSE, TCFG)
        sharded = shard_state(state, mesh, CFG_LSE)
        term_ids, num_terms = _queries(np.random.default_rng(1))
        s, i = distributed_topk(sharded.params, CFG_LSE, term_ids, num_terms,
                                mesh, k=8, chunk=8)
        want_s, _ = streaming_topk(state.params, CFG_LSE, term_ids, num_terms,
                                   k=8, chunk=16)
        np.testing.assert_allclose(np.asarray(s), np.asarray(want_s),
                                   rtol=1e-4, atol=1e-5)
