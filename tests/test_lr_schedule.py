"""Learning-rate schedules (TrainConfig.lr_schedule).

The reference trained at a fixed lr per run (SURVEY.md section 3.1); the
schedule support here is framework surface for the scale experiments
(e.g. the 1M frontier's cosine probe). Contracts under test:

  * make_lr endpoint values (peak, warmup ramp, decay target);
  * the optax path and the row-sparse lazy path evaluate the SAME
    schedule at the same step index (adagrad lazy is bit-identical to
    dense, so the parity must survive a schedule);
  * the fused optimizer-in-backward kernel bakes a fixed lr and must
    gate itself off under any schedule or warmup;
  * the train loop fills lr_decay_steps from the run's step budget.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sert_tpu.train.step import init_state, make_lr, make_train_step
from sert_tpu.utils.config import ModelConfig, TrainConfig

V, E, DW, DE, B, W = 97, 53, 12, 10, 16, 5


def _lse_cfg(**kw):
    return ModelConfig(model="lse", vocab_size=V, num_entities=E,
                       word_dim=DW, entity_dim=DE,
                       objective="sampled_softmax", num_negatives=7, **kw)


def _tcfg(**kw):
    kw.setdefault("batch_size", B)
    kw.setdefault("donate_state", False)
    kw.setdefault("learning_rate", 0.05)
    return TrainConfig(**kw)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append({
            "windows": rng.integers(0, V, size=(B, W)).astype(np.int32),
            "lengths": rng.integers(1, W + 1, size=B).astype(np.int32),
            "entities": rng.integers(0, E, size=B).astype(np.int32)})
    return out


def _run(mcfg, tcfg, n_steps):
    state = init_state(jax.random.key(0), mcfg, tcfg)
    step = make_train_step(mcfg, tcfg)
    for b in _batches(n_steps):
        state, metrics = step(state, {k: jnp.asarray(v)
                                      for k, v in b.items()})
    return state, metrics


class TestMakeLr:
    def test_constant_is_plain_float(self):
        assert make_lr(_tcfg()) == 0.05

    def test_constant_with_warmup_ramps(self):
        lr = make_lr(_tcfg(lr_warmup_steps=10))
        assert float(lr(0)) == 0.0
        np.testing.assert_allclose(float(lr(5)), 0.025, rtol=1e-6)
        np.testing.assert_allclose(float(lr(10)), 0.05, rtol=1e-6)
        np.testing.assert_allclose(float(lr(1000)), 0.05, rtol=1e-6)

    @pytest.mark.parametrize("kind", ["cosine", "linear"])
    def test_decay_endpoints(self, kind):
        lr = make_lr(_tcfg(lr_schedule=kind, lr_decay_steps=100,
                           lr_final_fraction=0.1))
        np.testing.assert_allclose(float(lr(0)), 0.05, rtol=1e-6)
        np.testing.assert_allclose(float(lr(100)), 0.005, rtol=1e-5)
        assert float(lr(0)) > float(lr(50)) > float(lr(100))

    @pytest.mark.parametrize("kind", ["cosine", "linear"])
    def test_decay_with_warmup(self, kind):
        lr = make_lr(_tcfg(lr_schedule=kind, lr_decay_steps=100,
                           lr_warmup_steps=10, lr_final_fraction=0.0))
        assert float(lr(0)) == 0.0
        np.testing.assert_allclose(float(lr(10)), 0.05, rtol=1e-6)
        np.testing.assert_allclose(float(lr(100)), 0.0, atol=1e-9)

    def test_decay_without_horizon_rejected(self):
        with pytest.raises(ValueError, match="lr_decay_steps"):
            make_lr(_tcfg(lr_schedule="cosine"))

    def test_unknown_schedule_rejected(self):
        with pytest.raises(ValueError, match="lr_schedule"):
            make_lr(_tcfg(lr_schedule="exponential", lr_decay_steps=10))


class TestScheduledTraining:
    def test_schedule_changes_the_trajectory(self):
        mcfg = ModelConfig(model="loglinear", vocab_size=V, num_entities=E,
                           word_dim=8)
        const, _ = _run(mcfg, _tcfg(), 8)
        decay, m = _run(mcfg, _tcfg(lr_schedule="cosine", lr_decay_steps=8,
                                    lr_final_fraction=0.0), 8)
        assert np.isfinite(float(m["loss"]))
        diff = float(jnp.max(jnp.abs(const.params["proj_w"]
                                     - decay.params["proj_w"])))
        assert diff > 1e-6

    def test_sparse_lazy_matches_dense_under_schedule(self):
        """adagrad lazy == dense bit-for-bit (train/sparse.py contract);
        a schedule must not break that — the row path evaluates make_lr at
        state.step, the dense path threads it through optax's own count."""
        mcfg = _lse_cfg()
        kw = dict(optimizer="adagrad", lr_schedule="cosine",
                  lr_decay_steps=12, lr_warmup_steps=3,
                  lr_final_fraction=0.1)
        dense, _ = _run(mcfg, _tcfg(sparse_update="off", **kw), 12)
        lazy, _ = _run(mcfg, _tcfg(sparse_update="on", **kw), 12)
        for k in dense.params:
            np.testing.assert_allclose(
                np.asarray(dense.params[k]), np.asarray(lazy.params[k]),
                atol=2e-7, rtol=2e-6, err_msg=k)

    def test_loop_fills_decay_horizon(self, tmp_path):
        from sert_tpu.data import (Associations, EntityRegistry,
                                   InstanceDataset)
        from sert_tpu.data.prepare import prepare
        from sert_tpu.data.synthetic import make_synthetic
        from sert_tpu.train.loop import train
        from sert_tpu.utils.config import DataConfig, RecipeConfig

        col = make_synthetic(num_entities=7, vocab_size=200,
                             docs_per_entity=4, doc_len=50, num_topics=4,
                             seed=0)
        reg = EntityRegistry(col.entities)
        assoc = Associations()
        for d, es in col.doc_entities.items():
            for e in es:
                assoc.add(d, reg.id(e))
        ddir = str(tmp_path / "data")
        prepare(col.docs, assoc, reg, ddir,
                DataConfig(window_size=4, vocab_min_count=1))
        ds = InstanceDataset(ddir)
        recipe = RecipeConfig(
            name="t", data=DataConfig(window_size=4, vocab_min_count=1),
            model=ModelConfig(model="loglinear", vocab_size=ds.meta["vocab_size"],
                              num_entities=7, word_dim=8),
            train=_tcfg(num_epochs=2, lr_schedule="linear",
                        log_every_steps=0))
        # completing at all proves the loop filled lr_decay_steps: building
        # the step with a decay schedule and horizon 0 raises in make_lr.
        state = train(recipe, ds, str(tmp_path / "run"), resume=False)
        assert int(state.step) == 2 * ds.num_batches_per_epoch(B)
