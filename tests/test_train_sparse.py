"""Lazy (row-sparse) optimizer path vs the dense step (train/sparse.py).

Parity contract (module docstring there): adagrad and sgd updates are
exactly zero where the gradient is zero, so the lazy path must match the
dense optax path over many steps up to float reassociation (the
duplicate-row segment-sum accumulates in a different order than the
dense scatter-add — observed diffs are ~1 ulp); adam additionally
matches on the first step from fresh (zero) moments and for rows touched
every step, and differs only in untouched rows' momentum tail.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sert_tpu.models import api
from sert_tpu.train.sparse import sparse_applicable, sparse_enabled
from sert_tpu.train.step import init_state, make_train_step
from sert_tpu.utils.config import ModelConfig, TrainConfig

V, E, DW, DE, B, W = 97, 53, 12, 10, 16, 5


def _cfg(objective="sampled_softmax", **kw):
    return ModelConfig(model="lse", vocab_size=V, num_entities=E,
                       word_dim=DW, entity_dim=DE, objective=objective,
                       num_negatives=7, **kw)


def _tcfg(**kw):
    kw.setdefault("batch_size", B)
    kw.setdefault("donate_state", False)
    kw.setdefault("learning_rate", 0.05)
    return TrainConfig(**kw)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = rng.integers(1, W + 1, size=B).astype(np.int32)
        out.append({
            "windows": rng.integers(0, V, size=(B, W)).astype(np.int32),
            "lengths": lengths,
            "entities": rng.integers(0, E, size=B).astype(np.int32)})
    return out


def _run(mcfg, tcfg, n_steps, noise=None, seed_key=0):
    state = init_state(jax.random.key(seed_key), mcfg, tcfg)
    step = make_train_step(mcfg, tcfg, noise=noise)
    metrics = None
    for b in _batches(n_steps):
        state, metrics = step(state, {k: jnp.asarray(v)
                                      for k, v in b.items()})
    return state, metrics


class TestGating:
    def test_auto_enables_exactly_when_applicable(self):
        # adam is EXCLUDED from auto: lazy adam's momentum-tail semantics
        # measured -0.034 NDCG@100 on the 1M stress;
        # adagrad/sgd lazy are bit-exact and stay auto-on.
        assert not sparse_enabled(_cfg(), _tcfg())          # default adam
        assert sparse_enabled(_cfg(), _tcfg(optimizer="adagrad"))
        assert sparse_enabled(_cfg(), _tcfg(optimizer="sgd"))
        assert sparse_enabled(_cfg(), _tcfg(sparse_update="on"))  # forced
        assert sparse_enabled(_cfg("nce"), _tcfg(optimizer="adagrad"))
        assert not sparse_enabled(_cfg(), _tcfg(sparse_update="off"))
        assert not sparse_enabled(_cfg(), _tcfg(optimizer="adafactor"))
        assert not sparse_enabled(_cfg(), _tcfg(weight_decay=0.01))
        assert not sparse_enabled(_cfg(), _tcfg(mesh_shape=(2, 4)))
        assert not sparse_enabled(
            ModelConfig(model="loglinear", vocab_size=V, num_entities=E),
            _tcfg())
        assert not sparse_enabled(_cfg().replace(model="lse_full"), _tcfg())

    def test_on_rejects_inapplicable(self):
        with pytest.raises(ValueError, match="sparse_update"):
            sparse_enabled(_cfg(), _tcfg(optimizer="adafactor",
                                         sparse_update="on"))

    def test_applicable_is_pure_predicate(self):
        assert sparse_applicable(_cfg(), _tcfg())
        assert not sparse_applicable(_cfg(), _tcfg(grad_clip_norm=0.0,
                                                   mesh_shape=(1, 8)))


class TestExactParity:
    """adagrad / sgd: lazy must equal dense leaf-exactly, many steps."""

    @pytest.mark.parametrize("objective", ["nce", "sampled_softmax"])
    @pytest.mark.parametrize("optimizer", ["adagrad", "sgd"])
    def test_multistep_leaf_exact(self, objective, optimizer):
        mcfg = _cfg(objective)
        noise = jnp.asarray(
            np.random.default_rng(5).normal(size=E).astype(np.float32))
        s_sparse, m_sparse = _run(mcfg, _tcfg(optimizer=optimizer), 6,
                                  noise=noise)
        s_dense, m_dense = _run(mcfg, _tcfg(optimizer=optimizer,
                                            sparse_update="off"), 6,
                                noise=noise)
        assert sparse_enabled(mcfg, _tcfg(optimizer=optimizer))
        for k in s_dense.params:
            np.testing.assert_allclose(
                np.asarray(s_sparse.params[k]), np.asarray(s_dense.params[k]),
                rtol=2e-6, atol=5e-7, err_msg=k)
        np.testing.assert_allclose(float(m_sparse["loss"]),
                                   float(m_dense["loss"]), rtol=1e-6)
        np.testing.assert_allclose(float(m_sparse["grad_norm"]),
                                   float(m_dense["grad_norm"]), rtol=1e-5)

    def test_adagrad_knobs_parity_and_effect(self):
        # The escape hatches (TrainConfig.adagrad_init_accumulator /
        # adagrad_eps, round-3 VERDICT item 7) must keep lazy == dense
        # leaf-exactly AND actually change the arithmetic vs defaults.
        mcfg = _cfg()
        noise = jnp.asarray(
            np.random.default_rng(5).normal(size=E).astype(np.float32))
        knobs = dict(optimizer="adagrad", adagrad_init_accumulator=1.0,
                     adagrad_eps=1e-4)
        s_sparse, _ = _run(mcfg, _tcfg(**knobs), 4, noise=noise)
        s_dense, _ = _run(mcfg, _tcfg(sparse_update="off", **knobs), 4,
                          noise=noise)
        for k in s_dense.params:
            np.testing.assert_allclose(
                np.asarray(s_sparse.params[k]), np.asarray(s_dense.params[k]),
                rtol=2e-6, atol=5e-7, err_msg=k)
        s_default, _ = _run(mcfg, _tcfg(optimizer="adagrad"), 4, noise=noise)
        diff = max(float(jnp.max(jnp.abs(s_default.params[k]
                                         - s_dense.params[k])))
                   for k in s_dense.params)
        assert diff > 1e-5, "non-default knobs changed nothing"

    def test_adam_first_step_exact(self):
        # From zero moments an untouched row's dense-adam update is zero
        # too, so step 1 must agree (to reassociation ulps) tree-wide.
        mcfg = _cfg()
        s_sparse, _ = _run(mcfg, _tcfg(optimizer="adam",
                               sparse_update="on"), 1)
        s_dense, _ = _run(mcfg, _tcfg(optimizer="adam",
                                      sparse_update="off"), 1)
        for k in s_dense.params:
            np.testing.assert_allclose(
                np.asarray(s_sparse.params[k]), np.asarray(s_dense.params[k]),
                rtol=1e-6, atol=1e-7, err_msg=k)

    def test_adam_multistep_full_coverage_exact(self):
        # Dense adam moves even zero-grad rows (momentum decays toward
        # zero but the update m_hat/(sqrt(v_hat)+eps) is nonzero), so
        # lazy-vs-dense divergence on partially-covered batches is BY
        # DESIGN and couples into every row through the loss. The regime
        # where multistep parity must be exact is full coverage: when
        # every word and entity row receives gradient on every step, the
        # lazy recursion is the dense recursion. Build such batches.
        E2, V2 = 8, 40   # B*W = 80 >= V2, B = 16 >= E2
        mcfg = ModelConfig(model="lse", vocab_size=V2, num_entities=E2,
                           word_dim=DW, entity_dim=DE,
                           objective="sampled_softmax", num_negatives=7)
        rng = np.random.default_rng(3)
        batches = []
        for _ in range(4):
            windows = rng.integers(0, V2, size=(B, W)).astype(np.int32)
            windows.reshape(-1)[:V2] = np.arange(V2)    # cover all words
            entities = np.concatenate(
                [np.arange(E2), rng.integers(0, E2, size=B - E2)]
            ).astype(np.int32)                          # cover all entities
            batches.append({"windows": windows,
                            "lengths": np.full(B, W, np.int32),
                            "entities": entities})

        def run(tcfg):
            state = init_state(jax.random.key(0), mcfg, tcfg)
            step = make_train_step(mcfg, tcfg)
            for b in batches:
                state, m = step(state, {k: jnp.asarray(v)
                                        for k, v in b.items()})
            return state

        s_sparse = run(_tcfg(optimizer="adam", sparse_update="on"))
        s_dense = run(_tcfg(optimizer="adam", sparse_update="off"))
        for k in s_dense.params:
            np.testing.assert_allclose(
                np.asarray(s_sparse.params[k]), np.asarray(s_dense.params[k]),
                rtol=2e-5, atol=2e-6, err_msg=k)

    def test_grad_clip_parity(self):
        mcfg = _cfg()
        t = dict(optimizer="adagrad", grad_clip_norm=0.5)
        s_sparse, m_s = _run(mcfg, _tcfg(**t), 4)
        s_dense, m_d = _run(mcfg, _tcfg(sparse_update="off", **t), 4)
        for k in s_dense.params:
            np.testing.assert_allclose(
                np.asarray(s_sparse.params[k]), np.asarray(s_dense.params[k]),
                rtol=2e-6, atol=5e-7, err_msg=k)
        np.testing.assert_allclose(float(m_s["grad_norm"]),
                                   float(m_d["grad_norm"]), rtol=1e-5)

    def test_steps_per_call_scan(self):
        mcfg = _cfg()
        tc = _tcfg(optimizer="adagrad", steps_per_call=3)
        state = init_state(jax.random.key(0), mcfg, tc)
        step = make_train_step(mcfg, tc)
        bs = _batches(3)
        stacked = {k: jnp.stack([jnp.asarray(b[k]) for b in bs])
                   for k in bs[0]}
        state, metrics = step(state, stacked)
        assert int(state.step) == 3

        ref = init_state(jax.random.key(0), mcfg, _tcfg(optimizer="adagrad"))
        ref_step = make_train_step(mcfg, _tcfg(optimizer="adagrad"))
        for b in bs:
            ref, ref_m = ref_step(ref, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        for k in ref.params:
            np.testing.assert_allclose(np.asarray(state.params[k]),
                                       np.asarray(ref.params[k]),
                                       rtol=2e-6, atol=5e-7, err_msg=k)
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(ref_m["loss"]), rtol=1e-6)


class TestCheckpointRoundtrip:
    def test_save_load_sparse_opt_state(self, tmp_path):
        from sert_tpu.train import checkpoint as ckpt
        mcfg, tc = _cfg(), _tcfg(optimizer="adam", sparse_update="on")
        state, _ = _run(mcfg, tc, 2)
        path = ckpt.save_checkpoint(str(tmp_path), int(state.step), state)
        template = init_state(jax.random.key(0), mcfg, tc)
        restored, _ = ckpt.load_checkpoint(path, template)
        np.testing.assert_array_equal(
            np.asarray(restored.opt_state["rows"]["entity_emb"]["m"]),
            np.asarray(state.opt_state["rows"]["entity_emb"]["m"]))
        # resumed training keeps stepping
        step = make_train_step(mcfg, tc)
        new_state, m = step(restored, {k: jnp.asarray(v) for k, v in
                                       _batches(1, seed=9)[0].items()})
        assert np.isfinite(float(m["loss"]))
        assert int(new_state.step) == int(state.step) + 1


class TestBf16Params:
    def test_bf16_param_training_steps_finite(self):
        mcfg = _cfg(param_dtype="bfloat16", compute_dtype="bfloat16")
        state, metrics = _run(mcfg, _tcfg(optimizer="adam",
                                  sparse_update="on"), 3)
        assert np.isfinite(float(metrics["loss"]))
        assert state.params["entity_emb"].dtype == jnp.bfloat16
        assert (state.opt_state["rows"]["entity_emb"]["m"].dtype
                == jnp.bfloat16)  # matches optax zeros_like dense layout


class TestCheckpointFlavorCompat:
    """Checkpoints written with one opt_state flavor (dense optax vs
    train/sparse.py's {"dense","rows"}) must stay loadable when
    sparse_update resolves differently at load time — the "auto" default
    flipping on was a measured bricking of every pre-sparse checkpoint."""

    def test_flavor_detection(self, tmp_path):
        from sert_tpu.train import checkpoint as ckpt
        mcfg = _cfg()
        dense_state, _ = _run(mcfg, _tcfg(sparse_update="off"), 1)
        sparse_state, _ = _run(mcfg, _tcfg(optimizer="adagrad"), 1)
        p_dense = ckpt.save_checkpoint(str(tmp_path / "d"), 1, dense_state)
        p_sparse = ckpt.save_checkpoint(str(tmp_path / "s"), 1, sparse_state)
        assert not ckpt.has_sparse_opt_state(p_dense)
        assert ckpt.has_sparse_opt_state(p_sparse)

    def test_dense_checkpoint_loads_under_auto_config(self, tmp_path):
        from sert_tpu.train import checkpoint as ckpt
        mcfg = _cfg()
        tc_off = _tcfg(optimizer="adagrad", sparse_update="off")
        tc_auto = _tcfg(optimizer="adagrad")
        state, _ = _run(mcfg, tc_off, 2)
        path = ckpt.save_checkpoint(str(tmp_path), int(state.step), state)
        # The regression premise: the auto-resolved (sparse) template fails.
        bad = jax.eval_shape(
            lambda: init_state(jax.random.key(0), mcfg, tc_auto))
        with pytest.raises(KeyError):
            ckpt.load_checkpoint(path, bad)
        # The loader contract: flavor follows the file.
        tpl = jax.eval_shape(lambda: init_state(
            jax.random.key(0), mcfg, tc_auto,
            sparse_override=ckpt.has_sparse_opt_state(path)))
        restored, _ = ckpt.load_checkpoint(path, tpl)
        np.testing.assert_array_equal(np.asarray(restored.params["entity_emb"]),
                                      np.asarray(state.params["entity_emb"]))

    def test_resume_pins_flavor_to_checkpoint(self, tmp_path):
        """train(resume=True) over a dir checkpointed DENSE, under a config
        that now auto-resolves SPARSE, must pin to dense and finish."""
        import dataclasses

        from sert_tpu.data import Associations, EntityRegistry, InstanceDataset
        from sert_tpu.data.prepare import prepare
        from sert_tpu.data.synthetic import make_synthetic
        from sert_tpu.train.loop import train
        from sert_tpu.utils.config import DataConfig, RecipeConfig

        col = make_synthetic(num_entities=E, vocab_size=80, docs_per_entity=3,
                             doc_len=30, num_topics=3, seed=0)
        reg = EntityRegistry(col.entities)
        assoc = Associations()
        for d, es in col.doc_entities.items():
            for e in es:
                assoc.add(d, reg.id(e))
        ddir = str(tmp_path / "data")
        prepare(col.docs, assoc, reg, ddir,
                DataConfig(window_size=W, vocab_min_count=1))
        ds = InstanceDataset(ddir)
        mcfg = dataclasses.replace(_cfg(), vocab_size=max(
            V, int(ds.meta["vocab_size"])))
        tc_off = _tcfg(optimizer="adagrad", sparse_update="off",
                       num_epochs=1, checkpoint_every_steps=1,
                       async_checkpoint=False, batch_size=8)
        out = str(tmp_path / "run")
        train(RecipeConfig(name="t", model=mcfg, train=tc_off), ds, out,
              deterministic_feed=True)
        tc_auto = dataclasses.replace(tc_off, sparse_update="auto",
                                      num_epochs=2)
        final = train(RecipeConfig(name="t", model=mcfg, train=tc_auto), ds,
                      out, deterministic_feed=True)
        # Continued DENSE: opt_state stayed an optax tree, not {"dense","rows"}.
        assert not isinstance(final.opt_state, dict)

    def test_resume_sparse_checkpoint_inapplicable_config_raises(
            self, tmp_path):
        from sert_tpu.train import checkpoint as ckpt
        from sert_tpu.train.loop import train
        from sert_tpu.utils.config import RecipeConfig
        mcfg = _cfg()
        state, _ = _run(mcfg, _tcfg(optimizer="adagrad"), 1)  # sparse flavor
        ckpt.save_checkpoint(str(tmp_path / "run" / "checkpoints"), 1, state)
        tc_bad = _tcfg(optimizer="adafactor")       # sparse-inapplicable
        with pytest.raises(ValueError, match="row-sparse optimizer state"):
            train(RecipeConfig(name="t", model=mcfg, train=tc_bad),
                  dataset=None, out_dir=str(tmp_path / "run"))
