"""Aux subsystem tests: configs, logging, profiling, debug guards."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sert_tpu.models import api
from sert_tpu.utils import debug, profiling
from sert_tpu.utils.config import (DataConfig, ModelConfig, RecipeConfig,
                                   TrainConfig, config_from_dict,
                                   config_to_dict, load_recipe, save_config)
from sert_tpu.utils.logging import JsonlLogger

CFG = ModelConfig(model="loglinear", vocab_size=30, num_entities=9, word_dim=4)


class TestConfig:
    def test_roundtrip(self, tmp_path):
        r = RecipeConfig(name="x", model=CFG,
                         train=TrainConfig(mesh_shape=(2, 4)))
        p = str(tmp_path / "r.json")
        save_config(r, p)
        back = load_recipe(p)
        assert back.model.num_entities == 9
        assert back.train.mesh_shape == (2, 4)
        assert back == r

    def test_unknown_keys_ignored(self):
        d = config_to_dict(DataConfig())
        d["future_field"] = 42
        cfg = config_from_dict(DataConfig, d)
        assert cfg.window_size == DataConfig().window_size


class TestJsonl:
    def test_events(self, tmp_path):
        p = str(tmp_path / "log.jsonl")
        with JsonlLogger(p) as log:
            log.log("train_step", step=1, loss=0.5)
            log.log("epoch_end", epoch=0)
        lines = [json.loads(x) for x in open(p)]
        assert lines[0]["event"] == "train_step" and lines[0]["loss"] == 0.5
        assert "ts" in lines[1]

    def test_null_logger(self):
        JsonlLogger(None).log("x", a=1)  # no-op, no crash


class TestDebug:
    def _batch(self):
        return {"windows": np.array([[1, 2], [3, 4]], np.int32),
                "lengths": np.array([2, 2], np.int32),
                "entities": np.array([0, 8], np.int32)}

    def test_validate_ok(self):
        debug.validate_batch(self._batch(), CFG)

    @pytest.mark.parametrize("field,val,msg", [
        ("windows", np.array([[1, 99], [3, 4]], np.int32), "term id"),
        ("entities", np.array([0, 9], np.int32), "entity id"),
        ("lengths", np.array([3, 2], np.int32), "length"),
    ])
    def test_validate_catches(self, field, val, msg):
        b = self._batch()
        b[field] = val
        with pytest.raises(ValueError, match=msg):
            debug.validate_batch(b, CFG)

    def test_checked_loss_flags_nan(self):
        params = api.init_params(jax.random.key(0), CFG)
        params["proj_w"] = params["proj_w"] * jnp.nan
        f = debug.checked(lambda p, b: api.loss_fn(p, b, CFG))
        err, _ = jax.jit(f)(params, self._batch())
        with pytest.raises(Exception):
            err.throw()

    def test_checked_loss_clean(self):
        params = api.init_params(jax.random.key(0), CFG)
        f = debug.checked(lambda p, b: api.loss_fn(p, b, CFG))
        err, loss = jax.jit(f)(params, self._batch())
        err.throw()  # no error
        assert np.isfinite(float(loss))

    def test_assert_all_finite(self):
        debug.assert_all_finite({"a": jnp.ones(3)})
        with pytest.raises(FloatingPointError, match="a"):
            debug.assert_all_finite({"a": jnp.array([1.0, jnp.inf])})


class TestProfiling:
    def test_step_timer(self):
        t = profiling.StepTimer(window=2)
        assert t.tick(jnp.ones(1)) is None
        assert t.tick(jnp.ones(1)) is None      # first window: no baseline
        t.tick(jnp.ones(1))
        rate = t.tick(jnp.ones(1))
        assert rate is not None and rate > 0

    def test_trace_noop_safe(self, tmp_path):
        with profiling.trace(str(tmp_path / "trace")):
            _ = jnp.arange(4).sum()

    def test_annotate(self):
        with profiling.annotate("region"):
            _ = jnp.arange(4).sum()


class TestCompilationCache:
    """utils/cache.py: JAX_COMPILATION_CACHE_DIR wins when set; otherwise
    one fixed, gitignored directory inside the checkout."""

    def _restore(self, prev):
        jax.config.update("jax_compilation_cache_dir", prev)

    def test_opt_out_env(self, monkeypatch):
        from sert_tpu.utils import cache
        prev = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("SERT_NO_COMPILE_CACHE", "1")
        try:
            assert cache.enable_compilation_cache() is None
            assert jax.config.jax_compilation_cache_dir == prev
        finally:
            self._restore(prev)

    def test_respects_existing_config(self, tmp_path, monkeypatch):
        """The environment variable wins, and nothing is set in code: JAX
        took the variable's value itself."""
        from sert_tpu.utils import cache
        prev = jax.config.jax_compilation_cache_dir
        monkeypatch.delenv("SERT_NO_COMPILE_CACHE", raising=False)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        try:
            assert cache.cache_dir() == str(tmp_path)
            assert cache.enable_compilation_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == prev
        finally:
            self._restore(prev)

    def test_default_dir_fixed_inside_checkout_and_gitignored(
            self, monkeypatch):
        import os
        from sert_tpu.utils import cache
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.delenv("SERT_NO_COMPILE_CACHE", raising=False)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert cache.cache_dir() == cache.DEFAULT_DIR
        assert os.path.dirname(cache.DEFAULT_DIR) == repo
        name = os.path.basename(cache.DEFAULT_DIR)
        with open(os.path.join(repo, ".gitignore")) as fh:
            assert f"{name}/" in fh.read().split()

    def test_enables_and_writes_entries(self, tmp_path, monkeypatch):
        from sert_tpu.utils import cache
        prev = jax.config.jax_compilation_cache_dir
        prev_t = jax.config.jax_persistent_cache_min_compile_time_secs
        prev_b = jax.config.jax_persistent_cache_min_entry_size_bytes
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.delenv("SERT_NO_COMPILE_CACHE", raising=False)
        monkeypatch.setattr(cache, "DEFAULT_DIR", str(tmp_path / "c"))
        try:
            # Any earlier CLI-driving test has already set the global cache
            # dir (cli.main enables it) AND initialized the cache backend;
            # clear the config and reset the backend so THIS call is the
            # one that configures it. (Product code never needs the reset —
            # the CLI configures the dir before the first compile.)
            jax.config.update("jax_compilation_cache_dir", None)
            try:
                from jax._src import compilation_cache as _cc
                _cc.reset_cache()
            except (ImportError, AttributeError):
                pytest.skip("jax compilation-cache reset unavailable")
            got = cache.enable_compilation_cache()
            assert got == str(tmp_path / "c")
            # Thresholds lowered only HERE so the toy program writes an
            # entry (product code keeps jax defaults).
            jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
            jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
            x = jnp.ones((64, 64))
            jax.jit(lambda a: (a @ a.T).sum() * 1.000173)(x).block_until_ready()
            import os as _os
            assert _os.listdir(got), "no cache entry written"
        finally:
            self._restore(prev)
            jax.config.update("jax_persistent_cache_min_compile_time_secs",
                              prev_t)
            jax.config.update("jax_persistent_cache_min_entry_size_bytes",
                              prev_b)
