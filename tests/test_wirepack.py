"""Wire-format feed packing (data/wirepack.py): bit-exact roundtrip,
byte accounting, and end-to-end train parity with packing on vs off."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sert_tpu.data import wirepack


def _batch(rng, V, E, B=32, w=8, lead=()):
    return {
        "windows": rng.integers(0, V, size=lead + (B, w)).astype(np.int32),
        "lengths": rng.integers(1, w + 1, size=lead + (B,)).astype(np.int32),
        "entities": rng.integers(0, E, size=lead + (B,)).astype(np.int32),
    }


class TestRoundtrip:
    @pytest.mark.parametrize("V,E", [
        (100, 50),                    # both fit uint16: no hi planes
        (65_536, 65_536),             # exactly 16 bits
        (65_537, 70_000),             # 17 bits -> hb=1
        (250_000, 1_000_000),         # the stress-1M id spaces (2 / 4)
        (16_000_000, 16_777_216),     # 24-bit ceiling -> hb=8
    ])
    def test_exact(self, V, E):
        rng = np.random.default_rng(hash((V, E)) % (1 << 32))
        raw = _batch(rng, V, E)
        packed = wirepack.pack_batch(raw, V, E)
        got = wirepack.unpack_batch_jnp(
            {k: jnp.asarray(v) for k, v in packed.items()}, V, E)
        for k in raw:
            np.testing.assert_array_equal(np.asarray(got[k]), raw[k], err_msg=k)

    def test_boundary_ids(self):
        """The extreme ids of each plane survive exactly."""
        V, E, w = 250_000, 1_000_000, 8
        raw = {
            "windows": np.array([[0, 1, 65_535, 65_536, 131_071, V - 1,
                                  V - 2, 7]], np.int32),
            "lengths": np.array([w], np.int32),
            "entities": np.array([E - 1], np.int32),
        }
        packed = wirepack.pack_batch(raw, V, E)
        got = wirepack.unpack_batch_jnp(
            {k: jnp.asarray(v) for k, v in packed.items()}, V, E)
        for k in raw:
            np.testing.assert_array_equal(np.asarray(got[k]), raw[k])

    def test_stacked_micro_batches(self):
        """steps_per_call stacking (leading [spc] axis) packs intact,
        including an odd window width that needs hi-plane padding."""
        V, E = 250_000, 1_000_000
        rng = np.random.default_rng(3)
        raw = _batch(rng, V, E, B=16, w=5, lead=(4,))
        packed = wirepack.pack_batch(raw, V, E)
        got = wirepack.unpack_batch_jnp(
            {k: jnp.asarray(v) for k, v in packed.items()}, V, E)
        for k in raw:
            np.testing.assert_array_equal(np.asarray(got[k]), raw[k])

    def test_bytes_reduction(self):
        """The stress-1M geometry ships <= 22 bytes/instance (raw: 40)."""
        V, E, B, w = 250_000, 1_000_000, 4096, 8
        rng = np.random.default_rng(0)
        raw = _batch(rng, V, E, B=B, w=w)
        packed = wirepack.pack_batch(raw, V, E)
        raw_b = sum(a.nbytes for a in raw.values())
        got_b = wirepack.packed_nbytes(packed)
        assert raw_b == B * (4 * w + 8)
        assert got_b <= B * 22
        assert raw_b / got_b > 1.8

    def test_window_cap(self):
        V, E = 100, 100
        rng = np.random.default_rng(1)
        raw = _batch(rng, V, E, B=4, w=300)
        with pytest.raises(ValueError, match="255"):
            wirepack.pack_batch(raw, V, E)
        assert not wirepack.feed_enabled("auto", V, E, window_size=300)
        with pytest.raises(ValueError, match="packed_feed"):
            wirepack.feed_enabled("on", V, E, window_size=300)

    def test_caps_and_modes(self):
        assert wirepack.hi_bits(65_536) == 0
        assert wirepack.hi_bits(65_537) == 1
        assert wirepack.hi_bits(250_000) == 2
        assert wirepack.hi_bits(1_000_000) == 4
        assert wirepack.hi_bits(16_777_216) == 8
        with pytest.raises(ValueError, match="24"):
            wirepack.hi_bits(1 << 25)
        assert not wirepack.packable(1 << 25, 100)
        assert not wirepack.feed_enabled("off", 100, 100)
        with pytest.raises(ValueError, match="packed_feed"):
            wirepack.feed_enabled("on", 1 << 25, 100)
        with pytest.raises(ValueError, match="unknown"):
            wirepack.feed_enabled("bogus", 100, 100)
        # auto stays off (unmeasured on a GPU host); explicit on works
        assert not wirepack.feed_enabled("auto", 100, 100)
        assert wirepack.feed_enabled("on", 100, 100)


class TestTrainParity:
    def test_packed_feed_matches_raw(self, tmp_path):
        """train() with packed_feed='on' produces the SAME final params
        as 'off' (bit-exact: the unpack is the identity on the ids)."""
        from sert_tpu import pipeline, recipes

        col = recipes.tiny_spec().build()
        base = recipes.tiny_recipe("loglinear")
        states = {}
        for mode in ("off", "on"):
            recipe = dataclasses.replace(
                base, train=dataclasses.replace(
                    base.train, packed_feed=mode, num_epochs=2))
            ddir = str(tmp_path / f"data_{mode}")
            pipeline.prepare_collection(col, ddir, recipe)
            state, _ = pipeline.train_from_dir(
                recipe, ddir, str(tmp_path / f"run_{mode}"), resume=False)
            states[mode] = jax.device_get(state.params)
        for k in states["off"]:
            np.testing.assert_array_equal(states["off"][k], states["on"][k],
                                          err_msg=k)
