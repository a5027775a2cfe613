"""The flash sampled-softmax loss on the fake 8-device mesh.

The flagship objective shards its batch over ``data`` and its shared
candidates over ``model``; per-shard kernels (ops/sampled_lse, run under
the Pallas interpreter here) stitched with pmax/psum must match the XLA
composition for loss AND gradients across DP, TP and mixed mesh shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sert_tpu import engines
from sert_tpu.parallel.mesh import make_mesh
from sert_tpu.parallel.train import make_sharded_train_step
from sert_tpu.utils.config import ModelConfig, TrainConfig

B, D, E, V = 32, 16, 64, 50


def _batch(seed, batch_size=16, w=5):
    rng = np.random.default_rng(seed)
    return {"windows": rng.integers(0, V, size=(batch_size, w)).astype(np.int32),
            "lengths": np.full(batch_size, w, np.int32),
            "entities": rng.integers(0, E, size=batch_size).astype(np.int32)}


@pytest.fixture(autouse=True)
def _interpret_kernels():
    with engines.interpret_kernels():
        yield


class TestShardedSampledLse:
    """Mesh deployment of the FLAGSHIP objective (sampled-softmax LSE)
    through the flash kernel: batch over ``data``, shared candidates over
    ``model``, per-shard ops/sampled_lse + pmax/psum lse stitching
    (parallel/fused_loss.make_sharded_sampled_loss). Parity target: the
    XLA composition of the identical loss (same rng => same negatives)."""

    K = 16  # divides the (2,4)/(4,2) model axes; E=64 guarantees hits occur

    def _cfg(self, fused, k=K):
        return ModelConfig(model="lse", objective="sampled_softmax",
                           vocab_size=V, num_entities=E, word_dim=8,
                           entity_dim=8, num_negatives=k,
                           fused_softmax=fused)

    # (2, 4) is the mixed mesh; (1, 4) and (4, 1) are the four-card
    # layouts of the recipes (candidates over model / batch over data).
    @pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 4), (4, 1)])
    def test_loss_and_grads_match_xla(self, mesh_shape):
        from sert_tpu.models import api, lse
        from sert_tpu.parallel.fused_loss import make_sharded_sampled_loss
        mesh = make_mesh(mesh_shape)
        cfg = self._cfg("on")
        params = api.init_params(jax.random.key(0), cfg)
        batch = {k: jnp.asarray(v) for k, v in _batch(3).items()}
        rng = jax.random.key(7)
        sh = make_sharded_sampled_loss(cfg, mesh)
        ls, gs = jax.jit(jax.value_and_grad(sh), static_argnums=2)(
            params, batch, cfg, rng)
        ref = lambda p: lse.loss_sampled_softmax(p, batch, self._cfg("off"),
                                                 rng=rng)
        lr, gr = jax.value_and_grad(ref)(params)
        np.testing.assert_allclose(float(ls), float(lr), rtol=1e-5)
        for name in gr:
            np.testing.assert_allclose(np.asarray(gs[name]),
                                       np.asarray(gr[name]),
                                       atol=1e-5, rtol=1e-5, err_msg=name)

    def test_step_parity_fused_vs_xla(self):
        # Deployment shape: the full sharded train step routes the loss
        # through the kernel when fused_softmax='on' (parallel/train gate)
        # and must reproduce the XLA-composition step exactly.
        mesh = make_mesh((2, 4))
        states = {}
        for fused in ("on", "off"):
            tcfg = TrainConfig(batch_size=16, learning_rate=1e-2,
                               donate_state=False)
            step, init_fn, put_fn = make_sharded_train_step(
                self._cfg(fused), tcfg, mesh)
            state = init_fn()
            for i in range(3):
                state, metrics = step(state, put_fn(_batch(i)))
            assert np.isfinite(float(metrics["loss"]))
            states[fused] = jax.device_get(state.params)
        for k in states["on"]:
            np.testing.assert_allclose(np.asarray(states["on"][k]),
                                       np.asarray(states["off"][k]),
                                       atol=1e-5, rtol=1e-5, err_msg=k)

    def test_gate_and_rejection(self):
        from sert_tpu.parallel.fused_loss import make_sharded_sampled_loss
        from sert_tpu.parallel.train import _want_fused_sampled
        mesh = make_mesh((2, 4))
        # 'on' + mesh-indivisible k: loud error from the maker
        with pytest.raises(ValueError, match="divide"):
            make_sharded_sampled_loss(self._cfg("on", k=10), mesh)
        # 'auto' + indivisible k: silent fallback to the XLA composition
        assert not _want_fused_sampled(self._cfg("auto", k=10), mesh)
        # 'auto' + divisible k below the kernel's threshold: XLA too
        assert not _want_fused_sampled(self._cfg("auto"), mesh)
        # wrong family/objective: loud error
        with pytest.raises(ValueError, match="sampled_softmax"):
            make_sharded_sampled_loss(
                ModelConfig(model="lse", objective="nce", vocab_size=V,
                            num_entities=E, word_dim=8, entity_dim=8), mesh)
        assert not _want_fused_sampled(
            ModelConfig(model="loglinear", vocab_size=V, num_entities=E,
                        word_dim=8, fused_softmax="on"), mesh)

    @pytest.mark.slow
    @pytest.mark.parametrize("mesh_shape", [(4, 2), (1, 8), (8, 1)])
    def test_loss_parity_other_meshes(self, mesh_shape):
        from sert_tpu.models import api, lse
        from sert_tpu.parallel.fused_loss import make_sharded_sampled_loss
        mesh = make_mesh(mesh_shape)
        cfg = self._cfg("on")
        params = api.init_params(jax.random.key(1), cfg)
        batch = {k: jnp.asarray(v) for k, v in _batch(5).items()}
        rng = jax.random.key(11)
        sh = make_sharded_sampled_loss(cfg, mesh)
        ls, gs = jax.jit(jax.value_and_grad(sh), static_argnums=2)(
            params, batch, cfg, rng)
        lr, gr = jax.value_and_grad(
            lambda p: lse.loss_sampled_softmax(p, batch, self._cfg("off"),
                                               rng=rng))(params)
        np.testing.assert_allclose(float(ls), float(lr), rtol=1e-5)
        for name in gr:
            np.testing.assert_allclose(np.asarray(gs[name]),
                                       np.asarray(gr[name]),
                                       atol=1e-5, rtol=1e-5, err_msg=name)
