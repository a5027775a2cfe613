"""The Pallas kernels compiled for the card (no interpreter) against their
plain references. Marked ``gpu``: they skip elsewhere. Run on the card:

    SERT_TEST_PLATFORM=cuda python -m pytest tests/ -m gpu
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sert_tpu.scoring.scorer import HIGHEST

pytestmark = pytest.mark.gpu


def _unit(key, shape):
    x = jax.random.normal(key, shape, jnp.float32)
    return x / jnp.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("Q,E", [(64, 100_003), (5, 4097)])
def test_sweep_compiled_matches_reference(gpu, Q, E):
    from sert_tpu.ops.score_binmax import (binmax_reference,
                                           prepare_binmax_matrix,
                                           score_binmax_prepared)
    k1, k2 = jax.random.split(jax.random.key(0))
    M, R = _unit(k1, (E, 128)), _unit(k2, (Q, 128))
    Mp = prepare_binmax_matrix(M)
    got = score_binmax_prepared(R, Mp, E)
    ref = binmax_reference(R, Mp, E)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=2.0 ** -8)


@pytest.mark.parametrize("k", [100, 1000])
def test_exact_engine_compiled_matches_dense(gpu, k):
    from sert_tpu.ops.exact_topk import exact_topk
    k1, k2 = jax.random.split(jax.random.key(1))
    M, R = _unit(k1, (200_000, 128)), _unit(k2, (64, 128))
    s, i = exact_topk(R, M, k=k, sweep="triton")
    dense = np.asarray(jnp.dot(R, M.T, precision=HIGHEST))
    np.testing.assert_allclose(np.asarray(s),
                               np.take_along_axis(dense, np.asarray(i), 1),
                               atol=1e-5)
    kth = np.sort(dense, axis=1)[:, -k]
    assert (np.asarray(s)[:, -1] >= kth - 1e-5).all()


def test_sampled_lse_compiled_matches_reference(gpu):
    from sert_tpu.ops.sampled_lse import sampled_lse, sampled_lse_reference
    B, K, d = 1000, 5000, 128
    ks = jax.random.split(jax.random.key(2), 3)
    reps = jnp.tanh(jax.random.normal(ks[0], (B, d)))
    cand = jax.random.normal(ks[1], (K, d)) / np.sqrt(d)
    corr = jax.random.normal(ks[2], (K,))
    ids = jnp.arange(K, dtype=jnp.int32) % 3000
    pos = jnp.arange(B, dtype=jnp.int32)
    f = lambda r, c, co: jnp.sum(sampled_lse(r, c, co, ids, pos, "bfloat16"))
    g = lambda r, c, co: jnp.sum(sampled_lse_reference(
        r, c, co, ids, pos, precision=HIGHEST))
    (lf, gf), (lg, gg) = (jax.value_and_grad(h, argnums=(0, 1, 2))(
        reps, cand, corr) for h in (f, g))
    assert abs(float(lf) - float(lg)) <= 1e-2 * abs(float(lg))
    for a, b in zip(gf, gg):
        assert float(jnp.linalg.norm(a - b) / jnp.linalg.norm(b)) <= 2e-2
