"""Kernel parity tests (SURVEY.md section 5, item 2): every Pallas kernel vs
its plain jax.numpy reference on random inputs. The kernels compile for the
GPU only; here they run under the Pallas interpreter, asked for explicitly
(``interpret=True`` or engines.interpret_kernels). tests/test_gpu.py runs
the compiled kernels on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sert_tpu import engines
from sert_tpu.ops.exact_topk import exact_topk
from sert_tpu.ops.score_binmax import (LANES, binmax_reference,
                                       prepare_binmax_matrix, score_binmax,
                                       score_binmax_prepared)


def _data(rng, Q=8, E=1000, d=32):
    R = jnp.asarray(rng.normal(size=(Q, d)).astype(np.float32))
    M = jnp.asarray(rng.normal(size=(E, d)).astype(np.float32))
    return R, M


def _ref_scores(R, M, bias=None, alpha=None):
    s = np.asarray(R, np.float32).astype(np.float64) @ np.asarray(
        M, np.float32).astype(np.float64).T
    if bias is not None:
        a = np.ones(s.shape[0]) if alpha is None else np.asarray(alpha)
        s = s + a[:, None] * np.asarray(bias)[None, :]
    return s


def _oracle_bins(s, E, bw=LANES):
    n_bins = -(-E // bw)
    sp = np.full((s.shape[0], n_bins * bw), -np.inf)
    sp[:, :E] = s
    return sp.reshape(s.shape[0], n_bins, bw).max(axis=-1)


# bf16 operands: each product is exact in fp32 after rounding the inputs to
# 8 mantissa bits, so against an fp64 oracle on the ROUNDED inputs only the
# fp32 accumulation order remains (atol 1e-4 at d <= 128, |x| ~ N(0, 1)).
BF16_ROUNDED_ATOL = 1e-4


class TestScoreBinmax:
    @pytest.mark.parametrize("Q,E", [(8, 256), (8, 1000), (5, 2049),
                                     (70, 4097)])
    @pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
    def test_kernel_matches_reference(self, Q, E, dtype):
        """Ragged E (tail bin), Q not a multiple of the query block, both
        prefilter dtypes: kernel == XLA reference == fp64 oracle on the
        same operands. Padded entity rows are masked in-kernel, so the
        tail bin is exact too."""
        rng = np.random.default_rng(E + Q)
        R, M = _data(rng, Q=Q, E=E)
        Mp = prepare_binmax_matrix(M, dtype=dtype)
        got = np.asarray(score_binmax_prepared(R, Mp, E, interpret=True))
        ref = np.asarray(binmax_reference(R, Mp, E))
        assert got.shape == ref.shape == (Q, -(-E // LANES))
        np.testing.assert_allclose(got, ref, atol=BF16_ROUNDED_ATOL)
        Rr, Mr = R.astype(dtype), M.astype(dtype)
        want = _oracle_bins(_ref_scores(Rr.astype(jnp.float32),
                                        Mr.astype(jnp.float32)), E)
        np.testing.assert_allclose(got, want, atol=BF16_ROUNDED_ATOL)

    @pytest.mark.parametrize("with_alpha", [False, True])
    def test_bias_and_alpha(self, with_alpha):
        rng = np.random.default_rng(0)
        R, M = _data(rng, E=700)
        bias = jnp.asarray(rng.normal(size=700).astype(np.float32))
        alpha = (jnp.asarray(rng.integers(1, 5, size=8).astype(np.float32))
                 if with_alpha else None)
        bins = np.asarray(score_binmax(R, M, bias, alpha, interpret=True))
        s = _ref_scores(R.astype(jnp.bfloat16).astype(jnp.float32),
                        M.astype(jnp.bfloat16).astype(jnp.float32),
                        bias, alpha)
        np.testing.assert_allclose(bins, _oracle_bins(s, 700), atol=1e-4)

    def test_bin_width_64(self):
        rng = np.random.default_rng(4)
        R, M = _data(rng, E=500)
        Mp = prepare_binmax_matrix(M)
        got = score_binmax_prepared(R, Mp, 500, bin_width=64, interpret=True)
        ref = binmax_reference(R, Mp, 500, bin_width=64)
        assert got.shape == (8, 8)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   atol=BF16_ROUNDED_ATOL)


class TestKernelBackendGuard:
    """A kernel on a backend it cannot compile for raises instead of
    silently dropping into the interpreter."""

    def test_sweep_refuses_cpu(self):
        R, M = _data(np.random.default_rng(0), E=300)
        with pytest.raises(RuntimeError, match="GPU only"):
            score_binmax(R, M)

    def test_sampled_lse_refuses_cpu(self):
        from sert_tpu.ops.sampled_lse import sampled_lse
        with pytest.raises(RuntimeError, match="GPU only"):
            sampled_lse(jnp.ones((4, 16)), jnp.ones((32, 16)),
                        jnp.zeros(32), jnp.arange(32), jnp.arange(4))

    def test_forced_engine_refuses_cpu(self):
        """engine "exact" with the Triton sweep forced, no interpreter."""
        R, M = _data(np.random.default_rng(1), E=300)
        with pytest.raises(RuntimeError, match="GPU only"):
            exact_topk(R, M, k=5, sweep="triton")

    def test_model_fused_on_refuses_cpu(self):
        from sert_tpu.models import lse
        from sert_tpu.utils.config import ModelConfig
        cfg = ModelConfig(model="lse", objective="sampled_softmax",
                          vocab_size=30, num_entities=20, word_dim=8,
                          entity_dim=8, num_negatives=8, fused_softmax="on")
        params = lse.init(jax.random.key(0), cfg)
        batch = {"windows": jnp.ones((4, 3), jnp.int32),
                 "lengths": jnp.full((4,), 3, jnp.int32),
                 "entities": jnp.arange(4, dtype=jnp.int32)}
        with pytest.raises(RuntimeError, match="GPU only"):
            lse.loss_sampled_softmax(params, batch, cfg,
                                     rng=jax.random.key(1))


class TestExactTopk:
    @pytest.mark.parametrize("sweep", ["xla", "triton"])
    @pytest.mark.parametrize("E,k", [(1000, 10), (2048, 100), (300, 50)])
    def test_exact_vs_dense(self, E, k, sweep):
        """The bf16 prefilter only PRUNES; the rescore uses original fp32
        inputs, so results must match the fp32 dense oracle (mismatches
        allowed only inside prefilter noise at the boundary). Both sweeps:
        the Triton kernel (interpreted) and the XLA reference."""
        rng = np.random.default_rng(E + k)
        R, M = _data(rng, E=E)
        got_s, got_i = exact_topk(R, M, k=k, sweep=sweep,
                                  interpret=sweep == "triton")
        dense = _ref_scores(R, M).astype(np.float32)
        want_i = np.argsort(-dense, axis=1)[:, :k]
        want_s = np.take_along_axis(dense, want_i, axis=1)
        got_from_dense = np.take_along_axis(dense, np.asarray(got_i), axis=1)
        np.testing.assert_allclose(np.asarray(got_s), got_from_dense,
                                   rtol=1e-5, atol=1e-5)  # scores are honest
        # ranking: allow index mismatch only within bf16 prefilter noise
        miss = (np.asarray(got_i) != want_i)
        if miss.any():
            d_scores = np.abs(got_from_dense[miss] - want_s[miss])
            assert d_scores.max() < 0.1

    def test_with_bias(self):
        rng = np.random.default_rng(5)
        R, M = _data(rng, E=640)
        bias = jnp.asarray(rng.normal(size=640).astype(np.float32) * 3)
        alpha = jnp.asarray(np.full(8, 2.0, np.float32))
        got_s, got_i = exact_topk(R, M, bias=bias, alpha=alpha, k=20)
        Rb = R.astype(jnp.bfloat16).astype(jnp.float32)
        Mb = M.astype(jnp.bfloat16).astype(jnp.float32)
        dense = np.asarray(jnp.dot(Rb, Mb.T)) + 2.0 * np.asarray(bias)[None, :]
        want_i = np.argsort(-dense, axis=1)[:, :20]
        got_sc = np.take_along_axis(dense, np.asarray(got_i), axis=1)
        want_sc = np.take_along_axis(dense, want_i, axis=1)
        np.testing.assert_allclose(got_sc, want_sc, rtol=1e-3, atol=2e-2)

    def test_packed_winners_trigger_exact_fallback(self):
        """Adversarial case for the hierarchical final selection: >m true
        winners packed into ONE 128-entity bin (duplicated vectors) must
        still return the exact top-k via the verified fallback."""
        rng = np.random.default_rng(8)
        d, E, k = 16, 640, 30
        M = rng.normal(size=(E, d)).astype(np.float32) * 0.01
        q = rng.normal(size=(d,)).astype(np.float32)
        # plant 40 near-identical high-scoring entities inside bin 2
        lo = 2 * 128
        M[lo:lo + 40] = (q / np.linalg.norm(q))[None, :] * 10.0
        M[lo:lo + 40] += rng.normal(size=(40, d)).astype(np.float32) * 1e-4
        R = jnp.asarray(np.stack([q] * 8))
        got_s, got_i = exact_topk(R, jnp.asarray(M), k=k)
        dense = np.asarray(R @ jnp.asarray(M).T)
        want_i = np.argsort(-dense, axis=1)[:, :k]
        want_s = np.take_along_axis(dense, want_i, axis=1)
        np.testing.assert_allclose(np.sort(np.asarray(got_s), axis=1),
                                   np.sort(want_s, axis=1), rtol=1e-5,
                                   atol=1e-5)
        # all 30 winners come from the packed bin
        assert set(np.asarray(got_i)[0]) == set(want_i[0])

    def test_k_clamped(self):
        rng = np.random.default_rng(6)
        R, M = _data(rng, E=200)
        s, i = exact_topk(R, M, k=500)
        assert s.shape == (8, 200)
        # every entity present exactly once
        assert (np.sort(np.asarray(i), axis=1) == np.arange(200)).all()

    @pytest.mark.parametrize("with_bias", [False, True])
    def test_clustered_layout_matches_natural(self, with_bias):
        """layout="clustered" permutes the staged rows; results must be
        IDENTICAL to the natural layout (indices mapped back, bias paired
        with the permuted rows in both kernels)."""
        from sert_tpu.ops.exact_topk import (exact_topk_prepared,
                                             prepare_entities)
        rng = np.random.default_rng(17)
        R, M = _data(rng, E=1500)
        bias = (jnp.asarray(rng.normal(size=1500).astype(np.float32))
                if with_bias else None)
        alpha = (jnp.asarray(np.full(8, 1.5, np.float32))
                 if with_bias else None)
        nat = prepare_entities(M)
        clu = prepare_entities(M, layout="clustered")
        assert clu.perm is not None and sorted(np.asarray(clu.perm)) == \
            list(range(1500))
        s0, i0 = exact_topk_prepared(R, nat, bias, alpha, k=40)
        s1, i1 = exact_topk_prepared(R, clu, bias, alpha, k=40)
        np.testing.assert_allclose(np.asarray(s0), np.asarray(s1),
                                   rtol=1e-5, atol=1e-5)
        # continuous random scores: winners are unique -> same entities
        np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))

    @pytest.mark.parametrize("na", [2, 64])
    def test_adaptive_bins_exact_both_branches(self, na):
        """adaptive_bins must be exact whether the quick path suffices
        (large na) or the verified fallback fires (tiny na)."""
        from sert_tpu.ops.exact_topk import (exact_topk_prepared,
                                             prepare_entities)
        rng = np.random.default_rng(100 + na)
        R, M = _data(rng, E=2048)
        prep = prepare_entities(M, layout="clustered")
        s0, i0 = exact_topk_prepared(R, prep, k=30)
        s1, i1 = exact_topk_prepared(R, prep, k=30, adaptive_bins=na)
        np.testing.assert_allclose(np.asarray(s0), np.asarray(s1),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))

    @pytest.mark.slow
    def test_adaptive_bins_fuzz(self):
        from sert_tpu.ops.exact_topk import (exact_topk_prepared,
                                             prepare_entities)
        rng = np.random.default_rng(7)
        for trial in range(6):
            E = int(rng.integers(300, 3000))
            k = int(rng.integers(5, 80))
            na = int(rng.integers(1, k + 12))
            layout = "clustered" if trial % 2 else "natural"
            R, M = _data(rng, Q=4, E=E)
            prep = prepare_entities(M, layout=layout)
            s0, i0 = exact_topk_prepared(R, prep, k=k)
            s1, i1 = exact_topk_prepared(R, prep, k=k, adaptive_bins=na)
            np.testing.assert_allclose(np.asarray(s0), np.asarray(s1),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"E={E} k={k} na={na}")
            np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))


class TestPrepSweepTileConsistency:
    """Regression: the sweep tile size must come from the prepare stage.

    prepare_binmax_matrix pads entity rows to a multiple of ITS te; a sweep
    run with a LARGER te would floor the grid and silently skip the tail
    rows, losing true winners living there."""

    def test_non_default_prep_te_keeps_tail_rows(self):
        # E=5000 pads to 6144 under te=2048 — an odd multiple of 2048, NOT
        # a multiple of the old hardcoded sweep te=4096, which dropped rows
        # 4096..4999. Winners planted there must be found.
        from sert_tpu.ops.exact_topk import (exact_topk_prepared,
                                             prepare_entities)
        rng = np.random.default_rng(11)
        d, E, k = 32, 5000, 10
        M = rng.normal(size=(E, d)).astype(np.float32) * 0.01
        q = rng.normal(size=(d,)).astype(np.float32)
        M[4500:4500 + k] = (q / np.linalg.norm(q))[None, :] * 5.0
        R = jnp.asarray(np.stack([q] * 8))
        prep = prepare_entities(jnp.asarray(M), te=2048)
        assert prep.te == 2048
        got_s, got_i = exact_topk_prepared(R, prep, k=k)
        assert np.isfinite(np.asarray(got_s)).all()
        assert set(np.asarray(got_i)[0]) == set(range(4500, 4500 + k))

    def test_mismatched_sweep_te_rejected(self):
        from sert_tpu.ops.score_binmax import (prepare_binmax_matrix,
                                               score_binmax_prepared)
        M = jnp.zeros((5000, 32), jnp.float32)
        Mp = prepare_binmax_matrix(M, te=2048)   # 6144 rows
        with pytest.raises(ValueError, match="multiple of te"):
            score_binmax_prepared(jnp.zeros((4, 32), jnp.float32), Mp,
                                  5000, te=4096, interpret=True)


@pytest.mark.slow
class TestPrefilterTrainedGeometry:
    """Round-2 VERDICT weak item 4: the bf16-prefilter boundary caveat
    (ops/exact_topk.py docstring) was only ever tested on RANDOM matrices,
    whose top-k margins are comfortable. Trained, clustered embeddings are
    the risk case. This trains a real (small) LSE — sibling entities share
    signature terms, so their embeddings converge to near-duplicates with
    sub-bf16 margins — then audits both prefilter dtypes against a float64
    oracle, mirroring the 1M-scale audit (benchmarks/stress_1m.py --audit;
    measured 0 misses on the trained 1M matrix)."""

    def _train_clustered(self, E=768, V=2048, d=32, group=8, steps=240):
        from sert_tpu.models import api
        from sert_tpu.train.step import init_state, make_train_step
        from sert_tpu.utils.config import ModelConfig, TrainConfig

        cfg = ModelConfig(model="lse", vocab_size=V, num_entities=E,
                          word_dim=d, entity_dim=d,
                          objective="sampled_softmax", num_negatives=64)
        tcfg = TrainConfig(batch_size=256, learning_rate=5e-2,
                           optimizer="adagrad", donate_state=False)
        state = init_state(jax.random.key(0), cfg, tcfg)
        step = make_train_step(cfg, tcfg,
                               noise=jnp.zeros((E,), jnp.float32))
        rng = np.random.default_rng(0)
        n_groups = E // group
        # group g owns an 8-term signature; every entity in g draws windows
        # from it -> siblings become near-duplicate embeddings.
        sig = rng.integers(0, V, size=(n_groups, 8)).astype(np.int32)
        for _ in range(steps):
            ents = rng.integers(0, E, size=256).astype(np.int32)
            g = ents // group
            cols = rng.integers(0, 8, size=(256, 5))
            batch = {"windows": sig[g[:, None], cols].astype(np.int32),
                     "lengths": np.full(256, 5, np.int32),
                     "entities": ents}
            state, _ = step(state, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        M = api.entity_matrix(state.params, cfg).astype(jnp.float32)
        M = M / jnp.maximum(jnp.linalg.norm(M, axis=-1, keepdims=True), 1e-9)
        # queries: one per group, the signature window itself
        from sert_tpu.models import lse
        qw = jnp.asarray(sig[:, :5])
        R = lse.window_rep(state.params, qw,
                           jnp.full((n_groups,), 5, jnp.int32), cfg)
        R = R / jnp.maximum(jnp.linalg.norm(R, axis=-1, keepdims=True), 1e-9)
        return np.asarray(R), np.asarray(M)

    def test_trained_margins_vs_float64_oracle(self):
        from sert_tpu.ops.exact_topk import (exact_topk_prepared,
                                             prepare_entities)
        k = 24
        R, M = self._train_clustered()
        scores = R.astype(np.float64) @ M.astype(np.float64).T
        order = np.argsort(-scores, axis=1)
        oracle = order[:, :k]
        # sanity: the geometry IS the risk case — the top-k boundary margin
        # must be tiny for a meaningful audit (siblings nearly tie).
        kth = np.take_along_axis(scores, order[:, k - 1:k], axis=1)
        k1 = np.take_along_axis(scores, order[:, k:k + 1], axis=1)
        assert np.median(kth - k1) < 0.05, "generator no longer clustered"

        for dtype, tol in (("bfloat16", 6e-3), ("float32", 1e-5)):
            prep = prepare_entities(jnp.asarray(M), prefilter_dtype=dtype)
            _, idx = exact_topk_prepared(jnp.asarray(R), prep, k=k)
            got = np.asarray(idx)
            for q in range(got.shape[0]):
                miss = set(oracle[q].tolist()) - set(got[q].tolist())
                # a miss is only REAL if its margin below the k-th value
                # exceeds the dtype's resolution-scaled tolerance
                real = [m for m in miss
                        if scores[q, m] < kth[q, 0] - tol]
                assert not real, (
                    f"{dtype} prefilter missed {real} at margins "
                    f"{[float(kth[q, 0] - scores[q, m]) for m in real]}")


class TestAdaptiveAcceptanceMargin:
    """The adaptive two-phase acceptance cut must carry prefilter-dtype
    slack: bf16 bin maxima round, so an unrescored bin whose TRUE max
    beats the provisional theta by less than bf16 resolution would
    otherwise be skipped — unlike bin selection, there is no pad_bins to
    absorb the reshuffle (regression test for the margin)."""

    def test_near_tie_bin_falls_back_not_skipped(self):
        from sert_tpu.ops.exact_topk import (exact_topk_prepared,
                                             prepare_entities)
        d, bw = 8, 128
        # Bin 0: scores 1.0 + i*1e-5 (i = 0..127). Bin 1: one entity at
        # 1.001265 — truly the SECOND best overall, but bf16 collapses
        # every bin-max to 1.0, so a margin-less acceptance cut at
        # theta ~ 1.00124 (the phase-1 k-th) would skip bin 1 entirely.
        s_bin0 = 1.0 + np.arange(128) * 1e-5
        s_bin1 = np.zeros(128)
        s_bin1[0] = 1.001265
        scores = np.concatenate([s_bin0, s_bin1]).astype(np.float32)
        M = np.zeros((256, d), np.float32)
        M[:, 0] = scores
        R = np.zeros((1, d), np.float32)
        R[0, 0] = 1.0
        prep = prepare_entities(jnp.asarray(M))
        assert prep.bin_width == bw
        k = 4
        top_s, top_i = exact_topk_prepared(jnp.asarray(R), prep, k=k,
                                           adaptive_bins=1)
        order = np.argsort(scores)[::-1][:k]
        np.testing.assert_array_equal(np.sort(np.asarray(top_i[0])),
                                      np.sort(order))
        np.testing.assert_allclose(np.asarray(top_s[0]),
                                   np.sort(scores[order])[::-1],
                                   rtol=1e-6, atol=1e-6)

    def test_adaptive_bins_too_small_for_k_raises(self):
        from sert_tpu.ops.exact_topk import (exact_topk_prepared,
                                             prepare_entities)
        rng = np.random.default_rng(3)
        R, M = _data(rng, Q=2, E=2048)
        prep = prepare_entities(M)
        with pytest.raises(ValueError, match="adaptive_bins"):
            exact_topk_prepared(R, prep, k=200, adaptive_bins=1)


class TestSampledLse:
    """ops/sampled_lse: the flash masked-lse over shared sampled-softmax
    candidates (the [B, k] logits never reach device memory) vs the XLA
    composition models/lse.loss_sampled_softmax builds."""

    def _case(self, seed, B, k, d, E=500, hits=True):
        rng = np.random.default_rng(seed)
        reps = jnp.asarray(rng.normal(size=(B, d)).astype(np.float32))
        cand = jnp.asarray(rng.normal(size=(k, d)).astype(np.float32) * 0.3)
        corr = jnp.asarray(rng.normal(size=(k,)).astype(np.float32))
        ids = rng.integers(0, E, size=k).astype(np.int32)
        pos = rng.integers(0, E, size=B).astype(np.int32)
        if hits:  # force accidental hits: some candidates ARE row positives
            ids[: min(B, k)] = pos[: min(B, k)]
        return reps, cand, corr, jnp.asarray(ids), jnp.asarray(pos)

    # fp32 operands: the kernel and XLA differ only in summation order.
    @pytest.mark.parametrize("B,k,d,E", [
        (20, 300, 24, 500),    # ragged k tail, B below one batch block
        (8, 256, 128, 500),    # exact tiles
        (16, 129, 40, 500),    # k one past a tile
        (70, 1000, 32, 500),   # B not a multiple of the batch block
        (64, 64, 16, 64),      # k near E: hits everywhere
        (33, 200, 8, 200),     # k = E, d padded to 16
    ])
    def test_fwd_and_grads_match_xla(self, B, k, d, E):
        from sert_tpu.ops.sampled_lse import (sampled_lse,
                                              sampled_lse_reference)
        reps, cand, corr, ids, pos = self._case(B + k, B, k, d, E=E)
        w = jnp.asarray(np.random.default_rng(1).normal(size=(B,))
                        .astype(np.float32))
        f = lambda r, c, co: jnp.sum(w * sampled_lse(r, c, co, ids, pos,
                                                     interpret=True))
        r_ = lambda r, c, co: jnp.sum(w * sampled_lse_reference(
            r, c, co, ids, pos))
        np.testing.assert_allclose(np.asarray(f(reps, cand, corr)),
                                   np.asarray(r_(reps, cand, corr)),
                                   rtol=1e-5)
        gf = jax.grad(f, argnums=(0, 1, 2))(reps, cand, corr)
        gr = jax.grad(r_, argnums=(0, 1, 2))(reps, cand, corr)
        for a, c in zip(gf, gr):
            np.testing.assert_allclose(np.asarray(a), np.asarray(c),
                                       rtol=1e-3, atol=1e-4)

    @pytest.mark.parametrize("B,k", [(4096, 129), (1, 40)])
    def test_split_layout_covers_candidates(self, B, k):
        """The candidate axis splits into a power-of-two number of spans
        that tile whole loop tiles and cover every candidate."""
        from sert_tpu.ops.sampled_lse import BLOCK_B, BLOCK_K, _layout
        Bp, splits, span, Kp = _layout(B, k)
        assert Bp % BLOCK_B == 0 and Bp >= B
        assert splits & (splits - 1) == 0
        assert span % BLOCK_K == 0 and Kp == splits * span >= k
        assert Kp - k < span

    def test_all_masked_row_softplus_loss_and_grad_zero(self):
        """A row whose EVERY candidate is an accidental hit contributes
        ~zero loss and exactly-zero gradient through the softplus form the
        model uses (the documented contract; the raw lse is ~-1e30)."""
        from sert_tpu.ops.sampled_lse import (sampled_lse,
                                              sampled_lse_reference)
        reps, cand, corr, ids, pos = self._case(9, 6, 40, 16, hits=False)
        ids = jnp.full_like(ids, 7)
        pos = pos.at[2].set(7)  # row 2: all 40 candidates masked
        s_pos = jnp.asarray(np.random.default_rng(2).normal(size=(6,))
                            .astype(np.float32))

        def loss(r, c, co):
            return jnp.sum(jax.nn.softplus(
                sampled_lse(r, c, co, ids, pos, interpret=True) - s_pos))

        def ref(r, c, co):
            return jnp.sum(jax.nn.softplus(
                sampled_lse_reference(r, c, co, ids, pos) - s_pos))

        out = sampled_lse(reps, cand, corr, ids, pos, interpret=True)
        assert float(out[2]) < -1e29
        np.testing.assert_allclose(np.asarray(loss(reps, cand, corr)),
                                   np.asarray(ref(reps, cand, corr)),
                                   rtol=1e-5)
        gf = jax.grad(loss, argnums=(0, 1, 2))(reps, cand, corr)
        gr = jax.grad(ref, argnums=(0, 1, 2))(reps, cand, corr)
        assert not np.any(np.asarray(gf[0][2]))  # row 2's dreps is exactly 0
        for a, c in zip(gf, gr):
            np.testing.assert_allclose(np.asarray(a), np.asarray(c),
                                       rtol=1e-3, atol=1e-4)

    # bf16 operands with fp32 accumulation: relative error of order 1e-2
    # against the fp32 composition (8 mantissa bits per operand).
    @pytest.mark.parametrize("B,k,d", [(8, 200, 32), (70, 300, 128)])
    def test_bf16_candidates_and_compute(self, B, k, d):
        from sert_tpu.ops.sampled_lse import (sampled_lse,
                                              sampled_lse_reference)
        reps, cand, corr, ids, pos = self._case(11 + B, B, k, d)
        cand16 = cand.astype(jnp.bfloat16)
        out = sampled_lse(reps, cand16, corr, ids, pos, "bfloat16", True)
        ref = sampled_lse_reference(reps, cand16, corr, ids, pos)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=0.02, atol=0.05)
        g = jax.grad(lambda c: jnp.sum(sampled_lse(
            reps, c, corr, ids, pos, "bfloat16", True)))(cand16)
        gr = jax.grad(lambda c: jnp.sum(sampled_lse_reference(
            reps, c, corr, ids, pos)))(cand16.astype(jnp.float32))
        assert g.dtype == jnp.bfloat16
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(gr), rtol=0.05, atol=0.02)

    def test_model_sampled_loss_fused_matches_unfused(self):
        """loss_sampled_softmax with fused_softmax='on' equals the XLA
        composition, values and gradients (the lse.py integration)."""
        from sert_tpu.models import lse
        from sert_tpu.utils.config import ModelConfig
        rng = np.random.default_rng(13)
        B, V, E, k = 16, 60, 40, 12
        batch = {"windows": rng.integers(0, V, size=(B, 5)).astype(np.int32),
                 "lengths": np.full(B, 5, np.int32),
                 "entities": rng.integers(0, E, size=B).astype(np.int32)}
        negatives = jnp.asarray(rng.integers(0, E, size=k).astype(np.int32))
        base = ModelConfig(model="lse", objective="sampled_softmax",
                           vocab_size=V, num_entities=E, word_dim=12,
                           entity_dim=8, num_negatives=k)
        params = lse.init(jax.random.key(4), base)
        on, off = base.replace(fused_softmax="on"), base.replace(
            fused_softmax="off")
        f_on = lambda p: lse.loss_sampled_softmax(p, batch, on,
                                                  negatives=negatives)
        f_off = lambda p: lse.loss_sampled_softmax(p, batch, off,
                                                   negatives=negatives)
        with engines.interpret_kernels():
            l_on = float(f_on(params))
            g_on = jax.grad(f_on)(params)
        assert l_on == pytest.approx(float(f_off(params)), rel=1e-5)
        g_off = jax.grad(f_off)(params)
        for key in g_on:
            np.testing.assert_allclose(np.asarray(g_on[key]),
                                       np.asarray(g_off[key]),
                                       rtol=1e-3, atol=1e-5, err_msg=key)


class TestRescoreDtype:
    """ScoreConfig.rescore_dtype="auto" (round-5): the 10M train-then-score
    OOM fix. Policy unit test + bf16-staged ranking agreement."""

    @pytest.mark.parametrize("limit_gib", [16, 80])
    def test_auto_policy_follows_device_limit(self, limit_gib):
        """fp32 while the fp32 copy fits an eighth of the device memory
        limit (injected here), then bf16; explicit choices pass through."""
        limit = limit_gib << 30
        e_at = engines.rescore_fp32_limit(limit) // (128 * 4)
        assert engines.rescore_dtype("auto", e_at, 128, limit) == "float32"
        assert engines.rescore_dtype("auto", e_at + 1, 128,
                                     limit) == "bfloat16"
        assert engines.rescore_dtype("auto", 1_000_000, 128,
                                     limit) == "float32"
        assert engines.rescore_dtype("float32", 10**9, 128,
                                     limit) == "float32"
        assert engines.rescore_dtype("bfloat16", 10, 8, limit) == "bfloat16"
        with pytest.raises(ValueError):
            engines.rescore_dtype("float16", 10, 8, limit)

    def test_auto_without_device_limit_is_fp32(self):
        # The CPU reports no memory limit: host memory, no bf16 fallback.
        assert engines.rescore_dtype("auto", 10**8, 128) == "float32"

    def test_bf16_rescore_ranking_agrees(self):
        """bf16-staged rescore must return the same winner SET as fp32 on
        continuous random data (scores are bf16-rounded, so compare the
        index sets and fp64-recomputed score agreement, not raw scores)."""
        from sert_tpu.ops.exact_topk import (exact_topk_prepared,
                                             prepare_entities)
        rng = np.random.default_rng(23)
        R, M = _data(rng, E=1500)
        p32 = prepare_entities(M)
        p16 = prepare_entities(M, rescore_dtype="bfloat16")
        assert p16.M_binned.dtype == jnp.bfloat16
        assert p32.M_binned.dtype == jnp.float32
        s0, i0 = exact_topk_prepared(R, p32, k=40)
        s1, i1 = exact_topk_prepared(R, p16, k=40)
        ref = _ref_scores(R, M)
        for q in range(R.shape[0]):
            want = set(np.argsort(-ref[q])[:40].tolist())
            got16 = set(np.asarray(i1[q]).tolist())
            # bf16 rescore can swap entries whose fp64 margin is below bf16
            # resolution; on N(0,1) dot products at d=32 that is rare —
            # allow at most 2 boundary swaps out of 40.
            assert len(want - got16) <= 2, (q, sorted(want - got16))
        np.testing.assert_allclose(np.asarray(s1, np.float32),
                                   np.take_along_axis(
                                       ref, np.asarray(i1), axis=1),
                                   rtol=2e-2, atol=2e-2)

    def test_score_topics_resolves_auto(self, monkeypatch):
        """score_topics must thread the RESOLVED dtype into staging."""
        import importlib
        # sert_tpu.ops.__init__ re-exports a FUNCTION named exact_topk, so
        # fetch the module object itself for patching.
        et = importlib.import_module("sert_tpu.ops.exact_topk")
        from sert_tpu.scoring import run as srun
        seen = {}
        real = et.prepare_entities

        def spy(M, **kw):
            seen.update(kw)
            return real(M, **kw)

        monkeypatch.setattr(srun, "resolve_engine", lambda sc, E: "exact")
        monkeypatch.setattr(et, "prepare_entities", spy)
        from sert_tpu.models import api
        from sert_tpu.scoring.run import score_topics
        from sert_tpu.utils.config import ModelConfig, ScoreConfig
        cfg = ModelConfig(model="lse", vocab_size=60, num_entities=300,
                          word_dim=9, entity_dim=8)
        params = api.init_params(jax.random.key(0), cfg)
        enc = {"q1": [3, 5], "q2": [7]}
        names = [f"e{i}" for i in range(300)]
        score_topics(params, cfg, enc, names,
                     ScoreConfig(top_k=10, rescore_dtype="bfloat16"))
        assert seen.get("rescore_dtype") == "bfloat16"
