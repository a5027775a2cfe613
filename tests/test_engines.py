"""sert_tpu/engines.py: every engine and kernel choice, from E, k and the
platform, and the explicit opt-in to the Pallas interpreter. Also the
device check of chip_smoke.py, which must refuse anything but a GPU."""

import types

import jax
import pytest

from sert_tpu import engines
from sert_tpu.scoring.run import resolve_engine
from sert_tpu.utils.config import ScoreConfig


@pytest.fixture
def on_gpu(monkeypatch):
    monkeypatch.setattr(engines, "on_gpu", lambda: True)


class TestScoringEngine:
    @pytest.mark.parametrize("E,k,want", [
        (1000, 100, "dense"),
        (1 << 15, 100, "dense"),
        ((1 << 15) + 1, 100, "exact"),
        ((1 << 15) + 1, 1000, "dense"),
        (1 << 18, 1000, "dense"),
        ((1 << 18) + 1, 1000, "exact"),
        (1_000_000, 100, "exact"),
        (1_000_000, 1000, "exact"),
        (10_000_000, 1000, "exact"),
    ])
    def test_gpu(self, on_gpu, E, k, want):
        assert engines.scoring_engine(E, k) == want

    @pytest.mark.parametrize("E,chunk,want", [
        (50, 100, "dense"), (100, 100, "dense"), (101, 100, "streaming"),
        (1_000_000, 1 << 15, "streaming")])
    def test_cpu(self, E, chunk, want):
        assert engines.scoring_engine(E, 100, chunk) == want

    def test_auto_config_resolves_through_the_module(self, on_gpu):
        assert resolve_engine(ScoreConfig(top_k=1000), 1_000_000) == "exact"
        assert resolve_engine(ScoreConfig(engine="streaming"),
                              1_000_000) == "streaming"


class TestKernelChoices:
    def test_binmax_sweep_cpu(self):
        assert engines.binmax_sweep() == "xla"

    def test_binmax_sweep_gpu(self, on_gpu):
        assert engines.binmax_sweep() == "triton"

    def test_binmax_sweep_interpreted(self):
        with engines.interpret_kernels():
            assert engines.binmax_sweep() == "triton"

    def test_local_engine(self, monkeypatch):
        assert engines.local_engine() == "binmax"
        monkeypatch.setattr(engines, "on_gpu", lambda: True)
        assert engines.local_engine() == "exact"

    @pytest.mark.parametrize("mode,k,gpu,want", [
        ("on", 16, False, True),
        ("off", 1 << 15, True, False),
        ("auto", engines.SAMPLED_LSE_MIN_NEGATIVES, True, True),
        ("auto", engines.SAMPLED_LSE_MIN_NEGATIVES - 1, True, False),
        ("auto", 1 << 15, False, False),
    ])
    def test_fused_sampled_lse(self, monkeypatch, mode, k, gpu, want):
        monkeypatch.setattr(engines, "on_gpu", lambda: gpu)
        assert engines.fused_sampled_lse(mode, k) is want

    def test_fused_sampled_lse_unknown_mode(self):
        with pytest.raises(ValueError, match="fused_softmax"):
            engines.fused_sampled_lse("maybe", 4096)


class TestInterpretOptIn:
    def test_default_is_compiled(self):
        assert engines.interpret_default(None) is False

    def test_context_nests_and_restores(self):
        with engines.interpret_kernels():
            with engines.interpret_kernels():
                assert engines.interpret_default(None) is True
            assert engines.interpret_default(None) is True
            assert engines.interpret_default(False) is False
        assert engines.interpret_default(None) is False

    def test_explicit_argument_wins(self):
        assert engines.interpret_default(True) is True

    def test_require_raises_off_gpu(self):
        with pytest.raises(RuntimeError, match="GPU only"):
            engines.require_kernel_backend(False, "k")

    def test_require_passes_interpreted(self):
        engines.require_kernel_backend(True, "k")

    def test_require_passes_on_gpu(self, on_gpu):
        engines.require_kernel_backend(False, "k")


class TestChipSmokeDevice:
    def _fake(self, platform):
        return types.SimpleNamespace(platform=platform,
                                     device_kind="fake " + platform)

    def test_refuses_the_cpu(self):
        import chip_smoke
        with pytest.raises(SystemExit):
            chip_smoke.check_device(jax.devices())

    def test_refuses_too_few_gpus(self):
        import chip_smoke
        with pytest.raises(SystemExit):
            chip_smoke.check_device([self._fake("gpu")], count=4)

    def test_accepts_a_gpu(self):
        import chip_smoke
        dev = self._fake("gpu")
        assert chip_smoke.check_device([dev]) is dev
