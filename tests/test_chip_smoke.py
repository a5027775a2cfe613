"""chip_smoke.py's phases on the CPU at tiny sizes, every kernel under the
Pallas interpreter: the script's wiring (kernel checks and timings, the
flagship's prepare -> train -> score -> serve, the four-device checks) runs
in the test suite, not only on the card. No time printed here is a device
measurement."""

import chip_smoke
from sert_tpu import engines

TINY = chip_smoke.Sizes(entities=3000, dim=32, queries=8, batch=64,
                        negatives=320, vocab=500, topics=20, depths=(10, 50),
                        rounds=1, iters=1)


def test_flagship_recipe_cuts_only_what_sizes_change():
    spec, recipe, cuts = chip_smoke.flagship_recipe(chip_smoke.FULL)
    assert [c.split()[0] for c in cuts] == ["SYNTH_1M.doc_len",
                                             "train.num_epochs"]
    assert (spec.num_entities, recipe.model.entity_dim,
            recipe.train.batch_size, recipe.model.num_negatives,
            recipe.score.top_k) == (1_000_000, 128, 4096, 32768, 1000)
    _, _, tiny_cuts = chip_smoke.flagship_recipe(TINY)
    assert len(tiny_cuts) == 9


def test_kernel_phase(capsys):
    with engines.interpret_kernels():
        chip_smoke.kernel_phase(TINY)
    out = capsys.readouterr().out
    for k in TINY.depths:
        assert f"exact_topk[triton] k={k}: top-{k} sets equal" in out
    assert "verdict sampled_lse:" in out


def test_flagship_phase(tmp_path, capsys):
    with engines.interpret_kernels():
        chip_smoke.flagship_phase(TINY, str(tmp_path))
    out = capsys.readouterr().out
    assert "epoch end -> train_from_dir returned" in out
    assert "serve burst: 16 concurrent requests" in out


def test_four_phase(capsys):
    with engines.interpret_kernels():
        chip_smoke.four_phase(TINY)
    out = capsys.readouterr().out
    assert "mesh (4, 1) train" in out
    assert "distributed ring k=50 vs one card" in out
    assert "sharded sampled-LSE loss mesh (2, 2)" in out
