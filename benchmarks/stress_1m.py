"""Million-entity end-to-end stress: train -> score -> evaluate -> audit.

BASELINE.json config 5's spirit at TRAINING time (round-2 VERDICT missing
item 3): the 10M scoring benchmark proves the engine, this proves the
whole pipeline — hard-mode synthetic collection at E=1,000,000, sampled-
softmax LSE (bf16 compute, batch-shared negatives), exact-engine scoring,
native metrics — closing the train->query->evaluate loop at serving scale
on one chip.

The workdir PERSISTS (default /tmp/stress_1m) so the trained entity
matrix doubles as the realistic-geometry input for the bf16-prefilter
exactness audit (--audit; round-2 VERDICT item 5): trained, clustered
embeddings are exactly the case where top-k margins can drop below bf16
resolution (ops/exact_topk.py precision caveat). The audit compares the
default bf16-prefilter engine and the prefilter_dtype="float32" escape
hatch against a float64 host oracle and reports realized miss rates.

Usage:
  python benchmarks/stress_1m.py               # full run (gen+prep+train+eval)
  python benchmarks/stress_1m.py --audit       # reuse workdir, audit only
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python benchmarks/stress_1m.py --dryrun-mesh   # sharded-step proof
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json
import time

import numpy as np


def build_recipe(E, vocab_size, epochs=3, lr_schedule="constant",
                 num_negatives=1024, model="lse",
                 snapshot_dtype="float32", snapshot_every=1,
                 param_dtype="float32", sparse_update="auto",
                 final_snapshot="full"):
    from sert_tpu.utils.config import (DataConfig, ModelConfig, RecipeConfig,
                                       ScoreConfig, TrainConfig)
    dcfg = DataConfig(window_size=8, vocab_min_count=1, vocab_max_size=300_000)
    sched = ({} if lr_schedule == "constant"
             else dict(lr_schedule=lr_schedule, lr_final_fraction=0.05))
    return RecipeConfig(
        name="stress1m",
        data=dcfg,
        # model="lse_full" is the exact-objective anchor (round-4 negatives
        # ladder): the SAME window_rep/tanh geometry trained with the full
        # softmax over all E entities — the limit the importance-corrected
        # sampled estimator converges to.
        # param_dtype="bfloat16" + sparse_update="on" is the E=10M memory
        # configuration sized for a 16 GB device: fp32 params + dense adam
        # moments are ~15.4 GB, bf16 params/moments (~7.7 GB) + lazy
        # row-scatter updates fit with room for the gathered candidates.
        model=ModelConfig(model=model, vocab_size=vocab_size, num_entities=E,
                          word_dim=128, entity_dim=128,
                          objective="sampled_softmax",
                          num_negatives=num_negatives,
                          negative_distribution="unigram",
                          compute_dtype="bfloat16",
                          param_dtype=param_dtype),
        # steps_per_call=4 as in the flagship recipe.
        # epoch_snapshot="params": the run's per-epoch dumps carry params
        # only (the reference's own format) — the 1.9 GB adam full-state
        # fetch per epoch drops to 0.65 GB (the final epoch still writes
        # full state). The same snapshots feed --score-snapshots'
        # epochs-vs-quality curve.
        train=TrainConfig(batch_size=4096, num_epochs=epochs,
                          optimizer="adam",
                          learning_rate=3e-3, steps_per_call=4,
                          log_every_steps=200, epoch_snapshot="params",
                          snapshot_dtype=snapshot_dtype,
                          epoch_snapshot_every=snapshot_every,
                          sparse_update=sparse_update,
                          final_snapshot=final_snapshot,
                          **sched),
        # top_k=1000: recall@1000 is BASELINE.json's headline metric; the
        # SMEM-chunked bin path was proven at 10M and this makes depth-1000
        # the tested path at the 1M flagship scale too (round-3 VERDICT #1).
        score=ScoreConfig(top_k=1000, similarity="cosine", engine="exact"))


_METRICS = ("ndcg@100", "recip_rank", "recall@100", "recall@1000", "p@5")


def run_pipeline(workdir, E, run_name="run", epochs=3,
                 lr_schedule="constant", docs_per_entity=1,
                 num_negatives=1024, model="lse",
                 snapshot_dtype="float32", snapshot_every=1,
                 param_dtype="float32", sparse_update="auto",
                 final_snapshot="full"):
    from sert_tpu import pipeline
    from sert_tpu.data import Associations, EntityRegistry, Vocabulary
    from sert_tpu.data.prepare import encode_queries, prepare
    from sert_tpu.data.synthetic import make_synthetic
    from sert_tpu.eval.metrics import evaluate_run
    from sert_tpu.scoring.run import score_topics

    os.makedirs(workdir, exist_ok=True)
    t0 = time.time()
    col = make_synthetic(num_entities=E, vocab_size=250_000,
                         docs_per_entity=docs_per_entity, doc_len=40,
                         signature_size=8,
                         num_topics=200, seed=13, hard=True, signal=0.6)
    print(f"gen {time.time()-t0:.0f}s ({len(col.docs)} docs)", flush=True)

    reg = EntityRegistry(col.entities)
    ddir = os.path.join(workdir, "data")
    recipe = build_recipe(E, 0, epochs=epochs, lr_schedule=lr_schedule,
                          num_negatives=num_negatives, model=model,
                          snapshot_dtype=snapshot_dtype,
                          snapshot_every=snapshot_every,
                          param_dtype=param_dtype,
                          sparse_update=sparse_update,
                          final_snapshot=final_snapshot)
    if os.path.exists(os.path.join(ddir, "instances.meta.json")):
        print("prepare: reusing existing data dir", flush=True)
    else:
        assoc = Associations()
        for d, es in col.doc_entities.items():
            for e in es:
                assoc.add(d, reg.id(e))
        t0 = time.time()
        meta = prepare(col.docs, assoc, reg, ddir, recipe.data)
        print(f"prepare {time.time()-t0:.0f}s ({meta['num_instances']} "
              f"instances, vocab {meta['vocab_size']})", flush=True)

    t0 = time.time()
    state, recipe = pipeline.train_from_dir(recipe, ddir,
                                            os.path.join(workdir, run_name))
    steps = int(state.step)
    train_s = time.time() - t0
    print(f"train {train_s:.0f}s ({steps} steps, "
          f"{steps/max(train_s,1e-9):.1f} steps/s)", flush=True)
    # Peak device-memory ledger: allocator stats per device; absent fields
    # degrade quietly.
    try:
        import jax
        stats = jax.local_devices()[0].memory_stats() or {}
        ledger = {k: stats[k] for k in ("bytes_in_use", "peak_bytes_in_use",
                                        "bytes_limit") if k in stats}
        if ledger:
            gib = {k: round(v / 2**30, 2) for k, v in ledger.items()}
            print(f"hbm ledger (GiB): {gib}", flush=True)
    except Exception as e:  # pragma: no cover - platform-dependent
        print(f"hbm ledger unavailable: {e}", flush=True)

    # At E=10M the just-trained adam moments (~5 GB bf16) plus the scoring
    # engine's staging exceed 16 GB HBM; scoring never reads them.
    from sert_tpu.train.step import release_opt_state
    state = release_opt_state(state)

    vocab = Vocabulary.load(ddir + "/vocab.json")
    encoded = encode_queries(col.topics, vocab, recipe.data)
    with open(os.path.join(workdir, "topics.json"), "w") as fh:
        json.dump({"topics": col.topics, "qrels": col.qrels}, fh)
    t0 = time.time()
    run = score_topics(state.params, recipe.model, encoded, reg.names,
                       recipe.score)
    print(f"score {time.time()-t0:.1f}s (200 topics x {E} at "
          f"k={recipe.score.top_k})", flush=True)
    res = evaluate_run(run, col.qrels)
    out = {k: round(v, 4) for k, v in res["all"].items() if k in _METRICS}
    print("metrics:", out, flush=True)
    return out


def score_snapshots(workdir, epoch_list, run_name="run"):
    """Epochs-vs-quality frontier from the run's per-epoch params
    snapshots (round-3 VERDICT #1): score each requested epoch's snapshot
    at the recipe's depth (k=1000) and report the full metric row. Reuses
    the pipeline's own load path (pipeline.load_scorer step=...), so each
    point costs one params upload + one scoring pass — no retraining."""
    from sert_tpu import pipeline
    from sert_tpu.data.instances import InstanceDataset
    from sert_tpu.data.prepare import encode_queries
    from sert_tpu.data.vocab import Vocabulary
    from sert_tpu.eval.metrics import evaluate_run
    from sert_tpu.scoring.run import score_topics
    from sert_tpu.train import checkpoint as ckpt

    ddir = os.path.join(workdir, "data")
    rdir = os.path.join(workdir, run_name)
    ds = InstanceDataset(ddir)
    # The run's own recipe.json (written by train_from_dir), not the
    # harness default: the 10M runs train param_dtype=bfloat16 — loading
    # their bf16 snapshots through the default fp32 template would DOUBLE
    # the params upload (5.1 GB vs 2.6) and any
    # non-default dims/knobs would silently mismatch.
    rpath = os.path.join(rdir, "recipe.json")
    if os.path.exists(rpath):
        from sert_tpu.utils.config import load_recipe
        recipe = pipeline.resolve_model_config(load_recipe(rpath), ds.meta)
    else:
        recipe = pipeline.resolve_model_config(build_recipe(0, 0), ds.meta)
    steps = sorted(ckpt.list_checkpoints(
        os.path.join(rdir, "checkpoints")))
    n_epochs = len(steps)
    per_epoch = {e: steps[e - 1] for e in range(1, n_epochs + 1)}
    print(f"snapshots on disk: epochs 1..{n_epochs} -> steps {steps}",
          flush=True)

    vocab = Vocabulary.load(os.path.join(ddir, "vocab.json"))
    with open(os.path.join(workdir, "topics.json")) as fh:
        saved = json.load(fh)
    encoded = encode_queries(saved["topics"], vocab, recipe.data)

    table = {}
    for e in epoch_list:
        if e not in per_epoch:
            print(f"epoch {e}: no snapshot (have 1..{n_epochs}); skipped",
                  flush=True)
            continue
        t0 = time.time()
        params, _, registry = pipeline.load_scorer(rdir, ddir, recipe,
                                                   step=per_epoch[e])
        t_load = time.time() - t0
        t0 = time.time()
        run = score_topics(params, recipe.model, encoded, registry.names,
                           recipe.score)
        t_score = time.time() - t0
        res = evaluate_run(run, saved["qrels"])
        row = {k: round(v, 4) for k, v in res["all"].items()
               if k in _METRICS}
        table[e] = row
        print(f"epoch {e} (step {per_epoch[e]}): {row} "
              f"[load {t_load:.0f}s score {t_score:.1f}s]", flush=True)
        del params
    return table


def audit_prefilter(workdir, n_queries=64, k=100):
    """Measured bf16-prefilter miss rate on the TRAINED 1M matrix vs a
    float64 host oracle, for both prefilter dtypes.

    The trained params are read straight from the checkpoint npz ON THE
    HOST (no 1.9GB state upload through load_scorer) and the float64
    oracle runs in numpy on the same host arrays; only the [E, d] matrix
    (the engine under test's real input) and the tiny [Q, d] query reps go
    to the device. R's provenance (host fp32 math) is irrelevant to the audit:
    oracle and both prefilter engines see the IDENTICAL R, and any
    trained query geometry exercises the boundary-margin question.
    """
    import zipfile

    import jax
    import jax.numpy as jnp

    from sert_tpu.data.instances import InstanceDataset
    from sert_tpu.data.prepare import encode_queries
    from sert_tpu.data.vocab import Vocabulary
    from sert_tpu.ops.exact_topk import exact_topk_prepared, prepare_entities
    from sert_tpu.train import checkpoint as ckpt
    from sert_tpu import pipeline

    ddir, rdir = os.path.join(workdir, "data"), os.path.join(workdir, "run")
    ds = InstanceDataset(ddir)
    recipe = pipeline.resolve_model_config(build_recipe(0, 0), ds.meta)
    vocab = Vocabulary.load(os.path.join(ddir, "vocab.json"))
    path = ckpt.latest_checkpoint(os.path.join(rdir, "checkpoints"))
    t0 = time.time()
    with open(path, "rb") as fh:
        import io
        z = np.load(io.BytesIO(fh.read()))
        p_host = {name: z[f".params['{name}']"]
                  for name in ("word_emb", "entity_emb", "proj_w", "proj_b")}
    print(f"host param load {time.time()-t0:.0f}s", flush=True)

    with open(os.path.join(workdir, "topics.json")) as fh:
        saved = json.load(fh)
    encoded = encode_queries(saved["topics"], vocab, recipe.data)
    live = [ids for ids in encoded.values() if ids][:n_queries]
    T = max(len(c) for c in live)
    t_ids = np.zeros((len(live), T), np.int32)
    n_t = np.zeros((len(live),), np.int32)
    for i, c in enumerate(live):
        t_ids[i, :len(c)] = c
        n_t[i] = len(c)

    # Host twin of models/lse.window_rep + cosine normalization (fp32).
    we = p_host["word_emb"].astype(np.float32)
    emb = we[t_ids]                                        # [Q, T, d]
    mask = (np.arange(T)[None, :] < n_t[:, None])
    pooled = (emb * mask[:, :, None]).sum(1) / np.maximum(n_t, 1)[:, None]
    R_host32 = np.tanh(pooled @ p_host["proj_w"].astype(np.float32)
                       + p_host["proj_b"].astype(np.float32))
    M_host32 = p_host["entity_emb"].astype(np.float32)
    if recipe.score.similarity == "cosine":
        R_host32 /= np.maximum(
            np.linalg.norm(R_host32, axis=-1, keepdims=True), 1e-9)
        M_host32 /= np.maximum(
            np.linalg.norm(M_host32, axis=-1, keepdims=True), 1e-9)
    R_host = R_host32.astype(np.float64)
    M_host = M_host32.astype(np.float64)
    M = jnp.asarray(M_host32)                    # the only big upload
    R = jnp.asarray(R_host32)

    # float64 oracle top-k sets (host; above the HIGHEST-precision fp32
    # reference)
    t0 = time.time()
    scores = R_host @ M_host.T                     # [Q, E]
    oracle_idx = np.argpartition(-scores, k, axis=1)[:, :k]
    print(f"float64 oracle {time.time()-t0:.0f}s", flush=True)

    out = {}
    for dtype in ("bfloat16", "float32"):
        prep = prepare_entities(M, prefilter_dtype=dtype)
        s, i = exact_topk_prepared(R.astype(jnp.float32), prep, k=k)
        got = np.asarray(i)
        missed = 0
        boundary_eps = []
        for q in range(got.shape[0]):
            miss = set(oracle_idx[q]) - set(got[q].tolist())
            # ties at the k-th value are interchangeable, not misses
            kth = np.partition(-scores[q], k - 1)[k - 1]
            real = [m for m in miss if -scores[q][m] < kth - 1e-12]
            missed += len(real)
            for m in real:
                boundary_eps.append(float(scores[q][m] + kth))
        rate = missed / (got.shape[0] * k)
        out[dtype] = {"missed": missed, "rate": rate,
                      "worst_margin": (max(boundary_eps)
                                       if boundary_eps else 0.0)}
        print(f"prefilter {dtype}: {missed} misses / "
              f"{got.shape[0] * k} slots (rate {rate:.2e})", flush=True)
    return out


def dryrun_mesh(E=1_000_000):
    """Prove the SAME pipeline configuration shards: one sharded
    sampled-softmax train step with the stress model config on the
    current (fake-device) mesh. Caller must set JAX_PLATFORMS=cpu and
    XLA_FLAGS=--xla_force_host_platform_device_count=8."""
    import jax
    import jax.numpy as jnp

    from sert_tpu.parallel.mesh import make_mesh
    from sert_tpu.parallel.train import make_sharded_train_step

    import dataclasses

    n = len(jax.devices())
    mesh = make_mesh((2, n // 2) if n >= 4 else (1, n))
    recipe = build_recipe(E, 250_000)
    tcfg = dataclasses.replace(recipe.train, batch_size=64,
                               donate_state=False, steps_per_call=1,
                               mesh_shape=mesh.devices.shape)
    step, init_fn, put_fn = make_sharded_train_step(
        recipe.model, tcfg, mesh,
        noise=jnp.zeros((E,), jnp.float32))
    state = init_fn()
    rng = np.random.default_rng(0)
    batch = put_fn({
        "windows": rng.integers(0, 250_000, size=(64, 8)).astype(np.int32),
        "lengths": np.full(64, 8, np.int32),
        "entities": rng.integers(0, E, size=(64,)).astype(np.int32),
    })
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), loss
    print(f"dryrun mesh {mesh.devices.shape}: sharded sampled-softmax step "
          f"at E={E} OK (loss {loss:.3f})", flush=True)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/tmp/stress_1m")
    ap.add_argument("--entities", type=int, default=1_000_000)
    ap.add_argument("--audit", action="store_true",
                    help="prefilter exactness audit on the existing workdir")
    ap.add_argument("--dryrun-mesh", action="store_true")
    ap.add_argument("--run-name", default="run",
                    help="train output subdir; a fresh name re-trains on "
                         "the prepared data (wall-clock A/B, e.g. the "
                         "async-checkpoint measurement)")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--lr-schedule", default="constant",
                    choices=["constant", "cosine", "linear"])
    ap.add_argument("--docs-per-entity", type=int, default=1,
                    help="hard-generator association multiplicity; the "
                         "round-4 data-ceiling A/B runs the SAME generator "
                         "at reduced E with 1 vs 2 docs/entity")
    ap.add_argument("--num-negatives", type=int, default=1024,
                    help="batch-shared sampled-softmax candidates (one "
                         "MXU matmul scores them all, so 2048 is nearly "
                         "free — the round-4 softmax-fidelity probe)")
    ap.add_argument("--snapshot-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="storage dtype for intermediate params-only epoch "
                         "snapshots (TrainConfig.snapshot_dtype): bfloat16 "
                         "halves the per-epoch device->host fetch that "
                         "round 4 measured as the e2e critical path")
    ap.add_argument("--snapshot-every", type=int, default=1,
                    help="write intermediate epoch snapshots every N "
                         "epochs (TrainConfig.epoch_snapshot_every)")
    ap.add_argument("--param-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="parameter storage dtype (ModelConfig.param_dtype):"
                         " bfloat16 halves params AND optimizer moments — "
                         "the E=10M enabler (fp32+adam is ~15.4 GB vs 16 GB"
                         " HBM)")
    ap.add_argument("--final-snapshot", default="full",
                    choices=["full", "params"],
                    help="final-epoch snapshot flavor "
                         "(TrainConfig.final_snapshot): 'params' ends the "
                         "run with a params-only snapshot at "
                         "--snapshot-dtype — at E=10M the full bf16 adam "
                         "state is a ~7.8 GB device->host fetch vs ~2.6 GB "
                         "params-only; the run then cannot exactly resume")
    ap.add_argument("--sparse-update", default="auto",
                    choices=["auto", "on", "off"],
                    help="row-sparse lazy optimizer (train/sparse.py): 'on'"
                         " forces lazy adam so optimizer HBM traffic scales"
                         " with touched rows, not E — required for "
                         "tolerable step time at E=10M")
    ap.add_argument("--model", default="lse", choices=["lse", "lse_full"],
                    help="lse_full = the exact full-softmax anchor (the "
                         "negatives ladder's limit; same geometry, exact "
                         "objective)")
    ap.add_argument("--score-snapshots", default="",
                    help="comma list of epochs to score from the existing "
                         "run's per-epoch params snapshots (the "
                         "epochs-vs-quality frontier); skips training")
    args = ap.parse_args()
    if not args.dryrun_mesh:
        # Persistent compile cache (utils/cache.py): repeated stress runs
        # stop re-paying the train-step/scorer compiles.
        from sert_tpu.utils.cache import enable_compilation_cache
        enable_compilation_cache()
    if args.dryrun_mesh:
        # Pin the platform through jax.config before first backend use
        # (same as tests/conftest.py / __graft_entry__).
        import jax
        jax.config.update("jax_platforms",
                          os.environ.get("SERT_TEST_PLATFORM", "cpu"))
        dryrun_mesh(args.entities)
    elif args.audit:
        print(json.dumps(audit_prefilter(args.workdir), indent=2))
    elif args.score_snapshots:
        epochs = [int(x) for x in args.score_snapshots.split(",")]
        print(json.dumps(score_snapshots(args.workdir, epochs,
                                         run_name=args.run_name), indent=2))
    else:
        run_pipeline(args.workdir, args.entities, run_name=args.run_name,
                     epochs=args.epochs, lr_schedule=args.lr_schedule,
                     docs_per_entity=args.docs_per_entity,
                     num_negatives=args.num_negatives, model=args.model,
                     snapshot_dtype=args.snapshot_dtype,
                     snapshot_every=args.snapshot_every,
                     param_dtype=args.param_dtype,
                     sparse_update=args.sparse_update,
                     final_snapshot=args.final_snapshot)
