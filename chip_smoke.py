"""Prove that sert-tpu runs on the GPU: its main path, end to end, in one
process (one JAX client holds the card; only nvidia-smi runs as a child).

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # four cards: the sharded paths only

One card, in order, each phase printing its own lines:
  1. device: JAX version, platform / kind / count, the card's name and
     power limit (nvidia-smi), the compile cache in effect. Anything but a
     GPU exits non-zero: there is no CPU fallback.
  2. kernels at the flagship's widths: each Pallas kernel compiled for the
     card (memory analysis printed), compared once with its plain
     reference at the stated tolerance, and timed against what XLA makes
     of the plain version, alternating, steady-state medians.
  3. the main path at the flagship's widths (recipe synthetic_1m_retrieval:
     E=1M, d=128, B=4096, k=32768 shared negatives, bf16, adam, cosine
     scoring to depth 1000): prepare -> one epoch of train_from_dir ->
     score_topics -> metrics -> EntitySearcher (single requests and one
     concurrent burst); then w3c_expert_finding end to end through the CLI.
  4. the last line: {"ok": true, "device": {...}}.

Any failure raises out of its phase: the script exits non-zero and never
prints the last line. tests/test_chip_smoke.py runs phases 2 and 3 and the
four-card checks on the CPU at tiny sizes, kernels interpreted.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, ".chip_smoke")     # gitignored scratch, removed


@dataclasses.dataclass(frozen=True)
class Sizes:
    entities: int = 1_000_000
    dim: int = 128
    queries: int = 64          # ScoreConfig.query_batch
    batch: int = 4096
    negatives: int = 32768
    vocab: int = 250_000
    topics: int = 200
    depths: tuple = (100, 1000)
    rounds: int = 5            # timing rounds, alternating kernel / XLA
    iters: int = 10            # calls per timed round


FULL = Sizes()                 # the flagship's widths (SYNTH_1M + recipe)

# Tolerances, each with its reason.
# Sweep: kernel and XLA multiply the same bf16 operands with fp32
# accumulation; only accumulation order differs, far inside one bf16 step.
SWEEP_RTOL = 2.0 ** -8
# Exact top-k: the rescore is fp32 at HIGHEST like the oracle; entities
# whose oracle score lies within fp32 accumulation noise of the k-th value
# may swap (exact_topk.py tie caveat).
TIE_ATOL = 1e-5
# Sampled LSE: bf16 operands against an fp32 HIGHEST reference carry a
# relative error of order 2^-8 per logit.
LSE_RTOL = 1e-2
GRAD_RTOL = 2e-2
# Sharded vs one-card: same arithmetic in another partition and order.
SHARD_RTOL = 2e-2


def say(*parts) -> None:
    print(*parts, flush=True)


def check_device(devices, count: int = 1):
    """The first device, if JAX found ``count`` GPUs; else exit non-zero."""
    d = devices[0]
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX found "
                         f"{d.platform!r} ({d.device_kind})")
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found "
                         f"{len(devices)}")
    return d


def device_phase(count: int):
    import jax
    from sert_tpu.utils.cache import enable_compilation_cache
    say("== phase 1: device")
    say(f"jax {jax.__version__}")
    devs = jax.devices()
    d = devs[0]
    say(f"platform={d.platform} kind={d.device_kind} count={len(devs)}")
    check_device(devs, count)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        say(f"nvidia-smi: {line.strip()}")
    say(f"compile cache: {enable_compilation_cache()}")
    return d


def _ready(x):
    import jax
    return jax.block_until_ready(x)


def alternate(fns, rounds: int, iters: int):
    """Steady-state median seconds per call of each zero-argument callable,
    warmed up first, then timed in alternating order (ABBA...) so drift
    hits every variant alike."""
    for f in fns.values():
        _ready(f())
    samples = {name: [] for name in fns}
    names = list(fns)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fns[name]()
            _ready(out)
            samples[name].append((time.perf_counter() - t0) / iters)
    return {name: statistics.median(v) for name, v in samples.items()}


def _ms(t: float) -> str:
    return f"{t * 1e3:.4f} ms"


def _print_memory(name: str, compiled) -> None:
    say(f"{name} memory_analysis: {compiled.memory_analysis()}")


def _normalized(key, shape):
    import jax
    import jax.numpy as jnp
    x = jax.random.normal(key, shape, jnp.float32)
    return x / jnp.linalg.norm(x, axis=-1, keepdims=True)


def check_topk(got_s, got_i, scores, k: int, label: str) -> None:
    """Index sets equal to the dense oracle's, up to fp32 ties at the k-th
    value; returned scores equal the oracle's at the returned indices."""
    import numpy as np
    scores = np.asarray(scores)
    got_s, got_i = np.asarray(got_s), np.asarray(got_i)
    order = np.argsort(-scores, axis=1)[:, :k]
    kth = np.take_along_axis(scores, order[:, -1:], axis=1)[:, 0]
    at = np.take_along_axis(scores, got_i, axis=1)
    err = float(np.max(np.abs(at - got_s)))
    if err > TIE_ATOL:
        raise AssertionError(f"{label}: scores off the oracle by {err}")
    swaps = 0
    for q in range(scores.shape[0]):
        diff = set(order[q].tolist()) ^ set(got_i[q].tolist())
        for e in diff:
            if abs(scores[q, e] - kth[q]) > TIE_ATOL:
                raise AssertionError(
                    f"{label}: query {q} entity {e} differs from the "
                    f"oracle at margin {scores[q, e] - kth[q]}")
        swaps += len(diff) // 2
    say(f"{label}: top-{k} sets equal the HIGHEST oracle "
        f"(score err {err:.2e}, {swaps} tie swaps within {TIE_ATOL})")


def kernel_phase(sz: Sizes) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sert_tpu import engines
    from sert_tpu.ops.exact_topk import exact_topk_prepared, prepare_entities
    from sert_tpu.ops.sampled_lse import sampled_lse, sampled_lse_reference
    from sert_tpu.ops.score_binmax import (binmax_reference,
                                           score_binmax_prepared)
    from sert_tpu.scoring.scorer import HIGHEST, chunked_topk_core

    say("== phase 2: kernels at the flagship widths")
    E, d, Q = sz.entities, sz.dim, sz.queries
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    M = _normalized(k1, (E, d))
    R = _normalized(k2, (Q, d))
    prep = prepare_entities(M)
    interp = engines.interpret_default(None)

    # -- fused bin-max sweep ------------------------------------------------
    compiled = score_binmax_prepared.lower(
        R, prep.Mp, E, te=prep.te, interpret=interp).compile()
    _print_memory("score_binmax", compiled)
    bins = score_binmax_prepared(R, prep.Mp, E, te=prep.te, interpret=interp)
    ref = binmax_reference(R, prep.Mp, E)
    err = float(jnp.max(jnp.abs(bins - ref)))
    tol = SWEEP_RTOL * max(1.0, float(jnp.max(jnp.abs(ref))))
    say(f"score_binmax vs XLA reference: max |diff| {err:.3e} "
        f"(tol {tol:.3e}, bf16 operands both)")
    if not err <= tol:
        raise AssertionError("score_binmax disagrees with its reference")
    scores = jnp.dot(R, M.T, precision=HIGHEST)
    for k in sz.depths:
        s, i = exact_topk_prepared(R, prep, k=k, sweep="triton",
                                   interpret=interp)
        check_topk(s, i, scores, k, f"exact_topk[triton] k={k}")
    del scores

    t = alternate({"sweep_triton": lambda: score_binmax_prepared(
                       R, prep.Mp, E, te=prep.te, interpret=interp),
                   "sweep_xla": lambda: binmax_reference(R, prep.Mp, E)},
                  sz.rounds, sz.iters)
    say(f"timing sweep alone Q={Q} E={E}: triton {_ms(t['sweep_triton'])}"
        f" | xla {_ms(t['sweep_xla'])}")
    mask = jnp.ones((Q, 1), bool)
    streaming = jax.jit(lambda R, M, k: chunked_topk_core(
        R, None, mask, M, None, k, 1 << 15, False)[:2], static_argnums=2)
    dense = jax.jit(lambda R, M, k: jax.lax.top_k(
        jnp.dot(R, M.T, precision=HIGHEST), k), static_argnums=2)
    for k in sz.depths:
        t = alternate({
            "exact_triton": lambda k=k: exact_topk_prepared(
                R, prep, k=k, sweep="triton", interpret=interp),
            "exact_xla": lambda k=k: exact_topk_prepared(
                R, prep, k=k, sweep="xla"),
            "streaming": lambda k=k: streaming(R, M, k),
            "dense": lambda k=k: dense(R, M, k)}, sz.rounds, sz.iters)
        say(f"timing exact_topk_prepared k={k} Q={Q} E={E}: "
            f"triton sweep {_ms(t['exact_triton'])} | xla sweep "
            f"{_ms(t['exact_xla'])} | engine streaming "
            f"{_ms(t['streaming'])} | engine dense {_ms(t['dense'])}")
        say(f"verdict score_binmax k={k}: "
            + ("kernel faster end to end" if t["exact_triton"]
               < t["exact_xla"] else "KERNEL SLOWER end to end"))
    del prep, M

    # -- flash sampled-softmax LSE -------------------------------------------
    B, K = sz.batch, sz.negatives
    ka, kb, kc, kd = jax.random.split(k3, 4)
    reps = jnp.tanh(jax.random.normal(ka, (B, d), jnp.float32))
    cand = jax.random.normal(kb, (K, d), jnp.float32) / np.sqrt(d)
    corr = jax.random.uniform(kc, (K,), jnp.float32) - np.log(E) + np.log(K)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, E, size=K).astype(np.int32)
    pos = rng.integers(0, E, size=B).astype(np.int32)
    ids[:64] = pos[:64]                      # accidental hits present
    ids, pos = jnp.asarray(ids), jnp.asarray(pos)
    w = jax.random.normal(kd, (B,), jnp.float32)

    def loss_kernel(r, c, co):
        return jnp.sum(w * sampled_lse(r, c, co, ids, pos, "bfloat16",
                                       interp))

    def loss_ref(r, c, co):
        return jnp.sum(w * sampled_lse_reference(r, c, co, ids, pos,
                                                 precision=HIGHEST))

    g_kernel = jax.jit(jax.value_and_grad(loss_kernel, argnums=(0, 1, 2)))
    g_ref = jax.jit(jax.value_and_grad(loss_ref, argnums=(0, 1, 2)))
    _print_memory("sampled_lse fwd+bwd",
                  g_kernel.lower(reps, cand, corr).compile())
    lse_k = jax.jit(lambda r, c, co: sampled_lse(
        r, c, co, ids, pos, "bfloat16", interp))(reps, cand, corr)
    lse_r = sampled_lse_reference(reps, cand, corr, ids, pos,
                                  precision=HIGHEST)
    rel = float(jnp.max(jnp.abs(lse_k - lse_r)) / jnp.max(jnp.abs(lse_r)))
    say(f"sampled_lse fwd vs fp32 HIGHEST reference: max rel {rel:.3e} "
        f"(tol {LSE_RTOL}, bf16 operands)")
    if not rel <= LSE_RTOL:
        raise AssertionError("sampled_lse forward disagrees")
    (_, gk), (_, gr) = g_kernel(reps, cand, corr), g_ref(reps, cand, corr)
    for name, a, b in zip(("dreps", "dcand", "dcorr"), gk, gr):
        rel = float(jnp.linalg.norm(a - b) / jnp.linalg.norm(b))
        say(f"sampled_lse {name} vs reference: rel norm {rel:.3e} "
            f"(tol {GRAD_RTOL})")
        if not rel <= GRAD_RTOL:
            raise AssertionError(f"sampled_lse {name} disagrees")

    def loss_xla(r, c, co):   # the same composition in XLA, bf16 operands
        return jnp.sum(w * sampled_lse_reference(r, c, co, ids, pos,
                                                 "bfloat16"))

    g_xla = jax.jit(jax.value_and_grad(loss_xla, argnums=(0, 1, 2)))
    t = alternate({"kernel": lambda: g_kernel(reps, cand, corr),
                   "xla": lambda: g_xla(reps, cand, corr)},
                  sz.rounds, sz.iters)
    say(f"timing sampled-softmax loss fwd+bwd B={B} k={K} d={d}: "
        f"triton {_ms(t['kernel'])} | xla {_ms(t['xla'])} (bf16 operands, "
        "fp32 accumulation, both)")
    del reps, cand, g_kernel, g_ref, g_xla
    _time_train_step(sz)


def _flagship_model(sz: Sizes, fused: str):
    from sert_tpu import recipes
    m = recipes.synthetic_1m_retrieval().model
    return m.replace(vocab_size=sz.vocab, num_entities=sz.entities,
                     word_dim=sz.dim, entity_dim=sz.dim,
                     num_negatives=sz.negatives, fused_softmax=fused)


def _flagship_train(sz: Sizes, **kw):
    from sert_tpu import recipes
    t = recipes.synthetic_1m_retrieval().train
    return dataclasses.replace(t, batch_size=sz.batch, steps_per_call=1,
                               lr_schedule="constant", **kw)


def _random_batch(sz: Sizes, seed: int, window: int = 8):
    import numpy as np
    rng = np.random.default_rng(seed)
    return {"windows": rng.integers(0, sz.vocab, size=(sz.batch, window))
            .astype(np.int32),
            "lengths": np.full(sz.batch, window, np.int32),
            "entities": rng.integers(0, sz.entities, size=sz.batch)
            .astype(np.int32)}


def _time_train_step(sz: Sizes) -> None:
    import jax
    import jax.numpy as jnp

    from sert_tpu.train.step import init_state, make_train_step

    tcfg = _flagship_train(sz)
    batch = {k: jnp.asarray(v) for k, v in _random_batch(sz, 1).items()}
    noise = jnp.zeros((sz.entities,), jnp.float32)
    steps, states = {}, {}
    for fused in ("on", "off"):
        cfg = _flagship_model(sz, fused)
        steps[fused] = make_train_step(cfg, tcfg, noise=noise)
        states[fused] = jax.jit(lambda cfg=cfg: init_state(
            jax.random.key(0), cfg, tcfg))()
    _print_memory("train step (flash loss)", steps["on"].lower(
        states["on"], batch).compile())

    def runner(fused):
        def go():
            states[fused], m = steps[fused](states[fused], batch)
            return m["loss"]
        return go

    t = alternate({f: runner(f) for f in ("on", "off")}, sz.rounds, sz.iters)
    say(f"timing flagship train step (adam, B={sz.batch}, k={sz.negatives},"
        f" E={sz.entities}): flash kernel {_ms(t['on'])} | xla "
        f"{_ms(t['off'])}")
    say("verdict sampled_lse: " + ("kernel faster end to end"
                                   if t["on"] < t["off"]
                                   else "KERNEL SLOWER end to end"))


def flagship_recipe(sz: Sizes):
    """Recipe synthetic_1m_retrieval and its SYNTH_1M collection at the
    widths of ``sz``, one epoch of about one window per document. Returns
    (spec, recipe, cuts), each cut a line naming what changed."""
    from sert_tpu import recipes
    recipe = recipes.synthetic_1m_retrieval()
    base = recipes.SYNTH_1M
    spec = dataclasses.replace(base, doc_len=recipe.data.window_size,
                               num_entities=sz.entities, vocab_size=sz.vocab,
                               num_topics=sz.topics)
    model = recipe.model.replace(num_negatives=sz.negatives,
                                 word_dim=sz.dim, entity_dim=sz.dim)
    train = dataclasses.replace(recipe.train, num_epochs=1,
                                batch_size=sz.batch, log_every_steps=40)
    pairs = [("SYNTH_1M.doc_len (about one window per document)",
              base.doc_len, spec.doc_len),
             ("SYNTH_1M.num_entities", base.num_entities, spec.num_entities),
             ("SYNTH_1M.vocab_size", base.vocab_size, spec.vocab_size),
             ("SYNTH_1M.num_topics", base.num_topics, spec.num_topics),
             ("model.num_negatives", recipe.model.num_negatives,
              model.num_negatives),
             ("model.word_dim", recipe.model.word_dim, model.word_dim),
             ("model.entity_dim", recipe.model.entity_dim, model.entity_dim),
             ("train.batch_size", recipe.train.batch_size, train.batch_size),
             ("train.num_epochs", recipe.train.num_epochs, train.num_epochs)]
    cuts = [f"{name} {was} -> {now}" for name, was, now in pairs
            if was != now]
    return spec, dataclasses.replace(recipe, model=model, train=train), cuts


def report_train(log_path: str, t_enter: float, t_exit: float,
                 steps: int) -> None:
    """Where the train stage's wall went, from train_log.jsonl (every event
    stamped ``ts``): set-up, the first call (compile), the logged steps as
    one window beside the median of its log intervals with the host-feed
    wait inside it, and the tail to train_from_dir's return (the last
    steps, the epoch-end snapshot and its write). The parts add up to the
    wall."""
    events = [json.loads(line) for line in open(log_path)]
    warm = next(e for e in events if e["event"] == "warmup")
    logs = [e for e in events if e["event"] == "train_step"]
    end = next(e for e in events if e["event"] == "epoch_end")
    first_call0 = warm["ts"] - warm["first_step_s"]
    say(f"stage train (1 epoch, {steps} steps): {t_exit - t_enter:.2f} s "
        "wall")
    record = {k: v for k, v in warm.items() if k not in ("event", "ts")}
    say(f"  train_from_dir to the first call: {first_call0 - t_enter:.2f} s"
        f" (loop warm-up record: {record})")
    say(f"  first call (compile + run): {warm['first_step_s']:.2f} s")
    last = warm
    if logs:
        say(f"  first call -> step {logs[0]['step']}: "
            f"{logs[0]['ts'] - warm['ts']:.3f} s")
        last = logs[-1]
    if len(logs) >= 2:
        win = logs[1:]
        n = logs[-1]["step"] - logs[0]["step"]
        dt = logs[-1]["ts"] - logs[0]["ts"]
        feed = sum(e["feed_wait_ms"] * (e["step"] - p["step"])
                   for p, e in zip(logs, win)) / 1e3
        sync = sum(e["device_sync_ms"] for e in win) / 1e3
        med = statistics.median(e["steps_per_sec"] for e in win)
        say(f"  steps {logs[0]['step']} -> {logs[-1]['step']}: {n} steps in "
            f"{dt:.3f} s = {n / dt:.2f} steps/s over the whole window "
            f"(median of {len(win)} log intervals {med:.2f}); host feed "
            f"wait {feed:.3f} s, device sync at log points {sync:.3f} s")
    say(f"  step {last.get('step', 'first call')} -> epoch end (last steps, "
        f"final snapshot issued): {end['ts'] - last['ts']:.3f} s")
    ckpt_dir = os.path.join(os.path.dirname(log_path), "checkpoints")
    size = sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(ckpt_dir) for f in files)
    say(f"  epoch end -> train_from_dir returned (final snapshot written, "
        f"{size} bytes): {t_exit - end['ts']:.3f} s")


def flagship_phase(sz: Sizes, work: str) -> None:
    import jax
    import numpy as np

    from sert_tpu import pipeline
    from sert_tpu.data.assoc import EntityRegistry
    from sert_tpu.data.prepare import (ENTITIES_NAME, VOCAB_NAME,
                                       encode_queries)
    from sert_tpu.data.vocab import Vocabulary
    from sert_tpu.eval.metrics import evaluate_run
    from sert_tpu.scoring.run import resolve_engine, score_topics
    from sert_tpu.serving import EntitySearcher
    from sert_tpu.train.step import release_opt_state

    say("== phase 3: main path, recipe synthetic_1m_retrieval")
    spec, recipe, cuts = flagship_recipe(sz)
    for cut in cuts:
        say(f"cut: {cut}")
    say("setting: train.log_every_steps 200 -> 40 (steady-state steps/s)")
    say(f"widths: E={spec.num_entities} d={recipe.model.entity_dim} "
        f"B={recipe.train.batch_size} k={recipe.model.num_negatives} "
        f"depth={recipe.score.top_k} compute={recipe.model.compute_dtype} "
        f"optimizer={recipe.train.optimizer}")
    data_dir = os.path.join(work, "flagship", "data")
    run_dir = os.path.join(work, "flagship", "run")

    t0 = time.perf_counter()
    col = spec.build()
    t1 = time.perf_counter()
    meta = pipeline.prepare_collection(col, data_dir, recipe)
    t2 = time.perf_counter()
    say(f"stage build collection: {t1 - t0:.2f} s ({len(col.docs)} docs)")
    say(f"stage prepare: {t2 - t1:.2f} s ({meta['num_instances']} "
        f"instances, vocab {meta['vocab_size']})")

    t_enter = time.time()            # the train log's ts clock
    state, resolved = pipeline.train_from_dir(recipe, data_dir, run_dir,
                                              resume=False)
    t_exit = time.time()
    report_train(os.path.join(run_dir, "train_log.jsonl"), t_enter, t_exit,
                 int(state.step))
    stats = jax.devices()[0].memory_stats() or {}
    say(f"train peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")

    state = release_opt_state(state)
    vocab = Vocabulary.load(os.path.join(data_dir, VOCAB_NAME))
    registry = EntityRegistry.load(os.path.join(data_dir, ENTITIES_NAME))
    encoded = encode_queries(col.topics, vocab, recipe.data)
    engine = resolve_engine(resolved.score, len(registry.names))
    t4 = time.perf_counter()
    run = score_topics(state.params, resolved.model, encoded, registry.names,
                       resolved.score)
    t5 = time.perf_counter()
    run = score_topics(state.params, resolved.model, encoded, registry.names,
                       resolved.score)
    t6 = time.perf_counter()
    say(f"stage score ({len(encoded)} topics, engine {engine}, depth "
        f"{resolved.score.top_k}): first call {t5 - t4:.2f} s (staging + "
        f"compile), repeat {t6 - t5:.4f} s")
    res = evaluate_run(run, col.qrels, measures=("ndcg@100", "recall@1000"))
    say(f"metrics (sanity, one epoch): NDCG@100 {res['all']['ndcg@100']:.4f}"
        f" recall@1000 {res['all']['recall@1000']:.4f}")
    if not all(np.isfinite(s) for hits in run.values() for _, s in hits):
        raise AssertionError("non-finite scores in the run")
    del state

    t7 = time.perf_counter()
    searcher = EntitySearcher(recipe, data_dir, run_dir, k=10)
    t8 = time.perf_counter()
    say(f"stage serve load + stage + warm-up: {t8 - t7:.2f} s")
    texts = [col.topics[q] for q in sorted(col.topics)[:16]]
    for text in texts[:3]:
        ta = time.perf_counter()
        hits = searcher.search(text)
        say(f"serve single request: {len(hits)} hits in "
            f"{time.perf_counter() - ta:.4f} s, top {hits[0][0]}")
        want = [n for n, _ in sorted(run[_qid_of(col.topics, text)],
                                     key=lambda h: -h[1])[:10]]
        if [n for n, _ in hits] != want:
            raise AssertionError("searcher disagrees with score_topics")
    before = searcher.stats["dispatches"]
    out = [None] * len(texts)
    gate = threading.Barrier(len(texts))

    def client(i):
        gate.wait()
        out[i] = searcher.search(texts[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(texts))]
    ta = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    dt = time.perf_counter() - ta
    n_disp = searcher.stats["dispatches"] - before
    say(f"serve burst: {len(texts)} concurrent requests answered in "
        f"{dt:.4f} s by {n_disp} engine dispatches "
        f"(max batch {searcher.stats['max_batch']})")
    if any(not o for o in out) or n_disp >= len(texts):
        raise AssertionError("burst not answered through the micro-batcher")
    del searcher


def w3c_phase(work: str) -> None:
    from sert_tpu import cli

    say("== phase 3b: w3c_expert_finding end to end (CLI e2e)")
    buf = io.StringIO()
    ta = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["e2e", "--recipe", "w3c_expert_finding", "--workdir",
                       os.path.join(work, "w3c")])
    metrics = json.loads(buf.getvalue())
    say(f"w3c e2e rc={rc} in {time.perf_counter() - ta:.2f} s: NDCG@100 "
        f"{metrics['ndcg@100']:.4f} recall@100 {metrics['recall@100']:.4f}")
    if rc != 0 or not metrics["ndcg@100"] > 0.5:
        raise AssertionError("w3c_expert_finding e2e failed")


def _qid_of(topics, text):
    return next(q for q, t in topics.items() if t == text)


def four_phase(sz: Sizes) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sert_tpu import engines
    from sert_tpu.models import api, lse
    from sert_tpu.parallel.fused_loss import make_sharded_sampled_loss
    from sert_tpu.parallel.mesh import make_mesh
    from sert_tpu.parallel.topk import distributed_topk
    from sert_tpu.parallel.train import make_sharded_train_step
    from sert_tpu.scoring.scorer import dense_scores, exact_engine_topk
    from sert_tpu.train.step import init_state, make_train_step

    say("== four cards: sharded paths against one card")
    cfg = _flagship_model(sz, "auto")
    noise = jnp.zeros((sz.entities,), jnp.float32)
    batches = [_random_batch(sz, s) for s in range(3)]

    def losses(step, state, put):
        out = []
        for b in batches:
            state, m = step(state, put(b))
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out

    tcfg1 = _flagship_train(sz, donate_state=False)
    one = losses(make_train_step(cfg, tcfg1, noise=noise),
                 init_state(jax.random.key(tcfg1.seed), cfg, tcfg1),
                 lambda b: {k: jnp.asarray(v) for k, v in b.items()})
    say(f"one card train (loss, grad_norm) x3: {one}")
    for shape in ((1, 4), (4, 1)):
        tcfg = dataclasses.replace(tcfg1, mesh_shape=shape)
        step, init_fn, put = make_sharded_train_step(cfg, tcfg,
                                                     make_mesh(shape), noise)
        got = losses(step, init_fn(), put)
        err = max(abs(a - b) / abs(b) for g, o in zip(got, one)
                  for a, b in zip(g, o))
        say(f"mesh {shape} train (loss, grad_norm) x3: {got}; max rel "
            f"diff {err:.3e} (tol {SHARD_RTOL})")
        if not err <= SHARD_RTOL:
            raise AssertionError(f"sharded train step {shape} disagrees")

    params = api.init_params(jax.random.key(3), cfg)
    rng = np.random.default_rng(5)
    Q = sz.queries
    term_ids = jnp.asarray(rng.integers(0, sz.vocab, size=(Q, 4))
                           .astype(np.int32))
    num_terms = jnp.full((Q,), 4, jnp.int32)
    scores = dense_scores(params, cfg, term_ids, num_terms)
    mesh = make_mesh((1, 4))
    say(f"distributed local engine: {engines.local_engine()}")
    for k in sz.depths:
        s1, i1 = exact_engine_topk(params, cfg, term_ids, num_terms, k=k)
        check_topk(s1, i1, scores, k, f"one card exact k={k}")
        for merge in ("allgather", "ring"):
            s, i = distributed_topk(params, cfg, term_ids, num_terms, mesh,
                                    k=k, merge=merge)
            check_topk(s, i, scores, k, f"distributed {merge} k={k}")
            err = float(jnp.max(jnp.abs(s - s1)))
            say(f"distributed {merge} k={k} vs one card: max score diff "
                f"{err:.2e}")
    del scores

    cfg_on = cfg.replace(fused_softmax="on")
    batch = {k: jnp.asarray(v) for k, v in batches[0].items()}
    rkey = jax.random.key(9)
    ref = jax.jit(jax.value_and_grad(
        lambda p: lse.loss_sampled_softmax(p, batch, cfg_on, rng=rkey)))
    lr, gr = ref(params)
    for shape in ((1, 4), (4, 1), (2, 2)):
        sh = make_sharded_sampled_loss(cfg_on, make_mesh(shape))
        ls, gs = jax.jit(jax.value_and_grad(sh), static_argnums=2)(
            params, batch, cfg_on, rkey)
        rel_l = abs(float(ls) - float(lr)) / abs(float(lr))
        rel_g = max(float(jnp.linalg.norm(gs[n] - gr[n])
                          / jnp.maximum(jnp.linalg.norm(gr[n]), 1e-30))
                    for n in gr)
        say(f"sharded sampled-LSE loss mesh {shape}: loss {float(ls)} vs "
            f"{float(lr)} (rel {rel_l:.2e}), grads max rel norm "
            f"{rel_g:.2e} (tol {SHARD_RTOL})")
        if not (rel_l <= SHARD_RTOL and rel_g <= SHARD_RTOL):
            raise AssertionError(f"sharded sampled loss {shape}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="four cards: the sharded paths only")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    dev = device_phase(4 if args.four else 1)
    shutil.rmtree(WORK, ignore_errors=True)
    try:
        if args.four:
            four_phase(FULL)
        else:
            kernel_phase(FULL)
            flagship_phase(FULL, WORK)
            w3c_phase(WORK)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    import jax
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
