"""Integrated 200k-entity LSE stress run (production-scale smoke).

Generates a 200k-entity planted-signal collection, prepares ~10M instances,
trains 8 epochs of sampled-softmax LSE (bf16 compute, steps_per_call=16),
scores 200 topics with the exact engine, and reports metrics — the whole
pipeline at a scale two orders above the e2e tests. Run time dominated by
single-core host prep on this machine.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tempfile
import time
from sert_tpu.data.synthetic import make_synthetic
from sert_tpu import pipeline
from sert_tpu.data import Associations, EntityRegistry, Vocabulary
from sert_tpu.data.prepare import prepare, encode_queries
from sert_tpu.scoring.run import score_topics
from sert_tpu.eval.metrics import evaluate_run
from sert_tpu.utils.config import DataConfig, ModelConfig, RecipeConfig, ScoreConfig, TrainConfig


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--optimizer", default="adam",
                    help="adam | adagrad | sgd | adafactor")
    ap.add_argument("--lr", type=float, default=3e-3)
    args = ap.parse_args()

    t0 = time.time()
    E = 200_000
    col = make_synthetic(num_entities=E, vocab_size=100_000, docs_per_entity=1,
                         doc_len=60, signature_size=8, num_topics=200, seed=11)
    print(f"gen {time.time()-t0:.0f}s ({len(col.docs)} docs)", flush=True)

    reg = EntityRegistry(col.entities); assoc = Associations()
    for d, es in col.doc_entities.items():
        for e in es: assoc.add(d, reg.id(e))
    dcfg = DataConfig(window_size=8, vocab_min_count=1, vocab_max_size=120_000)
    ddir = tempfile.mkdtemp()
    t0 = time.time()
    meta = prepare(col.docs, assoc, reg, ddir, dcfg)
    print(f"prepare {time.time()-t0:.0f}s ({meta['num_instances']} instances, vocab {meta['vocab_size']})", flush=True)

    recipe = RecipeConfig(
        name="stress200k",
        data=dcfg,
        model=ModelConfig(model="lse", vocab_size=meta["vocab_size"], num_entities=E,
                          word_dim=128, entity_dim=128, num_negatives=10,
                          negative_distribution="unigram", compute_dtype="bfloat16"),
        train=TrainConfig(batch_size=4096, num_epochs=8,
                          optimizer=args.optimizer, learning_rate=args.lr,
                          steps_per_call=16, log_every_steps=0),
        score=ScoreConfig(top_k=100, similarity="cosine", engine="exact"))
    t0 = time.time()
    state, recipe = pipeline.train_from_dir(recipe, ddir, tempfile.mkdtemp())
    print(f"train {time.time()-t0:.0f}s ({int(state.step)} steps)", flush=True)

    vocab = Vocabulary.load(ddir + "/vocab.json")
    encoded = encode_queries(col.topics, vocab, dcfg)
    t0 = time.time()
    run = score_topics(state.params, recipe.model, encoded, reg.names, recipe.score)
    print(f"score {time.time()-t0:.1f}s (200 topics x {E} entities)", flush=True)
    res = evaluate_run(run, col.qrels)
    print("metrics:", {k: round(v,4) for k,v in res["all"].items() if k in ("ndcg@100","recip_rank","recall@100")}, flush=True)



if __name__ == "__main__":
    main()