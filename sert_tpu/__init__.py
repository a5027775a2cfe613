"""sert-tpu: a semantic entity retrieval framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of cvangysel/SERT
(Semantic Entity Retrieval Toolkit): learning latent entity representations
directly from associated text (the log-linear word-to-entity expert-finding
model of Van Gysel et al., WWW 2016, and the LSE product-search model of
Van Gysel et al., CIKM 2016), then ranking entire entity collections for
free-text queries.

Design notes (vs. the reference):
  * The reference is single-host Theano; the compute path here is jit/pjit
    over a ``jax.sharding.Mesh`` with the entity-embedding matrix sharded
    over the ``model`` mesh axis and batches over the ``data`` axis.
  * The reference's Theano-compiled kernels become XLA programs plus Pallas
    kernels on the Triton route for two GPU hot paths (the fused bin-max
    scoring sweep, the flash sampled-softmax loss).
  * The reference mount (/root/reference) was empty at build time (see
    SURVEY.md section 0), so parity citations refer to the companion papers
    and SURVEY.md's layer map rather than file:line of upstream code.

Layer map (mirrors SURVEY.md section 2):
  data/      L2: corpus parsing, vocabulary, windowing, instance shards, feeders
  models/    L3: log-linear + LSE models (functional pytrees) and numpy twins
  train/     L4: jit'd train step, epoch loop, checkpoint/resume
  scoring/   L5: dense entity-matrix scoring engine with streaming top-k
  eval/      L6: TREC topic/qrel/run I/O and native trec_eval-style metrics
  parallel/  mesh construction, shardings, distributed top-k (new capability)
  ops/       Pallas GPU kernels (Triton route) and their XLA references
  engines.py every platform / size choice of engine and kernel
  native/    C++ host-side feeder acceleration (tokenize/window sweep)
"""

__version__ = "0.2.0"
