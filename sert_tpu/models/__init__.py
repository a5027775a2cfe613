"""L3 models: log-linear word-to-entity and LSE (latent semantic entities).

Both model families from the reference (SURVEY.md section 1):

  * ``loglinear`` — expert finding (Van Gysel et al., WWW 2016): word
    embeddings, masked-mean window pooling, affine map into candidate space,
    FULL softmax over all entities, cross-entropy loss.
  * ``lse`` — product search (Van Gysel et al., CIKM 2016): word embeddings,
    masked-mean pooling, ``tanh`` affine projection into entity space,
    similarity against a learned entity-embedding matrix, trained with
    negative sampling (sampled contrastive objective).

Models are functional: params are plain pytrees (dicts of arrays), losses are
pure functions — the JAX analogue of the reference's "build a Theano
graph, hand it to the compiler" boundary (SURVEY.md section 2, L3->L0).
"""

from sert_tpu.models import loglinear, lse  # noqa: F401
from sert_tpu.models.api import (  # noqa: F401
    all_entity_scores,
    init_params,
    loss_fn,
    query_scores,
    window_rep,
)
