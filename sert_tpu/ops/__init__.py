"""Pallas GPU kernels for the two hot paths, with their XLA references.

Both are written for the Triton route (``backend="triton"``) and run under
the Pallas interpreter only when a caller asks for it (sert_tpu/engines.py):

  * ``score_binmax`` — fused (R @ M^T + alpha*bias) -> per-bin maxima; the
    [Q, E] score matrix never reaches device memory. ``exact_topk`` builds
    exact top-k on it: top (k+pad) bins, gather only those bins' entities,
    rescore in fp32, final small top-k. Exactness: every bin holding a true
    top-k element has bin-max >= the k-th value, and at most k bins can
    (see ops/exact_topk.py for the tie caveat).
  * ``sampled_lse`` — flash masked log-sum-exp over the shared
    sampled-softmax candidates, with a custom VJP; the [B, k] logits never
    reach device memory.
"""

from sert_tpu.ops.score_binmax import score_binmax  # noqa: F401
from sert_tpu.ops.exact_topk import exact_topk  # noqa: F401
