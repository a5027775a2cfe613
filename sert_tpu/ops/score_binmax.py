"""Fused scoring + bin-max sweep: a Pallas kernel on the Triton route.

Computes ``S = R @ M^T (+ alpha_q * bias_e)`` tile by tile and emits only
per-bin maxima over groups of ``bin_width`` consecutive entities:
``out[q, b] = max_{l < bw} S[q, b * bw + l]``. The [Q, E] score matrix never
reaches device memory: at Q=64, E=1M it would be 256 MB of fp32 written
and read back, against the 256 MB bf16 entity matrix the sweep has to read
once anyway.

Tiling: one program per (query block, entity span). The program keeps its
``[BQ, d]`` query tile and walks its span in ``BE``-row entity tiles inside
a loop (so Triton can pipeline the tile loads): one bf16 ``pl.dot`` with
fp32 accumulation, the bias term, a mask for padded entity rows, and a max
over each bin. Bins never straddle tiles, so no block carries state to
another and every block is independent.

:func:`binmax_reference` is the same arithmetic in plain ``jnp`` that XLA
compiles: the CPU path, the test oracle, and the baseline the kernel is
timed against.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from sert_tpu import engines

LANES = 128          # default bin width: entities per prefilter bin
SPAN = 2048          # entity rows per program (the padding multiple)
BLOCK_E = 128        # entity rows per inner dot tile
MAX_BLOCK_Q = 64     # query rows per program


def _pad_to(x: jax.Array, axis: int, mult: int, value=0):
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths, constant_values=value)


def padded_dim(d: int) -> int:
    """Feature width the kernel sees: a power of two of at least 16 (what
    Triton's dot takes); zero columns change no score."""
    return max(16, pl.next_power_of_2(d))


def prepare_binmax_matrix(M: jax.Array, te: int = SPAN,
                          dtype=jnp.bfloat16) -> jax.Array:
    """One-time cast + pad of the entity matrix for the sweep: rows to a
    multiple of ``te``, columns to :func:`padded_dim`. Keep the result
    resident across calls; re-preparing the matrix per sweep costs more
    than the sweep itself.

    ``dtype=jnp.float32`` gives a full-precision prefilter (2x the bytes)
    for score distributions whose top-k margins sit below bf16 resolution;
    see the precision caveat in ops/exact_topk.py."""
    Mp = _pad_to(M.astype(dtype), 0, te)
    return _pad_to(Mp, 1, padded_dim(M.shape[1]))


def _sweep_kernel(*refs, num_entities, span, block_e, bw, has_bias):
    if has_bias:
        r_ref, m_ref, b_ref, a_ref, o_ref = refs
    else:
        r_ref, m_ref, o_ref = refs
    bq = r_ref.shape[0]
    nb = block_e // bw
    r = r_ref[...]
    if has_bias:
        alpha = a_ref[...]                                   # [bq]
    base = pl.program_id(1) * span

    def body(t, carry):
        rows = pl.ds(t * block_e, block_e)
        s = pl.dot(r, m_ref[rows, :], trans_b=True)          # [bq, block_e]
        if has_bias:
            s = s + alpha[:, None] * b_ref[rows][None, :]
        col = base + t * block_e + jnp.arange(block_e)
        s = jnp.where(col[None, :] < num_entities, s, -jnp.inf)
        o_ref[:, pl.ds(t * nb, nb)] = jnp.max(s.reshape(bq, nb, bw), axis=-1)
        return carry

    jax.lax.fori_loop(0, span // block_e, body, 0)


def _block_q(q: int) -> int:
    return min(MAX_BLOCK_Q, max(16, pl.next_power_of_2(q)))


@functools.partial(jax.jit, static_argnames=("num_entities", "te",
                                             "bin_width", "interpret"))
def score_binmax_prepared(R: jax.Array, Mp: jax.Array, num_entities: int,
                          bias: Optional[jax.Array] = None,
                          alpha: Optional[jax.Array] = None,
                          te: int = SPAN, bin_width: int = LANES,
                          interpret: bool = False) -> jax.Array:
    """[Q, ceil(E / bin_width)] bin maxima of R @ M^T (+ alpha * bias).

    ``Mp`` must come from :func:`prepare_binmax_matrix` with the same
    ``te``. bias [E] and alpha [Q] are optional (log-linear's per-entity
    bias scaled by the per-query term count). Padded entity rows are
    masked to -inf inside the kernel, so the tail bin is exact.

    The kernel compiles for the GPU only; elsewhere pass ``interpret=True``
    (tests) or use :func:`binmax_reference`."""
    engines.require_kernel_backend(interpret, "score_binmax")
    Q = R.shape[0]
    Ep, dp = Mp.shape
    if Ep % te:
        raise ValueError(
            f"Mp has {Ep} rows, not a multiple of te={te}: the sweep span "
            "must match the prepare_binmax_matrix te")
    if te % BLOCK_E or BLOCK_E % bin_width:
        raise ValueError(f"te={te} / bin_width={bin_width} must tile "
                         f"the {BLOCK_E}-row dot block")
    bq = _block_q(Q)
    Rp = _pad_to(_pad_to(R.astype(Mp.dtype), 0, bq), 1, dp)
    Qp = Rp.shape[0]
    grid = (Qp // bq, Ep // te)
    has_bias = bias is not None
    operands = [Rp, Mp]
    in_specs = [pl.BlockSpec((bq, dp), lambda i, j: (i, 0)),
                pl.BlockSpec((te, dp), lambda i, j: (j, 0))]
    if has_bias:
        if alpha is None:
            alpha = jnp.ones((Q,), jnp.float32)
        operands += [_pad_to(bias.astype(jnp.float32), 0, te)[:Ep],
                     _pad_to(alpha.astype(jnp.float32), 0, bq)]
        in_specs += [pl.BlockSpec((te,), lambda i, j: (j,)),
                     pl.BlockSpec((bq,), lambda i, j: (i,))]
    bins = pl.pallas_call(
        functools.partial(_sweep_kernel, num_entities=num_entities,
                          span=te, block_e=BLOCK_E, bw=bin_width,
                          has_bias=has_bias),
        grid=grid,
        in_specs=in_specs,
        out_specs=pl.BlockSpec((bq, te // bin_width), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((Qp, Ep // bin_width), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=3),
        interpret=interpret,
        name="score_binmax",
    )(*operands)
    return bins[:Q, :-(-num_entities // bin_width)]


@functools.partial(jax.jit, static_argnames=("num_entities", "bin_width"))
def binmax_reference(R: jax.Array, Mp: jax.Array, num_entities: int,
                     bias: Optional[jax.Array] = None,
                     alpha: Optional[jax.Array] = None,
                     bin_width: int = LANES) -> jax.Array:
    """The sweep in plain jnp, left to XLA: the [Q, E] scores materialize
    once, then reduce per bin. Same operand dtype and fp32 accumulation as
    the kernel, so the two agree to accumulation order."""
    Q = R.shape[0]
    Ep, dp = Mp.shape
    Rp = _pad_to(R.astype(Mp.dtype), 1, dp)
    s = jnp.dot(Rp, Mp.T, preferred_element_type=jnp.float32)    # [Q, Ep]
    if bias is not None:
        if alpha is None:
            alpha = jnp.ones((Q,), jnp.float32)
        b = _pad_to(bias.astype(jnp.float32), 0, Ep)[:Ep]
        s = s + alpha.astype(jnp.float32)[:, None] * b[None, :]
    s = jnp.where(jnp.arange(Ep)[None, :] < num_entities, s, -jnp.inf)
    n_bins = -(-num_entities // bin_width)
    s = s[:, :n_bins * bin_width]
    return jnp.max(s.reshape(Q, n_bins, bin_width), axis=-1)


def score_binmax(R: jax.Array, M: jax.Array,
                 bias: Optional[jax.Array] = None,
                 alpha: Optional[jax.Array] = None,
                 te: int = SPAN, interpret: bool = False) -> jax.Array:
    """Convenience wrapper: prepare M and sweep in one call (tests and
    one-shot use). Hot paths prepare once via prepare_binmax_matrix."""
    Mp = prepare_binmax_matrix(M, te=te)
    return score_binmax_prepared(R, Mp, M.shape[0], bias, alpha, te=te,
                                 interpret=interpret)
