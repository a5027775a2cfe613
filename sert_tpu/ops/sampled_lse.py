"""Flash masked log-sum-exp over shared sampled-softmax candidates.

The sampled-softmax LSE objective (models/lse.loss_sampled_softmax;
SURVEY.md section 3.1, the sampled objective row) scores every in-batch
positive against ONE shared candidate set:

    loss_i = softplus( lse_j(r_i . c_j - corr_j  |  cand_j != pos_i)
                       - s_pos_i )

Composed in XLA this materializes the [B, k] candidate logits in fp32
several times per step (forward, the accidental-hit select, the softmax
gradient): at B=4096, k=32768 each copy is 512 MB. These kernels are the
flash-attention treatment of that loss, written for Pallas on the Triton
route: the [B, k] logits never exist in device memory.

  forward:  grid (B / BB, S). Each program keeps a [BB, d] tile of
            query representations and walks its share (1/S) of the
            candidates in BK-row tiles: one dot with fp32 accumulation,
            the accidental-hit and padding mask applied in the tile, an
            online (max, sumexp) update. The S partials per row merge in
            XLA ([S, B] floats). S splits the candidate axis so that B=4096
            still yields enough programs to fill the card.
  backward: two kernels, each recomputing its logits tile and forming
            p = g_i * exp(z_ij - lse_i) (g is the per-row cotangent):
            ``dreps`` over batch blocks (again split S ways over the
            candidates, partials summed in XLA) and ``dcand``/``dcorr``
            over candidate blocks, each looping over the whole batch.
            No atomics: every output element has one writer, so results
            are deterministic.

Masked logits are -1e30 (finite), never -inf: a fully masked tile must not
turn the online update into inf - inf. A row whose every candidate is
masked returns ~-1e30, so softplus(out - s_pos) gives loss and gradient 0.
:func:`sampled_lse_reference` is the plain XLA composition these kernels
are tested and timed against.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from sert_tpu import engines
from sert_tpu.ops.score_binmax import _pad_to, padded_dim

NEG = -1e30
BLOCK_B = 64          # batch rows per forward / dreps program
BLOCK_K = 128         # candidate rows per forward loop tile
BLOCK_K_BWD = 64      # candidate rows per dreps loop tile / dcand program
BLOCK_B_BWD = 64      # batch rows per dcand loop tile
TARGET_PROGRAMS = 512  # forward / dreps programs to aim for (132 SMs)


def _ct(dtype: str):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _params(num_warps: int = 4, num_stages: int = 3):
    return plgpu.CompilerParams(num_warps=num_warps, num_stages=num_stages)


def _logits(r, c, corr, ids, pos, col0, k_total):
    """[rows, cols] corrected logits of one tile, fp32, with padding
    columns and accidental hits (candidate id == the row's positive id)
    forced to NEG."""
    z = pl.dot(r, c, trans_b=True) - corr[None, :]
    cols = col0 + jnp.arange(c.shape[0])
    keep = (cols[None, :] < k_total) & (ids[None, :] != pos[:, None])
    return jnp.where(keep, z, NEG)


def _fwd_kernel(r_ref, c_ref, corr_ref, ids_ref, pos_ref, m_ref, l_ref, *,
                k_total, block_k):
    r, pos = r_ref[...], pos_ref[...]
    span = c_ref.shape[0]
    base = pl.program_id(1) * span

    def body(t, carry):
        m, l = carry
        rows = pl.ds(t * block_k, block_k)
        z = _logits(r, c_ref[rows, :], corr_ref[rows], ids_ref[rows], pos,
                    base + t * block_k, k_total)
        m_new = jnp.maximum(m, jnp.max(z, axis=1))
        l = l * jnp.exp(m - m_new) + jnp.sum(jnp.exp(z - m_new[:, None]),
                                             axis=1)
        return m_new, l

    init = (jnp.full((r.shape[0],), NEG, jnp.float32),
            jnp.zeros((r.shape[0],), jnp.float32))
    m, l = jax.lax.fori_loop(0, span // block_k, body, init)
    m_ref[...] = m
    l_ref[...] = l


def _dreps_kernel(r_ref, c_ref, corr_ref, ids_ref, pos_ref, lse_ref, g_ref,
                  dr_ref, *, k_total, block_k):
    r, pos = r_ref[...], pos_ref[...]
    lse, g = lse_ref[...], g_ref[...]
    span = c_ref.shape[0]
    base = pl.program_id(1) * span

    def body(t, acc):
        rows = pl.ds(t * block_k, block_k)
        c = c_ref[rows, :]
        z = _logits(r, c, corr_ref[rows], ids_ref[rows], pos,
                    base + t * block_k, k_total)
        p = g[:, None] * jnp.exp(z - lse[:, None])
        return acc + pl.dot(p.astype(c.dtype), c)

    acc = jnp.zeros(dr_ref.shape, jnp.float32)
    dr_ref[...] = jax.lax.fori_loop(0, span // block_k, body, acc)


def _dcand_kernel(r_ref, c_ref, corr_ref, ids_ref, pos_ref, lse_ref, g_ref,
                  dc_ref, dcorr_ref, *, k_total, block_b):
    c, corr, ids = c_ref[...], corr_ref[...], ids_ref[...]
    col0 = pl.program_id(0) * c.shape[0]

    def body(t, carry):
        dc, dcorr = carry
        rows = pl.ds(t * block_b, block_b)
        r = r_ref[rows, :]
        z = _logits(r, c, corr, ids, pos_ref[rows], col0, k_total)
        p = g_ref[rows][:, None] * jnp.exp(z - lse_ref[rows][:, None])
        return (dc + pl.dot(p.astype(r.dtype), r, trans_a=True),
                dcorr - jnp.sum(p, axis=0))

    init = (jnp.zeros(dc_ref.shape, jnp.float32),
            jnp.zeros(dcorr_ref.shape, jnp.float32))
    dc, dcorr = jax.lax.fori_loop(0, r_ref.shape[0] // block_b, body, init)
    dc_ref[...] = dc
    dcorr_ref[...] = dcorr


def _layout(B: int, K: int):
    """(Bp, splits, span, Kp): padded batch, candidate splits, candidates
    per split, padded candidate count."""
    Bp = B + (-B) % BLOCK_B
    n_tiles = -(-K // BLOCK_K)
    want = -(-TARGET_PROGRAMS // (Bp // BLOCK_B))
    splits = min(pl.next_power_of_2(want), n_tiles)
    span = -(-n_tiles // splits) * BLOCK_K
    return Bp, splits, span, splits * span


def _prep(reps, cand, corr, cand_ids, pos_ids, dtype):
    """Cast to the compute dtype and pad: batch rows to BLOCK_B, the
    candidate axis to the split layout (padding is masked in-kernel by
    column index), the shared width to a power of two."""
    ct = _ct(dtype)
    B, K = reps.shape[0], cand.shape[0]
    Bp, splits, span, Kp = _layout(B, K)
    dp = padded_dim(reps.shape[1])
    reps_p = _pad_to(_pad_to(reps.astype(ct), 1, dp), 0, Bp)
    cand_p = _pad_to(_pad_to(cand.astype(ct), 1, dp), 0, Kp)
    corr_p = _pad_to(corr.astype(jnp.float32), 0, Kp)
    ids_p = _pad_to(cand_ids.astype(jnp.int32), 0, Kp, value=-1)
    pos_p = _pad_to(pos_ids.astype(jnp.int32), 0, Bp, value=-1)
    return reps_p, cand_p, corr_p, ids_p, pos_p, splits, span


@functools.partial(jax.custom_vjp, nondiff_argnums=(5, 6))
def sampled_lse(reps: jax.Array, cand: jax.Array, corr: jax.Array,
                cand_ids: jax.Array, pos_ids: jax.Array,
                dtype: str = "float32",
                interpret: Optional[bool] = None) -> jax.Array:
    """[B] masked log-sum-exp over the shared candidate set:

        out_i = logsumexp_j { reps_i . cand_j - corr_j : cand_ids_j != pos_ids_i }

    reps [B, d]; cand [k, d]; corr fp32 [k]; cand_ids/pos_ids int32.
    ``dtype="bfloat16"`` runs both matmuls on bf16 operands with fp32
    accumulation; "float32" keeps fp32 operands. GPU only, unless
    ``interpret`` (or engines.interpret_kernels) asks for the
    interpreter."""
    out, _ = _slse_fwd(reps, cand, corr, cand_ids, pos_ids, dtype,
                       interpret)
    return out


def _slse_fwd(reps, cand, corr, cand_ids, pos_ids, dtype, interpret):
    interpret = engines.interpret_default(interpret)
    engines.require_kernel_backend(interpret, "sampled_lse")
    B = reps.shape[0]
    reps_p, cand_p, corr_p, ids_p, pos_p, splits, span = _prep(
        reps, cand, corr, cand_ids, pos_ids, dtype)
    Bp, dp = reps_p.shape
    cand_spec = pl.BlockSpec((span, dp), lambda i, s: (s, 0))
    col_spec = pl.BlockSpec((span,), lambda i, s: (s,))
    row_spec = pl.BlockSpec((BLOCK_B,), lambda i, s: (i,))
    part_spec = pl.BlockSpec((None, BLOCK_B), lambda i, s: (s, i))
    m, l = pl.pallas_call(
        functools.partial(_fwd_kernel, k_total=cand.shape[0],
                          block_k=BLOCK_K),
        grid=(Bp // BLOCK_B, splits),
        in_specs=[pl.BlockSpec((BLOCK_B, dp), lambda i, s: (i, 0)),
                  cand_spec, col_spec, col_spec, row_spec],
        out_specs=[part_spec, part_spec],
        out_shape=[jax.ShapeDtypeStruct((splits, Bp), jnp.float32)] * 2,
        backend="triton",
        compiler_params=_params(),
        interpret=interpret,
        name="sampled_lse_fwd",
    )(reps_p, cand_p, corr_p, ids_p, pos_p)
    mx = jnp.max(m, axis=0)
    lse = mx + jnp.log(jnp.sum(l * jnp.exp(m - mx[None, :]), axis=0))
    # A zero-size array carries cand's dtype (residuals hold JAX types).
    residuals = (reps_p, cand_p, corr_p, ids_p, pos_p, lse, reps.shape,
                 cand.shape, jnp.zeros((0,), cand.dtype), splits, span)
    return lse[:B], residuals


def _slse_bwd(dtype, interpret, residuals, g):
    interpret = engines.interpret_default(interpret)
    (reps_p, cand_p, corr_p, ids_p, pos_p, lse, reps_shape, cand_shape,
     cand_like, splits, span) = residuals
    (B, d), K = reps_shape, cand_shape[0]
    Bp, dp = reps_p.shape
    Kp = cand_p.shape[0]
    # Padded batch rows contribute nothing: zero cotangent and a poisoned
    # lse make p exactly 0 there (0 * exp(z - 1e30)).
    valid = jnp.arange(Bp) < B
    lse_m = jnp.where(valid, lse, 1e30)
    g_p = _pad_to(g.astype(jnp.float32), 0, Bp)
    operands = (reps_p, cand_p, corr_p, ids_p, pos_p, lse_m, g_p)

    row_spec = pl.BlockSpec((BLOCK_B,), lambda i, s: (i,))
    col_spec = pl.BlockSpec((span,), lambda i, s: (s,))
    drp = pl.pallas_call(
        functools.partial(_dreps_kernel, k_total=K, block_k=BLOCK_K_BWD),
        grid=(Bp // BLOCK_B, splits),
        in_specs=[pl.BlockSpec((BLOCK_B, dp), lambda i, s: (i, 0)),
                  pl.BlockSpec((span, dp), lambda i, s: (s, 0)),
                  col_spec, col_spec, row_spec, row_spec, row_spec],
        out_specs=pl.BlockSpec((None, BLOCK_B, dp), lambda i, s: (s, i, 0)),
        out_shape=jax.ShapeDtypeStruct((splits, Bp, dp), jnp.float32),
        backend="triton",
        compiler_params=_params(),
        interpret=interpret,
        name="sampled_lse_dreps",
    )(*operands)

    full_rows = pl.BlockSpec((Bp,), lambda j: (0,))
    cols = pl.BlockSpec((BLOCK_K_BWD,), lambda j: (j,))
    dc, dcorr = pl.pallas_call(
        functools.partial(_dcand_kernel, k_total=K, block_b=BLOCK_B_BWD),
        grid=(Kp // BLOCK_K_BWD,),
        in_specs=[pl.BlockSpec((Bp, dp), lambda j: (0, 0)),
                  pl.BlockSpec((BLOCK_K_BWD, dp), lambda j: (j, 0)),
                  cols, cols, full_rows, full_rows, full_rows],
        out_specs=[pl.BlockSpec((BLOCK_K_BWD, dp), lambda j: (j, 0)),
                   cols],
        out_shape=[jax.ShapeDtypeStruct((Kp, dp), jnp.float32),
                   jax.ShapeDtypeStruct((Kp,), jnp.float32)],
        backend="triton",
        compiler_params=_params(),
        interpret=interpret,
        name="sampled_lse_dcand",
    )(*operands)
    dreps = jnp.sum(drp, axis=0)[:B, :d]
    return dreps, dc[:K, :d].astype(cand_like.dtype), dcorr[:K], None, None


sampled_lse.defvjp(_slse_fwd, _slse_bwd)


def sampled_lse_reference(reps: jax.Array, cand: jax.Array,
                          corr: jax.Array, cand_ids: jax.Array,
                          pos_ids: jax.Array, dtype: str = "float32",
                          precision=None) -> jax.Array:
    """The same masked log-sum-exp composed in XLA: the [B, k] logits
    materialize. Operands cast to ``dtype`` as in the kernel; pass
    ``precision=HIGHEST`` for an fp32 oracle on a GPU."""
    ct = _ct(dtype)
    z = jnp.dot(reps.astype(ct), cand.astype(ct).T,
                preferred_element_type=jnp.float32, precision=precision)
    z = z - corr.astype(jnp.float32)[None, :]
    z = jnp.where(cand_ids[None, :] == pos_ids[:, None], NEG, z)
    return jax.scipy.special.logsumexp(z, axis=-1)
