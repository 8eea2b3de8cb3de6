"""Banded pairwise Viterbi DP kernel.

Counterpart of the reference's QuickAlignMatrix fill
(/root/reference/src/quickalign.cpp:52-99).  The reference iterates cell
by cell inside a sparse diagonal envelope; here the fill is a lax.scan
over y-columns with every x-row computed in parallel on the vector units:

- Match/Insert depend only on the previous column -> pure vector ops.
- Delete's within-column recursion del[i] = max(base[i], del[i-1]+d2d)
  has a constant extension penalty, so it collapses to a running-max:
  del = cummax(base - i*d2d) + i*d2d  (max-plus prefix scan).

The diagonal envelope enters as a dense [X+1, Y+1] mask (out-of-band
cells pinned to -inf), preserving the sparse C++ semantics while keeping
shapes static for XLA.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

NEG_INF = -1e30  # avoid actual -inf: (-inf) - (-inf) NaNs in backward passes


@partial(jax.jit, static_argnames=())
def banded_viterbi_fill(
    emit,  # [X+1, Y+1]: emit[i, j] = match emission log-odds at (i, j); rows/cols 0 unused
    mask,  # [X+1, Y+1] bool envelope
    start_gap,  # [X+1, Y+1]: startGapScore(i, j)
    trans,  # [10]: m2m, m2i, m2d, i2i, i2m, i2d, d2d, d2m, unused, unused
):
    """Returns (mat, ins, del) each [Y+1, X+1] (column-major stack)."""
    m2m, m2i, m2d, i2i, i2m, i2d, d2d, d2m = (trans[k] for k in range(8))
    X1 = emit.shape[0]
    Y1 = emit.shape[1]
    dtype = emit.dtype
    neg = jnp.array(NEG_INF, dtype)
    idx = jnp.arange(X1, dtype=dtype)

    col0 = jnp.full((X1,), neg, dtype)

    def shift_down(v):
        return jnp.concatenate([jnp.full((1,), neg, dtype), v[:-1]])

    def step(carry, j):
        m_prev, i_prev, d_prev = carry  # column j-1
        mask_col = mask[:, j]
        m_prev_sh = shift_down(m_prev)
        i_prev_sh = shift_down(i_prev)
        d_prev_sh = shift_down(d_prev)

        m_cand = jnp.maximum(
            jnp.maximum(m_prev_sh + m2m, d_prev_sh + d2m), i_prev_sh + i2m
        )
        m_cand = jnp.maximum(m_cand, start_gap[:, j])
        m = jnp.where(mask_col, m_cand + emit[:, j], neg)

        ins = jnp.where(mask_col, jnp.maximum(i_prev + i2i, m_prev + m2i), neg)

        # del[i] = max(base[i], del[i-1] + d2d): a max-plus prefix scan with
        # constant increment, but the chain must BREAK at out-of-envelope
        # cells (sparse-storage semantics) -> segmented running max via
        # associative_scan with "segment boundary" flags at masked cells.
        base = jnp.maximum(shift_down(ins) + i2d, shift_down(m) + m2d)
        z = jnp.where(mask_col, base - idx * d2d, neg)
        flag = ~mask_col

        def seg_combine(left, right):
            vl, fl = left
            vr, fr = right
            return jnp.where(fr, vr, jnp.maximum(vl, vr)), fl | fr

        seg_max, _ = jax.lax.associative_scan(seg_combine, (z, flag))
        d = jnp.where(mask_col, seg_max + idx * d2d, neg)

        return (m, ins, d), (m, ins, d)

    (_, _, _), (mats, inss, dels) = jax.lax.scan(
        step, (col0, col0, col0), jnp.arange(1, Y1)
    )
    # prepend column 0
    mats = jnp.concatenate([col0[None, :], mats], axis=0)
    inss = jnp.concatenate([col0[None, :], inss], axis=0)
    dels = jnp.concatenate([col0[None, :], dels], axis=0)
    return mats, inss, dels  # [Y+1, X+1]


@partial(jax.jit, static_argnames=())
def banded_viterbi_fill_diag(
    emit_b,   # [B, Y+1]: emit[j + d_b, j] gathered into band coordinates
    start_b,  # [B, Y+1]: startGapScore in band coordinates
    valid_b,  # [B, Y+1] bool: cell (j + d_b, j) exists and is in-envelope
    up_idx,   # [B] int32: slot holding diagonal d_b + 1, or -1 (for Insert)
    down_ok,  # [B] bool: slot b-1 holds diagonal d_b - 1 (Delete chains)
    dvec,     # [B] float: the diagonal value d_b of each slot
    trans,    # [10] as banded_viterbi_fill
):
    """The quickalign Viterbi in diagonal-band coordinates.

    Cell (i, j) lives at (slot b, column j) with i = j + d_b over the
    envelope's active diagonals d (sorted ascending) -- compute is
    O(B * Y) instead of O(X * Y), a big win for sparse envelopes.
    Identical cell values to banded_viterbi_fill: Match stays on its
    diagonal (previous column, same slot), Insert comes from d+1
    (gathered via up_idx), and Delete's within-column chain walks
    adjacent diagonals (segmented max-plus scan broken where d-1 is
    absent or the cell is invalid).  Returns (mat, ins, del) [B, Y+1].
    """
    m2m, m2i, m2d, i2i, i2m, i2d, d2d, d2m = (trans[k] for k in range(8))
    B, Y1 = emit_b.shape
    dtype = emit_b.dtype
    neg = jnp.array(NEG_INF, dtype)

    def gather_up(v):
        # value at diagonal d_b + 1, or -inf when absent
        return jnp.where(up_idx >= 0, v[jnp.clip(up_idx, 0, B - 1)], neg)

    def shift_down_slot(v):
        # value at diagonal d_b - 1 == slot b-1 when adjacent
        s = jnp.concatenate([jnp.full((1,), neg, dtype), v[:-1]])
        return jnp.where(down_ok, s, neg)

    col0 = jnp.full((B,), neg, dtype)

    def step(carry, j):
        m_prev, i_prev, d_prev = carry
        ok = valid_b[:, j]
        # M(i,j) sources all sit at (i-1, j-1): previous column, same slot
        m_cand = jnp.maximum(jnp.maximum(m_prev + m2m, d_prev + d2m), i_prev + i2m)
        m_cand = jnp.maximum(m_cand, start_b[:, j])
        m = jnp.where(ok, m_cand + emit_b[:, j], neg)

        # I(i, j) sources (i, j-1): i = (j-1) + (d+1) -> prev column, d+1
        ins = jnp.where(
            ok, jnp.maximum(gather_up(i_prev) + i2i, gather_up(m_prev) + m2i), neg
        )

        # D(i, j) sources (i-1, j): same column, d-1 -> segmented
        # max-plus chain down adjacent slots
        base = jnp.maximum(shift_down_slot(ins) + i2d, shift_down_slot(m) + m2d)
        # multiplier is the GLOBAL row index i = j + d, so the telescoped
        # sums round identically to the dense kernel (bitwise parity)
        iv = dvec + j.astype(dtype)
        z = jnp.where(ok, base - iv * d2d, neg)
        flag = (~ok) | (~down_ok)

        def seg_combine(left, right):
            vl, fl = left
            vr, fr = right
            return jnp.where(fr, vr, jnp.maximum(vl, vr)), fl | fr

        seg_max, _ = jax.lax.associative_scan(seg_combine, (z, flag))
        d = jnp.where(ok, seg_max + iv * d2d, neg)

        return (m, ins, d), (m, ins, d)

    (_, _, _), (mats, inss, dels) = jax.lax.scan(
        step, (col0, col0, col0), jnp.arange(1, Y1)
    )
    mats = jnp.concatenate([col0[:, None], jnp.moveaxis(mats, 0, 1)], axis=1)
    inss = jnp.concatenate([col0[:, None], jnp.moveaxis(inss, 0, 1)], axis=1)
    dels = jnp.concatenate([col0[:, None], jnp.moveaxis(dels, 0, 1)], axis=1)
    return mats, inss, dels  # [B, Y+1]
