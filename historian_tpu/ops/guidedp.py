"""Device-resident guide alignment: batched banded Viterbi fill AND
traceback in one dispatch.

Counterpart of the reference's guide-stage hot loop
(/root/reference/src/quickalign.cpp:52-207 driven by span.cpp:90-120).
The round-2 route built emit/start/mask matrices on the host, shipped
them to the device, and read the three full [X, Y] score matrices back
for a host traceback -- IO that dwarfs the compute (a 10-sequence
guide stage moves ~100 MB).  Here the device
receives only tokens + envelope diagonals (~KBs/pair), builds the
score inputs itself (the substitution gather and gap-cost iotas are
device math), fills, picks the best end cell, and walks the Viterbi
traceback in a batched while_loop; the host reads back step codes and
scores (~KBs/pair).  Matrices never leave the device.

The traceback reproduces the host walk (engine/quickalign.py
::align_path) exactly: same candidate order (Match, Insert, Delete,
Start), same strict-> first-max tie-breaking, same end-cell flat
argmax order -- pinned bitwise on CPU f64 by tests/test_guidedp.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from historian_tpu.ops.pairdp import NEG_INF, banded_viterbi_fill

#: traceback step codes (host decodes into alignment path columns)
STEP_M, STEP_I, STEP_D = 0, 1, 2


def _gap_vec(pos, no_gap, gap_open, gap_extend, dtype):
    """(pos==1 ? noGap : gapOpen + (pos-2)*gapExtend), device-side."""
    p = pos.astype(dtype)
    return jnp.where(pos == 1, no_gap, gap_open + (p - 2) * gap_extend)


def _one_pair(x_tok, y_tok, lut, x_len, y_len, submat, trans, gaps):
    """Fill + end-cell + traceback for one (padded) pair.

    x_tok/y_tok: [PX]/[PY] int32 tokens, -1 at invalid/padded positions;
    lut: [PX+PY] bool diagonal membership, index (i - j) + PY;
    x_len/y_len: scalars; submat [A, A]; trans [10] (pairdp layout);
    gaps: [3] = no_gap, gap_open, gap_extend.
    """
    PX, PY = x_tok.shape[0], y_tok.shape[0]
    X1, Y1 = PX + 1, PY + 1
    dtype = submat.dtype
    neg = jnp.asarray(NEG_INF, dtype)
    no_gap, gap_open, gap_extend = gaps[0], gaps[1], gaps[2]

    # explicit i32 iotas: x64 is globally enabled (ops/__init__) and i64
    # index math is pure waste on the device
    ii = jnp.arange(X1, dtype=jnp.int32)[:, None]
    jj = jnp.arange(Y1, dtype=jnp.int32)[None, :]

    # emit[i, j] = log-odds of x_tok[i-1] vs y_tok[j-1]; 0 where invalid
    xt = jnp.concatenate([jnp.full((1,), -1, x_tok.dtype), x_tok])  # [X1]
    yt = jnp.concatenate([jnp.full((1,), -1, y_tok.dtype), y_tok])
    valid = (xt >= 0)[:, None] & (yt >= 0)[None, :]
    emit = jnp.where(
        valid, submat[jnp.maximum(xt, 0)[:, None], jnp.maximum(yt, 0)[None, :]], 0.0
    ).astype(dtype)

    # envelope mask: diagonal LUT, row/col 0 and out-of-length excluded
    # (mirrors engine/diagenv.py::mask)
    mask = lut[(ii - jj) + PY]
    mask = mask & (ii >= 1) & (jj >= 1) & (ii <= x_len) & (jj <= y_len)

    start_gap = (
        _gap_vec(ii, no_gap, gap_open, gap_extend, dtype)
        + _gap_vec(jj, no_gap, gap_open, gap_extend, dtype)
    )

    mat, ins, dele = banded_viterbi_fill(emit, mask, start_gap, trans)
    # kernel layout is [Y1, X1] (column-major stack); keep it -- the
    # traceback below indexes [j, i]

    # ---- best end cell: host order is flat argmax over [Y, X] (j-major,
    # i ascending, strict > keeps the first maximum) ---------------------
    end_i = jnp.where(
        ii == x_len, no_gap, gap_open + (x_len - ii - 2).astype(dtype) * gap_extend
    )
    end_j = jnp.where(
        jj == y_len, no_gap, gap_open + (y_len - jj - 2).astype(dtype) * gap_extend
    )
    end_sc = mat + (end_i + end_j).T  # [Y1, X1]
    in_grid = (ii.T >= 1) & (jj.T >= 1) & (ii.T <= x_len) & (jj.T <= y_len)
    flat = jnp.where(in_grid[1:, 1:], end_sc[1:, 1:], -jnp.inf).reshape(-1)
    best = jnp.argmax(flat).astype(jnp.int32)
    bj, bi = best // PX, best % PX
    x_end = (bi + 1).astype(jnp.int32)
    y_end = (bj + 1).astype(jnp.int32)
    score = flat[best]

    # ---- traceback (candidate order M, I, D, Start; first max wins) ----
    m2m, m2i, m2d, i2i, i2m, i2d, d2d, d2m = (trans[k] for k in range(8))
    L = PX + PY  # each step decrements i+j by >= 1

    def cell(m, j, i):
        return m[j, i]

    def body(carry):
        i, j, state, n, steps = carry

        # state M: sources at (i-1, j-1) + emit(i, j); Start terminates
        e = emit[i, j]
        cm_m = cell(mat, j - 1, i - 1) + m2m + e
        cm_i = cell(ins, j - 1, i - 1) + i2m + e
        cm_d = cell(dele, j - 1, i - 1) + d2m + e
        cm_s = (
            _gap_vec(i, no_gap, gap_open, gap_extend, dtype)
            + _gap_vec(j, no_gap, gap_open, gap_extend, dtype)
            + e
        )
        # first-max in order (M, I, D, S) via strict >
        m_next = jnp.int32(0)
        m_best = cm_m
        m_next = jnp.where(cm_i > m_best, 1, m_next)
        m_best = jnp.maximum(m_best, cm_i)
        m_next = jnp.where(cm_d > m_best, 2, m_next)
        m_best = jnp.maximum(m_best, cm_d)
        m_next = jnp.where(cm_s > m_best, 3, m_next)

        # state I: sources at (i, j-1); candidates (M, I)
        ci_m = cell(mat, j - 1, i) + m2i
        ci_i = cell(ins, j - 1, i) + i2i
        i_next = jnp.where(ci_i > ci_m, jnp.int32(1), jnp.int32(0))

        # state D: sources at (i-1, j); candidates (M, I, D)
        cd_m = cell(mat, j, i - 1) + m2d
        cd_i = cell(ins, j, i - 1) + i2d
        cd_d = cell(dele, j, i - 1) + d2d
        d_next = jnp.int32(0)
        d_best = cd_m
        d_next = jnp.where(cd_i > d_best, 1, d_next)
        d_best = jnp.maximum(d_best, cd_i)
        d_next = jnp.where(cd_d > d_best, 2, d_next)

        nxt = jnp.where(state == 0, m_next, jnp.where(state == 1, i_next, d_next))
        di = jnp.where(state == 1, 0, 1)  # I keeps i
        dj = jnp.where(state == 2, 0, 1)  # D keeps j
        steps = steps.at[n].set(state.astype(jnp.int8))
        return i - di, j - dj, nxt, n + 1, steps

    def cond(carry):
        i, j, state, n, _ = carry
        return (state != 3) & (n < L)

    steps0 = jnp.full((L,), jnp.int8(3))
    i_f, j_f, _, n_steps, steps = jax.lax.while_loop(
        cond, body, (x_end, y_end, jnp.int32(0), jnp.int32(0), steps0)
    )
    return steps, n_steps, x_end, y_end, i_f, j_f, score


@partial(jax.jit, static_argnames=())
def guide_align_device(x_tok, y_tok, lut, x_len, y_len, submat, trans, gaps):
    """Batched fill+traceback.  x_tok [B, PX], y_tok [B, PY], lut
    [B, PX+PY], x_len/y_len [B] int32; submat/trans/gaps shared.

    Returns (steps [B, PX+PY] int8 -- codes 0=M 1=I 2=D, 3=pad --
    n_steps, x_end, y_end, lead_i, lead_j, score) per pair.  Steps are
    in end->start order; lead_i/lead_j are the (i, j) where the walk
    hit Start (the leading free gap)."""
    return jax.vmap(_one_pair, in_axes=(0, 0, 0, 0, 0, None, None, None))(
        x_tok, y_tok, lut, x_len, y_len, submat, trans, gaps
    )
