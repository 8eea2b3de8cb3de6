"""Device traceback for the composition DP: stochastic and best traces
walked on the accelerator, so the banded cell tensor never leaves the
device.

The reference's sampleProfile/bestProfile (forward.cpp:845-889, 257-307)
walk the host cell map; round 2's device route therefore read the whole
in-envelope band back per merge (~MBs, which dominated device
reconstruction).  Here the walk runs on
device against the fill kernels' resident planes; the host reads back
only the visited cells -- (i, j, state, value) per step, ~100 KB per
merge -- which is exactly what make_profile consumes (engine/forward.py
::make_profile reads cells only at retained trace cells; effective-
transition elimination is pure profile structure).

Candidate semantics mirror engine/forward.py::source_transitions
exactly for a chain-x x DAG-y pair (x single-in-edge emit chain, y any
profile DAG -- the shapes the col/chain fill kernels handle):

- candidates are enumerated in the host's sorted-by-(i', j', s') order
  (y in-edge rows are pre-sorted by source index by the bridge);
- the emit/absorb term lp_cell_emit_or_absorb(dest), a constant shift
  across a dest's candidates, cancels in both the softmax weights and
  p = u * ptot, so the walker never needs the absorb matrix;
- best traces take the first maximum in candidate order (strict >),
  matching DPMatrix.best_cell.

Random draws: one uniform per step from jax.random, keyed per merge by
a single host mt19937 draw.  Device-mode sampling is therefore NOT
draw-for-draw identical to the host walk (which it could not be anyway:
accelerator fills are f32) but is deterministic given the CLI seed.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

NEG = -1e30

# state codes (engine/pairhmm.py): IMM, IMD, IDM, IMI, IIW, EEE
IMM, IMD, IDM, IMI, IIW, EEE = 0, 1, 2, 3, 4, 5

#: source-state gates per dest state (PairHMM.sources), additive 0/NEG
def _source_gate():
    import numpy as np

    g = np.full((5, 5), NEG, dtype=np.float32)  # [dest, src]
    g[IMM, [IMM, IMD, IDM, IMI, IIW]] = 0.0
    g[IMD, [IMM, IMD, IDM, IMI]] = 0.0
    g[IDM, [IMM, IMD, IDM, IIW]] = 0.0
    g[IMI, [IMM, IMI]] = 0.0
    g[IIW, [IMM, IIW, IMI]] = 0.0
    return g


def _end_lp(planes, trans6, xe_src, xe_lp, ye_src, ye_lp):
    """lp_end exactly as the host gathers it (engine/forward.py
    ::_finish_fill): left-to-right 5-way logaddexp of cell + trans per
    end-edge pair, + edge lps, chained into lp_end in ye order."""
    dtype = planes.dtype
    # per-plane gathers: see pair_trace_device's layout note (a strided
    # [5, SY, SX] gather relayouts the planes with the 5-axis minor)
    e_cell = jnp.stack(
        [planes[k][ye_src, xe_src] for k in range(5)], axis=-1
    )  # [KE, 5]
    row = e_cell[:, 0] + trans6[0, EEE]
    for q in (1, 2, 3, 4):
        row = jnp.logaddexp(row, e_cell[:, q] + trans6[q, EEE])
    row = row + xe_lp + ye_lp

    def chain(carry, v):
        return jnp.logaddexp(carry, v), None

    lp_end, _ = jax.lax.scan(chain, jnp.asarray(-jnp.inf, dtype), row)
    return lp_end


end_lp_device = jax.jit(_end_lp)


@partial(jax.jit, static_argnames=("n_steps_max",))
def pair_trace_device(
    planes,  # [5, SY, SX] fill output (NEG semiring zero)
    y_src, y_lp,  # [SY, KY] y in-edges SORTED by source per row (pad: lp=NEG)
    y_null,  # [SY] bool
    tx,  # [SX] transition lp into x state i (tx[0] = 0)
    trans6,  # [6, 6] dense PairHMM table (NEG-clamped)
    xe_src, xe_lp,  # scalar i32 / scalar: the chain x END in-edge
    ye_src, ye_lp,  # [KE] y END in-edges sorted by source (pad: lp=NEG)
    uniforms,  # [T, L] in [0, 1): one draw per step (ignored for best traces)
    is_best,  # [T] bool: argmax walk instead of sampled
    n_steps_max: int,  # static L
):
    """Walk T traces simultaneously.  Returns (path_i, path_j, path_s
    [T, L] i32 (post-step cells, END excluded, in end->start order),
    vals [T, L] f32 (cell value at each path cell), n_steps [T] i32,
    lp_end f32 scalar).

    Every step strictly decreases i + j (chain x edges point to i-1,
    y edges to toposorted earlier states), so L = SX + SY bounds the
    walk; traces stop at the start cell (0, 0)."""
    dtype = planes.dtype
    neg = jnp.asarray(NEG, dtype)
    T = is_best.shape[0]
    L = n_steps_max
    SY = y_src.shape[0]
    KY = y_src.shape[1]
    KE = ye_src.shape[0]
    gate = jnp.asarray(_source_gate(), dtype)  # [dest, src]
    # NEVER relayout the planes with the 5-state axis minor: a
    # [SY, SX, 5] (or {0,2,1}-laid [5, SY, SX]) copy of a 6144x6144
    # merge is a multi-GB transpose, and tiled layouts can pad the
    # minor 5 far wider.  Instead gather from five separate [SY, SX]
    # planes (major-axis slices) and stack only the SMALL gather
    # outputs.
    plane_list = [planes[k] for k in range(5)]

    def cell_rows(jj, ii):
        """planes[:, jj, ii] stacked as [..., 5] without any big copy."""
        return jnp.stack([p[jj, ii] for p in plane_list], axis=-1)

    def pick(cand_lp, cand_i, cand_j, cand_s, u, best):
        """Select one candidate: host sample_cell / best_cell semantics.
        cand_* are flat, in host-sorted candidate order."""
        lpmax = jnp.max(cand_lp)
        w = jnp.exp(cand_lp - lpmax)  # NEG entries underflow to exactly 0
        ptot = jnp.sum(w)
        p = u * ptot
        # host: subtract weights in order, stop at p <= 0  <=>  first
        # index with cumsum >= p (cumsum is monotone; 0-weight pads are
        # exact no-ops either way)
        cum = jnp.cumsum(w)
        k_samp = jnp.argmax(cum >= p).astype(jnp.int32)
        k_best = jnp.argmax(cand_lp).astype(jnp.int32)  # first max (strict >)
        k = jnp.where(best, k_best, k_samp)
        return cand_i[k], cand_j[k], cand_s[k]

    s_ix = jnp.arange(5, dtype=jnp.int32)

    def step_candidates(i, j, s):
        """Candidate table for dest (i, j, s), s in 0..4: [(KY+1)*5] flat,
        host-sorted.  Rows 0..KY-1: y-move candidates (k-major, source
        ascending; s' inner); row KY: x-move candidates.  A dest's live
        candidates are all-y or all-x, so the flat order is exact."""
        ys = y_src[j]  # [KY]
        yl = y_lp[j]
        ynul = y_null[j]

        # -- y-move rows ------------------------------------------------
        # dest IMM through null y: single s' = IMM, lp = y edge only
        # dest IDM/IMI through null y: single s' = s, lp = y edge only
        # dest IMM both-emit: i' = i-1, all s', lp = T6 + tx[i] + edge
        # dest IDM/IMI emit-y: i' = i,  s' in sources(s), lp = T6 + edge
        is_imm = s == IMM
        null_sprime_ok = (s_ix[None, :] == jnp.where(is_imm, IMM, s))
        emit_lp = jnp.where(
            is_imm,
            gate[IMM][None, :] + trans6[s_ix, IMM][None, :] + tx[i],
            gate[s][None, :] + trans6[s_ix, s][None, :],
        )  # [1, 5]
        y_cand_lp = jnp.where(
            ynul,
            jnp.where(null_sprime_ok, yl[:, None], neg),
            yl[:, None] + emit_lp,
        )  # [KY, 5]
        y_i = jnp.where(is_imm & ~ynul, i - 1, i)
        y_cell = cell_rows(ys, jnp.maximum(y_i, 0))  # [KY, 5]
        y_cand = jnp.maximum(y_cand_lp + y_cell, neg)
        y_live = (s == IMM) | (s == IDM) | (s == IMI)
        y_cand = jnp.where(y_live, y_cand, neg)

        # -- x-move row (dest IMD/IIW; chain x is never null) -------------
        x_cand_lp = gate[s] + trans6[s_ix, s] + tx[i]  # [5]
        x_cell = cell_rows(j, jnp.maximum(i - 1, 0))  # [5]
        x_cand = jnp.maximum(x_cand_lp + x_cell, neg)
        x_live = (s == IMD) | (s == IIW)
        x_cand = jnp.where(x_live, x_cand, neg)

        cand_lp = jnp.concatenate([y_cand.reshape(-1), x_cand])  # [(KY+1)*5]
        ci = jnp.concatenate(
            [jnp.broadcast_to(y_i, (KY, 5)).reshape(-1),
             jnp.full((5,), i - 1, jnp.int32)]
        )
        cj = jnp.concatenate(
            [jnp.broadcast_to(ys[:, None], (KY, 5)).reshape(-1),
             jnp.full((5,), j, jnp.int32)]
        )
        cs = jnp.concatenate(
            [jnp.broadcast_to(s_ix[None, :], (KY, 5)).reshape(-1), s_ix]
        )
        return cand_lp, ci.astype(jnp.int32), cj, cs

    # ---- EEE step (trace start): end-transition candidate table --------
    e_cell = cell_rows(ye_src, xe_src)  # [KE, 5]
    e_lp = jnp.maximum(
        ye_lp[:, None] + trans6[s_ix, EEE][None, :] + xe_lp + e_cell, neg
    )  # [KE, 5]
    e_i = jnp.full((KE * 5,), xe_src, jnp.int32)
    e_j = jnp.broadcast_to(ye_src[:, None], (KE, 5)).reshape(-1).astype(jnp.int32)
    e_s = jnp.broadcast_to(s_ix[None, :], (KE, 5)).reshape(-1)

    lp_end = _end_lp(planes, trans6, xe_src, xe_lp, ye_src, ye_lp)

    def first_step(u, best):
        return pick(e_lp.reshape(-1), e_i, e_j, e_s, u, best)

    i0, j0, s0 = jax.vmap(first_step)(uniforms[:, 0], is_best)

    # ---- batched walk ----------------------------------------------------
    def one_step(carry):
        n, i, j, s, done, pi, pj, ps = carry

        def one(i_t, j_t, s_t, u_t, best_t):
            cand_lp, ci, cj, cs = step_candidates(i_t, j_t, s_t)
            return pick(cand_lp, ci, cj, cs, u_t, best_t)

        ni, nj, ns = jax.vmap(one)(i, j, s, uniforms[:, n + 1], is_best)
        ni = jnp.where(done, i, ni)
        nj = jnp.where(done, j, nj)
        ns = jnp.where(done, s, ns)
        pi = pi.at[:, n + 1].set(jnp.where(done, -1, ni))
        pj = pj.at[:, n + 1].set(jnp.where(done, -1, nj))
        ps = ps.at[:, n + 1].set(jnp.where(done, -1, ns))
        done = done | ((ni == 0) & (nj == 0))
        return n + 1, ni, nj, ns, done, pi, pj, ps

    # (an 8x unrolled body was tried and measured identical at 6144^2 --
    # the walk is gather-latency-bound per step, not loop-overhead-bound)
    body = one_step

    def cond(carry):
        n, _, _, _, done, *_ = carry
        return (~jnp.all(done)) & (n + 1 < L)

    pi0 = jnp.full((T, L), -1, jnp.int32).at[:, 0].set(i0)
    pj0 = jnp.full((T, L), -1, jnp.int32).at[:, 0].set(j0)
    ps0 = jnp.full((T, L), -1, jnp.int32).at[:, 0].set(s0)
    done0 = (i0 == 0) & (j0 == 0)
    _, _, _, _, _, pi, pj, ps = jax.lax.while_loop(
        cond, body, (jnp.int32(0), i0, j0, s0, done0, pi0, pj0, ps0)
    )
    n_steps = jnp.sum(pi >= 0, axis=1).astype(jnp.int32)
    # cell values along the paths (make_profile's fwdLogProb metadata)
    all5 = cell_rows(jnp.maximum(pj, 0), jnp.maximum(pi, 0))  # [T, L, 5]
    vals = jnp.take_along_axis(
        all5, jnp.maximum(ps, 0)[..., None], axis=-1
    )[..., 0]
    vals = jnp.where(pi >= 0, vals, neg)
    return pi, pj, ps, vals, n_steps, lp_end
