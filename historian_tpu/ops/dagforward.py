"""Device kernel: Forward DP over general (DAG) profile pairs.

Generalizes the chain scan kernel (ops/pairforward.py) to the profiles
production reconstruction actually produces (reference
forward.cpp:78-203 over toposorted profile-state pairs): sampled
profiles under COLLAPSE_CHAINS are NEAR-chains -- measured on gp120,
~500-900 states with only ~10-90 null states and ~25-130 multi-in-edge
states -- so the DP decomposes as

- a lax.scan over x states (rows) carrying the full banded cell tensor;
  x-direction contributions gather K-padded in-edge source rows and
  reduce them with vector ops over all y (vector-unit work);
- a within-row solve for the y-direction recurrences (IDM/IMI, and IMM
  through null-y states), decomposed exactly into
    (1) a few gather iterations for IMM at null-y columns,
    (2) an associative affine scan over the chain-emit y states with the
        non-chain "junction" states cut out,
    (3) a short sequential scan over the junctions only (each gathers
        its in-edges from prefix values + segment propagators), and
    (4) a vectorized recombination distributing junction values back
        into their trailing chain segments.
  Sequential depth is therefore O(Sx * J) junction steps instead of
  O(Sx * Sy) cell steps.

Semiring zero is the finite NEG = -1e30 (never -inf: NEG arithmetic
keeps the cumulative-sum propagator trick NaN-free; anything
contaminated stays below the -1e25 readback cutoff).  All shapes are
bucket-padded by the host bridge (ops/devicedp.py) so a handful of
compiled programs covers a whole reconstruction.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from historian_tpu.ops.semiring import (
    affine_scan as _affine_scan,
    cumsum as _cumsum,
    lse as _lse,
)

NEG = -1e30


def _lse_last(v, neg):
    """logsumexp over the last axis, NEG-saturated (no -inf, no NaN)."""
    m = jnp.maximum(jnp.max(v, axis=-1), neg)
    return m + jnp.log(jnp.sum(jnp.exp(v - m[..., None]), axis=-1))


@partial(jax.jit, static_argnames=())
def dag_pair_forward_cells(
    # emissions (transition lps NOT folded in -- edges are explicit here)
    absorb,  # [SX, SY]
    rootsub_x, ins_x,  # [SX]
    rootsub_y, ins_y,  # [SY]
    mask,  # [SX, SY] bool envelope (False in padding)
    trans,  # [23] packed PairHMM transition log-probs
    # x profile structure
    x_src, x_lp,  # [SX, KX] in-edge sources / log-probs (NEG pad)
    x_null, x_eos, x_ready,  # [SX] bool: null, emit-or-start, ready|empty
    # y profile structure
    y_src, y_lp,  # [SY, KY]
    y_null, y_ready,  # [SY] bool (ready|empty)
    y_chain,  # [SY] bool: emit with a single in-edge from y-1
    y_govq,  # [SY] int32: 1-based id of the junction governing each state
    jidx,  # [J] int32 junction state indices (pad: out-of-range SY)
    nidx,  # [JN] int32 null-y state indices (pad likewise)
    n_null_iters,  # scalar int32: null->null IMM chain depth
):
    """Returns the [SX, SY, 5] cell tensor (state order IMM..IIW as in
    engine/pairhmm.py).  Rows cover profile states 0..SX-1 (the caller
    excludes the END state and pads); the end gather runs on host."""
    (imm_imm, imm_imd, imm_idm, imm_imi, imm_iiw, _imm_eee,
     imd_imm, imd_imd, imd_idm, _imd_eee,
     idm_imm, idm_imd, idm_idm, _idm_eee,
     imi_imm, imi_imd, imi_imi, imi_iiw, _imi_eee,
     iiw_imm, iiw_idm, iiw_iiw, _iiw_eee) = (trans[k] for k in range(23))

    SX, SY = absorb.shape
    J = jidx.shape[0]
    dtype = absorb.dtype
    neg = jnp.array(NEG, dtype)
    col_ix = jnp.arange(SY)

    # chain-scan coefficients shared by every row (row gates applied inside)
    y_lp1 = y_lp[:, 0]  # a chain state's single edge sits in slot 0
    bs_idm_c = idm_idm + y_lp1 + rootsub_y
    bs_imi_c = imi_imi + y_lp1 + ins_y
    is_junction = ~y_chain
    gov_col = jnp.where(y_govq > 0, jidx[jnp.maximum(y_govq - 1, 0)], -1)

    def solve_y(b, w_rec, bs_chain, gate, mask_row, x_rdy):
        """Exact within-row solve of u = A u (+) b over the y DAG.

        b: [SY] known sources (already gated); w_rec: [SY, KY] recursive
        edge weights into each dest; bs_chain: [SY] chain propagators;
        gate: [SY] validity of emit-dest updates (mask & x ready);
        mask_row: [SY] envelope row (null dests are env-masked only).
        Chain states solve by one associative affine scan with junctions
        cut; junction values come from a short sequential scan gathering
        prefix values + saturating-cumsum segment propagators; a final
        vectorized pass recombines."""
        ok = gate & y_chain
        a_p = jnp.where(ok, b, neg)
        bs_p = jnp.where(ok, bs_chain, neg)
        p = _affine_scan(a_p, bs_p)
        # propagator cumsum: cs[j] - cs[gov] = product of chain edges over
        # (gov, j].  Blocked (junction/masked) positions are counted
        # separately -- folding NEG into the cumsum would absorb every
        # later real addition (float: -5e31 + -6.1 == -5e31) and make rel
        # collapse to 0 for all positions after the first blocked one.
        cs = _cumsum(jnp.where(ok, bs_chain, 0.0))
        blocked = _cumsum(jnp.where(ok, 0, 1))
        cs0 = jnp.concatenate([jnp.zeros(1, dtype), cs])
        blk0 = jnp.concatenate([jnp.zeros(1, blocked.dtype), blocked])
        gov1 = jnp.where(gov_col >= 0, gov_col + 1, 0)
        rel = jnp.where(
            blocked - blk0[gov1] > 0, neg, cs - jnp.where(gov_col >= 0, cs0[gov1], 0.0)
        )
        rel = jnp.where(is_junction, 0.0, rel)
        p_j = jnp.where(is_junction, neg, p)

        def jstep(uvec, q):
            jq = jidx[q]
            srcs = y_src[jq]  # [KY]
            vals = _lse(p_j[srcs], rel[srcs] + uvec[y_govq[srcs]])
            u_q = _lse(b[jq], _lse_last(w_rec[jq] + vals, neg))
            u_q = jnp.where(mask_row[jq], u_q, neg)
            return uvec.at[q + 1].set(u_q), None

        uvec0 = jnp.full((J + 1,), neg, dtype)
        uvec, _ = jax.lax.scan(jstep, uvec0, jnp.arange(J))
        u = _lse(p_j, rel + uvec[y_govq])
        return jnp.where(is_junction, uvec[y_govq], u)

    def row_step(cells, i):
        mask_row = mask[i]
        srcs = cells[x_src[i]]  # [KX, SY, 5]
        w = x_lp[i][:, None]  # [KX, 1]
        s_imm, s_imd, s_idm, s_imi, s_iiw = (srcs[..., k] for k in range(5))

        def red_k(v):  # lse over the KX axis of [KX, SY]
            return _lse_last(jnp.swapaxes(v + w, 0, 1), neg)

        # ---- x-direction (reads earlier rows only) ----------------------
        mix_imd = _lse(s_imm + imm_imd, s_imd + imd_imd, s_idm + idm_imd, s_imi + imi_imd)
        mix_iiw = _lse(s_imm + imm_iiw, s_imi + imi_iiw, s_iiw + iiw_iiw)
        xn = x_null[i]
        imd_row = jnp.where(xn, red_k(s_imd), red_k(mix_imd) + rootsub_x[i])
        iiw_row = jnp.where(xn, red_k(s_iiw), red_k(mix_iiw) + ins_x[i])
        imd_row = jnp.where(y_ready & mask_row, imd_row, neg)
        iiw_row = jnp.where(y_ready & mask_row, iiw_row, neg)

        t5 = _lse(s_imm + imm_imm, s_imd + imd_imm, s_idm + idm_imm,
                  s_imi + imi_imm, s_iiw + iiw_imm)  # [KX, SY]
        tk = red_k(t5)  # [SY]
        imm_e = _lse_last(tk[y_src] + y_lp, neg) + absorb[i]  # emit-y dests
        imm_e = jnp.where(y_null, neg, imm_e)
        imm_n = jnp.where(y_ready, red_k(s_imm), neg)
        imm_row = jnp.where(xn, imm_n, imm_e)
        imm_row = jnp.where((i == 0) & (col_ix == 0), 0.0, imm_row)
        imm_row = jnp.where(mask_row, imm_row, neg)

        # ---- IMM through null-y columns (x emit-or-start rows) ----------
        def null_iter(_, imm_r):
            vals = _lse_last(imm_r[y_src[nidx]] + y_lp[nidx], neg)
            vals = jnp.where(mask_row[nidx], vals, neg)
            # padded nidx entries carry the out-of-range sentinel SY and
            # must not touch any real column (gathers above clamp, which
            # is fine: the result is dropped here)
            return imm_r.at[nidx].set(vals, mode="drop")

        imm_prop = jax.lax.fori_loop(0, n_null_iters, null_iter, imm_row)
        imm_prop = jnp.where((i == 0) & (col_ix == 0), 0.0, imm_prop)
        imm_row = jnp.where(x_eos[i], imm_prop, imm_row)

        # ---- within-row IDM / IMI ---------------------------------------
        x_rdy = x_ready[i]
        gate_e = mask_row & ~y_null & x_rdy
        kn_idm = _lse(imm_row + imm_idm, imd_row + imd_idm, iiw_row + iiw_idm)
        b_idm = _lse_last(kn_idm[y_src] + y_lp, neg) + rootsub_y
        b_idm = jnp.where(gate_e, b_idm, neg)
        w_idm = jnp.where(
            y_null[:, None], y_lp,
            jnp.where(gate_e[:, None], y_lp + idm_idm + rootsub_y[:, None], neg),
        )
        idm_row = solve_y(b_idm, w_idm, bs_idm_c, gate_e, mask_row, x_rdy)

        kn_imi = imm_row + imm_imi
        b_imi = _lse_last(kn_imi[y_src] + y_lp, neg) + ins_y
        b_imi = jnp.where(gate_e, b_imi, neg)
        w_imi = jnp.where(
            y_null[:, None], y_lp,
            jnp.where(gate_e[:, None], y_lp + imi_imi + ins_y[:, None], neg),
        )
        imi_row = solve_y(b_imi, w_imi, bs_imi_c, gate_e, mask_row, x_rdy)

        row = jnp.stack([imm_row, imd_row, idm_row, imi_row, iiw_row], axis=-1)
        row = jnp.where(mask_row[:, None], row, neg)
        cells = jax.lax.dynamic_update_slice(cells, row[None], (i, 0, 0))
        return cells, None

    cells0 = jnp.full((SX, SY, 5), neg, dtype)
    cells, _ = jax.lax.scan(row_step, cells0, jnp.arange(SX))
    return cells
