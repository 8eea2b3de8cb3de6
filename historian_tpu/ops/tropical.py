"""Tropical (max-plus / Viterbi) variant of the pair-transducer DP.

The Forward kernel (ops/pairforward.py) is LOGSUMEXP-bound: each
5-state cell costs ~18 chained log-sum-exps, so the way past that
ceiling is FEWER lse per cell.  In the tropical semiring (max, +) every
one of them becomes a max+add -- no exp/log -- which raises the
attainable cells/s by the vector units' lse:max cost ratio.

Where this is SOUND (the reference itself runs Viterbi there):

- guide alignments: quickalign.cpp:61-94 is a 3-state Viterbi; our
  engine/quickalign + ops/pairdp already run max-plus.
- refinement sweeps: refiner.cpp:10-103 realigns branches by Viterbi
  over conditional PWMs; our sampler/refiner drives
  engine/branchmatrix with viterbi=True.
- feasibility probes: a band-doubling retry only needs to know whether
  ANY in-band path exists (lp > -inf); the tropical end value is
  finite exactly when the Forward one is.

Where it is NOT sound, and must never route:

- production merge fills (recon.cpp:917-1052): profile construction
  needs Forward cell values (sums over paths) for sampling and for the
  reference's quirky-but-canonical effective-transition sums, and the
  reference's own `-fast` best trace is an argmax over FORWARD cell
  contributions (forward.cpp:845-889), not a true Viterbi path --
  substituting Viterbi changes golden outputs.
- anything feeding counts, posteriors, or reported log-likelihoods.

The kernel below mirrors pair_forward line for line with the semiring
swapped, so the measured ratio between the two isolates the lse cost.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

NEG = -1e30


def _tmax(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = jnp.maximum(out, x)
    return out


def max_affine_scan(a, b):
    """u[j] = max(a[j], u[j-1] + b[j]), u[-1] = -inf: the tropical
    analogue of semiring.affine_scan (same associative-composition
    shape, max in place of logaddexp)."""

    def combine(left, right):
        al, bl = left
        ar, br = right
        return jnp.maximum(ar, al + br), bl + br

    u, _ = jax.lax.associative_scan(combine, (a, b))
    return u


@partial(jax.jit, static_argnames=())
def tropical_pair_forward(absorb, rootsub_x, rootsub_y, ins_x, ins_y, mask, trans):
    """Viterbi fill over the same inputs as pairforward.pair_forward.

    Returns (cells [X+1, Y+1, 5], lp_best scalar): per-cell BEST-path
    scores and the best end-to-end alignment score.  lp_best <= lp_end
    of the Forward fill, with equality only for a single-path model.
    """
    (imm_imm, imm_imd, imm_idm, imm_imi, imm_iiw, imm_eee,
     imd_imm, imd_imd, imd_idm, imd_eee,
     idm_imm, idm_imd, idm_idm, idm_eee,
     imi_imm, imi_imd, imi_imi, imi_iiw, imi_eee,
     iiw_imm, iiw_idm, iiw_iiw, iiw_eee) = (trans[k] for k in range(23))

    X1, Y1 = absorb.shape
    dtype = absorb.dtype
    neg = jnp.array(NEG, dtype)
    neg_row = jnp.full((Y1,), neg, dtype)

    y_ready = (jnp.arange(Y1) < Y1 - 1) | (Y1 == 1)
    x_empty = X1 == 1

    def shift_right(v):
        return jnp.concatenate([jnp.full((1,), neg, dtype), v[:-1]])

    def row_step(carry, i):
        imm_p, imd_p, idm_p, imi_p, iiw_p = carry
        mask_row = mask[i]
        is_first = i == 0
        x_ready = (i < X1 - 1) | x_empty

        imd = _tmax(imm_p + imm_imd, imd_p + imd_imd, idm_p + idm_imd, imi_p + imi_imd) + rootsub_x[i]
        iiw = _tmax(imm_p + imm_iiw, imi_p + imi_iiw, iiw_p + iiw_iiw) + ins_x[i]
        imd = jnp.where(y_ready, imd, neg)
        iiw = jnp.where(y_ready, iiw, neg)

        imm_src = _tmax(
            imm_p + imm_imm, imd_p + imd_imm, idm_p + idm_imm,
            imi_p + imi_imm, iiw_p + iiw_imm,
        )
        imm = shift_right(imm_src) + absorb[i]
        imm = jnp.where(is_first & (jnp.arange(Y1) == 0), 0.0, imm)
        imd = jnp.where(is_first, neg_row, imd)
        iiw = jnp.where(is_first, neg_row, iiw)
        imm = jnp.where(mask_row, imm, neg)
        imd = jnp.where(mask_row, imd, neg)
        iiw = jnp.where(mask_row, iiw, neg)

        idm_other = _tmax(imm + imm_idm, imd + imd_idm, iiw + iiw_idm)
        a_idm = shift_right(idm_other) + rootsub_y
        b_idm = idm_idm + rootsub_y
        a_idm = jnp.where(mask_row & x_ready, a_idm, neg)
        idm = max_affine_scan(a_idm, jnp.where(mask_row & x_ready, b_idm, neg))
        idm = jnp.where(mask_row & x_ready, idm, neg)

        imi_other = imm + imm_imi
        a_imi = shift_right(imi_other) + ins_y
        b_imi = imi_imi + ins_y
        a_imi = jnp.where(mask_row & x_ready, a_imi, neg)
        imi = max_affine_scan(a_imi, jnp.where(mask_row & x_ready, b_imi, neg))
        imi = jnp.where(mask_row & x_ready, imi, neg)

        return (imm, imd, idm, imi, iiw), (imm, imd, idm, imi, iiw)

    init = (neg_row, neg_row, neg_row, neg_row, neg_row)
    _, rows = jax.lax.scan(row_step, init, jnp.arange(X1))
    cells = jnp.stack(rows, axis=-1)

    final = cells[X1 - 1, Y1 - 1]
    lp_best = _tmax(
        final[0] + imm_eee, final[1] + imd_eee, final[2] + idm_eee,
        final[3] + imi_eee, final[4] + iiw_eee,
    )
    return cells, lp_best
