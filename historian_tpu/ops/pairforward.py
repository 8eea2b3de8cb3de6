"""Device kernel: 5-state pair-transducer Forward DP over sequence chains.

This is the device hot path for the composition DP when both child profiles
are chains (leaf sequences, or linearized sampled profiles): the general
DAG machinery (engine/forward.py) reduces to the classic banded pair-HMM
recurrence, which maps cleanly onto XLA:

- lax.scan over x positions (rows);
- IMD/IIW/IMM contributions read only the previous row -> vector ops
  across all y positions on the vector units;
- the within-row IDM/IMI recurrences u[j] = a[j] lse (u[j-1] + b) are
  affine in the (log, +, logsumexp) semiring -> jax.lax.associative_scan
  with the affine-composition operator, O(log Y) depth instead of a
  sequential column walk.

Emission tensors (rootsub pair-absorb matrix, per-position insert scores)
are batched einsums computed once up front -- that is where the FLOPs
are, and they run as matmuls.

State indexing matches engine/pairhmm.py: IMM, IMD, IDM, IMI, IIW.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from historian_tpu.ops.semiring import affine_scan as _affine_scan, lse as _lse

NEG = -1e30


def emission_tensors(x_onehot, y_onehot, sub_l, sub_r, log_root, log_cpt_weight, log_ins_l, log_ins_r):
    """Precompute all emission scores as batched einsums.

    x_onehot: [X, A] (leaf one-hots or profile emission probabilities,
    linear space), sub_l/sub_r: [C, A, A] branch substitution matrices,
    log_root: [C, A] (log root prob + log component weight).

    Returns (absorb [X, Y], rootsub_x [X], rootsub_y [Y], ins_x [X], ins_y [Y]).
    """
    # subx[e, c, a] = sum_d subL[c, a, d] * x_onehot[e, d]
    subx = jnp.einsum("cad,xd->xca", sub_l, x_onehot)
    suby = jnp.einsum("cad,yd->yca", sub_r, y_onehot)
    root = jnp.exp(log_root)  # [C, A]
    # absorb[x, y] = log sum_{c,a} root[c,a] subx[x,c,a] suby[y,c,a]
    absorb = jnp.log(jnp.einsum("xca,ca,yca->xy", subx, root, suby) + 1e-300)
    rootsub_x = jnp.log(jnp.einsum("xca,ca->x", subx, root) + 1e-300)
    rootsub_y = jnp.log(jnp.einsum("yca,ca->y", suby, root) + 1e-300)
    w_ins_l = jnp.exp(log_cpt_weight[:, None] + log_ins_l)  # [C, A]
    w_ins_r = jnp.exp(log_cpt_weight[:, None] + log_ins_r)
    ins_x = jnp.log(jnp.einsum("xa,ca->x", x_onehot, w_ins_l) + 1e-300)
    ins_y = jnp.log(jnp.einsum("ya,ca->y", y_onehot, w_ins_r) + 1e-300)
    return absorb, rootsub_x, rootsub_y, ins_x, ins_y


@partial(jax.jit, static_argnames=())
def pair_forward(
    absorb,  # [X+1, Y+1]; absorb[i, j] valid for i,j >= 1
    rootsub_x,  # [X+1]
    rootsub_y,  # [Y+1]
    ins_x,  # [X+1]
    ins_y,  # [Y+1]
    mask,  # [X+1, Y+1] bool envelope (row/col 0 = True at start edge)
    trans,  # [23] packed PairHMM transition log-probs (see pack_transitions)
):
    """Returns (cells [X+1, Y+1, 5], lp_end scalar)."""
    (imm_imm, imm_imd, imm_idm, imm_imi, imm_iiw, imm_eee,
     imd_imm, imd_imd, imd_idm, imd_eee,
     idm_imm, idm_imd, idm_idm, idm_eee,
     imi_imm, imi_imd, imi_imi, imi_iiw, imi_eee,
     iiw_imm, iiw_idm, iiw_iiw, iiw_eee) = (trans[k] for k in range(23))

    X1, Y1 = absorb.shape
    dtype = absorb.dtype
    neg = jnp.array(NEG, dtype)
    neg_row = jnp.full((Y1,), neg, dtype)

    # Wait/Ready gating (canonical gap ordering, reference forward.cpp:95-162):
    # the final chain state is a Wait state, so x-absorbing transitions are
    # blocked at j = Y and y-absorbing transitions are blocked at i = X
    # (unless the other profile is empty).
    y_ready = (jnp.arange(Y1) < Y1 - 1) | (Y1 == 1)
    x_empty = X1 == 1

    def shift_right(v):
        return jnp.concatenate([jnp.full((1,), neg, dtype), v[:-1]])

    def row_step(carry, i):
        imm_p, imd_p, idm_p, imi_p, iiw_p = carry  # row i-1
        mask_row = mask[i]
        is_first = i == 0
        x_ready = (i < X1 - 1) | x_empty

        # x-absorbing: IMD, IIW from previous row, same j (gated by y ready)
        imd = _lse(imm_p + imm_imd, imd_p + imd_imd, idm_p + idm_imd, imi_p + imi_imd) + rootsub_x[i]
        iiw = _lse(imm_p + imm_iiw, imi_p + imi_iiw, iiw_p + iiw_iiw) + ins_x[i]
        imd = jnp.where(y_ready, imd, neg)
        iiw = jnp.where(y_ready, iiw, neg)

        # xy-absorbing IMM from previous row, previous column
        imm_src = _lse(
            imm_p + imm_imm, imd_p + imd_imm, idm_p + idm_imm,
            imi_p + imi_imm, iiw_p + iiw_imm,
        )
        imm = shift_right(imm_src) + absorb[i]
        # start cell
        imm = jnp.where(is_first & (jnp.arange(Y1) == 0), 0.0, imm)
        imd = jnp.where(is_first, neg_row, imd)
        iiw = jnp.where(is_first, neg_row, iiw)
        imm = jnp.where(mask_row, imm, neg)
        imd = jnp.where(mask_row, imd, neg)
        iiw = jnp.where(mask_row, iiw, neg)

        # y-absorbing within-row recurrences (IDM, IMI): affine scans,
        # gated by x ready (blocked on the final x row)
        idm_other = _lse(imm + imm_idm, imd + imd_idm, iiw + iiw_idm)
        a_idm = shift_right(idm_other) + rootsub_y
        b_idm = idm_idm + rootsub_y
        a_idm = jnp.where(mask_row & x_ready, a_idm, neg)
        idm = _affine_scan(a_idm, jnp.where(mask_row & x_ready, b_idm, neg))
        idm = jnp.where(mask_row & x_ready, idm, neg)

        imi_other = imm + imm_imi
        a_imi = shift_right(imi_other) + ins_y
        b_imi = imi_imi + ins_y
        a_imi = jnp.where(mask_row & x_ready, a_imi, neg)
        imi = _affine_scan(a_imi, jnp.where(mask_row & x_ready, b_imi, neg))
        imi = jnp.where(mask_row & x_ready, imi, neg)

        return (imm, imd, idm, imi, iiw), (imm, imd, idm, imi, iiw)

    init = (neg_row, neg_row, neg_row, neg_row, neg_row)
    _, rows = jax.lax.scan(row_step, init, jnp.arange(X1))
    cells = jnp.stack(rows, axis=-1)  # [X+1, Y+1, 5]

    final = cells[X1 - 1, Y1 - 1]
    lp_end = _lse(
        final[0] + imm_eee, final[1] + imd_eee, final[2] + idm_eee,
        final[3] + imi_eee, final[4] + iiw_eee,
    )
    return cells, lp_end


@partial(jax.jit, static_argnames=())
def chain_pair_forward_cells(
    absorb,  # [X1, Y1]; NEG-padded beyond the true sizes
    rootsub_x,  # [X1] (transition lp into each x state folded in)
    rootsub_y,  # [Y1]
    ins_x,  # [X1]
    ins_y,  # [Y1]
    mask,  # [X1, Y1] bool envelope (False in padding)
    trans,  # [23] packed PairHMM transition log-probs
    x_ready,  # [X1] bool Wait/Ready gating (replaces the shape-derived test)
    y_ready,  # [Y1] bool
):
    """`pair_forward` for bucket-padded production profiles: the true
    profile sizes live INSIDE the padded [X1, Y1] grid, so the Wait/Ready
    gates arrive as explicit vectors instead of being derived from the
    array shape, and only the banded cell tensor is returned (the end
    gather runs on host over the profiles' end transitions).  Transition
    log-probs of the chain profiles are pre-folded by the caller into
    rootsub/ins/absorb (each cell's value gains the lp of the edges that
    enter it -- exactly the reference recurrence, forward.cpp:86-202,
    restricted to single-in-edge chain states)."""
    (imm_imm, imm_imd, imm_idm, imm_imi, imm_iiw, _imm_eee,
     imd_imm, imd_imd, imd_idm, _imd_eee,
     idm_imm, idm_imd, idm_idm, _idm_eee,
     imi_imm, imi_imd, imi_imi, imi_iiw, _imi_eee,
     iiw_imm, iiw_idm, iiw_iiw, _iiw_eee) = (trans[k] for k in range(23))

    X1, Y1 = absorb.shape
    dtype = absorb.dtype
    neg = jnp.array(NEG, dtype)
    neg_row = jnp.full((Y1,), neg, dtype)

    def shift_right(v):
        return jnp.concatenate([jnp.full((1,), neg, dtype), v[:-1]])

    def row_step(carry, i):
        imm_p, imd_p, idm_p, imi_p, iiw_p = carry  # row i-1
        mask_row = mask[i]
        is_first = i == 0
        x_rdy = x_ready[i]

        imd = _lse(imm_p + imm_imd, imd_p + imd_imd, idm_p + idm_imd, imi_p + imi_imd) + rootsub_x[i]
        iiw = _lse(imm_p + imm_iiw, imi_p + imi_iiw, iiw_p + iiw_iiw) + ins_x[i]
        imd = jnp.where(y_ready, imd, neg)
        iiw = jnp.where(y_ready, iiw, neg)

        imm_src = _lse(
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

        idm_other = _lse(imm + imm_idm, imd + imd_idm, iiw + iiw_idm)
        a_idm = shift_right(idm_other) + rootsub_y
        b_idm = idm_idm + rootsub_y
        a_idm = jnp.where(mask_row & x_rdy, a_idm, neg)
        idm = _affine_scan(a_idm, jnp.where(mask_row & x_rdy, b_idm, neg))
        idm = jnp.where(mask_row & x_rdy, idm, neg)

        imi_other = imm + imm_imi
        a_imi = shift_right(imi_other) + ins_y
        b_imi = imi_imi + ins_y
        a_imi = jnp.where(mask_row & x_rdy, a_imi, neg)
        imi = _affine_scan(a_imi, jnp.where(mask_row & x_rdy, b_imi, neg))
        imi = jnp.where(mask_row & x_rdy, imi, neg)

        return (imm, imd, idm, imi, iiw), (imm, imd, idm, imi, iiw)

    init = (neg_row, neg_row, neg_row, neg_row, neg_row)
    _, rows = jax.lax.scan(row_step, init, jnp.arange(X1))
    return jnp.stack(rows, axis=-1)  # [X1, Y1, 5]


def pack_transitions(hmm) -> np.ndarray:
    """Flatten an engine.pairhmm.PairHMM into the kernel's [23] layout."""
    return np.array(
        [
            hmm.imm_imm, hmm.imm_imd, hmm.imm_idm, hmm.imm_imi, hmm.imm_iiw, hmm.imm_eee,
            hmm.imd_imm, hmm.imd_imd, hmm.imd_idm, hmm.imd_eee,
            hmm.idm_imm, hmm.idm_imd, hmm.idm_idm, hmm.idm_eee,
            hmm.imi_imm, hmm.imi_imd, hmm.imi_imi, hmm.imi_iiw, hmm.imi_eee,
            hmm.iiw_imm, hmm.iiw_idm, hmm.iiw_iiw, hmm.iiw_eee,
        ]
    )


def chain_pair_forward_arrays(model, x_seq: str, y_seq: str, t_x: float, t_y: float, dtype=np.float32):
    """Host-side packaging: build kernel inputs for a leaf sequence pair."""
    from historian_tpu.engine.pairhmm import PairHMM
    from historian_tpu.models.ratemodel import ProbModel

    xp = ProbModel(model, t_x)
    yp = ProbModel(model, t_y)
    hmm = PairHMM(xp, yp, model.ins_prob)
    x1 = model.alphabet.one_hot(x_seq, dtype=dtype)
    y1 = model.alphabet.one_hot(y_seq, dtype=dtype)
    # pad with a leading row for the DP boundary (position 0 = start)
    pad_x = np.zeros((1, model.alphabet_size), dtype=dtype)
    x_onehot = np.concatenate([pad_x, x1])
    y_onehot = np.concatenate([pad_x, y1])
    absorb, rsx, rsy, ix, iy = emission_tensors(
        jnp.asarray(x_onehot),
        jnp.asarray(y_onehot),
        jnp.asarray(xp.sub_mat, dtype=dtype),
        jnp.asarray(yp.sub_mat, dtype=dtype),
        jnp.asarray(hmm.log_root, dtype=dtype),
        jnp.asarray(np.log(model.cpt_weight), dtype=dtype),
        jnp.asarray(hmm.logl.log_ins_prob, dtype=dtype),
        jnp.asarray(hmm.logr.log_ins_prob, dtype=dtype),
    )
    mask = np.ones((len(x_seq) + 1, len(y_seq) + 1), dtype=bool)
    trans = pack_transitions(hmm).astype(dtype)
    return (absorb, rsx, rsy, ix, iy, jnp.asarray(mask), jnp.asarray(trans)), hmm
