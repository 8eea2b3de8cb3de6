"""Sequence-parallel (SP) pair-transducer Forward DP over a device mesh.

Distributes the 5-state chain DP (ops/pairforward.py, the device form of the
reference's composed-transducer fill, forward.cpp:68-223) across devices
by sharding the Y (column) axis over a mesh axis -- the ring-wavefront
decomposition: each device owns a contiguous column block, and every row
step exchanges two tiny messages over the ring:

- the IMM shift-by-one needs the left neighbour's final imm_src value
  (one ppermute);
- the within-row IDM/IMI affine recurrences u[j] = a[j] lse (u[j-1]+b[j])
  are associative, so each device scans its local block, publishes the
  segment summary (A, B) with composition
      (A_l, B_l) . (A_r, B_r) = (lse(A_r, A_l + B_r), B_l + B_r),
  and a log2(n)-step Hillis-Steele exclusive scan over the ring yields
  the incoming carry u_in; the local fixup is
      u[j] = lse(u_local[j], u_in + cumsum(b)[j]).

Communication is O(X * log n) scalars per pair -- pure interconnect latency, no
bandwidth term -- so wall-clock approaches 1/n of the single-chip fill as
Y grows.  This is the SP/CP axis of the parallelism plan (SURVEY.md 2.7);
dp/ep axes compose with it by vmapping the wrapper over a batch.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from historian_tpu.ops.semiring import affine_scan as _affine_scan, cumsum as _cumsum, lse as _lse
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

NEG = -1e30


def _ring_affine_carry(A, B, axis_name: str, n_dev: int):
    """Exclusive affine-segment prefix over the mesh ring.

    A, B: this device's segment summary (scalars).  Returns the carry
    u_in entering this device: the composition of all devices strictly to
    the left, applied to -inf (identity carry = (-inf, 0))."""
    accA = A
    accB = B
    # prefA/prefB accumulate the exclusive prefix (identity to start)
    prefA = jnp.full_like(A, NEG)
    prefB = jnp.zeros_like(B)
    idx = jax.lax.axis_index(axis_name)
    shift = 1
    while shift < n_dev:
        perm = [(s, (s + shift) % n_dev) for s in range(n_dev)]
        inA = jax.lax.ppermute(accA, axis_name, perm)
        inB = jax.lax.ppermute(accB, axis_name, perm)
        have = idx >= shift
        # fold the incoming (left) segment into the exclusive prefix
        prefA = jnp.where(have, jnp.logaddexp(prefA, inA + prefB), prefA)
        prefB = jnp.where(have, inB + prefB, prefB)
        # and into the running inclusive accumulator for the next round
        accA = jnp.where(have, jnp.logaddexp(accA, inA + accB), accA)
        accB = jnp.where(have, inB + accB, accB)
        shift *= 2
    return prefA  # u_in = prefix applied to identity carry (-inf)


def _shift_from_left(v_last, axis_name: str, n_dev: int):
    """Each device receives its left neighbour's v_last; device 0 gets -inf."""
    perm = [(s, (s + 1) % n_dev) for s in range(n_dev)]
    incoming = jax.lax.ppermute(v_last, axis_name, perm)
    idx = jax.lax.axis_index(axis_name)
    return jnp.where(idx > 0, incoming, jnp.full_like(v_last, NEG))


def sp_pair_forward(absorb, rootsub_x, rootsub_y, ins_x, ins_y, mask, trans,
                    mesh: Mesh, axis: str = "sp"):
    """Column-sharded Forward DP.  Args as ops.pairforward.pair_forward.

    Returns lp_end (replicated scalar).  Y+1 is padded to a multiple of
    the axis size with masked-out columns; results are exact.
    """
    X1, Y1 = absorb.shape
    n_dev = mesh.shape[axis]
    pad = (-Y1) % n_dev
    if pad:
        dtype = absorb.dtype
        absorb = jnp.concatenate([absorb, jnp.full((X1, pad), NEG, dtype)], axis=1)
        rootsub_y = jnp.concatenate([rootsub_y, jnp.full((pad,), NEG, dtype)])
        ins_y = jnp.concatenate([ins_y, jnp.full((pad,), NEG, dtype)])
        mask = jnp.concatenate([mask, jnp.zeros((X1, pad), bool)], axis=1)
    Yp = Y1 + pad
    y_loc = Yp // n_dev

    fn = shard_map(
        partial(_sp_kernel, axis_name=axis, n_dev=n_dev, X1=X1, Y1=Y1, y_loc=y_loc),
        mesh=mesh,
        in_specs=(P(None, axis), P(None), P(axis), P(None), P(axis), P(None, axis), P(None)),
        out_specs=P(),
        check_vma=False,
    )
    return fn(absorb, rootsub_x, rootsub_y, ins_x, ins_y, mask, trans)


def sp_pair_forward_batch(absorb, rootsub_x, rootsub_y, ins_x, ins_y, mask, trans,
                          mesh: Mesh, dp_axis: str = "dp", sp_axis: str = "sp"):
    """dp x sp composition: the batch shards over `dp_axis` while each
    pair's columns shard over `sp_axis` (2-D mesh).  Batched args as
    the batched pair kernel; mask/trans shared.  Returns lp_end [B]."""
    B, X1, Y1 = absorb.shape
    n_sp = mesh.shape[sp_axis]
    pad = (-Y1) % n_sp
    if pad:
        dtype = absorb.dtype
        absorb = jnp.concatenate([absorb, jnp.full((B, X1, pad), NEG, dtype)], axis=2)
        rootsub_y = jnp.concatenate([rootsub_y, jnp.full((B, pad), NEG, dtype)], axis=1)
        ins_y = jnp.concatenate([ins_y, jnp.full((B, pad), NEG, dtype)], axis=1)
        mask = jnp.concatenate([mask, jnp.zeros((X1, pad), bool)], axis=1)
    y_loc = (Y1 + pad) // n_sp

    kern = partial(_sp_kernel, axis_name=sp_axis, n_dev=n_sp, X1=X1, Y1=Y1, y_loc=y_loc)

    def shard_fn(absorb_s, rsx_s, rsy_s, ix_s, iy_s, mask_s, trans_s):
        # lax.map keeps the per-pair collectives legal inside shard_map
        return jax.lax.map(
            lambda a: kern(a[0], a[1], a[2], a[3], a[4], mask_s, trans_s),
            (absorb_s, rsx_s, rsy_s, ix_s, iy_s),
        )

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(dp_axis, None, sp_axis), P(dp_axis), P(dp_axis, sp_axis),
                  P(dp_axis), P(dp_axis, sp_axis), P(None, sp_axis), P(None)),
        out_specs=P(dp_axis),
        check_vma=False,
    )
    return fn(absorb, rootsub_x, rootsub_y, ins_x, ins_y, mask, trans)


def _sp_kernel(absorb, rootsub_x, rootsub_y, ins_x, ins_y, mask, trans,
               *, axis_name, n_dev, X1, Y1, y_loc):
    (imm_imm, imm_imd, imm_idm, imm_imi, imm_iiw, imm_eee,
     imd_imm, imd_imd, imd_idm, imd_eee,
     idm_imm, idm_imd, idm_idm, idm_eee,
     imi_imm, imi_imd, imi_imi, imi_iiw, imi_eee,
     iiw_imm, iiw_idm, iiw_iiw, iiw_eee) = (trans[k] for k in range(23))

    dtype = absorb.dtype
    neg = jnp.array(NEG, dtype)
    neg_row = jnp.full((y_loc,), neg, dtype)
    dev = jax.lax.axis_index(axis_name)
    col = dev * y_loc + jnp.arange(y_loc)  # global column indices
    y_ready = (col < Y1 - 1) | (Y1 == 1)
    is_last_col = col == Y1 - 1
    x_empty = X1 == 1

    def local_shift(v, incoming):
        return jnp.concatenate([incoming[None], v[:-1]])

    def global_affine(a, b):
        """Distributed u[j] = a[j] lse (u[j-1] + b[j]) over the full row."""
        u_local = _affine_scan(a, b)
        cumb = _cumsum(b)
        u_in = _ring_affine_carry(u_local[-1], cumb[-1], axis_name, n_dev)
        return jnp.logaddexp(u_local, u_in + cumb)

    def row_step(carry, i):
        imm_p, imd_p, idm_p, imi_p, iiw_p = carry
        mask_row = mask[i]
        is_first = i == 0
        x_ready = (i < X1 - 1) | x_empty

        imd = _lse(imm_p + imm_imd, imd_p + imd_imd, idm_p + idm_imd, imi_p + imi_imd) + rootsub_x[i]
        iiw = _lse(imm_p + imm_iiw, imi_p + imi_iiw, iiw_p + iiw_iiw) + ins_x[i]
        imd = jnp.where(y_ready, imd, neg)
        iiw = jnp.where(y_ready, iiw, neg)

        imm_src = _lse(
            imm_p + imm_imm, imd_p + imd_imm, idm_p + idm_imm,
            imi_p + imi_imm, iiw_p + iiw_imm,
        )
        from_left = _shift_from_left(imm_src[-1], axis_name, n_dev)
        imm = local_shift(imm_src, from_left) + absorb[i]
        imm = jnp.where(is_first & (col == 0), 0.0, imm)
        imd = jnp.where(is_first, neg_row, imd)
        iiw = jnp.where(is_first, neg_row, iiw)
        imm = jnp.where(mask_row, imm, neg)
        imd = jnp.where(mask_row, imd, neg)
        iiw = jnp.where(mask_row, iiw, neg)

        gate = mask_row & x_ready
        idm_other = _lse(imm + imm_idm, imd + imd_idm, iiw + iiw_idm)
        idm_left = _shift_from_left(idm_other[-1], axis_name, n_dev)
        a_idm = local_shift(idm_other, idm_left) + rootsub_y
        idm = global_affine(jnp.where(gate, a_idm, neg), jnp.where(gate, idm_idm + rootsub_y, neg))
        idm = jnp.where(gate, idm, neg)

        imi_other = imm + imm_imi
        imi_left = _shift_from_left(imi_other[-1], axis_name, n_dev)
        a_imi = local_shift(imi_other, imi_left) + ins_y
        imi = global_affine(jnp.where(gate, a_imi, neg), jnp.where(gate, imi_imi + ins_y, neg))
        imi = jnp.where(gate, imi, neg)

        return (imm, imd, idm, imi, iiw), None

    init = (neg_row, neg_row, neg_row, neg_row, neg_row)
    (imm, imd, idm, imi, iiw), _ = jax.lax.scan(row_step, init, jnp.arange(X1))

    lp_here = _lse(
        imm + imm_eee, imd + imd_eee, idm + idm_eee, imi + imi_eee, iiw + iiw_eee
    )
    # the device owning global column Y1-1 contributes; others add zero
    part = jnp.sum(jnp.where(is_last_col, lp_here, 0.0))
    return jax.lax.psum(part, axis_name)
