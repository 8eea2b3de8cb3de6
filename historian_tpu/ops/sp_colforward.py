"""Sequence-parallel (SP) column-major Forward DP: the PRODUCTION merge
shape (chain x x sampled-profile DAG y) sharded across a device mesh.

ops/sp_pairforward.py demonstrated the ring-wavefront decomposition on
chain x chain pairs; this kernel applies it to the fill production
reconstruction actually dispatches (ops/colforward.py): the x chain
shards over the mesh axis, the scan stays column-major over y states,
and each device keeps its OWN x-block of every earlier column -- so the
y DAG's in-edge gathers (the structure that makes the row-major kernel
expensive) remain device-local.  Per column, exactly five tiny messages
cross the ring:

- three shift-by-one boundaries (the x-chain step of IMM's t5 reduction
  and of the IMD/IIW source mixes): one ppermute scalar each;
- two affine-scan carries for the within-column IMD/IIW recurrences
  u[i] = a[i] lse (u[i-1] + b[i]): each device scans its block and a
  log2(n)-step ring scan composes the segment summaries
  (ops/sp_pairforward._ring_affine_carry).

Communication is O(SY * log n) scalars per merge -- pure interconnect latency --
while each device's column step does 1/n of the O(KY * SX) vector work,
so the fill approaches 1/n wall-clock as SX grows (long-sequence
scaling, SURVEY.md 2.7 sp / 5.long-context).

Exactness: same recurrences, reassociated; the dryrun asserts parity
against the single-device kernel on a real gp120 sampled-profile merge.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from historian_tpu.ops.sp_pairforward import _ring_affine_carry, _shift_from_left
from historian_tpu.ops.semiring import affine_scan as _affine_scan, cumsum as _cumsum, lse as _lse

NEG = -1e30


def _lse_last(v, neg):
    m = jnp.maximum(jnp.max(v, axis=-1), neg)
    return m + jnp.log(jnp.sum(jnp.exp(v - m[..., None]), axis=-1))


def sp_col_forward_cells(
    absorb_t, rootsub_x, ins_x, rootsub_y, ins_y, mask_t, trans,
    x_ready, x_eos, y_src, y_lp, y_null, y_ready,
    mesh: Mesh, axis: str = "sp",
):
    """Args as ops.colforward.col_pair_forward_cells, plus the mesh.
    Returns the same COLUMN-major [SY, SX, 5] cell tensor (reassembled
    across the x shards); SX pads up to the axis size internally."""
    SY, SX = absorb_t.shape
    n_dev = mesh.shape[axis]
    pad = (-SX) % n_dev
    if pad:
        # pad x with masked NEG rows at the global end (they land in the
        # last device's block, so no inter-device boundary moves)
        dtype = np.asarray(absorb_t).dtype
        absorb_t = np.concatenate(
            [absorb_t, np.full((SY, pad), NEG, dtype)], axis=1
        )
        rootsub_x = np.concatenate([rootsub_x, np.full(pad, NEG, dtype)])
        ins_x = np.concatenate([ins_x, np.full(pad, NEG, dtype)])
        mask_t = np.concatenate([mask_t, np.zeros((SY, pad), bool)], axis=1)
        x_ready = np.concatenate([x_ready, np.zeros(pad, bool)])
        x_eos = np.concatenate([x_eos, np.zeros(pad, bool)])
    fn = shard_map(
        partial(_sp_col_kernel, axis_name=axis, n_dev=n_dev),
        mesh=mesh,
        in_specs=(
            P(None, axis),  # absorb_t
            P(axis), P(axis),  # rootsub_x, ins_x
            P(None), P(None),  # rootsub_y, ins_y
            P(None, axis),  # mask_t
            P(None),  # trans
            P(axis), P(axis),  # x_ready, x_eos
            P(None, None), P(None, None),  # y_src, y_lp
            P(None), P(None),  # y_null, y_ready
        ),
        out_specs=P(None, axis, None),
        check_vma=False,
    )
    out = fn(
        absorb_t, rootsub_x, ins_x, rootsub_y, ins_y, mask_t, trans,
        x_ready, x_eos, y_src, y_lp, y_null, y_ready,
    )
    return out[:, :SX, :] if pad else out


def _sp_col_kernel(
    absorb_t, rootsub_x, ins_x, rootsub_y, ins_y, mask_t, trans,
    x_ready, x_eos, y_src, y_lp, y_null, y_ready,
    *, axis_name, n_dev,
):
    (imm_imm, imm_imd, imm_idm, imm_imi, imm_iiw, _imm_eee,
     imd_imm, imd_imd, imd_idm, _imd_eee,
     idm_imm, idm_imd, idm_idm, _idm_eee,
     imi_imm, imi_imd, imi_imi, imi_iiw, _imi_eee,
     iiw_imm, iiw_idm, iiw_iiw, _iiw_eee) = (trans[k] for k in range(23))

    SY, x_loc = absorb_t.shape
    dtype = absorb_t.dtype
    neg = jnp.array(NEG, dtype)
    dev = jax.lax.axis_index(axis_name)
    row_ix = dev * x_loc + jnp.arange(x_loc)  # global x indices
    x_gate = jnp.where(x_ready, 0.0, neg)

    def shift1(v):
        """v at global i-1: local shift with the left neighbour's last
        lane crossing the ring (device 0 reads the NEG boundary)."""
        incoming = _shift_from_left(v[-1], axis_name, n_dev)
        return jnp.concatenate([incoming[None], v[:-1]])

    def global_affine(a, b):
        """u[i] = a[i] lse (u[i-1] + b[i]) over the full (sharded) row."""
        u_local = _affine_scan(a, b)
        cumb = _cumsum(b)
        u_in = _ring_affine_carry(u_local[-1], cumb[-1], axis_name, n_dev)
        return jnp.logaddexp(u_local, u_in + cumb)

    def col_step(cells, xs):
        j, srcj, lpj, absorb_col, mask_col, rsy_j, isy_j, nul_j, rdy_j = xs
        srcs = cells[srcj]  # [KY, x_loc, 5]
        w = lpj[:, None]
        s_imm, s_imd, s_idm, s_imi, s_iiw = (srcs[..., k] for k in range(5))

        def red_k(v):  # lse over the KY axis of [KY, x_loc]
            return _lse_last(jnp.swapaxes(v + w, 0, 1), neg)

        mgate = jnp.where(mask_col, 0.0, neg)

        t5 = _lse(s_imm + imm_imm, s_imd + imd_imm, s_idm + idm_imm,
                  s_imi + imi_imm, s_iiw + iiw_imm)
        imm_e = shift1(red_k(t5)) + absorb_col
        imm_n = jnp.where(x_eos, red_k(s_imm), neg)
        imm_col = jnp.where(nul_j, imm_n, imm_e)
        imm_col = jnp.where((j == 0) & (row_ix == 0), 0.0, imm_col)
        imm_col = imm_col + mgate

        kn_idm = _lse(s_imm + imm_idm, s_imd + imd_idm,
                      s_idm + idm_idm, s_iiw + iiw_idm)
        idm_e = red_k(kn_idm) + rsy_j + x_gate
        idm_n = red_k(s_idm)
        idm_col = jnp.where(nul_j, idm_n, idm_e) + mgate

        kn_imi = _lse(s_imm + imm_imi, s_imi + imi_imi)
        imi_e = red_k(kn_imi) + isy_j + x_gate
        imi_n = red_k(s_imi)
        imi_col = jnp.where(nul_j, imi_n, imi_e) + mgate

        ygate = jnp.where(rdy_j, 0.0, neg)
        a_imd = (shift1(_lse(imm_col + imm_imd, idm_col + idm_imd,
                             imi_col + imi_imd))
                 + rootsub_x + ygate + mgate)
        b_imd = jnp.maximum(imd_imd + rootsub_x + mgate, neg)
        imd_col = global_affine(a_imd, b_imd)

        a_iiw = (shift1(_lse(imm_col + imm_iiw, imi_col + imi_iiw))
                 + ins_x + ygate + mgate)
        b_iiw = jnp.maximum(iiw_iiw + ins_x + mgate, neg)
        iiw_col = global_affine(a_iiw, b_iiw)

        col = jnp.stack([imm_col, imd_col, idm_col, imi_col, iiw_col], axis=-1)
        col = jnp.maximum(col, neg)
        z = jnp.int32(0)
        cells = jax.lax.dynamic_update_slice(cells, col[None], (j, z, z))
        return cells, None

    cells0 = jnp.full((SY, x_loc, 5), neg, dtype)
    xs = (jnp.arange(SY, dtype=jnp.int32), y_src, y_lp, absorb_t, mask_t,
          rootsub_y, ins_y, y_null, y_ready)
    cells, _ = jax.lax.scan(col_step, cells0, xs)
    return cells
