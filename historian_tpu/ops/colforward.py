"""Device kernel: Forward DP scanned COLUMN-major (over y states).

Complements the row-major DAG kernel (ops/dagforward.py) for the merge
shape production reconstruction hits most: x a pure emit chain (a leaf
sequence, or any -fast best-trace profile) composed against a general
sampled-profile DAG y.  Scanning over y states instead of x rows makes
the y DAG structure FREE:

- every y in-edge becomes a gather of an earlier, already-final column
  (the toposort order of y states IS the scan order, so null-state
  propagation needs no fixed-point iteration and junction states need
  no sequential inner solve -- the two costs that dominate the
  row-major kernel when y has hundreds of non-chain states);
- the only within-column recurrences left are IMD / IIW along x, and a
  pure chain x makes those single associative affine scans.

Sequential depth is exactly SY vector steps of O(KY * SX) work --
measured on gp120 this replaces ~500-1000 sequential junction gathers
per row with zero.

Matches the reference fill over toposorted profile-state pairs
(/root/reference/src/forward.cpp:78-203) restricted to chain x;
the host oracle is engine/forward.py::ForwardMatrix._fill.

Semiring zero is the finite NEG = -1e30 as in the sibling kernels; the
bridge (ops/devicedp.py) restores -inf on readback.  The cell tensor is
carried and returned COLUMN-major [SY, SX, 5] so in-edge gathers index
the leading axis.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

NEG = -1e30


def _lse(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = jnp.logaddexp(out, x)
    return out


def _lse_last(v, neg):
    """logsumexp over the last axis, NEG-saturated (no -inf, no NaN)."""
    m = jnp.maximum(jnp.max(v, axis=-1), neg)
    return m + jnp.log(jnp.sum(jnp.exp(v - m[..., None]), axis=-1))


def _affine_scan(a, b):
    """u[i] = logaddexp(a[i], u[i-1] + b[i]), u[-1] = -inf (NEG-safe)."""

    def combine(l, r):
        vl, wl = l
        vr, wr = r
        return jnp.logaddexp(vr, vl + wr), jnp.maximum(wl + wr, NEG)

    v, _ = jax.lax.associative_scan(combine, (a, b))
    return v


@partial(jax.jit, static_argnames=())
def col_pair_forward_cells(
    absorb_t,  # [SY, SX]  absorb + x-chain edge lp folded per row of x
    rootsub_x, ins_x,  # [SX]  (+ x-chain edge lp folded)
    rootsub_y, ins_y,  # [SY]
    mask_t,  # [SY, SX] bool envelope (False in padding)
    trans,  # [23] packed PairHMM transition log-probs
    x_ready, x_eos,  # [SX] bool: ready|empty, emit-or-start
    y_src, y_lp,  # [SY, KY] in-edge sources / log-probs (NEG pad)
    y_null, y_ready,  # [SY] bool (ready = ready|empty)
):
    """Returns the cell tensor COLUMN-major: [SY, SX, 5], state order
    IMM, IMD, IDM, IMI, IIW as in engine/pairhmm.py."""
    (imm_imm, imm_imd, imm_idm, imm_imi, imm_iiw, _imm_eee,
     imd_imm, imd_imd, imd_idm, _imd_eee,
     idm_imm, idm_imd, idm_idm, _idm_eee,
     imi_imm, imi_imd, imi_imi, imi_iiw, _imi_eee,
     iiw_imm, iiw_idm, iiw_iiw, _iiw_eee) = (trans[k] for k in range(23))

    SY, SX = absorb_t.shape
    dtype = absorb_t.dtype
    neg = jnp.array(NEG, dtype)
    row_ix = jnp.arange(SX)
    x_gate = jnp.where(x_ready, 0.0, neg)  # IDM/IMI emit-dest gate per row

    def shift1(v):
        """v at i-1 (x chain step); i = 0 reads the boundary NEG."""
        return jnp.concatenate([jnp.full((1,), neg, dtype), v[:-1]])

    def col_step(cells, xs):
        j, srcj, lpj, absorb_col, mask_col, rsy_j, isy_j, nul_j, rdy_j = xs
        srcs = cells[srcj]  # [KY, SX, 5]
        w = lpj[:, None]  # [KY, 1]
        s_imm, s_imd, s_idm, s_imi, s_iiw = (srcs[..., k] for k in range(5))

        def red_k(v):  # lse over the KY axis of [KY, SX]
            return _lse_last(jnp.swapaxes(v + w, 0, 1), neg)

        mgate = jnp.where(mask_col, 0.0, neg)

        # ---- IMM ---------------------------------------------------------
        t5 = _lse(s_imm + imm_imm, s_imd + imd_imm, s_idm + idm_imm,
                  s_imi + imi_imm, s_iiw + iiw_imm)  # [KY, SX]
        imm_e = shift1(red_k(t5)) + absorb_col  # xy-absorbing dests
        imm_n = jnp.where(x_eos, red_k(s_imm), neg)  # y-null dests
        imm_col = jnp.where(nul_j, imm_n, imm_e)
        imm_col = jnp.where((j == 0) & (row_ix == 0), 0.0, imm_col)  # start
        imm_col = imm_col + mgate

        # ---- IDM / IMI (within-row y moves; all sources already final) ---
        kn_idm = _lse(s_imm + imm_idm, s_imd + imd_idm,
                      s_idm + idm_idm, s_iiw + iiw_idm)
        idm_e = red_k(kn_idm) + rsy_j + x_gate
        idm_n = red_k(s_idm)
        idm_col = jnp.where(nul_j, idm_n, idm_e) + mgate

        kn_imi = _lse(s_imm + imm_imi, s_imi + imi_imi)
        imi_e = red_k(kn_imi) + isy_j + x_gate
        imi_n = red_k(s_imi)
        imi_col = jnp.where(nul_j, imi_n, imi_e) + mgate

        # ---- IMD / IIW (x-direction; chain x -> affine scans over i) -----
        ygate = jnp.where(rdy_j, 0.0, neg)
        a_imd = (shift1(_lse(imm_col + imm_imd, idm_col + idm_imd,
                             imi_col + imi_imd))
                 + rootsub_x + ygate + mgate)
        b_imd = jnp.maximum(imd_imd + rootsub_x + mgate, neg)
        imd_col = _affine_scan(a_imd, b_imd)

        a_iiw = (shift1(_lse(imm_col + imm_iiw, imi_col + imi_iiw))
                 + ins_x + ygate + mgate)
        b_iiw = jnp.maximum(iiw_iiw + ins_x + mgate, neg)
        iiw_col = _affine_scan(a_iiw, b_iiw)

        col = jnp.stack([imm_col, imd_col, idm_col, imi_col, iiw_col], axis=-1)
        col = jnp.maximum(col, neg)
        z = jnp.int32(0)
        cells = jax.lax.dynamic_update_slice(cells, col[None], (j, z, z))
        return cells, None

    cells0 = jnp.full((SY, SX, 5), neg, dtype)
    xs = (jnp.arange(SY, dtype=jnp.int32), y_src, y_lp, absorb_t, mask_t,
          rootsub_y, ins_y, y_null, y_ready)
    cells, _ = jax.lax.scan(col_step, cells0, xs)
    return cells


# ---------------------------------------------------------------- col route
# The production route (ops/devicedp.py::col_forward_cells) builds the
# emission and the band mask on device and runs the column scan in ONE
# jit.  `kernel` picks the scan: "xla" (col_pair_forward_cells above) or
# "cuda" (ops/cuda_colforward.py, one launch per merge).  `v` is the dict
# of per-row / per-column vectors (rsx, isx, rsy, isy, trans, x_ready,
# x_eos, y_src, y_lp, y_null, y_ready).


def col_planes(kernel: str, absorb, mask, v):
    """Column scan over a built [SY, SX] absorb/mask -> [5, SY, SX]."""
    if kernel == "cuda":
        from historian_tpu.ops.cuda_colforward import col_forward_planes

        return col_forward_planes(absorb, mask, v)
    cells = col_pair_forward_cells(
        absorb, v["rsx"], v["isx"], v["rsy"], v["isy"], mask, v["trans"],
        v["x_ready"], v["x_eos"], v["y_src"], v["y_lp"], v["y_null"],
        v["y_ready"],
    )
    return jnp.moveaxis(cells, -1, 0)


def _gate(dense, mask):
    neg = jnp.asarray(NEG, dense.dtype)
    return jnp.where(mask, jnp.maximum(dense, neg), neg)


def absorb_vecmask(ey_e, ex_e, shift_y, shift_x, m2, m1, dist, yne, xns, ny, nx):
    """Factored emission absorb[j, i] = log(ey_e[j] . ex_e[i]) + shifts,
    with the band mask rebuilt from the envelope's O(L) vectors
    (engine/forward.py env_vectors: near_end[j] | near_start[i] |
    |m2[j] - m1[i]| <= dist), ANDed with the real-region bounds so
    padded rows and columns are always out of band."""
    dense = jnp.log(ey_e @ ex_e.T) + shift_y[:, None] + shift_x[None, :]
    in_range = (
        (jnp.arange(ey_e.shape[0]) < ny)[:, None]
        & (jnp.arange(ex_e.shape[0]) < nx)[None, :]
    )
    mask = in_range & (
        yne[:, None] | xns[None, :] | (jnp.abs(m2[:, None] - m1[None, :]) <= dist)
    )
    return _gate(dense, mask), mask


def absorb_idx(ey_e, ex_e, shift_y, shift_x, idx):
    """Factored emission gated by a mask scattered from flat in-band
    indices (ops/devicedp._mask_idx; out-of-range sentinels drop)."""
    SY, SX = ey_e.shape[0], ex_e.shape[0]
    dense = jnp.log(ey_e @ ex_e.T) + shift_y[:, None] + shift_x[None, :]
    mask = jnp.zeros((SY * SX,), bool).at[idx].set(True, mode="drop").reshape(SY, SX)
    return _gate(dense, mask), mask


@partial(jax.jit, static_argnames=("kernel",))
def fill_planes(absorb, mask, v, *, kernel):
    return col_planes(kernel, absorb, mask, v)


@partial(jax.jit, static_argnames=("kernel",))
def fill_vecmask(v, ey_e, ex_e, shift_y, shift_x, m2, m1, dist, yne, xns,
                 ny, nx, *, kernel):
    absorb, mask = absorb_vecmask(
        ey_e, ex_e, shift_y, shift_x, m2, m1, dist, yne, xns, ny, nx
    )
    return col_planes(kernel, absorb, mask, v)


@partial(jax.jit, static_argnames=("kernel",))
def fill_idx(v, ey_e, ex_e, shift_y, shift_x, idx, *, kernel):
    absorb, mask = absorb_idx(ey_e, ex_e, shift_y, shift_x, idx)
    return col_planes(kernel, absorb, mask, v)
