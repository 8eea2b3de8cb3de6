"""Batched ML pairwise evolutionary distances.

The reference estimates each pairwise distance with its own
golden-section minimization of the negative log-likelihood
(/root/reference/src/model.cpp:506-655), O(N^2) sequential 1-D solves.
Here all pairs are solved together on device:

1. pair count matrices [P, A, A] by one-hot einsum over aligned columns;
2. NLL for all pairs on a shared log-spaced t-grid in one einsum
   [P,A,A] x [T,A,A] (matmul work) using eigendecomposed P(t) = V e^{Lt} V^-1
   evaluated for the whole grid at once;
3. vectorized golden-section refinement: every pair iterates in lockstep
   with its own bracket.

For exact parity with the reference's per-pair GSL iteration sequence,
RateModel.ml_distance_from_counts replicates GSL's goldensection
minimizer host-side; this module is the production path.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

T_MIN = 1e-9
T_MAX = 10.0


def pair_count_matrices(alphabet, gapped_rows: list[str], dtype=np.float64) -> np.ndarray:
    """[P, A, A] aligned-pair counts for all P = N(N-1)/2 pairs (i < j)."""
    n = len(gapped_rows)
    a = alphabet.size
    length = len(gapped_rows[0]) if n else 0
    toks = np.stack([alphabet.tokenize(r) for r in gapped_rows])  # [N, L]
    onehot = np.zeros((n, length, a), dtype=dtype)
    valid = toks >= 0
    idx = np.nonzero(valid)
    onehot[idx[0], idx[1], toks[valid]] = 1.0
    pairs = [(i, j) for i in range(n - 1) for j in range(i + 1, n)]
    out = np.empty((len(pairs), a, a), dtype=dtype)
    for p, (i, j) in enumerate(pairs):
        out[p] = np.einsum("la,lb->ab", onehot[i], onehot[j])
    return out


@partial(jax.jit, static_argnames=("n_golden",))
def _grid_and_golden(counts, log_p_grid, t_grid, eval_logp_coeffs, n_golden: int):
    """counts [P,A,A]; log_p_grid [T,A,A]; t_grid [T].

    eval_logp_coeffs: tuple (evec_r, eval_r, evinv_r, weights) for
    real-spectrum on-the-fly P(t) evaluation during refinement.
    """
    nll_grid = -jnp.einsum("pab,tab->pt", counts, log_p_grid)  # [P, T]
    best = jnp.argmin(nll_grid, axis=1)  # [P]
    t_lo = t_grid[jnp.maximum(best - 1, 0)]
    t_hi = t_grid[jnp.minimum(best + 1, len(t_grid) - 1)]

    evec, evals, evinv, weights = eval_logp_coeffs

    def nll_at(t):  # t: [P]
        # P(t)[p] = sum_c w_c * V_c exp(L_c t_p) V_c^-1
        e = jnp.exp(evals[None, :, :] * t[:, None, None])  # [P, C, A]
        p = jnp.einsum("c,cik,pck,ckj->pij", weights, evec, e, evinv)
        p = jnp.clip(p, 1e-300, 1.0)
        return -jnp.einsum("pab,pab->p", counts, jnp.log(p))

    gr = 0.6180339887498949

    def body(carry, _):
        a_, b_ = carry
        x1 = b_ - gr * (b_ - a_)
        x2 = a_ + gr * (b_ - a_)
        f1 = nll_at(x1)
        f2 = nll_at(x2)
        a_next = jnp.where(f1 < f2, a_, x1)
        b_next = jnp.where(f1 < f2, x2, b_)
        return (a_next, b_next), None

    (a_, b_), _ = jax.lax.scan(body, (t_lo, t_hi), None, length=n_golden)
    return (a_ + b_) / 2, nll_grid


def batched_ml_distances(model, gapped_seqs, max_iterations: int = 100, n_grid: int = 96, n_golden: int = 40, dtype=np.float64) -> np.ndarray:
    """All-pairs distance matrix via the device grid+golden solver."""
    from historian_tpu.models.eigen import EigenModel

    n = len(gapped_seqs)
    rows = [s.seq for s in gapped_seqs]
    counts = pair_count_matrices(model.alphabet, rows, dtype=dtype)
    if max_iterations <= 0:
        # JC shortcut only
        dist = np.zeros((n, n))
        p = 0
        for i in range(n - 1):
            for j in range(i + 1, n):
                dist[i, j] = dist[j, i] = min(
                    T_MAX, max(T_MIN, model.jukes_cantor_distance(counts[p]))
                )
                p += 1
        return dist

    eigen = EigenModel(model)
    if not np.all(eigen.is_real):
        # complex spectrum: fall back to host per-pair solves
        dist = np.zeros((n, n))
        p = 0
        for i in range(n - 1):
            for j in range(i + 1, n):
                dist[i, j] = dist[j, i] = model.ml_distance_from_counts(counts[p], max_iterations)
                p += 1
        return dist

    evec = eigen.evec.real.astype(dtype)
    evals = eigen.eval.real.astype(dtype)
    evinv = eigen.evec_inv.real.astype(dtype)
    weights = model.cpt_weight.astype(dtype)

    t_grid = np.concatenate([[T_MIN], np.geomspace(1e-4, T_MAX, n_grid - 1)]).astype(dtype)
    p_grid = np.stack([model.sub_prob_matrix(t) for t in t_grid])  # [T, C, A, A]
    p_mix = np.einsum("c,tcab->tab", weights, p_grid)
    log_p_grid = np.log(np.clip(p_mix, 1e-300, 1.0)).astype(dtype)

    t_opt, _ = _grid_and_golden(
        jnp.asarray(counts),
        jnp.asarray(log_p_grid),
        jnp.asarray(t_grid),
        (jnp.asarray(evec), jnp.asarray(evals), jnp.asarray(evinv), jnp.asarray(weights)),
        n_golden,
    )
    t_opt = np.asarray(t_opt)
    # identical sequences: distance ~ T_MIN, not grid artifacts
    dist = np.zeros((n, n))
    p = 0
    for i in range(n - 1):
        for j in range(i + 1, n):
            dist[i, j] = dist[j, i] = float(t_opt[p])
            p += 1
    return dist
