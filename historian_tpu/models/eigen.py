"""Eigendecomposition machinery for rate matrices.

Counterpart of the reference's EigenModel
(/root/reference/src/model.h:81-119, model.cpp:1135-1377): complex
eigendecomposition of each mixture component's rate matrix, the
closed-form eigenbasis substitution-count integral

    J_kl(T) = int_0^T e^{lam_k t} e^{lam_l (T-t)} dt
            = (e^{lam_k T} - e^{lam_l T}) / (lam_k - lam_l)

and the rotations between eigenbasis counts and rate-matrix-basis counts.
Everything is dense [C, A, A] complex128 numpy, vectorized with einsum --
no per-(i,j,k,l) scalar loops.
"""

from __future__ import annotations

import numpy as np

from historian_tpu.models.ratemodel import RateModel

EIGEN_EPSILON = 1e-6


def get_eigen_model(model: RateModel) -> "EigenModel":
    """The model's EigenModel, cached on the model object and keyed by
    the rate-matrix content (EM's M-step mutates models in place, which
    must invalidate): MCMC constructs a sum-product engine per proposed
    tree, and re-running the eigendecomposition each time is pure waste."""
    own = model.__dict__.get("_eigen")
    if own is not None:
        return own  # CachingRateModel is an immutable snapshot with its own EigenModel
    key = model.sub_rate.tobytes()
    cached = model.__dict__.get("_eigen_model_cache")
    if cached is not None and cached[0] == key:
        return cached[1]
    eigen = EigenModel(model)
    model.__dict__["_eigen_model_cache"] = (key, eigen)
    return eigen


class EigenModel:
    def __init__(self, model: RateModel):
        self.model = model
        c = model.components
        a = model.alphabet_size
        self.eval = np.zeros((c, a), dtype=np.complex128)
        self.evec = np.zeros((c, a, a), dtype=np.complex128)  # right eigenvectors (columns)
        self.evec_inv = np.zeros((c, a, a), dtype=np.complex128)
        self.is_real = np.zeros(c, dtype=bool)
        for cpt in range(c):
            w, v = np.linalg.eig(model.sub_rate[cpt])
            self.eval[cpt] = w
            self.evec[cpt] = v
            self.evec_inv[cpt] = np.linalg.inv(v)
            self.is_real[cpt] = (
                np.all(np.abs(w.imag) < EIGEN_EPSILON)
                and np.all(np.abs(v.imag) < EIGEN_EPSILON)
                and np.all(np.abs(self.evec_inv[cpt].imag) < EIGEN_EPSILON)
            )

    @property
    def components(self) -> int:
        return self.model.components

    def sub_prob_matrix(self, t: float) -> np.ndarray:
        """[C, A, A] real substitution matrix V exp(L t) V^-1, clipped to [0,1]."""
        exp_ev_t = np.exp(self.eval * t)  # [C, A]
        p = np.einsum("cik,ck,ckj->cij", self.evec, exp_ev_t, self.evec_inv)
        if np.any(np.abs(p.imag) >= EIGEN_EPSILON):
            raise FloatingPointError("substitution probability has imaginary part")
        return np.clip(p.real, 0.0, 1.0)

    def eigen_sub_count(self, t: float) -> np.ndarray:
        """[C, A, A] complex J_kl(t) integrals (model.cpp:1329-1350),
        memoized per branch length (trees share lengths across MCMC/EM
        engine rebuilds; flushed when oversized like CachingRateModel)."""
        cache = self.__dict__.setdefault("_sub_count_cache", {})
        hit = cache.get(t)
        if hit is not None:
            return hit
        out = self._eigen_sub_count(t)
        if len(cache) >= 4096:
            cache.clear()
        cache[t] = out
        return out

    def _eigen_sub_count(self, t: float) -> np.ndarray:
        c, a = self.eval.shape
        exp_ev_t = np.exp(self.eval * t)  # [C, A]
        lam_k = self.eval[:, :, None]
        lam_l = self.eval[:, None, :]
        num = exp_ev_t[:, :, None] - exp_ev_t[:, None, :]
        den = lam_k - lam_l
        # nearly-equal eigenvalues (incl. diagonal): limit = t * e^{lam_k t}
        near = (np.abs(den.real) <= EIGEN_EPSILON * np.maximum(np.abs(lam_k.real), np.abs(lam_l.real)) + EIGEN_EPSILON**2) & (
            np.abs(den.imag) <= EIGEN_EPSILON * np.maximum(np.abs(lam_k.imag), np.abs(lam_l.imag)) + EIGEN_EPSILON**2
        )
        eye = np.broadcast_to(np.eye(a, dtype=bool), (c, a, a))
        near = near | eye
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(near, 0, num) / np.where(near, 1, den)
        limit = np.broadcast_to((exp_ev_t * t)[:, :, None], (c, a, a))
        return np.where(near, limit, ratio)

    def sub_counts_from_eigen_counts(self, eigen_counts: np.ndarray) -> np.ndarray:
        """Rotate eigenbasis counts back to rate-matrix basis
        (model.cpp:1352-1377):

          counts[i][j] = Re( sum_kl evecInv[k,i] eigenCounts[k,l] evec[j,l] )
                         * (i==j ? 1 : subRate[i,j])
        """
        c = self.components
        out = np.einsum("cki,ckl,cjl->cij", self.evec_inv, eigen_counts, self.evec).real
        mult = self.model.sub_rate.copy()
        for cpt in range(c):
            np.fill_diagonal(mult[cpt], 1.0)
        return out * mult

    def sub_count_matrix(self, cpt: int, a_tok: int, b_tok: int, sub: np.ndarray, e_sub_count: np.ndarray) -> np.ndarray:
        """[A, A] expected substitution counts i->j on a branch with observed
        endpoints a_tok -> b_tok (model.cpp:1298-1321), vectorized over (i,j).

        count(i,j | a,b,T) = mult_ij * Re( sum_kl evec[a,k] evecInv[k,i]
                             J_kl evec[j,l] evecInv[l,b] ) / P_ab
        where mult_ij = subRate[i,j] off-diagonal, 1 on the diagonal.
        """
        p_ab = sub[a_tok, b_tok]
        left = self.evec[cpt, a_tok, :][:, None] * self.evec_inv[cpt]  # [k, i]
        # c_ij = sum_k left[k,i] * sum_l J[k,l] * evec[j,l] * evecInv[l,b]
        jl = e_sub_count * self.evec_inv[cpt][:, b_tok][None, :]  # [k, l]
        c_ij = np.einsum("ki,jl,kl->ij", left, self.evec[cpt], jl)
        mult = self.model.sub_rate[cpt].copy()
        np.fill_diagonal(mult, 1.0)
        return np.maximum(0.0, mult * c_ij.real / p_ab)
