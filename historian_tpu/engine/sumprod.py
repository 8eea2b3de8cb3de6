"""Tree sum-product engine: likelihoods, posteriors, eigencounts.

Host-facing wrapper over the column-batched Felsenstein kernels
(historian_tpu.ops.felsenstein).  Replaces the reference's
SumProduct/AlignColSumProduct column-at-a-time loop
(/root/reference/src/sumprod.h:32-102) with whole-alignment batched device
fills; posterior extraction and eigencount accumulation are vectorized
einsums over [columns, nodes, components, alphabet] tensors.
"""

from __future__ import annotations

import os

import numpy as np
import jax.numpy as jnp

import historian_tpu.ops  # noqa: F401  (enables x64)
from historian_tpu.core.tree import Tree
from historian_tpu.models.counts import EigenCounts
from historian_tpu.models.eigen import EigenModel, get_eigen_model
from historian_tpu.models.ratemodel import RateModel
from historian_tpu.ops.felsenstein import (
    GAP_TOK,
    TreeArrays,
    _fill_down_batch,
    _fill_up_batch_tokens,
    _node_post_prob_batch,
    tokenize_alignment,
)

MIN_POST_PROB = 0.01

# small LRU of engines keyed by (model content, tree topology+lengths):
# MCMC alignment moves and likelihood evaluations reuse the same
# (model, tree) pair many times, and engine construction does per-branch
# expm + eigencount integrals
_ENGINE_CACHE: dict = {}
_ENGINE_CACHE_MAX = 32


def _model_fingerprint(model) -> tuple:
    """Content key for the engine cache.  Keying on id(model) is unsafe
    (a freed model's address can be reused by a new model with different
    parameters); the fingerprint covers every parameter the engine
    reads, recomputed per call because RateModels are mutable (EM's
    M-step updates them in place).  The type name is included because
    CachingRateModel computes sub_prob_matrix through the
    eigendecomposition rather than scaling-and-squaring expm, which can
    differ in the last bits."""
    return (
        type(model).__name__,
        model.alphabet.symbols,
        model.ins_rate,
        model.del_rate,
        model.ins_ext_prob,
        model.del_ext_prob,
        model.sub_rate.tobytes(),
        model.ins_prob.tobytes(),
        model.cpt_weight.tobytes(),
    )


def get_engine(model, tree) -> "SumProductEngine":
    key = (_model_fingerprint(model), tree.to_string())
    engine = _ENGINE_CACHE.pop(key, None)
    if engine is None:
        engine = SumProductEngine(model, tree)
        if len(_ENGINE_CACHE) >= _ENGINE_CACHE_MAX:
            _ENGINE_CACHE.pop(next(iter(_ENGINE_CACHE)))
    _ENGINE_CACHE[key] = engine  # re-insert as most recent
    return engine


class SumProductEngine:
    """Per-(model, tree) state: branch substitution matrices, eigencount
    integrals, and the device fill entry points."""

    def __init__(self, model: RateModel, tree: Tree, dtype=np.float64):
        self.model = model
        self.tree = tree
        self.dtype = dtype
        self.arrays = TreeArrays(tree)
        n = self.arrays.n_nodes
        c, a = model.components, model.alphabet_size
        sub = np.zeros((n, c, a, a))
        for node in range(n - 1):
            sub[node] = model.sub_prob_matrix(tree.branch_length(node))
        sub[n - 1] = np.eye(a)[None, :, :]  # root has no branch
        self.branch_sub = sub
        self.eigen = get_eigen_model(model)
        with np.errstate(divide="ignore"):
            self.log_cpt_weight = np.log(model.cpt_weight)
        self.ins_prob = model.ins_prob
        self._count_device_ok: bool | None = None
        self._col_ll_cache: dict[bytes, float] = {}
        self._branch_eigen_sub_count: np.ndarray | None = None

    @property
    def branch_eigen_sub_count(self) -> np.ndarray:
        """[N, C, A, A] complex J integrals per branch, computed lazily:
        only count extraction reads them, and MCMC/refiner likelihood
        loops construct engines for thousands of proposed trees that
        never touch counts."""
        if self._branch_eigen_sub_count is None:
            tree = self.tree
            n = self.arrays.n_nodes
            c, a = self.model.components, self.model.alphabet_size
            self._branch_eigen_sub_count = np.stack(
                [self.eigen.eigen_sub_count(tree.branch_length(node)) for node in range(n - 1)]
                + [np.zeros((c, a, a), dtype=np.complex128)]
            )
        return self._branch_eigen_sub_count

    @property
    def count_device_ok(self) -> bool:
        """True when the eigensystem is EXACTLY real (zero imaginary
        parts, not merely below epsilon), so the device float64 count
        path loses no information."""
        if self._count_device_ok is None:
            e = self.eigen
            self._count_device_ok = bool(
                np.all(e.is_real)
                and not np.any(e.evec.imag)
                and not np.any(e.evec_inv.imag)
                and not np.any(self.branch_eigen_sub_count.imag)
            )
        return self._count_device_ok

    # ------------------------------------------------------------------ fills
    def fill(self, gapped_rows: list[str]) -> "SumProductFill":
        """Run up+down passes for all columns at once."""
        tokens = tokenize_alignment(self.model.alphabet, gapped_rows)
        return self.fill_tokens(tokens)

    # native host fill for small batches (an MCMC proposal refills a few
    # hundred columns, where the device scan's per-step dispatch overhead
    # is ~95% of the wall time); large count batches stay on the device
    _NATIVE_FILL_MAX_CELLS = 1 << 17  # L x N

    def _native_fill(self, tokens: np.ndarray) -> "SumProductFill | None":
        import os

        if os.environ.get("HISTORIAN_DEVICE_SUMPROD", "0") == "1":
            return None
        arr = self.arrays
        n = arr.n_nodes
        L = tokens.shape[1]
        if L * n > self._NATIVE_FILL_MAX_CELLS:
            return None
        from historian_tpu.native import get_native

        lib = get_native()
        if lib is None:
            return None
        c, a = self.model.components, self.model.alphabet_size
        F = np.empty((L, n, c, a))
        logF = np.empty((L, n, c))
        E = np.empty((L, n, c, a))
        logE = np.empty((L, n, c))
        G = np.empty((L, n, c, a))
        logG = np.empty((L, n, c))
        cpt_ll = np.empty((L, c))
        col_ll = np.empty(L)
        lib.sumprod_fill(
            L, n, c, a,
            np.ascontiguousarray(tokens, dtype=np.int32),
            arr.parent.astype(np.int64), arr.left.astype(np.int64),
            arr.right.astype(np.int64), arr.sibling.astype(np.int64),
            np.ascontiguousarray(self.branch_sub),
            np.ascontiguousarray(self.ins_prob),
            np.ascontiguousarray(self.log_cpt_weight),
            np.uint8(1),
            F, logF, E, logE, G, logG, cpt_ll, col_ll,
        )
        fill = SumProductFill(self, tokens, F, logF, E, logE, cpt_ll, col_ll, None)
        fill._device["G"] = G
        fill._device["logG"] = logG
        return fill

    def fill_tokens(self, tokens: np.ndarray) -> "SumProductFill":
        native = self._native_fill(tokens)
        if native is not None:
            return native
        arr = self.arrays
        n = arr.n_nodes
        a = self.model.alphabet_size
        # bucket the column count with all-gap columns (independent under
        # vmap; results sliced off) so realignments during MCMC/refinement
        # and varying count batches reuse jit compilations.  Buckets are
        # 64-multiples up to 1024, then geometric (~1/16 granularity) so
        # big batches stay within a few dozen compiled shapes
        L = tokens.shape[1]
        if L <= 1:
            pad = 0
        elif L <= 1024:
            pad = (-L) % 64
        else:
            unit = 1 << (L.bit_length() - 4)
            pad = (-L) % unit
        if pad:
            tokens_p = np.concatenate(
                [tokens, np.full((tokens.shape[0], pad), GAP_TOK, tokens.dtype)], axis=1
            )
        else:
            tokens_p = tokens
        sub = jnp.asarray(self.branch_sub, dtype=self.dtype)
        ins = jnp.asarray(self.ins_prob, dtype=self.dtype)
        lw = jnp.asarray(self.log_cpt_weight, dtype=self.dtype)
        (F, logF, E, logE, cpt_ll, col_ll), is_gap = _fill_up_batch_tokens(
            jnp.asarray(tokens_p), jnp.asarray(arr.parent), jnp.asarray(arr.left),
            jnp.asarray(arr.right), sub, ins, lw, n, a,
        )
        # The padded device tensors are NOT sliced back to L here: an eager
        # device slice compiles a fresh XLA program per (padded, true)
        # length pair, and MCMC sees a new alignment length every few
        # steps. Consumers slice on host after materialization instead
        # (padding columns are all-gap, hence inert for the count paths).

        def fill_down():
            # the root->tip pass, deferred: likelihood-only consumers
            # (every MCMC/refiner proposal) never need G
            return _fill_down_batch(
                E, logE, is_gap, jnp.asarray(arr.parent),
                jnp.asarray(arr.sibling), sub, ins, n,
            )

        return SumProductFill(self, tokens, F, logF, E, logE, cpt_ll, col_ll, fill_down)

    _LAST_FILL: "tuple | None" = None  # (engine, tokens bytes, fill) singleton

    def fill_cached(self, gapped_rows: list[str]) -> "SumProductFill":
        """One-entry fill memo: MCMC proposes many moves against the same
        history before one is accepted, and each proposal needs the same
        full-alignment messages (conditional PWMs). Reusing the fill also
        reuses its host materializations. A single global entry bounds
        the footprint ([L, N, C, A] tensors are multi-MB)."""
        tokens = tokenize_alignment(self.model.alphabet, gapped_rows)
        key = tokens.tobytes()
        ent = SumProductEngine._LAST_FILL
        if ent is not None and ent[0] is self and ent[1] == key:
            return ent[2]
        fill = self.fill_tokens(tokens)
        SumProductEngine._LAST_FILL = (self, key, fill)
        return fill

    def fill_column(self, col: dict[int, str]) -> "SumProductFill":
        """Single-column fill from a {node: char} map (absent nodes are
        gaps) -- the per-cell entry point used by the Forward DP's count
        machinery (reference SumProduct::initColumn, sumprod.cpp:58-87)."""
        n = self.arrays.n_nodes
        tokens = np.full((n, 1), GAP_TOK, dtype=np.int32)
        for node, ch in col.items():
            if ch == "-" or ch == ".":
                continue
            tok = self.model.alphabet.tokenize_char(ch)
            tokens[node, 0] = tok if tok >= 0 else -2
        return self.fill_tokens(tokens)

    def column_log_likelihoods(self, gapped_rows: list[str]) -> np.ndarray:
        return np.asarray(self.fill(gapped_rows).col_ll)

    _COL_LL_CACHE_MAX = 100_000  # entries (~N bytes each); cleared when exceeded

    def column_log_likelihoods_cached(self, gapped_rows: list[str]) -> np.ndarray:
        """Per-column log-likelihoods memoized by column token content.

        Engines are cached per (model, tree) -- see get_engine -- so the
        memo is automatically scoped to one tree: MCMC and refiner moves
        that keep the tree fixed change only a handful of columns per
        step, and everything else hits the cache. Misses run through one
        batched fill; a first call with an empty cache is therefore the
        exact same computation (same column batch, same bucketed shape)
        as the uncached path."""
        tokens = tokenize_alignment(self.model.alphabet, gapped_rows)  # [N, L]
        cache = self._col_ll_cache
        if len(cache) > self._COL_LL_CACHE_MAX:
            cache.clear()
        cols = np.ascontiguousarray(tokens.T)  # [L, N]
        keys = [c.tobytes() for c in cols]
        miss: dict[bytes, int] = {}
        for idx, k in enumerate(keys):
            if k not in cache and k not in miss:
                miss[k] = idx
        if miss:
            sel = np.fromiter(miss.values(), dtype=np.int64, count=len(miss))
            if len(sel) == 1:
                # never issue an L=1 fill: it takes fill_tokens' unpadded
                # special path, whose values differ in the last ~9 digits
                # from every padded bucket (which are mutually bit-identical)
                sel = np.repeat(sel, 2)
            fill = self.fill_tokens(np.ascontiguousarray(tokens[:, sel]))
            ll = np.asarray(fill.col_ll)
            for k, l in zip(miss, ll):
                cache[k] = float(l)
        return np.fromiter((cache[k] for k in keys), dtype=np.float64, count=len(keys))

    def log_likelihood_cached(self, gapped_rows: list[str]) -> float:
        return float(self.column_log_likelihoods_cached(gapped_rows).sum())

    def log_likelihood(self, gapped_rows: list[str]) -> float:
        return float(self.column_log_likelihoods(gapped_rows).sum())


class _LazyDownDict(dict):
    """Device-tensor map whose "G"/"logG" entries are computed on first
    access: the root->tip (down) pass only matters for posterior and
    count extraction, so likelihood-only fills never pay for it."""

    def __init__(self, fill_down, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._fill_down = fill_down

    def __missing__(self, key):
        if key not in ("G", "logG") or self._fill_down is None:
            raise KeyError(key)
        self["G"], self["logG"] = self._fill_down()
        self._fill_down = None
        return self[key]


class SumProductFill:
    """All messages for all columns; posterior / count extraction.

    The message tensors are materialized to numpy lazily: likelihood-only
    consumers (every MCMC proposal) read just col_ll, so the multi-MB
    F/E/G readbacks -- and the entire down pass -- happen only when
    posterior or count extraction actually touches them."""

    _LAZY = ("F", "logF", "E", "logE", "G", "logG", "cpt_ll", "col_ll")

    def __init__(self, engine, tokens, F, logF, E, logE, cpt_ll, col_ll, fill_down):
        self.engine = engine
        self.tokens = tokens  # [N, L]
        self._device = _LazyDownDict(fill_down, {
            "F": F, "logF": logF, "E": E, "logE": logE,
            "cpt_ll": cpt_ll, "col_ll": col_ll,
        })  # F: [L, N, C, A]; logF: [L, N, C]; cpt_ll: [L, C]; col_ll: [L]

    def __getattr__(self, name):
        dev = self.__dict__.get("_device")
        if dev is not None and name in self._LAZY:
            # "G"/"logG" may trigger the down pass; the host slice drops
            # the fill's bucket-padding columns (device tensors stay
            # padded -- eager device slices compile per length pair)
            arr = np.asarray(dev[name])[: self.n_columns]
            setattr(self, name, arr)
            return arr
        raise AttributeError(name)

    @property
    def n_columns(self) -> int:
        return self.tokens.shape[1]

    def rows_at(self, name: str, cols: np.ndarray, node: int) -> np.ndarray:
        """tensor[cols, node] gathered on device and read back small.

        Conditional-PWM extraction needs a few (column, node) slices of
        the multi-MB message tensors; gathering on device avoids the
        full-tensor host readback. Column indices are bucket-padded to
        64-multiples so the eager gather reuses compilations. Falls back
        to an already-materialized host tensor when present."""
        host = self.__dict__.get(name)
        if host is not None:
            return host[cols, node]
        t = self._device[name]
        if isinstance(t, np.ndarray):
            # native-fill tensors are host numpy: index with numpy.  A
            # jnp index here would silently commit the tiny cols array
            # to the DEFAULT device -- one device round trip per read,
            # on a path MCMC runs for every proposal.
            return t[cols, node]
        pad = (-len(cols)) % 64
        cols_p = np.concatenate([cols, np.zeros(pad, dtype=np.int64)]) if pad else cols
        out = np.asarray(t[jnp.asarray(cols_p), int(node)])
        return out[: len(cols)]

    def is_gap(self, node: int, col: int) -> bool:
        return self.tokens[node, col] == GAP_TOK

    def column_roots(self, col: int) -> list[int]:
        arr = self.engine.arrays
        roots = []
        for n in range(arr.n_nodes):
            if self.tokens[n, col] != GAP_TOK:
                p = arr.parent[n]
                if p < 0 or self.tokens[p, col] == GAP_TOK:
                    roots.append(n)
        return roots

    def column_root(self, col: int) -> int:
        roots = self.column_roots(col)
        if len(roots) != 1:
            raise ValueError(f"column {col} has {len(roots)} roots (expected 1)")
        return roots[0]

    # -------------------------------------------------------------- posteriors
    def log_node_post_prob(self, col: int, node: int) -> np.ndarray:
        """[A] log posterior at node, mixture-marginalized."""
        out = self.log_node_post_prob_all()
        return out[col, node]

    def log_node_post_prob_all(self) -> np.ndarray:
        """[L, N, A] log posteriors for every column and node."""
        if not hasattr(self, "_lnpp"):
            self._lnpp = np.asarray(
                _node_post_prob_batch(
                    jnp.asarray(self.F), jnp.asarray(self.logF), jnp.asarray(self.G),
                    jnp.asarray(self.logG), jnp.asarray(self.col_ll),
                    jnp.asarray(self.engine.log_cpt_weight, dtype=self.F.dtype),
                    self.engine.arrays.n_nodes,
                )
            )
        return self._lnpp

    def max_post_state(self, col: int, node: int) -> int:
        return int(np.argmax(self.log_node_post_prob_all()[col, node]))

    def log_branch_post_prob(self, cpt: int, col: int, node: int, a: int, b: int) -> float:
        """log P(parent=a, node=b | column) (sumprod.cpp:252-257)."""
        arr = self.engine.arrays
        p = arr.parent[node]
        s = arr.sibling[node]
        with np.errstate(divide="ignore"):
            return float(
                self.engine.log_cpt_weight[cpt]
                + self.logG[col, p, cpt]
                + np.log(self.G[col, p, cpt, a])
                + np.log(self.engine.branch_sub[node, cpt, a, b])
                + self.logF[col, node, cpt]
                + np.log(self.F[col, node, cpt, b])
                + self.logE[col, s, cpt]
                + np.log(self.E[col, s, cpt, a])
                - self.col_ll[col]
            )

    def log_node_excluded_post_prob(self, col: int, node: int, exclude: int, normalize: bool = True) -> np.ndarray:
        """[C, A] conditional log-posterior at node excluding one neighbor's
        message -- the MCMC conditional-PWM workhorse (sumprod.cpp:219-250)."""
        arr = self.engine.arrays
        c_, a_ = self.engine.model.components, self.engine.model.alphabet_size
        tok = self.tokens[node, col]
        if tok == GAP_TOK:
            raise ValueError("posterior requested at gapped position")
        if tok >= 0:
            init = np.full(a_, -np.inf)
            init[tok] = 0.0
        else:
            init = np.zeros(a_)
        lpp = np.tile(init, (c_, 1))
        lpp += self.engine.log_cpt_weight[:, None]
        with np.errstate(divide="ignore"):
            for child in (arr.left[node], arr.right[node]):
                if child >= 0 and child != exclude:
                    lpp += np.log(self.E[col, child]) + self.logE[col, child][:, None]
            p = arr.parent[node]
            if p != exclude and p >= 0:
                lpp += np.log(self.G[col, node]) + self.logG[col, node][:, None]
        if normalize:
            from scipy.special import logsumexp

            lpp -= logsumexp(lpp)
        return lpp

    # ------------------------------------------------- ancestral reconstruction
    def ancestral_gapped_rows(self, gapped_rows: list[str]) -> list[str]:
        """Replace wildcard chars with MAP states (sumprod.cpp:401-413)."""
        lnpp = self.log_node_post_prob_all()  # [L, N, A]
        alphabet = self.engine.model.alphabet
        out = []
        map_states = np.argmax(lnpp, axis=2)  # [L, N]
        for n, row in enumerate(gapped_rows):
            chars = list(row)
            for col, ch in enumerate(chars):
                if ch == "*":
                    chars[col] = alphabet.symbol(map_states[col, n])
            out.append("".join(chars))
        return out

    def ancestral_post_probs(self, gapped_rows: list[str], min_prob: float = MIN_POST_PROB, max_prob: float = 1.0):
        """{row: {col: {char: prob}}} for wildcard positions (sumprod.cpp:415-426)."""
        lnpp = self.log_node_post_prob_all()
        alphabet = self.engine.model.alphabet
        lp_min, lp_max = np.log(min_prob), np.log(max_prob)
        out: dict[int, dict[int, dict[str, float]]] = {}
        for n, row in enumerate(gapped_rows):
            for col, ch in enumerate(row):
                if ch == "*":
                    lp = lnpp[col, n]
                    sel = (lp >= lp_min) & (lp <= lp_max)
                    if np.any(sel):
                        out.setdefault(n, {})[col] = {
                            alphabet.symbol(i): float(np.exp(lp[i])) for i in np.nonzero(sel)[0]
                        }
        return out

    # ----------------------------------------------------------------- counts
    def column_root_array(self) -> np.ndarray:
        """[L] per-column root node (-1 if empty; asserts single root)."""
        arr = self.engine.arrays
        gap = self.tokens.T == GAP_TOK  # [L, N]
        parent_safe = np.maximum(arr.parent, 0)
        parent_gap = np.where(arr.parent[None, :] >= 0, gap[:, parent_safe], True)
        is_root = (~gap) & parent_gap  # [L, N]
        n_roots = is_root.sum(axis=1)
        if np.any(n_roots > 1):
            bad = int(np.argmax(n_roots > 1))
            raise ValueError(f"column {bad} has {n_roots[bad]} roots (expected 1)")
        roots = np.where(n_roots == 1, np.argmax(is_root, axis=1), -1)
        return roots.astype(np.int64)

    def accumulate_root_counts(self, root_counts: np.ndarray, weight=1.0) -> None:
        """root_counts[c,i] += w_l * insProb*F(root_l) * exp(logw+logF-colLL),
        vectorized over columns (sumprod.cpp:264-271); weight may be a
        scalar or a per-column [L] array."""
        eng = self.engine
        roots = self.column_root_array()
        sel = roots >= 0
        if not np.any(sel):
            return
        w = np.broadcast_to(np.asarray(weight, dtype=float), (self.n_columns,))[sel]
        r = roots[sel]
        cols = np.nonzero(sel)[0]
        norm = np.exp(
            eng.log_cpt_weight[None, :] + self.logF[cols, r] - self.col_ll[cols, None]
        )  # [l, C]
        root_counts += np.einsum(
            "l,ci,lci,lc->ci", w, eng.ins_prob, self.F[cols, r], norm
        )

    def accumulate_eigen_counts(self, root_counts: np.ndarray, eigen_counts: np.ndarray, weight=1.0) -> None:
        """Vectorized eigencount accumulation over all columns and branches
        (sumprod.cpp:294-372): for each ungapped non-root node n,

          eigenCounts[c,k,l] += w * scale * (D0 . evec)_k J[n,c,k,l] (U0 . evecInv^T)_l

        with U0 = F[col,n], D0 = G[col,parent]*E[col,sibling] and
        scale = exp(logw_c + logF + logG + logE - colLogLike).

        Large batches on exactly-real eigensystems run fused on the
        device (no [L, N, C, A] host readbacks or temporaries); small
        batches keep the numpy formulation, which pins byte-exact golden
        outputs.
        """
        if self.n_columns >= 512:
            if self.engine.count_device_ok:
                self._accumulate_eigen_counts_device(root_counts, eigen_counts, weight)
            else:
                self._accumulate_eigen_counts_device_cplx(root_counts, eigen_counts, weight)
            return
        self.accumulate_root_counts(root_counts, weight)
        eng = self.engine
        arr = eng.arrays
        n_nodes = arr.n_nodes
        L = self.n_columns

        # mask[L, N]: ungapped, has ungapped parent (i.e. not a column root)
        gap = self.tokens.T == GAP_TOK  # [L, N]
        parent = arr.parent.copy()
        parent_safe = np.maximum(parent, 0)
        sib_safe = np.maximum(arr.sibling, 0)
        has_parent = parent >= 0
        mask = (~gap) & has_parent[None, :] & ~gap[:, parent_safe]
        if not np.any(mask):
            return

        U0 = self.F  # [L, N, C, A]
        D0 = self.G[:, parent_safe] * self.E[:, sib_safe]  # [L, N, C, A]
        log_scale = (
            eng.log_cpt_weight[None, None, :]
            + self.logF
            + self.logG[:, parent_safe]
            + self.logE[:, sib_safe]
            - self.col_ll[:, None, None]
        )  # [L, N, C]
        w_col = np.broadcast_to(np.asarray(weight, dtype=float), (L,))
        w = np.where(mask[:, :, None], np.exp(log_scale), 0.0) * w_col[:, None, None]

        evec = eng.eigen.evec  # [C, A, A]
        evec_inv = eng.eigen.evec_inv
        # Dbasis[L,N,C,k] = sum_a D0[...,a] evec[c,a,k]
        db = np.einsum("lnca,cak->lnck", D0, evec)
        # Ubasis[L,N,C,m] = sum_b U0[...,b] evecInv[c,m,b]
        ub = np.einsum("lncb,cmb->lncm", U0, evec_inv)
        j = self.engine.branch_eigen_sub_count  # [N, C, A, A]
        # einsum path search costs ~10s of ms -- worth it only for real
        # column batches, pure overhead for the single-column fills
        eigen_counts += np.einsum(
            "lnc,lnck,lncm,nckm->ckm", w, db, ub, j, optimize=(L >= 8)
        )

    def _accumulate_eigen_counts_device(self, root_counts: np.ndarray, eigen_counts: np.ndarray, weight) -> None:
        """Device-fused accumulate for exactly-real eigensystems: the
        whole contraction runs jitted on the padded column batch, so the
        [L, N, C, A] messages never materialize on host."""
        from historian_tpu.ops.felsenstein import (
            _eigen_counts_batch,
            _root_counts_batch,
        )

        eng = self.engine
        arr = eng.arrays
        L = self.n_columns
        P = int(self._device["F"].shape[0])  # fill bucket padding (all-gap)
        pad = P + ((-P) % 1024) - L
        dev = self._device

        def pad_l(a):
            extra = pad - (P - L)
            if not extra:
                return a
            return jnp.pad(a, ((0, extra),) + ((0, 0),) * (a.ndim - 1))

        gap = self.tokens.T == GAP_TOK  # [L, N]
        parent = arr.parent
        parent_safe = np.maximum(parent, 0)
        sib_safe = np.maximum(arr.sibling, 0)
        mask = (~gap) & (parent >= 0)[None, :] & ~gap[:, parent_safe]
        mask_p = np.concatenate([mask, np.zeros((pad,) + mask.shape[1:], bool)]) if pad else mask
        w_col = np.broadcast_to(np.asarray(weight, dtype=float), (L,))
        w_col_p = np.concatenate([w_col, np.zeros(pad)]) if pad else w_col

        eigen_counts += np.asarray(
            _eigen_counts_batch(
                pad_l(dev["F"]), pad_l(dev["logF"]), pad_l(dev["E"]),
                pad_l(dev["logE"]), pad_l(dev["G"]), pad_l(dev["logG"]),
                pad_l(dev["col_ll"]),
                jnp.asarray(parent_safe), jnp.asarray(sib_safe),
                jnp.asarray(mask_p), jnp.asarray(w_col_p),
                jnp.asarray(eng.log_cpt_weight),
                jnp.asarray(np.ascontiguousarray(eng.eigen.evec.real)),
                jnp.asarray(np.ascontiguousarray(eng.eigen.evec_inv.real)),
                jnp.asarray(np.ascontiguousarray(eng.branch_eigen_sub_count.real)),
            )
        )

        self._accumulate_root_counts_device(root_counts, w_col)

    def _accumulate_root_counts_device(self, root_counts: np.ndarray, w_col: np.ndarray) -> None:
        """Device-fused root-count accumulation over the root-bearing columns."""
        from historian_tpu.ops.felsenstein import _root_counts_batch

        eng = self.engine
        dev = self._device
        roots = self.column_root_array()
        sel = roots >= 0
        if not np.any(sel):
            return
        cols = np.nonzero(sel)[0]
        r = roots[sel]
        l = len(cols)
        lpad = (-l) % 1024
        F_sel = dev["F"][jnp.asarray(cols), jnp.asarray(r)]      # [l, C, A]
        logF_sel = dev["logF"][jnp.asarray(cols), jnp.asarray(r)]  # [l, C]
        col_ll_sel = dev["col_ll"][jnp.asarray(cols)]
        w_sel = w_col[sel]
        if lpad:
            F_sel = jnp.pad(F_sel, ((0, lpad), (0, 0), (0, 0)))
            logF_sel = jnp.pad(logF_sel, ((0, lpad), (0, 0)))
            col_ll_sel = jnp.pad(col_ll_sel, ((0, lpad),))
            w_sel = np.concatenate([w_sel, np.zeros(lpad)])
        root_counts += np.asarray(
            _root_counts_batch(
                F_sel, logF_sel, col_ll_sel, jnp.asarray(w_sel),
                jnp.asarray(eng.log_cpt_weight), jnp.asarray(eng.ins_prob),
            )
        )

    _CPLX_COUNT_CHUNK = 8192

    def _accumulate_eigen_counts_device_cplx(self, root_counts: np.ndarray, eigen_counts: np.ndarray, weight) -> None:
        """Device path for complex eigensystems (non-reversible models like
        the ECM codon matrices): the contraction is decomposed into real
        einsums (`_eigen_counts_batch_cplx`) and run over fixed-size column
        chunks — one compiled shape regardless of batch size, bounded
        intermediates — accumulating [C, A, A] partials on device."""
        from historian_tpu.ops.felsenstein import _eigen_counts_batch_cplx

        eng = self.engine
        arr = eng.arrays
        L = self.n_columns
        dev = self._device

        gap = self.tokens.T == GAP_TOK  # [L, N]
        parent = arr.parent
        parent_safe = np.maximum(parent, 0)
        sib_safe = np.maximum(arr.sibling, 0)
        mask = (~gap) & (parent >= 0)[None, :] & ~gap[:, parent_safe]
        w_col = np.broadcast_to(np.asarray(weight, dtype=float), (L,))

        e = eng.eigen
        p_s = jnp.asarray(parent_safe)
        s_s = jnp.asarray(sib_safe)
        lcw = jnp.asarray(eng.log_cpt_weight)
        evr = jnp.asarray(np.ascontiguousarray(e.evec.real))
        evi = jnp.asarray(np.ascontiguousarray(e.evec.imag))
        eir = jnp.asarray(np.ascontiguousarray(e.evec_inv.real))
        eii = jnp.asarray(np.ascontiguousarray(e.evec_inv.imag))
        jr = jnp.asarray(np.ascontiguousarray(eng.branch_eigen_sub_count.real))
        ji = jnp.asarray(np.ascontiguousarray(eng.branch_eigen_sub_count.imag))

        chunk = self._CPLX_COUNT_CHUNK
        P = int(dev["F"].shape[0])  # fill bucket padding (all-gap columns)
        pad = P + ((-P) % chunk) - L

        def pad_l(a):
            extra = pad - (P - L)
            if not extra:
                return a
            return jnp.pad(a, ((0, extra),) + ((0, 0),) * (a.ndim - 1))

        mask_p = np.concatenate([mask, np.zeros((pad,) + mask.shape[1:], bool)]) if pad else mask
        w_p = np.concatenate([w_col, np.zeros(pad)]) if pad else w_col
        out_r, out_i = _eigen_counts_batch_cplx(
            pad_l(dev["F"]), pad_l(dev["logF"]), pad_l(dev["E"]), pad_l(dev["logE"]),
            pad_l(dev["G"]), pad_l(dev["logG"]), pad_l(dev["col_ll"]),
            p_s, s_s, jnp.asarray(mask_p), jnp.asarray(w_p), lcw,
            evr, evi, eir, eii, jr, ji, chunk=chunk,
        )
        eigen_counts += np.asarray(out_r) + 1j * np.asarray(out_i)
        self._accumulate_root_counts_device(root_counts, w_col)

    def per_column_eigen_counts(self, chunk: int = 1024):
        """(root[L, C, A] real, eigen[L, C, A, A] complex): each column's
        unit-weight contribution -- the same per-column terms that
        accumulate_eigen_counts sums over l.  Chunked so the [l, N, C, A]
        temporaries stay bounded for large column batches."""
        eng = self.engine
        arr = eng.arrays
        L = self.n_columns
        C, A = eng.model.components, eng.model.alphabet_size
        root = np.zeros((L, C, A))
        eigen = np.zeros((L, C, A, A), dtype=np.complex128)

        roots = self.column_root_array()
        sel = roots >= 0
        if np.any(sel):
            r = roots[sel]
            cols = np.nonzero(sel)[0]
            norm = np.exp(
                eng.log_cpt_weight[None, :] + self.logF[cols, r] - self.col_ll[cols, None]
            )
            root[cols] = np.einsum("ci,lci,lc->lci", eng.ins_prob, self.F[cols, r], norm)

        gap = self.tokens.T == GAP_TOK  # [L, N]
        parent = eng.arrays.parent
        parent_safe = np.maximum(parent, 0)
        sib_safe = np.maximum(arr.sibling, 0)
        mask = (~gap) & (parent >= 0)[None, :] & ~gap[:, parent_safe]
        if np.any(mask):
            evec = eng.eigen.evec
            evec_inv = eng.eigen.evec_inv
            j = eng.branch_eigen_sub_count  # [N, C, A, A]
            for lo in range(0, L, chunk):
                hi = min(lo + chunk, L)
                U0 = self.F[lo:hi]
                D0 = self.G[lo:hi][:, parent_safe] * self.E[lo:hi][:, sib_safe]
                log_scale = (
                    eng.log_cpt_weight[None, None, :]
                    + self.logF[lo:hi]
                    + self.logG[lo:hi][:, parent_safe]
                    + self.logE[lo:hi][:, sib_safe]
                    - self.col_ll[lo:hi, None, None]
                )
                w = np.where(mask[lo:hi][:, :, None], np.exp(log_scale), 0.0)
                db = np.einsum("lnca,cak->lnck", D0, evec)
                ub = np.einsum("lncb,cmb->lncm", U0, evec_inv)
                eigen[lo:hi] = np.einsum(
                    "lnc,lnck,lncm,nckm->lckm", w, db, ub, j, optimize=True
                )
        return root, eigen

    def eigen_counts(self, weight: float = 1.0) -> EigenCounts:
        eng = self.engine
        out = EigenCounts(eng.model.components, eng.model.alphabet_size)
        self.accumulate_eigen_counts(out.root_count, out.eigen_count, weight)
        out.indel.lp = float(self.col_ll.sum()) * weight
        return out


def accumulate_alignment_eigen_counts(counts: EigenCounts, model: RateModel, tree: Tree, gapped_seqs, weight: float = 1.0) -> None:
    """Counterpart of EigenCounts::accumulateSubstitutionCounts
    (model.cpp:900-915): one batched fill, then vectorized accumulation.

    When a device mesh is active (CLI -mesh N / HISTORIAN_MESH), the
    whole E-step runs as a column-sharded shard_map with an in-jit psum
    reduction -- the in-memory form of the reference's count/sum file
    MapReduce (README.md:201-208)."""
    from historian_tpu.parallel.pcounts import active_mesh, sharded_alignment_eigen_counts

    mesh = active_mesh()
    if mesh is not None:
        counts += sharded_alignment_eigen_counts(
            model, tree, [s.seq for s in gapped_seqs], mesh, weight
        )
        return
    engine = SumProductEngine(model, tree)
    fill = engine.fill([s.seq for s in gapped_seqs])
    c = EigenCounts(model.components, model.alphabet_size)
    fill.accumulate_eigen_counts(c.root_count, c.eigen_count, 1.0)
    c.indel.lp = float(fill.col_ll.sum())
    c *= weight
    counts += c
