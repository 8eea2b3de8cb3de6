"""Column-batched Felsenstein pruning (sum-product on a tree).

Counterpart of the reference's SumProduct engine
(/root/reference/src/sumprod.cpp:99-372).  The reference processes one
alignment column at a time with per-node scalar loops; here all columns
are batched (vmap) and the tree walk is a lax.scan over the postorder
node sequence, so each scan step is a [Cols, C, A] x [A, A] batched
matrix product.

Gap handling follows the reference's sub-forest semantics
(sumprod.cpp:58-97): a gapped node passes E = ones; an ungapped node
whose parent is gapped becomes a column root, contributing
logF + log(F . insProb) to the column likelihood.

Numerical control: per-node max-rescaling with the log carried
separately (the reference rescales only below 1e-30; rescaling every
step is algebraically identical and branch-free for XLA).

Trees must be binary (the reference asserts the same before inference,
recon.cpp assertBinary).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from historian_tpu.core.tree import Tree

GAP_TOK = -1
WILD_TOK = -2


class TreeArrays:
    """Static binary-tree structure as flat arrays for device scans.

    Nodes are in postorder (root last).  For leaves, child entries are -1.
    """

    def __init__(self, tree: Tree):
        tree_n = tree.n_nodes()
        # require only a toposort (children before parents); forests with
        # multiple roots and 1-child nodes arise from MCMC detach operations
        for n in range(tree_n):
            if 0 <= tree.parent(n) <= n:
                raise ValueError("tree nodes must be toposorted (children before parents)")
        parent = np.full(tree_n, -1, dtype=np.int32)
        left = np.full(tree_n, -1, dtype=np.int32)
        right = np.full(tree_n, -1, dtype=np.int32)
        sibling = np.full(tree_n, -1, dtype=np.int32)
        branch_len = np.zeros(tree_n, dtype=np.float64)
        for n in range(tree_n):
            parent[n] = tree.parent(n)
            kids = tree.children(n)
            if len(kids) > 2:
                raise ValueError("device sum-product requires at most 2 children per node")
            if len(kids) >= 1:
                left[n] = kids[0]
            if len(kids) == 2:
                right[n] = kids[1]
                sibling[kids[0]] = kids[1]
                sibling[kids[1]] = kids[0]
            branch_len[n] = tree.branch_length(n)
        self.n_nodes = tree_n
        self.parent = parent
        self.left = left
        self.right = right
        self.sibling = sibling
        self.branch_length = branch_len
        self.is_leaf = left < 0


def tokenize_alignment(alphabet, gapped_rows: list[str]) -> np.ndarray:
    """[N, L] int32: token >= 0, GAP_TOK for gaps, WILD_TOK for wildcards
    and invalid symbols (reference initColumn semantics, sumprod.cpp:64-69)."""
    from historian_tpu.core.alphabet import GAP_CHARS

    n = len(gapped_rows)
    length = len(gapped_rows[0]) if n else 0
    if any(len(r) != length for r in gapped_rows):
        raise ValueError("alignment rows have unequal lengths")
    if n == 0 or length == 0:
        return np.full((n, length), WILD_TOK, dtype=np.int32)
    codes = np.frombuffer("".join(gapped_rows).encode("latin-1"), dtype=np.uint8)
    codes = codes.reshape(n, length)
    toks = alphabet.tokenize_bytes(codes)
    is_gap = (codes == ord("-")) | (codes == ord("."))
    return np.where(is_gap, GAP_TOK, np.where(toks >= 0, toks, WILD_TOK)).astype(np.int32)


@partial(jax.jit, static_argnames=("n_nodes", "alphabet_size"))
def _fill_up_batch_tokens(
    tokens,  # [N, L] int32 (GAP_TOK gaps, negative non-gap = wildcard)
    parent, left, right,  # [N]
    sub_mat, ins_prob, log_cpt_weight,
    n_nodes: int, alphabet_size: int,
):
    """`_fill_up_batch` taking raw tokens: the observation tensor and gap
    mask are built inside the jit, so the one-hot construction fuses into
    the scan instead of running as eager host-dispatched ops per fill
    (MCMC issues one fill per proposal)."""
    dtype = sub_mat.dtype
    one_hot = jax.nn.one_hot(jnp.maximum(tokens, 0), alphabet_size, dtype=dtype)
    wild = (tokens < 0)[..., None]
    obs = jnp.where(wild, jnp.ones_like(one_hot), one_hot)  # [N, L, A]
    obs = jnp.swapaxes(obs, 0, 1)  # [L, N, A]
    is_gap = (tokens == GAP_TOK).T  # [L, N]
    return (
        _fill_up_batch(obs, is_gap, parent, left, right, sub_mat, ins_prob,
                       log_cpt_weight, n_nodes),
        is_gap,
    )


@partial(jax.jit, static_argnames=("n_nodes",))
def _fill_up_batch(
    obs,  # [L, N, A] observation tensor (column-major batch)
    is_gap,  # [L, N] bool
    parent,  # [N] int32
    left,  # [N]
    right,  # [N]
    sub_mat,  # [N, C, A, A]  (per-branch substitution probs; root row unused)
    ins_prob,  # [C, A]
    log_cpt_weight,  # [C]
    n_nodes: int,
):
    """Tip-to-root messages for every column and mixture component.

    Returns F, logF, E, logE ([L, N, C, A] / [L, N, C]) and col_log_like [L].
    """
    L = obs.shape[0]
    C, A = ins_prob.shape
    dtype = obs.dtype
    neg_inf = jnp.array(-jnp.inf, dtype)

    def column_fill(obs_col, gap_col):
        # obs_col: [N, A], gap_col: [N]
        E0 = jnp.ones((n_nodes, C, A), dtype)
        F0 = jnp.zeros((n_nodes, C, A), dtype)
        logE0 = jnp.zeros((n_nodes, C), dtype)
        logF0 = jnp.zeros((n_nodes, C), dtype)
        cpt_ll0 = jnp.zeros((C,), dtype)

        def step(carry, n):
            E, logE, F, logF, cpt_ll = carry
            l, r = left[n], right[n]
            # product of children E, each factor masked independently
            # (nodes may have 0, 1 or 2 children -- forests from detach ops)
            e_l = jnp.where(l >= 0, E[jnp.maximum(l, 0)], jnp.ones((C, A), dtype))
            e_r = jnp.where(r >= 0, E[jnp.maximum(r, 0)], jnp.ones((C, A), dtype))
            child_prod = e_l * e_r
            log_children = (
                jnp.where(l >= 0, logE[jnp.maximum(l, 0)], jnp.zeros((C,), dtype))
                + jnp.where(r >= 0, logE[jnp.maximum(r, 0)], jnp.zeros((C,), dtype))
            )
            Fn_raw = child_prod * obs_col[n][None, :]  # [C, A]
            # rescale by per-component max
            fmax = jnp.max(Fn_raw, axis=-1, keepdims=True)  # [C, 1]
            safe = jnp.maximum(fmax, jnp.finfo(dtype).tiny)
            Fn = Fn_raw / safe
            logFn = log_children + jnp.log(safe[:, 0])

            gap_n = gap_col[n]
            p = parent[n]
            gap_p = jnp.where(p >= 0, gap_col[jnp.maximum(p, 0)], True)
            is_root = (~gap_n) & gap_p

            # root contribution to column likelihood
            root_ll = logFn + jnp.log(
                jnp.maximum(jnp.einsum("ca,ca->c", Fn, ins_prob), jnp.finfo(dtype).tiny)
            )
            cpt_ll = cpt_ll + jnp.where(is_root, root_ll, jnp.zeros_like(root_ll))

            # message up the branch
            En = jnp.einsum("cij,cj->ci", sub_mat[n], Fn)
            E = E.at[n].set(jnp.where(gap_n | is_root, jnp.ones((C, A), dtype), En))
            logE = logE.at[n].set(jnp.where(gap_n | is_root, 0.0, logFn))
            F = F.at[n].set(jnp.where(gap_n, jnp.zeros((C, A), dtype), Fn))
            logF = logF.at[n].set(jnp.where(gap_n, 0.0, logFn))
            return (E, logE, F, logF, cpt_ll), None

        (E, logE, F, logF, cpt_ll), _ = jax.lax.scan(
            step, (E0, logE0, F0, logF0, cpt_ll0), jnp.arange(n_nodes)
        )
        col_ll = jax.scipy.special.logsumexp(log_cpt_weight + cpt_ll)
        empty = jnp.all(gap_col)
        col_ll = jnp.where(empty, 0.0, col_ll)
        return F, logF, E, logE, cpt_ll, col_ll

    return jax.vmap(column_fill)(obs, is_gap)


@partial(jax.jit, static_argnames=("n_nodes",))
def _fill_down_batch(
    E,  # [L, N, C, A]
    logE,  # [L, N, C]
    is_gap,  # [L, N]
    parent,  # [N]
    sibling,  # [N]
    sub_mat,  # [N, C, A, A]
    ins_prob,  # [C, A]
    n_nodes: int,
):
    """Root-to-tip messages G (sumprod.cpp:163-198), batched over columns."""
    C, A = ins_prob.shape
    dtype = E.dtype

    def column_fill(E_col, logE_col, gap_col):
        G0 = jnp.zeros((n_nodes, C, A), dtype)
        logG0 = jnp.zeros((n_nodes, C), dtype)

        def step(carry, i):
            G, logG = carry
            n = n_nodes - 1 - i  # preorder = reverse postorder
            p = parent[n]
            s = sibling[n]
            gap_p = jnp.where(p >= 0, gap_col[jnp.maximum(p, 0)], True)
            is_root = gap_p  # for ungapped n: parent gapped or absent => root
            Gp = G[jnp.maximum(p, 0)]
            Es = jnp.where(
                (s >= 0) & ~gap_col[jnp.maximum(s, 0)],
                E_col[jnp.maximum(s, 0)],
                jnp.ones((C, A), dtype),
            )
            logEs = jnp.where(s >= 0, logE_col[jnp.maximum(s, 0)], jnp.zeros((C,), dtype))
            Gn = jnp.einsum("ci,cij->cj", Gp * Es, sub_mat[n])
            logGn = logG[jnp.maximum(p, 0)] + logEs
            G = G.at[n].set(jnp.where(is_root, jnp.broadcast_to(ins_prob, (C, A)), Gn))
            logG = logG.at[n].set(jnp.where(is_root, jnp.zeros((C,), dtype), logGn))
            return (G, logG), None

        (G, logG), _ = jax.lax.scan(step, (G0, logG0), jnp.arange(n_nodes))
        return G, logG

    return jax.vmap(column_fill)(E, logE, is_gap)


@partial(jax.jit, static_argnames=("n_nodes",))
def _node_post_prob_batch(F, logF, G, logG, col_ll, log_cpt_weight, n_nodes: int):
    """[L, N, A] log posterior over states at every node, component-marginal
    (sumprod.cpp:208-217)."""
    dtype = F.dtype
    tiny = jnp.finfo(dtype).tiny
    # lpp[l, n, c, a] = log w_c + logF + log F + logG + log G - col_ll
    lpp = (
        log_cpt_weight[None, None, :, None]
        + logF[..., None]
        + jnp.log(jnp.maximum(F, tiny))
        + logG[..., None]
        + jnp.log(jnp.maximum(G, tiny))
        - col_ll[:, None, None, None]
    )
    out = jax.scipy.special.logsumexp(lpp, axis=2)
    return jnp.minimum(out, 0.0)


@jax.jit
def _eigen_counts_batch(F, logF, E, logE, G, logG, col_ll, parent_safe,
                        sib_safe, mask, w_col, log_cpt_weight, evec_r,
                        evec_inv_r, j_r):
    """[C, A, A] real eigencount accumulation over a column batch
    (sumprod.cpp:294-372), device-fused: for each ungapped non-root node,
    w * (D0 . evec)_k J_kl (U0 . evecInv^T)_l with
    D0 = G[parent] * E[sibling], U0 = F,
    w = exp(logw_c + logF + logG + logE - colLogLike) * columnWeight.

    Only valid for models with exactly-real eigensystems (evec_r etc. are
    the real parts, checked exact by the caller)."""
    D0 = G[:, parent_safe] * E[:, sib_safe]
    log_scale = (
        log_cpt_weight[None, None, :]
        + logF
        + logG[:, parent_safe]
        + logE[:, sib_safe]
        - col_ll[:, None, None]
    )
    w = jnp.where(mask[:, :, None], jnp.exp(log_scale), 0.0) * w_col[:, None, None]
    db = jnp.einsum("lnca,cak->lnck", D0, evec_r)
    ub = jnp.einsum("lncb,cmb->lncm", F, evec_inv_r)
    return jnp.einsum("lnc,lnck,lncm,nckm->ckm", w, db, ub, j_r)


def _eigen_counts_core_cplx(F, logF, E, logE, G, logG, col_ll, parent_safe,
                            sib_safe, mask, w_col, log_cpt_weight,
                            evec_r, evec_i, evec_inv_r, evec_inv_i, j_r, j_i):
    """Complex-eigensystem variant of `_eigen_counts_batch`, decomposed
    into real einsums so it runs on backends without complex support
    (the device path): with real messages D0, U0 and complex evec/evecInv/J,

      out[c,k,m] = sum_{l,n} w * (D0 . evec)_k (U0 . evecInv^T)_m J_km

    expands to products of the real/imaginary projections.  Returns
    (real, imag) float64 [C, A, A] pairs."""
    D0 = G[:, parent_safe] * E[:, sib_safe]
    log_scale = (
        log_cpt_weight[None, None, :]
        + logF
        + logG[:, parent_safe]
        + logE[:, sib_safe]
        - col_ll[:, None, None]
    )
    w = jnp.where(mask[:, :, None], jnp.exp(log_scale), 0.0) * w_col[:, None, None]
    wD = w[..., None] * D0
    db_r = jnp.einsum("lnca,cak->lnck", wD, evec_r)
    db_i = jnp.einsum("lnca,cak->lnck", wD, evec_i)
    ub_r = jnp.einsum("lncb,cmb->lncm", F, evec_inv_r)
    ub_i = jnp.einsum("lncb,cmb->lncm", F, evec_inv_i)
    s_r = (jnp.einsum("lnck,lncm->nckm", db_r, ub_r)
           - jnp.einsum("lnck,lncm->nckm", db_i, ub_i))
    s_i = (jnp.einsum("lnck,lncm->nckm", db_r, ub_i)
           + jnp.einsum("lnck,lncm->nckm", db_i, ub_r))
    out_r = (jnp.einsum("nckm,nckm->ckm", s_r, j_r)
             - jnp.einsum("nckm,nckm->ckm", s_i, j_i))
    out_i = (jnp.einsum("nckm,nckm->ckm", s_r, j_i)
             + jnp.einsum("nckm,nckm->ckm", s_i, j_r))
    return out_r, out_i


@partial(jax.jit, static_argnames=("chunk",))
def _eigen_counts_batch_cplx(F, logF, E, logE, G, logG, col_ll, parent_safe,
                             sib_safe, mask, w_col, log_cpt_weight,
                             evec_r, evec_i, evec_inv_r, evec_inv_i, j_r, j_i,
                             chunk=8192):
    """Chunked scan over `_eigen_counts_core_cplx`: the column axis (a
    multiple of `chunk`, caller-padded with mask=False tails) is reshaped
    to [n_chunks, chunk, ...] so intermediates stay chunk-sized while the
    whole accumulation runs in one device dispatch."""
    n_chunks = F.shape[0] // chunk

    def re(a):
        return a.reshape((n_chunks, chunk) + a.shape[1:])

    xs = tuple(re(a) for a in (F, logF, E, logE, G, logG, col_ll, mask, w_col))
    a = evec_r.shape[1]
    c = evec_r.shape[0]
    init = (jnp.zeros((c, a, a), F.dtype), jnp.zeros((c, a, a), F.dtype))

    def body(acc, x):
        f, lf, e, le, g, lg, cl, m, w = x
        r, i = _eigen_counts_core_cplx(
            f, lf, e, le, g, lg, cl, parent_safe, sib_safe, m, w,
            log_cpt_weight, evec_r, evec_i, evec_inv_r, evec_inv_i, j_r, j_i,
        )
        return (acc[0] + r, acc[1] + i), None

    (out_r, out_i), _ = jax.lax.scan(body, init, xs)
    return out_r, out_i


@jax.jit
def _root_counts_batch(F_sel, logF_sel, col_ll_sel, w_sel, log_cpt_weight, ins_prob):
    """[C, A] root count accumulation over the root-bearing columns
    (sumprod.cpp:264-271), device-fused."""
    norm = jnp.exp(log_cpt_weight[None, :] + logF_sel - col_ll_sel[:, None])
    return jnp.einsum("l,ci,lci,lc->ci", w_sel, ins_prob, F_sel, norm)
