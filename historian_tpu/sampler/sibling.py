"""Three-sequence sibling transducer DP: align (left, right) -> parent.

Counterpart of the reference's Sampler::SiblingMatrix
(/root/reference/src/sampler.h:226-325, sampler.cpp:1185-1620): an
11-state machine {IMM, IMD, IDM, IDD, WWW, WWX, WXW, IMI, IIW, IDI, IIX}
whose IDD self-loop is eliminated analytically (geometric, re-added
during traceback) and whose wait states are eliminated for path scoring.
Samples a parent alignment of two sibling profiles and produces the
parent's position-weight matrix.

The fill runs in native C++ by default (native/fill.cpp sibling_fill,
bit-identical to the python fallback), or on device as a lax.scan
kernel (ops/siblingdp, HISTORIAN_DEVICE_SIBLING=1); the emission
tensors are precomputed einsums.
"""

from __future__ import annotations

import math
import os

import numpy as np
from scipy.special import logsumexp as logsumexp_nd


def logsumexp(vals):
    """Scalar log-sum-exp over a small list.

    Same max-shift formulation as scipy.special.logsumexp (which this
    replaces: its array-API dispatch costs ~200us per call, and the
    sibling fill makes one call per cell), evaluated with math.* on
    floats."""
    m = max(vals)
    if m == -math.inf:
        return -math.inf
    return m + math.log(sum(math.exp(v - m) for v in vals))

from historian_tpu.core.alignpath import AlignPath, GuideAlignmentEnvelope, align_path_columns, residues_in_row
from historian_tpu.engine.treealign import calc_ins_probs, pre_multiply, root_ext_prob
from historian_tpu.models.ratemodel import LogProbModel, ProbModel, RateModel
from historian_tpu.utils.rng import MT19937

NEG = -np.inf
MIN_BRANCH_LEN = 1e-9

# state indices
IMM, IMD, IDM, IDD, WWW, WWX, WXW, IMI, IIW, IDI, IIX = range(11)
EEE = 11
SSS = IMM
N_STATES = 11


def _lg(p: float) -> float:
    return math.log(p) if p > 0 else NEG


class SiblingMatrix:
    def __init__(
        self,
        model: RateModel,
        l_pwm: np.ndarray,  # [L, C, A]
        r_pwm: np.ndarray,  # [R, C, A]
        pl_dist: float,
        pr_dist: float,
        env: GuideAlignmentEnvelope,
        l_env_pos: np.ndarray,
        r_env_pos: np.ndarray,
        l_row: int,
        r_row: int,
        p_row: int,
        defer_fill: bool = False,
    ):
        self.model = model
        self.l_prob = ProbModel(model, max(MIN_BRANCH_LEN, pl_dist))
        self.r_prob = ProbModel(model, max(MIN_BRANCH_LEN, pr_dist))
        l_log = LogProbModel(self.l_prob)
        r_log = LogProbModel(self.r_prob)
        self.l_row, self.r_row, self.p_row = l_row, r_row, p_row
        with np.errstate(divide="ignore"):
            self.log_root = np.log(model.ins_prob) + np.log(model.cpt_weight)[:, None]
        self.l_sub = pre_multiply(l_pwm, l_log.log_sub_prob)  # [L, C, A]
        self.r_sub = pre_multiply(r_pwm, r_log.log_sub_prob)
        self.l_emit = calc_ins_probs(l_pwm, l_log.log_ins_prob, l_log.log_cpt_weight)
        self.r_emit = calc_ins_probs(r_pwm, r_log.log_ins_prob, r_log.log_cpt_weight)
        self.x_size = len(l_pwm) + 1
        self.y_size = len(r_pwm) + 1

        # envelope mask
        mask = np.zeros((self.x_size, self.y_size), dtype=bool)
        if env.initialized:
            m1 = env.cumulative_matches[env.row1_pos_to_col[np.asarray(l_env_pos)]]
            m2 = env.cumulative_matches[env.row2_pos_to_col[np.asarray(r_env_pos)]]
            mask[:, :] = np.abs(m1[:, None] - m2[None, :]) <= env.max_distance
        else:
            mask[:, :] = True
        mask[0, :] = mask[:, 0] = mask[-1, :] = mask[:, -1] = True
        self.mask = mask

        # match emission matrix [X, Y] (1-based positions):
        # lse_{c,a}(logRoot[c,a] + lSub[x,c,a] + rSub[y,c,a]), evaluated as
        # an exp-shifted matmul (BLAS work) instead of a logsumexp
        # over the full [L, R, C, A] tensor -- the L x R pair axes never
        # materialize, and the inner product rides dgemm.  Equal to the
        # tensor logsumexp up to summation reassociation.
        self.match_emit = np.full((self.x_size, self.y_size), NEG)
        if len(l_pwm) and len(r_pwm):
            z = self.log_root[None, :, :] + self.l_sub  # [L, C, A]
            mx = z.max(axis=(1, 2), keepdims=True)
            my = self.r_sub.max(axis=(1, 2), keepdims=True)
            sx = np.where(np.isfinite(mx), mx, 0.0)
            sy = np.where(np.isfinite(my), my, 0.0)
            ex = np.exp(z - sx).reshape(len(l_pwm), -1)
            ey = np.exp(self.r_sub - sy).reshape(len(r_pwm), -1)
            with np.errstate(divide="ignore"):
                self.match_emit[1:, 1:] = (
                    np.log(ex @ ey.T) + sx[:, 0, 0][:, None] + sy[:, 0, 0][None, :]
                )

        self._t_raw: dict | None = None
        self._init_transitions()
        if not defer_fill:
            self._fill()

    # ------------------------------------------------------------ transitions
    def idd_self_loop_prob(self) -> float:
        return root_ext_prob(self.model) * self.l_prob.del_ext * self.r_prob.del_ext

    def lp_trans(self, src: int, dest: int) -> float:
        """Raw 35-transition table (sampler.cpp:1460-1577), built once."""
        if self._t_raw is None:
            self._t_raw = self._build_raw_table()
        return self._t_raw.get((src, dest), NEG)

    def _build_raw_table(self) -> dict:
        l, r = self.l_prob, self.r_prob
        re = root_ext_prob(self.model)
        t = {
            (IMM, WWW): _lg(1 - l.ins) + _lg(1 - r.ins),
            (IMM, IMI): _lg(r.ins),
            (IMM, IIW): _lg(l.ins) + _lg(1 - r.ins),
            (IMD, WWX): _lg(1 - l.ins),
            (IMD, IIX): _lg(l.ins),
            (IDM, WXW): _lg(1 - r.ins),
            (IDM, IDI): _lg(r.ins),
            (IDD, IDD): _lg(self.idd_self_loop_prob()),
            (IDD, IMM): _lg(re) + _lg(1 - l.del_ext) + _lg(1 - r.del_ext),
            (IDD, IMD): _lg(re) + _lg(1 - l.del_ext) + _lg(r.del_ext),
            (IDD, IDM): _lg(re) + _lg(l.del_ext) + _lg(1 - r.del_ext),
            (IDD, EEE): _lg(1 - re) + _lg(1 - l.del_ext) + _lg(1 - r.del_ext),
            (WWW, IMM): _lg(re) + _lg(1 - l.del_) + _lg(1 - r.del_),
            (WWW, IMD): _lg(re) + _lg(1 - l.del_) + _lg(r.del_),
            (WWW, IDM): _lg(re) + _lg(l.del_) + _lg(1 - r.del_),
            (WWW, IDD): _lg(re) + _lg(l.del_) + _lg(r.del_),
            (WWW, EEE): 0.0,
            (WWX, IMM): _lg(re) + _lg(1 - l.del_) + _lg(1 - r.del_ext),
            (WWX, IMD): _lg(re) + _lg(1 - l.del_) + _lg(r.del_ext),
            (WWX, IDM): _lg(re) + _lg(l.del_) + _lg(1 - r.del_ext),
            (WWX, IDD): _lg(re) + _lg(l.del_) + _lg(r.del_ext),
            (WWX, EEE): _lg(1 - r.del_ext),
            (WXW, IMM): _lg(re) + _lg(1 - l.del_ext) + _lg(1 - r.del_),
            (WXW, IMD): _lg(re) + _lg(1 - l.del_ext) + _lg(r.del_),
            (WXW, IDM): _lg(re) + _lg(l.del_ext) + _lg(1 - r.del_),
            (WXW, IDD): _lg(re) + _lg(l.del_ext) + _lg(r.del_),
            (WXW, EEE): _lg(1 - l.del_ext),
            (IMI, WWW): _lg(1 - l.ins) + _lg(1 - r.ins_ext),
            (IMI, IMI): _lg(r.ins_ext),
            (IMI, IIW): _lg(l.ins) + _lg(1 - r.ins_ext),
            (IIW, WWW): _lg(1 - l.ins_ext),
            (IIW, IIW): _lg(l.ins_ext),
            (IDI, WXW): _lg(1 - r.ins_ext),
            (IDI, IDI): _lg(r.ins_ext),
            (IIX, WWX): _lg(1 - l.ins_ext),
            (IIX, IIX): _lg(l.ins_ext),
        }
        return t

    def lp_trans_elim_idd(self, src: int, dest: int) -> float:
        if src == IDD:
            if dest == IDD:
                return NEG
            return self.lp_trans(src, dest) + self.idd_exit()
        return self.lp_trans(src, dest)

    def idd_exit(self) -> float:
        return math.log(1.0 / (1.0 - self.idd_self_loop_prob()))

    def lp_trans_elim_wait(self, src: int, dest: int) -> float:
        return logsumexp(
            [
                self.lp_trans(src, dest),
                self.lp_trans(src, WWW) + self.lp_trans(WWW, dest),
                self.lp_trans(src, WWX) + self.lp_trans(WWX, dest),
                self.lp_trans(src, WXW) + self.lp_trans(WXW, dest),
            ]
        )

    def _init_transitions(self) -> None:
        e = self.lp_trans_elim_idd
        self.t = {}
        for src in range(N_STATES):
            for dest in list(range(N_STATES)) + [EEE]:
                self.t[(src, dest)] = e(src, dest)

    # ------------------------------------------------------------------- fill
    def _fill(self) -> None:
        if self._want_device() and self._fill_device():
            return
        if self._fill_native():
            return
        self._fill_host()

    @classmethod
    def fill_batch(cls, mats: "list[SiblingMatrix]") -> bool:
        """Fill K deferred proposal grids in ONE device dispatch
        (ops/siblingdp.sibling_forward_batch).

        Amortizes the per-dispatch round trip over the whole batch:
        grids are bucket-padded to a shared [X1, Y1] (128-multiples, so
        repeated batches reuse compiles), transitions ride per-item.
        Not wired into production: the MH chain is sequential --
        proposal k+1's inputs depend on whether proposal k was accepted
        -- so only independent chains (MCMC over multiple datasets) or
        speculative proposals can feed a batch.  Values agree with the
        host fill to f64 round-off, same caveat as _fill_device."""
        if not mats:
            return True
        from historian_tpu.ops.siblingdp import (
            pack_sibling_transitions,
            sibling_forward_batch,
        )

        X1 = -(-max(m.x_size for m in mats) // 128) * 128
        Y1 = -(-max(m.y_size for m in mats) // 128) * 128
        K = len(mats)
        l_emit = np.full((K, X1 - 1), NEG)
        r_emit = np.full((K, Y1 - 1), NEG)
        match = np.full((K, X1, Y1), -1e30)
        mask = np.zeros((K, X1, Y1), dtype=bool)
        trans = np.empty((K, 35))
        ends = np.empty((K, 2), dtype=np.int32)
        for k, m in enumerate(mats):
            sx, sy = m.x_size, m.y_size
            l_emit[k, : sx - 1] = m.l_emit
            r_emit[k, : sy - 1] = m.r_emit
            match[k, :sx, :sy] = np.where(
                np.isfinite(m.match_emit), m.match_emit, -1e30
            )
            mask[k, :sx, :sy] = m.mask
            trans[k] = pack_sibling_transitions(m)
            ends[k] = (sx - 1, sy - 1)
        cells, lp_end = sibling_forward_batch(
            l_emit, r_emit, match, mask, trans, ends
        )
        cells = np.asarray(cells, dtype=np.float64)
        lp_end = np.asarray(lp_end, dtype=np.float64)
        for k, m in enumerate(mats):
            ck = cells[k, : m.x_size, : m.y_size]
            m.cells = np.where(ck < -1e29, NEG, ck)
            m.lp_end = float(lp_end[k])
        return True

    def _want_device(self) -> bool:
        """HISTORIAN_DEVICE_SIBLING=1/0 forces; default 'auto' uses the
        device only on the GPU backend with a grid big enough to
        out-compute the host fill."""
        env = os.environ.get("HISTORIAN_DEVICE_SIBLING", "auto")
        if env in ("0", "1"):
            return env == "1"
        from historian_tpu.ops import devicedp

        return devicedp.accel_backend() and self.x_size * self.y_size * N_STATES > 2_000_000

    def _fill_native(self) -> bool:
        """Native host-runtime fill (native/fill.cpp sibling_fill):
        bit-identical to _fill_host -- same lse formulation, operation
        order, and libm -- so it is the default when the library builds.
        HISTORIAN_NATIVE=0 forces the python fill."""
        from historian_tpu.native import get_native

        lib = get_native()
        if lib is None or not hasattr(lib, "sibling_fill"):
            return False
        sx, sy = self.x_size, self.y_size
        tmat = np.full((12, 12), NEG)
        for (s, d), lp in self.t.items():
            tmat[s, d] = lp
        cells = np.full((sx, sy, N_STATES), NEG)
        lp_end = np.zeros(1)
        lib.sibling_fill(
            sx, sy,
            np.ascontiguousarray(self.l_emit, np.float64),
            np.ascontiguousarray(self.r_emit, np.float64),
            np.ascontiguousarray(self.match_emit, np.float64),
            np.ascontiguousarray(self.mask.astype(np.uint8)),
            tmat, cells, lp_end,
        )
        self.cells = cells
        self.lp_end = float(lp_end[0])
        return True

    def _fill_device(self) -> bool:
        """Run the fill through the ops/siblingdp device kernel.

        Opt-in (HISTORIAN_DEVICE_SIBLING=1): agrees with the host fill to
        f64 round-off, which is enough for scoring/batching but not for
        reproducing the reference's exact MH accept/reject float
        sequence -- the host fill stays the default."""
        from historian_tpu.ops.siblingdp import pack_sibling_transitions, sibling_forward

        match_emit = np.where(np.isfinite(self.match_emit), self.match_emit, -1e30)
        cells, lp_end = sibling_forward(
            np.ascontiguousarray(self.l_emit, np.float64),
            np.ascontiguousarray(self.r_emit, np.float64),
            np.ascontiguousarray(match_emit, np.float64),
            np.ascontiguousarray(self.mask),
            pack_sibling_transitions(self),
        )
        cells = np.asarray(cells).astype(np.float64)
        self.cells = np.where(cells < -1e29, NEG, cells)
        self.lp_end = float(lp_end)
        return True

    def _fill_host(self) -> None:
        t = self.t
        sx, sy = self.x_size, self.y_size
        cells = np.full((sx, sy, N_STATES), NEG)
        cells[0, 0, IMM] = 0.0  # start (SSS aliases IMM)
        cells[0, 0, WWW] = t[(IMM, WWW)]
        with np.errstate(divide="ignore", invalid="ignore"):
            for x in range(sx):
                for y in range(sy):
                    if not self.mask[x, y]:
                        continue
                    dest = cells[x, y]
                    if x > 0 and self.mask[x - 1, y]:
                        l_src = cells[x - 1, y]
                        le = self.l_emit[x - 1]
                        dest[IIW] = le + logsumexp(
                            [l_src[IMM] + t[(IMM, IIW)], l_src[IMI] + t[(IMI, IIW)], l_src[IIW] + t[(IIW, IIW)]]
                        )
                        dest[IIX] = le + np.logaddexp(
                            l_src[IMD] + t[(IMD, IIX)], l_src[IIX] + t[(IIX, IIX)]
                        )
                        dest[IMD] = le + logsumexp(
                            [l_src[WWW] + t[(WWW, IMD)], l_src[WWX] + t[(WWX, IMD)],
                             l_src[WXW] + t[(WXW, IMD)], l_src[IDD] + t[(IDD, IMD)]]
                        )
                        dest[WWW] = dest[IIW] + t[(IIW, WWW)]
                        dest[WWX] = np.logaddexp(
                            dest[IIX] + t[(IIX, WWX)], dest[IMD] + t[(IMD, WWX)]
                        )
                    if y > 0 and self.mask[x, y - 1]:
                        r_src = cells[x, y - 1]
                        ren = self.r_emit[y - 1]
                        dest[IMI] = ren + np.logaddexp(
                            r_src[IMM] + t[(IMM, IMI)], r_src[IMI] + t[(IMI, IMI)]
                        )
                        dest[IDI] = ren + np.logaddexp(
                            r_src[IDM] + t[(IDM, IDI)], r_src[IDI] + t[(IDI, IDI)]
                        )
                        dest[IDM] = ren + logsumexp(
                            [r_src[WWW] + t[(WWW, IDM)], r_src[WWX] + t[(WWX, IDM)],
                             r_src[WXW] + t[(WXW, IDM)], r_src[IDD] + t[(IDD, IDM)]]
                        )
                        dest[WWW] = np.logaddexp(dest[WWW], dest[IMI] + t[(IMI, WWW)])
                        dest[WXW] = np.logaddexp(
                            dest[IDI] + t[(IDI, WXW)], dest[IDM] + t[(IDM, WXW)]
                        )
                    if x > 0 and y > 0 and self.mask[x - 1, y - 1]:
                        lr_src = cells[x - 1, y - 1]
                        dest[IMM] = self.match_emit[x, y] + logsumexp(
                            [lr_src[WWW] + t[(WWW, IMM)], lr_src[WWX] + t[(WWX, IMM)],
                             lr_src[WXW] + t[(WXW, IMM)], lr_src[IDD] + t[(IDD, IMM)]]
                        )
                        dest[WWW] = np.logaddexp(dest[WWW], dest[IMM] + t[(IMM, WWW)])
                    if (x, y) == (0, 0):
                        dest[IMM] = 0.0
                        dest[WWW] = t[(IMM, WWW)]
                    dest[IDD] = logsumexp(
                        [dest[WWW] + t[(WWW, IDD)], dest[WWX] + t[(WWX, IDD)], dest[WXW] + t[(WXW, IDD)]]
                    )
        self.cells = cells
        end = cells[sx - 1, sy - 1]
        self.lp_end = float(
            logsumexp(
                [end[IDD] + t[(IDD, EEE)], end[WWW] + t[(WWW, EEE)],
                 end[WWX] + t[(WWX, EEE)], end[WXW] + t[(WXW, EEE)]]
            )
        )

    # ------------------------------------------------------------- traceback
    @staticmethod
    def get_state(src: int, l_ungapped: bool, r_ungapped: bool, p_ungapped: bool) -> int:
        if p_ungapped:
            return IMM if l_ungapped and r_ungapped else (IMD if l_ungapped else (IDM if r_ungapped else IDD))
        if l_ungapped:
            return IIX if src in (IMD, IIX) else IIW
        if r_ungapped:
            return IDI if src in (IDM, IDI) else IMI
        if src in (IDM, IDD, IDI):
            return WXW
        if src in (IMD, IIX):
            return WWX
        return WWW

    @staticmethod
    def _column(state: int, x: int, y: int):
        l = r = p = False
        if state == IMM:
            if x > 0 and y > 0:
                l = r = p = True
        elif state == IMD:
            p = l = True
        elif state == IDM:
            p = r = True
        elif state == IDD:
            p = True
        elif state in (IIW, IIX):
            if x > 0:
                l = True
        elif state in (IMI, IDI):
            if y > 0:
                r = True
        return l, r, p

    def lp_emit(self, x: int, y: int, state: int) -> float:
        if state == IMM:
            return self.match_emit[x, y] if (x > 0 and y > 0) else NEG
        if state in (IDM, IMI, IDI):
            return self.r_emit[y - 1] if y > 0 else NEG
        if state in (IMD, IIW, IIX):
            return self.l_emit[x - 1] if x > 0 else NEG
        return 0.0

    def sample(self, rng: MT19937) -> AlignPath:
        x, y, state = self.x_size - 1, self.y_size - 1, EEE
        l_path: list[bool] = []
        r_path: list[bool] = []
        p_path: list[bool] = []
        idd_p = self.idd_self_loop_prob()
        while x > 0 or y > 0:
            l, r, p = self._column(state, x, y) if state != EEE else (False, False, False)
            if l or r or p:
                l_path.append(l)
                r_path.append(r)
                p_path.append(p)
            if state == IDD:
                # geometric number of IDD self-loops (std::geometric_distribution)
                u = rng.uniform()
                n_loops = int(math.floor(math.log1p(-u) / math.log(idd_p))) if idd_p > 0 else 0
                for _ in range(n_loops):
                    l_path.append(l)
                    r_path.append(r)
                    p_path.append(p)
            sx = x - 1 if l else x
            sy = y - 1 if r else y
            if state == EEE:
                sx, sy = x, y
            e = self.lp_emit(x, y, state) if state != EEE else 0.0
            cands = {}
            for s in range(N_STATES):
                cands[s] = self.cells[sx, sy, s] + self.t[(s, state)] + e
            state = self._sample_state(cands, rng)
            x, y = sx, sy
        l_path.reverse()
        r_path.reverse()
        p_path.reverse()
        return {
            self.l_row: np.array(l_path, dtype=bool),
            self.r_row: np.array(r_path, dtype=bool),
            self.p_row: np.array(p_path, dtype=bool),
        }

    @staticmethod
    def _sample_state(cands: dict, rng: MT19937) -> int:
        items = sorted(cands.items())
        lpmax = max(v for _, v in items)
        if lpmax == NEG:
            raise RuntimeError("traceback state has zero probability")
        weights = [math.exp(v - lpmax) for _, v in items]
        total = sum(weights)
        p = rng.uniform(0, total)
        for (s, _), w in zip(items, weights):
            p -= w
            if p <= 0:
                return s
        return items[-1][0]

    def log_post_prob(self, lrp_path: AlignPath) -> float:
        cols = align_path_columns(lrp_path)
        lp = 0.0
        x = y = 0
        state = SSS
        lr = np.asarray(lrp_path[self.l_row], dtype=bool)
        rr = np.asarray(lrp_path[self.r_row], dtype=bool)
        pr = np.asarray(lrp_path[self.p_row], dtype=bool)
        for col in range(cols):
            dl, dr, dp = bool(lr[col]), bool(rr[col]), bool(pr[col])
            if dl:
                x += 1
            if dr:
                y += 1
            prev = state
            state = self.get_state(prev, dl, dr, dp)
            if not self.mask[x, y]:
                return NEG
            lp += self.lp_trans_elim_wait(prev, state) + self.lp_emit(x, y, state)
            lp = min(lp, float(self.cells[x, y, state]))
        lp += self.lp_trans_elim_wait(state, EEE)
        lp = min(lp, self.lp_end)
        return lp - self.lp_end

    def parent_seq(self, lrp_path: AlignPath) -> np.ndarray:
        """Parent PWM = normalized product of child messages
        (sampler.cpp:1576-1606)."""
        lr = np.asarray(lrp_path[self.l_row], dtype=bool)
        rr = np.asarray(lrp_path[self.r_row], dtype=bool)
        pr = np.asarray(lrp_path[self.p_row], dtype=bool)
        c, a = self.model.components, self.model.alphabet_size
        sel = np.nonzero(pr)[0]
        if not len(sel):
            return np.zeros((0, c, a))
        # note: position counters advance only within parent-emitting columns,
        # exactly as in the reference (sampler.cpp:1583-1594)
        l_here = lr[sel]
        r_here = rr[sel]
        l_idx = np.cumsum(l_here) - 1
        r_idx = np.cumsum(r_here) - 1
        prof = np.zeros((len(sel), c, a))
        if np.any(l_here):
            prof[l_here] += self.l_sub[l_idx[l_here]]
        if np.any(r_here):
            prof[r_here] += self.r_sub[r_idx[r_here]]
        # one batched scipy call: bit-identical per column to the
        # reference's per-column logsumexp normalization
        return prof - logsumexp_nd(prof, axis=(1, 2), keepdims=True)
