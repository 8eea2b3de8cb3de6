"""Branch alignment matrices: 3-state parent<->child pair HMM over PWMs.

Counterpart of the reference's BranchMatrixBase / Sampler::BranchMatrix /
Refiner::BranchMatrix (sampler.h:183-223, sampler.cpp:1005-1160,
refiner.cpp:10-103).  The fill runs on device (ops/branchdp); traceback
(best or stochastic sample) and path scoring walk the returned cells on
host, reproducing the reference's source ordering for RNG parity.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.special import logsumexp

from historian_tpu.core.alignpath import AlignPath, GuideAlignmentEnvelope
from historian_tpu.engine.treealign import calc_ins_probs, pre_multiply
from historian_tpu.models.ratemodel import LogProbModel, ProbModel, RateModel
from historian_tpu.ops.branchdp import DELETE, INSERT, MATCH, NEG, branch_forward, branch_viterbi
from historian_tpu.utils.rng import MT19937

MIN_BRANCH_LEN = 1e-9
START, END = 0, 3  # Start aliases Match in transition lookups


class BranchMatrix:
    """Forward (sum) or Viterbi (max) branch DP over position-weight matrices."""

    def __init__(
        self,
        model: RateModel,
        x_pwm: np.ndarray,  # [X, C, A] parent conditional log-probs
        y_pwm: np.ndarray,  # [Y, C, A] child conditional log-probs
        dist: float,
        env: GuideAlignmentEnvelope,
        x_env_pos: np.ndarray,
        y_env_pos: np.ndarray,
        x_row: int,
        y_row: int,
        viterbi: bool = False,
    ):
        self.model = model
        self.prob_model = ProbModel(model, max(MIN_BRANCH_LEN, dist))
        self.log_prob_model = LogProbModel(self.prob_model)
        self.x_row, self.y_row = x_row, y_row
        self.viterbi = viterbi
        self.x_size = len(x_pwm) + 1
        self.y_size = len(y_pwm) + 1
        self.x_pwm = x_pwm
        self.y_sub = pre_multiply(y_pwm, self.log_prob_model.log_sub_prob)
        with np.errstate(divide="ignore"):
            self.y_emit = calc_ins_probs(
                y_pwm, self.log_prob_model.log_ins_prob, self.log_prob_model.log_cpt_weight
            )

        # transitions
        tp = self.prob_model.trans_prob

        def lg(p):
            return math.log(p) if p > 0 else -np.inf

        M, I, D, E = ProbModel.MATCH, ProbModel.INSERT, ProbModel.DELETE, ProbModel.END
        self.mm, self.mi, self.md, self.me = lg(tp(M, M)), lg(tp(M, I)), lg(tp(M, D)), lg(tp(M, E))
        self.im, self.ii, self.id, self.ie = lg(tp(I, M)), lg(tp(I, I)), lg(tp(I, D)), lg(tp(I, E))
        self.dm, self.dd, self.de = lg(tp(D, M)), lg(tp(D, D)), lg(tp(D, E))

        # envelope mask [X+1, Y+1]: boundary rows/cols always in
        mask = np.zeros((self.x_size, self.y_size), dtype=bool)
        if env.initialized:
            m1 = env.cumulative_matches[env.row1_pos_to_col[np.asarray(x_env_pos)]]
            m2 = env.cumulative_matches[env.row2_pos_to_col[np.asarray(y_env_pos)]]
            mask[:, :] = np.abs(m1[:, None] - m2[None, :]) <= env.max_distance
        else:
            mask[:, :] = True
        mask[0, :] = mask[:, 0] = mask[-1, :] = mask[:, -1] = True
        self.mask = mask

        # match emission matrix: lse_{c,a}(x_pwm[x] + y_sub[y]) -> [X+1, Y+1]
        match_emit = np.full((self.x_size, self.y_size), NEG)
        if len(x_pwm) and len(y_pwm):
            mx = x_pwm.max(axis=(1, 2), keepdims=True)
            my = self.y_sub.max(axis=(1, 2), keepdims=True)
            sx = np.where(np.isfinite(mx), mx, 0.0)
            sy = np.where(np.isfinite(my), my, 0.0)
            ex = np.exp(x_pwm - sx).reshape(len(x_pwm), -1)
            ey = np.exp(self.y_sub - sy).reshape(len(y_pwm), -1)
            with np.errstate(divide="ignore"):
                match_emit[1:, 1:] = (
                    np.log(ex @ ey.T) + sx[:, 0, 0][:, None] + sy[:, 0, 0][None, :]
                )
        self.match_emit = match_emit
        ins_emit = np.concatenate([[NEG], self.y_emit]) if len(y_pwm) else np.array([NEG])

        trans = np.array([self.mm, self.mi, self.md, self.im, self.ii, self.id, self.dm, self.dd])
        self.cells = self._fill_cells(match_emit, ins_emit, mask, trans, viterbi)
        end = self.cells[self.x_size - 1, self.y_size - 1]
        reduce3 = max if viterbi else lambda *v: logsumexp(list(v))
        self.lp_end = float(
            reduce3(end[MATCH] + self.me, end[INSERT] + self.ie, end[DELETE] + self.de)
        )

    @staticmethod
    def _fill_cells(match_emit, ins_emit, mask, trans, viterbi: bool) -> np.ndarray:
        """Run the 3-state fill through the native host runtime or the
        device kernel.  HISTORIAN_DEVICE_BRANCH=1/0 forces; default
        'auto' routes to the device only on the GPU backend with a grid
        big enough to out-compute the host fill -- the same rule as the
        sibling fill.  The two implementations use the same recurrences
        but different Delete-recursion orderings, so cells can differ in
        the last bits."""
        import os

        env = os.environ.get("HISTORIAN_DEVICE_BRANCH", "auto")
        want_device = env == "1"
        if env not in ("0", "1"):
            from historian_tpu.ops import devicedp

            want_device = (
                devicedp.accel_backend()
                and match_emit.shape[0] * match_emit.shape[1] * 3 > 2_000_000
            )
        if not want_device:
            from historian_tpu.native import get_native

            lib = get_native()
            if lib is not None:
                cells = np.empty((match_emit.shape[0], match_emit.shape[1], 3))
                lib.branch_fill(
                    match_emit.shape[0], match_emit.shape[1],
                    np.ascontiguousarray(match_emit),
                    np.ascontiguousarray(ins_emit, dtype=np.float64),
                    np.ascontiguousarray(mask, dtype=np.uint8),
                    trans, np.uint8(viterbi), cells,
                )
                return cells

        import jax.numpy as jnp

        fill = branch_viterbi if viterbi else branch_forward
        # bucket shapes to 128-multiples so MCMC/refiner fills share jit
        # compilations (mask is False outside the real region, which the
        # fill pins to -inf; results are sliced back, unchanged)
        px = -(-match_emit.shape[0] // 128) * 128
        py = -(-match_emit.shape[1] // 128) * 128
        emit_p = np.full((px, py), NEG)
        emit_p[: match_emit.shape[0], : match_emit.shape[1]] = match_emit
        ins_p = np.full(py, NEG)
        ins_p[: len(ins_emit)] = ins_emit
        mask_p = np.zeros((px, py), dtype=bool)
        mask_p[: mask.shape[0], : mask.shape[1]] = mask
        return np.asarray(
            fill(jnp.asarray(emit_p), jnp.asarray(ins_p), jnp.asarray(mask_p), jnp.asarray(trans))
        )[: match_emit.shape[0], : match_emit.shape[1]]

    # ----------------------------------------------------------------- helpers
    def lp_trans(self, src: int, dest: int) -> float:
        table = {
            (MATCH, MATCH): self.mm, (MATCH, INSERT): self.mi, (MATCH, DELETE): self.md, (MATCH, END): self.me,
            (INSERT, MATCH): self.im, (INSERT, INSERT): self.ii, (INSERT, DELETE): self.id, (INSERT, END): self.ie,
            (DELETE, MATCH): self.dm, (DELETE, INSERT): -np.inf, (DELETE, DELETE): self.dd, (DELETE, END): self.de,
        }
        return table.get((src, dest), -np.inf)

    def lp_emit(self, x: int, y: int, state: int) -> float:
        if state == MATCH:
            return self.match_emit[x, y] if (x > 0 and y > 0) else -np.inf
        if state == INSERT:
            return self.y_emit[y - 1] if y > 0 else -np.inf
        return 0.0

    @staticmethod
    def _column(state: int):
        if state == MATCH:
            return True, True
        if state == INSERT:
            return False, True
        if state == DELETE:
            return True, False
        return False, False

    def _traceback(self, chooser) -> AlignPath:
        x, y, state = self.x_size - 1, self.y_size - 1, END
        x_path: list[bool] = []
        y_path: list[bool] = []
        while x > 0 or y > 0:
            if state == END:
                dx = dy = False
            else:
                dx, dy = self._column(state)
                x_path.append(dx)
                y_path.append(dy)
            sx = x - 1 if dx else x
            sy = y - 1 if dy else y
            if state == END:
                sx, sy = x, y
            e = self.lp_emit(x, y, state) if state != END else 0.0
            cands = {}
            for s in (MATCH, INSERT, DELETE):
                cands[s] = self.cells[sx, sy, s] + self.lp_trans(s, state) + e
            state = chooser(cands)
            x, y = sx, sy
        x_path.reverse()
        y_path.reverse()
        return {
            self.x_row: np.array(x_path, dtype=bool),
            self.y_row: np.array(y_path, dtype=bool),
        }

    def best(self) -> AlignPath:
        def choose_best(cands):
            best_s, best_v = None, -np.inf
            for s in (MATCH, INSERT, DELETE):
                if cands[s] > best_v:
                    best_s, best_v = s, cands[s]
            return best_s

        return self._traceback(choose_best)

    def sample(self, rng: MT19937) -> AlignPath:
        """Stochastic traceback matching the reference's random_key_log
        ordering (map sorted by state index)."""

        def choose_sample(cands):
            items = sorted(cands.items())
            lpmax = max(v for _, v in items)
            weights = [math.exp(v - lpmax) for _, v in items]
            total = sum(weights)
            p = rng.uniform(0, total)
            for (s, _), w in zip(items, weights):
                p -= w
                if p <= 0:
                    return s
            return items[-1][0]

        return self._traceback(choose_sample)

    def log_path_prob(self, path: AlignPath) -> float:
        """Score one alignment path (sampler.cpp:1122-1152)."""
        x = y = 0
        state = MATCH  # Start aliases Match
        lp = 0.0
        xr = np.asarray(path[self.x_row], dtype=bool)
        yr = np.asarray(path[self.y_row], dtype=bool)
        for col in range(len(xr)):
            dx, dy = bool(xr[col]), bool(yr[col])
            if dx:
                x += 1
            if dy:
                y += 1
            next_state = ProbModel.get_state(dx, dy)
            if not self.mask[x, y]:
                return -np.inf
            lp += self.lp_trans(state, next_state) + self.lp_emit(x, y, next_state)
            lp = min(lp, float(self.cells[x, y, next_state]))
            state = next_state
        lp += self.lp_trans(state, END)
        return lp

    def log_post_prob(self, path: AlignPath) -> float:
        return min(self.log_path_prob(path), self.lp_end) - self.lp_end
