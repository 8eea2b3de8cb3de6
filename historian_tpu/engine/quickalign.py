"""Fast banded pairwise Viterbi alignment (guide-alignment workhorse).

Counterpart of the reference's QuickAlignMatrix
(/root/reference/src/quickalign.h:8-69): 3-state (M/I/D) Viterbi with
log-odds substitution scores log P_sub(i,j)/P_ins(j), symmetrized gap
open/extend derived from the rate model's branch probabilities, and free
end gaps.  The fill runs as a column-scan device kernel
(historian_tpu.ops.pairdp); traceback walks the returned matrices on
host, reproducing the reference's candidate ordering (Match, Insert,
Delete, Start -- quickalign.cpp:147-207).
"""

from __future__ import annotations

import math
import os

import jax.numpy as jnp
import numpy as np

from historian_tpu.core.alignpath import AlignPath
from historian_tpu.core.seqs import FastSeq
from historian_tpu.engine.diagenv import DiagonalEnvelope
from historian_tpu.models.ratemodel import ProbModel, RateModel
from historian_tpu.ops.pairdp import NEG_INF, banded_viterbi_fill

_batched_fill = None


def _get_batched_fill():
    import jax

    global _batched_fill
    if _batched_fill is None:
        _batched_fill = jax.jit(jax.vmap(banded_viterbi_fill, in_axes=(0, 0, 0, None)))
    return _batched_fill


def device_guide_enabled() -> bool:
    """Whether guide fills+tracebacks run fully device-resident
    (ops/guidedp.py).  HISTORIAN_DEVICE_GUIDE=1/0 forces; default
    'auto' = on exactly when the backend is an accelerator, where the
    legacy route's full-matrix readback dominates the guide stage."""
    env = os.environ.get("HISTORIAN_DEVICE_GUIDE", "auto")
    if env == "0":
        return False
    if env == "1":
        return True
    from historian_tpu.ops import devicedp

    return devicedp.accel_backend()


class QuickAligner:
    """Reusable scoring context for one (model, time)."""

    def __init__(self, model: RateModel, time: float, dtype=np.float64):
        self.model = model
        self.time = time
        self.dtype = dtype
        pm = ProbModel(model, time)
        with np.errstate(divide="ignore"):
            submat = np.log(pm.sub_mat[0]) - np.log(pm.ins_vec[0])[None, :]
        self.submat = submat.astype(dtype)

        gap_prob = pm.ins + (1 - pm.ins) * pm.del_
        no_gap_prob = 1 - gap_prob
        gap_ext = 1.0 / ((pm.ins / gap_prob) / pm.ins_ext + (1 - pm.ins / gap_prob) / pm.del_ext)
        no_gap_ext = 1 - gap_ext

        self.no_gap = math.log(no_gap_prob)
        self.gap_open = math.log(gap_prob) + math.log(no_gap_ext)
        self.gap_extend = math.log(gap_ext)

        self.m2i = math.log(gap_prob)
        self.m2d = math.log(no_gap_prob * gap_prob)
        self.m2m = math.log(no_gap_prob * no_gap_prob)
        self.i2i = math.log(gap_ext)
        self.i2d = math.log(no_gap_ext * gap_prob)
        self.i2m = math.log(no_gap_ext * no_gap_prob)
        self.d2d = math.log(gap_ext)
        self.d2m = math.log(no_gap_ext)

    def _gap_score_vec(self, pos: np.ndarray, seq_len_minus: bool = False) -> np.ndarray:
        """(pos==1 ? noGap : gapOpen + (pos-2)*gapExtend), vectorized."""
        return np.where(pos == 1, self.no_gap, self.gap_open + (pos - 2) * self.gap_extend)

    def align(self, x: FastSeq, y: FastSeq, envelope: DiagonalEnvelope | None = None):
        return QuickAlignResult(self, x, y, envelope)

    def align_batch(self, jobs: "list[tuple[FastSeq, FastSeq, DiagonalEnvelope | None]]", force_batch: bool = False, progress=None):
        """Align many pairs, batching same-bucket DP fills into one vmapped
        device call each (the guide-graph hot path: one dispatch per shape
        bucket instead of one per pair).  `progress(done, total)` is
        called as fills complete."""
        import jax

        if device_guide_enabled():
            return self._align_batch_device(jobs, progress)
        return self._align_batch_host_backend(jobs, force_batch, progress)

    def _align_batch_host_backend(self, jobs, force_batch: bool = False, progress=None):
        """The bucket-vmapped fill on the default backend (serial per
        pair on the CPU backend, where batching only adds compiles)."""
        import jax

        results = [QuickAlignResult(self, x, y, env, defer_fill=True) for x, y, env in jobs]
        if jax.default_backend() == "cpu" and not force_batch:
            # serial backend: batching only adds vmap-compile cost
            for k, r in enumerate(results):
                if progress is not None:
                    progress(k, len(results))
                if not r.trivial:
                    r._run_fill()
            return results
        buckets: dict[tuple[int, int], list[int]] = {}
        for k, r in enumerate(results):
            if not r.trivial:
                buckets.setdefault(r._padded_shape, []).append(k)
        for idxs in buckets.values():
            if len(idxs) == 1:
                results[idxs[0]]._run_fill()
                continue
            # pad the batch to a multiple of 8 so bucket sizes reuse compiles
            b = -(-len(idxs) // 8) * 8
            pick = idxs + [idxs[-1]] * (b - len(idxs))
            emit = np.stack([results[k]._emit_p for k in pick])
            mask = np.stack([results[k]._mask_p for k in pick])
            start = np.stack([results[k]._start_p for k in pick])
            trans = results[idxs[0]]._trans
            mats, inss, dels = _get_batched_fill()(
                jnp.asarray(emit), jnp.asarray(mask), jnp.asarray(start), jnp.asarray(trans)
            )
            mats = np.asarray(mats)
            inss = np.asarray(inss)
            dels = np.asarray(dels)
            for slot, k in enumerate(idxs):
                results[k]._finish(mats[slot], inss[slot], dels[slot])
        return results

    def _align_batch_device(self, jobs, progress=None):
        """Fully device-resident guide stage (ops/guidedp.py): tokens and
        envelope diagonals go up, traceback step codes and scores come
        back; the score matrices never cross the host-device link."""
        import jax

        from historian_tpu.ops.guidedp import guide_align_device

        from historian_tpu.ops import devicedp

        dtype = np.float32 if devicedp.accel_backend() else self.dtype
        results = [
            QuickAlignResult(self, x, y, env, device_route=True) for x, y, env in jobs
        ]
        buckets: dict[tuple[int, int], list[int]] = {}
        for k, r in enumerate(results):
            if not r.trivial:
                buckets.setdefault(r._padded_shape, []).append(k)
        trans = np.array(
            [self.m2m, self.m2i, self.m2d, self.i2i, self.i2m,
             self.i2d, self.d2d, self.d2m, 0.0, 0.0], dtype=dtype,
        )
        gaps = np.array([self.no_gap, self.gap_open, self.gap_extend], dtype=dtype)
        submat = self.submat.astype(dtype)
        done = 0
        total = sum(len(v) for v in buckets.values())
        for (px, py), idxs in buckets.items():
            b = -(-len(idxs) // 8) * 8  # reuse compiles across bucket sizes
            pick = idxs + [idxs[-1]] * (b - len(idxs))
            x_tok = np.full((b, px), -1, dtype=np.int32)
            y_tok = np.full((b, py), -1, dtype=np.int32)
            lut = np.zeros((b, px + py + 1), dtype=bool)
            x_len = np.zeros(b, dtype=np.int32)
            y_len = np.zeros(b, dtype=np.int32)
            for slot, k in enumerate(pick):
                r = results[k]
                x_tok[slot, : r.x_len] = r.x_tok
                y_tok[slot, : r.y_len] = r.y_tok
                x_len[slot], y_len[slot] = r.x_len, r.y_len
                lut[slot, np.asarray(r.envelope.diagonals, dtype=np.int64) + py] = True
            steps, n_steps, x_end, y_end, lead_i, lead_j, score = (
                np.asarray(a)
                for a in guide_align_device(
                    jnp.asarray(x_tok), jnp.asarray(y_tok), jnp.asarray(lut),
                    jnp.asarray(x_len), jnp.asarray(y_len),
                    jnp.asarray(submat), jnp.asarray(trans), jnp.asarray(gaps),
                )
            )
            for slot, k in enumerate(idxs):
                results[k]._finish_device(
                    steps[slot], int(n_steps[slot]), int(x_end[slot]),
                    int(y_end[slot]), int(lead_i[slot]), int(lead_j[slot]),
                    float(score[slot]),
                )
                done += 1
                if progress is not None:
                    progress(done - 1, total)
        return results


class QuickAlignResult:
    def __init__(self, aligner: QuickAligner, x: FastSeq, y: FastSeq, envelope: DiagonalEnvelope | None, defer_fill: bool = False, device_route: bool = False):
        self.aligner = aligner
        self.x = x
        self.y = y
        model = aligner.model
        x_len, y_len = len(x.seq), len(y.seq)
        self.x_len, self.y_len = x_len, y_len
        if envelope is None:
            envelope = DiagonalEnvelope(x_len, y_len).init_full()
        self.envelope = envelope
        self._steps = None  # device-traceback step codes (device route)

        if x_len == 0 or y_len == 0:
            # trivial alignment: the nonempty sequence is one long gap run
            other = max(x_len, y_len)
            self.trivial = True
            self.mat = self.ins = self.del_ = None
            self.end = self.result = (
                0.0 if other == 0 else aligner.gap_open + (other - 2) * aligner.gap_extend
            )
            self.x_end, self.y_end = x_len, y_len
            return
        self.trivial = False

        x_tok = model.alphabet.tokenize(x.seq)
        y_tok = model.alphabet.tokenize(y.seq)
        self.x_tok, self.y_tok = x_tok, y_tok

        if device_route:
            # emit/start/mask are built ON DEVICE from tokens + diagonals
            # (ops/guidedp.py); only the bucket shape is needed here
            self.mat = self.ins = self.del_ = None
            self._padded_shape = (
                -(-x_len // 128) * 128, -(-y_len // 128) * 128
            )
            return

        dtype = aligner.dtype
        # emit[i, j] for i in 1..X, j in 1..Y; 0 where either token invalid
        emit = np.zeros((x_len + 1, y_len + 1), dtype=dtype)
        valid = (x_tok >= 0)[:, None] & (y_tok >= 0)[None, :]
        sub = aligner.submat[np.maximum(x_tok, 0)[:, None], np.maximum(y_tok, 0)[None, :]]
        emit[1:, 1:] = np.where(valid, sub, 0.0)

        ii = np.arange(x_len + 1, dtype=dtype)
        jj = np.arange(y_len + 1, dtype=dtype)
        start_gap = (
            aligner._gap_score_vec(ii)[:, None] + aligner._gap_score_vec(jj)[None, :]
        ).astype(dtype)
        end_i = np.where(ii == x_len, aligner.no_gap, aligner.gap_open + (x_len - ii - 2) * aligner.gap_extend)
        end_j = np.where(jj == y_len, aligner.no_gap, aligner.gap_open + (y_len - jj - 2) * aligner.gap_extend)
        self.end_gap = end_i[:, None] + end_j[None, :]

        mask = envelope.mask()
        trans = np.array(
            [aligner.m2m, aligner.m2i, aligner.m2d, aligner.i2i, aligner.i2m,
             aligner.i2d, aligner.d2d, aligner.d2m, 0.0, 0.0],
            dtype=dtype,
        )
        # bucket shapes to multiples of 128 so repeated guide-alignment
        # calls share jit compilations (out-of-bounds cells carry a False
        # mask, which the fill pins to -inf -- values are unchanged)
        px = -(-(x_len + 1) // 128) * 128
        py = -(-(y_len + 1) // 128) * 128
        emit_p = np.zeros((px, py), dtype=dtype)
        emit_p[: x_len + 1, : y_len + 1] = emit
        mask_p = np.zeros((px, py), dtype=bool)
        mask_p[: x_len + 1, : y_len + 1] = mask
        start_p = np.zeros((px, py), dtype=dtype)
        start_p[: x_len + 1, : y_len + 1] = start_gap
        self.emit = emit
        self._emit_p, self._mask_p, self._start_p = emit_p, mask_p, start_p
        self._trans = trans
        self._padded_shape = (px, py)
        if not defer_fill:
            self._run_fill()

    def _run_fill(self) -> None:
        if os.environ.get("HISTORIAN_DIAG_FILL", "0") == "1" and self._run_fill_diag():
            return
        mats, inss, dels = banded_viterbi_fill(
            jnp.asarray(self._emit_p), jnp.asarray(self._mask_p),
            jnp.asarray(self._start_p), jnp.asarray(self._trans),
        )
        self._finish(np.asarray(mats), np.asarray(inss), np.asarray(dels))

    def _run_fill_diag(self) -> bool:
        """Sparse envelopes: fill in diagonal-band coordinates, O(B*Y)
        instead of O(X*Y), then scatter back to the dense accessors.

        Opt-in (HISTORIAN_DIAG_FILL=1): values agree with the dense fill
        to f64 round-off but not bitwise (XLA may contract the delete
        chain's multiply-add differently between the two formulations),
        so the dense fill stays the default for strict reproducibility.
        Worthwhile when envelopes are narrow (band << X), e.g. long
        near-homologous sequences with -kmatchband."""
        from historian_tpu.ops.pairdp import banded_viterbi_fill_diag

        env = self.envelope
        diags = np.sort(np.asarray(getattr(env, "diagonals", []), dtype=np.int64))
        X, Y = self.x_len, self.y_len
        if len(diags) == 0 or 2 * len(diags) >= X + 1:
            return False  # dense is as cheap (or envelope is full)
        B = len(diags)
        # pad the band/columns so repeated fills share compilations
        Bp = -(-B // 8) * 8
        Yp = -(-(Y + 1) // 128) * 128
        jj = np.arange(Y + 1)[None, :]
        dd = diags[:, None]
        ii = jj + dd  # [B, Y+1]
        in_range = (ii >= 1) & (ii <= X) & (jj >= 1)
        ii_c = np.clip(ii, 0, X)
        emit_b = np.zeros((Bp, Yp))
        start_b = np.full((Bp, Yp), NEG_INF)
        valid_b = np.zeros((Bp, Yp), dtype=bool)
        emit_b[:B, : Y + 1] = np.where(in_range, self.emit[ii_c, jj], 0.0)
        sg = self.aligner._gap_score_vec(np.arange(X + 1, dtype=float))
        sgj = self.aligner._gap_score_vec(np.arange(Y + 1, dtype=float))
        start_b[:B, : Y + 1] = np.where(in_range, sg[ii_c] + sgj[jj], NEG_INF)
        valid_b[:B, : Y + 1] = in_range
        up_idx = np.full(Bp, -1, dtype=np.int32)
        pos = {int(d): k for k, d in enumerate(diags)}
        for k, d in enumerate(diags):
            up_idx[k] = pos.get(int(d) + 1, -1)
        down_ok = np.zeros(Bp, dtype=bool)
        down_ok[1:B] = np.diff(diags) == 1

        dvec = np.zeros(Bp)
        dvec[:B] = diags
        mats_b, inss_b, dels_b = banded_viterbi_fill_diag(
            jnp.asarray(emit_b), jnp.asarray(start_b), jnp.asarray(valid_b),
            jnp.asarray(up_idx), jnp.asarray(down_ok), jnp.asarray(dvec),
            jnp.asarray(self._trans),
        )
        mats_b = np.asarray(mats_b)[:B, : Y + 1]
        inss_b = np.asarray(inss_b)[:B, : Y + 1]
        dels_b = np.asarray(dels_b)[:B, : Y + 1]
        # scatter back into dense [Y+1, X+1] (the dense kernel's layout
        # that _finish transposes)
        dense = [np.full((Y + 1, X + 1), NEG_INF) for _ in range(3)]
        sel = in_range
        jjb = np.broadcast_to(jj, ii.shape)
        for out, band in zip(dense, (mats_b, inss_b, dels_b)):
            out[jjb[sel], ii[sel]] = band[sel]
        self._finish(*dense)
        return True

    def _finish(self, mats: np.ndarray, inss: np.ndarray, dels: np.ndarray) -> None:
        x_len, y_len = self.x_len, self.y_len
        # store [X+1, Y+1] row-major like the reference accessors
        self.mat = mats.T[: x_len + 1, : y_len + 1]
        self.ins = inss.T[: x_len + 1, : y_len + 1]
        self.del_ = dels.T[: x_len + 1, : y_len + 1]

        # best end cell: scan j=1..Y outer, i inner ascending, strict >
        end_scores = self.mat + self.end_gap  # [X+1, Y+1]
        grid = end_scores[1:, 1:].T  # [Y, X] so flat order is (j, i)
        flat = np.argmax(grid)
        best_j, best_i = divmod(flat, x_len)
        self.end = float(grid[best_j, best_i])
        self.x_end, self.y_end = int(best_i) + 1, int(best_j) + 1
        self.result = self.end

    def _finish_device(self, steps: np.ndarray, n_steps: int, x_end: int,
                       y_end: int, lead_i: int, lead_j: int, score: float) -> None:
        """Store the device traceback (ops/guidedp.py outputs): step codes
        end->start, the best end cell, and the (i, j) where the walk hit
        Start.  align_path() decodes these without any score matrix."""
        self._steps = np.asarray(steps[:n_steps])
        self.x_end, self.y_end = x_end, y_end
        self._lead = (lead_i, lead_j)
        self.end = self.result = score

    @property
    def finite(self) -> bool:
        return self.result > NEG_INF / 2

    def align_path(self, row1: int = 0, row2: int = 1) -> AlignPath:
        """Host traceback reproducing reference candidate order."""
        if self.trivial:
            return {
                row1: np.concatenate([np.ones(self.x_len, bool), np.zeros(self.y_len, bool)]),
                row2: np.concatenate([np.zeros(self.x_len, bool), np.ones(self.y_len, bool)]),
            }
        if not self.finite:
            raise ValueError("can't do Viterbi traceback: final score is -infinity")
        if self._steps is not None:
            return self._align_path_from_steps(row1, row2)
        al = self.aligner
        i, j = self.x_end, self.y_end
        state = "M"
        x_steps: list[bool] = [True] * (self.x_len - self.x_end) + [False] * (self.y_len - self.y_end)
        y_steps: list[bool] = [False] * (self.x_len - self.x_end) + [True] * (self.y_len - self.y_end)
        mid_x: list[bool] = []
        mid_y: list[bool] = []
        mat, ins, del_ = self.mat, self.ins, self.del_
        while state != "S":
            if state == "M":
                emit_sc = self.emit[i, j]
                i -= 1
                j -= 1
                mid_x.append(True)
                mid_y.append(True)
                cands = [
                    (mat[i, j] + al.m2m + emit_sc, "M"),
                    (ins[i, j] + al.i2m + emit_sc, "I"),
                    (del_[i, j] + al.d2m + emit_sc, "D"),
                    (self._start_gap(i + 1, j + 1) + emit_sc, "S"),
                ]
            elif state == "I":
                j -= 1
                mid_x.append(False)
                mid_y.append(True)
                cands = [
                    (mat[i, j] + al.m2i, "M"),
                    (ins[i, j] + al.i2i, "I"),
                ]
            else:  # "D"
                i -= 1
                mid_x.append(True)
                mid_y.append(False)
                cands = [
                    (mat[i, j] + al.m2d, "M"),
                    (ins[i, j] + al.i2d, "I"),
                    (del_[i, j] + al.d2d, "D"),
                ]
            best_sc, best_state = NEG_INF * 2, None
            for sc, st in cands:
                if sc > best_sc:
                    best_sc, best_state = sc, st
            state = best_state
        mid_x.reverse()
        mid_y.reverse()
        lead_x = [True] * i + [False] * j
        lead_y = [False] * i + [True] * j
        path: AlignPath = {
            row1: np.array(lead_x + mid_x + x_steps, dtype=bool),
            row2: np.array(lead_y + mid_y + y_steps, dtype=bool),
        }
        assert int(path[row1].sum()) == self.x_len
        assert int(path[row2].sum()) == self.y_len
        return path

    def _align_path_from_steps(self, row1: int, row2: int) -> AlignPath:
        """Decode the device traceback's step codes into the same
        AlignPath the host walk builds: leading free gap, the mid
        section (steps arrive end->start, exactly the order the host
        appends before reversing), trailing free gap."""
        steps = self._steps[::-1]  # start -> end
        mid_x = (steps == 0) | (steps == 2)  # M and D consume x
        mid_y = (steps == 0) | (steps == 1)  # M and I consume y
        li, lj = self._lead
        lead_x = np.concatenate([np.ones(li, bool), np.zeros(lj, bool)])
        lead_y = np.concatenate([np.zeros(li, bool), np.ones(lj, bool)])
        tx, ty = self.x_len - self.x_end, self.y_len - self.y_end
        tail_x = np.concatenate([np.ones(tx, bool), np.zeros(ty, bool)])
        tail_y = np.concatenate([np.zeros(tx, bool), np.ones(ty, bool)])
        path: AlignPath = {
            row1: np.concatenate([lead_x, mid_x, tail_x]),
            row2: np.concatenate([lead_y, mid_y, tail_y]),
        }
        assert int(path[row1].sum()) == self.x_len
        assert int(path[row2].sum()) == self.y_len
        return path

    def _start_gap(self, i: int, j: int) -> float:
        al = self.aligner
        si = al.no_gap if i == 1 else al.gap_open + (i - 2) * al.gap_extend
        sj = al.no_gap if j == 1 else al.gap_open + (j - 2) * al.gap_extend
        return si + sj

    def gapped(self) -> list[FastSeq]:
        from historian_tpu.core.alignpath import Alignment

        return Alignment([self.x, self.y], self.align_path()).gapped()
