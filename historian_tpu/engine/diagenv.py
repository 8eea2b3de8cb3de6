"""K-mer-seeded banded diagonal envelopes for pairwise DP.

Counterpart of the reference's DiagonalEnvelope
(/root/reference/src/diagenv.h:23-155, diagenv.cpp:93-222).  Diagonal
k-mer-match counting is vectorized with numpy; the envelope is exposed to
device kernels as a per-diagonal membership set and a dense [X+1, Y+1]
boolean mask (dense masked cells cost nothing on the vector units, so unlike the
C++ sparse storage the kernel just masks).

Deterministic by design: the reference auto-tunes its k-mer threshold to
the machine's physical RAM (diagenv.cpp:102-195); here the memory budget
is explicit config (default 1 GiB) so runs are reproducible across hosts
(SURVEY.md section 5, "memory-adaptive heuristics must become
deterministic config").
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from historian_tpu.core.seqs import make_kmers

DEFAULT_KMER_LENGTH = 6
DEFAULT_KMER_THRESHOLD = -1  # negative => use memory budget
DEFAULT_BAND_SIZE = 64
from historian_tpu.utils.memsize import physical_memory_bytes

DEFAULT_MAX_SIZE = physical_memory_bytes()  # reference: getMemorySize() (diagenv.cpp:64)
MIN_KMERS_FOR_SPARSE_ENVELOPE = 2


@dataclass
class DiagEnvParams:
    sparse: bool = True
    kmer_len: int = DEFAULT_KMER_LENGTH
    kmer_threshold: int = DEFAULT_KMER_THRESHOLD
    max_size: int = DEFAULT_MAX_SIZE
    band_size: int = DEFAULT_BAND_SIZE


class DiagonalEnvelope:
    """Set of active diagonals d = i - j for a pair of sequences.

    Diagonal convention matches the reference: cell (i, j) with i in
    1..xLen, j in 1..yLen lies on diagonal i - j.
    """

    def __init__(self, x_len: int, y_len: int):
        self.x_len = x_len
        self.y_len = y_len
        self.diagonals: np.ndarray = np.array([], dtype=np.int64)

    @property
    def min_diagonal(self) -> int:
        return 1 - self.y_len

    @property
    def max_diagonal(self) -> int:
        return self.x_len - 1

    def init_full(self) -> "DiagonalEnvelope":
        self.diagonals = np.arange(self.min_diagonal, self.max_diagonal + 1)
        return self

    def init_sparse(
        self,
        x_tokens: np.ndarray,
        y_tokens: np.ndarray,
        alphabet_size: int,
        params: DiagEnvParams = DiagEnvParams(),
        cell_size: int = 24,
    ) -> "DiagonalEnvelope":
        """Seed diagonals by k-mer match counts (vectorized)."""
        k = params.kmer_len
        thr = params.kmer_threshold
        if thr >= 0:
            min_len = MIN_KMERS_FOR_SPARSE_ENVELOPE * (k + thr)
            if self.x_len < min_len or self.y_len < min_len:
                return self.init_full()
        else:
            if self.x_len * self.y_len * cell_size < params.max_size:
                return self.init_full()

        x_kmers = make_kmers(x_tokens, alphabet_size, k)
        y_kmers = make_kmers(y_tokens, alphabet_size, k)
        # join on kmer codes: for each shared code, count diagonal hits
        diag_count: dict[int, int] = {}
        order_y = np.argsort(y_kmers, kind="stable")
        sorted_y = y_kmers[order_y]
        # positions of each x kmer in y via searchsorted
        lo = np.searchsorted(sorted_y, x_kmers, side="left")
        hi = np.searchsorted(sorted_y, x_kmers, side="right")
        for i in range(len(x_kmers)):
            if x_kmers[i] < 0:
                continue
            for idx in range(lo[i], hi[i]):
                j = order_y[idx]
                d = i - j
                diag_count[d] = diag_count.get(d, 0) + 1

        half_band = params.band_size // 2
        diag_size = min(self.x_len, self.y_len) * cell_size

        # group diagonals by count, descending
        by_count: dict[int, list[int]] = {}
        for d, c in diag_count.items():
            by_count.setdefault(c, []).append(d)

        diags: set[int] = {0}
        storage: set[int] = {-1, 0, 1}
        for count in sorted(by_count, reverse=True):
            if thr >= 0 and count < thr:
                break
            more = set(diags)
            more_storage = set(storage)
            for seed in sorted(by_count[count]):
                d_min = max(self.min_diagonal, seed - half_band)
                d_max = min(self.max_diagonal, seed + half_band)
                more.update(range(d_min, d_max + 1))
                more_storage.update(range(d_min - 1, d_max + 2))
            if thr < 0 and len(more_storage) * diag_size >= params.max_size:
                break
            diags = more
            storage = more_storage
        self.diagonals = np.array(sorted(diags), dtype=np.int64)
        return self

    def contains(self, i: int, j: int) -> bool:
        return int(i - j) in set(self.diagonals.tolist())

    def n_cells(self) -> int:
        total = 0
        for d in self.diagonals:
            lo = max(1, 1 + d)
            hi = min(self.x_len, self.y_len + d)
            total += max(0, hi - lo + 1)
        return total

    def mask(self) -> np.ndarray:
        """[X+1, Y+1] bool: True where cell (i, j) is in the envelope
        (row/col 0 excluded -- DP boundary)."""
        # diagonal membership via a lookup table over i-j offsets
        # (np.isin hashes every cell; the LUT is one indexed gather)
        lut = np.zeros(self.x_len + self.y_len + 1, dtype=bool)
        lut[np.asarray(self.diagonals, dtype=np.int64) + self.y_len] = True
        ii = np.arange(self.x_len + 1)[:, None]
        jj = np.arange(self.y_len + 1)[None, :]
        out = lut[(ii - jj) + self.y_len]
        out[0, :] = False
        out[:, 0] = False
        return out
