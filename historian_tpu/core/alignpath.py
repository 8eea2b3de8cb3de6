"""Alignment-path algebra.

Counterpart of the reference's alignpath layer
(/root/reference/src/alignpath.h:9-64): an AlignPath maps row index ->
boolean per-column "emits a residue here" vector.  We store rows as numpy
bool arrays so column reductions (empty-column removal, match counting for
guide envelopes) are vectorized.

The synchronized multi-alignment merge (alignPathMerge,
alignpath.cpp:94-203 in the reference) is reimplemented here as an
anchor-linkage topological merge over (row, residue-index) anchors.
"""

from __future__ import annotations

import numpy as np

from historian_tpu.core.alphabet import GAP_CHARS, is_gap
from historian_tpu.core.seqs import FastSeq

GAP_CHAR = "-"
WILDCARD_CHAR = "*"

# AlignPath = dict[int row, np.ndarray bool of shape [columns]]
AlignPath = dict


def align_path_columns(path: AlignPath) -> int:
    cols = None
    for row, rp in path.items():
        if cols is None:
            cols = len(rp)
        elif cols != len(rp):
            raise ValueError(
                f"alignment path is not flush: row {row} has {len(rp)} columns, expected {cols}"
            )
    return 0 if cols is None else cols


def residues_in_row(row_path: np.ndarray) -> int:
    return int(np.count_nonzero(row_path))


def align_path_union(a1: AlignPath, a2: AlignPath) -> AlignPath:
    out = dict(a1)
    for r, rp in a2.items():
        out.setdefault(r, rp)
    return out


def align_path_concat(*paths: AlignPath) -> AlignPath:
    out: AlignPath = {}
    total = 0
    for p in paths:
        c = align_path_columns(p)
        for r in out:
            if r not in p:
                out[r] = np.concatenate([out[r], np.zeros(c, dtype=bool)])
        for r, rp in p.items():
            prefix = out.get(r)
            if prefix is None:
                prefix = np.zeros(total, dtype=bool)
            out[r] = np.concatenate([prefix, np.asarray(rp, dtype=bool)])
        total += c
    return out


def align_path_remove_empty_columns(path: AlignPath) -> AlignPath:
    if not path:
        return {}
    stacked = np.stack([np.asarray(rp, dtype=bool) for rp in path.values()])
    keep = stacked.any(axis=0)
    return {r: np.asarray(rp, dtype=bool)[keep] for r, rp in path.items()}


def align_path_has_gaps(path: AlignPath) -> bool:
    return any(not np.all(rp) for rp in path.values())


def ensure_align_path_has_row(path: AlignPath, row: int) -> None:
    cols = align_path_columns(path)
    if row not in path:
        path[row] = np.zeros(cols, dtype=bool)


def align_path_string(path: AlignPath) -> str:
    lines = []
    for row in sorted(path):
        body = "".join("*" if b else "-" for b in path[row])
        lines.append(f"{row:4d} {body}")
    return "\n".join(lines) + "\n"


def _native_merge(alignments: list[AlignPath], seq_len: dict[int, int], align_cols: list[int]) -> AlignPath | None:
    """Run the merge through the native runtime (same algorithm compiled;
    output identical -- column emission order and membership are fully
    deterministic). None if the native library is unavailable."""
    from historian_tpu.native import get_native

    lib = get_native()
    if lib is None or not alignments:
        return None
    rows = list(seq_len)  # first-seen order
    dense = {r: i for i, r in enumerate(rows)}
    rows_ptr = np.zeros(len(alignments) + 1, dtype=np.int64)
    cell_ptr = np.zeros(len(alignments) + 1, dtype=np.int64)
    row_ids: list[int] = []
    mats: list[np.ndarray] = []
    for n, a in enumerate(alignments):
        for r, rp in a.items():
            row_ids.append(dense[r])
            mats.append(np.asarray(rp, dtype=np.uint8))
        rows_ptr[n + 1] = len(row_ids)
        cell_ptr[n + 1] = cell_ptr[n] + len(a) * align_cols[n]
    cells = (
        np.concatenate([m for m in mats]) if mats else np.zeros(0, dtype=np.uint8)
    )
    total_cols = int(sum(align_cols))
    out = np.zeros((len(rows), max(total_cols, 1)), dtype=np.uint8)
    n_out = lib.align_merge(
        len(alignments), rows_ptr, np.array(row_ids, dtype=np.int64),
        np.array(align_cols, dtype=np.int64), cell_ptr,
        np.ascontiguousarray(cells), len(rows),
        np.array([seq_len[r] for r in rows], dtype=np.int64), out,
    )
    if n_out == -1:
        raise ValueError("a merge input has an empty column")
    if n_out == -2:
        raise ValueError("inconsistent alignments: conflicting column linkage")
    if n_out == -3:
        raise ValueError("alignment merge failed: no alignments ready (ordering cycle)")
    return {r: out[dense[r], :n_out].astype(bool) for r in rows}


def align_path_merge(alignments: list[AlignPath]) -> AlignPath:
    """Synchronized merge of alignments sharing rows.

    Each column of each input defines an anchor set {(row, residue#)}.
    Columns from different alignments that share an anchor must become one
    output column; linkage is transitively closed.  Ordering must respect
    every input's column order; inconsistent inputs (cyclic orderings or
    conflicting links) raise ValueError.
    """
    # residue counts per row; verify consistency
    seq_len: dict[int, int] = {}
    align_cols: list[int] = []
    for a in alignments:
        align_cols.append(align_path_columns(a))
        for row, rp in a.items():
            n = residues_in_row(np.asarray(rp, dtype=bool))
            if row in seq_len:
                if seq_len[row] != n:
                    raise ValueError(
                        f"incompatible residue counts for row {row}: {seq_len[row]} != {n}"
                    )
            else:
                seq_len[row] = n

    native = _native_merge(alignments, seq_len, align_cols)
    if native is not None:
        return native

    # (align#, col#) -> {(row, pos)} and (row, pos) -> {(align#, col#)}
    col_anchors: list[list[list[tuple[int, int]]]] = []
    anchor_cols: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for n, a in enumerate(alignments):
        per_col: list[list[tuple[int, int]]] = [[] for _ in range(align_cols[n])]
        for row, rp in a.items():
            # .tolist() gives plain ints (no per-element numpy boxing in
            # the tight append loop below)
            cols_with_residue = np.nonzero(np.asarray(rp, dtype=bool))[0].tolist()
            for pos, col in enumerate(cols_with_residue):
                per_col[col].append((row, pos))
                anchor_cols.setdefault((row, pos), []).append((n, col))
        for col, anchors in enumerate(per_col):
            if not anchors:
                raise ValueError(f"column {col} of alignment {n} is empty")
        col_anchors.append(per_col)

    def linked_columns(n: int, col: int) -> dict[int, int]:
        """Transitive closure of column linkage starting from (n, col)."""
        seen: dict[int, int] = {}
        stack = [(n, col)]
        while stack:
            an, ac = stack.pop()
            if an in seen:
                if seen[an] != ac:
                    raise ValueError(
                        f"inconsistent alignments: alignment {an} columns {seen[an]} and {ac} are linked"
                    )
                continue
            seen[an] = ac
            for row, pos in col_anchors[an][ac]:
                for link in anchor_cols[(row, pos)]:
                    if link[0] not in seen:
                        stack.append(link)
                    elif seen[link[0]] != link[1]:
                        raise ValueError(
                            "inconsistent alignments: conflicting column linkage"
                        )
        return seen

    out_cols: list[set[int]] = []  # each entry: set of rows emitting
    next_col = [0] * len(alignments)
    while True:
        all_done = True
        progressed = False
        for n in range(len(alignments)):
            if next_col[n] >= align_cols[n]:
                continue
            all_done = False
            group = linked_columns(n, next_col[n])
            if all(next_col[an] == ac for an, ac in group.items()):
                rows: set[int] = set()
                for an, ac in group.items():
                    for row, _pos in col_anchors[an][ac]:
                        rows.add(row)
                    next_col[an] += 1
                out_cols.append(rows)
                progressed = True
                break
        if all_done:
            break
        if not progressed:
            raise ValueError("alignment merge failed: no alignments ready (ordering cycle)")

    ncols = len(out_cols)
    out: AlignPath = {row: np.zeros(ncols, dtype=bool) for row in seq_len}
    for c, rows in enumerate(out_cols):
        for row in rows:
            out[row][c] = True
    return out


class Alignment:
    """Ungapped sequences + an AlignPath; converts to/from gapped rows."""

    gap_char = GAP_CHAR
    wildcard_char = WILDCARD_CHAR

    def __init__(self, ungapped: list[FastSeq], path: AlignPath):
        self.ungapped = ungapped
        self.path = path

    @classmethod
    def from_gapped(cls, gapped: list[FastSeq]) -> "Alignment":
        cols = {len(s.seq) for s in gapped}
        if len(cols) > 1:
            raise ValueError("alignment is not flush")
        ungapped = []
        path: AlignPath = {}
        for row, s in enumerate(gapped):
            codes = np.frombuffer(s.seq.encode("latin-1"), dtype=np.uint8)
            mask = (codes != ord("-")) & (codes != ord("."))
            path[row] = mask
            ungapped.append(s.ungapped())
        return cls(ungapped, path)

    def gapped(self) -> list[FastSeq]:
        out = []
        for row, s in enumerate(self.ungapped):
            rp = self.path.get(row)
            if rp is None:
                out.append(FastSeq(name=s.name, comment=s.comment, seq=""))
                continue
            rp = np.asarray(rp, dtype=bool)
            n_res = int(np.count_nonzero(rp))
            codes = np.full(len(rp), ord(GAP_CHAR), dtype=np.uint8)
            codes[rp] = np.frombuffer(s.seq.encode("latin-1"), dtype=np.uint8)[:n_res]
            qual = ""
            if s.has_qual():
                q = np.full(len(rp), ord("!"), dtype=np.uint8)
                q[rp] = np.frombuffer(s.qual.encode("latin-1"), dtype=np.uint8)[:n_res]
                qual = q.tobytes().decode("latin-1")
            out.append(
                FastSeq(
                    name=s.name, comment=s.comment,
                    seq=codes.tobytes().decode("latin-1"), qual=qual,
                )
            )
        return out

    @staticmethod
    def is_gap(c: str) -> bool:
        return c in GAP_CHARS

    @staticmethod
    def is_wildcard(c: str) -> bool:
        return c == WILDCARD_CHAR


class GuideAlignmentEnvelope:
    """Banding by cumulative-match offset between two guide rows.

    in_range(pos1, pos2) tests |cumMatches(col(pos1)) - cumMatches(col(pos2))|
    <= max_distance, with cumulative matches and position->column maps
    precomputed vectorized (reference alignpath.h:43-62).
    """

    def __init__(self, guide: AlignPath | None = None, row1: int = -1, row2: int = -1, max_distance: int = -1):
        self.max_distance = max_distance
        self.row1 = row1
        self.row2 = row2
        if guide is None or max_distance < 0:
            return
        if row1 not in guide or row2 not in guide:
            raise ValueError(f"guide alignment is missing row {row1} or {row2}")
        r1 = np.asarray(guide[row1], dtype=bool)
        r2 = np.asarray(guide[row2], dtype=bool)
        matches = np.concatenate([[0], np.cumsum(r1 & r2)]).astype(np.int32)
        self.cumulative_matches = matches
        self.row1_pos_to_col = np.concatenate([[0], np.nonzero(r1)[0] + 1]).astype(np.int32)
        self.row2_pos_to_col = np.concatenate([[0], np.nonzero(r2)[0] + 1]).astype(np.int32)

    @property
    def initialized(self) -> bool:
        return self.max_distance >= 0

    def in_range(self, pos1: int, pos2: int) -> bool:
        if not self.initialized:
            return True
        d = int(
            self.cumulative_matches[self.row1_pos_to_col[pos1]]
            - self.cumulative_matches[self.row2_pos_to_col[pos2]]
        )
        return abs(d) <= self.max_distance

    def in_range_matrix(self, n1: int, n2: int) -> np.ndarray:
        """Vectorized envelope mask for positions [0..n1) x [0..n2)."""
        if not self.initialized:
            return np.ones((n1, n2), dtype=bool)
        m1 = self.cumulative_matches[self.row1_pos_to_col[:n1]]
        m2 = self.cumulative_matches[self.row2_pos_to_col[:n2]]
        return np.abs(m1[:, None] - m2[None, :]) <= self.max_distance
