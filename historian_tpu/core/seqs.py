"""Sequence records, FASTA/FASTQ IO and k-mer indexing.

Counterpart of the reference's fastseq layer
(/root/reference/src/fastseq.h:18-86): FastSeq records, gzip-aware FASTA
reading, 50-char-wrapped FASTA writing, duplicate-name detection, and the
k-mer index used to seed banded-diagonal alignment envelopes.  K-mer
counting here is vectorized with numpy (stride tricks over token arrays)
rather than per-position hashing.
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass, field

import numpy as np

FASTA_LINE_WIDTH = 50


@dataclass
class FastSeq:
    name: str
    seq: str
    comment: str = ""
    qual: str = ""

    def __len__(self) -> int:
        return len(self.seq)

    @property
    def length(self) -> int:
        return len(self.seq)

    def has_qual(self) -> bool:
        return len(self.qual) == len(self.seq) and len(self.seq) > 0

    def ungapped(self) -> "FastSeq":
        seq = self.seq.replace("-", "").replace(".", "")
        if self.has_qual():
            keep = [i for i, c in enumerate(self.seq) if c not in "-."]
            qual = "".join(self.qual[i] for i in keep)
        else:
            qual = ""
        return FastSeq(name=self.name, comment=self.comment, seq=seq, qual=qual)


def _open_maybe_gzip(path: str) -> io.TextIOBase:
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def parse_fasta(text: str) -> list[FastSeq]:
    return _parse_fasta_lines(text.splitlines())


def _parse_fasta_lines(lines) -> list[FastSeq]:
    seqs: list[FastSeq] = []
    name = None
    comment = ""
    chunks: list[str] = []
    qual_chunks: list[str] | None = None

    def flush():
        nonlocal name, comment, chunks, qual_chunks
        if name is not None:
            seqs.append(
                FastSeq(
                    name=name,
                    comment=comment,
                    seq="".join(chunks),
                    qual="".join(qual_chunks) if qual_chunks else "",
                )
            )
        name, comment, chunks, qual_chunks = None, "", [], None

    for raw in lines:
        line = raw.rstrip("\n").rstrip("\r")
        if not line:
            continue
        if line.startswith(">") or line.startswith("@"):
            flush()
            header = line[1:].strip()
            parts = header.split(None, 1)
            name = parts[0] if parts else ""
            comment = parts[1] if len(parts) > 1 else ""
        elif line.startswith("+") and name is not None:
            qual_chunks = []
        else:
            if name is None:
                raise ValueError("FASTA parse error: sequence data before header")
            if qual_chunks is not None:
                qual_chunks.append(line)
            else:
                chunks.append(line)
    flush()
    return seqs


def read_fasta(path: str) -> list[FastSeq]:
    with _open_maybe_gzip(path) as f:
        return _parse_fasta_lines(f)


def format_fasta(seqs: list[FastSeq], width: int = FASTA_LINE_WIDTH) -> str:
    out: list[str] = []
    for s in seqs:
        header = f">{s.name}"
        if s.comment:
            header += f" {s.comment}"
        out.append(header)
        for i in range(0, max(len(s.seq), 1), width):
            chunk = s.seq[i : i + width]
            if chunk or i == 0:
                out.append(chunk)
    return "\n".join(out) + "\n"


def write_fasta(seqs: list[FastSeq], path_or_file, width: int = FASTA_LINE_WIDTH) -> None:
    text = format_fasta(seqs, width)
    if hasattr(path_or_file, "write"):
        path_or_file.write(text)
    else:
        with open(path_or_file, "w") as f:
            f.write(text)


def check_unique_names(seqs: list[FastSeq]) -> None:
    seen: set[str] = set()
    for s in seqs:
        if s.name in seen:
            raise ValueError(f"duplicate sequence name {s.name!r}")
        seen.add(s.name)


def make_kmers(tokens: np.ndarray, alphabet_size: int, k: int) -> np.ndarray:
    """Vectorized k-mer codes for every position; -1 where any token invalid.

    kmer code at position i covers tokens[i : i+k], big-endian in the
    alphabet radix (reference makeKmer semantics, fastseq.h:78-84).
    Returns an array of length len(tokens) - k + 1 (empty if too short).
    """
    n = len(tokens) - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.int64)
    windows = np.lib.stride_tricks.sliding_window_view(tokens.astype(np.int64), k)
    valid = np.all(windows >= 0, axis=1)
    radix = alphabet_size ** np.arange(k - 1, -1, -1, dtype=np.int64)
    codes = (np.maximum(windows, 0) * radix).sum(axis=1)
    codes[~valid] = -1
    return codes


@dataclass
class KmerIndex:
    """kmer code -> sorted positions, built vectorized."""

    k: int
    alphabet_size: int
    positions: dict[int, np.ndarray] = field(default_factory=dict)

    @classmethod
    def build(cls, tokens: np.ndarray, alphabet_size: int, k: int) -> "KmerIndex":
        codes = make_kmers(tokens, alphabet_size, k)
        idx = cls(k=k, alphabet_size=alphabet_size)
        order = np.argsort(codes, kind="stable")
        sorted_codes = codes[order]
        uniq, starts = np.unique(sorted_codes, return_index=True)
        bounds = np.append(starts[1:], len(sorted_codes))
        for code, lo, hi in zip(uniq, starts, bounds):
            if code >= 0:
                idx.positions[int(code)] = np.sort(order[lo:hi])
        return idx
