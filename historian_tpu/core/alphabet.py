"""Alphabets and tokenization.

Counterpart of the reference's AlphabetOwner
(/root/reference/src/model.h:21-41): an ordered symbol set with a wildcard
character, mapping characters <-> integer tokens.  Tokenization here is
vectorized (numpy lookup tables) because on the device whole sequences become
one-hot / integer tensors, not per-character loops.
"""

from __future__ import annotations

import numpy as np

GAP_CHARS = "-."
WILDCARD_CHAR = "*"


def is_gap(c: str) -> bool:
    return c in GAP_CHARS


def is_wildcard(c: str) -> bool:
    return c == WILDCARD_CHAR


class Alphabet:
    """An ordered alphabet with exact-first, case-folded-fallback tokens.

    Mirrors reference semantics (fastseq.cpp:10-16): a character maps to
    its exact position in the alphabet string if present, otherwise to the
    position of its case-swapped form.  This keeps case-sensitive codon
    alphabets ('F' vs 'f' are distinct tokens) and case-insensitive
    nucleotide/amino alphabets both working.
    """

    def __init__(self, symbols: str, wildcard: str = WILDCARD_CHAR):
        if len(set(symbols)) != len(symbols):
            raise ValueError(f"duplicate symbols in alphabet {symbols!r}")
        self.symbols = symbols
        self.wildcard = wildcard
        self._tok: dict[str, int] = {}
        # case-swapped fallbacks first, then exact matches override
        for i, s in enumerate(symbols):
            swapped = s.lower() if s.isupper() else s.upper()
            if swapped not in symbols:
                self._tok[swapped] = i
        for i, s in enumerate(symbols):
            self._tok[s] = i
        # vectorized lookup table over byte values; -1 = invalid
        lut = np.full(256, -1, dtype=np.int32)
        for ch, i in self._tok.items():
            lut[ord(ch)] = i
        self._lut = lut

    @property
    def size(self) -> int:
        return len(self.symbols)

    def tokenize_char(self, c: str) -> int:
        """Token for character c, or -1 if not in the alphabet."""
        return self._tok.get(c, -1)

    def tokenize_or_die(self, c: str) -> int:
        t = self.tokenize_char(c)
        if t < 0:
            raise ValueError(f"character {c!r} is not in alphabet {self.symbols!r}")
        return t

    def is_valid_symbol(self, c: str) -> bool:
        return c in self._tok

    def symbol(self, tok: int) -> str:
        return self.symbols[tok]

    def tokenize(self, seq: str) -> np.ndarray:
        """Vectorized tokenization: array of tokens, -1 for invalid chars."""
        b = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
        return self._lut[b]

    def tokenize_bytes(self, codes: np.ndarray) -> np.ndarray:
        """Tokenize an array of latin-1 byte codes (any shape)."""
        return self._lut[codes]

    def tokenize_valid(self, seq: str) -> np.ndarray:
        toks = self.tokenize(seq)
        if np.any(toks < 0):
            bad = seq[int(np.argmax(toks < 0))]
            raise ValueError(f"character {bad!r} is not in alphabet {self.symbols!r}")
        return toks

    def one_hot(self, seq: str, dtype=np.float64) -> np.ndarray:
        """[len, A] one-hot rows; invalid/wildcard chars become all-ones.

        This is the leaf-profile emission semantics of the reference
        (profile.cpp:23-76: wildcard or unrecognized -> uniform absorb).
        """
        toks = self.tokenize(seq)
        out = np.zeros((len(toks), self.size), dtype=dtype)
        valid = toks >= 0
        out[np.arange(len(toks))[valid], toks[valid]] = 1
        out[~valid, :] = 1
        return out

    def detokenize(self, toks) -> str:
        return "".join(self.symbols[t] for t in toks)

    def __repr__(self) -> str:
        return f"Alphabet({self.symbols!r})"
