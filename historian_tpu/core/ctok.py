"""Codon <-> single-character tokenization for codon-level models.

Counterpart of the reference's CodonTokenizer
(/root/reference/src/ctok.h:7-45).  The token characters themselves are
fixed interoperability data: the reference's ECM codon model files encode
their 61-codon alphabet with these exact single-character tokens, so any
compatible implementation must use the same table.
"""

from __future__ import annotations

# token char -> lowercase DNA codon (universal genetic code)
TOKEN_TO_CODON: dict[str, str] = {
    "K": "aaa", "n": "aac", "k": "aag", "N": "aat",
    "~": "aca", "t": "acc", "`": "acg", "T": "act",
    "3": "aga", "#": "agc", "]": "agg", "%": "agt",
    "|": "ata", "i": "atc", "M": "atg", "I": "att",
    "Q": "caa", "h": "cac", "q": "cag", "H": "cat",
    ",": "cca", "p": "ccc", "8": "ccg", "P": "cct",
    "=": "cga", "r": "cgc", "}": "cgg", "R": "cgt",
    "{": "cta", "[": "ctc", "/": "ctg", "<": "ctt",
    "E": "gaa", "d": "gac", "e": "gag", "D": "gat",
    "4": "gca", "a": "gcc", "&": "gcg", "A": "gct",
    "9": "gga", "g": "ggc", "6": "ggg", "G": "ggt",
    "^": "gta", "v": "gtc", "7": "gtg", "V": "gtt",
    "0": "taa", "y": "tac", "1": "tag", "Y": "tat",
    "5": "tca", "s": "tcc", "$": "tcg", "S": "tct",
    "2": "tga", "c": "tgc", "W": "tgg", "C": "tgt",
    "L": "tta", "f": "ttc", "l": "ttg", "F": "ttt",
    "-": "---", "*": "***",
}

STOP_TOKENS = frozenset("012")


class CodonTokenizer:
    def __init__(self):
        self.tok2cod = dict(TOKEN_TO_CODON)
        self.cod2tok: dict[str, str] = {}
        for tok, cod in TOKEN_TO_CODON.items():
            self.cod2tok[cod] = tok
            self.cod2tok[cod.replace("t", "u")] = tok  # RNA spelling

    def is_stop_token(self, tok: str) -> bool:
        return tok in STOP_TOKENS

    def tokenize(self, gapped_seq: str, allow_stop_codons: bool = False, name: str = "") -> str:
        if len(gapped_seq) % 3 != 0:
            raise ValueError(
                f"can't codon-tokenize {name}: length {len(gapped_seq)} is not a multiple of 3"
            )
        out = []
        for pos in range(0, len(gapped_seq), 3):
            cod = gapped_seq[pos : pos + 3].lower()
            if cod not in self.cod2tok:
                raise ValueError(f"unknown codon {cod!r} at position {pos} in {name}")
            tok = self.cod2tok[cod]
            if not allow_stop_codons and self.is_stop_token(tok):
                if pos + 3 == len(gapped_seq):
                    continue  # silently drop terminal stop codon
                raise ValueError(f"illegal stop codon {cod!r} at position {pos} in {name}")
            out.append(tok)
        return "".join(out)

    def detokenize(self, tok_seq: str) -> str:
        out = []
        for tok in tok_seq:
            if tok not in self.tok2cod:
                raise ValueError(f"can't detokenize {tok!r}")
            out.append(self.tok2cod[tok])
        return "".join(out)

    def tokenize_seqs(self, seqs, allow_stop_codons: bool = False):
        from historian_tpu.core.seqs import FastSeq

        return [
            FastSeq(name=s.name, comment=s.comment, seq=self.tokenize(s.seq, allow_stop_codons, s.name))
            for s in seqs
        ]

    def detokenize_seqs(self, seqs):
        from historian_tpu.core.seqs import FastSeq

        return [
            FastSeq(name=s.name, comment=s.comment, seq=self.detokenize(s.seq)) for s in seqs
        ]

    def token_alphabet(self, allow_stop_codons: bool = False) -> str:
        dna = "tcag"
        alph = []
        for b0 in dna:
            for b1 in dna:
                for b2 in dna:
                    tok = self.cod2tok[b0 + b1 + b2]
                    if allow_stop_codons or not self.is_stop_token(tok):
                        alph.append(tok)
        return "".join(alph)

    def assert_alphabet_tokenized(self, alphabet: str) -> None:
        for c in alphabet:
            if c not in self.tok2cod:
                raise ValueError(f"character {c!r} is not a tokenized codon")


codon_tokenizer = CodonTokenizer()
