"""Stockholm alignment format read/write.

Counterpart of the reference's Stockholm layer
(/root/reference/src/stockholm.h:16-40): gapped rows plus #=GF / #=GC /
#=GR / #=GS annotation maps, with tree embedding via the #=GF NH tag.
The writer reproduces the reference's column-width and blocking rules so
golden outputs match byte-for-byte.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import IO

from historian_tpu.core.alignpath import Alignment, AlignPath
from historian_tpu.core.seqs import FastSeq
from historian_tpu.core.tree import Tree

NH_TAG = "NH"
ID_TAG = "ID"
LP_TAG = "LP"

MIN_CHARS_PER_ROW = 10
DEFAULT_ROW_LENGTH = 80

_SEQ_RE = re.compile(r"^\s*(\S+)\s+(\S+)\s*$")
_GF_RE = re.compile(r"^\s*#=GF\s+(\S+)\s+(\S.*)$")
_GC_RE = re.compile(r"^\s*#=GC\s+(\S+)\s+(\S+)\s*$")
_GR_RE = re.compile(r"^\s*#=GR\s+(\S+)\s+(\S+)\s+(\S+)\s*$")
_GS_RE = re.compile(r"^\s*#=GS\s+(\S+)\s+(\S+)\s+(\S.*)$")
_HASH_RE = re.compile(r"^\s*#.*$")
_DIVIDER_RE = re.compile(r"^\s*//\s*$")


@dataclass
class Stockholm:
    gapped: list[FastSeq] = field(default_factory=list)
    gc: dict[str, str] = field(default_factory=dict)  # gc[tag] = per-column string
    gf: dict[str, list[str]] = field(default_factory=dict)  # gf[tag] = lines
    gr: dict[str, dict[str, str]] = field(default_factory=dict)  # gr[tag][seq] = cols
    gs: dict[str, dict[str, list[str]]] = field(default_factory=dict)  # gs[tag][seq] = lines

    @classmethod
    def parse(cls, text: str) -> "Stockholm":
        out = cls()
        seq: dict[str, str] = {}
        row_names: list[str] = []
        for line in text.splitlines():
            m = _SEQ_RE.match(line)
            if m and not line.lstrip().startswith("#") and not _DIVIDER_RE.match(line):
                name, chunk = m.group(1), m.group(2)
                if name not in seq:
                    row_names.append(name)
                    seq[name] = ""
                seq[name] += chunk
                continue
            m = _GF_RE.match(line)
            if m:
                out.gf.setdefault(m.group(1), []).append(m.group(2))
                continue
            m = _GC_RE.match(line)
            if m:
                out.gc[m.group(1)] = out.gc.get(m.group(1), "") + m.group(2)
                continue
            m = _GR_RE.match(line)
            if m:
                tag_map = out.gr.setdefault(m.group(2), {})
                tag_map[m.group(1)] = tag_map.get(m.group(1), "") + m.group(3)
                continue
            m = _GS_RE.match(line)
            if m:
                out.gs.setdefault(m.group(2), {}).setdefault(m.group(1), []).append(m.group(3))
                continue
            if _DIVIDER_RE.match(line):
                break
            if _HASH_RE.match(line):
                continue
        for name in row_names:
            out.gapped.append(FastSeq(name=name, seq=seq[name]))
        return out

    @classmethod
    def read(cls, fh: IO[str] | str) -> "Stockholm":
        if isinstance(fh, str):
            with open(fh) as f:
                return cls.parse(f.read())
        return cls.parse(fh.read())

    @classmethod
    def read_all(cls, fh: IO[str] | str) -> "list[Stockholm]":
        """All alignments in a possibly multi-block Stockholm file."""
        text = open(fh).read() if isinstance(fh, str) else fh.read()
        out = []
        for chunk in text.split("//"):
            if "# STOCKHOLM" not in chunk:
                continue
            stock = cls.parse(chunk + "//\n")
            if stock.rows:
                out.append(stock)
        return out

    @classmethod
    def from_seqs(cls, seqs: list[FastSeq], tree: Tree | None = None) -> "Stockholm":
        out = cls(gapped=list(seqs))
        if tree is not None:
            out.set_tree(tree)
        return out

    # ------------------------------------------------------------------ trees
    def set_tree(self, tree: Tree, tag: str = NH_TAG) -> None:
        self.gf.setdefault(tag, []).append(tree.to_string())

    def has_tree(self) -> bool:
        return bool(self.gf.get(NH_TAG))

    def get_tree(self) -> Tree:
        return Tree(self.gf[NH_TAG][0])

    # ------------------------------------------------------------------ shape
    @property
    def rows(self) -> int:
        return len(self.gapped)

    @property
    def columns(self) -> int:
        cols = {len(s.seq) for s in self.gapped}
        if len(cols) > 1:
            raise ValueError("alignment is not flush")
        return cols.pop() if cols else 0

    def path(self) -> AlignPath:
        return Alignment.from_gapped(self.gapped).path

    # ------------------------------------------------------------------ write
    def to_string(self, chars_per_row: int = DEFAULT_ROW_LENGTH) -> str:
        out: list[str] = []
        cols = self.columns
        names = {fs.name for fs in self.gapped}
        w = max([len(fs.name) for fs in self.gapped] or [0])
        nw = tw = 0
        for tag in self.gf:
            w = max(w, len(tag) + 5)
        for tag, colstr in self.gc.items():
            w = max(w, len(tag) + 5)
            cols = max(cols, len(colstr))
        for tag, by_name in self.gs.items():
            tw = max(tw, len(tag))
            for name in by_name:
                nw = max(nw, len(name))
        for tag, by_name in self.gr.items():
            tw = max(tw, len(tag))
            for name, colstr in by_name.items():
                nw = max(nw, len(name))
                cols = max(cols, len(colstr))
        if tw > 0:
            w = max(w, nw + tw + 6)

        out.append("# STOCKHOLM 1.0")
        for tag in sorted(self.gf):
            for line in self.gf[tag]:
                out.append(f"#=GF {tag:<{w - 5}} {line}")
        for tag in sorted(self.gs):
            by_name = self.gs[tag]
            for fs in self.gapped:
                if fs.name in by_name:
                    for line in by_name[fs.name]:
                        out.append(f"#=GS {fs.name:<{nw + 1}}{tag:<{tw + 1}}{line}")
            for name in sorted(by_name):
                if name not in names:
                    for line in by_name[name]:
                        out.append(f"#=GS {name:<{nw + 1}}{tag:<{tw + 1}}{line}")

        col_step = max(MIN_CHARS_PER_ROW, chars_per_row - w - 1) if chars_per_row > 0 else cols
        col = 0
        block = 0
        while block == 0 or col < cols:
            for tag in sorted(self.gc):
                if block == 0 or col < len(self.gc[tag]):
                    out.append(f"#=GC {tag:<{w - 5}} {self.gc[tag][col:col + col_step]}")
            for fs in self.gapped:
                if block == 0 or col < len(fs.seq):
                    out.append(f"{fs.name:<{w + 1}}{fs.seq[col:col + col_step]}")
                for tag in sorted(self.gr):
                    if fs.name in self.gr[tag]:
                        colstr = self.gr[tag][fs.name]
                        if block == 0 or col < len(colstr):
                            out.append(
                                f"#=GR {fs.name:<{nw + 1}}{tag:<{tw + 1}}{colstr[col:col + col_step]}"
                            )
            for tag in sorted(self.gr):
                for name in sorted(self.gr[tag]):
                    if name not in names:
                        colstr = self.gr[tag][name]
                        if block == 0 or col < len(colstr):
                            out.append(
                                f"#=GR {name:<{nw + 1}}{tag:<{tw + 1}}{colstr[col:col + col_step]}"
                            )
            if col + col_step < cols:
                out.append("")
            block += 1
            col += col_step
        out.append("//")
        return "\n".join(out) + "\n"

    def write(self, fh: IO[str], chars_per_row: int = DEFAULT_ROW_LENGTH) -> None:
        fh.write(self.to_string(chars_per_row))
