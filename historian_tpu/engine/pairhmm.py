"""Two-branch composed pair transducer.

Counterpart of the reference's PairHMM
(/root/reference/src/pairhmm.h:8-65, pairhmm.cpp:17-44): the composition
of two single-branch Match/Insert/Delete transducers (left and right
child of an ancestral node) into a 5-live-state machine
{IMM, IMD, IDM, IMI, IIW} plus start/end aliases.  States with
overlapping events (idd, idi, iix) and indistinguishable-gap transitions
(iiw->imd, imi->idm) are dropped, exactly as in the reference.
"""

from __future__ import annotations

import math

import numpy as np

from historian_tpu.models.ratemodel import LogProbModel, ProbModel

IMM, IMD, IDM, IMI, IIW, EEE = 0, 1, 2, 3, 4, 5
TOTAL_STATES = 5
STATE_NAMES = ["IMM", "IMD", "IDM", "IMI", "IIW", "EEE"]


def state_name(s: int, x_at_start: bool = False, y_at_start: bool = False) -> str:
    if s == IMM and x_at_start and y_at_start:
        return "SSS"
    if s == IMI and x_at_start:
        return "SSI"
    if s == IIW and y_at_start:
        return "SIW"
    return STATE_NAMES[s]


class PairHMM:
    def __init__(self, l: ProbModel, r: ProbModel, root_ins_prob: np.ndarray):
        self.l = l
        self.r = r
        self.logl = LogProbModel(l)
        self.logr = LogProbModel(r)
        self.alphabet = l.alphabet
        # logRoot[c, a] = log(root insert prob) + log(cpt weight)
        with np.errstate(divide="ignore"):
            self.log_root = np.log(root_ins_prob) + self.logl.log_cpt_weight[:, None]

        def lg(p: float) -> float:
            return math.log(p) if p > 0 else -math.inf

        l_ins, l_del = l.ins, l.del_
        r_ins, r_del = r.ins, r.del_
        l_ins_ext, l_del_ext = l.ins_ext, l.del_ext
        r_ins_ext, r_del_ext = r.ins_ext, r.del_ext

        self.imm_imi = lg(r_ins)
        self.imm_iiw = lg(l_ins * (1 - r_ins))
        self.imm_imm = lg((1 - l_ins) * (1 - r_ins) * (1 - l_del) * (1 - r_del))
        self.imm_imd = lg((1 - l_ins) * (1 - r_ins) * (1 - l_del) * r_del)
        self.imm_idm = lg((1 - l_ins) * (1 - r_ins) * l_del * (1 - r_del))
        self.imm_eee = lg((1 - l_ins) * (1 - r_ins))

        self.imd_imm = lg((1 - l_ins) * (1 - l_del) * (1 - r_del_ext))
        self.imd_imd = lg((1 - l_ins) * (1 - l_del) * r_del_ext)
        self.imd_idm = lg((1 - l_ins) * l_del * (1 - r_del_ext))
        self.imd_eee = lg((1 - l_ins) * (1 - r_del_ext))

        self.idm_imm = lg((1 - r_ins) * (1 - l_del_ext) * (1 - r_del))
        self.idm_imd = lg((1 - r_ins) * (1 - l_del_ext) * r_del)
        self.idm_idm = lg((1 - r_ins) * l_del_ext * (1 - r_del))
        self.idm_eee = lg((1 - r_ins) * (1 - l_del_ext))

        self.imi_imi = lg(r_ins_ext)
        self.imi_iiw = lg(l_ins * (1 - r_ins_ext))
        self.imi_imm = lg((1 - l_ins) * (1 - r_ins_ext) * (1 - l_del) * (1 - r_del))
        self.imi_imd = lg((1 - l_ins) * (1 - r_ins_ext) * (1 - l_del) * r_del)
        self.imi_eee = lg((1 - l_ins) * (1 - r_ins_ext))

        self.iiw_iiw = lg(l_ins_ext)
        self.iiw_imm = lg((1 - l_ins_ext) * (1 - l_del) * (1 - r_del))
        self.iiw_idm = lg((1 - l_ins_ext) * l_del * (1 - r_del))
        self.iiw_eee = lg((1 - l_ins_ext))

        # dense [6, 6] transition table (source state x dest state)
        t = np.full((6, 6), -np.inf)
        t[IMM, IMM] = self.imm_imm
        t[IMM, IMD] = self.imm_imd
        t[IMM, IDM] = self.imm_idm
        t[IMM, IMI] = self.imm_imi
        t[IMM, IIW] = self.imm_iiw
        t[IMM, EEE] = self.imm_eee
        t[IMD, IMM] = self.imd_imm
        t[IMD, IMD] = self.imd_imd
        t[IMD, IDM] = self.imd_idm
        t[IMD, EEE] = self.imd_eee
        t[IDM, IMM] = self.idm_imm
        t[IDM, IMD] = self.idm_imd
        t[IDM, IDM] = self.idm_idm
        t[IDM, EEE] = self.idm_eee
        t[IMI, IMM] = self.imi_imm
        t[IMI, IMD] = self.imi_imd
        t[IMI, IMI] = self.imi_imi
        t[IMI, IIW] = self.imi_iiw
        t[IMI, EEE] = self.imi_eee
        t[IIW, IMM] = self.iiw_imm
        t[IIW, IDM] = self.iiw_idm
        t[IIW, IIW] = self.iiw_iiw
        t[IIW, EEE] = self.iiw_eee
        self.trans_table = t

    @property
    def components(self) -> int:
        return self.l.components

    @property
    def alphabet_size(self) -> int:
        return self.alphabet.size

    def lp_trans(self, src: int, dest: int) -> float:
        return self.trans_table[src, dest]

    @staticmethod
    def states() -> list[int]:
        return [IMM, IMD, IDM, IMI, IIW]

    @staticmethod
    def sources(dest: int) -> list[int]:
        if dest in (IMM, EEE):
            return [IMM, IMD, IDM, IMI, IIW]
        if dest == IMD:
            return [IMM, IMD, IDM, IMI]
        if dest == IDM:
            return [IMM, IMD, IDM, IIW]
        if dest == IMI:
            return [IMM, IMI]
        if dest == IIW:
            return [IMM, IIW, IMI]
        return []
