"""Sufficient statistics for EM rate fitting.

Counterpart of the reference's count structures
(/root/reference/src/model.h:165-229):

- IndelCounts: ins/del open+extend event counts and wait times plus a
  log-likelihood accumulator, walked from parent/child alignment paths.
- EventCounts: alphabet-basis counts (root usage, i->j substitution
  events, diagonal = wait times) with an associative +/* algebra -- this
  algebra is the psum reduction operator for multi-chip EM.
- EigenCounts: eigenbasis complex accumulators filled during the E-step,
  rotated to EventCounts via EigenModel.

The M-step (optimize), conjugate priors (logPrior) and expected complete
log-likelihood match model.cpp:1022-1104.

Note the reference's counts-JSON writer emits no comma between "insTime"
and "delTime" (model.cpp:953-954) and its golden files embed that quirk;
we reproduce it on write and tolerate it on read.
"""

from __future__ import annotations

import json
import math
import re
from typing import IO

import numpy as np
from scipy.special import gammaln

from historian_tpu.core.alphabet import Alphabet
from historian_tpu.models.eigen import EigenModel
from historian_tpu.models.ratemodel import ProbModel, RateModel, decay_wait_time


def log_beta_pdf(prob: float, yes_count: float, no_count: float) -> float:
    """log Beta(prob; yes+1, no+1) (reference logsumexp.cpp:101-103)."""
    a, b = yes_count + 1, no_count + 1
    if prob <= 0 or prob >= 1:
        return -math.inf
    return (
        (a - 1) * math.log(prob)
        + (b - 1) * math.log1p(-prob)
        + gammaln(a + b)
        - gammaln(a)
        - gammaln(b)
    )


def log_gamma_pdf(rate: float, event_count: float, wait_time: float) -> float:
    """log Gamma(rate; shape=events+1, scale=1/waitTime)."""
    a = event_count + 1
    if rate <= 0 or wait_time <= 0:
        return -math.inf
    return (a - 1) * math.log(rate) - rate * wait_time + a * math.log(wait_time) - gammaln(a)


def log_dirichlet_pdf(prob: np.ndarray, count: np.ndarray) -> float:
    alpha = np.asarray(count, dtype=float) + 1
    prob = np.asarray(prob, dtype=float)
    if np.any(prob <= 0):
        return -math.inf
    return float(
        ((alpha - 1) * np.log(prob)).sum() + gammaln(alpha.sum()) - gammaln(alpha).sum()
    )


class IndelCounts:
    def __init__(self, pseudocount: float = 0.0, pseudotime: float = 0.0):
        self.ins = pseudocount
        self.del_ = pseudocount
        self.ins_ext = pseudocount
        self.del_ext = pseudocount
        self.ins_time = pseudotime
        self.del_time = pseudotime
        self.lp = 0.0

    def __iadd__(self, o: "IndelCounts") -> "IndelCounts":
        self.ins += o.ins
        self.del_ += o.del_
        self.ins_ext += o.ins_ext
        self.del_ext += o.del_ext
        self.ins_time += o.ins_time
        self.del_time += o.del_time
        self.lp += o.lp
        return self

    def __imul__(self, w: float) -> "IndelCounts":
        self.ins *= w
        self.del_ *= w
        self.ins_ext *= w
        self.del_ext *= w
        self.ins_time *= w
        self.del_time *= w
        self.lp *= w
        return self

    def copy(self) -> "IndelCounts":
        c = IndelCounts()
        c.__dict__.update(self.__dict__)
        return c

    def add_scaled(self, o: "IndelCounts", w: float) -> None:
        """self += o * w without a temporary."""
        self.ins += o.ins * w
        self.del_ += o.del_ * w
        self.ins_ext += o.ins_ext * w
        self.del_ext += o.del_ext * w
        self.ins_time += o.ins_time * w
        self.del_time += o.del_time * w
        self.lp += o.lp * w

    def accumulate_branch(self, model: RateModel, time: float, parent_path: np.ndarray, child_path: np.ndarray, weight: float = 1.0) -> None:
        """Walk one parent/child alignment-path pair (model.cpp:847-893)."""
        ins_wait = decay_wait_time(model.ins_rate, time)
        del_wait = decay_wait_time(model.del_rate, time)
        pm = ProbModel(model, time)
        state = ProbModel.MATCH
        for p, c in zip(parent_path, child_path):
            if p and c:
                nxt = ProbModel.MATCH
            elif p:
                nxt = ProbModel.DELETE
            elif c:
                nxt = ProbModel.INSERT
            else:
                continue
            if nxt == ProbModel.MATCH:
                if state == nxt:
                    self.ins_time += weight * time
                    self.del_time += weight * time
            elif nxt == ProbModel.INSERT:
                if state == nxt:
                    self.ins_ext += weight
                else:
                    self.ins += weight
                    self.ins_time += weight * ins_wait
            elif nxt == ProbModel.DELETE:
                if state == nxt:
                    self.del_ext += weight
                else:
                    self.del_ += weight
                    self.del_time += weight * del_wait
            self.lp += math.log(pm.trans_prob(state, nxt)) * weight
            state = nxt
        self.lp += math.log(pm.trans_prob(state, ProbModel.END)) * weight

    def accumulate_tree(self, model: RateModel, tree, align_path: dict, weight: float = 1.0) -> None:
        for node in range(tree.n_nodes() - 1):
            self.accumulate_branch(
                model,
                tree.branch_length(node),
                align_path[tree.parent(node)],
                align_path[node],
                weight,
            )

    # JSON: note the reference's missing-comma quirk after insTime
    def to_json_lines(self, indent: int = 0) -> list[str]:
        ind = " " * indent
        return [
            f"{ind}{{",
            f'{ind} "ins": {self.ins:g},',
            f'{ind} "del": {self.del_:g},',
            f'{ind} "insExt": {self.ins_ext:g},',
            f'{ind} "delExt": {self.del_ext:g},',
            f'{ind} "insTime": {self.ins_time:g}',
            f'{ind} "delTime": {self.del_time:g}',
            f"{ind}}}",
        ]

    @classmethod
    def from_json(cls, obj: dict) -> "IndelCounts":
        c = cls()
        c.ins = float(obj["ins"])
        c.del_ = float(obj["del"])
        c.ins_ext = float(obj["insExt"])
        c.del_ext = float(obj["delExt"])
        c.ins_time = float(obj["insTime"])
        c.del_time = float(obj["delTime"])
        return c


def _parse_lenient_json(text: str) -> dict:
    """json.loads with the reference's missing-comma quirk repaired."""
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        fixed = re.sub(r'(:\s*[-+0-9.eE]+)(\s*\n\s*")', r"\1,\2", text)
        return json.loads(fixed)


class EventCounts:
    """Alphabet-basis expected event counts; + and * form the psum algebra."""

    def __init__(self, alphabet: Alphabet, components: int, pseudo: float = 0.0):
        self.alphabet = alphabet
        a = alphabet.size
        self.indel = IndelCounts(pseudo, pseudo)
        self.root_count = np.full((components, a), pseudo, dtype=np.float64)
        self.sub_count = np.full((components, a, a), pseudo, dtype=np.float64)

    @property
    def components(self) -> int:
        return self.root_count.shape[0]

    def copy(self) -> "EventCounts":
        c = EventCounts(self.alphabet, self.components)
        c.indel = self.indel.copy()
        c.root_count = self.root_count.copy()
        c.sub_count = self.sub_count.copy()
        return c

    def __iadd__(self, o: "EventCounts") -> "EventCounts":
        if self.alphabet.symbols != o.alphabet.symbols:
            raise ValueError("alphabets don't match")
        self.indel += o.indel
        self.root_count += o.root_count
        self.sub_count += o.sub_count
        return self

    def __add__(self, o: "EventCounts") -> "EventCounts":
        c = self.copy()
        c += o
        return c

    def __imul__(self, w: float) -> "EventCounts":
        self.indel *= w
        self.root_count *= w
        self.sub_count *= w
        return self

    def optimize(self, model: RateModel, fit_indel_rates: bool = True, fit_subst_rates: bool = True) -> None:
        """M-step: rates = counts/waits, roots normalized, weights = shares
        (model.cpp:1022-1059).  Mutates model in place."""
        if fit_subst_rates:
            ins_norm = self.root_count.sum(axis=1)  # [C]
            model.ins_prob = self.root_count / ins_norm[:, None]
            wait = np.einsum("cii->ci", self.sub_count)  # [C, A] diagonal
            rates = self.sub_count / wait[:, :, None]
            c, a = ins_norm.shape[0], self.root_count.shape[1]
            for cpt in range(c):
                np.fill_diagonal(rates[cpt], 0.0)
                np.fill_diagonal(rates[cpt], -rates[cpt].sum(axis=1))
            model.sub_rate = rates
            model.cpt_weight = ins_norm / ins_norm.sum()
        if fit_indel_rates:
            model.ins_rate = self.indel.ins / self.indel.ins_time
            model.del_rate = self.indel.del_ / self.indel.del_time
            model.ins_ext_prob = self.indel.ins_ext / (self.indel.ins_ext + self.indel.ins)
            model.del_ext_prob = self.indel.del_ext / (self.indel.del_ext + self.indel.del_)

    def log_prior(self, model: RateModel, include_indel_rates: bool = True, include_subst_rates: bool = True) -> float:
        lp = 0.0
        if include_indel_rates:
            lp += log_gamma_pdf(model.ins_rate, self.indel.ins, self.indel.ins_time)
            lp += log_gamma_pdf(model.del_rate, self.indel.del_, self.indel.del_time)
            lp += log_beta_pdf(model.ins_ext_prob, self.indel.ins_ext, self.indel.ins)
            lp += log_beta_pdf(model.del_ext_prob, self.indel.del_ext, self.indel.del_)
        if include_subst_rates:
            a = self.alphabet.size
            for cpt in range(self.components):
                lp += log_dirichlet_pdf(model.ins_prob[cpt], self.root_count[cpt])
                for i in range(a):
                    for j in range(a):
                        if i != j:
                            lp += log_gamma_pdf(
                                model.sub_rate[cpt, i, j],
                                self.sub_count[cpt, i, j],
                                self.sub_count[cpt, i, i],
                            )
        return lp

    def expected_log_likelihood(self, model: RateModel) -> float:
        def xlogy(x, y):
            return x * math.log(y) if x > 0 and y > 0 else 0.0

        ic = self.indel
        lp = (
            -model.ins_rate * ic.ins_time
            + xlogy(ic.ins, model.ins_rate)
            - model.del_rate * ic.del_time
            + xlogy(ic.del_, model.del_rate)
            + xlogy(ic.ins_ext, model.ins_ext_prob)
            + xlogy(ic.ins, 1 - model.ins_ext_prob)
            + xlogy(ic.del_ext, model.del_ext_prob)
            + xlogy(ic.del_, 1 - model.del_ext_prob)
        )
        a = self.alphabet.size
        for cpt in range(self.components):
            for i in range(a):
                exit_i = -model.sub_rate[cpt, i, i]
                lp += xlogy(self.root_count[cpt, i], model.ins_prob[cpt, i])
                lp -= exit_i * self.sub_count[cpt, i, i]
                for j in range(a):
                    if i != j:
                        lp += xlogy(self.sub_count[cpt, i, j], model.sub_rate[cpt, i, j])
        return lp

    # ------------------------------------------------------------------ JSON
    def _sub_component_lines(self, cpt: int, indent: int) -> list[str]:
        ind = " " * indent
        sym = self.alphabet.symbol
        a = self.alphabet.size
        out = [f"{ind}{{", f'{ind} "root":', f"{ind}  {{"]
        for i in range(a):
            sep = "," if i < a - 1 else ""
            out.append(f'{ind}   "{sym(i)}": {self.root_count[cpt, i]:g}{sep}')
        out += [f"{ind}  }},", f'{ind} "sub":', f"{ind}  {{"]
        for i in range(a):
            cells = ", ".join(
                f'"{sym(j)}": {self.sub_count[cpt, i, j]:g}' for j in range(a) if j != i
            )
            sep = "," if i < a - 1 else ""
            out.append(f'{ind}   "{sym(i)}": {{ {cells} }}{sep}')
        out += [f"{ind}  }},", f'{ind} "wait":', f"{ind}  {{"]
        for i in range(a):
            sep = "," if i < a - 1 else ""
            out.append(f'{ind}   "{sym(i)}": {self.sub_count[cpt, i, i]:g}{sep}')
        out += [f"{ind}  }}", f"{ind}}}"]
        return out

    def to_json_string(self) -> str:
        out = ["{", f' "alphabet": "{self.alphabet.symbols}",', ' "indel":']
        out += self.to_indel_lines()
        out[-1] += ","
        out.append(' "sub":')
        if self.components > 1:
            out += ["  {", '   "mixture": [']
            for cpt in range(self.components):
                lines = self._sub_component_lines(cpt, 4)
                if cpt < self.components - 1:
                    lines[-1] += ","
                out += lines
            out += ["   ]", "  },"]
        else:
            lines = self._sub_component_lines(0, 2)
            lines[-1] += ","
            out += lines
        out.append(f' "logLikelihood": {self.indel.lp:g}')
        out.append("}")
        return "\n".join(out) + "\n"

    def to_indel_lines(self) -> list[str]:
        return self.indel.to_json_lines(2)

    def write(self, out: IO[str]) -> None:
        out.write(self.to_json_string())

    @classmethod
    def from_json(cls, obj: dict) -> "EventCounts":
        alphabet = Alphabet(obj["alphabet"])
        a = alphabet.size

        def read_component(jm: dict):
            rc = np.zeros(a)
            sc = np.zeros((a, a))
            root = jm["root"]
            sub = jm["sub"]
            wait = jm["wait"]
            for i in range(a):
                si = alphabet.symbol(i)
                rc[i] = float(root[si])
                sc[i, i] = float(wait[si])
                for j in range(a):
                    if i != j:
                        sc[i, j] = float(sub[si][alphabet.symbol(j)])
            return rc, sc

        sub_block = obj["sub"]
        if isinstance(sub_block.get("mixture"), list):
            parts = [read_component(c) for c in sub_block["mixture"]]
        else:
            parts = [read_component(sub_block)]
        out = cls(alphabet, len(parts))
        out.root_count = np.stack([p[0] for p in parts])
        out.sub_count = np.stack([p[1] for p in parts])
        out.indel = IndelCounts.from_json(obj["indel"])
        out.indel.lp = float(obj.get("logLikelihood", 0.0))
        return out

    @classmethod
    def from_json_string(cls, text: str) -> "EventCounts":
        return cls.from_json(_parse_lenient_json(text))

    @classmethod
    def from_file(cls, path: str) -> "EventCounts":
        with open(path) as f:
            return cls.from_json_string(f.read())


class EigenCounts:
    """Eigenbasis complex count accumulators (E-step working form)."""

    def __init__(self, components: int = 0, alphabet_size: int = 0):
        self.indel = IndelCounts()
        self.root_count = np.zeros((components, alphabet_size), dtype=np.float64)
        self.eigen_count = np.zeros((components, alphabet_size, alphabet_size), dtype=np.complex128)

    @property
    def components(self) -> int:
        return self.root_count.shape[0]

    def copy(self) -> "EigenCounts":
        c = EigenCounts()
        c.indel = self.indel.copy()
        c.root_count = self.root_count.copy()
        c.eigen_count = self.eigen_count.copy()
        return c

    def __iadd__(self, o: "EigenCounts") -> "EigenCounts":
        self.indel += o.indel
        if self.components == 0:
            self.root_count = o.root_count.copy()
            self.eigen_count = o.eigen_count.copy()
        elif o.components > 0:
            self.root_count += o.root_count
            self.eigen_count += o.eigen_count
        return self

    def __add__(self, o: "EigenCounts") -> "EigenCounts":
        c = self.copy()
        c += o
        return c

    def __imul__(self, w: float) -> "EigenCounts":
        self.indel *= w
        self.root_count *= w
        self.eigen_count *= w
        return self

    def add_scaled(self, o: "EigenCounts", w: float) -> None:
        """self += o * w in one array pass per field (hot accumulation
        loops; avoids the copy/scale/add temporaries of `+= o * w`)."""
        self.indel.add_scaled(o.indel, w)
        if o.components > 0:
            if self.components == 0:
                self.root_count = o.root_count * w
                self.eigen_count = o.eigen_count * w
            else:
                self.root_count += o.root_count * w
                self.eigen_count += o.eigen_count * w

    def transform(self, model: RateModel) -> EventCounts:
        """Rotate to alphabet basis -> EventCounts (model.cpp:924-931)."""
        eigen = EigenModel(model)
        out = EventCounts(model.alphabet, model.components)
        out.indel = self.indel.copy()
        out.root_count = self.root_count.copy()
        out.sub_count = eigen.sub_counts_from_eigen_counts(self.eigen_count)
        return out

    def accumulate_counts(self, model: RateModel, alignment, tree, update_indel_counts: bool = True, update_subst_counts: bool = True, weight: float = 1.0) -> None:
        """E-step accumulation from a complete (reconstructed) alignment."""
        if update_indel_counts:
            self.indel.accumulate_tree(model, tree, alignment.path, weight)
        if update_subst_counts:
            from historian_tpu.engine.sumprod import accumulate_alignment_eigen_counts

            accumulate_alignment_eigen_counts(self, model, tree, alignment.gapped(), weight)
