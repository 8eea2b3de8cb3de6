"""Reconstruction orchestrator: the framework's workflow engine.

Counterpart of the reference's Reconstructor
(/root/reference/src/recon.h:29-160): dataset loading with format
autodetection, model loading with overrides, guide alignment, tree
estimation, the postorder progressive transducer merge with
band-doubling retry, ancestral prediction, EM fitting with the
count/sum MapReduce algebra, and all output writers.
"""

from __future__ import annotations

import math
import re
import sys
from dataclasses import dataclass, field

import numpy as np

from historian_tpu.core.alignpath import (
    AlignPath,
    Alignment,
    align_path_columns,
    align_path_has_gaps,
    residues_in_row,
)
from historian_tpu.core.ctok import codon_tokenizer
from historian_tpu.core.nexus import NexusData
from historian_tpu.core.seqs import FastSeq, format_fasta, read_fasta
from historian_tpu.core.stockholm import ID_TAG, LP_TAG, NH_TAG, Stockholm
from historian_tpu.core.tree import Tree
from historian_tpu.engine import treealign
from historian_tpu.engine.diagenv import DiagEnvParams
from historian_tpu.engine.forward import (
    COLLAPSE_CHAINS,
    COUNT_INDEL_EVENTS,
    COUNT_SUBST_EVENTS,
    INCLUDE_BEST_TRACE,
    KEEP_GAPS_OPEN,
    BackwardMatrix,
    ForwardMatrix,
)
from historian_tpu.engine.pairhmm import PairHMM
from historian_tpu.engine.profile import Profile
from historian_tpu.engine.span import AlignGraph
from historian_tpu.engine.sumprod import SumProductEngine
from historian_tpu.models.counts import EigenCounts, EventCounts
from historian_tpu.models.gamma import make_discretized_gamma_model
from historian_tpu.models.presets import DEFAULT_AMINO_MODEL, DEFAULT_CODON_MODEL, named_model
from historian_tpu.models.ratemodel import ProbModel, RateModel
from historian_tpu.utils.logging import log_this_at
from historian_tpu.utils.rng import DEFAULT_SEED, MT19937

DEFAULT_PROFILE_SAMPLES = 10
DEFAULT_MAX_DISTANCE_FROM_GUIDE = 20
DEFAULT_MAX_EM_ITERATIONS = 100
DEFAULT_MIN_EM_IMPROVEMENT = 0.001
DEFAULT_MCMC_SAMPLES_PER_SEQ = 100
DEFAULT_SIMULATOR_ROOT_SEQ_LEN = 100
ANCESTRAL_POST_PROB_TAG = "PP"

# RAM-derived profile cap (maxProfileStates = sqrt(frac * RAM / cellSize),
# recon.cpp:78); HISTORIAN_MEMSIZE overrides the probe for reproducibility
from historian_tpu.utils.memsize import physical_memory_bytes

DEFAULT_DP_MEMORY_BYTES = physical_memory_bytes()
DP_CELL_SIZE = 40
#: bucket shapes already warmed by _prefetch_device_programs (per process)
_PREFETCHED_BUCKETS: set = set()
#: smallest full-grid state-cell count worth warming executables for
PREFETCH_MIN_CELLS = 2e7


@dataclass
class Dataset:
    name: str = ""
    tree: Tree | None = None
    seqs: list[FastSeq] = field(default_factory=list)
    gapped_guide: list[FastSeq] = field(default_factory=list)
    gapped_recon: list[FastSeq] = field(default_factory=list)
    gapped_ancestral_recon: list[FastSeq] = field(default_factory=list)
    ancestral_post_prob: dict = field(default_factory=dict)
    guide: AlignPath = field(default_factory=dict)
    seq_index: dict[str, int] = field(default_factory=dict)
    node_to_seq_index: dict[int, int] = field(default_factory=dict)
    row_name: list[str] = field(default_factory=list)
    closest_leaf: list[int] = field(default_factory=list)
    closest_leaf_distance: list[float] = field(default_factory=list)
    reconstruction: Alignment | None = None
    eigen_counts: EigenCounts = field(default_factory=EigenCounts)

    def has_reconstruction(self) -> bool:
        return bool(self.gapped_recon)

    def init_guide(self, gapped: list[FastSeq]) -> None:
        self.gapped_guide = gapped
        align = Alignment.from_gapped(gapped)
        self.guide = align.path
        self.seqs = align.ungapped

    def prepare_recon(self, recon: "Reconstructor") -> None:
        """Reorder rows to tree nodes, compute closest leaves
        (recon.cpp:864-915)."""
        self.tree.validate_branch_lengths()
        for n, s in enumerate(self.seqs):
            if s.name in self.seq_index:
                raise ValueError(f"duplicate sequence name {s.name}")
            self.seq_index[s.name] = n
        self.tree.assert_binary()
        reordered_guide: AlignPath = {}
        for node in range(self.tree.n_nodes()):
            if self.tree.is_leaf(node):
                name = self.tree.node_name(node)
                if not name:
                    raise ValueError(f"leaf node {node} is unnamed")
                if name not in self.seq_index:
                    raise KeyError(f"can't find sequence for leaf node {name}")
                seqidx = self.seq_index[name]
                self.node_to_seq_index[node] = seqidx
                if self.guide:
                    reordered_guide[node] = self.guide[seqidx]
                self.closest_leaf.append(node)
                self.closest_leaf_distance.append(0.0)
            else:
                cl, dcl = -1, 0.0
                for nc, c in enumerate(self.tree.children(node)):
                    dc = self.closest_leaf_distance[c] + self.tree.branch_length(c)
                    if nc == 0 or dc < dcl:
                        cl = self.closest_leaf[c]
                        dcl = dc
                self.closest_leaf.append(cl)
                self.closest_leaf_distance.append(dcl)
            self.row_name.append(self.tree.seq_name(node))
        self.guide = reordered_guide


FORMAT_FASTA = "fasta"
FORMAT_GAPPED_FASTA = "gapped-fasta"
FORMAT_NEXUS = "nexus"
FORMAT_STOCKHOLM = "stockholm"
FORMAT_NEWICK = "newick"
FORMAT_JSON = "json"
FORMAT_UNKNOWN = "unknown"


def detect_format(path: str) -> str:
    """First-line heuristics + gap scan (recon.cpp:1441-1480)."""
    with open(path) as f:
        text = f.read(1 << 20)
    first = ""
    for line in text.splitlines():
        if line.strip():
            first = line
            break
    if re.match(r"^\s*#\s*STOCKHOLM", first):
        return FORMAT_STOCKHOLM
    if re.match(r"^\s*#\s*NEXUS", first, re.IGNORECASE) or first.strip().upper() == "#NEXUS":
        return FORMAT_NEXUS
    if re.match(r"^\s*\{", first):
        return FORMAT_JSON
    if re.match(r"^\s*\(", first):
        return FORMAT_NEWICK
    if re.match(r"^\s*>", first):
        seqs = read_fasta(path)
        if any("-" in s.seq or "." in s.seq for s in seqs):
            return FORMAT_GAPPED_FASTA
        return FORMAT_FASTA
    return FORMAT_UNKNOWN


class Reconstructor:
    def __init__(self):
        self.profile_samples = DEFAULT_PROFILE_SAMPLES
        self.profile_node_limit = 0
        self.profile_min_len = 0
        self.profile_max_len = 1 << 62
        self.dp_memory_bytes = DEFAULT_DP_MEMORY_BYTES
        self.max_dp_memory_fraction = 0.05
        self.rnd_seed = DEFAULT_SEED
        self.max_distance_from_guide = DEFAULT_MAX_DISTANCE_FROM_GUIDE
        self.tokenize_codons = False
        self.guide_align_try_all_pairs = False
        self.use_upgma = True
        self.jukes_cantor_distance_matrix = False
        self.include_best_trace_in_profile = True
        self.keep_gaps_open = False
        self.use_posteriors_for_profile = False
        self.reconstruct_root = True
        self.refine_reconstruction = False
        self.accumulate_subst_counts = False
        self.accumulate_indel_counts = False
        self.predict_ancestral_sequence = False
        self.report_ancestral_sequence_probability = False
        self.got_prior = False
        self.use_laplace_pseudocounts = True
        self.min_post_prob = 0.0
        self.max_em_iterations = DEFAULT_MAX_EM_ITERATIONS
        self.min_em_improvement = DEFAULT_MIN_EM_IMPROVEMENT
        self.run_mcmc = False
        self.fix_tree_mcmc = False
        self.fix_align_mcmc = False
        self.fix_guide_mcmc = False
        self.mcmc_samples_per_seq = DEFAULT_MCMC_SAMPLES_PER_SEQ
        self.mcmc_trace_filename = ""
        self.checkpoint_filename = ""
        self.checkpoint_every = 100  # MCMC steps between snapshots
        self.output_format = FORMAT_STOCKHOLM
        self.output_leaves_only = False
        self.simulator_root_seq_len = -1
        self.gamma_categories = 0
        self.gamma_shape = 1.0
        self.normalize_model = False
        self.fit_subst_rates = True
        self.fit_indel_rates = True

        self.dot_save_filename = ""
        self.use_posteriors_for_dot = False
        self.min_dot_post_prob = 0.01
        self.keep_dot_gaps_open = False
        self.use_separate_sub_posteriors_for_dot = False
        self.min_dot_sub_post_prob = 0.01
        self.model_filename = ""
        self.preset_model_name = ""
        self.model_save_filename = ""
        self.guide_save_filename = ""
        self.tree_filename = ""
        self.tree_root = ""
        self.model_param: dict[str, float] = {}
        self.seq_filenames: list[str] = []
        self.fasta_guide_filenames: list[str] = []
        self.nexus_guide_filenames: list[str] = []
        self.stockholm_guide_filenames: list[str] = []
        self.fasta_recon_filename = ""
        self.nexus_recon_filenames: list[str] = []
        self.stockholm_recon_filenames: list[str] = []
        self.count_filenames: list[str] = []
        self.simulator_tree_filenames: list[str] = []

        self.diag_env_params = DiagEnvParams()
        self.model: RateModel | None = None
        self.datasets: list[Dataset] = []
        self.prior_counts: EventCounts | None = None
        self.data_counts: EventCounts | None = None
        self.data_plus_prior_counts: EventCounts | None = None
        self.generator = MT19937(self.rnd_seed)

    # ------------------------------------------------------------------ model
    def seed_generator(self) -> None:
        self.generator = MT19937(self.rnd_seed)

    def max_profile_states(self) -> int:
        if self.profile_node_limit:
            return int(self.profile_node_limit)
        return int(math.sqrt(self.max_dp_memory_fraction * self.dp_memory_bytes / DP_CELL_SIZE))

    def load_model(self) -> None:
        if self.preset_model_name:
            self.model = named_model(self.preset_model_name)
        elif self.model_filename:
            self.model = RateModel.from_file(self.model_filename)
        elif self.tokenize_codons:
            self.model = named_model(DEFAULT_CODON_MODEL)
        else:
            self.model = named_model(DEFAULT_AMINO_MODEL)

        if self.normalize_model:
            self.model = self.model.normalize_substitution_rate()

        p = self.model_param
        for attr, key in [
            ("ins_rate", "insrate"), ("del_rate", "delrate"),
            ("ins_ext_prob", "insextprob"), ("del_ext_prob", "delextprob"),
        ]:
            if key in p:
                setattr(self.model, attr, p[key])
        for attr, key in [("ins_ext_prob", "inslen"), ("del_ext_prob", "dellen")]:
            if key in p:
                setattr(self.model, attr, max(0.0, 1.0 - 1.0 / p[key]))
        if "gaprate" in p:
            self.model.ins_rate = self.model.del_rate = p["gaprate"]
        if "gapextprob" in p:
            self.model.ins_ext_prob = self.model.del_ext_prob = p["gapextprob"]
        if "gaplen" in p:
            v = max(0.0, 1.0 - 1.0 / p["gaplen"])
            self.model.ins_ext_prob = self.model.del_ext_prob = v
        sub_scale = p.get("subscale", 1.0) * p.get("scale", 1.0)
        indel_scale = p.get("indelscale", 1.0) * p.get("scale", 1.0)
        if sub_scale != 1.0 or indel_scale != 1.0:
            self.model = self.model.scale_rates(sub_scale, indel_scale)

        if self.gamma_categories > 1:
            self.model = make_discretized_gamma_model(self.model, self.gamma_categories, self.gamma_shape)

        if self.tokenize_codons:
            codon_tokenizer.assert_alphabet_tokenized(self.model.alphabet.symbols)

        self.data_counts = EventCounts(self.model.alphabet, self.model.components)

        if self.model_save_filename:
            with open(self.model_save_filename, "w") as f:
                self.model.write(f)

    # ------------------------------------------------------------------- data
    def new_dataset(self) -> Dataset:
        ds = Dataset(name=f"#{len(self.datasets) + 1}")
        self.datasets.append(ds)
        return ds

    def load_tree(self, dataset: Dataset) -> None:
        if not self.tree_filename:
            raise ValueError("must specify a tree")
        with open(self.tree_filename) as f:
            dataset.tree = Tree(f.read())
        if self.tree_root:
            dataset.tree = dataset.tree.reroot_above(self.tree_root)

    def build_tree(self, dataset: Dataset) -> None:
        if self.run_mcmc and not self.fix_tree_mcmc:
            self.use_upgma = True
        dist = self.model.distance_matrix(
            dataset.gapped_guide,
            0 if self.jukes_cantor_distance_matrix else 100,
        )
        names = [s.name for s in dataset.gapped_guide]
        if self.use_upgma:
            dataset.tree = Tree.upgma(names, dist)
        else:
            dataset.tree = Tree.neighbor_joining(names, dist)

    def load_seqs(self) -> None:
        for fn in self.seq_filenames:
            self._load_one(seq_filename=fn)
        for fn in self.fasta_guide_filenames:
            self._load_one(guide_filename=fn)
        for fn in self.nexus_guide_filenames:
            self._load_one(nexus_filename=fn)
        for fn in self.stockholm_guide_filenames:
            self._load_one(stockholm_filename=fn)

    def _tok(self, seqs: list[FastSeq]) -> list[FastSeq]:
        return codon_tokenizer.tokenize_seqs(seqs) if self.tokenize_codons else seqs

    def _load_one(self, seq_filename="", guide_filename="", nexus_filename="", stockholm_filename="") -> None:
        if stockholm_filename:
            with open(stockholm_filename) as f:
                text = f.read()
            for chunk in _split_stockholm(text):
                stock = Stockholm.parse(chunk)
                if stock.rows == 0:
                    continue
                ds = self.new_dataset()
                ds.name = stockholm_filename
                ds.init_guide(self._tok(stock.gapped))
                if stock.has_tree():
                    ds.tree = stock.get_tree()
                else:
                    self.build_tree(ds)
                ds.prepare_recon(self)
                self._maybe_save_guide(ds)
            return
        ds = self.new_dataset()
        if nexus_filename:
            ds.name = nexus_filename
            nex = NexusData.read(nexus_filename)
            nex.convert_nexus_to_alignment()
            ds.tree = nex.tree
            ds.init_guide(self._tok(nex.gapped))
            ds.prepare_recon(self)
            self._maybe_save_guide(ds)
            return
        if seq_filename:
            ds.name = seq_filename
            ds.seqs = self._tok(read_fasta(seq_filename))
            if self.max_distance_from_guide < 0 and self.tree_filename:
                pass  # no guide needed: unbanded DP with a supplied tree
            else:
                if self.guide_align_try_all_pairs:
                    graph = AlignGraph(ds.seqs, self.model, 1.0, self.diag_env_params, dense=True)
                else:
                    self.seed_generator()
                    graph = AlignGraph(ds.seqs, self.model, 1.0, self.diag_env_params, rng=self.generator)
                align = graph.mst_align()
                ds.guide = align.path
                ds.gapped_guide = align.gapped()
        else:
            ds.name = guide_filename
            guide = read_fasta(guide_filename)
            ds.init_guide(self._tok(guide))
            if not align_path_has_gaps(ds.guide):
                log_this_at(1, f"warning: guide alignment {guide_filename} has no gaps")
        if self.tree_filename:
            self.load_tree(ds)
        else:
            self.build_tree(ds)
        ds.prepare_recon(self)
        self._maybe_save_guide(ds)

    def _maybe_save_guide(self, ds: Dataset) -> None:
        if not (self.guide_save_filename and ds.gapped_guide):
            return
        rows = [
            ds.gapped_guide[ds.node_to_seq_index[node]]
            for node in range(ds.tree.n_nodes())
            if ds.tree.is_leaf(node)
        ]
        with open(self.guide_save_filename, "a") as f:
            self.write_tree_alignment(ds.tree, rows, ds.name, f, False)

    def load_auto(self, path: str) -> None:
        """Format autodetection for bare filenames (-auto)."""
        fmt = detect_format(path)
        if fmt == FORMAT_FASTA:
            self.seq_filenames.append(path)
        elif fmt == FORMAT_GAPPED_FASTA:
            self.fasta_guide_filenames.append(path)
        elif fmt == FORMAT_NEXUS:
            self.nexus_guide_filenames.append(path)
        elif fmt == FORMAT_STOCKHOLM:
            self.stockholm_guide_filenames.append(path)
        elif fmt == FORMAT_NEWICK:
            self.tree_filename = path
        elif fmt == FORMAT_JSON:
            self.model_filename = path
        else:
            raise ValueError(f"can't detect format of {path}")

    def load_recon(self) -> None:
        if self.fasta_recon_filename:
            ds = self.new_dataset()
            ds.name = self.fasta_recon_filename
            self.load_tree(ds)
            ds.gapped_recon = self._tok(read_fasta(self.fasta_recon_filename))
            ds.gapped_recon = ds.tree.reorder_seqs(ds.gapped_recon)
            ds.reconstruction = Alignment.from_gapped(ds.gapped_recon)
            ds.gapped_guide = ds.gapped_recon
        for fn in self.nexus_recon_filenames:
            ds = self.new_dataset()
            ds.name = fn
            nex = NexusData.read(fn)
            nex.convert_nexus_to_alignment()
            ds.tree = nex.tree
            ds.gapped_recon = self._tok(nex.gapped)
            ds.gapped_recon = ds.tree.reorder_seqs(ds.gapped_recon)
            ds.reconstruction = Alignment.from_gapped(ds.gapped_recon)
            ds.gapped_guide = ds.gapped_recon
        for fn in self.stockholm_recon_filenames:
            with open(fn) as f:
                text = f.read()
            for n, chunk in enumerate(_split_stockholm(text)):
                stock = Stockholm.parse(chunk)
                if stock.rows == 0:
                    continue
                if not stock.has_tree():
                    raise ValueError("Stockholm alignment lacks tree")
                ds = self.new_dataset()
                ds.name = f"{fn} alignment #{n + 1}"
                ds.gapped_recon = self._tok(stock.gapped)
                ds.tree = stock.get_tree()
                ds.gapped_recon = ds.tree.reorder_seqs(ds.gapped_recon)
                ds.reconstruction = Alignment.from_gapped(ds.gapped_recon)
                ds.gapped_guide = ds.gapped_recon

    def load_counts(self) -> None:
        if not self.count_filenames:
            self.prior_counts = EventCounts(self.model.alphabet, self.model.components)
        else:
            for i, fn in enumerate(self.count_filenames):
                c = EventCounts.from_file(fn)
                if i == 0:
                    self.prior_counts = c
                else:
                    self.prior_counts += c
                self.got_prior = True
        if self.use_laplace_pseudocounts:
            self.prior_counts += EventCounts(
                self.prior_counts.alphabet, self.prior_counts.components, 1.0
            )
            self.got_prior = True
        self.data_counts = self.prior_counts.copy()

    # ---------------------------------------------------------- reconstruction
    def reconstruct(self, dataset: Dataset) -> None:
        """Postorder progressive transducer merge (recon.cpp:917-1052)."""
        if not self.use_posteriors_for_profile:
            self.seed_generator()
        tree = dataset.tree
        model = self.model
        strategy = COLLAPSE_CHAINS
        if self.keep_gaps_open:
            strategy |= KEEP_GAPS_OPEN
        if self.accumulate_subst_counts:
            strategy |= COUNT_SUBST_EVENTS
        if self.accumulate_indel_counts:
            strategy |= COUNT_INDEL_EVENTS
        if self.include_best_trace_in_profile:
            strategy |= INCLUDE_BEST_TRACE

        sumprod = SumProductEngine(model, tree) if self.accumulate_subst_counts else None

        from historian_tpu.core.alignpath import GuideAlignmentEnvelope

        path: AlignPath = {}
        prof: dict[int, Profile] = {}
        lp_final_fwd = -np.inf

        # ---- schedule: strict postorder with a bounded in-flight merge
        # WINDOW.  Host path: the window drains immediately after each
        # enqueue == the reference's sequential postorder loop
        # (recon.cpp:917-1052).  Device-resident path: a merge's fill is
        # enqueued as soon as BOTH children's profiles exist, and the
        # window advances oldest-first only when (a) a parent needs a
        # child still in flight or (b) the in-flight bytes would exceed
        # the memory budget -- SURVEY §2.7's pp axis (children's
        # profiles stream into their parents' merges, no level barrier)
        # composed with its batch axis (independent in-flight merges
        # overlap in the device queue); with a multi-device `-mesh`,
        # round-robin placement runs them on different chips (dp axis)
        # and long merges route through the SP ring instead
        # (engine/forward._fill_sp), using every device at once.
        from historian_tpu.ops import devicedp
        from historian_tpu.parallel import spmerge

        import contextlib
        import time as _time

        pipelined = devicedp.enabled() and devicedp.trace_enabled()
        if pipelined:
            # overlap the first merges' compiles and program loads with
            # the guide/leaf stage: a daemon thread runs a dummy merge of
            # the PREDICTED first bucket shape through the real device
            # route, so the fill/end-lp/trace programs are resident
            # before the first production dispatch
            self._prefetch_device_programs(dataset, model)
        #: observability: deepest in-flight merge window this run (1 on
        #: the host path; >1 proves cross-level pp streaming engaged)
        self.sched_max_in_flight = 0
        place = spmerge.dp_placement_devices()
        n_placed = 0
        window: list[int] = []  # fill-enqueued merges, oldest first
        window_bytes: dict[int, int] = {}
        armed: set[int] = set()  # lp_end resolved + trace walk enqueued
        fwd_of: dict[int, ForwardMatrix] = {}
        want_bwd_of: dict[int, bool] = {}
        done: set[int] = set()
        #: aggregate in-flight residency cap: every windowed merge holds
        #: device f32 planes or a host f64 cell tensor concurrently.
        #: 1.5x (not 2x) the per-merge admission budget: a fill in
        #: flight ALSO holds absorb+mask transients of its own plane
        #: size, so 2x admitted 2 resident + 1 filling merges at the
        #: budget's largest bucket, and that peak overran a device whose
        #: budget is a fifth of its memory (devicedp.planes_budget_mb).
        #: 1.5x keeps a two-deep window for all but the biggest merges,
        #: whose fills dominate their windows anyway.
        budget = devicedp.trace_planes_mb() * 1.5 * 1e6
        backward_hold: list = [None]

        def _est_bytes(node: int) -> int:
            # worst case of the two fill residencies: device-resident f32
            # planes (bucketed) vs host f64 cell tensor
            l_c, r_c = tree.children(node)
            sx, sy = prof[l_c].size - 1, prof[r_c].size - 1
            return max(
                5 * devicedp._bucket(sx) * devicedp._bucket(sy) * 4,
                (sx + 2) * (sy + 2) * 5 * 8,
            )

        def _arm(node: int) -> None:
            """Resolve lp_end (band-doubling retries rebuild inline,
            recon.cpp:954-975) and enqueue the traceback walk.  A
            device-routed merge consumes ONE mt19937 draw here (arm
            order); a host-routed merge (no trace handle) draws per-cell
            later inside sample_profile, exactly as the reference does
            (golden parity).  Draw order is therefore deterministic only
            GIVEN a fixed routing outcome: when routing depends on
            runtime-measured rates (dispatch probe, observed fill
            rates), the same seed can yield different reconstructions
            across runs.  Pin HISTORIAN_DEVICE_DP / run single-platform
            for seed-stable output (ADVICE r4)."""
            if node in armed:
                return
            fwd = fwd_of[node]
            fwd.dispatch_lp_end()
            if not (fwd.lp_end > -np.inf):
                fwd_of[node], want_bwd_of[node] = self._merge_forward(
                    dataset, tree, model, sumprod, prof, node, block=True,
                    first=fwd,
                )
                fwd = fwd_of[node]
                if node in window_bytes:
                    # the retry rebuilt the merge (doubled or unbounded
                    # band): refresh its residency estimate so the
                    # aggregate window budget stays honest (ADVICE r4)
                    window_bytes[node] = max(
                        5 * devicedp._bucket(fwd.x_size - 1)
                        * devicedp._bucket(fwd.y_size - 1) * 4,
                        (fwd.x_size + 1) * (fwd.y_size + 1) * 5 * 8,
                    )
            if not self.use_posteriors_for_profile and node != tree.root():
                include_best = bool(strategy & INCLUDE_BEST_TRACE)
                # -fast (profmaxstates 1 + best trace): the best trace
                # alone always meets the cell budget, so sample_profile
                # walks zero sampled traces -- prefetch only the best
                # walk (the surplus walks are full sequential device
                # passes) and, like the host path, consume no rng draw
                n_pref = (
                    0 if (self.max_profile_states() == 1 and include_best)
                    else self.profile_samples
                )
                fwd.prefetch_traces(n_pref, include_best, self.generator)
            armed.add(node)

        def _finish_oldest() -> None:
            """Advance the window head through readback + profile build
            (and keep the NEXT head's trace walk in flight meanwhile)."""
            nonlocal lp_final_fwd, path
            node = window.pop(0)
            window_bytes.pop(node, None)
            _t0 = _time.perf_counter()
            _arm(node)
            if window:
                _arm(window[0])
            _t1 = _time.perf_counter()
            forward, want_backward = fwd_of.pop(node), want_bwd_of.pop(node)
            # free the previous BackwardMatrix before readback: a live
            # previous owner makes bufpool fall back to cold storage
            backward_hold[0] = None
            lp_final_fwd, backward_hold[0], new_path = self._merge_profile(
                dataset, tree, model, strategy, prof, node,
                forward, want_backward, lp_final_fwd,
            )
            if new_path is not None:
                path = new_path
            done.add(node)
            if devicedp.TIMING and pipelined:
                import sys as _sys

                _sys.stderr.write(
                    f"[window] node {node} arm={_t1 - _t0:.2f}s "
                    f"readback+surgery={_time.perf_counter() - _t1:.2f}s "
                    f"in-flight={len(window)}\n"
                )

        for node in range(tree.n_nodes()):
            if tree.is_leaf(node):
                prof[node] = Profile.from_sequence(
                    model.components, model.alphabet,
                    dataset.seqs[dataset.node_to_seq_index[node]], node,
                )
                prof[node].name = tree.node_name(node)
                done.add(node)
                continue
            # dependency: drain until both children's profiles exist
            while any(c not in done for c in tree.children(node)):
                _finish_oldest()
            # memory: keep aggregate in-flight residency under budget
            est = _est_bytes(node)
            while window and sum(window_bytes.values()) + est > budget:
                _finish_oldest()
            if place:
                import jax

                ctx = jax.default_device(place[n_placed % len(place)])
                n_placed += 1
            else:
                ctx = contextlib.nullcontext()
            with ctx:
                fwd_of[node], want_bwd_of[node] = self._merge_forward(
                    dataset, tree, model, sumprod, prof, node, block=False
                )
            window.append(node)
            window_bytes[node] = est
            self.sched_max_in_flight = max(self.sched_max_in_flight, len(window))
            fwd_of[node].dispatch_lp_end()
            if not pipelined:
                _finish_oldest()
            elif len(window) > 1:
                # keep the head's trace walk in flight while younger
                # fills stream in behind it
                _arm(window[0])
        while window:
            _finish_oldest()

        log_this_at(2, f"Final Forward log-likelihood is {lp_final_fwd}")

        if self.reconstruct_root:
            dataset.reconstruction = self.make_alignment(dataset, path, tree.root())
            dataset.gapped_recon = dataset.reconstruction.gapped()
            if self.refine_reconstruction:
                self.refine(dataset)

        if self.accumulate_subst_counts:
            self.data_counts += dataset.eigen_counts.transform(model)
        elif self.accumulate_indel_counts:
            self.data_counts.indel += dataset.eigen_counts.indel

    def _prefetch_device_programs(self, dataset, model) -> None:
        """Warm the per-process device executables for the predicted
        first-merge bucket shapes on a daemon thread (HISTORIAN_PREFETCH=0
        disables).  The dummy merge runs the REAL device route (fill +
        end-lp + best-trace walk) over synthetic chains sized to the
        leaf-length buckets, so the compiled programs are exactly the
        production ones; a merge that ends up host-routed or a different
        bucket just ignores the warm load (async, off the critical
        path)."""
        import os
        import threading

        from historian_tpu.ops import devicedp

        if os.environ.get("HISTORIAN_PREFETCH", "1") == "0":
            return
        lens = [len(s.seq) for s in dataset.seqs]
        if not lens:
            return
        buckets = sorted({devicedp._bucket(ln + 1) for ln in lens})[-2:]
        if buckets[-1] * buckets[-1] * 5 < PREFETCH_MIN_CELLS:
            return  # even the biggest full grid cannot win the router
        key = tuple(buckets)
        if key in _PREFETCHED_BUCKETS:
            return
        _PREFETCHED_BUCKETS.add(key)

        def body():
            try:
                from historian_tpu.core.seqs import FastSeq
                from historian_tpu.engine.forward import ForwardMatrix
                from historian_tpu.engine.pairhmm import PairHMM
                from historian_tpu.engine.profile import Profile
                from historian_tpu.models.ratemodel import ProbModel

                rng = np.random.RandomState(0)
                a = model.alphabet
                hmm = PairHMM(
                    ProbModel(model, 0.5), ProbModel(model, 0.5), model.ins_prob
                )
                for b in buckets:
                    seq = lambda nm: FastSeq(name=nm, seq="".join(
                        a.symbol(i) for i in rng.randint(0, a.size, size=b - 1)
                    ))
                    x = Profile.from_sequence(model.components, a, seq("px"), 0)
                    y = Profile.from_sequence(model.components, a, seq("py"), 1)
                    fwd = ForwardMatrix(x, y, hmm, 2)
                    fwd.dispatch_lp_end()
                    if fwd._trace_handle is not None:
                        fwd._device_traces(0, True, None)
                    del fwd
            except Exception:
                pass  # best-effort warm: never fail the reconstruction

        threading.Thread(target=body, daemon=True).start()

    def _merge_forward(self, dataset, tree, model, sumprod, prof, node,
                       block: bool, first=None):
        """Build one internal node's ForwardMatrix.  block=False returns
        after the (possibly async, device-resident) fill is enqueued;
        block=True runs the band-doubling retry loop to a finite lp_end
        (recon.cpp:954-975).  `first` is a zero-likelihood matrix from a
        non-blocking attempt, so the retry starts at the doubled band."""
        from historian_tpu.core.alignpath import GuideAlignmentEnvelope

        l_child, r_child = tree.children(node)
        l_prof, r_prof = prof[l_child], prof[r_child]
        l_probs = ProbModel(model, tree.branch_length(l_child))
        r_probs = ProbModel(model, tree.branch_length(r_child))
        hmm = PairHMM(l_probs, r_probs, model.ins_prob)
        log_this_at(2, f"Aligning node #{l_child} ({l_prof.size} states) and node #{r_child} ({r_prof.size} states) to build profile for node #{node}")

        max_dist = self.max_distance_from_guide
        # when no full-band consumer (BackwardMatrix) will run on this
        # node, the device fill may stay resident with tracebacks
        # walked on device (ops/devicedp.trace_enabled)
        want_backward = (
            (
                self.accumulate_subst_counts
                or self.accumulate_indel_counts
                or self.dot_save_filename
            )
            and node == tree.root()
        ) or (self.use_posteriors_for_profile and node != tree.root())
        if first is not None:
            # resume the retry ladder above the band that just failed
            if dataset.guide and max_dist * 2 > align_path_columns(dataset.guide):
                max_dist = -1
            elif max_dist == 0:
                max_dist = 1
            else:
                max_dist *= 2
            first = None
        while True:
            env = (
                GuideAlignmentEnvelope()
                if not dataset.guide or max_dist < 0
                else GuideAlignmentEnvelope(
                    dataset.guide,
                    dataset.closest_leaf[l_child],
                    dataset.closest_leaf[r_child],
                    max_dist,
                )
            )
            forward = ForwardMatrix(
                l_prof, r_prof, hmm, node, env, sumprod,
                defer_cells=not want_backward,
            )
            if not block:
                return forward, want_backward
            if forward.lp_end > -np.inf:
                return forward, want_backward
            # band-doubling retry (recon.cpp:954-975)
            if max_dist < 0:
                raise RuntimeError(
                    "zero forward likelihood even without guide constraints"
                )
            if dataset.guide and max_dist * 2 > align_path_columns(dataset.guide):
                max_dist = -1
            elif max_dist == 0:
                max_dist = 1
            else:
                max_dist *= 2
            forward = None

    def _merge_profile(self, dataset, tree, model, strategy, prof,
                       node, forward, want_backward, lp_final_fwd):
        """Consume one finished merge: backward pass if needed, profile
        construction, child cleanup.  Returns (lp_final_fwd, backward,
        root_align_path_or_None)."""
        l_child, r_child = tree.children(node)
        new_path = None
        backward = None
        if want_backward:
            backward = BackwardMatrix(forward)

        if node == tree.root():
            if self.dot_save_filename:
                from historian_tpu.engine.seqgraph import SeqGraph

                dot_strategy = INCLUDE_BEST_TRACE | (
                    KEEP_GAPS_OPEN if self.keep_dot_gaps_open else 0
                )
                dot_prof = (
                    backward.post_prob_profile(self.min_dot_post_prob, 0, dot_strategy)
                    if self.use_posteriors_for_dot
                    else backward.best_profile(dot_strategy)
                )
                min_sub = (
                    self.min_dot_sub_post_prob
                    if self.use_separate_sub_posteriors_for_dot
                    else (self.min_dot_post_prob if self.use_posteriors_for_dot else self.min_post_prob)
                )
                with np.errstate(divide="ignore"):
                    graph = SeqGraph.from_profile(
                        dot_prof, model.alphabet.symbols,
                        np.log(model.cpt_weight), np.log(model.ins_prob),
                        min_sub,
                    )
                with open(self.dot_save_filename, "w") as f:
                    f.write(graph.simplify().to_dot())
            if self.reconstruct_root:
                new_path = forward.best_align_path()
                prof[node] = forward.best_profile()
            lp_final_fwd = forward.lp_end
            if self.accumulate_subst_counts or self.accumulate_indel_counts:
                dataset.eigen_counts = backward.get_counts()
        elif self.use_posteriors_for_profile:
            prof[node] = backward.post_prob_profile(
                self.min_post_prob, self.max_profile_states(), strategy
            )
        else:
            prof[node] = forward.sample_profile(
                self.generator, self.profile_samples, self.max_profile_states(), strategy
            )
        # free children
        prof.pop(l_child, None)
        prof.pop(r_child, None)
        return lp_final_fwd, backward, new_path

    def reconstruct_all(self) -> None:
        if not self.datasets:
            raise ValueError("please supply some data")
        for ds in self.datasets:
            self.reconstruct(ds)

    def make_alignment(self, dataset: Dataset, path: AlignPath, root: int) -> Alignment:
        tree = dataset.tree
        ungapped: list[FastSeq] = [FastSeq(name="", seq="") for _ in range(tree.n_nodes())]
        for node in tree.node_and_descendants(root):
            if tree.is_leaf(node):
                ungapped[node] = dataset.seqs[dataset.seq_index[dataset.row_name[node]]]
            else:
                n_res = residues_in_row(np.asarray(path[node]))
                ungapped[node] = FastSeq(name=dataset.row_name[node], seq="*" * n_res)
        return Alignment(ungapped, path)

    def refine(self, dataset: Dataset) -> None:
        from historian_tpu.sampler.refiner import Refiner

        gapped = (
            dataset.gapped_ancestral_recon
            if dataset.gapped_ancestral_recon
            else dataset.gapped_recon
        )
        refiner = Refiner(self.model)
        new_tree, new_gapped = refiner.refine(dataset.tree, gapped)
        dataset.tree = new_tree
        if dataset.gapped_ancestral_recon:
            dataset.gapped_ancestral_recon = new_gapped
        else:
            dataset.gapped_recon = new_gapped

    # ----------------------------------------------------- ancestral prediction
    def predict_ancestors(self, dataset: Dataset) -> None:
        if not self.predict_ancestral_sequence:
            return
        engine = SumProductEngine(self.model, dataset.tree)
        rows = [s.seq for s in dataset.gapped_recon]
        fill = engine.fill(rows)
        anc_rows = fill.ancestral_gapped_rows(rows)
        dataset.gapped_ancestral_recon = [
            FastSeq(name=s.name, comment=s.comment, seq=r)
            for s, r in zip(dataset.gapped_recon, anc_rows)
        ]
        if self.report_ancestral_sequence_probability:
            dataset.ancestral_post_prob = fill.ancestral_post_probs(rows)

    def predict_all_ancestors(self) -> None:
        for ds in self.datasets:
            self.predict_ancestors(ds)

    # ------------------------------------------------------------------ counts
    def count(self, dataset: Dataset) -> None:
        dataset.eigen_counts = EigenCounts(self.model.components, self.model.alphabet_size)
        dataset.eigen_counts.accumulate_counts(
            self.model, dataset.reconstruction, dataset.tree,
            self.accumulate_indel_counts, self.accumulate_subst_counts,
        )
        if self.accumulate_subst_counts:
            self.data_counts += dataset.eigen_counts.transform(self.model)
        elif self.accumulate_indel_counts:
            self.data_counts.indel += dataset.eigen_counts.indel

    def count_all(self) -> None:
        if not self.datasets:
            raise ValueError("please supply some data")
        self.data_counts = EventCounts(self.model.alphabet, self.model.components)
        # Multi-process launches shard DATASETS round-robin and allreduce
        # the partial counts -- the in-memory form of the reference's
        # count-files + `sum` MapReduce (README.md:201-208).  Safe for the
        # reconstruct path too: the generator reseeds per dataset, so each
        # dataset's trajectory is independent of which process runs it.
        # EXCEPT: an aligned dataset under a multi-process -mesh runs a
        # COLLECTIVE column-sharded E-step (in-jit psum over the global
        # mesh) -- every process must participate, and the replicated
        # result must not be reduced a second time.
        nproc, pid = 1, 0
        from historian_tpu.parallel import dist

        if dist.is_initialized():
            import jax

            nproc, pid = jax.process_count(), jax.process_index()
        mesh_collective = False
        if nproc > 1:
            from historian_tpu.parallel.pcounts import active_mesh

            mesh = active_mesh()
            mesh_collective = mesh is not None and (
                len({d.process_index for d in mesh.devices.flat}) > 1
            )

        def is_collective(ds: Dataset) -> bool:
            return mesh_collective and ds.has_reconstruction()

        for ds in self.datasets:
            if is_collective(ds):
                self.count(ds)  # every process; psum replicates the result
        if nproc > 1:
            shared = self.data_counts
            self.data_counts = EventCounts(self.model.alphabet, self.model.components)
            for k, ds in enumerate(self.datasets):
                if is_collective(ds) or k % nproc != pid:
                    continue
                if ds.has_reconstruction():
                    self.count(ds)
                else:
                    self.reconstruct(ds)
            from historian_tpu.parallel.pcounts import allreduce_counts

            self.data_counts = shared + allreduce_counts(
                self.data_counts, self.model.alphabet
            )
        else:
            for ds in self.datasets:
                if ds.has_reconstruction():
                    self.count(ds)
                else:
                    self.reconstruct(ds)
        if self.prior_counts is not None:
            self.data_plus_prior_counts = self.data_counts + self.prior_counts
        else:
            self.data_plus_prior_counts = self.data_counts.copy()

    def fit(self) -> None:
        """EM loop (recon.cpp:1385-1408)."""
        if not (self.accumulate_indel_counts or self.accumulate_subst_counts):
            raise ValueError("with indel AND substitution rates fixed, nothing to fit")
        if not self.datasets:
            if not self.got_prior:
                raise ValueError("please specify data or pseudocounts to fit a model")
            self.prior_counts.optimize(
                self.model, self.accumulate_indel_counts, self.accumulate_subst_counts
            )
            return
        lp_last = -np.inf
        self.prior_counts.indel.lp = 0.0
        it0 = 0
        fp = ""
        ckpt_path = self.checkpoint_filename
        if ckpt_path:
            from historian_tpu.parallel import dist

            if dist.is_initialized():
                import jax

                # each process snapshots its OWN dataset shard's
                # reconstructions (count_all shards datasets round-robin);
                # model/rng state is identical across processes
                if jax.process_index() > 0:
                    ckpt_path += f".p{jax.process_index()}"
        if ckpt_path:
            from historian_tpu.utils import checkpoint as ckpt

            # identity of the run's inputs, computed at fit() entry (before
            # any EM iteration mutates dataset state) on both save and resume
            fp = ckpt.input_fingerprint(
                [self.model.alphabet.symbols, str(len(self.datasets))]
                + [
                    f"{r.name}\n{r.seq}"
                    for ds in self.datasets
                    for r in (ds.gapped_recon or ds.seqs)
                ]
            )
            state = ckpt.load(ckpt_path, "fit", fingerprint=fp)
            if state is not None and len(state.get("datasets", ())) == len(self.datasets):
                self.model = ckpt.restore_model(state["model"])
                lp_last = float(state["lp_last"])
                it0 = int(state["iteration"]) + 1
                ckpt.restore_rng(self.generator, state["rng"])
                # reconstructions persist across EM iterations
                # (recon.cpp:1375-1385: countAll only reconstructs
                # datasets that have none), so they are optimizer state
                for ds, st in zip(self.datasets, state["datasets"]):
                    if st is None:
                        continue
                    ds.tree = Tree(st["tree"])
                    ds.gapped_recon = [
                        FastSeq(name=n, seq=s) for n, s in st["gapped_recon"]
                    ]
                    ds.reconstruction = Alignment.from_gapped(ds.gapped_recon)
                log_this_at(
                    1,
                    f"Resuming EM from checkpoint {ckpt_path} "
                    f"(completed iteration #{it0})",
                )
        for it in range(it0, self.max_em_iterations):
            self.count_all()
            lp_data = self.data_counts.indel.lp
            lp_prior = (
                self.prior_counts.log_prior(
                    self.model, self.accumulate_indel_counts, self.accumulate_subst_counts
                )
                if self.got_prior
                else 0.0
            )
            lp_with_prior = lp_data + lp_prior
            log_this_at(1, f"EM iteration #{it + 1}: log-likelihood = {lp_with_prior}")
            if lp_with_prior <= lp_last + abs(lp_last) * self.min_em_improvement:
                break
            self.data_plus_prior_counts.optimize(
                self.model, self.accumulate_indel_counts, self.accumulate_subst_counts
            )
            lp_last = lp_with_prior
            if ckpt_path:
                from historian_tpu.utils import checkpoint as ckpt

                ckpt.save_atomic(
                    ckpt_path,
                    {
                        "command": "fit",
                        "fingerprint": fp,
                        "iteration": it,
                        "lp_last": lp_last,
                        "model": ckpt.model_state(self.model),
                        "rng": ckpt.rng_state(self.generator),
                        "datasets": [
                            {
                                "tree": ckpt.exact_newick(ds.tree),
                                "gapped_recon": [[r.name, r.seq] for r in ds.gapped_recon],
                            }
                            if ds.has_reconstruction()
                            else None
                            for ds in self.datasets
                        ],
                    },
                )

    # ------------------------------------------------------------------- MCMC
    def sample_all(self) -> None:
        if not self.run_mcmc:
            return
        from historian_tpu.sampler.sampler import run_mcmc_on_datasets

        run_mcmc_on_datasets(self)

    # ---------------------------------------------------------------- simulate
    def simulate(self) -> None:
        from historian_tpu.sampler.simulator import simulate_tree

        for fn in self.simulator_tree_filenames:
            with open(fn) as f:
                tree = Tree(f.read())
            ds = self.new_dataset()
            ds.name = fn
            ds.tree = tree
            root_len = (
                self.simulator_root_seq_len
                if self.simulator_root_seq_len >= 0
                else DEFAULT_SIMULATOR_ROOT_SEQ_LEN
            )
            stock = simulate_tree(self.generator, self.model, tree, root_len)
            ds.gapped_recon = stock.gapped
            ds.tree = tree

    # ----------------------------------------------------------------- writers
    def write_tree_alignment(self, tree: Tree, gapped: list[FastSeq], name: str, out, is_reconstruction: bool, post_prob=None) -> None:
        t = Tree(tree.to_string())
        g = [FastSeq(name=s.name, comment=s.comment, seq=s.seq) for s in gapped]
        if self.output_leaves_only:
            g = [g[n] for n in range(tree.n_nodes()) if tree.is_leaf(n)]
        if self.tokenize_codons:
            g = codon_tokenizer.detokenize_seqs(g)
        # convert internal wildcard to the model's wildcard char
        wild = self.model.wildcard if self.model else "*"
        for s in g:
            s.seq = s.seq.replace("*", wild)
        if self.output_format == FORMAT_JSON or (
            is_reconstruction and self.output_format in (FORMAT_NEXUS, FORMAT_STOCKHOLM)
        ):
            if self.output_leaves_only:
                t.assign_internal_node_names()
            else:
                t.assign_internal_node_names()
                for n in range(t.n_nodes()):
                    if n < len(g) and not g[n].name:
                        g[n].name = t.seq_name(n)
                # rename rows to match named nodes
                for n in range(t.n_nodes()):
                    if n < len(g):
                        g[n].name = t.seq_name(n)
        if self.output_format == FORMAT_FASTA:
            out.write(format_fasta(g))
        elif self.output_format == FORMAT_NEXUS:
            nex = NexusData(gapped=g, tree=t)
            nex.convert_alignment_to_nexus()
            out.write(nex.to_string())
        elif self.output_format == FORMAT_JSON:
            out.write(self._json_alignment(t, g, post_prob))
        else:  # stockholm
            stock = Stockholm.from_seqs(g, t)
            if post_prob and not self.output_leaves_only:
                for row, by_col in sorted(post_prob.items()):
                    for col, by_char in sorted(by_col.items()):
                        for ch, prob in sorted(by_char.items()):
                            stock.gs.setdefault(ANCESTRAL_POST_PROB_TAG, {}).setdefault(
                                stock.gapped[row].name, []
                            ).append(f"{col + 1} {ch} {prob:.6f}")
            stock.gf.setdefault(ID_TAG, []).append(name)
            lp = treealign.log_likelihood(self.model, tree, gapped)
            stock.gf.setdefault(LP_TAG, []).append(f"{lp:.6f}")
            out.write(stock.to_string(0))

    def _json_alignment(self, tree: Tree, gapped: list[FastSeq], post_prob=None) -> str:
        """JSON output incl. per-column ancestral posterior arrays for
        internal nodes (reference writeJson, recon.cpp:1148-1185)."""
        align_cols = len(gapped[0].seq) if gapped else 0
        out = ['{"root": "' + tree.node_name(tree.root()) + '",']
        branches = []
        for n in range(tree.n_nodes()):
            if n != tree.root():
                branches.append(
                    f'\n  ["{tree.node_name(tree.parent(n))}","{tree.node_name(n)}",{tree.branch_length(n):g}]'
                )
        out.append(' "branches": [' + ",".join(branches) + "],")
        rows = []
        for s, fs in enumerate(gapped):
            n = s if not self.output_leaves_only else tree.find_node(fs.name)
            if tree.is_leaf(n) or not post_prob or s not in post_prob:
                rows.append(f'\n  "{fs.name}": "{fs.seq}"')
            else:
                cols = []
                by_col = post_prob[s]
                for col in range(align_cols):
                    if col in by_col:
                        cells = ",".join(
                            f'["{ch}",{prob:.6f}]' for ch, prob in sorted(by_col[col].items())
                        )
                        cols.append(f"[{cells}]")
                    else:
                        cols.append("[]")
                rows.append(f'\n  "{fs.name}": [' + ",".join(cols) + "]")
        out.append(' "rowData": {' + ",".join(rows) + "\n}}")
        return "\n".join(out) + "\n"

    def write_recon(self, out) -> None:
        if not self.datasets:
            raise ValueError("no dataset")
        for ds in self.datasets:
            gapped = (
                ds.gapped_ancestral_recon
                if self.predict_ancestral_sequence
                else ds.gapped_recon
            )
            self.write_tree_alignment(
                ds.tree, gapped, ds.name, out, True,
                ds.ancestral_post_prob if self.report_ancestral_sequence_probability else None,
            )

    def write_counts(self, out) -> None:
        self.data_counts.write(out)

    def write_model(self, out) -> None:
        self.model.write(out)


def _split_stockholm(text: str) -> list[str]:
    """Split a multi-alignment Stockholm file on '//' dividers."""
    chunks = []
    current: list[str] = []
    for line in text.splitlines():
        current.append(line)
        if re.match(r"^\s*//\s*$", line):
            chunks.append("\n".join(current))
            current = []
    if any(line.strip() for line in current):
        chunks.append("\n".join(current))
    return chunks
