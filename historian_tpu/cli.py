"""Command-line interface.

Counterpart of the reference's historian CLI
(/root/reference/target/historian.cpp:244-398): commands
reconstruct/count/fit/mcmc/sum/generate/help/version with single-letter
abbreviations; bare filenames become -auto with format autodetection;
-fast/-careful aliases expand to their constituent flags.
"""

from __future__ import annotations

import sys
from collections import deque

from historian_tpu import __version__
from historian_tpu.models.counts import EventCounts
from historian_tpu.recon import (
    FORMAT_FASTA,
    FORMAT_JSON,
    FORMAT_NEXUS,
    FORMAT_STOCKHOLM,
    Reconstructor,
)
from historian_tpu.utils.logging import logger

PROG = "historian-tpu"

CAREFUL_ALIAS = ["-allspan", "-kmatchoff", "-band", "40", "-profminpost", ".001", "-profmaxmem", "5", "-refine"]
FAST_ALIAS = ["-rndspan", "-kmatchn", "3", "-band", "10", "-profmaxstates", "1", "-jc", "-norefine"]

BRIEF = f"""{PROG}: a GPU-accelerated statistical phylogenetics framework
Reconstruction of evolutionary histories by transducer composition.

Usage: {PROG} {{recon,count,fit,mcmc,sum,generate,help,version}} [options] [files]
Run '{PROG} help' for details.
"""


HELP = f"""{PROG}: reconstruction of evolutionary histories by transducer composition

Usage: {PROG} <command> [options] [files]

Commands (single-letter abbreviations work):
  recon (r)     reconstruct ancestral sequence histories [default command]
  count (c)     compute expected event counts on a reconstruction
  fit (f)       fit model parameters by EM from counts
  mcmc (m)      sample trees and alignments by MCMC
  sum (s)       sum event-count JSON files (the MapReduce reducer)
  generate (g)  simulate alignments down a tree
  help, version

Input (repeatable; bare filenames are auto-detected by content):
  -seqs <file>       unaligned FASTA sequences
  -guide <file>      gapped FASTA used as a guide alignment
  -nexus <file>      Nexus alignment + tree
  -stockholm <file>  Stockholm alignment (tree via #=GF NH)
  -tree <file>       Newick tree
  -reroot <node>     re-root a loaded tree above this node
  -codon             tokenize sequences as codons (61-char alphabet)

Model:
  -model <file>      rate-model JSON
  -preset <name>     jc jcrna dayhoff jtt wag lg ECMrest ECMunrest
  -normalize         normalize substitution rate to one expected event/unit time
  -insrate/-delrate/-insextprob/-delextprob/-gaprate/-gapextprob <x>
  -inslen/-dellen/-gaplen <L>         expected gap lengths
  -subscale/-indelscale/-scale <x>    rate rescaling
  -gamma <n> -shape <a>  discretized-gamma rate mixture
  -savemodel <file>

Reconstruction:
  -band <n>          alignment-envelope width around the guide (-noband: off)
  -profsamples <n>   sampled-path profile states   -profminpost <p>  posterior cutoff
  -profmaxstates <n> -profminlen <n> -profmaxlen <n> -profmaxmem <pct>
  -keepgapsopen      keep gap structure open during progressive merge
  -nobest            drop the best trace from sampled profiles
  -ancseq            predict ancestral residues    -ancprob  with posteriors
  -noancs            write leaves only
  -refine / -norefine   iterative branch realignment
  -output fasta|nexus|stockholm|json
  -savedot <file> [-dotpost [p]] [-dotsubpost [p]] [-dotgapsopen]
  -saveguide <file>

Guide alignment & tree estimation:
  -allspan / -rndspan    all-vs-all or sparse random guide graph
  -upgma / -nj           tree construction        -jc  Jukes-Cantor distances
  -kmatch <k> -kmatchn <n> -kmatchband <b> -kmatchmb <mb> -kmatchmax -kmatchoff

MCMC (mcmc command or -mcmc):
  -samples <n>    samples per sequence    -trace <file>  log-likelihood trace
  -fixtree / -fixalign / -fixguide

Counts / EM:
  -counts <file>  prior pseudocounts      -nolaplace  no +1 pseudocounts
  -fixsubrates / -fixgaprates             -mininc <x> -maxiter <n>  EM stopping
  -checkpoint <file>  snapshot EM/MCMC state + resume from it if present
  -ckptevery <n>      MCMC steps between snapshots (default 100)

Misc:
  -seed <n>       mt19937 seed            -platform cpu|gpu  JAX backend
  -mesh <n|DxE>   engage a device mesh: count/fit E-steps shard columns over
                  dp (psum reduce; DxE adds an ep axis over mixture
                  components); recon/mcmc merges round-robin over dp and long
                  merges shard over the SP ring (HISTORIAN_SP forces/disables)
  -profile <dir>  write a jax.profiler trace of the run
  -v .. -v9, -log <tag>, -nocolor         logging
  -abort          raw tracebacks on errors

Aliases: -careful (= -allspan -kmatchoff -band 40 -profminpost .001
-profmaxmem 5 -refine)  -fast (= -rndspan -kmatchn 3 -band 10
-profmaxstates 1 -jc -norefine)
"""


def _parse_common(recon: Reconstructor, argvec: deque) -> bool:
    """Consume one model/recon/profile/count arg; return True if consumed."""
    if not argvec:
        return False
    arg = argvec[0]

    def take(n=1):
        if len(argvec) < n + 1:
            raise SystemExit(f"{PROG}: option {arg!r} requires {n} argument(s)")
        vals = [argvec.popleft() for _ in range(n + 1)][1:]
        return vals[0] if n == 1 else vals

    # model args
    if arg == "-model":
        recon.model_filename = take()
    elif arg == "-preset":
        recon.preset_model_name = take()
    elif arg == "-normalize":
        argvec.popleft()
        recon.normalize_model = True
    elif arg in ("-insrate", "-delrate", "-insextprob", "-delextprob", "-inslen",
                 "-dellen", "-gaprate", "-gapextprob", "-gaplen", "-subscale",
                 "-indelscale", "-scale"):
        recon.model_param[arg[1:]] = float(take())
    elif arg == "-gamma":
        recon.gamma_categories = int(take())
    elif arg == "-shape":
        recon.gamma_shape = float(take())
    elif arg == "-savemodel":
        recon.model_save_filename = take()
    elif arg == "-codon":
        argvec.popleft()
        recon.tokenize_codons = True
    # recon IO args
    elif arg == "-auto":
        recon.load_auto(take())
    elif arg == "-seqs":
        recon.seq_filenames.append(take())
    elif arg == "-guide":
        recon.fasta_guide_filenames.append(take())
    elif arg == "-nexus":
        recon.nexus_guide_filenames.append(take())
    elif arg == "-stockholm":
        recon.stockholm_guide_filenames.append(take())
    elif arg == "-tree":
        recon.tree_filename = take()
    elif arg in ("-root", "-reroot"):  # reference name is -reroot (recon.cpp:466)
        recon.tree_root = take()
    elif arg == "-nobest":
        argvec.popleft()
        recon.include_best_trace_in_profile = False
    elif arg == "-saveguide":
        recon.guide_save_filename = take()
    elif arg == "-output":
        fmt = take().lower()
        formats = {
            "fasta": FORMAT_FASTA, "nexus": FORMAT_NEXUS,
            "stockholm": FORMAT_STOCKHOLM, "json": FORMAT_JSON,
        }
        if fmt not in formats:
            raise SystemExit(
                f"{PROG}: unknown output format {fmt!r}"
                f" (expected one of: {', '.join(formats)})"
            )
        recon.output_format = formats[fmt]
    elif arg == "-noancs":
        argvec.popleft()
        recon.output_leaves_only = True
    # reconstruction algorithm args
    elif arg == "-band":
        recon.max_distance_from_guide = int(take())
    elif arg == "-noband":
        argvec.popleft()
        recon.max_distance_from_guide = -1
    elif arg == "-profsamples":
        recon.profile_samples = int(take())
        recon.use_posteriors_for_profile = False
    elif arg == "-profminpost":
        recon.min_post_prob = float(take())
        recon.use_posteriors_for_profile = True
    elif arg == "-profmaxstates":
        recon.profile_node_limit = int(take())
    elif arg == "-profminlen":
        recon.profile_min_len = int(take())
    elif arg == "-profmaxlen":
        recon.profile_max_len = int(take())
    elif arg == "-profmaxmem":
        recon.max_dp_memory_fraction = float(take()) / 100.0
        recon.profile_node_limit = 0
    elif arg == "-savedot":
        recon.dot_save_filename = take()
    elif arg == "-dotpost":
        argvec.popleft()
        recon.use_posteriors_for_dot = True
        recon.min_dot_post_prob = float(argvec.popleft()) if argvec and not argvec[0].startswith("-") else recon.min_dot_post_prob
    elif arg == "-dotgapsopen":
        argvec.popleft()
        recon.keep_dot_gaps_open = True
    elif arg == "-dotsubpost":
        argvec.popleft()
        recon.use_separate_sub_posteriors_for_dot = True
        recon.min_dot_sub_post_prob = float(argvec.popleft()) if argvec and not argvec[0].startswith("-") else recon.min_dot_sub_post_prob
    elif arg == "-keepgapsopen":
        argvec.popleft()
        recon.keep_gaps_open = True
    elif arg == "-ancseq":
        argvec.popleft()
        recon.predict_ancestral_sequence = True
    elif arg == "-ancprob":
        argvec.popleft()
        recon.predict_ancestral_sequence = True
        recon.report_ancestral_sequence_probability = True
    elif arg == "-refine":
        argvec.popleft()
        recon.refine_reconstruction = True
    elif arg == "-norefine":
        argvec.popleft()
        recon.refine_reconstruction = False
    elif arg == "-mcmc":
        argvec.popleft()
        recon.run_mcmc = True
    elif arg == "-samples":
        recon.mcmc_samples_per_seq = int(take())
    elif arg == "-trace":
        recon.mcmc_trace_filename = take()
    elif arg == "-checkpoint":
        # not in the reference: periodic EM/MCMC snapshot + resume
        recon.checkpoint_filename = take()
    elif arg == "-ckptevery":
        recon.checkpoint_every = int(take())
    elif arg == "-fixtree":
        argvec.popleft()
        recon.fix_tree_mcmc = True
    elif arg == "-fixalign":
        argvec.popleft()
        recon.fix_align_mcmc = True
    elif arg == "-fixguide":
        argvec.popleft()
        recon.fix_guide_mcmc = True
    # guide/tree estimation
    elif arg == "-rndspan":
        argvec.popleft()
        recon.guide_align_try_all_pairs = False
    elif arg == "-allspan":
        argvec.popleft()
        recon.guide_align_try_all_pairs = True
    elif arg == "-upgma":
        argvec.popleft()
        recon.use_upgma = True
    elif arg == "-nj":
        argvec.popleft()
        recon.use_upgma = False
    elif arg == "-jc":
        argvec.popleft()
        recon.jukes_cantor_distance_matrix = True
    elif arg == "-kmatchn":
        recon.diag_env_params.kmer_threshold = int(take())
    elif arg == "-kmatch":
        recon.diag_env_params.kmer_len = int(take())
    elif arg == "-kmatchband":
        recon.diag_env_params.band_size = int(take())
    elif arg == "-kmatchmb":
        recon.diag_env_params.max_size = int(take()) << 20
        recon.diag_env_params.kmer_threshold = -1
    elif arg == "-kmatchmax":
        argvec.popleft()
        recon.diag_env_params.kmer_threshold = -1
    elif arg == "-kmatchoff":
        argvec.popleft()
        recon.diag_env_params.sparse = False
    # aliases
    elif arg == "-careful":
        argvec.popleft()
        argvec.extendleft(reversed(CAREFUL_ALIAS))
    elif arg == "-fast":
        argvec.popleft()
        argvec.extendleft(reversed(FAST_ALIAS))
    # counting / fitting
    elif arg == "-recon":
        recon.fasta_recon_filename = take()
    elif arg == "-nexusrecon":
        recon.nexus_recon_filenames.append(take())
    elif arg == "-stockrecon":
        recon.stockholm_recon_filenames.append(take())
    elif arg == "-counts":
        recon.count_filenames.append(take())
    elif arg == "-mininc":
        recon.min_em_improvement = float(take())
    elif arg == "-maxiter":
        recon.max_em_iterations = int(take())
    elif arg == "-nolaplace":
        argvec.popleft()
        recon.use_laplace_pseudocounts = False
    elif arg == "-fixsubrates":
        argvec.popleft()
        recon.fit_subst_rates = False
    elif arg == "-fixgaprates":
        argvec.popleft()
        recon.fit_indel_rates = False
    # simulation
    elif arg == "-rootlen":
        recon.simulator_root_seq_len = int(take())
    # general
    elif arg == "-mesh":
        from historian_tpu.parallel.pcounts import set_mesh

        set_mesh(take())
    elif arg == "-seed":
        recon.rnd_seed = int(take())
        recon.seed_generator()
    elif not arg.startswith("-"):
        recon.load_auto(argvec.popleft())
    else:
        return False
    return True


def _drain_args(recon: Reconstructor, argvec: deque) -> None:
    while argvec:
        if not _parse_common(recon, argvec):
            raise SystemExit(f"{PROG}: unknown option {argvec[0]!r} (try '{PROG} help')")


def select_platform(platform: str) -> None:
    """Run on `platform` (cpu|gpu) and check that JAX's default device is
    one.  A platform with no device ends the command with a non-zero
    exit that names it: nothing falls back to another backend."""
    if platform not in ("cpu", "gpu"):
        raise SystemExit(f"{PROG}: -platform must be cpu or gpu, not {platform!r}")
    import jax

    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    # multi-host bring-up must precede the device check below --
    # jax.distributed.initialize rejects an already-booted backend
    from historian_tpu.parallel.dist import init_from_env

    init_from_env()
    try:
        found = jax.devices()[0].platform
    except RuntimeError as e:
        found = f"none ({e})"
    if found != platform:
        raise SystemExit(
            f"{PROG}: -platform {platform}: no {platform.upper()} device found "
            f"(JAX's default device: {found})"
        )


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # platform selection: -platform cpu|gpu or HISTORIAN_PLATFORM env;
    # with neither, JAX's default backend runs the kernels
    import os

    platform = os.environ.get("HISTORIAN_PLATFORM", "")
    if "-platform" in argv:
        i = argv.index("-platform")
        if i + 1 >= len(argv):
            raise SystemExit(f"{PROG}: option '-platform' requires 1 argument(s)")
        platform = argv[i + 1]
        del argv[i : i + 2]
    if platform:
        select_platform(platform)
    # multi-host bring-up before any device use; no-op unless the
    # HISTORIAN_DIST / HISTORIAN_COORDINATOR family of env vars is set
    from historian_tpu.parallel.dist import init_from_env

    init_from_env()
    if os.environ.get("HISTORIAN_MESH"):
        from historian_tpu.parallel.pcounts import set_mesh

        set_mesh(os.environ["HISTORIAN_MESH"])
    argv = logger.parse_args(argv)
    if not argv:
        sys.stderr.write(BRIEF)
        return 1

    command = argv[0]
    rest = argv[1:]
    # single-letter abbreviations; unknown first token => implicit reconstruct
    aliases = {
        "r": "recon", "reconstruct": "recon", "recon": "recon",
        "c": "count", "count": "count",
        "f": "fit", "fit": "fit",
        "m": "mcmc", "mcmc": "mcmc",
        "s": "sum", "sum": "sum",
        "g": "generate", "generate": "generate",
        "h": "help", "help": "help", "--help": "help", "-h": "help",
        "v": "version", "version": "version", "--version": "version", "-V": "version",
    }
    if command in aliases:
        command = aliases[command]
    else:
        rest = argv  # no command: default reconstruct, treat token as arg
        command = "recon"

    recon = Reconstructor()
    out = sys.stdout

    if command == "help":
        sys.stderr.write(HELP)
        return 0
    if command == "version":
        print(f"{PROG} {__version__}")
        return 0

    argvec = deque(rest)

    if "-profile" in argvec:
        # observability: wrap the whole command in a jax.profiler trace
        # (view with tensorboard or xprof); SURVEY.md 5: the reference has
        # leveled logging only
        i = list(argvec).index("-profile")
        trace_dir = list(argvec)[i + 1]
        for _ in range(2):
            del argvec[i]
        import jax

        with jax.profiler.trace(trace_dir):
            return _dispatch(command, recon, argvec, out)
    if "-abort" in argvec:  # debugging aid: raw tracebacks (reference optparser.cpp:35)
        argvec.remove("-abort")
        return _dispatch(command, recon, argvec, out)
    try:
        return _dispatch(command, recon, argvec, out)
    except OSError as e:
        if e.filename is not None:
            raise SystemExit(f"{PROG}: {e.strerror.lower()}: {e.filename!r}")
        raise
    except ValueError as e:
        raise SystemExit(f"{PROG}: {e}")
    except LookupError as e:
        raise SystemExit(f"{PROG}: {e.args[0] if e.args else e}")


def _dispatch(command: str, recon: Reconstructor, argvec: deque, out) -> int:
    if command == "recon":
        _drain_args(recon, argvec)
        recon.load_model()
        recon.load_seqs()
        recon.reconstruct_all()
        recon.sample_all()
        recon.predict_all_ancestors()
        recon.write_recon(out)
    elif command == "count":
        recon.accumulate_subst_counts = True
        recon.accumulate_indel_counts = True
        recon.use_laplace_pseudocounts = False
        _drain_args(recon, argvec)
        recon.load_model()
        recon.load_seqs()
        recon.load_recon()
        recon.load_counts()
        recon.count_all()
        recon.write_counts(out)
    elif command == "sum":
        paths = [a for a in argvec if not a.startswith("-")]
        total = None
        for p in paths:
            c = EventCounts.from_file(p)
            total = c if total is None else total + c
        if total is None:
            raise SystemExit("sum: no count files given")
        total.write(out)
    elif command == "fit":
        recon.accumulate_subst_counts = True
        recon.accumulate_indel_counts = True
        _drain_args(recon, argvec)
        recon.accumulate_subst_counts = recon.fit_subst_rates
        recon.accumulate_indel_counts = recon.fit_indel_rates
        recon.load_model()
        recon.load_seqs()
        recon.load_recon()
        recon.load_counts()
        recon.fit()
        recon.write_model(out)
    elif command == "mcmc":
        recon.run_mcmc = True
        _drain_args(recon, argvec)
        recon.load_model()
        recon.load_seqs()
        recon.load_recon()
        recon.sample_all()  # reconstructs any dataset lacking a reconstruction
        recon.predict_all_ancestors()
        recon.write_recon(out)
    elif command == "generate":
        _drain_args(recon, argvec)
        # bare newick files end up in tree_filename via autodetect
        if recon.tree_filename:
            recon.simulator_tree_filenames.append(recon.tree_filename)
        recon.load_model()
        recon.seed_generator()
        recon.simulate()
        for ds in recon.datasets:
            recon.write_tree_alignment(ds.tree, ds.gapped_recon, ds.name, out, True)
    else:
        raise SystemExit(f"unknown command {command!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
