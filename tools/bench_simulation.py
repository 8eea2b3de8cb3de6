#!/usr/bin/env python
"""Simulation-based rate-recovery benchmark (the doc/sim analogue).

Mirrors the reference's doc/sim/Makefile gp120 protocol exactly
(doc/sim/Makefile:44-100; published summary doc/sim/gp120.1-100.summary:
ma 0.90, hist 0.70):

- simulate:  generate -preset dayhoff -gaprate 0.028 -gapextprob 0.68
             <gp120 tree> -rootlen 500        (rates from doc/sim/gp120.json:
             (insrate+delrate)/2 = 0.028, harmonic-mean extprob = 0.68)
- "ma":      fit -fast -fixsubrates -band 1 on the TRUE alignment
             (all rows incl. ancestors, NJ tree -- %.ma.json recipe)
- "hist":    fit -fast -fixsubrates on the unaligned leaves
             (EM re-reconstructs each iteration -- %.hist.json recipe)

Reported per mode: mean(est_ins/true), mean(est_del/true).

Usage: python tools/bench_simulation.py [-platform cpu] [-n replicates]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, __file__.rsplit("/", 2)[0])

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GP120_TREE = "/root/reference/data/gp120.tree.nh"
TRUE_RATE = 0.028      # -gaprate: both insrate and delrate
TRUE_EXT = 0.68        # -gapextprob
ROOT_LEN = 500


def run(args: list[str]) -> str:
    proc = subprocess.run(
        [sys.executable, "-m", "historian_tpu"] + args,
        capture_output=True, text=True, cwd=REPO,
    )
    if proc.returncode != 0:
        sys.exit(f"command failed: {' '.join(args)}\n{proc.stderr.strip().splitlines()[-1]}")
    return proc.stdout


#: ablation modes (doc/sim/Makefile recipe -> extra structure supplied):
#:   ma        %.ma.json      true alignment, NJ tree        (published 0.90)
#:   ma.tree   %.ma.tree.json true alignment + TRUE tree     (ablates tree est)
#:   hist      %.hist.json    leaves only, EM reconstruction (published 0.70)
#:   hist.tree (ours)         leaves + TRUE tree, EM         (ablates tree est)
#:   histrec   %.histrec.json fixed recon -fast -norefine,
#:             then fit -stockrecon                          (ablates the EM loop)
#:   histslow  %.histslow.json posterior profiles instead of -fast's
#:             best-trace chains (ablates MAP indel labeling)
MODES = ("ma", "ma.tree", "hist", "hist.nj", "hist.tree", "histrec", "histslow")


def main() -> None:
    args = sys.argv[1:]
    # default the worker CLIs to CPU: the study is many small host-bound
    # fits that gain nothing from a GPU
    platform = ["-platform", "cpu"]
    if "-platform" in args:
        i = args.index("-platform")
        platform = args[i : i + 2]
    n = int(args[args.index("-n") + 1]) if "-n" in args else 5
    rep0 = int(args[args.index("-rep0") + 1]) if "-rep0" in args else 0
    modes = (args[args.index("-modes") + 1].split(",")
             if "-modes" in args else list(MODES))
    csv_path = args[args.index("-csv") + 1] if "-csv" in args else None

    sim_flags = ["-preset", "dayhoff", "-gaprate", str(TRUE_RATE),
                 "-gapextprob", str(TRUE_EXT), "-rootlen", str(ROOT_LEN)]
    est: dict[str, list[tuple[float, float]]] = {m: [] for m in modes}
    csv = open(csv_path, "w") if csv_path else None
    if csv:
        csv.write("rep,mode,insrate,delrate\n")
    with tempfile.TemporaryDirectory() as tmp:
        for rep in range(rep0, rep0 + n):
            stock = run(["generate"] + platform + sim_flags
                        + ["-seed", str(1000 + rep), GP120_TREE])
            sim_path = os.path.join(tmp, f"sim{rep}.stock")
            with open(sim_path, "w") as f:
                f.write(stock)

            from historian_tpu.core.stockholm import Stockholm

            rows = Stockholm.read(sim_path).gapped
            ma_path = os.path.join(tmp, f"sim{rep}.ma.fa")
            with open(ma_path, "w") as f:
                for s in rows:
                    f.write(f">{s.name}\n{s.seq}\n")
            leaf_path = os.path.join(tmp, f"sim{rep}.leaf.fa")
            with open(leaf_path, "w") as f:
                for s in rows:
                    if not s.name.startswith("node"):
                        f.write(f">{s.name}\n{s.seq.replace('-', '').replace('.', '')}\n")

            for mode in modes:
                if mode == "ma":
                    cmd = ["fit", "-fast", "-fixsubrates", "-band", "1", ma_path]
                elif mode == "ma.tree":
                    cmd = ["fit", "-fast", "-fixsubrates", "-band", "1",
                           ma_path, "-tree", GP120_TREE]
                elif mode == "hist":
                    cmd = ["fit", "-fast", "-fixsubrates", leaf_path]
                elif mode == "hist.nj":
                    # protocol-vintage ablation (round 5): the committed
                    # doc/sim artifacts carry NON-ultrametric guide trees
                    # (doc/sim/gp120.recon.fa #=GF NH), i.e. the published
                    # table predates the reference's UPGMA default
                    # (recon.cpp:43) -- re-run hist with the NJ tree stage
                    cmd = ["fit", "-fast", "-nj", "-fixsubrates", leaf_path]
                elif mode == "hist.tree":
                    cmd = ["fit", "-fast", "-fixsubrates", leaf_path,
                           "-tree", GP120_TREE]
                elif mode == "histslow":
                    cmd = ["fit", "-fixsubrates", "-profminpost", ".001",
                           "-profmaxstates", "12000", leaf_path]
                elif mode == "histrec":
                    rec = run(["recon"] + platform
                              + ["-fast", "-norefine", "-output", "stockholm",
                                 leaf_path])
                    rec_path = os.path.join(tmp, f"sim{rep}.rec.stk")
                    with open(rec_path, "w") as f:
                        f.write(rec)
                    cmd = ["fit", "-fast", "-fixsubrates", "-stockrecon",
                           rec_path, leaf_path]
                else:
                    sys.exit(f"unknown mode {mode!r}")
                fitted = json.loads(run(["fit"][:0] + cmd[:1] + platform + cmd[1:]))
                est[mode].append((fitted["insrate"], fitted["delrate"]))
                if csv:
                    csv.write(f"{rep},{mode},{fitted['insrate']!r},{fitted['delrate']!r}\n")
                    csv.flush()
            print(f"rep {rep}: " + "  ".join(
                f"{m} {est[m][-1][0] / TRUE_RATE:.2f}/{est[m][-1][1] / TRUE_RATE:.2f}"
                for m in modes), flush=True)

    print("recovery est/true (ins/del):")
    published = {"ma": "0.90/0.90", "hist": "0.70/0.70"}
    for m in modes:
        mi = sum(p[0] for p in est[m]) / len(est[m]) / TRUE_RATE
        md = sum(p[1] for p in est[m]) / len(est[m]) / TRUE_RATE
        ref = f" (reference published {published[m]})" if m in published else ""
        print(f"  {m}: ins {mi:.2f} del {md:.2f}{ref}")
    if csv:
        csv.close()


if __name__ == "__main__":
    main()
