#!/usr/bin/env python
"""Adjudicate the default-mode GPU-vs-CPU reconstruction quality gap:
run the flagship gp120 default recon over several mt19937 seeds on both
platforms and record the final #=GF LP distributions in
chiprun_out/lp_seeds.json.

The platforms CANNOT be draw-for-draw identical by design: CPU fills
are f64 with host tracebacks (bit-compatible with the reference path);
`-platform gpu` routes big merges to f32 device fills with on-device
trace walks (different RNG stream entirely, ops/tracedp.py).  Each
platform IS deterministic given a seed, so the honest comparison is the
LP distribution over seeds: overlapping distributions = seed noise;
a systematic offset = f32/route quality loss.
"""

import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SEEDS = [5489, 1, 2, 3, 17]


def run(platform: str, seed: int) -> tuple[float, float]:
    cmd = [sys.executable, "-m", "historian_tpu", "recon",
           "/root/reference/data/gp120.fa", "-seed", str(seed),
           "-platform", platform]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=1800, cwd=REPO)
    wall = time.perf_counter() - t0
    assert p.returncode == 0, (platform, seed, p.stderr[-1000:])
    m = re.search(r"#=GF LP\s+(-?[0-9.eE+]+)", p.stdout)
    assert m, p.stdout[:300]
    return float(m.group(1)), wall


def main() -> None:
    out = {"seeds": SEEDS, "lp_cpu": [], "lp_gpu": [], "note": __doc__.strip().splitlines()[0]}
    for seed in SEEDS:
        for platform in ("cpu", "gpu"):
            lp, wall = run(platform, seed)
            out[f"lp_{platform}"].append(lp)
            print(f"seed {seed} {platform}: LP {lp:.3f} ({wall:.1f}s)", file=sys.stderr)
    cpu, gpu = out["lp_cpu"], out["lp_gpu"]
    mean = lambda v: sum(v) / len(v)
    out["mean_cpu"] = round(mean(cpu), 3)
    out["mean_gpu"] = round(mean(gpu), 3)
    out["mean_gap_nats"] = round(mean(cpu) - mean(gpu), 3)
    spread = max(max(cpu) - min(cpu), max(gpu) - min(gpu))
    out["max_within_platform_spread_nats"] = round(spread, 3)
    out["verdict"] = (
        "systematic" if abs(out["mean_gap_nats"]) > spread else "seed-noise"
    )
    path = os.path.join(REPO, "chiprun_out", "lp_seeds.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
