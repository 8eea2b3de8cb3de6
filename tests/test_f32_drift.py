"""Bound the device f32 merge-route's logLik drift.

The #=GF LP header is an f64 HOST rescore of the chosen alignment
(recon.py write path), so any LP difference between routes is real
alignment divergence, not scoring error.  Adjudication on the long
corpus (long6 -fast, five ~6000^2 merges, CPU backend):

  host f64 route      lp = -45387.96481
  device route, f64   lp = -45387.96481   (EXACT: the route is exact;
                                           only the dtype can diverge)
  device route, f32   lp = -45397.28      (-9.3 nats: f32 best-trace
                                           decisions pick a slightly
                                           different near-optimum; on
                                           long12 the f32 choice scored
                                           +336 nats BETTER -- the drift
                                           is divergence among
                                           near-equal optima, unbiased
                                           in sign)

This test pins both facts at a smaller scale so the battery catches a
route regression or a blow-up of the f32 divergence.
"""

import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lp(out: str) -> float:
    m = re.search(r"#=GF LP\s+(-?[0-9.eE+]+)", out)
    assert m, out[:300]
    return float(m.group(1))


def _recon(corpus, tree, env_extra):
    env = dict(os.environ)
    env["HISTORIAN_PLATFORM"] = "cpu"
    env.pop("JAX_PLATFORMS", None)
    env.update(env_extra)
    r = subprocess.run(
        [sys.executable, "-m", "historian_tpu", "recon", "-fast", "-noband",
         "-model", "/root/reference/data/testamino.json",
         "-tree", tree, corpus],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900,
    )
    assert r.returncode == 0, r.stderr[-1500:]
    return _lp(r.stdout)


@pytest.mark.slow
def test_f32_route_drift_bounded(ref_data):
    # 4-taxon corpus of ~1200aa chains: big enough that every merge
    # exceeds bucket sizes where f32 rounding can flip trace decisions,
    # small enough for the battery
    from historian_tpu.core.seqs import write_fasta, FastSeq
    from historian_tpu.core.tree import Tree
    from historian_tpu.models.ratemodel import RateModel
    from historian_tpu.sampler.simulator import simulate_tree
    from historian_tpu.utils.rng import MT19937

    model = RateModel.from_file(f"{ref_data}/testamino.json")
    tree = Tree("((a:0.3,b:0.3):0.2,(c:0.35,d:0.25):0.15);")
    tree.assign_internal_node_names()
    stock = simulate_tree(MT19937(11), model, tree, 1200)
    with tempfile.TemporaryDirectory() as tmp:
        fa = os.path.join(tmp, "leaves.fa")
        with open(fa, "w") as f:
            for s in stock.gapped:
                if s.name in ("a", "b", "c", "d"):
                    f.write(f">{s.name}\n{s.seq.replace('-', '')}\n")
        nh = os.path.join(tmp, "t.nh")
        with open(nh, "w") as f:
            f.write(str(tree) + "\n")
        lp_host = _recon(fa, nh, {"HISTORIAN_DEVICE_DP": "0"})
        lp_dev64 = _recon(fa, nh, {"HISTORIAN_DEVICE_DP": "1",
                                   "HISTORIAN_DEVICE_DTYPE": "f64"})
        lp_dev32 = _recon(fa, nh, {"HISTORIAN_DEVICE_DP": "1",
                                   "HISTORIAN_DEVICE_DTYPE": "f32"})
    # the device route is EXACT in f64: any gap here is a route bug
    assert abs(lp_dev64 - lp_host) < 1e-6, (lp_dev64, lp_host)
    # f32 divergence stays bounded (measured ~2 nats/merge at 6k scale;
    # 50 nats here would mean something qualitatively broke)
    assert abs(lp_dev32 - lp_host) < 50.0, (lp_dev32, lp_host)
