"""Device execution of the production composition DP (ops/devicedp).

The chain x chain Forward fill must produce the same banded cell tensor
as the host fill (float64 on CPU: identical up to reassociation), and a
full -fast reconstruction through the device path must match the host
path's output.
"""

import os

import numpy as np
import pytest

from historian_tpu.core.seqs import read_fasta
from historian_tpu.core.tree import Tree
from historian_tpu.engine.forward import ForwardMatrix
from historian_tpu.engine.pairhmm import PairHMM
from historian_tpu.engine.profile import Profile
from historian_tpu.models.ratemodel import ProbModel, RateModel


def _leaf_pair_forward(ref_data, monkeypatch, device: bool):
    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "1" if device else "0")
    model = RateModel.from_file(os.path.join(ref_data, "testamino.json"))
    seqs = read_fasta(os.path.join(ref_data, "PF16593.pair.fa"))
    x = Profile.from_sequence(model.components, model.alphabet, seqs[0], 0)
    y = Profile.from_sequence(model.components, model.alphabet, seqs[1], 1)
    hmm = PairHMM(ProbModel(model, 0.8), ProbModel(model, 0.4), model.ins_prob)
    return ForwardMatrix(x, y, hmm, 2)


def test_leaf_chain_fill_matches_host(ref_data, monkeypatch):
    host = _leaf_pair_forward(ref_data, monkeypatch, device=False)
    dev = _leaf_pair_forward(ref_data, monkeypatch, device=True)
    assert np.isfinite(dev.lp_end)
    assert abs(dev.lp_end - host.lp_end) < 1e-9
    hc = np.where(np.isfinite(host.cells), host.cells, -1.0e99)
    dc = np.where(np.isfinite(dev.cells), dev.cells, -1.0e99)
    np.testing.assert_allclose(dc, hc, rtol=1e-9, atol=1e-9)


def test_leaf_chain_fill_banded_matches_host(ref_data, monkeypatch):
    """Same comparison under a guide envelope (the production banding)."""
    from historian_tpu.core.alignpath import Alignment, GuideAlignmentEnvelope

    model = RateModel.from_file(os.path.join(ref_data, "testamino.json"))
    gapped = read_fasta(os.path.join(ref_data, "PF16593.fa"))[:2]
    align = Alignment.from_gapped(gapped)
    env = GuideAlignmentEnvelope(align.path, 0, 1, 10)
    seqs = align.ungapped
    x = Profile.from_sequence(model.components, model.alphabet, seqs[0], 0)
    y = Profile.from_sequence(model.components, model.alphabet, seqs[1], 1)
    hmm = PairHMM(ProbModel(model, 0.5), ProbModel(model, 0.5), model.ins_prob)
    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "0")
    host = ForwardMatrix(x, y, hmm, 2, env)
    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "1")
    dev = ForwardMatrix(x, y, hmm, 2, env)
    assert np.isfinite(dev.lp_end) and abs(dev.lp_end - host.lp_end) < 1e-9
    hc = np.where(np.isfinite(host.cells), host.cells, -1.0e99)
    dc = np.where(np.isfinite(dev.cells), dev.cells, -1.0e99)
    np.testing.assert_allclose(dc, hc, rtol=1e-9, atol=1e-9)


def test_best_trace_profile_is_chain(ref_data, monkeypatch):
    """-fast's COLLAPSE_CHAINS best-trace profiles are pure emit chains,
    so second-level merges also take the device path."""
    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "0")
    fwd = _leaf_pair_forward(ref_data, monkeypatch, device=False)
    prof = fwd.best_profile()
    assert prof.as_chain() is not None
    # and a default sampled profile (multiple traces) generally is NOT
    from historian_tpu.utils.rng import MT19937

    sampled = fwd.sample_profile(MT19937(5489), 10, 0)
    assert sampled.size > prof.size  # sanity: sampling retained more cells


def _run_cli(args, env_extra):
    import subprocess
    import sys

    env = dict(os.environ)
    env.update(env_extra)
    return subprocess.run(
        [sys.executable, "-m", "historian_tpu", *args],
        capture_output=True, text=True, timeout=600, env=env, cwd="/root/repo",
    )


def test_fast_recon_device_path_matches_host(ref_data):
    """End-to-end `recon -fast` (every merge a chain pair) through the
    device kernel equals the host-path output byte for byte on CPU f64."""
    args = [
        "recon", "-fast", "-output", "fasta",
        "-model", os.path.join(ref_data, "testcount.jukescantor.json"),
        "-guide", os.path.join(ref_data, "testcount.fa"),
        "-tree", os.path.join(ref_data, "testcount.nh"),
    ]
    # HISTORIAN_PLATFORM: the CLI's platform flag goes through the
    # config API, so it holds whatever JAX_PLATFORMS says
    base = {"HISTORIAN_PLATFORM": "cpu"}
    host = _run_cli(args, {**base, "HISTORIAN_DEVICE_DP": "0"})
    dev = _run_cli(args, {**base, "HISTORIAN_DEVICE_DP": "1"})
    assert host.returncode == 0, host.stderr[-2000:]
    assert dev.returncode == 0, dev.stderr[-2000:]
    assert host.stdout == dev.stdout


def test_dag_kernel_matches_host_on_sampled_profiles(ref_data, monkeypatch):
    """Second-level merge of SAMPLED (DAG) profiles through the DAG device
    kernel equals the host fill cell for cell."""
    from historian_tpu.utils.rng import MT19937

    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "0")
    model = RateModel.from_file(os.path.join(ref_data, "testamino.json"))
    seqs = read_fasta(os.path.join(ref_data, "gp120.fa"))[:4]
    for s in seqs:
        s.seq = s.seq[:160]  # divergent enough for forked samples, test-fast
    profs = [
        Profile.from_sequence(model.components, model.alphabet, s, i)
        for i, s in enumerate(seqs)
    ]
    hmm = PairHMM(ProbModel(model, 0.6), ProbModel(model, 0.4), model.ins_prob)
    f01 = ForwardMatrix(profs[0], profs[1], hmm, 4)
    f23 = ForwardMatrix(profs[2], profs[3], hmm, 5)
    p01 = f01.sample_profile(MT19937(5489), 10, 0)
    p23 = f23.sample_profile(MT19937(99), 10, 0)
    assert p01.as_chain() is None and p23.as_chain() is None  # genuine DAGs

    hmm2 = PairHMM(ProbModel(model, 0.3), ProbModel(model, 0.7), model.ins_prob)
    host = ForwardMatrix(p01, p23, hmm2, 6)
    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "1")
    from historian_tpu.ops import devicedp

    dev_cells = devicedp.dag_forward_cells(host)
    assert dev_cells is not None
    hc = host.cells[: host.x_size - 1, : host.y_size - 1]
    hx = np.where(np.isfinite(hc), hc, -1.0e99)
    dx = np.where(np.isfinite(dev_cells), dev_cells, -1.0e99)
    np.testing.assert_allclose(dx, hx, rtol=1e-9, atol=1e-9)


def test_dag_kernel_exact_bucket_size(ref_data, monkeypatch):
    """When the padded grid dim equals the real state count (SY == ny),
    the index-list padding must stay a no-op: padding entries carry the
    out-of-range sentinel SY, never a real column.  Regression for the
    round-2 advisor finding (padding with SY-1 scattered null-propagation
    values over the real last y column)."""
    from historian_tpu.utils.rng import MT19937

    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "0")
    model = RateModel.from_file(os.path.join(ref_data, "testamino.json"))
    seqs = read_fasta(os.path.join(ref_data, "gp120.fa"))[:4]
    for s in seqs:
        s.seq = s.seq[:160]
    profs = [
        Profile.from_sequence(model.components, model.alphabet, s, i)
        for i, s in enumerate(seqs)
    ]
    hmm = PairHMM(ProbModel(model, 0.6), ProbModel(model, 0.4), model.ins_prob)
    f01 = ForwardMatrix(profs[0], profs[1], hmm, 4)
    f23 = ForwardMatrix(profs[2], profs[3], hmm, 5)
    p01 = f01.sample_profile(MT19937(5489), 10, 0)
    p23 = f23.sample_profile(MT19937(99), 10, 0)

    hmm2 = PairHMM(ProbModel(model, 0.3), ProbModel(model, 0.7), model.ins_prob)
    host = ForwardMatrix(p01, p23, hmm2, 6)
    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "1")
    from historian_tpu.ops import devicedp

    monkeypatch.setattr(devicedp, "_bucket", lambda n: n)  # force SY == ny
    dev_cells = devicedp.dag_forward_cells(host)
    assert dev_cells is not None
    hc = host.cells[: host.x_size - 1, : host.y_size - 1]
    hx = np.where(np.isfinite(hc), hc, -1.0e99)
    dx = np.where(np.isfinite(dev_cells), dev_cells, -1.0e99)
    np.testing.assert_allclose(dx, hx, rtol=1e-9, atol=1e-9)


def test_col_kernel_matches_host_chain_x_dag_y(ref_data, monkeypatch):
    """Column-major kernel (chain x, sampled-profile DAG y) -- the
    dominant production merge shape -- equals the host fill cell for
    cell in f64."""
    from historian_tpu.utils.rng import MT19937

    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "0")
    model = RateModel.from_file(os.path.join(ref_data, "testamino.json"))
    seqs = read_fasta(os.path.join(ref_data, "gp120.fa"))[:3]
    for s in seqs:
        s.seq = s.seq[:160]
    profs = [
        Profile.from_sequence(model.components, model.alphabet, s, i)
        for i, s in enumerate(seqs)
    ]
    hmm = PairHMM(ProbModel(model, 0.6), ProbModel(model, 0.4), model.ins_prob)
    f01 = ForwardMatrix(profs[0], profs[1], hmm, 3)
    p01 = f01.sample_profile(MT19937(5489), 10, 0)
    assert p01.as_chain() is None and profs[2].as_chain() is not None

    hmm2 = PairHMM(ProbModel(model, 0.3), ProbModel(model, 0.7), model.ins_prob)
    host = ForwardMatrix(profs[2], p01, hmm2, 4)
    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "1")
    from historian_tpu.ops import devicedp

    dev_cells = devicedp.col_forward_cells(host)
    assert dev_cells is not None
    hc = host.cells[: host.x_size - 1, : host.y_size - 1]
    hx = np.where(np.isfinite(hc), hc, -1.0e99)
    dx = np.where(np.isfinite(dev_cells), dev_cells, -1.0e99)
    np.testing.assert_allclose(dx, hx, rtol=1e-9, atol=1e-9)


def test_col_kernel_banded_full_forward(ref_data, monkeypatch):
    """Column-major device fill under a guide envelope: the full
    ForwardMatrix (dispatch included) matches lp_end and cells."""
    from historian_tpu.core.alignpath import Alignment, GuideAlignmentEnvelope
    from historian_tpu.utils.rng import MT19937

    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "0")
    model = RateModel.from_file(os.path.join(ref_data, "testamino.json"))
    gapped = read_fasta(os.path.join(ref_data, "gp120.guide.fa"))[:3]
    for s in gapped:
        s.seq = s.seq[:200]
    align = Alignment.from_gapped(gapped)
    seqs = align.ungapped
    profs = [
        Profile.from_sequence(model.components, model.alphabet, s, i)
        for i, s in enumerate(seqs)
    ]
    hmm = PairHMM(ProbModel(model, 0.5), ProbModel(model, 0.5), model.ins_prob)
    env01 = GuideAlignmentEnvelope(align.path, 0, 1, 12)
    f01 = ForwardMatrix(profs[0], profs[1], hmm, 3, env01)
    p01 = f01.sample_profile(MT19937(5489), 10, 0)
    assert p01.as_chain() is None

    env = GuideAlignmentEnvelope(align.path, 2, 0, 12)
    host = ForwardMatrix(profs[2], p01, hmm, 4, env)
    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "1")
    dev = ForwardMatrix(profs[2], p01, hmm, 4, env)
    assert np.isfinite(dev.lp_end) and abs(dev.lp_end - host.lp_end) < 1e-9
    hc = np.where(np.isfinite(host.cells), host.cells, -1.0e99)
    dc = np.where(np.isfinite(dev.cells), dev.cells, -1.0e99)
    np.testing.assert_allclose(dc, hc, rtol=1e-9, atol=1e-9)


def test_dag_kernel_banded_full_forward(ref_data, monkeypatch):
    """DAG device fill under a guide envelope: lp_end and cells match."""
    from historian_tpu.core.alignpath import Alignment, GuideAlignmentEnvelope
    from historian_tpu.utils.rng import MT19937

    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "0")
    model = RateModel.from_file(os.path.join(ref_data, "testamino.json"))
    gapped = read_fasta(os.path.join(ref_data, "gp120.guide.fa"))[:3]
    for s in gapped:
        s.seq = s.seq[:200]
    align = Alignment.from_gapped(gapped)
    seqs = align.ungapped
    profs = [
        Profile.from_sequence(model.components, model.alphabet, s, i)
        for i, s in enumerate(seqs)
    ]
    hmm = PairHMM(ProbModel(model, 0.5), ProbModel(model, 0.5), model.ins_prob)
    env01 = GuideAlignmentEnvelope(align.path, 0, 1, 12)
    f01 = ForwardMatrix(profs[0], profs[1], hmm, 3, env01)
    p01 = f01.sample_profile(MT19937(5489), 10, 0)
    assert p01.as_chain() is None

    env = GuideAlignmentEnvelope(align.path, 0, 2, 12)
    host = ForwardMatrix(p01, profs[2], hmm, 4, env)
    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "1")
    dev = ForwardMatrix(p01, profs[2], hmm, 4, env)
    assert np.isfinite(dev.lp_end) and abs(dev.lp_end - host.lp_end) < 1e-9
    hc = np.where(np.isfinite(host.cells), host.cells, -1.0e99)
    dc = np.where(np.isfinite(dev.cells), dev.cells, -1.0e99)
    np.testing.assert_allclose(dc, hc, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("route", ["chain", "col"])
def test_factored_absorb_matches_scatter(ref_data, monkeypatch, route):
    """The O(S x CA) factored emission upload (device exp-space matmul,
    ops/devicedp._factored_absorb) must reproduce the O(band) value
    scatter cell-for-cell -- same fill, only the transport of the absorb
    tensor differs (engine/forward.py absorb_factors; SURVEY section 7
    'fuse emission einsums')."""
    from historian_tpu.utils.rng import MT19937

    model = RateModel.from_file(os.path.join(ref_data, "testamino.json"))
    seqs = read_fasta(os.path.join(ref_data, "PF16593.pair.fa"))
    x = Profile.from_sequence(model.components, model.alphabet, seqs[0], 0)
    y = Profile.from_sequence(model.components, model.alphabet, seqs[1], 1)
    hmm = PairHMM(ProbModel(model, 0.8), ProbModel(model, 0.4), model.ins_prob)
    if route == "col":
        # chain x DAG: sample a profile for y first (host fill)
        monkeypatch.setenv("HISTORIAN_DEVICE_DP", "0")
        fwd0 = ForwardMatrix(x, y, hmm, 2)
        y = fwd0.sample_profile(MT19937(5489), 5, 0)

    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "1")
    monkeypatch.setenv("HISTORIAN_FACTORED_ABSORB", "0")
    scat = ForwardMatrix(x, y, hmm, 2)
    monkeypatch.setenv("HISTORIAN_FACTORED_ABSORB", "1")
    fact = ForwardMatrix(x, y, hmm, 2)
    assert np.isfinite(fact.lp_end)
    assert abs(fact.lp_end - scat.lp_end) < 1e-9
    sc = np.where(np.isfinite(scat.cells), scat.cells, -1.0e99)
    fc = np.where(np.isfinite(fact.cells), fact.cells, -1.0e99)
    np.testing.assert_allclose(fc, sc, rtol=1e-9, atol=1e-9)


def test_latency_aware_routing_keeps_small_merges_on_host(ref_data, monkeypatch):
    """With a slow dispatch (simulated: a 28ms round trip), the cost
    model must route a gp120-sized merge to the host fill; forcing
    HISTORIAN_DEVICE_MIN_CELLS=0 must route it to the device."""
    from historian_tpu.ops import devicedp

    model = RateModel.from_file(os.path.join(ref_data, "testamino.json"))
    seqs = read_fasta(os.path.join(ref_data, "PF16593.pair.fa"))
    x = Profile.from_sequence(model.components, model.alphabet, seqs[0], 0)
    y = Profile.from_sequence(model.components, model.alphabet, seqs[1], 1)
    hmm = PairHMM(ProbModel(model, 0.8), ProbModel(model, 0.4), model.ins_prob)

    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "auto")
    monkeypatch.setattr(devicedp, "accel_backend", lambda: True)
    monkeypatch.setattr(devicedp, "dispatch_overhead_s", lambda: 0.028)
    calls = []
    monkeypatch.setattr(
        devicedp, "chain_forward_cells", lambda dp: calls.append("chain") or None
    )
    monkeypatch.setattr(devicedp, "enabled", lambda: True)
    fwd = ForwardMatrix(x, y, hmm, 2)
    assert calls == [], "small merge must not reach a device route"
    assert np.isfinite(fwd.lp_end)  # host fill ran

    # explicit override: threshold 0 -> device route attempted
    monkeypatch.setenv("HISTORIAN_DEVICE_MIN_CELLS", "0")
    fwd2 = ForwardMatrix(x, y, hmm, 2)
    assert np.isfinite(fwd2.lp_end)
    assert abs(fwd2.lp_end - fwd.lp_end) < 1e-9
