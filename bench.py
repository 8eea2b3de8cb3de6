#!/usr/bin/env python
"""Benchmark: pair-transducer Forward DP throughput on the accelerator.

Measures the flagship device kernel (historian_tpu.ops.pairforward:
5-state composed-transducer Forward fill, the hot loop of progressive
reconstruction -- reference forward.cpp:68-223) in f32, batched over a
fleet of protein-length pairs under the LG model, and compares against an
optimized single-core C++ re-creation of the reference's inner loop
(tools/bench_baseline.cpp, lookup-table LSE, -O3 -march=native) measured
on this same machine.

Prints ONE JSON line:
  {"metric": ..., "value": cells/s on accelerator, "unit": "cells/s",
   "vs_baseline": accelerator / single-core-C++}
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

BATCH = 128
X_LEN = 384
Y_LEN = 384
REPS = 24
SEED_PAIRS = 8  # distinct real pairs; tiled to BATCH

#: flops per 5-state DP cell (see ops/pairforward.py recurrences): 23
#: transition adds + ~18 logaddexp at ~5 flops each.  The emission
#: einsum is NOT in the timed region (absorb is precomputed), so MFU
#: here describes the DP recurrence alone -- vector log-sum-exp work
#: that the tensor cores never see, and the bf16-peak MFU is honest
#: about that.
DP_FLOPS_PER_CELL = 113
#: device peak (dense bf16 tensor-core rate) for the MFU denominator,
#: keyed by jax device_kind.  Source: NVIDIA H100 SXM data sheet (989
#: TFLOP/s dense bf16 at the 700 W limit).
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def _peak_flops() -> float:
    import jax

    kind = jax.devices()[0].device_kind
    if kind not in PEAK_FLOPS:
        raise KeyError(f"no peak FLOP/s recorded for device kind {kind!r}")
    return PEAK_FLOPS[kind]


def build_baseline() -> float:
    """Compile + run the C++ single-core baseline; returns cells/s."""
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "tools", "bench_baseline.cpp")
    exe = os.path.join(here, "tools", "bench_baseline")
    if not os.path.exists(exe) or os.path.getmtime(exe) < os.path.getmtime(src):
        subprocess.run(
            ["g++", "-O3", "-march=native", "-o", exe, src], check=True, capture_output=True
        )
    # 20-letter alphabet, 1 component, matching the device workload;
    # best of 3 runs (this host's scheduling noise easily halves one run)
    best = 0.0
    for _ in range(3):
        out = subprocess.run(
            [exe, str(X_LEN), str(Y_LEN), "20", "1", "3"],
            check=True, capture_output=True, text=True, timeout=600,
        )
        best = max(best, float(out.stdout.strip()))
    return best


def bench_device() -> float:
    """Measure the batched device pair-forward scan.

    Timing protocol (dispatch is asynchronous, so naive
    block_until_ready loops can under- or over-state): every iteration
    gets DISTINCT inputs (a per-iteration emission shift,
    defeating any result caching along the dispatch path), all REPS
    results are reduced into one scalar on device (a data dependency on
    every iteration), and the clock stops only after that scalar reaches
    the host.  The single device->host round trip is amortised over REPS.
    """
    import jax
    import jax.numpy as jnp

    from historian_tpu.models.presets import named_model
    from historian_tpu.ops.pairforward import chain_pair_forward_arrays, pair_forward

    model = named_model("lg")
    rng = np.random.RandomState(42)
    alpha = model.alphabet.symbols

    def random_seq(n):
        return "".join(alpha[i] for i in rng.randint(0, 20, size=n))

    pairs = []
    for _ in range(SEED_PAIRS):
        a, _ = chain_pair_forward_arrays(
            model, random_seq(X_LEN), random_seq(Y_LEN), 0.5, 0.5, dtype=np.float32
        )
        pairs.append(a)
    tile = BATCH // SEED_PAIRS
    absorb = jnp.tile(jnp.stack([a[0] for a in pairs]), (tile, 1, 1))
    rsx = jnp.tile(jnp.stack([a[1] for a in pairs]), (tile, 1))
    rsy = jnp.tile(jnp.stack([a[2] for a in pairs]), (tile, 1))
    ix = jnp.tile(jnp.stack([a[3] for a in pairs]), (tile, 1))
    iy = jnp.tile(jnp.stack([a[4] for a in pairs]), (tile, 1))
    mask = pairs[0][5]
    trans = pairs[0][6]

    def scan_kernel(a, rx, ry, jx, jy):
        def one(ab, r1, r2, j1, j2):
            _, lp = pair_forward(ab, r1, r2, j1, j2, mask, trans)
            return lp

        return jax.vmap(one)(a, rx, ry, jx, jy)

    def measure(kernel, reps=REPS) -> float:
        @jax.jit
        def step(eps):
            # eps shifts every emission: distinct inputs per iteration
            return jnp.sum(kernel(absorb + eps, rsx, rsy, ix, iy))

        warm = float(step(jnp.float32(0.0)))  # compile + sanity
        assert np.isfinite(warm), "non-finite forward likelihoods"
        t0 = time.perf_counter()
        accs = [step(jnp.float32(1e-4 * (k + 1))) for k in range(reps)]
        total = float(jnp.sum(jnp.stack(accs)))  # blocks on every iteration
        t1 = time.perf_counter()
        assert np.isfinite(total)
        cells = BATCH * (X_LEN + 1) * (Y_LEN + 1) * 5 * reps
        return cells / (t1 - t0)

    measure(scan_kernel)  # throwaway warm pass
    return max(measure(scan_kernel, reps=4 * REPS) for _ in range(3))


def _production_merge(tiny: bool = False):
    """Build the real production merge workload: gp120 leaf chain x
    sampled-profile DAG under LG (the dominant GPU recon merge shape; reference hot loop forward.cpp:78-203).  Host fill
    (native) so the returned ForwardMatrix doubles as the baseline
    oracle.  Returns (dp, n_cells_in_band).

    tiny=True shrinks the sequences so the fast test tier can exercise
    every code path of this probe in milliseconds (guard against probes
    silently breaking)."""
    import os

    from historian_tpu.core.seqs import read_fasta
    from historian_tpu.engine.forward import ForwardMatrix
    from historian_tpu.engine.pairhmm import PairHMM
    from historian_tpu.engine.profile import Profile
    from historian_tpu.models.presets import named_model
    from historian_tpu.models.ratemodel import ProbModel
    from historian_tpu.utils.rng import MT19937

    prev = os.environ.get("HISTORIAN_DEVICE_DP")
    os.environ["HISTORIAN_DEVICE_DP"] = "0"
    try:
        model = named_model("lg")
        seqs = read_fasta("/root/reference/data/gp120.fa")[:3]
        if tiny:
            seqs = [type(s)(name=s.name, seq=s.seq[:48]) for s in seqs]
        profs = [
            Profile.from_sequence(model.components, model.alphabet, s, i)
            for i, s in enumerate(seqs)
        ]
        hmm = PairHMM(ProbModel(model, 0.6), ProbModel(model, 0.4), model.ins_prob)
        fwd01 = ForwardMatrix(profs[0], profs[1], hmm, 3)
        p01 = fwd01.sample_profile(MT19937(5489), 10, 0)
        hmm2 = PairHMM(ProbModel(model, 0.3), ProbModel(model, 0.7), model.ins_prob)
        dp = ForwardMatrix(profs[2], p01, hmm2, 4)
    finally:
        if prev is None:
            os.environ.pop("HISTORIAN_DEVICE_DP", None)
        else:
            os.environ["HISTORIAN_DEVICE_DP"] = prev
    n_cells = int(np.count_nonzero(dp.env_mask[: dp.x_size - 1, : dp.y_size - 1])) * 5
    return dp, n_cells


def bench_production_col_kernel(tiny: bool = False) -> dict:
    """The SHIPPED production merge route (ops/devicedp.col_forward_cells:
    column scan + band-compacted IO + host prep), measured
    end-to-end per merge on a REAL captured gp120 merge (leaf chain x
    10-trace sampled profile).  Two variants:

    - full-readback (what BackwardMatrix-consuming merges pay),
      reported as state-cells/s including host prep + readback;
    - device-resident (keep=True + lp_end + 11 traces on device, what
      default GPU recon pays per merge).

    Baseline: the host-native (C++ OpenMP) fill of the SAME merge in
    this process, same boundary (absorb precompute excluded from both).
    Distinct inputs per rep (absorb shift) defeat result caching.
    """
    from historian_tpu.ops import devicedp

    dp, n_cells = _production_merge(tiny)
    base_absorb = dp.absorb.copy()
    fx0, sxs0, fy0, mys0 = dp.absorb_factors

    def perturb(k):
        # distinct inputs per rep on BOTH transports (value scatter reads
        # dp.absorb; the factored matmul reads absorb_factors); absorb and
        # absorb_factors are lazy read-only properties, so write the
        # backing fields directly
        eps = np.float64(1e-4 * k)
        dp._absorb = base_absorb + eps
        dp._absorb_factors = (fx0, sxs0 + eps, fy0, mys0)

    # -- baseline: host native fill of the same merge
    host_reps = 1 if tiny else 4
    dp._fill_native()  # warm (arena, pages)
    t0 = time.perf_counter()
    for k in range(host_reps):
        perturb(k + 1)
        assert dp._fill_native()
    t_host = (time.perf_counter() - t0) / host_reps
    host_rate = n_cells / t_host

    # -- device full-readback route
    out = devicedp.col_forward_cells(dp)
    assert out is not None, "col route not taken on the captured merge"
    reps = 1 if tiny else 8
    t0 = time.perf_counter()
    for k in range(reps):
        perturb(k + 1)
        out = devicedp.col_forward_cells(dp)
    t_dev = (time.perf_counter() - t0) / reps
    assert np.isfinite(out[np.asarray(dp.env_mask[: dp.x_size - 1, : dp.y_size - 1])]).any()
    prep_s, dispatch_s, readback_s = devicedp.LAST_SPLIT
    dev_rate = n_cells / t_dev

    # -- device-resident route (fill + lp_end + best + 10 sampled traces)
    def resident(k):
        perturb(k + 1)
        h = devicedp.col_forward_device(dp)
        assert h is not None
        lp, traces = h.lp_end_and_traces(10, True, 1000 + k)
        assert np.isfinite(lp) and len(traces) == 11
        return lp

    resident(0)  # warm/compile
    res_reps = 1 if tiny else 8
    t0 = time.perf_counter()
    for k in range(res_reps):
        resident(k + 1)
    t_res = (time.perf_counter() - t0) / res_reps
    devicedp.observe_resident_merge(n_cells, dp.x_size + dp.y_size, t_res)

    # what GPU recon actually executes for THIS merge: the
    # latency-aware router compares both engines (devicedp.merge_on_device)
    router_device = devicedp.merge_on_device(n_cells, dp.x_size + dp.y_size)
    shipped_rate = dev_rate if router_device else host_rate
    return {
        "unit": "state-cells/s",
        "workload": f"gp120 merge x={dp.x_size - 1} y={dp.y_size - 1} states",
        "value": round(shipped_rate),
        "router_choice": "device" if router_device else "host",
        "device_rate": round(dev_rate),
        "baseline": round(host_rate),
        "baseline_src": "host native (C++ OpenMP) fill, same merge, this host",
        "vs_baseline": round(shipped_rate / host_rate, 3),
        "merge_wall_s": round(t_dev, 4),
        "split_s": {
            "prep": round(prep_s, 4),
            "dispatch": round(dispatch_s, 4),
            "readback": round(readback_s, 4),
        },
        "resident_merge_s": round(t_res, 4),
        "host_merge_wall_s": round(t_host, 4),
    }


def bench_router_crossover(tiny: bool = False) -> dict:
    """Host-vs-device per-merge wall at growing banded chain x chain
    merge sizes: the measurement the router's cost model
    (ops/devicedp.merge_on_device) is calibrated against.  Each size
    builds a real ForwardMatrix over synthetic protein chains under a
    |i-j| <= W guide band and times (a) the host OpenMP wavefront fill
    and (b) the device-resident route (fill + lp_end), both with
    distinct emissions per rep.  Reports per-size walls and the first
    size where the device wins."""
    import jax

    from historian_tpu.core.alignpath import GuideAlignmentEnvelope
    from historian_tpu.engine.forward import ForwardMatrix
    from historian_tpu.engine.pairhmm import PairHMM
    from historian_tpu.engine.profile import Profile
    from historian_tpu.models.presets import named_model
    from historian_tpu.models.ratemodel import ProbModel
    from historian_tpu.ops import devicedp

    from historian_tpu.core.seqs import FastSeq

    model = named_model("lg")
    rng = np.random.RandomState(7)
    alpha = model.alphabet.symbols
    rows = []
    crossover = None
    sizes = ((64, 16),) if tiny else ((1500, 128), (3000, 256), (6000, 768), (12000, 768))
    for L, W in sizes:
        seq_x = FastSeq(name="x", seq="".join(alpha[i] for i in rng.randint(0, 20, size=L)))
        seq_y = FastSeq(name="y", seq="".join(alpha[i] for i in rng.randint(0, 20, size=L)))
        x = Profile.from_sequence(model.components, model.alphabet, seq_x, 0)
        y = Profile.from_sequence(model.components, model.alphabet, seq_y, 1)
        hmm = PairHMM(ProbModel(model, 0.5), ProbModel(model, 0.5), model.ins_prob)
        ones = np.ones(L, dtype=bool)
        env = GuideAlignmentEnvelope({0: ones, 1: ones}, 0, 1, W)
        prev = os.environ.get("HISTORIAN_DEVICE_DP")
        os.environ["HISTORIAN_DEVICE_DP"] = "0"
        try:
            dp = ForwardMatrix(x, y, hmm, 2, env)
        finally:
            if prev is None:
                os.environ.pop("HISTORIAN_DEVICE_DP", None)
            else:
                os.environ["HISTORIAN_DEVICE_DP"] = prev
        n_cells = int(np.count_nonzero(dp.env_mask)) * 5
        base_absorb = dp.absorb.copy()
        fx0, sxs0, fy0, mys0 = dp.absorb_factors

        def perturb(k):
            # distinct inputs per rep on BOTH transports (value scatter
            # reads dp.absorb; the factored matmul reads absorb_factors);
            # write the backing fields of the lazy read-only properties
            eps = np.float64(1e-4 * k)
            dp._absorb = base_absorb + eps
            dp._absorb_factors = (fx0, sxs0 + eps, fy0, mys0)

        def host_once(k):
            perturb(k)
            assert dp._fill_native()

        host_once(0)  # warm pages
        t0 = time.perf_counter()
        reps = 1 if tiny else 3
        for k in range(reps):
            host_once(k + 1)
        t_host = (time.perf_counter() - t0) / reps

        def dev_once(k):
            perturb(k)
            h = devicedp.col_forward_device(dp)
            if h is not None:
                lp, _ = h.lp_end_and_traces(0, True, 1)
                return lp
            cells = devicedp.chain_forward_cells(dp)
            assert cells is not None
            return float(cells[0, 0, 0])

        t_dev = None
        try:
            dev_once(0)  # compile + warm
            t0 = time.perf_counter()
            for k in range(reps):
                dev_once(k + 1)
            t_dev = (time.perf_counter() - t0) / reps
            # self-calibration: the router's prediction below must track
            # what was just measured (host fills self-report via the
            # _fill_native hook; the resident wall re-fits step_s)
            devicedp.observe_resident_merge(n_cells, dp.x_size + dp.y_size, t_dev)
        except Exception as e:
            rows.append({"L": L, "W": W, "state_cells": n_cells,
                         "host_s": round(t_host, 3), "device": f"error: {e}"[:120]})
            continue
        from historian_tpu.parallel import spmerge

        rows.append({
            "L": L, "W": W, "state_cells": n_cells,
            "host_s": round(t_host, 4), "device_s": round(t_dev, 4),
            "device_wins": bool(t_dev < t_host),
            "router_predicts_device": bool(
                devicedp.merge_on_device(n_cells, dp.x_size + dp.y_size)
            ),
            # what an 8-chip `-mesh` would do with this merge: route it
            # through the SP ring (parallel/spmerge) once the sharded-away
            # per-column work beats the ring latency
            "sp_8dev_predicted": bool(spmerge.sp_merge_wins(dp, 8)),
        })
        if crossover is None and t_dev < t_host:
            crossover = n_cells
    return {
        "unit": "seconds per merge (host OpenMP vs device route)",
        "sizes": rows,
        "crossover_state_cells": crossover,
        "dispatch_overhead_ms": round(devicedp.dispatch_overhead_s() * 1e3, 2),
    }


def bench_codon(tiny: bool = False) -> dict:
    """Headline scan at codon scale (C*A = 61; the emission einsum --
    not timed here -- is where the matmul share grows).  Baseline: the
    single-core C++ loop on the same 61-letter workload."""
    import jax
    import jax.numpy as jnp

    from historian_tpu.models.presets import named_model
    from historian_tpu.ops.pairforward import chain_pair_forward_arrays, pair_forward

    model = named_model("ECMrest")
    rng = np.random.RandomState(11)
    n_tok = model.alphabet.size
    xl = yl = 16 if tiny else 192
    batch = 4 if tiny else 32
    syms = [model.alphabet.symbol(i) for i in range(n_tok)]

    def random_codon_seq(n):
        return "".join(syms[i] for i in rng.randint(0, n_tok, size=n))

    arrs = [
        chain_pair_forward_arrays(
            model, random_codon_seq(xl), random_codon_seq(yl), 0.5, 0.5,
            dtype=np.float32,
        )[0]
        for _ in range(4)
    ]
    tile = batch // 4
    absorb = jnp.tile(jnp.stack([a[0] for a in arrs]), (tile, 1, 1))
    rsx = jnp.tile(jnp.stack([a[1] for a in arrs]), (tile, 1))
    rsy = jnp.tile(jnp.stack([a[2] for a in arrs]), (tile, 1))
    ix = jnp.tile(jnp.stack([a[3] for a in arrs]), (tile, 1))
    iy = jnp.tile(jnp.stack([a[4] for a in arrs]), (tile, 1))
    mask, trans = arrs[0][5], arrs[0][6]

    def one(ab, r1, r2, j1, j2):
        return pair_forward(ab, r1, r2, j1, j2, mask, trans)[1]

    @jax.jit
    def step(eps):
        return jnp.sum(jax.vmap(one)(absorb + eps, rsx, rsy, ix, iy))

    float(step(jnp.float32(0.0)))
    reps = 2 if tiny else 16
    t0 = time.perf_counter()
    accs = [step(jnp.float32(1e-4 * (k + 1))) for k in range(reps)]
    total = float(jnp.sum(jnp.stack(accs)))
    t1 = time.perf_counter()
    assert np.isfinite(total)
    rate = batch * (xl + 1) * (yl + 1) * 5 * reps / (t1 - t0)

    here = os.path.dirname(os.path.abspath(__file__))
    exe = os.path.join(here, "tools", "bench_baseline")
    base = 0.0
    if not tiny:  # the C++ baseline subprocess is not part of the probe path
        for _ in range(3):
            out = subprocess.run(
                [exe, str(xl), str(yl), "61", "1", "3"],
                check=True, capture_output=True, text=True, timeout=600,
            )
            base = max(base, float(out.stdout.strip()))
    return {
        "unit": "state-cells/s",
        "workload": f"ECMrest batch={batch} {xl}x{yl}",
        "value": round(rate),
        "baseline": round(base),
        "baseline_src": "single-core C++ (tools/bench_baseline.cpp), A=61, this host",
        "vs_baseline": round(rate / base, 3) if base else None,
    }


def bench_roofline(tiny: bool = False) -> dict:
    """Empirical attainable bound for the DP recurrence.

    The 5-state Forward DP is LOGSUMEXP-BOUND: the recurrence has no
    matmul, so bf16 tensor-core MFU is structurally irrelevant -- the
    honest ceiling is how many dependent logaddexp ops the vector units
    sustain.  Measure it directly: a K-deep chained jnp.logaddexp over a
    4 MB block (compute-bound: one load/store per K ops), then divide by
    the ~18 lse per state-cell to get the attainable state-cells/s the
    headline kernel is chasing."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    N = 1 << 12 if tiny else 1 << 20  # f32 elements (4 MB block)
    K = 4 if tiny else 64

    @partial(jax.jit, static_argnames="reps")
    def chain_all(x, c0, reps):
        # ALL reps inside one jit: exactly one dispatch + one scalar
        # readback, so dispatch latency cannot masquerade as compute
        def rep(v, c):
            def body(i, u):
                return jnp.logaddexp(u, u * c)

            v = jax.lax.fori_loop(0, K, body, v)
            return v, v[0, 0]

        _, lasts = jax.lax.scan(rep, x, c0)
        return jnp.sum(lasts)

    x = jnp.full((8, N // 8), -1.0, jnp.float32)

    def timed(reps):
        cs = jnp.float32(0.999) - 1e-6 * jnp.arange(reps, dtype=jnp.float32)
        float(chain_all(x, cs, reps))  # compile + warm
        t0 = time.perf_counter()
        assert np.isfinite(float(chain_all(x, cs + 1e-7, reps)))
        return time.perf_counter() - t0

    # differential: the (dt2 - dt1) slope cancels dispatch/readback RTT
    r1, r2 = (2, 4) if tiny else (64, 192)
    dt1, dt2 = timed(r1), timed(r2)
    lse_per_s = N * K * (r2 - r1) / max(dt2 - dt1, 1e-9)
    LSE_PER_CELL = 18  # logaddexp ops per 5-state cell (ops/pairforward)
    attain = lse_per_s / LSE_PER_CELL
    return {
        "unit": "lse/s (chained logaddexp, 4 MB block)",
        "vpu_lse_per_s": round(lse_per_s),
        "lse_per_state_cell": LSE_PER_CELL,
        "attainable_state_cells_per_s": round(attain),
        "note": "the DP is lse-bound on the vector units; "
                "bf16 tensor-core MFU is not the relevant ceiling",
    }


def bench_mcmc_batch(tiny: bool = False) -> dict:
    """Device-BATCHED sibling proposal fills vs the host native fill:
    K proposal grids bucket-padded into one dispatch
    (ops/siblingdp.sibling_forward_batch) so the per-dispatch round trip
    amortizes K-fold.  Reports amortized per-proposal walls both ways;
    production routing stays host unless the batch wins (the MH chain is
    sequential, so only cross-dataset/speculative proposals can batch --
    see SiblingMatrix.fill_batch)."""
    from historian_tpu.core.alignpath import GuideAlignmentEnvelope
    from historian_tpu.core.tree import Tree
    from historian_tpu.engine.treealign import get_conditional_pwms
    from historian_tpu.models.presets import named_model
    from historian_tpu.sampler.sibling import SiblingMatrix
    from historian_tpu.sampler.simulator import simulate_tree
    from historian_tpu.utils.rng import MT19937

    model = named_model("lg")
    rng = np.random.RandomState(17)
    n_leaves = 6 if tiny else 24
    sim_len = 40 if tiny else 300
    pts = np.sort(rng.uniform(0.05, 1.0, n_leaves))
    dist = np.abs(pts[:, None] - pts[None, :]) + 0.05
    np.fill_diagonal(dist, 0.0)
    tree = Tree.upgma([f"L{i}" for i in range(n_leaves)], dist)
    tree.assign_internal_node_names()
    stock = simulate_tree(MT19937(3), model, tree, sim_len)
    rows = tree.reorder_seqs(stock.gapped)

    def build(defer):
        mats = []
        for node in range(tree.n_nodes()):
            if tree.is_leaf(node):
                continue
            l_c, r_c = tree.children(node)
            exclude = {l_c: node, r_c: node}
            pwms = get_conditional_pwms(model, tree, rows, exclude)
            mats.append(SiblingMatrix(
                model, pwms[l_c], pwms[r_c],
                tree.branch_length(l_c), tree.branch_length(r_c),
                GuideAlignmentEnvelope(),
                np.arange(len(pwms[l_c]) + 1), np.arange(len(pwms[r_c]) + 1),
                l_c, r_c, node, defer_fill=True,
            ))
            if defer and len(mats) >= (3 if tiny else 16):
                break
            if not defer and len(mats) >= (3 if tiny else 16):
                break
        return mats

    K = 3 if tiny else 16
    host_mats = build(defer=False)[:K]
    t0 = time.perf_counter()
    for m in host_mats:
        m._fill()  # router default: native OpenMP wavefront
    host_s = (time.perf_counter() - t0) / len(host_mats)

    batch_mats = build(defer=True)[:K]
    assert SiblingMatrix.fill_batch(batch_mats)  # warm/compile
    rebatch = build(defer=True)[:K]
    t0 = time.perf_counter()
    assert SiblingMatrix.fill_batch(rebatch)
    batch_s = (time.perf_counter() - t0) / len(rebatch)

    # agreement spot-check (f64 round-off class)
    worst = max(abs(a.lp_end - b.lp_end) for a, b in zip(host_mats, rebatch))
    cells = sum(m.x_size * m.y_size * 11 for m in rebatch)
    return {
        "unit": "s/proposal (amortized)",
        "workload": f"{tree.n_nodes()}-node chain, K={len(rebatch)} sibling grids, "
                    f"{cells} state-cells/batch",
        "host_native_s_per_proposal": round(host_s, 5),
        "device_batched_s_per_proposal": round(batch_s, 5),
        "batch_speedup_vs_host": round(host_s / batch_s, 3) if batch_s else None,
        "lp_end_worst_abs_diff": float(worst),
        "routed": "host (batch stays opt-in unless it wins; the MH chain "
                  "is sequential, so production batches need independent "
                  "chains -- SiblingMatrix.fill_batch docstring)",
    }


def bench_tropical(tiny: bool = False) -> dict:
    """Max-plus (Viterbi) pair kernel vs the logsumexp Forward kernel on
    the identical batched workload (the Forward kernel is lse-bound, so
    the only way past it is fewer lse/cell -- the tropical semiring
    drops all of them).  Sound for the
    stages where the reference itself runs Viterbi (guide alignment,
    refiner sweeps, feasibility probes); see ops/tropical.py for the
    routing note."""
    import jax
    import jax.numpy as jnp

    from historian_tpu.models.presets import named_model
    from historian_tpu.ops.pairforward import chain_pair_forward_arrays, pair_forward
    from historian_tpu.ops.tropical import tropical_pair_forward

    model = named_model("lg")
    rng = np.random.RandomState(21)
    alpha = model.alphabet.symbols
    xl = yl = 48 if tiny else X_LEN
    batch = 8 if tiny else BATCH
    seed_pairs = 4 if tiny else SEED_PAIRS

    def random_seq(n):
        return "".join(alpha[i] for i in rng.randint(0, 20, size=n))

    pairs = [
        chain_pair_forward_arrays(model, random_seq(xl), random_seq(yl), 0.5, 0.5,
                                  dtype=np.float32)[0]
        for _ in range(seed_pairs)
    ]
    tile = batch // seed_pairs
    absorb = jnp.tile(jnp.stack([a[0] for a in pairs]), (tile, 1, 1))
    rsx = jnp.tile(jnp.stack([a[1] for a in pairs]), (tile, 1))
    rsy = jnp.tile(jnp.stack([a[2] for a in pairs]), (tile, 1))
    ix = jnp.tile(jnp.stack([a[3] for a in pairs]), (tile, 1))
    iy = jnp.tile(jnp.stack([a[4] for a in pairs]), (tile, 1))
    mask = pairs[0][5]
    trans = pairs[0][6]

    def measure(kernel_one, reps):
        @jax.jit
        def step(eps):
            def one(ab, r1, r2, j1, j2):
                _, lp = kernel_one(ab, r1, r2, j1, j2, mask, trans)
                return lp

            return jnp.sum(jax.vmap(one)(absorb + eps, rsx, rsy, ix, iy))

        assert np.isfinite(float(step(jnp.float32(0.0))))
        t0 = time.perf_counter()
        accs = [step(jnp.float32(1e-4 * (k + 1))) for k in range(reps)]
        total = float(jnp.sum(jnp.stack(accs)))
        t1 = time.perf_counter()
        assert np.isfinite(total)
        return batch * (xl + 1) * (yl + 1) * 5 * reps / (t1 - t0)

    reps = 2 if tiny else 24
    # interleaved A/B (both warmed above) so host weather hits both arms
    trop = lse = 0.0
    for _ in range(1 if tiny else 3):
        trop = max(trop, measure(tropical_pair_forward, reps))
        lse = max(lse, measure(pair_forward, reps))
    return {
        "unit": "state-cells/s",
        "workload": f"LG batch={batch} {xl}x{yl} (scan kernels, same inputs)",
        "tropical_cells_per_s": round(trop),
        "forward_lse_cells_per_s": round(lse),
        "tropical_speedup": round(trop / lse, 3) if lse else None,
        "routing_note": (
            "sound where the reference runs Viterbi: guide stage "
            "(quickalign.cpp:61-94; ours already max-plus), refiner "
            "(refiner.cpp:10-103), band-retry feasibility; NOT for "
            "production merge fills/counts/posteriors (ops/tropical.py)"
        ),
    }


def bench_mcmc_router(tiny: bool = False) -> dict:
    """MCMC proposal-fill routing: steps/s on a ~300-node co-sampling
    chain with the default router (sibling/branch fills pick host
    native vs device by backend + grid size) vs the device fills FORCED
    on.  Only >2M-cell proposal grids go to the GPU by default."""
    from historian_tpu.core.tree import Tree
    from historian_tpu.engine.treealign import History, SimpleTreePrior
    from historian_tpu.models.presets import named_model
    from historian_tpu.sampler.sampler import Sampler
    from historian_tpu.sampler.simulator import simulate_tree
    from historian_tpu.utils.rng import MT19937

    from historian_tpu.models.ratemodel import CachingRateModel

    model = CachingRateModel(named_model("lg"))  # production wrap, recon.cpp:1320
    rng = np.random.RandomState(99)
    n_leaves = 8 if tiny else 150
    pts = np.sort(rng.uniform(0.05, 1.0, n_leaves))
    dist = np.abs(pts[:, None] - pts[None, :]) + 0.05
    np.fill_diagonal(dist, 0.0)
    tree = Tree.upgma([f"L{i}" for i in range(n_leaves)], dist)
    tree.assign_internal_node_names()
    stock = simulate_tree(MT19937(1), model, tree, 30 if tiny else 180)
    rows = tree.reorder_seqs(stock.gapped)

    def chain(steps: int, seed: int) -> float:
        sampler = Sampler(model, SimpleTreePrior(), rows, name="bench")
        sampler.initialize(History(gapped=rows, tree=tree))
        mt = MT19937(seed)
        for _ in range(1 if tiny else 5):  # warm (memos, compiles)
            sampler.sample(mt)
        t0 = time.perf_counter()
        for _ in range(steps):
            sampler.sample(mt)
        return steps / (time.perf_counter() - t0)

    auto_rate = chain(4 if tiny else 60, 7)
    saved = {
        k: os.environ.get(k)
        for k in ("HISTORIAN_DEVICE_SIBLING", "HISTORIAN_DEVICE_BRANCH")
    }
    os.environ["HISTORIAN_DEVICE_SIBLING"] = "1"
    os.environ["HISTORIAN_DEVICE_BRANCH"] = "1"
    try:
        forced_rate = chain(2 if tiny else 8, 7)
    except Exception as e:
        forced_rate = None
        forced_err = f"{type(e).__name__}: {e}"[:120]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = {
        "unit": "MH steps/s",
        "workload": f"{tree.n_nodes()}-node simulated ultrametric chain, LG",
        "router_auto_steps_per_s": round(auto_rate, 2),
        "forced_device_steps_per_s": (
            round(forced_rate, 2) if forced_rate else forced_err
        ),
        "router_advantage": (
            round(auto_rate / forced_rate, 2) if forced_rate else None
        ),
    }
    return out


def bench_fit_estep(tiny: bool = False) -> dict:
    """The fit/count hot loop (reference forward.cpp:1183-1214 analogue):
    Felsenstein up/down fill + eigencount contraction over alignment
    columns on device (parallel/pcounts, the -mesh production path).
    Returns column-cells/s = columns x branches x A^2 per second."""
    import jax
    from jax.sharding import Mesh

    from historian_tpu.models.presets import named_model
    from historian_tpu.core.tree import Tree
    from historian_tpu.parallel import pcounts

    model = named_model("lg")
    # a 31-node balanced tree with unit branches
    def nwk(depth):
        if depth == 0:
            nwk.i += 1
            return f"L{nwk.i}:0.3"
        return f"({nwk(depth - 1)},{nwk(depth - 1)}):0.3"
    nwk.i = 0
    tree = Tree(nwk(4) + ";")
    n_leaves = 16
    L = 64 if tiny else 4096  # 5e7 column-cells/rep: above every small-work
    # pin, enough to amortize dispatch so the ratio measures the E-step
    rng = np.random.RandomState(5)
    alpha = model.alphabet.symbols
    row_sets = []
    for s in range(3):
        leaf_rows = ["".join(alpha[i] for i in rng.randint(0, 20, size=L))
                     for _ in range(n_leaves)]
        rows = []
        li = 0
        for n in range(tree.n_nodes()):
            if tree.is_leaf(n):
                rows.append(leaf_rows[li]); li += 1
            else:
                rows.append("*" * L)
        row_sets.append(rows)
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    pcounts.sharded_alignment_eigen_counts(model, tree, row_sets[0], mesh)  # warm
    reps = 1 if tiny else 6
    t0 = time.perf_counter()
    for k in range(reps):
        c = pcounts.sharded_alignment_eigen_counts(model, tree, row_sets[k % 3], mesh)
    t1 = time.perf_counter()
    a = model.alphabet.size
    rate = L * (tree.n_nodes() - 1) * a * a * reps / (t1 - t0)

    # baseline: the host (engine/sumprod, CPU backend) count path on the
    # SAME workload, in a fresh CPU subprocess so backend state cannot leak
    script = (
        "import sys, os\n"
        "sys.path.insert(0, '/root/repo')\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        "import time, numpy as np\n"
        "from historian_tpu.models.presets import named_model\n"
        "from historian_tpu.core.tree import Tree\n"
        "from historian_tpu.engine.sumprod import SumProductEngine\n"
        "model = named_model('lg')\n"
        "def nwk(d):\n"
        "    if d == 0:\n"
        "        nwk.i += 1; return f'L{nwk.i}:0.3'\n"
        "    return f'({nwk(d-1)},{nwk(d-1)}):0.3'\n"
        "nwk.i = 0\n"
        "tree = Tree(nwk(4) + ';')\n"
        "L = 4096\n"
        "rng = np.random.RandomState(5)\n"
        "alpha = model.alphabet.symbols\n"
        "row_sets = []\n"
        "for s in range(3):\n"
        "    lr = [''.join(alpha[i] for i in rng.randint(0, 20, size=L)) for _ in range(16)]\n"
        "    rows = []; li = 0\n"
        "    for n in range(tree.n_nodes()):\n"
        "        if tree.is_leaf(n): rows.append(lr[li]); li += 1\n"
        "        else: rows.append('*' * L)\n"
        "    row_sets.append(rows)\n"
        "eng = SumProductEngine(model, tree)\n"
        "C, A = model.components, model.alphabet.size\n"
        "def count(rows):\n"
        "    f = eng.fill(rows)\n"
        "    rc = np.zeros((C, A)); ec = np.zeros((C, A, A), complex)\n"
        "    f.accumulate_root_counts(rc); f.accumulate_eigen_counts(rc, ec)\n"
        "    return ec\n"
        "count(row_sets[0])\n"
        "reps = 3\n"
        "t0 = time.perf_counter()\n"
        "for k in range(reps): count(row_sets[k % 3])\n"
        "t1 = time.perf_counter()\n"
        "print(L * (tree.n_nodes() - 1) * A * A * reps / (t1 - t0))\n"
    )
    base = None
    if not tiny:  # the CPU-subprocess baseline (script pins L=4096) is not the probe path
        try:
            env = {k: v for k, v in os.environ.items()}
            env["JAX_PLATFORMS"] = "cpu"
            proc = subprocess.run(
                [sys.executable, "-c", script], capture_output=True, text=True,
                timeout=900, env=env,
            )
            base = float(proc.stdout.strip().splitlines()[-1])
        except Exception:
            pass
    return {
        "unit": "column-cells/s (columns x branches x A^2)",
        "workload": "31-node tree, L=4096, LG",
        "value": round(rate),
        "baseline": round(base) if base else None,
        "baseline_src": "host engine/sumprod count path, CPU subprocess, this host",
        "vs_baseline": round(rate / base, 3) if base else None,
    }


def _extras_digest(extras: dict) -> dict:
    """Tiny scalar summary of the extras for the printed headline line.
    The full extras go to chiprun_out/bench_extras.json; the ONE printed
    line must stay short enough to survive a tail capture."""
    d = {}
    p = extras.get("production_col_forward")
    if isinstance(p, dict):
        d["production_merge_vs_host"] = p.get("vs_baseline")
        d["production_router"] = p.get("router_choice")
        d["production_device_rate"] = p.get("device_rate")
    r = extras.get("router_crossover")
    if isinstance(r, dict):
        d["router_crossover_cells"] = r.get("crossover_state_cells")
        sizes = r.get("sizes") or []
        d["router_mispredicts"] = sum(
            1 for s in sizes
            if isinstance(s, dict) and "device_wins" in s
            and s["device_wins"] != s.get("router_predicts_device")
        )
    f = extras.get("fit_estep")
    if isinstance(f, dict):
        d["fit_estep_vs_host"] = f.get("vs_baseline")
    rl = extras.get("roofline")
    if isinstance(rl, dict):
        d["attainable_cells_per_s"] = rl.get("attainable_state_cells_per_s")
    m = extras.get("mcmc_router")
    if isinstance(m, dict):
        d["mcmc_steps_per_s"] = m.get("router_auto_steps_per_s")
        d["mcmc_router_advantage"] = m.get("router_advantage")
    c = extras.get("codon_pair_forward")
    if isinstance(c, dict):
        d["codon_vs_cpp"] = c.get("vs_baseline")
    mb = extras.get("mcmc_batch")
    if isinstance(mb, dict):
        d["mcmc_batch_vs_host"] = mb.get("batch_speedup_vs_host")
    tr = extras.get("tropical")
    if isinstance(tr, dict):
        d["tropical_speedup"] = tr.get("tropical_speedup")
    return d


def main() -> None:
    import jax

    device_rate = bench_device()
    try:
        baseline_rate = build_baseline()
    except Exception:
        baseline_rate = float("nan")
    vs = device_rate / baseline_rate if baseline_rate == baseline_rate else None
    flops = device_rate * DP_FLOPS_PER_CELL
    extras = {}
    for name, fn in (
        ("roofline", bench_roofline),
        ("production_col_forward", bench_production_col_kernel),
        ("router_crossover", bench_router_crossover),
        ("codon_pair_forward", bench_codon),
        ("fit_estep", bench_fit_estep),
        ("mcmc_router", bench_mcmc_router),
        ("mcmc_batch", bench_mcmc_batch),
        ("tropical", bench_tropical),
    ):
        try:
            extras[name] = fn()
        except Exception as e:  # report, never break the headline line
            extras[name] = f"error: {type(e).__name__}: {e}"[:200]
    # bulky detail goes to a FILE; the printed line carries only scalars
    detail = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "chiprun_out", "bench_extras.json"
    )
    os.makedirs(os.path.dirname(detail), exist_ok=True)
    with open(detail, "w") as f:
        json.dump(extras, f, indent=1)
    print(
        json.dumps(
            {
                "metric": "pair_forward_dp_cells_per_sec_per_chip",
                "value": round(device_rate),
                "unit": "cells/s",
                "vs_baseline": round(vs, 3) if vs is not None else None,
                "flops_per_sec": round(flops),
                "dp_flops_per_cell": DP_FLOPS_PER_CELL,
                "mfu_vs_bf16_peak": round(flops / _peak_flops(), 5),
                "summary": _extras_digest(extras),
                "device": {
                    "platform": jax.devices()[0].platform,
                    "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices()),
                },
                "detail": "chiprun_out/bench_extras.json",
            }
        )
    )


if __name__ == "__main__":
    main()
