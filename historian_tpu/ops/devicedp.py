"""Device execution of the production composition DP.

Bridges engine/forward.py (the host data model: profiles, PairHMM,
envelope) onto the device kernels (ops/pairforward.py, ops/colforward.py,
ops/dagforward.py) so that the flagship Forward fill -- the reference's
hottest loop (/root/reference/src/forward.cpp:78-203) -- runs on the GPU
for chain-profile merges: every leaf x leaf merge, every leaf x
sampled-profile merge, and EVERY merge in -fast mode (COLLAPSE_CHAINS
best-trace profiles are pure emit chains).

Shape discipline: profile sizes vary per merge and every new shape
compiles, so grids are bucket-padded (NEG emissions, False mask) -- a
handful of compiled shapes covers a whole reconstruction, and the
padding rows/columns stay at NEG.

Enablement: HISTORIAN_DEVICE_DP=1 forces on, =0 forces off; default
"auto" uses the device exactly when JAX's default backend is the GPU.
dtype is float64 on CPU (bit-for-bit comparable with the host fill's
values) and float32 on the GPU (see fill_dtype).
"""

from __future__ import annotations

import os

import numpy as np

NEG = -1e30
#: readback threshold: kernel NEG-arithmetic leaves "impossible" cells far
#: below any reachable log-prob; restore them to -inf for the host walkers
NEG_CUTOFF = -1e25
BUCKET = 64
#: HISTORIAN_DEVICE_DP_TIME=1 prints per-merge device fill timings to stderr
TIMING = os.environ.get("HISTORIAN_DEVICE_DP_TIME", "0") == "1"

#: last col-route fill's wall split, (prep_s, dispatch_s, readback_s),
#: recorded unconditionally (bench.py reports it per merge)
LAST_SPLIT: tuple = (0.0, 0.0, 0.0)


def enabled() -> bool:
    env = os.environ.get("HISTORIAN_DEVICE_DP", "auto")
    if env == "0":
        return False
    if env == "1":
        return True
    return accel_backend()


_DISPATCH_OVERHEAD: float | None = None

#: host OpenMP fill throughput, state-cells/s: the prior used until the
#: process has timed a native fill of its own (host_fill_rate)
HOST_FILL_RATE = 4e7
#: dispatches a device-resident merge pays beyond its compute: emission
#: and fill, lp_end gather, trace walk, visited-cell readback (a prior)
MERGE_ROUND_TRIPS = 7
#: device column-scan bulk throughput, state-cells/s: the CUDA kernel's
#: per-x-row cost, 0.51 ns (chain y) to 0.82 ns (4 in-edges) per row of
#: 5 states, measured with tools/bench_colforward.py at SX 3072-12288 on
#: an NVIDIA H100 80GB HBM3 (700 W power limit); the slower end is kept
DEV_FILL_RATE = 6e9
#: sequential per-step cost of the device route, s per unit of path
#: length (x_size + y_size): the column scan's fixed ~11-15 us per
#: column plus the best-trace walk's ~33 us per step, each about half a
#: path-length unit, same card and limit (chip_smoke.py phase 2).
STEP_S = 2.3e-5


# ---------------------------------------------------- router calibration
# The cost-model constants above are priors; both sides drift (the host
# fill rate moves with the machine's load), so the router RE-CALIBRATES
# from what it actually measures: every native host fill reports its
# rate (engine/forward._fill_native), resident-merge walls re-fit the
# per-step latency (bench probes), and a one-shot ~50 ms micro-fill seeds
# the host rate before the first real fill of a process.
_HOST_OBS: list[float] = []
_STEP_OBS: list[float] = []
_PROBED_HOST: float | None = None


def observe_host_fill(state_cells: int, seconds: float) -> None:
    """Feed one measured native host fill into the router's host-rate
    estimate (median of the recent window rides out scheduler noise)."""
    if seconds > 1e-4 and state_cells > 100_000:
        _HOST_OBS.append(state_cells / seconds)
        del _HOST_OBS[:-16]


def observe_resident_merge(band_cells: int, path_len: int, wall_s: float) -> None:
    """Re-fit the device route's per-step latency from one measured
    resident merge wall (fill + end gather + trace walk)."""
    est = (
        wall_s
        - MERGE_ROUND_TRIPS * dispatch_overhead_s()
        - band_cells / DEV_FILL_RATE
    ) / max(path_len, 1)
    if est > 0:
        _STEP_OBS.append(est)
        del _STEP_OBS[:-16]


def _probe_host_rate() -> float:
    """One-shot micro-fill of a dense 256x256 chain merge through the
    native host runtime (~30 ms), run lazily the first time the router
    needs a host rate before any production fill has been observed."""
    global _PROBED_HOST
    if _PROBED_HOST is not None:
        return _PROBED_HOST
    _PROBED_HOST = 0.0  # sentinel: no recursion while probing
    try:
        import time

        from historian_tpu.core.seqs import FastSeq
        from historian_tpu.engine.forward import ForwardMatrix
        from historian_tpu.engine.pairhmm import PairHMM
        from historian_tpu.engine.profile import Profile
        from historian_tpu.models.presets import named_model
        from historian_tpu.models.ratemodel import ProbModel

        model = named_model("jc")
        rng = np.random.RandomState(1)
        n = 255
        mk = lambda name: FastSeq(
            name=name, seq="".join("acgt"[i] for i in rng.randint(0, 4, size=n))
        )
        x = Profile.from_sequence(model.components, model.alphabet, mk("x"), 0)
        y = Profile.from_sequence(model.components, model.alphabet, mk("y"), 1)
        hmm = PairHMM(ProbModel(model, 0.5), ProbModel(model, 0.5), model.ins_prob)
        prev = os.environ.get("HISTORIAN_DEVICE_DP")
        os.environ["HISTORIAN_DEVICE_DP"] = "0"
        try:
            dp = ForwardMatrix(x, y, hmm, 2)  # first fill warms arena/pages
            if dp.cells is None:
                return 0.0
            cells = int(np.count_nonzero(dp.env_mask)) * 5
            t0 = time.perf_counter()
            reps = 2
            for _ in range(reps):
                if not dp._fill_native():
                    return 0.0
            _PROBED_HOST = cells * reps / (time.perf_counter() - t0)
        finally:
            if prev is None:
                os.environ.pop("HISTORIAN_DEVICE_DP", None)
            else:
                os.environ["HISTORIAN_DEVICE_DP"] = prev
    except Exception:
        _PROBED_HOST = 0.0
    return _PROBED_HOST


def host_fill_rate() -> float:
    """Current best estimate of the host fill throughput, state-cells/s:
    median of observed production fills, else the startup micro-probe,
    else the static prior."""
    if _HOST_OBS:
        return float(np.median(_HOST_OBS[-8:]))
    probed = _probe_host_rate()
    return probed if probed > 0 else HOST_FILL_RATE


def step_s() -> float:
    """Current best estimate of the device route's sequential per-step
    cost (column scan + trace walk), s/step."""
    if _STEP_OBS:
        return float(np.median(_STEP_OBS[-8:]))
    return STEP_S


def device_merge_cost_s(band_cells: int, path_len: int,
                        overhead_s: float | None = None) -> float:
    """Estimated wall of the device-resident merge route: fixed dispatch
    overhead + sequential column-scan/trace-walk latency + bulk fill."""
    if overhead_s is None:
        overhead_s = dispatch_overhead_s()
    return (
        MERGE_ROUND_TRIPS * overhead_s
        + step_s() * path_len
        + band_cells / DEV_FILL_RATE
    )


def backend_kind() -> str:
    """JAX's default backend platform ("cpu" or "gpu")."""
    import jax

    return jax.default_backend()


def accel_backend() -> bool:
    return backend_kind() == "gpu"


def fill_dtype():
    """Merge-fill device dtype: f64 on the CPU backend (golden parity),
    f32 on the GPU, where f64 runs at half the f32 rate and f32 meets
    the accuracy bound of tests/test_f32_drift.py.
    HISTORIAN_DEVICE_DTYPE=f32|f64 overrides -- f32-on-CPU reproduces
    the GPU's numeric path for drift studies without a card, f64 on the
    GPU removes the long-input f32 best-trace caveat for merges that
    need it."""
    import jax
    import numpy as np

    env = os.environ.get("HISTORIAN_DEVICE_DTYPE", "")
    if env == "f32":
        return np.float32
    if env == "f64":
        return np.float64
    return np.float64 if jax.default_backend() == "cpu" else np.float32


def merge_on_device(band_cells: int, path_len: int) -> bool:
    """Auto-mode routing decision for one merge fill on the GPU:
    HISTORIAN_DEVICE_MIN_CELLS pins a plain cell threshold; otherwise
    the cost model decides (the column scan and the trace walk are
    sequential in path length, so small merges lose to the host OpenMP
    wavefront fill, which clears them in milliseconds)."""
    env = os.environ.get("HISTORIAN_DEVICE_MIN_CELLS")
    if env is not None:
        return band_cells >= int(float(env))
    return band_cells / host_fill_rate() >= device_merge_cost_s(band_cells, path_len)


def dispatch_overhead_s() -> float:
    """Host->device->host transfer round trip on the default backend,
    measured once per process (synchronously, compile-free: pure
    device_put + readback of a small buffer)."""
    global _DISPATCH_OVERHEAD
    if _DISPATCH_OVERHEAD is None:
        import time

        import jax

        buf = np.zeros(64, np.float32)
        np.asarray(jax.device_put(buf))  # warm-up
        t0 = time.perf_counter()
        for _ in range(3):
            np.asarray(jax.device_put(buf))
        _DISPATCH_OVERHEAD = (time.perf_counter() - t0) / 3
        if TIMING:
            import sys

            print(f"[devdp] dispatch overhead={_DISPATCH_OVERHEAD:.6f}s",
                  file=sys.stderr, flush=True)
    return _DISPATCH_OVERHEAD


def dag_on_device() -> bool:
    """Whether DAG x DAG merges run the device row kernel.  Forced on
    with HISTORIAN_DEVICE_DP=1 (tests, benches, kernels-first runs);
    in auto mode the engine keeps them on the host fill, which beats
    the row kernel's SX x 2J sequential junction scans at every
    measured size (see engine/forward.py::_fill_device)."""
    return os.environ.get("HISTORIAN_DEVICE_DP", "auto") == "1"


def _bucket(n: int) -> int:
    """Grid dims round up to a bucket so compiled programs are reused.

    On the GPU each new shape pays a compile (and a program load per
    process) while execution scales only linearly with padding, so
    buckets are 4x coarser there (256 vs 64) and 1024 above 4096 -- a
    progressive-merge run's per-level shape growth then shares one
    program per ~1k band instead of one per level, at <=14% padded
    compute."""
    accel = accel_backend()
    b = 256 if accel else BUCKET
    if accel and n > 4096:
        b = 1024
    return max(b, -(-n // b) * b)


IDX_BUCKET = 8192


def _mask_idx(mask2d: np.ndarray, SY: int, total: int) -> tuple[np.ndarray, int]:
    """Flat row-major indices of the in-envelope cells, bucket-padded with
    an out-of-range sentinel (scatter mode='drop' ignores it; gather clamps
    and the host discards the tail).  The envelope band is a small
    fraction of the grid, so both the absorb upload and the cell
    readback ride these indices instead of full [SX, SY(,5)] tensors."""
    ii, jj = np.nonzero(mask2d)
    flat = (ii.astype(np.int64) * SY + jj).astype(np.int32)
    n = len(flat)
    P = max(IDX_BUCKET, -(-n // IDX_BUCKET) * IDX_BUCKET)
    idx = np.full(P, total, dtype=np.int32)
    idx[:n] = flat
    return idx, n


def _device_io():
    """Jitted scatter/gather helpers (built once; shapes bucket so the
    compile count stays tiny)."""
    import jax
    import jax.numpy as jnp

    global _SCATTER_ABSORB, _GATHER_CELLS
    if "_SCATTER_ABSORB" in globals():
        return _SCATTER_ABSORB, _GATHER_CELLS

    from functools import partial

    @partial(jax.jit, static_argnames=("sx", "sy"))
    def scatter_absorb(vals, idx, sx, sy):
        flat = jnp.full((sx * sy,), jnp.asarray(NEG, vals.dtype))
        flat = flat.at[idx].set(vals, mode="drop")
        mask = jnp.zeros((sx * sy,), bool).at[idx].set(True, mode="drop")
        return flat.reshape(sx, sy), mask.reshape(sx, sy)

    @jax.jit
    def gather_cells(cells, idx):
        return cells.reshape(-1, cells.shape[-1])[idx]

    _SCATTER_ABSORB, _GATHER_CELLS = scatter_absorb, gather_cells
    return _SCATTER_ABSORB, _GATHER_CELLS


def _gather_planes():
    """jitted in-band gather from [5, SY, SX] planes -> [P, 5]."""
    import jax

    global _GATHER_PLANES
    if "_GATHER_PLANES" not in globals():
        _GATHER_PLANES = jax.jit(lambda p, idx: p.reshape(5, -1).T[idx])
    return _GATHER_PLANES


def _expand_cells(vals: np.ndarray, mask2d: np.ndarray, n: int, nx: int, ny: int) -> np.ndarray:
    """Scatter gathered in-band cell values back into a dense [-inf] grid
    (exactly what a full readback would have produced: out-of-envelope and
    NEG-contaminated cells read as -inf to the host walkers)."""
    out = np.full((nx, ny, 5), -np.inf)
    v = vals[:n].astype(np.float64)
    v[v < NEG_CUTOFF] = -np.inf
    out[mask2d[:nx, :ny]] = v
    return out


def _clamp(a: np.ndarray, dtype) -> np.ndarray:
    """Finite NEG in place of -inf (the kernel's semiring zero)."""
    return np.where(np.isfinite(a), a, NEG).astype(dtype, copy=False)


def _bucket_pow2(n: int, lo: int = 1) -> int:
    k = lo
    while k < n:
        k <<= 1
    return k


def _profile_dag_arrays(profile, n: int):
    """Per-profile structure tables for the DAG kernel, memoized: in-edge
    matrices, chain/junction decomposition, null list + chain depth.
    `n` = number of grid states (profile.size - 1: END excluded)."""
    cached = profile.__dict__.get("_dag_arrays")
    if cached is not None:
        return cached
    trans = profile.trans
    k_max = max((len(profile.states[s].in_trans) for s in range(n)), default=1)
    K = _bucket_pow2(max(1, k_max))
    src = np.zeros((n, K), dtype=np.int32)
    lp = np.full((n, K), NEG)
    chain = np.zeros(n, dtype=bool)
    null_depth = np.zeros(n, dtype=np.int32)
    is_null = np.array([profile.states[s].is_null for s in range(n)])
    for s in range(n):
        st = profile.states[s]
        for k, t in enumerate(st.in_trans):
            src[s, k] = trans[t].src
            v = trans[t].lp
            lp[s, k] = v if np.isfinite(v) else NEG
        if (
            not is_null[s]
            and len(st.in_trans) == 1
            and trans[st.in_trans[0]].src == s - 1
        ):
            chain[s] = True
        if is_null[s]:
            d = 0
            for t in st.in_trans:
                sp = trans[t].src
                if sp < n and is_null[sp]:
                    d = max(d, null_depth[sp])
            null_depth[s] = d + 1
    jidx = np.nonzero(~chain)[0].astype(np.int32)
    govq = np.zeros(n, dtype=np.int32)
    q = 0
    for s in range(n):
        if not chain[s]:
            q += 1
        govq[s] = q
    nidx = np.nonzero(is_null)[0].astype(np.int32)
    out = {
        "K": K, "src": src, "lp": lp, "chain": chain, "jidx": jidx,
        "govq": govq, "nidx": nidx,
        "n_null_iters": int(null_depth.max(initial=0)),
    }
    profile.__dict__["_dag_arrays"] = out
    return out


def dag_forward_cells(dp) -> np.ndarray | None:
    """Run the Forward fill for a general profile pair on device via the
    DAG kernel (ops/dagforward.py).  Same contract as chain_forward_cells
    but with explicit edge structure instead of folded transitions."""
    if dp.x_empty or dp.y_empty:
        return None
    import jax
    import jax.numpy as jnp

    from historian_tpu.ops.dagforward import dag_pair_forward_cells
    from historian_tpu.ops.pairforward import pack_transitions

    import time as _time

    t0 = _time.perf_counter()
    nx = dp.x_size - 1
    ny = dp.y_size - 1
    SX, SY = _bucket(nx), _bucket(ny)
    dtype = fill_dtype()

    ax = _profile_dag_arrays(dp.x, nx)
    ay = _profile_dag_arrays(dp.y, ny)

    def pad_edges(a, n, S):
        K = a["K"]
        src = np.zeros((S, K), dtype=np.int32)
        lp = np.full((S, K), NEG, dtype)
        src[:n] = a["src"]
        lp[:n] = a["lp"]
        # padded states: pretend chain with NEG edge so they add no junctions
        src[n:, 0] = np.maximum(np.arange(n, S) - 1, 0)
        return src, lp

    x_src, x_lp = pad_edges(ax, nx, SX)
    y_src, y_lp = pad_edges(ay, ny, SY)

    def padb(vals, n, S, pad_val=False):
        out = np.full(S, pad_val, dtype=bool)
        out[:n] = vals[:n]
        return out

    x_null = padb(dp.x_null, nx, SX)
    x_eos = padb(dp.x_emit_or_start, nx, SX)
    x_ready = padb(dp.x_ready | dp.x_empty, nx, SX)
    y_null = padb(dp.y_null, ny, SY)
    y_ready = padb(dp.y_ready | dp.y_empty, ny, SY)
    y_chain = np.ones(SY, dtype=bool)  # padded states chain (no junction cost)
    y_chain[:ny] = ay["chain"]
    govq = np.zeros(SY, dtype=np.int32)
    govq[:ny] = ay["govq"]
    govq[ny:] = ay["govq"][-1] if ny else 0

    # pad index lists with the out-of-range sentinel SY: the kernel's
    # null-propagation scatter drops it, and junction writes land in
    # uvec slots no y state governs.  (SY-1 is NOT safe -- when ny is an
    # exact bucket multiple that column is a real state.)
    J = _bucket_pow2(len(ay["jidx"]), lo=32)
    jidx = np.full(J, SY, dtype=np.int32)
    jidx[: len(ay["jidx"])] = ay["jidx"]
    JN = _bucket_pow2(len(ay["nidx"]), lo=32)
    nidx = np.full(JN, SY, dtype=np.int32)
    nidx[: len(ay["nidx"])] = ay["nidx"]

    rsx = np.full(SX, NEG, dtype); rsx[:nx] = _clamp(dp.rootsubx[:nx], dtype)
    isx = np.full(SX, NEG, dtype); isx[:nx] = _clamp(dp.insx[:nx], dtype)
    rsy = np.full(SY, NEG, dtype); rsy[:ny] = _clamp(dp.rootsuby[:ny], dtype)
    isy = np.full(SY, NEG, dtype); isy[:ny] = _clamp(dp.insy[:ny], dtype)
    trans = _clamp(pack_transitions(dp.hmm), dtype)

    # band-compacted IO: ship absorb values + indices, derive mask on
    # device, read back only the in-envelope cells
    env = np.asarray(dp.env_mask[:nx, :ny], dtype=bool)
    mask_p = np.zeros((SX, SY), dtype=bool)
    mask_p[:nx, :ny] = env
    idx, n_in = _mask_idx(mask_p, SY, SX * SY)
    vals = np.full(len(idx), NEG, dtype)
    vals[:n_in] = _clamp(np.asarray(dp.absorb[:nx, :ny])[env], dtype)
    scatter_absorb, gather_cells = _device_io()
    t1 = _time.perf_counter()
    idx_d = jnp.asarray(idx)
    absorb_d, mask_d = scatter_absorb(jnp.asarray(vals), idx_d, SX, SY)

    cells_dev = dag_pair_forward_cells(
        absorb_d, jnp.asarray(rsx), jnp.asarray(isx),
        jnp.asarray(rsy), jnp.asarray(isy),
        mask_d, jnp.asarray(trans),
        jnp.asarray(x_src), jnp.asarray(x_lp),
        jnp.asarray(x_null), jnp.asarray(x_eos), jnp.asarray(x_ready),
        jnp.asarray(y_src), jnp.asarray(y_lp),
        jnp.asarray(y_null), jnp.asarray(y_ready),
        jnp.asarray(y_chain), jnp.asarray(govq),
        jnp.asarray(jidx), jnp.asarray(nidx),
        jnp.int32(ay["n_null_iters"]),
    )
    t2 = _time.perf_counter()
    out = np.asarray(gather_cells(cells_dev, idx_d))
    t3 = _time.perf_counter()
    if TIMING:
        import sys as _sys

        print(
            f"[devdp.dag] SX={SX} SY={SY} KX={x_src.shape[1]} KY={y_src.shape[1]} "
            f"J={len(jidx)} JN={len(nidx)} prep={t1 - t0:.3f} "
            f"dispatch={t2 - t1:.3f} wait+read={t3 - t2:.3f}",
            file=_sys.stderr, flush=True,
        )
    return _expand_cells(out, mask_p, n_in, nx, ny)


def col_kernel_inputs(dp, dtype=np.float64, bucket=None):
    """Dense input bundle for the column-major kernel, exactly as the
    production route's in-band scatter materializes it on device (NEG
    outside the envelope and the true sizes).  Used by the SP
    (mesh-sharded) fill and the multichip dryrun, which need the dense
    arrays host-side to shard them."""
    from historian_tpu.ops.pairforward import pack_transitions

    ex = dp.x.as_chain()
    assert ex is not None, "col kernel needs a chain x"
    nx = dp.x_size - 1
    ny = dp.y_size - 1
    SX = bucket(nx) if bucket else _bucket(nx)
    SY = bucket(ny) if bucket else _bucket(ny)

    tx = ex[:nx]
    rsx = np.full(SX, NEG, dtype); rsx[:nx] = _clamp(dp.rootsubx[:nx] + tx, dtype)
    isx = np.full(SX, NEG, dtype); isx[:nx] = _clamp(dp.insx[:nx] + tx, dtype)
    rsy = np.full(SY, NEG, dtype); rsy[:ny] = _clamp(dp.rootsuby[:ny], dtype)
    isy = np.full(SY, NEG, dtype); isy[:ny] = _clamp(dp.insy[:ny], dtype)
    trans = _clamp(pack_transitions(dp.hmm), dtype)

    ay = _profile_dag_arrays(dp.y, ny)
    KY = ay["src"].shape[1]
    y_src = np.zeros((SY, KY), dtype=np.int32)
    y_lp = np.full((SY, KY), NEG, dtype)
    y_src[:ny] = ay["src"]
    y_lp[:ny] = _clamp(ay["lp"], dtype)

    def padb(vals, n, S):
        out = np.zeros(S, dtype=bool)
        out[:n] = vals[:n]
        return out

    x_ready = padb(dp.x_ready | dp.x_empty, nx, SX)
    x_eos = padb(dp.x_emit_or_start, nx, SX)
    y_null = padb(dp.y_null, ny, SY)
    y_ready = padb(dp.y_ready | dp.y_empty, ny, SY)

    env_t = np.asarray(dp.env_mask[:nx, :ny], dtype=bool).T
    mask_t = np.zeros((SY, SX), dtype=bool)
    mask_t[:ny, :nx] = env_t
    absorb_t = np.full((SY, SX), NEG, dtype)
    dense = np.asarray(dp.absorb[:nx, :ny]).T + tx[None, :]
    absorb_t[:ny, :nx][env_t] = _clamp(dense[env_t], dtype)
    return dict(
        absorb_t=absorb_t, rootsub_x=rsx, ins_x=isx, rootsub_y=rsy,
        ins_y=isy, mask_t=mask_t, trans=trans, x_ready=x_ready,
        x_eos=x_eos, y_src=y_src, y_lp=y_lp, y_null=y_null,
        y_ready=y_ready, nx=nx, ny=ny,
    )


def _factored_wins(n_in: int, n_states: int, ca: int) -> bool:
    """Whether the emission tensor ships as O(S x CA) factors (device
    matmul) instead of O(band) precomputed values.  Factors win once the
    band holds more numbers than the factors.  HISTORIAN_FACTORED_ABSORB
    forces 1/0 (tests, debugging)."""
    env = os.environ.get("HISTORIAN_FACTORED_ABSORB")
    if env is not None:
        return env == "1"
    return n_in > n_states * ca


def _factored_absorb():
    """Jitted device-side emission build for the chain route:
    absorb[j, i] = log(ey_exp[j] . ex_exp[i]) + shift_y[j] + shift_x[i],
    gated to NEG outside the band (idx = flat in-band indices, as in
    _mask_idx).  Ships O(S x C*A) factors to the device instead of
    O(band) precomputed values, and runs the emission inner product
    there as one matmul (SURVEY section 7: fuse emission einsums)."""
    import jax

    global _FACTORED_ABSORB
    if "_FACTORED_ABSORB" in globals():
        return _FACTORED_ABSORB

    from historian_tpu.ops.colforward import absorb_idx

    _FACTORED_ABSORB = jax.jit(absorb_idx)
    return _FACTORED_ABSORB


def col_kernel() -> str:
    """Column-scan implementation for the col route: "cuda" (the Hopper
    kernel, ops/cuda_colforward.py) on the GPU backend, "xla"
    (ops/colforward.col_pair_forward_cells) elsewhere.
    HISTORIAN_COL_KERNEL=cuda|xla overrides (the XLA scan is the
    kernel's reference, and timing the two needs both on one card)."""
    env = os.environ.get("HISTORIAN_COL_KERNEL", "auto")
    if env in ("cuda", "xla"):
        return env
    if env != "auto":
        raise ValueError(f"HISTORIAN_COL_KERNEL must be auto, cuda or xla, not {env!r}")
    return "cuda" if backend_kind() == "gpu" else "xla"


def device_bytes_limit() -> int | None:
    """Memory the default device's allocator may hand out, or None where
    the backend does not report it (the CPU)."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("bytes_limit")


#: resident-plane budget where the device reports no memory limit (the
#: CPU backend), MB: admits 12288-bucket merges (5 x 12288^2 f32 = 3.02 GB)
DEFAULT_PLANES_MB = 3072.0


def planes_budget_mb(bytes_limit: int | None) -> float:
    """Per-merge budget for device-resident [5, SY, SX] planes, MB: a
    fifth of the device's allocator limit.  A merge in flight also holds
    its absorb/mask transients, and the recon window (recon.py) keeps
    at most 1.5x this budget resident, so a fifth leaves room for both
    plus the trace walk.  HISTORIAN_TRACE_PLANES_MB overrides."""
    env = os.environ.get("HISTORIAN_TRACE_PLANES_MB")
    if env is not None:
        return float(env)
    if not bytes_limit:
        return DEFAULT_PLANES_MB
    return bytes_limit / 5 / 1e6


def trace_planes_mb() -> float:
    """planes_budget_mb for the default device (cached per process)."""
    global _TRACE_PLANES_MB
    if "_TRACE_PLANES_MB" not in globals():
        _TRACE_PLANES_MB = planes_budget_mb(device_bytes_limit())
    return _TRACE_PLANES_MB


def col_forward_device(dp) -> "DeviceTraceFill | None":
    """Device-resident variant of col_forward_cells: the fill stays on
    device as [5, SY, SX] planes wrapped in a DeviceTraceFill whose
    tracebacks run on device too (ops/tracedp.py).  Routing conditions
    are col_forward_cells' plus a single chain-x END in-edge and the
    trace_planes_mb budget."""
    if dp.x_empty or dp.y_empty:
        return None
    if dp.x.as_chain() is None or len(dp.x.end.in_trans) != 1:
        return None
    if 5 * _bucket(dp.x_size - 1) * _bucket(dp.y_size - 1) * 4 > trace_planes_mb() * 1e6:
        return None
    return col_forward_cells(dp, keep=True)


def col_forward_cells(dp, keep: bool = False):
    """Run the Forward fill on device via the column-major scan
    (ops/colforward.py): x must be a pure emit chain, y may be any
    profile DAG.  This is the dominant production merge shape (leaf x
    sampled-profile); the y DAG's null/junction structure costs nothing
    here, unlike the row-major DAG kernel.  Returns None when x is not
    a chain (caller falls back to the DAG kernel / host fill).

    Emission, band mask and column scan run in one jit (colforward
    fill_*); col_kernel() picks the scan.  With keep=True, returns a
    DeviceTraceFill (planes stay on device, no cell readback) instead of
    the [nx, ny, 5] host tensor."""
    if dp.x_empty or dp.y_empty:
        return None
    ex = dp.x.as_chain()
    if ex is None:
        return None
    import time as _time

    import jax.numpy as jnp

    from historian_tpu.ops import colforward
    from historian_tpu.ops.pairforward import pack_transitions

    t0 = _time.perf_counter()
    nx = dp.x_size - 1
    ny = dp.y_size - 1
    SX, SY = _bucket(nx), _bucket(ny)
    dtype = fill_dtype()
    kernel = col_kernel()

    tx = ex[:nx]  # transition lp into x state i (tx[0] = 0 for START)
    rsx = np.full(SX, NEG, dtype); rsx[:nx] = _clamp(dp.rootsubx[:nx] + tx, dtype)
    isx = np.full(SX, NEG, dtype); isx[:nx] = _clamp(dp.insx[:nx] + tx, dtype)
    rsy = np.full(SY, NEG, dtype); rsy[:ny] = _clamp(dp.rootsuby[:ny], dtype)
    isy = np.full(SY, NEG, dtype); isy[:ny] = _clamp(dp.insy[:ny], dtype)
    trans = _clamp(pack_transitions(dp.hmm), dtype)

    ay = _profile_dag_arrays(dp.y, ny)
    KY = ay["src"].shape[1]
    y_src = np.zeros((SY, KY), dtype=np.int32)
    y_lp = np.full((SY, KY), NEG, dtype)
    y_src[:ny] = ay["src"]
    y_lp[:ny] = _clamp(ay["lp"], dtype)

    def padb(vals, n, S):
        out = np.zeros(S, dtype=bool)
        out[:n] = vals[:n]
        return out

    vecs = dict(
        rsx=rsx, isx=isx, rsy=rsy, isy=isy, trans=trans,
        x_ready=padb(dp.x_ready | dp.x_empty, nx, SX),
        x_eos=padb(dp.x_emit_or_start, nx, SX),
        y_src=y_src, y_lp=y_lp,
        y_null=padb(dp.y_null, ny, SY),
        y_ready=padb(dp.y_ready | dp.y_empty, ny, SY),
    )

    # band-compacted IO over the TRANSPOSED grid (cells are column-major
    # on device so y in-edge gathers index the leading axis)
    env_t = np.asarray(dp.env_mask[:nx, :ny], dtype=bool).T  # [ny, nx]
    mask_t = np.zeros((SY, SX), dtype=bool)
    mask_t[:ny, :nx] = env_t
    n_in = int(np.count_nonzero(mask_t))
    fx, sxs, fy, sys_ = dp.absorb_factors  # [x_size, CA], [x_size], ...
    CA = fx.shape[1]
    # factored upload wins when the band holds more values than the
    # factors (long merges: O(band) -> O(L x CA) bytes); the small-band
    # case keeps the host-precomputed scatter (bit-compatible with the
    # host absorb)
    use_factored = _factored_wins(n_in, SX + SY, CA)
    # resident factored fills also rebuild the band mask on device from
    # the envelope's O(L) vectors, skipping the O(band) index upload
    # (readback builds indices lazily if a consumer ever needs cells)
    vec_mask = use_factored and keep
    idx = None if vec_mask else _mask_idx(mask_t, SX, SY * SX)[0]
    if use_factored:
        ex_f = np.zeros((SX, CA), dtype)
        ex_f[:nx] = fx[:nx]
        ey_f = np.zeros((SY, CA), dtype)
        ey_f[:ny] = fy[:ny]
        shift_x = np.full(SX, NEG, dtype)
        shift_x[:nx] = sxs[:nx] + tx
        shift_y = np.zeros(SY, dtype)
        shift_y[:ny] = sys_[:ny]
    else:
        absorb_t = np.asarray(dp.absorb[:nx, :ny]).T + tx[None, :]
        vals = np.full(len(idx), NEG, dtype)
        vals[:n_in] = _clamp(absorb_t[env_t], dtype)

    t1 = _time.perf_counter()
    vecs_d = {k: jnp.asarray(v) for k, v in vecs.items()}
    idx_d = None if idx is None else jnp.asarray(idx)
    if vec_mask:
        ev = getattr(dp, "env_vectors", None)
        # pad sentinels of opposite sign differ by 2^30 > any real
        # distance bound, so padded rows/columns always fail the test;
        # an uninitialized envelope (ev None) passes every real cell at
        # distance 0
        m1 = np.full(SX, 1 << 29, np.int32)
        m2 = np.full(SY, -(1 << 29), np.int32)
        if ev is None:
            m1[:nx] = 0
            m2[:ny] = 0
            dist = 0
        else:
            vm1, vm2, dist = ev
            m1[:nx] = vm1[:nx]
            m2[:ny] = vm2[:ny]
        xns = np.zeros(SX, bool)
        xns[:nx] = dp.x_near_start[:nx]
        yne = np.zeros(SY, bool)
        yne[:ny] = dp.y_near_end[:ny]
        planes = colforward.fill_vecmask(
            vecs_d, jnp.asarray(ey_f), jnp.asarray(ex_f),
            jnp.asarray(shift_y), jnp.asarray(shift_x),
            jnp.asarray(m2), jnp.asarray(m1), jnp.int32(dist),
            jnp.asarray(yne), jnp.asarray(xns), jnp.int32(ny), jnp.int32(nx),
            kernel=kernel,
        )
    elif use_factored:
        planes = colforward.fill_idx(
            vecs_d, jnp.asarray(ey_f), jnp.asarray(ex_f),
            jnp.asarray(shift_y), jnp.asarray(shift_x), idx_d, kernel=kernel,
        )
    else:
        scatter_absorb, _ = _device_io()
        absorb_d, mask_d = scatter_absorb(jnp.asarray(vals), idx_d, SY, SX)
        planes = colforward.fill_planes(absorb_d, mask_d, vecs_d, kernel=kernel)
    t2 = _time.perf_counter()
    if keep:
        return DeviceTraceFill(dp, planes, nx, ny, idx_d, mask_t, n_in)
    out = np.asarray(_gather_planes()(planes, idx_d))
    t3 = _time.perf_counter()
    global LAST_SPLIT
    LAST_SPLIT = (t1 - t0, t2 - t1, t3 - t2)
    if TIMING:
        import sys as _sys

        print(
            f"[devdp.col.{kernel}] SX={SX} SY={SY} KY={KY} prep={t1 - t0:.3f} "
            f"dispatch={t2 - t1:.3f} wait+read={t3 - t2:.3f}",
            file=_sys.stderr, flush=True,
        )
    # expand over the transposed mask, then restore row-major [nx, ny, 5]
    tmp = np.full((ny, nx, 5), -np.inf)
    v = out[:n_in].astype(np.float64)
    v[v < NEG_CUTOFF] = -np.inf
    tmp[env_t] = v
    return tmp.transpose(1, 0, 2)


def trace_enabled() -> bool:
    """Whether merge fills stay device-resident with tracebacks walked on
    device (ops/tracedp.py).  HISTORIAN_DEVICE_TRACE=1/0 forces; default
    'auto' = on exactly when the backend is an accelerator, where the
    banded-cell readback dominates per-merge cost."""
    env = os.environ.get("HISTORIAN_DEVICE_TRACE", "auto")
    if env == "0":
        return False
    if env == "1":
        return True
    return accel_backend()


def _sorted_walk_edges(src: np.ndarray, lp: np.ndarray):
    """Per-row copies of the in-edge tables sorted by source index with
    padding slots last -- the device walker's candidate order must match
    the host's sorted-by-cell order (engine/forward.py::_trace_entry)."""
    pad = lp <= NEG / 2
    order = np.argsort(np.where(pad, np.iinfo(np.int32).max, src), axis=1, kind="stable")
    rows = np.arange(src.shape[0])[:, None]
    return src[rows, order], lp[rows, order]


class DeviceTraceFill:
    """Device-resident fill handle: the [5, SY, SX] cell planes plus the
    walk structure, with tracebacks run by ops/tracedp.py.  Created by
    col/chain_forward_device; consumed by engine/forward.py when
    trace_enabled().  `readback()` materializes host cells on demand
    (BackwardMatrix and other full-band consumers)."""

    def __init__(self, dp, planes, nx: int, ny: int, idx, mask_t, n_in):
        import jax.numpy as jnp

        self.dp = dp
        self.planes = planes  # [5, SY, SX] device
        self.nx, self.ny = nx, ny
        self._idx, self._mask_t, self._n_in = idx, mask_t, n_in
        self._cells_np = None

        ay = _profile_dag_arrays(dp.y, ny)
        SY = planes.shape[1]
        dtype = np.float32 if planes.dtype == jnp.float32 else np.float64
        KY = ay["src"].shape[1]
        y_src = np.zeros((SY, KY), np.int32)
        y_lp = np.full((SY, KY), NEG, dtype)
        y_src[:ny], y_lp[:ny] = _sorted_walk_edges(
            ay["src"], _clamp(ay["lp"], dtype)
        )
        y_null = np.zeros(SY, bool)
        y_null[:ny] = dp.y_null[:ny]
        ex = dp.x.as_chain()
        tx = np.zeros(planes.shape[2], dtype)
        tx[:nx] = _clamp(ex[:nx], dtype)

        # end in-edges: chain x has exactly one (callers verified by
        # routing), y's are sorted by source like the walk edges
        x_end = dp.x.end
        assert len(x_end.in_trans) == 1, "chain x END must have one in-edge"
        xt = dp.x.trans[x_end.in_trans[0]]
        ye = sorted(
            (dp.y.trans[t].src, dp.y.trans[t].lp) for t in dp.y.end.in_trans
        )
        KE = _bucket_pow2(len(ye), lo=8)
        ye_src = np.zeros(KE, np.int32)
        ye_lp = np.full(KE, NEG, dtype)
        for k, (s, v) in enumerate(ye):
            ye_src[k] = s
            ye_lp[k] = v if np.isfinite(v) else NEG

        t6 = np.array(dp.hmm.trans_table, dtype=dtype, copy=True)
        t6[~np.isfinite(t6)] = NEG

        self._walk_args = (
            jnp.asarray(y_src), jnp.asarray(y_lp), jnp.asarray(y_null),
            jnp.asarray(tx), jnp.asarray(t6),
            jnp.int32(xt.src), jnp.asarray(dtype(xt.lp if np.isfinite(xt.lp) else NEG)),
            jnp.asarray(ye_src), jnp.asarray(ye_lp),
        )
        self.n_steps_max = int(planes.shape[1] + planes.shape[2])
        self._lp_end = None
        self._lp_end_dev = None

    def dispatch_lp_end(self) -> None:
        """Enqueue the end gather on device without blocking; lp_end
        reads the resulting scalar back later (level pipelining)."""
        if self._lp_end is None and self._lp_end_dev is None:
            from historian_tpu.ops.tracedp import end_lp_device

            _, _, _, _, t6, xe_src, xe_lp, ye_src, ye_lp = self._walk_args
            self._lp_end_dev = end_lp_device(
                self.planes, t6, xe_src, xe_lp, ye_src, ye_lp
            )

    @property
    def lp_end(self) -> float:
        """Host _finish_fill's end gather, computed on device (the engine
        needs it right after the fill for the band-doubling retry)."""
        if self._lp_end is None:
            self.dispatch_lp_end()
            v = float(self._lp_end_dev)
            self._lp_end_dev = None
            self._lp_end = -np.inf if v < NEG_CUTOFF else v
        return self._lp_end

    def dispatch_traces(self, n_samples: int, include_best: bool, seed: int):
        """Enqueue include_best + n_samples walks in one device dispatch;
        returns the raw device tuple without blocking.  collect_traces
        reads it back."""
        import jax
        import jax.numpy as jnp

        from historian_tpu.ops.tracedp import pair_trace_device

        T = n_samples + (1 if include_best else 0)
        key = jax.random.PRNGKey(np.uint32(seed))
        u = jax.random.uniform(key, (max(T, 1), self.n_steps_max), jnp.float32)
        best = np.zeros(max(T, 1), bool)
        if include_best:
            best[0] = True
        return pair_trace_device(
            self.planes, *self._walk_args,
            u.astype(self.planes.dtype), jnp.asarray(best), self.n_steps_max,
        )

    def collect_traces(self, raw, n_samples: int, include_best: bool):
        """Read a dispatch_traces result back; returns the traces list
        (see lp_end_and_traces) and caches lp_end as a side effect."""
        T = n_samples + (1 if include_best else 0)
        pi, pj, ps, vals, n_steps, lp_end = raw
        pi, pj, ps = np.asarray(pi), np.asarray(pj), np.asarray(ps)
        vals = np.array(vals, dtype=np.float64)
        vals[vals < NEG_CUTOFF] = -np.inf
        n_steps = np.asarray(n_steps)
        lp_end = float(lp_end)
        if lp_end < NEG_CUTOFF:
            lp_end = -np.inf
        if self._lp_end is None:
            self._lp_end = lp_end
        traces = []
        for t in range(T):
            n = int(n_steps[t])
            cells = [(int(pi[t, k]), int(pj[t, k]), int(ps[t, k])) for k in range(n)]
            cells.reverse()  # walker emits end->start
            traces.append((cells, vals[t, :n][::-1]))
        return traces

    def lp_end_and_traces(self, n_samples: int, include_best: bool, seed: int):
        """Run include_best + n_samples walks in one dispatch.  Returns
        (lp_end, traces) where traces is a list of (path, vals): path a
        list of (i, j, s) cells START->END-SOURCE order (the END cell
        itself is appended by the engine), vals the matching cell values.
        The first trace is the best trace when include_best."""
        raw = self.dispatch_traces(n_samples, include_best, seed)
        traces = self.collect_traces(raw, n_samples, include_best)
        return self.lp_end, traces

    def readback(self) -> np.ndarray:
        """Full banded cell tensor [nx, ny, 5] (host layout), for
        consumers that need the whole band (BackwardMatrix)."""
        if self._cells_np is None:
            _, gather_cells = _device_io()
            import jax.numpy as jnp

            if self._idx is None:
                # vector-mask fills skip the index upload; build it only
                # when a full-band consumer actually asks for cells
                SY, SX = self.planes.shape[1], self.planes.shape[2]
                idx, self._n_in = _mask_idx(self._mask_t, SX, SY * SX)
                self._idx = jnp.asarray(idx)
            cells_t = jnp.moveaxis(self.planes, 0, -1)  # [SY, SX, 5]
            out = np.asarray(gather_cells(cells_t, self._idx))
            tmp = np.full((self.ny, self.nx, 5), -np.inf)
            v = out[: self._n_in].astype(np.float64)
            v[v < NEG_CUTOFF] = -np.inf
            tmp[self._mask_t[: self.ny, : self.nx]] = v
            self._cells_np = tmp.transpose(1, 0, 2)
        return self._cells_np


def chain_forward_cells(dp) -> np.ndarray | None:
    """Run the Forward fill for a chain x chain DPMatrix on device.

    Returns the [x_size-1, y_size-1, 5] float64 cell tensor (host layout:
    value -inf at pruned/unreachable cells), or None when the profile
    pair is not a pure chain pair (the caller falls back to the host
    fill).  Emission tensors (absorb/rootsub/ins) and the envelope mask
    are reused from the DPMatrix precomputation; each chain's transition
    log-prob into a state is folded into every score of that state's row
    or column, which is exactly the reference recurrence restricted to
    single-in-edge states."""
    if dp.x_empty or dp.y_empty:
        return None
    ex = dp.x.as_chain()
    ey = dp.y.as_chain()
    if ex is None or ey is None:
        return None
    import time as _time

    import jax
    import jax.numpy as jnp

    from historian_tpu.ops.pairforward import chain_pair_forward_cells, pack_transitions

    t0 = _time.perf_counter()
    nx = dp.x_size - 1  # kernel rows: states 0..n (START + emits; END excluded)
    ny = dp.y_size - 1
    X1, Y1 = _bucket(nx), _bucket(ny)
    dtype = fill_dtype()

    tx = ex[:nx]  # transition lp into x state i (tx[0] = 0 for START)
    ty = ey[:ny]

    def pad1(vals, n, size):
        out = np.full(size, NEG, dtype)
        out[:n] = _clamp(vals, dtype)
        return out

    rsx = pad1(dp.rootsubx[:nx] + tx, nx, X1)
    isx = pad1(dp.insx[:nx] + tx, nx, X1)
    rsy = pad1(dp.rootsuby[:ny] + ty, ny, Y1)
    isy = pad1(dp.insy[:ny] + ty, ny, Y1)

    x_ready = np.zeros(X1, dtype=bool)
    x_ready[:nx] = dp.x_ready[:nx]
    y_ready = np.zeros(Y1, dtype=bool)
    y_ready[:ny] = dp.y_ready[:ny]

    trans = _clamp(pack_transitions(dp.hmm), dtype)

    # band-compacted IO (see _mask_idx): absorb ships as in-band values,
    # the mask is derived on device, and only in-band cells come back;
    # long merges ship the O(S x CA) emission factors instead and run the
    # exp-space matmul on device (_factored_absorb)
    env = np.asarray(dp.env_mask[:nx, :ny], dtype=bool)
    mask_p = np.zeros((X1, Y1), dtype=bool)
    mask_p[:nx, :ny] = env
    idx, n_in = _mask_idx(mask_p, Y1, X1 * Y1)
    scatter_absorb, gather_cells = _device_io()
    fx, sxs, fy, sys_ = dp.absorb_factors
    CA = fx.shape[1]
    use_factored = _factored_wins(n_in, X1 + Y1, CA)
    if use_factored:
        ex_f = np.zeros((X1, CA), dtype)
        ex_f[:nx] = fx[:nx]
        ey_f = np.zeros((Y1, CA), dtype)
        ey_f[:ny] = fy[:ny]
        shift_x = np.full(X1, NEG, dtype)
        shift_x[:nx] = sxs[:nx] + tx
        shift_y = np.zeros(Y1, dtype)
        shift_y[:ny] = sys_[:ny] + ty
    else:
        absorb_full = dp.absorb[:nx, :ny] + tx[:, None] + ty[None, :]
        vals = np.full(len(idx), NEG, dtype)
        vals[:n_in] = _clamp(absorb_full[env], dtype)
    t1 = _time.perf_counter()
    idx_d = jnp.asarray(idx)
    if use_factored:
        absorb_d, mask_d = _factored_absorb()(
            jnp.asarray(ex_f), jnp.asarray(ey_f),
            jnp.asarray(shift_x), jnp.asarray(shift_y), idx_d,
        )
    else:
        absorb_d, mask_d = scatter_absorb(jnp.asarray(vals), idx_d, X1, Y1)
    t2 = _time.perf_counter()

    cells_dev = chain_pair_forward_cells(
        absorb_d, jnp.asarray(rsx), jnp.asarray(rsy),
        jnp.asarray(isx), jnp.asarray(isy), mask_d,
        jnp.asarray(trans), jnp.asarray(x_ready), jnp.asarray(y_ready),
    )
    t3 = _time.perf_counter()
    out = np.asarray(gather_cells(cells_dev, idx_d))
    t4 = _time.perf_counter()
    if TIMING:
        import sys as _sys

        print(
            f"[devdp.chain] X1={X1} Y1={Y1} prep={t1 - t0:.3f} "
            f"scatter={t2 - t1:.3f} dispatch={t3 - t2:.3f} "
            f"wait+read={t4 - t3:.3f}",
            file=_sys.stderr, flush=True,
        )
    return _expand_cells(out, mask_p, n_in, nx, ny)
