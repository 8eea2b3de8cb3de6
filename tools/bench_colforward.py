"""Column-scan timing: the CUDA kernel against XLA's col_pair_forward_cells.

Runs both implementations of the col route's column scan on the same
seeded synthetic merge (full band, LG transitions, a chain y with one
in-edge per column and a DAG y with KY=4 in-edges reaching up to 32
columns back), checks that they agree, and reports the cost of one
column step at each SX.  Needs a GPU (the CUDA kernel has no CPU mode).

    python tools/bench_colforward.py [--sx 3072,6144,12288] [--sy 512]
                                     [--full 6144] [--out FILE]

--full N also times one N x N chain merge end to end through each scan.
Prints one JSON object per measurement; the last line is a summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

NEG = -1e30


def synthetic_merge(SX: int, SY: int, ky: int, seed: int = 0, dtype=np.float32):
    """Seeded column-route inputs with realistic magnitudes: absorb and
    insert/delete scores of a few nats per cell, LG transitions."""
    from historian_tpu.engine.pairhmm import PairHMM
    from historian_tpu.models.presets import named_model
    from historian_tpu.models.ratemodel import ProbModel
    from historian_tpu.ops.pairforward import pack_transitions

    rng = np.random.default_rng(seed)
    model = named_model("lg")
    hmm = PairHMM(ProbModel(model, 0.3), ProbModel(model, 0.4), model.ins_prob)
    trans = pack_transitions(hmm)
    trans = np.where(np.isfinite(trans), trans, NEG).astype(dtype)
    y_src = np.zeros((SY, ky), np.int32)
    y_lp = np.full((SY, ky), NEG, dtype)
    j = np.arange(1, SY)
    y_src[1:, 0] = j - 1
    y_lp[1:, 0] = np.log(0.7) if ky > 1 else 0.0
    for k in range(1, ky):
        back = rng.integers(2, 33, size=SY - 1)
        ok = j - back >= 0
        y_src[1:, k][ok] = (j - back)[ok]
        y_lp[1:, k][ok] = np.log(0.1)
    y_null = np.zeros(SY, bool)
    if ky > 1:
        y_null[1:] = rng.random(SY - 1) < 0.05
    v = dict(
        rsx=rng.normal(-3.0, 0.5, SX).astype(dtype),
        isx=rng.normal(-3.2, 0.5, SX).astype(dtype),
        rsy=rng.normal(-3.0, 0.5, SY).astype(dtype),
        isy=rng.normal(-3.2, 0.5, SY).astype(dtype),
        trans=trans,
        x_ready=np.ones(SX, bool), x_eos=np.ones(SX, bool),
        y_src=y_src, y_lp=y_lp, y_null=y_null, y_ready=np.ones(SY, bool),
    )
    absorb = rng.normal(-2.5, 1.0, (SY, SX)).astype(dtype)
    mask = np.ones((SY, SX), bool)
    return absorb, mask, v


def rel_err(got: np.ndarray, ref: np.ndarray) -> float:
    live = ref > -1e25
    if not np.any(live):
        return 0.0
    d = np.abs(got[live].astype(np.float64) - ref[live].astype(np.float64))
    return float((d / np.maximum(np.abs(ref[live].astype(np.float64)), 1.0)).max())


def time_fn(fn, reps: int = 3) -> float:
    fn().block_until_ready()  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn().block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sx", default="3072,6144,12288")
    ap.add_argument("--sy", type=int, default=512)
    ap.add_argument("--full", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from historian_tpu.ops import colforward, cuda_colforward

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench_colforward: needs a GPU, found {dev.platform}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    cuda_colforward.register()
    rows = [{"phase": "build", "seconds": time.perf_counter() - t0}]
    print(json.dumps(rows[-1]), flush=True)

    def run(kernel, absorb, mask, v):
        return colforward.fill_planes(absorb, mask, v, kernel=kernel)

    shapes = [(int(s), args.sy) for s in args.sx.split(",") if s]
    if args.full:
        shapes.append((args.full, args.full))
    for SX, SY in shapes:
        for ky in ((1,) if SY == SX else (1, 4)):
            absorb, mask, v = synthetic_merge(SX, SY, ky)
            a_d, m_d = jnp.asarray(absorb), jnp.asarray(mask)
            v_d = {k: jnp.asarray(x) for k, x in v.items()}
            out = {}
            row = {"SX": SX, "SY": SY, "KY": ky}
            for kernel in ("xla", "cuda"):
                secs = time_fn(lambda: run(kernel, a_d, m_d, v_d))
                out[kernel] = np.asarray(run(kernel, a_d, m_d, v_d))
                row[f"{kernel}_s"] = secs
                row[f"{kernel}_us_per_col"] = secs / SY * 1e6
            row["max_rel_err"] = rel_err(out["cuda"], out["xla"])
            row["speedup"] = row["xla_s"] / row["cuda_s"]
            # both f32 scans against the same inputs run in f64
            a64 = jnp.asarray(absorb, jnp.float64)
            v64 = {k: jnp.asarray(x, jnp.float64) if x.dtype == np.float32
                   else jnp.asarray(x) for k, x in v.items()}
            ref = np.asarray(run("xla", a64, m_d, v64))
            row["xla_f32_vs_f64"] = rel_err(out["xla"], ref)
            row["cuda_f32_vs_f64"] = rel_err(out["cuda"], ref)
            row["cuda_f64_vs_f64"] = rel_err(np.asarray(run("cuda", a64, m_d, v64)), ref)
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    print(json.dumps({"ok": True, "device": dev.device_kind, "rows": len(rows) - 1}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
