#!/usr/bin/env python3
"""Run historian-tpu's main path on one NVIDIA GPU and check the results.

    python3 chip_smoke.py              # phases 1-4 on one card
    python3 chip_smoke.py --cards 4    # the four-card path only

Phases (one card):
  1 device  JAX sees a GPU whose kind names an H100; the CUDA column
            kernel builds; whether the native host library loaded.
  2 kernel  the col route's column scan at real widths (a long8 leaf
            chain x a sampled-profile DAG of two long8 leaves, and a
            ~6000^2 long6 chain x chain merge, LG) against the host
            native f64 fill: every in-band cell above the NEG cutoff and
            lp_end.  The CUDA kernel in f64 within relative 1e-5; the
            CUDA and XLA scans in f32 within twice the error of XLA's
            f32 scan on the CPU (f32 drifts past 1e-5 at these sizes).
  3 recon   `recon -fast -noband -preset lg` on long12 and `recon
            -careful -norefine -noband -preset lg` on long8, through the
            CLI: Stockholm with #=GF LP, merges counted on the device
            route, and with HISTORIAN_DEVICE_DTYPE=f64 the LP of the
            `-platform cpu` run within 1e-6.
  4 count   `count -preset lg` on the long12 reconstruction (above the
            E-step device threshold), equal to the CPU run to 4
            significant figures.

--cards 4 runs `recon -fast -noband -mesh 4` on long8x12k (whose leaf
merges take the SP ring) and `count -mesh 4`, each against the same
command on one card.

Every phase is a child process run one at a time, so one process holds
the card; the parent never imports JAX.  A failed phase stops the run
with a non-zero exit.  The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Phase outputs are kept under chiprun_out/smoke/.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "tests", "data")
OUT = os.path.join(REPO, "chiprun_out", "smoke")
#: relative tolerance of the kernel phase (cells and lp_end vs host f64)
KERNEL_RTOL = 1e-5
#: f64 device route vs the CPU run (tests/test_f32_drift.py's bound)
LP_TOL = 1e-6


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ------------------------------------------------------------ child phases
def _rel_err(got, ref) -> float:
    import numpy as np

    live = np.isfinite(ref) & (ref > -1e25)
    g = np.where(np.isfinite(got), got, -1e99)[live]
    r = ref[live]
    return float((np.abs(g - r) / np.maximum(np.abs(r), 1.0)).max())


def child_device() -> dict:
    import jax

    from historian_tpu import native
    from historian_tpu.ops import cuda_colforward

    devs = jax.devices()
    d = devs[0]
    check(d.platform == "gpu", f"JAX's first device is {d.platform}, not a GPU")
    check("H100" in d.device_kind, f"device kind {d.device_kind!r} is not an H100")
    t0 = time.perf_counter()
    cuda_colforward.register()
    return {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs),
        "jax": jax.__version__, "native": native.get_native() is not None,
        "kernel_build_s": time.perf_counter() - t0,
    }


def _merges():
    """The two phase-2 merges, host-filled in f64 (the oracle).  The
    DAG comes from leaves of the two subtrees (long8's sister leaves are
    too close for sampled paths to diverge)."""
    from historian_tpu.core.seqs import read_fasta
    from historian_tpu.engine.forward import ForwardMatrix
    from historian_tpu.engine.pairhmm import PairHMM
    from historian_tpu.engine.profile import Profile
    from historian_tpu.models.presets import named_model
    from historian_tpu.models.ratemodel import ProbModel
    from historian_tpu.utils.rng import MT19937

    model = named_model("lg")

    def prof(s, i):
        return Profile.from_sequence(model.components, model.alphabet, s, i)

    def hmm(a, b):
        return PairHMM(ProbModel(model, a), ProbModel(model, b), model.ins_prob)

    l8 = read_fasta(os.path.join(DATA, "long8.fa"))
    f04 = ForwardMatrix(prof(l8[0], 0), prof(l8[4], 4), hmm(0.3, 0.3), 8)
    p04 = f04.sample_profile(MT19937(5489), 100, 0)
    dag = ForwardMatrix(prof(l8[2], 2), p04, hmm(0.3, 0.7), 9)
    l6 = read_fasta(os.path.join(DATA, "long6.fa"))
    chain = ForwardMatrix(prof(l6[0], 0), prof(l6[1], 1), hmm(0.1, 0.1), 6)
    return {"chain_x_dag_long8": dag, "chain_x_chain_long6": chain}


def child_kernel() -> dict:
    import jax
    import numpy as np

    from historian_tpu.ops import devicedp

    os.environ["HISTORIAN_DEVICE_DP"] = "0"
    t0 = time.perf_counter()
    merges = _merges()
    host_s = time.perf_counter() - t0
    os.environ["HISTORIAN_DEVICE_DP"] = "1"
    out = {"host_fill_s": host_s}
    for name, dp in merges.items():
        ref = dp.cells[: dp.x_size - 1, : dp.y_size - 1]
        ay = devicedp._profile_dag_arrays(dp.y, dp.y_size - 1)
        real = ay["lp"] > devicedp.NEG / 2
        reach = (np.arange(dp.y_size - 1)[:, None] - ay["src"])[real]
        row = {"nx": dp.x_size - 1, "ny": dp.y_size - 1, "KY": int(ay["K"]),
               "max_in_edge_distance": int(reach.max(initial=0)),
               "host_lp_end": float(dp.lp_end)}
        for label, kernel, dtype, where in (
            ("cuda_f32", "cuda", "f32", "gpu"),
            ("cuda_f64", "cuda", "f64", "gpu"),
            ("xla_gpu_f32", "xla", "f32", "gpu"),
            ("xla_cpu_f32", "xla", "f32", "cpu"),
        ):
            os.environ["HISTORIAN_COL_KERNEL"] = kernel
            os.environ["HISTORIAN_DEVICE_DTYPE"] = dtype
            with jax.default_device(jax.devices(where)[0]):
                if where == "gpu":
                    devicedp.col_forward_cells(dp)  # compile + warm
                t = time.perf_counter()
                cells = devicedp.col_forward_cells(dp)
                row[f"{label}_s"] = time.perf_counter() - t
                handle = devicedp.col_forward_device(dp)
                lp_end = handle.lp_end
                if label == "cuda_f32":  # the device best-trace walk
                    handle.lp_end_and_traces(0, True, 0)
                    t = time.perf_counter()
                    _, traces = handle.lp_end_and_traces(0, True, 0)
                    row["walk_s"] = time.perf_counter() - t
                    row["walk_steps"] = len(traces[0][0])
            row[f"{label}_max_rel_err"] = _rel_err(cells, ref)
            row[f"{label}_lp_end_rel_err"] = abs(lp_end - dp.lp_end) / max(abs(dp.lp_end), 1.0)
            print(f"{name} {label}: {row[f'{label}_s']:.3f}s, max rel err "
                  f"{row[f'{label}_max_rel_err']:.3g}", file=sys.stderr, flush=True)
        for k in ("HISTORIAN_COL_KERNEL", "HISTORIAN_DEVICE_DTYPE"):
            os.environ.pop(k)
        out[name] = row
        # f64 on the card: the kernel is exact to the tolerance.  f32
        # drifts with the size of the merge for any implementation
        # (small log-sum-exp increments fall below half an ulp of
        # values near -1e4), so the f32 scans are held to the f32 XLA
        # scan's own error on the CPU, and to 1e-5 where that is below.
        for label in ("cuda_f64", "cuda_f32", "xla_gpu_f32"):
            for what in ("max_rel_err", "lp_end_rel_err"):
                err = row[f"{label}_{what}"]
                bound = KERNEL_RTOL if label == "cuda_f64" else max(
                    KERNEL_RTOL, 2 * row[f"xla_cpu_f32_{what}"])
                check(err <= bound, f"{name}: {label} {what} {err:.3g} > {bound:.3g}")
    return out


def child_cli(out_path: str, argv: list[str]) -> dict:
    """historian_tpu.cli.main(argv) with its stdout in out_path and the
    device merge routes counted (wrapping, no program change)."""
    from historian_tpu.ops import devicedp
    from historian_tpu.parallel import spmerge

    counts = {"col": 0, "chain": 0, "dag": 0, "sp": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            if out is not None:
                counts[name] += 1
            return out
        return wrapped

    devicedp.col_forward_cells = counting("col", devicedp.col_forward_cells)
    devicedp.chain_forward_cells = counting("chain", devicedp.chain_forward_cells)
    devicedp.dag_forward_cells = counting("dag", devicedp.dag_forward_cells)
    spmerge.sp_forward_cells = counting("sp", spmerge.sp_forward_cells)

    from historian_tpu.cli import main

    t0 = time.perf_counter()
    saved = sys.stdout
    with open(out_path, "w") as f:
        sys.stdout = f
        try:
            rc = main(argv)
        finally:
            sys.stdout = saved
    return {"rc": rc, "wall_s": time.perf_counter() - t0, "device_merges": counts}


# ------------------------------------------------------------------ parent
def run_child(tag: str, args: list[str], env_extra: dict | None = None,
              timeout: float = 900) -> dict:
    env = dict(os.environ)
    env.update(env_extra or {})
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout,
    )
    wall = time.perf_counter() - t0
    with open(os.path.join(OUT, f"{tag}.stderr"), "w") as f:
        f.write(proc.stderr)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise SmokeFailure(
            f"phase {tag} failed (rc={proc.returncode}):\n{proc.stderr[-3000:]}"
        )
    res = json.loads(lines[-1])
    res["process_wall_s"] = wall
    print(f"[{tag}] {json.dumps(res)}", flush=True)
    return res


def lp_of(path: str) -> float:
    with open(path) as f:
        text = f.read()
    m = re.search(r"#=GF LP\s+(-?[0-9.eE+]+)", text)
    check(text.startswith("# STOCKHOLM") and m is not None,
          f"{path}: no Stockholm output with #=GF LP")
    return float(m.group(1))


def recon(tag: str, argv: list[str], env_extra: dict | None = None,
          platform: str = "") -> tuple[dict, str]:
    out = os.path.join(OUT, f"{tag}.stk")
    args = (["-platform", platform] if platform else []) + argv
    res = run_child(tag, ["cli", out, "--", *args], env_extra)
    check(res["rc"] == 0, f"{tag}: exit code {res['rc']}")
    res["lp"] = lp_of(out)
    return res, out


_NUM = re.compile(r"-?\d+(?:\.\d*)?(?:[eE][-+]?\d+)?")


def counts_agree(a_path: str, b_path: str) -> float:
    """Largest relative difference between the numbers of two count
    files (the reference's JSON-like layout, compared token by token);
    fails unless the text between numbers matches and every number
    agrees to 4 significant figures."""
    with open(a_path) as f:
        a = f.read()
    with open(b_path) as f:
        b = f.read()
    check(_NUM.sub("#", a) == _NUM.sub("#", b), "count files differ in layout")
    worst = 0.0
    for x, y in zip(map(float, _NUM.findall(a)), map(float, _NUM.findall(b))):
        d = abs(x - y) / max(abs(x), abs(y), 1e-300)
        worst = max(worst, d)
        check(f"{x:.4g}" == f"{y:.4g}" or d < 5e-4, f"counts differ: {x} vs {y}")
    return worst


def count(tag: str, recon_path: str, extra: list[str], platform: str = "",
          env_extra: dict | None = None) -> tuple[dict, str]:
    out = os.path.join(OUT, f"{tag}.json")
    args = (["-platform", platform] if platform else []) + [
        "count", "-preset", "lg", *extra, "-stockrecon", recon_path]
    res = run_child(tag, ["cli", out, "--", *args], env_extra)
    check(res["rc"] == 0, f"{tag}: exit code {res['rc']}")
    return res, out


def one_card() -> dict:
    dev = run_child("1_device", ["device"])
    print(f"jax {dev['jax']}; native host library "
          + ("loaded" if dev["native"] else
             "NOT loaded: the host oracle is the slow numpy fill"), flush=True)
    run_child("2_kernel", ["kernel"], timeout=1200)

    fast = ["recon", "-fast", "-noband", "-preset", "lg",
            "-tree", os.path.join(DATA, "long12.nh"), os.path.join(DATA, "long12.fa")]
    careful = ["recon", "-careful", "-norefine", "-noband", "-preset", "lg",
               "-tree", os.path.join(DATA, "long8.nh"), os.path.join(DATA, "long8.fa")]
    recon_out = {}
    for name, argv in (("long12_fast", fast), ("long8_careful", careful)):
        gpu, path = recon(f"3_{name}_gpu", argv)
        merges = sum(gpu["device_merges"].values())
        check(merges > 0, f"{name}: no merge ran on the device route")
        gpu64, _ = recon(f"3_{name}_gpu_f64", argv, {"HISTORIAN_DEVICE_DTYPE": "f64"},
                         platform="gpu")
        cpu, _ = recon(f"3_{name}_cpu", argv, platform="cpu")
        print(f"{name}: LP gpu f32 {gpu['lp']:.6f} (diff {gpu['lp'] - cpu['lp']:+.6f} "
              f"vs cpu {cpu['lp']:.6f}); gpu f64 {gpu64['lp']:.6f}; "
              f"device merges {gpu['device_merges']}", flush=True)
        check(abs(gpu64["lp"] - cpu["lp"]) <= LP_TOL,
              f"{name}: f64 device LP {gpu64['lp']} vs cpu {cpu['lp']}")
        recon_out[name] = path
    gpu, g_path = count("4_count_gpu", recon_out["long12_fast"], [])
    cpu, c_path = count("4_count_cpu", recon_out["long12_fast"], [], platform="cpu")
    print(f"count: max relative difference gpu vs cpu "
          f"{counts_agree(g_path, c_path):.3g}", flush=True)
    return dev


def four_cards() -> dict:
    dev = run_child("1_device", ["device"])
    check(dev["count"] >= 4, f"--cards 4 needs four GPUs, JAX sees {dev['count']}")
    argv = ["recon", "-fast", "-noband", "-preset", "lg",
            "-tree", os.path.join(DATA, "long8x12k.nh"), os.path.join(DATA, "long8x12k.fa")]
    f64 = {"HISTORIAN_DEVICE_DTYPE": "f64"}
    mesh, m_path = recon("5_mesh4_recon", [argv[0], "-mesh", "4", *argv[1:]], f64)
    check(mesh["device_merges"]["sp"] > 0, "the -mesh 4 run made no SP ring merge")
    one, o_path = recon("5_card1_recon", argv, {**f64, "CUDA_VISIBLE_DEVICES": "0"})
    print(f"long8x12k: LP mesh4 {mesh['lp']:.6f} one card {one['lp']:.6f}; "
          f"walls {mesh['wall_s']:.1f}s vs {one['wall_s']:.1f}s; "
          f"SP merges {mesh['device_merges']['sp']}", flush=True)
    check(abs(mesh["lp"] - one["lp"]) <= LP_TOL,
          f"mesh LP {mesh['lp']} vs one card {one['lp']}")
    _, mc = count("5_mesh4_count", o_path, ["-mesh", "4"])
    _, oc = count("5_card1_count", o_path, [], env_extra={"CUDA_VISIBLE_DEVICES": "0"})
    print(f"count -mesh 4 vs one card: max relative difference "
          f"{counts_agree(mc, oc):.3g}", flush=True)
    return dev


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        sys.path.insert(0, REPO)
        phase = sys.argv[2]
        if phase == "cli":
            i = sys.argv.index("--")
            res = child_cli(sys.argv[3], sys.argv[i + 1:])
        else:
            res = {"device": child_device, "kernel": child_kernel}[phase]()
        print(json.dumps(res))
        return 0

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(REPO, "historian_tpu")):
        print("chip_smoke: the historian_tpu package is not beside this script",
              file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    t0 = time.perf_counter()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        check(smi.returncode == 0 and smi.stdout.strip() != "", "nvidia-smi found no GPU")
        dev = four_cards() if args.cards == 4 else one_card()
    except (SmokeFailure, OSError, subprocess.TimeoutExpired) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"total wall {time.perf_counter() - t0:.1f}s", flush=True)
    for line in smi.stdout.strip().splitlines():
        print(line.strip(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
