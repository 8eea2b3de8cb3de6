"""Production multi-chip merge routing: SP + DP engaged from `-mesh`.

The reference's progressive merge loop (recon.cpp:917-1052) is strictly
sequential; SURVEY.md section 2.7 translates it to two device-mesh axes
that this module wires into the PRODUCTION router (engine/forward.py
fill dispatch + recon.py level scheduler):

- **SP (sequence parallel)**: a long merge's x chain shards over every
  mesh device and the column scan runs as a ring wavefront
  (ops/sp_colforward.py -- per column, five boundary scalars and two
  log2(n)-step affine-carry ring scans cross devices while each device does
  1/n of the vector work).  Exact: same recurrences, reassociated.
- **DP (data parallel)**: independent same-level merges round-robin
  over the mesh devices, so a level's single-device resident fills run
  concurrently on different chips instead of queuing on one.

Activation: `-mesh N` (or HISTORIAN_MESH) with N > 1 devices.
HISTORIAN_SP=1 forces every chain-x merge through the SP kernel (tests,
dryrun); =0 disables SP routing; auto applies the crossover below.
"""

from __future__ import annotations

import os

import numpy as np

#: minimum sharded-away x rows per column for the ring to pay: SP
#: replaces a single-device column step with 1/n of its vector work plus
#: ~2 log2(n) + 3 ppermute hops per column, so the x rows it shards away,
#: SX * (1 - 1/n), must exceed a crossover.  A prior that the H100 does
#: not bear out: on four NVIDIA H100 80GB HBM3 (700 W power limit),
#: `recon -fast -noband -mesh 4` on tests/data/long8x12k (8 ring merges
#: at SX ~11000) took 258 s against 26.5 s on one card with the CUDA
#: column kernel (chip_smoke.py --cards 4).  Kept so that -mesh still
#: drives the ring until it is re-fit or rewritten.
SP_MIN_SX = int(float(os.environ.get("HISTORIAN_SP_MIN_SX", "8192")))

_SP_CACHE: tuple = (None, None)


def _env() -> str:
    return os.environ.get("HISTORIAN_SP", "auto")


def sp_mesh():
    """A flat ("sp",) mesh over the active `-mesh` devices, or None when
    no multi-device mesh is active (cached per active mesh)."""
    global _SP_CACHE
    if _env() == "0":
        return None
    from historian_tpu.parallel.pcounts import active_mesh

    base = active_mesh()
    if base is None:
        return None
    devs = list(base.devices.flat)
    if len(devs) < 2:
        return None
    if _SP_CACHE[0] is base:
        return _SP_CACHE[1]
    from jax.sharding import Mesh

    mesh = Mesh(np.array(devs), ("sp",))
    _SP_CACHE = (base, mesh)
    return mesh


def sp_merge_wins(dp, n_dev: int) -> bool:
    """Routing decision for one merge fill: the SP ring only pays when
    the per-column vector work it shards away exceeds its per-column
    ring latency (long x chains)."""
    if dp.x_empty or dp.y_empty or dp.x.as_chain() is None:
        return False
    if _env() == "1":
        return True
    nx = dp.x_size - 1
    return nx * (1.0 - 1.0 / n_dev) >= SP_MIN_SX


def sp_forward_cells(dp, mesh) -> np.ndarray | None:
    """Fill one production merge (chain x, any profile-DAG y) with the
    mesh-sharded SP column kernel; returns the host-layout [nx, ny, 5]
    cell tensor (same contract as ops.devicedp.col_forward_cells) or
    None when the merge shape does not qualify."""
    if dp.x_empty or dp.y_empty or dp.x.as_chain() is None:
        return None
    import jax

    from historian_tpu.ops import devicedp
    from historian_tpu.ops.devicedp import NEG_CUTOFF, col_kernel_inputs
    from historian_tpu.ops.sp_colforward import sp_col_forward_cells

    dtype = devicedp.fill_dtype()
    inp = col_kernel_inputs(dp, dtype=dtype)
    cells_t = np.asarray(
        sp_col_forward_cells(
            inp["absorb_t"], inp["rootsub_x"], inp["ins_x"], inp["rootsub_y"],
            inp["ins_y"], inp["mask_t"], inp["trans"], inp["x_ready"],
            inp["x_eos"], inp["y_src"], inp["y_lp"], inp["y_null"],
            inp["y_ready"], mesh=mesh,
        )
    )  # [SY, SX, 5]
    nx, ny = inp["nx"], inp["ny"]
    env_t = inp["mask_t"][:ny, :nx]
    out = np.full((ny, nx, 5), -np.inf)
    vals = cells_t[:ny, :nx][env_t].astype(np.float64)
    vals[vals < NEG_CUTOFF] = -np.inf
    out[env_t] = vals
    return out.transpose(1, 0, 2)


def dp_placement_devices():
    """Devices for round-robin placement of a level's independent merges
    (recon.py phase A), or None when no multi-device mesh is active."""
    from historian_tpu.parallel.pcounts import active_mesh

    base = active_mesh()
    if base is None:
        return None
    devs = list(base.devices.flat)
    return devs if len(devs) > 1 else None
