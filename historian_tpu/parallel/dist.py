"""Multi-host (DCN) initialization for the count/fit mesh.

Single-host scaling rides NVLink via the dp mesh in parallel/pcounts; this
module adds the standard JAX multi-host recipe on top (SURVEY.md 2.7:
jax.distributed + a global mesh, the on-device analogue of running the
reference's count/sum file MapReduce across machines):

- every process calls `init_from_env()` before first device use;
- `jax.devices()` then reports the GLOBAL device list, so
  `pcounts.set_mesh(n)` builds a mesh whose collectives ride NVLink
  within a host and the network across hosts -- no other code changes,
  psum is psum;
- EM/MCMC restart after a host failure is the checkpoint story
  (utils/checkpoint): snapshots are deterministic host-side state, so
  every process restores identically from the same file.

Configuration comes from the standard JAX/cluster env vars when present
(JAX detects GKE / Slurm automatically) or from explicit
HISTORIAN_COORDINATOR / HISTORIAN_NUM_PROCESSES / HISTORIAN_PROCESS_ID.
The CLI triggers this when HISTORIAN_DIST=1 (or any of the explicit
vars) is set; single-process initialization is exercised in tests.
"""

from __future__ import annotations

import os

_INITIALIZED = False


def is_initialized() -> bool:
    return _INITIALIZED


def init_from_env() -> bool:
    """Initialize jax.distributed if this looks like a multi-host launch
    (or HISTORIAN_DIST=1 forces it); returns True when initialized.

    Safe to call more than once; a second call is a no-op."""
    global _INITIALIZED
    if _INITIALIZED:
        return True
    coord = os.environ.get("HISTORIAN_COORDINATOR")
    nproc = os.environ.get("HISTORIAN_NUM_PROCESSES")
    pid = os.environ.get("HISTORIAN_PROCESS_ID")
    forced = os.environ.get("HISTORIAN_DIST") == "1"
    if not (forced or coord or nproc or pid):
        return False
    import jax

    kwargs = {}
    if coord:
        kwargs["coordinator_address"] = coord
    if nproc:
        kwargs["num_processes"] = int(nproc)
    if pid:
        kwargs["process_id"] = int(pid)
    if forced and not coord:
        # explicit single-host bring-up (dryrun/tests): loopback
        # coordinator, one process
        kwargs.setdefault("coordinator_address", "127.0.0.1:12321")
        kwargs.setdefault("num_processes", 1)
        kwargs.setdefault("process_id", 0)
    jax.distributed.initialize(**kwargs)
    _INITIALIZED = True
    return True


def global_mesh(n_devices: int | None = None):
    """A dp mesh over the global (multi-host) device list."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(
            f"{n_devices} devices requested, {len(devices)} visible globally"
        )
    return Mesh(np.array(devices[:n_devices]), ("dp",))
