"""The column kernel for NVIDIA Hopper (native_src/colforward.cu), called
through jax.ffi.

The kernel runs the whole column scan of one merge in a single launch:
one thread block walks the SY columns, reads each column's y in-edge
sources back from the output planes, and does the two within-column
affine scans as a block scan.  It computes the same recurrence as
ops/colforward.py::col_pair_forward_cells, the plain XLA version it is
checked against.

The shared library is built from the source on first use with nvcc
(sm_90a) into native_src/build/, keyed by a hash of the source, so a
stale build is never loaded.  There is no interpret mode: on a machine
without a GPU only the operand packing below runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

NEG = -1e30

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native_src", "colforward.cu",
)
_BUILD_DIR = os.path.join(os.path.dirname(_SRC), "build")
#: FFI target name and exported handler symbol per element type
_TARGETS = {
    np.dtype(np.float32): ("historian_col_forward_f32", "HistorianColForwardF32"),
    np.dtype(np.float64): ("historian_col_forward_f64", "HistorianColForwardF64"),
}
_registered = False


def nvcc_path() -> str | None:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return path if os.path.exists(path) else None


def lib_path() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"libcolforward-{tag}.so")


def build_command(out: str) -> list[str]:
    import jax.ffi

    return [
        nvcc_path() or "nvcc",
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(),
        "-o", out, _SRC,
    ]


def build() -> str:
    """Path of the built library, compiling it first if needed."""
    path = lib_path()
    if os.path.exists(path):
        return path
    if nvcc_path() is None:
        raise RuntimeError(
            "the CUDA column kernel needs nvcc to build "
            f"{os.path.relpath(_SRC)}; set HISTORIAN_COL_KERNEL=xla to run "
            "the XLA column scan instead"
        )
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(build_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building the column kernel:\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def register() -> None:
    """Load the library and register its handlers with XLA (once)."""
    global _registered
    if _registered:
        return
    import jax

    lib = ctypes.cdll.LoadLibrary(build())
    for target, symbol in _TARGETS.values():
        jax.ffi.register_ffi_target(
            target, jax.ffi.pycapsule(getattr(lib, symbol)), platform="CUDA"
        )
    _registered = True


def kernel_operands(absorb, mask, v):
    """Pack the col route's inputs into the kernel's operand list:
    absorb [SY, SX], mask gate [SY, SX] (0 in band, NEG outside),
    xvec [4, SX] (rootsub_x, ins_x, x_ready gate, x_eos gate),
    yvec [SY, 4] (null, ready, rootsub_y, ins_y), y_src [SY, KY] i32,
    y_lp [SY, KY], trans [23].  Traceable (runs inside the fill's jit)."""
    import jax.numpy as jnp

    dtype = absorb.dtype
    neg = jnp.asarray(NEG, dtype)
    zero = jnp.asarray(0, dtype)
    maskg = jnp.where(mask, zero, neg)
    xvec = jnp.stack([
        v["rsx"].astype(dtype), v["isx"].astype(dtype),
        jnp.where(v["x_ready"], zero, neg), jnp.where(v["x_eos"], zero, neg),
    ])
    yvec = jnp.stack([
        v["y_null"].astype(dtype), v["y_ready"].astype(dtype),
        v["rsy"].astype(dtype), v["isy"].astype(dtype),
    ], axis=1)
    return (
        absorb, maskg, xvec, yvec, v["y_src"].astype(jnp.int32),
        v["y_lp"].astype(dtype), v["trans"].astype(dtype),
    )


def col_forward_planes(absorb, mask, v):
    """The CUDA column scan: [5, SY, SX] state planes (IMM, IMD, IDM,
    IMI, IIW), the layout the device trace walk reads."""
    import jax

    register()
    SY, SX = absorb.shape
    dtype = np.dtype(absorb.dtype)
    call = jax.ffi.ffi_call(
        _TARGETS[dtype][0], jax.ShapeDtypeStruct((5, SY, SX), dtype)
    )
    return call(*kernel_operands(absorb, mask, v))
