"""Device compute kernels (JAX/XLA, plus one CUDA kernel through jax.ffi).

Everything in this package is batched over columns / pairs / states so
the device sees large regular operations, with static shapes under jit,
log-space float32 on the hot paths and float64 available on CPU for
golden-parity testing.
"""

import os

import jax

# Allow explicit float64/complex128 on host paths (parity tests, model math).
# Hot-path kernels request float32 explicitly.
jax.config.update("jax_enable_x64", True)

# Likelihood matmuls (the factored emission absorb, Felsenstein pruning,
# distance grids, count contractions) run in full float32: on the GPU,
# XLA would otherwise take TF32 for f32 matmuls, which keeps about three
# decimal digits.  Set once here for every kernel in the package.
jax.config.update("jax_default_matmul_precision", "highest")


def _machine_key() -> str:
    """Cache-key the host CPU: XLA:CPU persists AOT executables whose key
    does not include machine features, so a cache written on one
    microarchitecture can SIGILL on another. Isolate per feature set."""
    import hashlib
    import platform

    tag = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    tag += line
                    break
    except OSError:
        pass
    return hashlib.sha1(tag.encode()).hexdigest()[:12]


#: checkout root; the default compile cache lives inside it (.gitignore)
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """Persistent XLA compilation cache: JAX_COMPILATION_CACHE_DIR when
    set (JAX reads it itself), else .jax_cache/ in the checkout, one
    subdirectory per host CPU feature set."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return os.path.join(_REPO, ".jax_cache", "xla-" + _machine_key())


# Kernel shapes recur across CLI runs (fills are bucketed for exactly
# this reason), so compiles that take a second or more are kept.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
