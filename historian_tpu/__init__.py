"""historian-tpu: a GPU-accelerated statistical phylogenetics framework.

A from-scratch reimplementation of the capabilities of evoldoers/historian
(multiple alignment + ancestral sequence reconstruction by transducer
composition; EM rate fitting; MCMC tree/alignment co-sampling; simulation),
designed for an accelerator:

- model layer and graph surgery run on host in float64 (numpy) -- these are
  tiny (alphabet <= 64) and latency-bound, not FLOP-bound;
- the hot loops (Felsenstein column batches, banded pairwise DP, distance
  matrices, transducer-composition Forward/Backward fills) run as JAX/XLA
  kernels (one of them CUDA through jax.ffi) in float32 log space, batched
  over columns / states / mixture components so the device sees large
  regular work;
- multi-chip scaling uses jax.sharding meshes with psum-reduced event counts
  (the on-device analogue of the reference's count/sum file MapReduce).

Reference layer map: see SURVEY.md (citations into /root/reference).
"""

__version__ = "0.1.0"


def _tune_malloc() -> None:
    """Keep glibc from returning big numpy temporaries to the kernel.

    The DP engines produce multi-hundred-MB temporaries every merge.  With
    glibc defaults, allocations over the (dynamic, <=32MB) threshold are
    mmap'd and munmap'd on free, so every merge re-faults its pages; on this
    class of host first-touch faults run ~10-45 s/GB (measured) vs ~0.1 s/GB
    for warm pages -- page faults, not arithmetic, dominate wall clock.
    Raising M_MMAP_THRESHOLD and M_TRIM_THRESHOLD keeps freed blocks on the
    heap for reuse (measured 58-140s -> ~1s per scan pass on gp120 -careful).
    Trade-off: process RSS stays at its high-water mark.  Disable with
    HISTORIAN_MALLOC=0.
    """
    import os

    if os.environ.get("HISTORIAN_MALLOC", "1") == "0":
        return
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        m_trim_threshold, m_top_pad, m_mmap_threshold = -1, -2, -3
        libc.mallopt(m_mmap_threshold, 1 << 30)
        libc.mallopt(m_trim_threshold, 1 << 30)
        libc.mallopt(m_top_pad, 1 << 24)
    except Exception:
        pass  # non-glibc platform: defaults stand


_tune_malloc()

from historian_tpu.core.alphabet import Alphabet
from historian_tpu.core.seqs import FastSeq, read_fasta, write_fasta
