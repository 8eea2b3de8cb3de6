// Column-major Forward DP (chain x, profile-DAG y) as one CUDA kernel.
//
// Same recurrence as historian_tpu/ops/colforward.py::col_pair_forward_cells
// (the XLA reference), written for one thread-block CLUSTER that walks all
// SY columns itself: a column is one step of the sequential loop, so a
// merge is ONE launch instead of several per column.  The x rows of a
// column are split into contiguous slices, one per block of the cluster
// (up to 8 SMs), and the blocks meet at cluster barriers.
//
// Per column j:
//   pass A  (coalesced over x rows i): gather the column's y in-edge
//           sources from the output planes (earlier columns, resident in
//           L2), reduce over edges, and write IMM / IDM / IMI;
//   pass B  the two within-column affine log-semiring scans (IMD, IIW):
//           each thread composes its contiguous chunk of rows, a block
//           scan over the per-thread summaries (warp shuffles + shared
//           memory) and a scan over the blocks' totals (read from the
//           other blocks' shared memory) give every chunk its carry, and
//           a second walk over the chunk writes the scanned values.
//
// The semiring zero is the finite NEG = -1e30; out-of-band cells carry
// the additive mask gate (0 in band, NEG outside).  Output planes are
// [5, SY, SX] in state order IMM, IMD, IDM, IMI, IIW.
//
// Build (sm_90a, Hopper):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> -o libcolforward.so colforward.cu
// historian_tpu/ops/cuda_colforward.py runs exactly this on first use.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace cg = cooperative_groups;
namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 512;     // threads per block
constexpr int kMaxCluster = 8;    // portable cluster size limit
constexpr int kRowsPerBlock = 1024;  // target x rows per block

template <typename T>
__device__ __forceinline__ T neg_v() {
  return T(-1e30);
}

// Full-precision exp/log: the MUFU approximations (__expf, __logf) drift
// past the 1e-5 relative tolerance over a 6000-column merge.
__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ float ln(float x) { return logf(x); }
__device__ __forceinline__ float ln1p(float x) { return log1pf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ double ln(double x) { return log(x); }
__device__ __forceinline__ double ln1p(double x) { return log1p(x); }

template <typename T>
__device__ __forceinline__ T lae(T a, T b) {
  const T m = a > b ? a : b;
  const T d = (a > b ? b : a) - m;
  return m + ln1p(ex(d));
}

// Online log-sum-exp accumulator: one exp per term, one log at the end.
template <typename T>
struct Lse {
  T m, s;
  __device__ __forceinline__ Lse() : m(T(-1e30)), s(T(0)) {}
  __device__ __forceinline__ void add(T x) {
    if (x > m) {
      s = s * ex(m - x) + T(1);
      m = x;
    } else {
      s += ex(x - m);
    }
  }
  __device__ __forceinline__ T get() const { return s > T(0) ? m + ln(s) : m; }
};

template <typename T>
__device__ __forceinline__ T mx(T a, T b) {
  return a > b ? a : b;
}

// Affine map u -> lae(v, u + w); compose(l, r) applies l first.
template <typename T>
struct Aff {
  T v, w;
};

template <typename T>
__device__ __forceinline__ Aff<T> compose(Aff<T> l, Aff<T> r) {
  return {lae(r.v, l.v + r.w), mx(l.w + r.w, neg_v<T>())};
}

template <typename T>
__device__ __forceinline__ Aff<T> shfl_up(Aff<T> a, int d) {
  return {__shfl_up_sync(0xffffffffu, a.v, d), __shfl_up_sync(0xffffffffu, a.w, d)};
}

// Exclusive block scan of two affine summaries at once (IMD and IIW).
// `sm` holds 2 * 32 entries.  Requires blockDim.x % 32 == 0.
template <typename T>
__device__ void block_exclusive_scan2(Aff<T>& a, Aff<T>& b, Aff<T>* sm) {
  const Aff<T> ident = {neg_v<T>(), T(0)};
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  Aff<T> ia = a, ib = b;  // warp-inclusive
  for (int d = 1; d < 32; d <<= 1) {
    Aff<T> pa = shfl_up(ia, d), pb = shfl_up(ib, d);
    if (lane >= d) {
      ia = compose(pa, ia);
      ib = compose(pb, ib);
    }
  }
  if (lane == 31) {
    sm[warp] = ia;
    sm[32 + warp] = ib;
  }
  __syncthreads();
  if (warp == 0) {
    Aff<T> ta = lane < nwarps ? sm[lane] : ident;
    Aff<T> tb = lane < nwarps ? sm[32 + lane] : ident;
    for (int d = 1; d < 32; d <<= 1) {
      Aff<T> pa = shfl_up(ta, d), pb = shfl_up(tb, d);
      if (lane >= d) {
        ta = compose(pa, ta);
        tb = compose(pb, tb);
      }
    }
    sm[lane] = ta;  // inclusive over warps
    sm[32 + lane] = tb;
  }
  __syncthreads();
  Aff<T> ea = shfl_up(ia, 1), eb = shfl_up(ib, 1);  // warp-exclusive
  if (lane == 0) {
    ea = ident;
    eb = ident;
  }
  if (warp > 0) {
    ea = compose(sm[warp - 1], ea);
    eb = compose(sm[32 + warp - 1], eb);
  }
  a = ea;
  b = eb;
}

template <typename T>
struct Trans {
  T imm_imm, imm_imd, imm_idm, imm_imi, imm_iiw;
  T imd_imm, imd_imd, imd_idm;
  T idm_imm, idm_imd, idm_idm;
  T imi_imm, imi_imd, imi_imi, imi_iiw;
  T iiw_imm, iiw_idm, iiw_iiw;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
col_forward_kernel(const T* __restrict__ absorb,  // [SY, SX]
                   const T* __restrict__ maskg,   // [SY, SX] 0 | NEG
                   const T* __restrict__ xvec,    // [4, SX] rsx, isx, x_gate, x_eos
                   const T* __restrict__ yvec,    // [SY, 4] null, ready, rsy, isy
                   const int32_t* __restrict__ ysrc,  // [SY, KY]
                   const T* __restrict__ ylp,     // [SY, KY] (NEG pad)
                   const T* __restrict__ tr,      // [23] packed PairHMM
                   T* out,                        // [5, SY, SX]
                   int SY, int SX, int KY) {
  __shared__ Aff<T> sm[64];    // block scan: per-warp totals
  __shared__ Aff<T> total[2];  // this block's IMD / IIW slice totals
  __shared__ Aff<T> carry[2];  // composed totals of the blocks before it
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nblocks = static_cast<int>(cluster.num_blocks());
  const T NEG = neg_v<T>();
  const Aff<T> ident = {NEG, T(0)};
  const Trans<T> t = {tr[0],  tr[1],  tr[2],  tr[3],  tr[4],  tr[6],
                      tr[7],  tr[8],  tr[10], tr[11], tr[12], tr[14],
                      tr[15], tr[16], tr[17], tr[19], tr[20], tr[21]};
  const size_t P = size_t(SY) * SX;
  // the five planes never overlap, so each pointer may be restrict
  T* __restrict__ o_imm = out;
  T* __restrict__ o_imd = out + P;
  T* __restrict__ o_idm = out + 2 * P;
  T* __restrict__ o_imi = out + 3 * P;
  T* __restrict__ o_iiw = out + 4 * P;
  const T* rsx = xvec;
  const T* isx = xvec + SX;
  const T* xgate = xvec + 2 * SX;
  const T* xeos = xvec + 3 * SX;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  // this block's slice of x rows, and this thread's chunk of the slice
  const int per_block = (SX + nblocks - 1) / nblocks;
  const int x0 = min(rank * per_block, SX);
  const int x1 = min(x0 + per_block, SX);
  const int chunk = (x1 - x0 + nt - 1) / nt;
  const int lo = min(x0 + tid * chunk, x1);
  const int hi = min(lo + chunk, x1);

  for (int j = 0; j < SY; ++j) {
    const size_t row = size_t(j) * SX;
    const bool nul = yvec[4 * j] > T(0.5);
    const bool rdy = yvec[4 * j + 1] > T(0.5);
    const T rsy = yvec[4 * j + 2];
    const T isy = yvec[4 * j + 3];

    // ---- pass A: IMM, IDM, IMI ------------------------------------------
    // every log-sum-exp over (in-edge, source state) pairs is taken flat
    for (int i = x0 + tid; i < x1; i += nt) {
      Lse<T> t5a, immn, idma, idmn, imia, imin;
      for (int k = 0; k < KY; ++k) {
        const T w = ylp[j * KY + k];
        if (w <= NEG / 2) continue;  // padding slot
        const size_t s = size_t(ysrc[j * KY + k]) * SX + i;
        const T s_imm = o_imm[s] + w, s_imd = o_imd[s] + w, s_idm = o_idm[s] + w;
        const T s_imi = o_imi[s] + w, s_iiw = o_iiw[s] + w;
        immn.add(s_imm);
        idmn.add(s_idm);
        imin.add(s_imi);
        idma.add(s_imm + t.imm_idm);
        idma.add(s_imd + t.imd_idm);
        idma.add(s_idm + t.idm_idm);
        idma.add(s_iiw + t.iiw_idm);
        imia.add(s_imm + t.imm_imi);
        imia.add(s_imi + t.imi_imi);
        if (i > 0) {  // IMM reads its sources one x row back
          const size_t p = s - 1;
          t5a.add(o_imm[p] + w + t.imm_imm);
          t5a.add(o_imd[p] + w + t.imd_imm);
          t5a.add(o_idm[p] + w + t.idm_imm);
          t5a.add(o_imi[p] + w + t.imi_imm);
          t5a.add(o_iiw[p] + w + t.iiw_imm);
        }
      }
      const T mg = maskg[row + i];
      T imm = nul ? immn.get() + xeos[i] : t5a.get() + absorb[row + i];
      if (j == 0 && i == 0) imm = T(0);
      imm += mg;
      const T idm = (nul ? idmn.get() : idma.get() + rsy + xgate[i]) + mg;
      const T imi = (nul ? imin.get() : imia.get() + isy + xgate[i]) + mg;
      o_imm[row + i] = mx(imm, NEG);
      o_idm[row + i] = mx(idm, NEG);
      o_imi[row + i] = mx(imi, NEG);
    }
    cluster.sync();  // pass B reads row x0 - 1 of the previous block

    // ---- pass B: IMD / IIW affine scans over x ----------------------------
    // u[i] = lse(a[i], u[i-1] + b[i]).  The first walk over the thread's
    // chunk parks a[i] in the output slots (only this thread touches
    // them until the second walk overwrites them with u[i]).
    const T ygate = rdy ? T(0) : NEG;
    Aff<T> sa = ident, sb = ident;
    for (int i = lo; i < hi; ++i) {
      const T mg = maskg[row + i];
      T pa = NEG, pb = NEG;
      if (i > 0) {
        const T pm = o_imm[row + i - 1], pd = o_idm[row + i - 1], pi = o_imi[row + i - 1];
        Lse<T> la, lb;
        la.add(pm + t.imm_imd);
        la.add(pd + t.idm_imd);
        la.add(pi + t.imi_imd);
        lb.add(pm + t.imm_iiw);
        lb.add(pi + t.imi_iiw);
        pa = la.get();
        pb = lb.get();
      }
      const T aa = pa + rsx[i] + ygate + mg;
      const T ab = pb + isx[i] + ygate + mg;
      o_imd[row + i] = aa;
      o_iiw[row + i] = ab;
      sa = compose(sa, Aff<T>{aa, mx(t.imd_imd + rsx[i] + mg, NEG)});
      sb = compose(sb, Aff<T>{ab, mx(t.iiw_iiw + isx[i] + mg, NEG)});
    }
    const Aff<T> own_a = sa, own_b = sb;
    block_exclusive_scan2(sa, sb, sm);
    if (tid == nt - 1) {
      total[0] = compose(sa, own_a);
      total[1] = compose(sb, own_b);
    }
    cluster.sync();  // every block's slice total is published
    if (tid == 0) {
      Aff<T> ca = ident, cb = ident;
      for (int r = 0; r < rank; ++r) {
        const Aff<T>* other = cluster.map_shared_rank(total, r);
        ca = compose(ca, other[0]);
        cb = compose(cb, other[1]);
      }
      carry[0] = ca;
      carry[1] = cb;
    }
    __syncthreads();
    T ua = compose(carry[0], sa).v;  // carry in: u[lo - 1]
    T ub = compose(carry[1], sb).v;
    for (int i = lo; i < hi; ++i) {
      const T mg = maskg[row + i];
      ua = lae(o_imd[row + i], ua + mx(t.imd_imd + rsx[i] + mg, NEG));
      ub = lae(o_iiw[row + i], ub + mx(t.iiw_iiw + isx[i] + mg, NEG));
      o_imd[row + i] = mx(ua, NEG);
      o_iiw[row + i] = mx(ub, NEG);
    }
    cluster.sync();  // column j is final everywhere before j + 1 reads it
  }
}

// Blocks per cluster for an SX-row column: about kRowsPerBlock rows per
// block, a power of two up to the portable cluster limit.
inline int cluster_blocks(int SX) {
  int c = 1;
  while (c < kMaxCluster && SX > c * kRowsPerBlock) c <<= 1;
  return c;
}

template <typename T, ffi::DataType DT>
ffi::Error ColForward(cudaStream_t stream, ffi::Buffer<DT> absorb,
                      ffi::Buffer<DT> maskg, ffi::Buffer<DT> xvec,
                      ffi::Buffer<DT> yvec, ffi::Buffer<ffi::S32> ysrc,
                      ffi::Buffer<DT> ylp, ffi::Buffer<DT> trans,
                      ffi::ResultBuffer<DT> out) {
  const auto dims = absorb.dimensions();
  if (dims.size() != 2 || ysrc.dimensions().size() != 2 ||
      trans.element_count() < 23) {
    return ffi::Error::InvalidArgument("col_forward: bad operand ranks");
  }
  const int SY = static_cast<int>(dims[0]);
  const int SX = static_cast<int>(dims[1]);
  const int KY = static_cast<int>(ysrc.dimensions()[1]);
  const int blocks = cluster_blocks(SX);
  const int rows = (SX + blocks - 1) / blocks;
  int nt = ((rows + 31) / 32) * 32;
  nt = nt < 32 ? 32 : (nt > kThreads ? kThreads : nt);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(nt, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, col_forward_kernel<T>, absorb.typed_data(), maskg.typed_data(),
      xvec.typed_data(), yvec.typed_data(), ysrc.typed_data(),
      ylp.typed_data(), trans.typed_data(), out->typed_data(), SY, SX, KY);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

#define COL_FORWARD_BINDING(DT)                      \
  ffi::Ffi::Bind()                                   \
      .Ctx<ffi::PlatformStream<cudaStream_t>>()      \
      .Arg<ffi::Buffer<DT>>()                        \
      .Arg<ffi::Buffer<DT>>()                        \
      .Arg<ffi::Buffer<DT>>()                        \
      .Arg<ffi::Buffer<DT>>()                        \
      .Arg<ffi::Buffer<ffi::S32>>()                  \
      .Arg<ffi::Buffer<DT>>()                        \
      .Arg<ffi::Buffer<DT>>()                        \
      .Ret<ffi::Buffer<DT>>()

XLA_FFI_DEFINE_HANDLER_SYMBOL(HistorianColForwardF32,
                              (ColForward<float, ffi::F32>),
                              COL_FORWARD_BINDING(ffi::F32));
XLA_FFI_DEFINE_HANDLER_SYMBOL(HistorianColForwardF64,
                              (ColForward<double, ffi::F64>),
                              COL_FORWARD_BINDING(ffi::F64));
