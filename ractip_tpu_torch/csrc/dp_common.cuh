// Shared pieces of the McCaskill column-scan kernels (fold and cofold).
//
// Layout: every [B, L, L] matrix a kernel streams is stored per instance in
// column-major order, X[b][j][i] = M[b](i, j), so that a column j is one
// contiguous run over the rows i and the threads of a block (one thread per
// row i) read it coalesced.  The factor matrices come stacked as
// F[f][b][j][i] in the field order of ractip_tpu_torch.ops.factors.
// The resident tables the outside kernels contract against (qm, qx) come in
// the natural row-major layout M[b][l][i], which is coalesced over i too.
#pragma once

#include <cuda_runtime.h>

namespace rt {

constexpr int kMaxLoop = 30;
constexpr int kW = kMaxLoop + 1;   // interior-loop window (31)
constexpr int kPow2 = 11;          // doubling steps of the ml_base scans
constexpr float kHuge = 1e30f;     // saturating ceiling of every DP table
constexpr int kRing = 32;          // window ring depth (columns), >= kW + 1
constexpr int kRaw = 4;            // raw qb / ob ring depth (stacks, loops)
constexpr float kLogNormal = -80.f;     // log(1.8e-35): safely above FLT_MIN

// Floats of a scan's column rings: two window rings and one raw ring of L
// rows each.
__host__ __device__ inline size_t ring_floats(int L) {
  return (size_t)(2 * kRing + kRaw) * L;
}

// Placement of a scan's large arrays (the kSmem template bits): each set
// bit puts one in shared memory, else it lives in device memory.
constexpr int kRingS = 1;     // the column rings
constexpr int kOmS = 2;       // the outside scans' om table
constexpr int kQmS = 4;       // the qm table, packed as a strict triangle
constexpr int kSmemBlock = 232448;   // opt-in shared memory of one block
constexpr int kSmemSM = 233472;      // shared memory of one SM (1 KB a
                                     // block is the runtime's)

// A strictly upper triangular L x L table packed by columns: column l holds
// rows 0..l-1 from tri(l) on (L (L-1) / 2 floats in all).
__host__ __device__ inline int tri(int l) { return l * (l - 1) / 2; }

// Blocks of `smem` bytes that fit one SM by shared memory alone.
inline int blocks_by_smem(size_t smem) {
  return (int)(kSmemSM / (smem + 1024));
}

// A scan variant's launch: its kernel (V::fn), threads and shared memory.
// Blocks of it an SM, threads, shared memory and registers together (0 if
// the runtime cannot say).
template <class V>
int blocks_per_sm(const V& v) {
  cudaFuncSetAttribute(v.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)v.smem);
  int nb = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, v.fn, v.threads,
                                                    v.smem) != cudaSuccess)
    return 0;
  return nb;
}

// Waves of B blocks of v on the card (a large count where v cannot run).
template <class V>
int waves(const V& v, int B) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int per = blocks_per_sm(v) * sms;
  return per > 0 ? (B + per - 1) / per : 1 << 30;
}

enum Field {
  FHN = 0, PSTK, P11, P21A, P21B, P22, PB15, PB13, TAU, TAUR, MOUT, MINN,
  FMB, FMC, FE, FCX
};

// min(x, HUGE) that keeps NaN (as jnp.minimum does), so the host-side
// saturation test sees it.
__device__ __forceinline__ float clamp_huge(float x) {
  return x > kHuge ? kHuge : x;
}

// y[i] = sum_{k>=i} a^(k-i) v[k] by recursive doubling with pw[s] =
// a^(2^s) and zero fill past the end: the plain version's steps, for where
// the order of the roundings matters (subnormal values).  All threads of
// the block call it; buf holds L floats.
template <bool kUp>
__device__ __forceinline__ float doubling_scan(float v, int i, int L,
                                               const float* pw, float* buf) {
  __syncthreads();
  if (i < L) buf[i] = v;
  __syncthreads();
  int s = 1;
  for (int idx = 0; idx < kPow2 && s < L; ++idx, s <<= 1) {
    float y = 0.f, nb = 0.f;
    if (i < L) {
      y = buf[i];
      const int k = kUp ? i + s : i - s;
      if (k >= 0 && k < L) nb = buf[k];
    }
    __syncthreads();
    if (i < L) buf[i] = y + pw[idx] * nb;
    __syncthreads();
  }
  return i < L ? buf[i] : 0.f;
}

// a^m for 0 <= m <= 32 from pw[s] = a^(2^s).
__device__ __forceinline__ float pow_bits(const float* pw, int m) {
  if (m == 32) return pw[5];
  float p = 1.f;
  for (int s = 0; s < 5; ++s)
    if (m & (1 << s)) p *= pw[s];
  return p;
}

// Sum of v over the kT consecutive lanes that share a row (several threads
// per row); every one of them gets the same sum.  The shuffles name only
// the row's lanes, so rows of one warp may take different branches.
template <int kT>
__device__ __forceinline__ float row_sum(float v) {
  if (kT == 1) return v;
  const unsigned mask = ((1u << kT) - 1u) << ((threadIdx.x & 31) & ~(kT - 1));
#pragma unroll
  for (int o = 1; o < kT; o <<= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

// The ml_base scans y[i] = sum_{k>=i} a^(k-i) v[k] (kUp) or
// sum_{k<=i} a^(i-k) v[k] of NV vectors over the rows (kT lanes a row, all
// holding the row's element; zero past the rows) in two halves around one
// block barrier: warp_scan scans the 32 / kT rows of each warp with
// shuffles and stores the warps' totals in tot[q*32 + warp]; after a
// __syncthreads() scan_carry adds a^(distance) times the carry from the
// other warps.  tot must not be rewritten before a further barrier.  With
// R = 32 / kT rows a warp and r the row within it, apw is a^(R - r) (kUp)
// or a^(r + 1) and aR = a^R: pow_bits, once per kernel.
template <bool kUp, int kT, int NV>
__device__ __forceinline__ void warp_scan(float (&v)[NV], const float* pw,
                                          float* tot) {
  constexpr int R = 32 / kT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = lane / kT;
#pragma unroll
  for (int s = 0; (1 << s) < R; ++s) {
    const int d = 1 << s;
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const float t = kUp ? __shfl_down_sync(0xffffffffu, v[q], d * kT)
                          : __shfl_up_sync(0xffffffffu, v[q], d * kT);
      if (kUp ? r + d < R : r >= d) v[q] += pw[s] * t;
    }
  }
  if (lane == (kUp ? 0 : 31)) {
#pragma unroll
    for (int q = 0; q < NV; ++q) tot[q * 32 + warp] = v[q];
  }
}

template <bool kUp, int NV>
__device__ __forceinline__ void scan_carry(float (&v)[NV], float apw,
                                           float aR, const float* tot) {
  const int warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    float c = 0.f;
    if (kUp)
      for (int w = nw - 1; w > warp; --w) c = tot[q * 32 + w] + aR * c;
    else
      for (int w = 0; w < warp; ++w) c = tot[q * 32 + w] + aR * c;
    v[q] += apw * c;
  }
}

// The warp's sum of v into red[warp]; after a barrier, sum_red(red) gives
// every thread the block's sum (shuffle tree, then the warps in order).
__device__ __forceinline__ void warp_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
}

__device__ __forceinline__ float sum_red(const float* red) {
  const int nw = (blockDim.x + 31) >> 5;
  float s = 0.f;
  for (int w = 0; w < nw; ++w) s += red[w];
  return s;
}

// M5[d](i): a 5' jump i -> i+d does not cross the cut.
__device__ __forceinline__ float m5(int d, int i, int cut) {
  return (i < cut && cut <= i + d) ? 0.f : 1.f;
}

}  // namespace rt
