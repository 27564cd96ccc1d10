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

enum Field {
  FHN = 0, PSTK, P11, P21A, P21B, P22, PB15, PB13, TAU, TAUR, MOUT, MINN,
  FMB, FMC, FE, FCX
};

// min(x, HUGE) that keeps NaN (as jnp.minimum does), so the host-side
// saturation test sees it.
__device__ __forceinline__ float clamp_huge(float x) {
  return x > kHuge ? kHuge : x;
}

// Sum of v over the block; every thread gets the result.  red holds
// blockDim.x / 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  __syncthreads();                       // red may still be read
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nw; ++w) s += red[w];
  return s;
}

// y[i] = sum_{k>=i} a^(k-i) v[k] (kUp) or y[i] = sum_{k<=i} a^(i-k) v[k],
// by recursive doubling with pw[s] = a^(2^s) and zero fill past the ends:
// the same steps as the TPU kernels' lane-shift scans.  All threads of the
// block call it; buf holds L floats.
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

// M5[d](i): a 5' jump i -> i+d does not cross the cut.
__device__ __forceinline__ float m5(int d, int i, int cut) {
  return (i < cut && cut <= i + d) ? 0.f : 1.f;
}

}  // namespace rt
