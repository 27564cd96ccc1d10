// pf_duplex row sweep (K6): the forward and the backward chain sums of the
// pure-duplex hybridization model.
//
// Replaces ractip_tpu/ops/duplex_pallas.py::sweep_pallas (_sweep_fwd,
// _sweep_kernel), and computes what ractip_tpu/ops/duplex.py::_sweep does:
// for the rows i of s1 in order (descending for the backward sweep), every
// cell (i, j) of the row sums the chain-start factor, the generic interior
// loops over a W = 31 row window (w2_raw[u1, u2] times the window row at
// distance u1+1, column j + (u2+1)), bulges of size >= 2, and the stacks,
// 1x1, 2x1, 2x2 and size-1 bulge loops from the three previous rows.  Each
// row is renormalised when its maximum exceeds 1e4, and the cumulative log
// scale is kept: the true value is M[i, j] * exp(lsc[i]).  The backward
// sweep mirrors every j-shift (j - k in place of j + k).
//
// What bounds it on the card: the bytes are the 11 factor matrices read once
// on the chain region (rows < n1, columns < n2; the rest is zero padding the
// kernel never reads) and M written once (44 bytes per valid cell and 4 per
// cell of M, per direction); the operations are about 1000 per valid cell
// (435 multiply-adds of the generic loop, 58 of the bulges, the shifted
// terms).  At 67 TFLOP/s and 3.35 TB/s those two bounds are about equal (~21
// FLOP per byte), but neither is what binds a sweep like this one: the rows
// are sequential, and every row needs a block-wide maximum before the next
// may start, so it is bound by the latency of one row step after another.
//
// Design: one block per instance and direction (grid (B, 2)), threads
// over the columns j (a thread owns j = tid, tid + blockDim, ...), the row
// loop inside the block.  The sweep covers the instance's n1 x n2 region
// only: padded rows and columns have zero factors, so their cells are 0
// and are written as such without being computed, and the log scale of a
// padded row is what the full sweep gives it (0 before the first valid row
// of the backward sweep, the last valid row's scale after the forward one).
// The three W-row windows (raw rows, rows x mm_other, rows x tau) are rings
// indexed by step mod W, which replaces the TPU kernel's
// shift-by-concatenate; they sit in shared memory (3 x 31 x L2 floats, 36
// KB at L2 = 96) or, where they do not fit, in a device-memory scratch the
// wrapper allocates (ring != nullptr).  The ring is rescaled in place only
// on the rows where the scale is not 1.
#include <cuda_runtime.h>

namespace rt_duplex {

constexpr int kW = 31;          // MAXLOOP + 1
constexpr int kNFac = 11;
enum Fac {
  START = 0, MM_HERE, MM_OTHER, TAU, PSTK, P11, P21A, P21B, P22, PB1A, PB1B
};
constexpr int kRed = 64;        // reduction scratch (32 warps + result)

// Maximum of v over the block; every thread gets it.  The barriers also
// separate the row's reads of the rings from the writes that follow.
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float x = lane < nw ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  return red[32];
}

__global__ void __launch_bounds__(1024) duplex_sweep_kernel(
    const float* __restrict__ fac,   // [2][kNFac][B][L1][L2]
    const float* __restrict__ w2_g,  // [kW][kW] w2_raw
    const float* __restrict__ bk_g,  // [kW] bulge_raw
    const int* __restrict__ n1_g,    // [B] rows of s1
    const int* __restrict__ n2_g,    // [B] columns of s2
    float* __restrict__ M,           // [2][B][L1][L2]
    float* __restrict__ lsc,         // [2][B][L1]
    float* ring_g,                   // [2][B][3][kW][L2] or nullptr
    int B, int L1, int L2) {
  extern __shared__ float sh[];
  float* s_w2 = sh;                  // [kW * kW]
  float* s_bk = s_w2 + kW * kW;      // [kW]
  float* s_red = s_bk + kW;          // [kRed]
  float* s_val = s_red + kRed;       // [L2] the row before renormalising
  const int b = blockIdx.x, dz = blockIdx.y;   // dz 1: the backward sweep
  const bool rev = dz == 1;
  const int sg = rev ? -1 : 1;
  const int n1 = min(max(n1_g[b], 0), L1), n2 = min(max(n2_g[b], 0), L2);
  const size_t cells = (size_t)L1 * L2;
  const size_t plane = (size_t)B * cells;
  const size_t wl = (size_t)kW * L2;
  float* ring = ring_g ? ring_g + ((size_t)dz * B + b) * 3 * wl
                       : s_val + L2;
  float* RF = ring;                  // raw rows
  float* RA = ring + wl;             // rows x mm_other
  float* RT = ring + 2 * wl;         // rows x tau
  const float* F = fac + (size_t)dz * kNFac * plane + (size_t)b * cells;
  float* Mo = M + (size_t)dz * plane + (size_t)b * cells;
  float* lo = lsc + ((size_t)dz * B + b) * L1;

  for (int x = threadIdx.x; x < kW * kW; x += blockDim.x) s_w2[x] = w2_g[x];
  for (int x = threadIdx.x; x < kW; x += blockDim.x) s_bk[x] = bk_g[x];
  for (size_t x = threadIdx.x; x < 3 * wl; x += blockDim.x) ring[x] = 0.f;
  // the padded rows: zero cells
  for (size_t x = (size_t)n1 * L2 + threadIdx.x; x < cells; x += blockDim.x)
    Mo[x] = 0.f;
  __syncthreads();

  // ring slot of the row at distance d (1 <= d <= W) from step t; rows
  // before step 0 map to slots not yet written, which hold zeros
  auto slot = [&](int t, int d) { return (t - d + kW) % kW; };
  float off = 0.f;
  for (int t = 0; t < n1; ++t) {
    const int i = rev ? n1 - 1 - t : t;
    const float eoff = expf(-off);
    const float* r1 = RF + slot(t, 1) * L2;
    const float* r2 = RF + slot(t, 2) * L2;
    const float* r3 = RF + slot(t, 3) * L2;
    const float* rt1 = RT + slot(t, 1) * L2;
    float lmax = 0.f;
    for (int j = threadIdx.x; j < n2; j += blockDim.x) {
      const float* f = F + (size_t)i * L2 + j;
      auto at = [&](const float* r, int k) {
        const int jj = j + sg * k;
        return (jj >= 0 && jj < n2) ? r[jj] : 0.f;
      };
      // columns j + sg*k stay inside [0, n2) for k <= kmax
      const int kmax = rev ? j : n2 - 1 - j;
      // generic interior loops: u1 unpaired on s1 (row distance u1+1),
      // u2 on s2 (column shift u2+1)
      float gen = 0.f;
      for (int u1 = 1; u1 < kW - 1; ++u1) {
        const float* ra = RA + slot(t, u1 + 1) * L2 + j;
        const float* w = s_w2 + u1 * kW;
        const int u2max = min(kW - 1 - u1, kmax - 1);
        for (int u2 = 1; u2 <= u2max; ++u2) gen += w[u2] * ra[sg * (u2 + 1)];
      }
      gen *= f[MM_HERE * plane];
      // bulges of size m >= 2: on s1 the row at distance m+1, column j+sg;
      // on s2 the previous row, column j + sg*(m+1)
      float b1 = 0.f, b2 = 0.f;
      if (kmax >= 1)
        for (int m = 2; m < kW; ++m)
          b1 += s_bk[m] * RT[slot(t, m + 1) * L2 + j + sg];
      const int mmax = min(kW - 1, kmax - 1);
      for (int m = 2; m <= mmax; ++m) b2 += s_bk[m] * rt1[j + sg * (m + 1)];
      const float bul = f[TAU * plane] * (b1 + b2);
      const float val = f[START * plane] * eoff + gen + bul
          + f[PSTK * plane] * at(r1, 1) + f[P11 * plane] * at(r2, 2)
          + f[P21A * plane] * at(r2, 3) + f[P21B * plane] * at(r3, 2)
          + f[P22 * plane] * at(r3, 3) + f[PB1A * plane] * at(r2, 1)
          + f[PB1B * plane] * at(r1, 2);
      s_val[j] = val;
      lmax = fmaxf(lmax, val);
    }
    // adaptive renormalisation, the policy of the jnp sweep
    const float m0 = fmaxf(block_max(lmax, s_red), 1e-30f);
    const float scale = m0 > 1e4f ? m0 : 1.f;
    const int cur = t % kW;
    if (scale != 1.f) {              // the same on every thread
      for (int x = threadIdx.x; x < 3 * kW * n2; x += blockDim.x) {
        float* r = ring + (size_t)(x / n2) * L2 + x % n2;
        *r = *r / scale;
      }
      __syncthreads();
    }
    for (int j = threadIdx.x; j < L2; j += blockDim.x) {
      if (j >= n2) {                 // padded column
        Mo[(size_t)i * L2 + j] = 0.f;
        continue;
      }
      const float* f = F + (size_t)i * L2 + j;
      const float vn = s_val[j] / scale;
      Mo[(size_t)i * L2 + j] = vn;
      RF[cur * L2 + j] = vn;
      RA[cur * L2 + j] = vn * f[MM_OTHER * plane];
      RT[cur * L2 + j] = vn * f[TAU * plane];
    }
    off = off + logf(scale);
    if (threadIdx.x == 0) lo[i] = off;
    __syncthreads();                 // the new row before the next step
  }
  // log scales of the padded rows: those the full sweep would carry there
  for (int i = n1 + threadIdx.x; i < L1; i += blockDim.x)
    lo[i] = rev ? 0.f : off;
}

}  // namespace rt_duplex

// Shared memory the kernel needs for L2, with the rings (ring_in_shared)
// or without them.
extern "C" long long rt_duplex_smem(int L2, int ring_in_shared) {
  using namespace rt_duplex;
  long long f = kW * kW + kW + kRed + (long long)L2;
  if (ring_in_shared) f += 3LL * kW * L2;
  return f * (long long)sizeof(float);
}

extern "C" int rt_duplex_sweep(const float* fac, const float* w2,
                               const float* bk, const int* n1, const int* n2,
                               float* M, float* lsc, float* ring, int B,
                               int L1, int L2, void* stream) {
  using namespace rt_duplex;
  const int threads = L2 >= 1024 ? 1024 : ((L2 + 31) / 32) * 32;
  const size_t shmem = (size_t)rt_duplex_smem(L2, ring == nullptr);
  cudaError_t e = cudaFuncSetAttribute(
      duplex_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B, 2);
  duplex_sweep_kernel<<<grid, threads, shmem,
                        static_cast<cudaStream_t>(stream)>>>(
      fac, w2, bk, n1, n2, M, lsc, ring, B, L1, L2);
  return (int)cudaGetLastError();
}
