// pf_duplex row sweep (K6): the forward and the backward chain sums of the
// pure-duplex hybridization model.
//
// Replaces ractip_tpu/ops/duplex_pallas.py::sweep_pallas (_sweep_fwd,
// _sweep_kernel), and computes what ractip_tpu_torch/ops/duplex.py::
// sweep_plain does: for the rows i of s1 in order (descending for the
// backward sweep), every cell (i, j) of the row sums the chain-start factor,
// the generic interior loops over a W = 31 row window (w2_raw[u1, u2] times
// the window row at distance u1+1, column j + (u2+1)), bulges of size >= 2,
// and the stacks, 1x1, 2x1, 2x2 and size-1 bulge loops from the three
// previous rows.  Each row is renormalised when its maximum exceeds 1e4, and
// the cumulative log scale is kept: the true value is M[i, j] * exp(lsc[i]).
// The backward sweep mirrors every j-shift (j - k in place of j + k).
//
// What bounds it on the card: the bytes are the 11 factor matrices read once
// on the chain region (rows < n1, columns < n2; the rest is zero padding the
// kernel never reads) and M written once; the operations are about 1000 per
// valid cell.  Neither binds a sweep like this one: the rows are sequential,
// and every row needs a block-wide maximum before the next may start, so the
// floor is the rows times the shortest row step.
//
// Design: one block per instance and direction (grid (B, 2)), the row loop
// inside the block.  A row step is short when its work is spread wide:
//  * G lanes a column group (G = 1, 2, 4 or 8): the lanes split the
//    window's u1 range and the bulge sizes, and combine their partial sums
//    with shuffles whose mask names only the group's lanes.  Each group
//    computes J adjacent columns (2 or 4), sliding the window values it
//    loads through registers (J + 28 loads and 29 weights for J x 29 terms
//    of a window row).  A batch that fills every SM takes J = 4 (fewer
//    shared-memory loads a term), a smaller one J = 2 (more lanes, a
//    shorter chain); then the most lanes that keep the fewest waves.
//  * The window rings (rows x mm_other and rows x tau, 32 deep; the raw
//    rows, 4 deep) sit in shared memory with zero columns beside each row,
//    so no read needs a bounds test; where they do not fit (long targets)
//    they sit in a device-memory scratch with the same layout.  The ring
//    stride is chosen so that the lanes of a warp hit distinct banks.
//  * The 11 factor rows of the next row are copied into a shared-memory
//    double buffer (cp.async) while the current row computes.
//  * Two barriers a row: the row maximum (per-warp maxima in shared memory,
//    read by every thread), and the new ring row before the next step.  A
//    row that renormalises divides the ring rows still to be read in place,
//    as the plain version does, inside the same two barriers.
// The sweep covers the instance's n1 x n2 region only: padded rows and
// columns have zero factors, so their cells are 0 and are written as such,
// and the log scale of a padded row is what the full sweep gives it (0
// before the first valid row of the backward sweep, the last valid row's
// scale after the forward one).
#include <algorithm>

#include "dp_common.cuh"

namespace rt_duplex {

using rt::blocks_per_sm;
using rt::kSmemBlock;
using rt::waves;

constexpr int kW = 31;          // MAXLOOP + 1
constexpr int kNFac = 11;
enum Fac {
  START = 0, MM_HERE, MM_OTHER, TAU, PSTK, P11, P21A, P21B, P22, PB1A, PB1B
};
constexpr int kR = 32;          // window ring depth: distances 1..31
constexpr int kRF = 4;          // raw ring depth: distances 1..3
constexpr int kRingRows = 2 * kR + kRF;
constexpr int kPad = 40;        // zero columns beside a ring row: reads
                                // reach 37 columns past either end
constexpr int kMaxG = 8;
constexpr int kW2S = 33;        // w2 row stride: the G rows on other banks
constexpr int kW2Rows = 30 + kMaxG;   // u1 < 30 + G, zero past 29
constexpr int kBkN = 32 + kMaxG;      // m < 32 + G, zero past 30

// Shared memory of a variant, in floats: w2, bulges, warp maxima, the row's
// values, the factor double buffer, and the rings where they sit there.
__host__ __device__ inline int fac_width(int L2, int J) {
  return (L2 + J - 1) / J * J;
}
__host__ __device__ inline size_t smem_floats(int L2, int J, int W2,
                                              bool ring_s) {
  const int fw = fac_width(L2, J);
  return (size_t)kW2Rows * kW2S + kBkN + 32 + fw + 2 * kNFac * fw
      + (ring_s ? (size_t)kRingRows * W2 : 0);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

struct Args {
  const float* fac;    // [2][kNFac][B][L1][L2]
  const float* w2;     // [kW][kW] w2_raw
  const float* bk;     // [kW] bulge_raw
  const int* n1;       // [B] rows of s1
  const int* n2;       // [B] columns of s2
  float* M;            // [2][B][L1][L2]
  float* lsc;          // [2][B][L1]
  float* ring;         // [2][B][kRingRows][W2] or nullptr (shared memory)
  int B, L1, L2, W2;
};

// The factor row i (columns < n2) into dst, [kNFac][fw].
__device__ __forceinline__ void stage(float* dst, const float* F, int i,
                                      int n2, int fw, int L2, size_t plane) {
  for (int x = threadIdx.x; x < kNFac * n2; x += blockDim.x) {
    const int f = x / n2, j = x - f * n2;
    cp_async4(dst + f * fw + j, F + f * plane + (size_t)i * L2 + j);
  }
  cp_async_commit();
}

template <int G, int kJ, bool kRingS, bool kRev>
__device__ __forceinline__ void sweep(const Args& a) {
  constexpr int SG = kRev ? -1 : 1;
  constexpr int OFF = kRev ? kPad : 0;       // ring column of column 0
  constexpr int KG = (29 + G - 1) / G;       // u1 = g + 1 + k G, k < KG
  constexpr int KB = (29 + G - 1) / G;       // m = g + 2 + k G, k < KB
  extern __shared__ float sh[];
  const int b = blockIdx.x, dz = kRev ? 1 : 0;
  const int tid = threadIdx.x, NT = blockDim.x, lane = tid & 31;
  const int g = tid % G;
  const unsigned gmask = G == 1 ? 1u << lane
                                : ((1u << G) - 1u) << (lane & ~(G - 1));
  const int L1 = a.L1, L2 = a.L2, W2 = a.W2;
  const int n1 = min(max(a.n1[b], 0), L1), n2 = min(max(a.n2[b], 0), L2);
  const int fw = fac_width(L2, kJ);
  const size_t cells = (size_t)L1 * L2;
  const size_t plane = (size_t)a.B * cells;
  float* s_w2 = sh;                          // [kW2Rows][kW2S]
  float* s_bk = s_w2 + kW2Rows * kW2S;       // [kBkN]
  float* s_red = s_bk + kBkN;                // [32] warp maxima
  float* s_val = s_red + 32;                 // [fw] the row before scaling
  float* s_fac = s_val + fw;                 // [2][kNFac][fw]
  float* ring = kRingS ? s_fac + 2 * kNFac * fw
                       : a.ring + ((size_t)dz * a.B + b) * kRingRows * W2;
  float* RA = ring;                          // [kR][W2] rows x mm_other
  float* RT = ring + kR * W2;                // [kR][W2] rows x tau
  float* RF = ring + 2 * kR * W2;            // [kRF][W2] raw rows
  const float* F = a.fac + (size_t)dz * kNFac * plane + (size_t)b * cells;
  float* Mo = a.M + (size_t)dz * plane + (size_t)b * cells;
  float* lo = a.lsc + ((size_t)dz * a.B + b) * L1;

  for (int x = tid; x < kW2Rows * kW2S; x += NT) {
    const int u1 = x / kW2S, u2 = x - u1 * kW2S;
    s_w2[x] = (u1 >= 1 && u1 <= kW - 2 && u2 >= 1 && u2 <= kW - 1 - u1)
        ? a.w2[u1 * kW + u2] : 0.f;
  }
  for (int x = tid; x < kBkN; x += NT)
    s_bk[x] = (x >= 2 && x < kW) ? a.bk[x] : 0.f;
  for (size_t x = tid; x < (size_t)kRingRows * W2; x += NT) ring[x] = 0.f;
  for (size_t x = (size_t)n1 * L2 + tid; x < cells; x += NT) Mo[x] = 0.f;
  if (n1 > 0) stage(s_fac, F, kRev ? n1 - 1 : 0, n2, fw, L2, plane);
  cp_async_wait_all();
  __syncthreads();

  const int ntile = (n2 + kJ - 1) / kJ;
  float off = 0.f;
  for (int t = 0; t < n1; ++t) {
    const int i = kRev ? n1 - 1 - t : t;
    const float* sf = s_fac + (t & 1) * kNFac * fw;
    if (t + 1 < n1)              // the next row's factors, while this computes
      stage(s_fac + ((t + 1) & 1) * kNFac * fw, F, kRev ? i - 1 : i + 1, n2,
            fw, L2, plane);
    const float eoff = expf(-off);
    float lmax = 0.f;
    for (int c = tid / G; c < ntile; c += NT / G) {
      // the group's columns j0 + SG q, q < kJ
      const int j0 = kRev ? c * kJ + kJ - 1 : c * kJ;
      float gen[kJ], b1[kJ], b2[kJ];
#pragma unroll
      for (int q = 0; q < kJ; ++q) gen[q] = b1[q] = b2[q] = 0.f;
      // generic interior loops: u1 unpaired on s1 (row distance u1+1), u2
      // on s2 (column shift u2+1); w2 is zero past u2 = 30 - u1
#pragma unroll
      for (int k = 0; k < KG; ++k) {
        const int u1 = g + 1 + k * G;
        const int U = 29 - k * G;               // the most u2 any lane needs
        const float* ra = RA + ((t - u1 - 1) & (kR - 1)) * W2 + OFF + j0
            + 2 * SG;
        const float* w = s_w2 + u1 * kW2S;
        float xv[kJ + 28];
#pragma unroll
        for (int p = 0; p < kJ + 28; ++p)
          if (p < kJ + U - 1) xv[p] = ra[SG * p];
#pragma unroll
        for (int u2 = 1; u2 <= 29; ++u2) {
          if (u2 <= U) {
            const float wv = w[u2];
#pragma unroll
            for (int q = 0; q < kJ; ++q)
              gen[q] = fmaf(wv, xv[q + u2 - 1], gen[q]);
          }
        }
      }
      // bulges of size m >= 2: on s1 the row at distance m+1, column j+SG;
      // on s2 the previous row, column j + SG (m+1)
      const float* rt1 = RT + ((t - 1) & (kR - 1)) * W2 + OFF + j0;
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        const int m = g + 2 + k * G;
        const float bkm = s_bk[m];
        const float* rb = RT + ((t - m - 1) & (kR - 1)) * W2 + OFF + j0 + SG;
#pragma unroll
        for (int q = 0; q < kJ; ++q) {
          b1[q] = fmaf(bkm, rb[SG * q], b1[q]);
          b2[q] = fmaf(bkm, rt1[SG * (q + m + 1)], b2[q]);
        }
      }
      if constexpr (G > 1) {
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1) {
#pragma unroll
          for (int q = 0; q < kJ; ++q) {
            gen[q] += __shfl_xor_sync(gmask, gen[q], o);
            b1[q] += __shfl_xor_sync(gmask, b1[q], o);
            b2[q] += __shfl_xor_sync(gmask, b2[q], o);
          }
        }
      }
      const float* r1 = RF + ((t - 1) & (kRF - 1)) * W2 + OFF;
      const float* r2 = RF + ((t - 2) & (kRF - 1)) * W2 + OFF;
      const float* r3 = RF + ((t - 3) & (kRF - 1)) * W2 + OFF;
#pragma unroll
      for (int q = 0; q < kJ; ++q) {
        const int j = j0 + SG * q;
        if (q % G != g || j >= n2) continue;
        const float* f = sf + j;
        auto at = [&](const float* r, int k) { return r[j + SG * k]; };
        const float val = f[START * fw] * eoff + gen[q] * f[MM_HERE * fw]
            + f[TAU * fw] * (b1[q] + b2[q])
            + f[PSTK * fw] * at(r1, 1) + f[P11 * fw] * at(r2, 2)
            + f[P21A * fw] * at(r2, 3) + f[P21B * fw] * at(r3, 2)
            + f[P22 * fw] * at(r3, 3) + f[PB1A * fw] * at(r2, 1)
            + f[PB1B * fw] * at(r1, 2);
        s_val[j] = val;
        lmax = fmaxf(lmax, val);
      }
    }
    // the row maximum with one barrier: per-warp maxima, read by every thread
    for (int o = 16; o > 0; o >>= 1)
      lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
    if (lane == 0) s_red[tid >> 5] = lmax;
    __syncthreads();
    float m0 = lane < (NT >> 5) ? s_red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    // adaptive renormalisation, the policy of the plain sweep
    m0 = fmaxf(m0, 1e-30f);
    const float scale = m0 > 1e4f ? m0 : 1.f;
    const int cur = t & (kR - 1), cur4 = t & (kRF - 1);
    if (scale != 1.f) {          // the same on every thread
      // the ring rows still to be read: all but the slots this row takes
      for (int x = tid; x < kRingRows * n2; x += NT) {
        const int row = x / n2, j = x - row * n2;
        if (row == cur || row == kR + cur || row == 2 * kR + cur4) continue;
        float* r = ring + (size_t)row * W2 + OFF + j;
        *r = *r / scale;
      }
    }
    for (int j = tid; j < n2; j += NT) {
      const float vn = s_val[j] / scale;
      Mo[(size_t)i * L2 + j] = vn;
      RF[cur4 * W2 + OFF + j] = vn;
      RA[cur * W2 + OFF + j] = vn * sf[MM_OTHER * fw + j];
      RT[cur * W2 + OFF + j] = vn * sf[TAU * fw + j];
    }
    for (int j = n2 + tid; j < L2; j += NT) Mo[(size_t)i * L2 + j] = 0.f;
    off = off + logf(scale);
    if (tid == 0) lo[i] = off;
    cp_async_wait_all();
    __syncthreads();             // the new row before the next step
  }
  // log scales of the padded rows: those the full sweep would carry there
  for (int i = n1 + tid; i < L1; i += NT) lo[i] = kRev ? 0.f : off;
}

template <int G, int J, bool kRingS>
__global__ void __launch_bounds__(1024) duplex_sweep_kernel(Args a) {
  if (blockIdx.y == 0) sweep<G, J, kRingS, false>(a);
  else sweep<G, J, kRingS, true>(a);
}

// A launch: its kernel, threads, shared memory, lanes a column group,
// columns a group, ring placement and ring row stride.
struct Variant {
  void (*fn)(Args);
  int threads;
  size_t smem;
  int G, J;
  bool ring_s;
  int W2;
};

// The ring row stride: room for the zero columns, and the residue mod 32
// that spreads a warp's window reads ((c, g) -> (slot - g) W2 + c J) over
// the most banks.
int ring_stride(int L2, int G, int J) {
  const int base = L2 + kPad;
  int best = base, worst = 33;
  for (int s = 0; s < 32 && G > 1; ++s) {
    int cnt[32] = {0}, most = 0;
    for (int l = 0; l < 32; ++l) {
      const long a = -(long)(l % G) * (base + s) + (long)(l / G) * J;
      const int k = (int)(((a % 32) + 32) % 32);
      most = std::max(most, ++cnt[k]);
    }
    if (most < worst) { worst = most; best = base + s; }
  }
  return best;
}

template <int G, int J, bool kRingS>
Variant variant(int L2) {
  const int W2 = ring_stride(L2, G, J);
  const int groups = (L2 + J - 1) / J;
  const int threads = std::min(1024, (G * groups + 31) / 32 * 32);
  return {duplex_sweep_kernel<G, J, kRingS>, threads,
          smem_floats(L2, J, W2, kRingS) * sizeof(float), G, J, kRingS, W2};
}

// The variants built: every G with J = 2 or 4 and the rings in shared
// memory; G = 1 or 2 with J = 2 and the rings in device memory (they leave
// shared memory past L2 ~ 600, where a block of 1024 holds at most two
// lanes a group of two columns).
template <int G>
Variant variant_g(int L2, int J, bool ring_s) {
  if constexpr (G <= 2) {
    if (!ring_s) return variant<G, 2, false>(L2);
  }
  return J == 4 ? variant<G, 4, true>(L2) : variant<G, 2, true>(L2);
}

Variant variant_of(int L2, int G, int J, bool ring_s) {
  switch (G) {
    case 2: return variant_g<2>(L2, J, ring_s);
    case 4: return variant_g<4>(L2, J, ring_s);
    case 8: return variant_g<8>(L2, J, ring_s);
    default: return variant_g<1>(L2, J, ring_s);
  }
}

// The variant for B instances at L2: the rings in shared memory where they
// fit, else in device memory; J = 4 where the 2 B blocks fill every SM and
// the rings are in shared memory, else J = 2; the most lanes a group (each
// group within one block of 1024) that keep the blocks in the fewest
// waves.  force, if not 0, names the variant: G | 16 for the rings in
// device memory | 32 for J = 4.
Variant pick(int L2, int B, int force) {
  if (force)
    return variant_of(L2, force & 15, force & 32 ? 4 : 2, !(force & 16));
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const bool ring_s = variant_of(L2, 1, 2, true).smem <= (size_t)kSmemBlock;
  const int J = ring_s && 2 * B >= sms ? 4 : 2;
  const int groups = (L2 + J - 1) / J;
  Variant v = variant_of(L2, 1, J, ring_s);
  for (int G = 2; G <= (ring_s ? kMaxG : 2); G *= 2) {
    if (G * groups > 1024) break;
    const Variant w = variant_of(L2, G, J, ring_s);
    if (w.smem > (size_t)kSmemBlock) break;
    if (waves(w, 2 * B) <= waves(v, 2 * B)) v = w;
  }
  return v;
}

}  // namespace rt_duplex

// Floats of the device-memory ring scratch the variant for (L2, B, force)
// needs: 0 where its rings sit in shared memory.
extern "C" long long rt_duplex_scratch(int L2, int B, int force) {
  using namespace rt_duplex;
  const Variant v = pick(L2, B, force);
  return v.ring_s ? 0 : 2LL * B * kRingRows * v.W2;
}

// Lanes a column group of that variant.
extern "C" int rt_duplex_lanes(int L2, int B, int force) {
  return rt_duplex::pick(L2, B, force).G;
}

// Columns a group of that variant.
extern "C" int rt_duplex_columns(int L2, int B, int force) {
  return rt_duplex::pick(L2, B, force).J;
}

// Blocks an SM of that variant (0 if the runtime cannot say).
extern "C" int rt_duplex_occupancy(int L2, int B, int force) {
  return rt_duplex::blocks_per_sm(rt_duplex::pick(L2, B, force));
}

extern "C" int rt_duplex_sweep(const float* fac, const float* w2,
                               const float* bk, const int* n1, const int* n2,
                               float* M, float* lsc, float* ring, int B,
                               int L1, int L2, int force, void* stream) {
  using namespace rt_duplex;
  const Variant v = pick(L2, B, force);
  if (v.ring_s != (ring == nullptr)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      v.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)v.smem);
  if (e != cudaSuccess) return (int)e;
  const Args a{fac, w2, bk, n1, n2, M, lsc, ring, B, L1, L2, v.W2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  v.fn<<<dim3(B, 2), v.threads, v.smem, st>>>(a);
  return (int)cudaGetLastError();
}
