// Exterior suffix partition function q2 (K3).
//
// Replaces ractip_tpu/ops/scan_pallas.py::q2_pallas (_q2_kernel):
//   q2[i] = clamp(sigma q2[i+1] + sum_k qbe[i, k] q2[k+1]),  q2[i] = 1 for
//   i >= n, for i = L-1 down to 0, q2[L] = 1 (ops/scan.py::q2_plain).
// At step i the cells q2[1..i] still hold their initial 1, and q2[k+1] = 1
// for k >= n - 1, so
//   s_i = sum_{k < i} qbe[i, k] + sum_{k >= n-1} qbe[i, k]
//       + sum_{i <= k < n-1} qbe[i, k] q2[k+1].
// Nothing here assumes the padding or the lower triangle of qbe is zero.
//
// What bounds it on the card: the bytes are qbe's rows i < n (read once)
// and q2 (written once); the recursion is a chain of n dependent steps, so
// one step's latency times n is the floor of one instance.
//
// Design: one block per instance.  The rows i < n are taken from the top
// (row n-1) down in passes of whole 32-row tiles; every warp copies a
// pass's rows into shared memory (cp.async, all in flight at once), and
// where two passes fit, warps 1-3 copy the next pass while warp 0 computes.
// Warp 0 takes a tile one row a lane: each lane sums its row against what
// is known (1 below the diagonal, the q2 of the tiles above from column hi
// on, hi the tile's top row), then the tile's recursion runs in push form:
// the owner lane of row i finishes q2[i] with a multiply-add and the
// clamp, one shuffle broadcasts it, and every lane adds qbe[r, i-1] q2[i]
// to its row r.  A step's chain is the shuffle, two multiply-adds and the
// clamp.  Past about L = 1770 not even one tile fits shared memory: the
// four warps then sum the tile's rows from device memory, a row a warp at
// a time with coalesced loads, before warp 0's recursion.
#include <algorithm>

#include "dp_common.cuh"

namespace rt {

constexpr int kQ2Threads = 128;
constexpr int kTile = 32;                 // rows a tile, one a lane
constexpr size_t kQ2Budget = 56 * 1024;   // shared bytes of the staged rows,
                                          // to keep four blocks an SM

__device__ __forceinline__ void q2_cp_async4(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void q2_cp_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Rows a pass (whole tiles), buffers (2: the next pass is copied while the
// current one computes), and whether the rows sit in shared memory.
struct Q2Plan {
  int rows, nbuf;
  bool staged;
};

__host__ __device__ inline int q2_stride(int L) { return L | 1; }
__host__ __device__ inline int q2_head(int L) { return (L + 4) & ~3; }

inline Q2Plan q2_plan(int L) {
  const size_t row = sizeof(float) * q2_stride(L);
  const size_t room = kSmemBlock - sizeof(float) * q2_head(L);
  const int all = (L + kTile - 1) / kTile * kTile;
  if (all * row <= kQ2Budget) return {all, 1, true};
  if (2 * kTile * row <= room)
    return {kTile * std::max<int>(1, (int)(kQ2Budget / (2 * kTile * row))),
            2, true};
  if (kTile * row <= room) return {kTile, 1, true};
  return {kTile, 1, false};
}

inline size_t q2_smem(int L, const Q2Plan& p) {
  return sizeof(float) * (q2_head(L) + (p.staged ? (size_t)p.nbuf * p.rows
                                                       * q2_stride(L)
                                                 : kTile));
}

template <bool kStaged>
__global__ void __launch_bounds__(kQ2Threads) q2_kernel(
    const float* __restrict__ qbe_g, const float* __restrict__ sig_g,
    const int* __restrict__ n_g, float* __restrict__ q2_o, int L, int rows,
    int nbuf) {
  extern __shared__ float sh[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x;
  const int Ls = kStaged ? q2_stride(L) : L;
  float* q2s = sh;                               // [L + 1]
  float* buf = sh + q2_head(L);                  // [nbuf][rows][Ls], or
                                                 // the tile's row sums
  const float sg = sig_g[b];
  const int n = min(max(n_g[b], 0), L);
  const float* Q = qbe_g + (size_t)b * L * L;
  for (int t = tid; t <= L; t += kQ2Threads) q2s[t] = 1.f;
  // passes from the top: pass p holds the rows [plo(p), phi(p)]
  const int tiles = (n + kTile - 1) / kTile, per = rows / kTile;
  const int npass = (tiles + per - 1) / per;
  auto plo = [&](int p) { return max(0, tiles - (p + 1) * per) * kTile; };
  auto phi = [&](int p) { return min((tiles - p * per) * kTile, n) - 1; };
  auto slot = [&](int p) { return buf + (size_t)(p % nbuf) * rows * Ls; };
  // copy pass p's rows, warps w0.. taking rows in turn, lanes the columns
  auto load = [&](int p, int w0) {
    float* dst = slot(p);
    const int lo = plo(p), hi = phi(p);
    for (int r = lo + warp - w0; r <= hi; r += kQ2Threads / 32 - w0)
      for (int k = lane; k < L; k += 32)
        q2_cp_async4(dst + (size_t)(r - lo) * Ls + k, Q + (size_t)r * L + k);
    q2_cp_async_wait_all();
  };
  if (kStaged && npass > 0) load(0, 0);
  __syncthreads();
  for (int p = 0; p < npass; ++p) {
    if constexpr (!kStaged) {          // one tile a pass: its row sums
      const int lo = plo(p), hi = phi(p);
      for (int rr = warp; rr < kTile; rr += kQ2Threads / 32) {
        const int r = lo + rr;
        float a = 0.f;
        if (r <= hi) {
          const float* row = Q + (size_t)r * L;
#pragma unroll 8
          for (int k = lane; k < L; k += 32) {
            const float v = row[k];
            a += k < r ? v : (k >= hi ? v * q2s[k + 1] : 0.f);
          }
        }
        for (int o = 16; o > 0; o >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, o);
        if (lane == 0) buf[rr] = a;
      }
      __syncthreads();
    }
    if (warp == 0) {
      const int base = plo(p);
      const float* S = kStaged ? slot(p) : Q + (size_t)base * L;
      for (int lo = (phi(p) / kTile) * kTile; lo >= base; lo -= kTile) {
        const int hi = min(lo + kTile - 1, n - 1);   // the tile's top row
        const int r = lo + lane;                     // this lane's row
        const bool live = r <= hi;
        const float* row = S + (size_t)(r - base) * Ls;
        float x[kTile];                  // the row on the tile's columns
#pragma unroll
        for (int c = 0; c < kTile; ++c)
          x[c] = live && lo + c < L ? row[lo + c] : 0.f;
        // the row against what is known (from device memory: the four
        // warps' sums above), in eight partial sums without a branch in
        // the loops: the columns left of the tile (weight 1, all below the
        // diagonal), those right of it (weight q2[k+1]), then the tile's
        // own (1 below the diagonal, q2[k+1] from hi on, the rest pushed
        // during the recursion)
        float a8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (kStaged && live) {
          for (int k0 = 0; k0 < lo; k0 += 8) {
#pragma unroll
            for (int j = 0; j < 8; ++j) a8[j] += row[k0 + j];
          }
          const int k1 = lo + kTile;
          const int k8 = k1 < L ? k1 + (L - k1) / 8 * 8 : k1;
          for (int k0 = k1; k0 < k8; k0 += 8) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              a8[j] += row[k0 + j] * q2s[k0 + j + 1];
          }
          for (int k = k8; k < L; ++k) a8[0] += row[k] * q2s[k + 1];
        }
        float acc = ((a8[0] + a8[1]) + (a8[2] + a8[3]))
            + ((a8[4] + a8[5]) + (a8[6] + a8[7]));
#pragma unroll
        for (int c = 0; kStaged && c < kTile; ++c) {
          const int k = lo + c;
          if (k < L) acc += k < r ? x[c] : (k >= hi ? x[c] * q2s[k + 1] : 0.f);
        }
        if (!kStaged) acc = buf[lane];
        // the recursion over the tile's rows, top down, in push form
        float qprev = q2s[hi + 1];
#pragma unroll
        for (int s = kTile - 1; s >= 0; --s) {
          if (lo + s <= hi) {            // the same on every lane
            const float v = clamp_huge(__fadd_rn(__fmul_rn(sg, qprev), acc));
            const float q = __shfl_sync(0xffffffffu, v, s);
            if (lane == 0) q2s[lo + s] = q;
            // rows r <= lo + s - 1 take qbe[r, lo + s - 1] q2[lo + s]; the
            // rows at and above lo + s are finished, their acc unused
            if (s > 0) acc = fmaf(x[s - 1], q, acc);
            qprev = q;
          }
        }
        __syncwarp();
      }
    } else if (kStaged && nbuf == 2 && p + 1 < npass) {
      load(p + 1, 1);
    }
    __syncthreads();
    if (kStaged && nbuf == 1 && p + 1 < npass) {
      load(p + 1, 0);
      __syncthreads();
    }
  }
  for (int t = tid; t <= L; t += kQ2Threads)
    q2_o[(size_t)b * (L + 1) + t] = q2s[t];
}

}  // namespace rt

extern "C" int rt_q2(const float* qbe, const float* sig, const int* n,
                     float* q2, int B, int L, void* stream) {
  using namespace rt;
  const Q2Plan p = q2_plan(L);
  const size_t shmem = q2_smem(L, p);
  void (*fn)(const float*, const float*, const int*, float*, int, int, int) =
      p.staged ? q2_kernel<true> : q2_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fn<<<B, kQ2Threads, shmem, st>>>(qbe, sig, n, q2, L, p.rows, p.nbuf);
  return (int)cudaGetLastError();
}
