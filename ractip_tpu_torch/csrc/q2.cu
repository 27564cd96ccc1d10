// Exterior suffix partition function q2 (K3).
//
// Replaces ractip_tpu/ops/scan_pallas.py::q2_pallas (_q2_kernel):
//   q2[i] = sigma q2[i+1] + sum_k qbe[i, k] q2[k+1],  q2[i] = 1 for i >= n,
// for i = L-1 down to 0, q2[L] = 1.
//
// What bounds it on the card: a sequential recursion of L steps, each a dot
// product of one qbe row (L floats) with the q2 suffix; L^2 multiply-adds
// per instance, so it is latency bound, not byte or FLOP bound.
//
// Design: one warp per instance.  Each step the 32 lanes read the row
// coalesced (qbe in the natural [b][i][k] layout), reduce with shuffles and
// lane 0 writes q2[i] into shared memory; __syncwarp() orders the steps, so
// no block barrier is needed.
#include "dp_common.cuh"

namespace rt {

__global__ void __launch_bounds__(32) q2_kernel(
    const float* __restrict__ qbe_g, const float* __restrict__ sig_g,
    const int* __restrict__ n_g, float* q2_o, int L) {
  extern __shared__ float s_q2[];          // [L + 1]
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const float sg = sig_g[b];
  const int n = n_g[b];
  const float* qbe = qbe_g + (size_t)b * L * L;
  for (int t = lane; t <= L; t += 32) s_q2[t] = 1.f;
  __syncwarp();
  for (int i = L - 1; i >= 0; --i) {
    float s = 0.f;
    for (int k = lane; k < L; k += 32) s += qbe[(size_t)i * L + k] * s_q2[k + 1];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) s_q2[i] = i >= n ? 1.f : clamp_huge(sg * s_q2[i + 1] + s);
    __syncwarp();
  }
  for (int t = lane; t <= L; t += 32) q2_o[(size_t)b * (L + 1) + t] = s_q2[t];
}

}  // namespace rt

extern "C" int rt_q2(const float* qbe, const float* sig, const int* n,
                     float* q2, int B, int L, void* stream) {
  using namespace rt;
  const size_t shmem = sizeof(float) * (size_t)(L + 1);
  q2_kernel<<<B, 32, shmem, static_cast<cudaStream_t>(stream)>>>(
      qbe, sig, n, q2, L);
  return (int)cudaGetLastError();
}
