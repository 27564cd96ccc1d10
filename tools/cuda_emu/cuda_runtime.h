// CPU emulation of the CUDA features the DP kernels use: one std::thread
// per CUDA thread, blocks one after another (grids and blocks of up to two
// dimensions), barriers for __syncthreads, for __syncwarp and for the lanes
// a shuffle names.  Shared memory is a heap buffer filled with NaN
// (uninitialised reads show), so ASan sees its bounds.  cp.async is a plain
// copy (the kernels' own fallback without __CUDA_ARCH__).
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <limits>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __shared__
#define __launch_bounds__(x)
#define __restrict__
struct dim3_ { unsigned x = 0, y = 0, z = 0; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
inline thread_local dim3_ threadIdx;
inline dim3_ blockIdx, blockDim, gridDim;
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T> int cudaFuncSetAttribute(T, cudaFuncAttribute, int) { return 0; }
inline int cudaGetLastError() { return 0; }
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
typedef int cudaError_t;
template <class T> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, T, int, size_t) { *n = 1; return 0; }
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 1; return 0; }
using std::min; using std::max;
inline float __logf(float x) { return logf(x); }
inline float __expf(float x) { return expf(x); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
namespace emu {
using Bar = std::barrier<>;
inline std::unique_ptr<Bar> block_bar;
inline std::map<std::pair<int, unsigned>, std::unique_ptr<Bar>> warp_bars;
inline std::vector<float> slots;           // [warp][32]
inline float* g_sh = nullptr;
inline std::atomic<int> or_acc{0};
inline Bar& wbar(unsigned mask) {
  const int w = threadIdx.x / 32;
  auto it = warp_bars.find({w, mask});
  if (it == warp_bars.end()) { fprintf(stderr, "no barrier for mask %x\n", mask); abort(); }
  return *it->second;
}
inline float shfl(unsigned mask, float v, int src) {
  const int lane = threadIdx.x & 31, w = threadIdx.x / 32;
  if (!(mask >> lane & 1u)) { fprintf(stderr, "lane %d not in mask %x\n", lane, mask); abort(); }
  Bar& b = wbar(mask);
  slots[w * 32 + lane] = v;
  b.arrive_and_wait();
  float r = v;
  if (src >= 0 && src < 32) {
    if (!(mask >> src & 1u)) { fprintf(stderr, "src %d not in mask %x\n", src, mask); abort(); }
    r = slots[w * 32 + src];
  }
  b.arrive_and_wait();
  return r;
}
template <class F>
void launch(dim3 grid, dim3 blk, size_t smem, cudaStream_t, F fn) {
  const int block = blk.x;
  gridDim.x = grid.x; gridDim.y = grid.y; blockDim.x = block;
  const int nw = (block + 31) / 32;
  for (unsigned by = 0; by < grid.y; ++by)
  for (unsigned b = 0; b < grid.x; ++b) {
    blockIdx.x = b; blockIdx.y = by;
    std::vector<float> sh(smem / sizeof(float), std::numeric_limits<float>::quiet_NaN());
    g_sh = sh.data();
    block_bar = std::make_unique<Bar>(block);
    warp_bars.clear();
    slots.assign(nw * 32, 0.f);
    for (int w = 0; w < nw; ++w) {
      warp_bars[{w, 0xffffffffu}] = std::make_unique<Bar>(32);
      for (int t : {2, 4, 8, 16})
        for (int g = 0; g < 32; g += t)
          warp_bars[{w, ((1u << t) - 1u) << g}] = std::make_unique<Bar>(t);
    }
    std::vector<std::thread> th;
    for (int t = 0; t < block; ++t)
      th.emplace_back([t, &fn] { threadIdx.x = t; fn(); });
    for (auto& x : th) x.join();
    g_sh = nullptr;
  }
}
}  // namespace emu
inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline int __syncthreads_or(int p) {
  if (p) emu::or_acc.fetch_or(1);
  __syncthreads();
  const int r = emu::or_acc.load();
  __syncthreads();
  if (threadIdx.x == 0) emu::or_acc = 0;
  __syncthreads();
  return r;
}
inline void __syncwarp(unsigned m = 0xffffffffu) { emu::wbar(m).arrive_and_wait(); }
inline float __shfl_sync(unsigned m, float v, int s) { return emu::shfl(m, v, s); }
inline float __shfl_xor_sync(unsigned m, float v, int o) { return emu::shfl(m, v, (int)(threadIdx.x & 31) ^ o); }
inline float __shfl_down_sync(unsigned m, float v, int d) {
  const int s = (threadIdx.x & 31) + d; return emu::shfl(m, v, s < 32 ? s : -1); }
inline float __shfl_up_sync(unsigned m, float v, int d) {
  const int s = (int)(threadIdx.x & 31) - d; return emu::shfl(m, v, s); }
