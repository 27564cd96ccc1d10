// McCaskill inside column scan, fold (K1) and cut-aware cofold (K4).
//
// Replaces ractip_tpu/ops/scan_pallas.py::inside_pallas_streamed
// (_inside_kernel_streamed) and ractip_tpu/ops/cofold_pallas.py::
// co_inside_pallas_streamed (_co_inside_kernel_streamed): one template,
// kCofold selecting the cut masks, the exterior-segment table qx and the
// spanning-pair term, as the JAX kernels share their helpers.
//
// What bounds it on the card: the scan is sequential in the column j and
// parallel only over the rows i and the batch, so it is bound by latency
// (one barrier-separated column step after another), not by bytes or FLOPs.
// Per cell it does ~435 window multiply-adds (the generic interior loop)
// plus two O(L) contractions against the resident qm (and qx) table.
//
// Design: one block per instance, one thread per row i (L <= 1024), and a
// loop over the columns inside the block in place of the TPU's sequential
// grid axis.  __syncthreads() separates the phases of a column: the qm2
// contraction, qb, qm1, the doubling suffix scan, the qm contraction and
// the q1 block reduction.  The resident tables (qm, qx) do not fit in
// shared memory at the cofold lengths (2 x 147 KB at L = 192), so they stay
// in device memory, read back through L1/L2; the W = 31 rolling qb windows
// of the TPU kernel become reads of the qb columns this block already
// wrote.  Only the short per-column vectors live in shared memory.
#include "dp_common.cuh"

namespace rt {

template <bool kCofold>
__global__ void __launch_bounds__(1024) inside_kernel(
    const float* __restrict__ F, const float* __restrict__ w2k_g,
    const float* __restrict__ bulge_g, const float* __restrict__ sig_g,
    const float* __restrict__ pows_g, const int* __restrict__ cut_g,
    float* qm1_o, float* qb_o, float* qm_o, float* aux_o, float* q1_o,
    int B, int L) {
  extern __shared__ float sh[];
  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const int Lp = L + 1;
  float* s_w2 = sh;                       // [W*W]
  float* s_bk = s_w2 + kW * kW;           // [W]
  float* s_pw = s_bk + kW;                // [POW2]
  float* s_red = s_pw + kPow2 + 1;        // [32]
  float* s_qm1P = s_red + 32;             // previous qm1 column
  float* s_v = s_qm1P + Lp;               // contraction vector
  float* s_qm2 = s_v + Lp;                // qm2 column (read at i+1)
  float* s_q1 = s_qm2 + Lp;               // q1 prefix
  float* s_scan = s_q1 + Lp;              // scan buffer
  float* s_scan2 = s_scan + Lp;           // second scan buffer (cofold)
  float* s_qxP = s_scan2 + Lp;            // previous qx column (cofold)
  float* s_qxA = s_qxP + Lp;              // qx[:, cut-1] capture (cofold)
  float* s_qbe = s_qxA + Lp;              // qb*fe column (cofold)

  for (int t = i; t < kW * kW; t += blockDim.x) s_w2[t] = w2k_g[b * kW * kW + t];
  for (int t = i; t < kW; t += blockDim.x) s_bk[t] = bulge_g[b * kW + t];
  for (int t = i; t < kPow2; t += blockDim.x) s_pw[t] = pows_g[b * kPow2 + t];
  for (int t = i; t < 9 * Lp; t += blockDim.x) s_qm1P[t] = 0.f;
  const size_t LL = (size_t)L * L;
  const size_t fstride = (size_t)B * LL;
  const float* Fb = F + (size_t)b * LL;
  auto fat = [&](int f, int r, int col) -> float {
    return Fb[f * fstride + (size_t)col * L + r];
  };
  float* qb = qb_o + (size_t)b * LL;
  float* qm = qm_o + (size_t)b * LL;
  float* qm1 = qm1_o + (size_t)b * LL;
  float* aux = aux_o + (size_t)b * LL;    // qm2 (fold) or qx (cofold)
  const float sg = sig_g[b];
  const int ct = kCofold ? cut_g[b] : 0;
  const bool row = i < L;
  // qm2's last column is never produced by the scan (the caller fills it)
  if (!kCofold && row) aux[(size_t)(L - 1) * L + i] = 0.f;
  __syncthreads();
  const float sm = s_pw[0];

  for (int j = 0; j < L; ++j) {
    // ---- cofold: capture qxA = qx[:, cut-1] when the scan reaches the cut
    float qxB = 1.f;
    if (kCofold) {
      if (j == ct && row)
        s_qxA[i] = i < ct ? s_qxP[i] : (i == ct ? 1.f : 0.f);
      if (j > ct) qxB = s_qxP[ct];
    }
    // ---- multiloop closing: qm2col[i] = sum_l qm(i, l) qm1(l+1, j-1)
    if (row) {
      float v = 0.f;
      if (i + 1 < L) v = s_qm1P[i + 1] * ((kCofold && i + 1 == ct) ? 0.f : 1.f);
      s_v[i] = v;
    }
    __syncthreads();
    float qm2col = 0.f;
    if (row) {
      float acc = 0.f;
      for (int l = 0; l < j; ++l) acc += qm[(size_t)l * L + i] * s_v[l];
      qm2col = clamp_huge(acc);
      s_qm2[i] = qm2col;
      if (!kCofold && j >= 1) aux[(size_t)(j - 1) * L + i] = qm2col;
    }
    __syncthreads();
    // ---- qb column
    float qbcol = 0.f;
    if (row) {
      // source-column mask of the interior window (cofold): an inner pair
      // column k contributes only from the strand side of j
      auto bm = [&](int k) -> float {
        return (!kCofold || k >= ct || j < ct) ? 1.f : 0.f;
      };
      // generic interior loops: sum_{u1,u2} w2k[u1,u2] X(i+u1+1, j-1-u2)
      float gen = 0.f;
      for (int u1 = 1; u1 < kMaxLoop; ++u1) {
        const int r = i + u1 + 1;
        if (r >= L) break;
        float acc = 0.f;
        for (int u2 = 1; u2 <= kMaxLoop - u1; ++u2) {
          const int k = j - 1 - u2;
          if (k < 0) break;
          acc += s_w2[u1 * kW + u2] * qb[(size_t)k * L + r] * fat(MINN, r, k)
                 * bm(k);
        }
        gen += (kCofold ? m5(u1 + 1, i, ct) : 1.f) * acc;
      }
      gen *= fat(MOUT, i, j);
      // bulges of size >= 2
      float b5 = 0.f, b3 = 0.f;
      if (j >= 1) {
        const float bmj = bm(j - 1);
        for (int m = 2; m <= kMaxLoop; ++m) {
          const int r = i + m + 1;
          if (r >= L) break;
          b5 += s_bk[m] * (kCofold ? m5(m + 1, i, ct) : 1.f)
                * (qb[(size_t)(j - 1) * L + r] * fat(TAUR, r, j - 1) * bmj);
        }
      }
      if (i + 1 < L) {
        for (int m = 2; m <= kMaxLoop; ++m) {
          const int k = j - 1 - m;
          if (k < 0) break;
          b3 += qb[(size_t)k * L + i + 1] * fat(TAUR, i + 1, k) * bm(k) * s_bk[m];
        }
      }
      const float bulges =
          fat(TAU, i, j) * (b5 + (kCofold ? m5(1, i, ct) : 1.f) * b3);
      // stacks, 1x1 / 1x2 / 2x1 / 2x2 interiors, 1-bulges
      auto q = [&](int di, int dj) -> float {
        const int r = i + di, k = j - dj;
        return (r < L && k >= 0) ? qb[(size_t)k * L + r] : 0.f;
      };
      float v = fat(FHN, i, j) + gen + bulges
              + fat(PSTK, i, j) * q(1, 1) + fat(P11, i, j) * q(2, 2)
              + fat(P21A, i, j) * q(2, 3) + fat(P21B, i, j) * q(3, 2)
              + fat(P22, i, j) * q(3, 3) + fat(PB15, i, j) * q(2, 1)
              + fat(PB13, i, j) * q(1, 2);
      const float qm2n = i + 1 < L ? s_qm2[i + 1] : 0.f;
      if (kCofold) {
        const float mlgate = j != ct ? 1.f : 0.f;
        v += mlgate * fat(FMC, i, j) * sg * sg * (m5(1, i, ct) * qm2n);
        const float qxAn = i + 1 < L ? s_qxA[i + 1] : 0.f;
        v += fat(FCX, i, j) * qxAn * qxB;
      } else {
        v += fat(FMC, i, j) * sg * sg * qm2n;
      }
      qbcol = clamp_huge(v);
      qb[(size_t)j * L + i] = qbcol;
    }
    // ---- qm1 column
    float qm1col = 0.f;
    if (row) {
      const float mlgate = (kCofold && j == ct) ? 0.f : 1.f;
      qm1col = clamp_huge(mlgate * sm * s_qm1P[i] + qbcol * fat(FMB, i, j));
      qm1[(size_t)j * L + i] = qm1col;
    }
    __syncthreads();                       // all reads of s_qm1P are done
    if (row) s_qm1P[i] = qm1col;
    // ---- qm column: ml_base suffix scan + sum_l qm(i, l) qm1(l+1, j)
    float dterm = doubling_scan<true>(qm1col, i, L, s_pw, s_scan);
    if (kCofold) {
      const float lo = doubling_scan<true>(i < ct ? qm1col : 0.f, i, L, s_pw,
                                           s_scan2);
      if (i < ct) dterm = lo;
    }
    if (row) {
      float v = 0.f;
      if (i + 1 < L) v = s_qm1P[i + 1] * ((kCofold && i + 1 == ct) ? 0.f : 1.f);
      s_v[i] = v;
    }
    __syncthreads();
    if (row) {
      float acc = 0.f;
      for (int l = 0; l < j; ++l) acc += qm[(size_t)l * L + i] * s_v[l];
      qm[(size_t)j * L + i] = clamp_huge(dterm + acc);
    }
    // ---- exterior prefix q1[j]
    const float q1prev = j >= 1 ? s_q1[j - 1] : 1.f;
    float term = 0.f, qbecol = 0.f;
    if (row) {
      const float q1pad = i == 0 ? 1.f : s_q1[i - 1];
      qbecol = qbcol * fat(FE, i, j);
      term = kCofold ? q1pad * qbecol : q1pad * qbcol * fat(FE, i, j);
      if (kCofold) s_qbe[i] = qbecol;
    }
    const float s = block_sum(term, s_red);
    if (i == 0) {
      const float q1v = clamp_huge(sg * q1prev + s);
      s_q1[j] = q1v;
      q1_o[(size_t)b * L + j] = q1v;
    }
    // ---- cofold: exterior-segment column qx[:, j]
    if (kCofold && row) {
      float acc = 0.f;
      for (int l = 0; l < j; ++l) acc += aux[(size_t)l * L + i] * s_qbe[l + 1];
      const float onej = i == j ? 1.f : 0.f;
      const float qxcol = clamp_huge(sg * (s_qxP[i] + onej) + acc + qbecol);
      aux[(size_t)j * L + i] = qxcol;
      s_qxP[i] = qxcol;
    }
    __syncthreads();
  }
}

}  // namespace rt

extern "C" int rt_inside(const float* F, const float* w2k, const float* bulge_k,
                         const float* sig, const float* pows, const int* cut,
                         float* qm1, float* qb, float* qm, float* aux, float* q1,
                         int B, int L, int cofold, void* stream) {
  using namespace rt;
  const int threads = ((L + 31) / 32) * 32;
  const size_t shmem =
      sizeof(float) * (kW * kW + kW + kPow2 + 1 + 32 + 9 * (size_t)(L + 1));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cofold) {
    cudaFuncSetAttribute(inside_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    inside_kernel<true><<<B, threads, shmem, st>>>(
        F, w2k, bulge_k, sig, pows, cut, qm1, qb, qm, aux, q1, B, L);
  } else {
    cudaFuncSetAttribute(inside_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    inside_kernel<false><<<B, threads, shmem, st>>>(
        F, w2k, bulge_k, sig, pows, cut, qm1, qb, qm, aux, q1, B, L);
  }
  return (int)cudaGetLastError();
}
