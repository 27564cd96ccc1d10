// McCaskill outside column scan, fold (K2) and cut-aware cofold (K5).
//
// Replaces ractip_tpu/ops/scan_pallas.py::outside_pallas_streamed
// (_outside_kernel_streamed) and ractip_tpu/ops/cofold_pallas.py::
// co_outside_pallas_streamed (_co_outside_kernel_streamed): one template,
// kCofold adding the cut masks and the exposed-cut spanning-pair adjoints
// (vvec, wvec and the GA build at c + 1 == cut).
//
// What bounds it on the card: like the inside scan it is sequential in the
// column (here from c = L-1 down to 0) and parallel over rows and the batch,
// so barrier latency bounds it.  Per column it adds two O(L) contractions
// against qm (qm^T om and qm^T ash), the window adjoints (~435 terms per
// cell) and a rank-1 update of the resident om table (O(L) per row).
//
// Design: one block per instance, one thread per row i.  The rank-1 scatter
// om[i, m] += ash[i] w1[m] + omcol[i] w2[m] has no race because each thread
// owns its row i; om (L x L per instance) lives in a device-memory scratch
// the wrapper allocates, zeroed here.  The W-deep rolling ob buffers of the
// TPU kernel become reads of the ob columns this block already wrote.
#include "dp_common.cuh"

namespace rt {

template <bool kCofold>
__global__ void __launch_bounds__(1024) outside_kernel(
    const float* __restrict__ F, const float* __restrict__ qmN_g,
    const float* __restrict__ qm1_g, const float* __restrict__ q1pad_g,
    const float* __restrict__ q2_g, const float* __restrict__ w2k_g,
    const float* __restrict__ bulge_g, const float* __restrict__ sig_g,
    const float* __restrict__ pows_g, const int* __restrict__ cut_g,
    const float* __restrict__ qxN_g, const float* __restrict__ qxA_g,
    const float* __restrict__ qBpref_g, float* om_s, float* ob_o, int B,
    int L) {
  extern __shared__ float sh[];
  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const int Lp = L + 1;
  float* s_w2 = sh;
  float* s_bk = s_w2 + kW * kW;
  float* s_pw = s_bk + kW;
  float* s_red = s_pw + kPow2 + 1;
  float* s_om = s_red + 32;               // om column c
  float* s_qmt = s_om + Lp;               // contraction results (read at i-1)
  float* s_a = s_qmt + Lp;                // a = ob fmc sigma^2 (read at l-1)
  float* s_w1 = s_a + Lp;                 // qm1 column c-1, shifted up
  float* s_w2v = s_w1 + Lp;               // qm1 column c, shifted up
  float* s_scan = s_w2v + Lp;
  float* s_scan2 = s_scan + Lp;
  float* s_vvec = s_scan2 + Lp;           // spanning-pair adjoints (cofold)
  float* s_wv = s_vvec + Lp;              // wvec (cofold)

  for (int t = i; t < kW * kW; t += blockDim.x) s_w2[t] = w2k_g[b * kW * kW + t];
  for (int t = i; t < kW; t += blockDim.x) s_bk[t] = bulge_g[b * kW + t];
  for (int t = i; t < kPow2; t += blockDim.x) s_pw[t] = pows_g[b * kPow2 + t];
  for (int t = i; t < 9 * Lp; t += blockDim.x) s_om[t] = 0.f;
  const size_t LL = (size_t)L * L;
  const size_t fstride = (size_t)B * LL;
  const float* Fb = F + (size_t)b * LL;
  auto fat = [&](int f, int r, int col) -> float {
    return Fb[f * fstride + (size_t)col * L + r];
  };
  const float* qmN = qmN_g + (size_t)b * LL;    // qm(l, i) at [l][i]
  const float* qm1 = qm1_g + (size_t)b * LL;    // qm1(r, c) at [c][r]
  const float* qxN = kCofold ? qxN_g + (size_t)b * LL : nullptr;
  float* om = om_s + (size_t)b * LL;            // om(i, m) at [m][i]
  float* ob = ob_o + (size_t)b * LL;            // ob(i, c) at [c][i]
  const float sg = sig_g[b];
  const int ct = kCofold ? cut_g[b] : 0;
  const bool row = i < L;
  if (row)
    for (int m = 0; m < L; ++m) om[(size_t)m * L + i] = 0.f;
  const float q1pad = row ? q1pad_g[(size_t)b * L + i] : 0.f;
  const float qBp = (kCofold && row) ? qBpref_g[(size_t)b * L + i] : 0.f;
  const float J1i = (kCofold && i == ct) ? 0.f : 1.f;
  float pend = 0.f, sm1 = 0.f, ga = 0.f, wv = 0.f;
  __syncthreads();
  const float smv = s_pw[0];

  for (int j = 0; j < L; ++j) {
    const int c = L - 1 - j;
    // ---- om1 column c: pending direct term + ml_base prefix scan + qm^T om
    const float omcol = row ? om[(size_t)c * L + i] : 0.f;
    if (row) s_om[i] = omcol;
    __syncthreads();
    if (row) {
      float acc = 0.f;
      for (int l = 0; l < L; ++l) acc += qmN[(size_t)l * L + i] * s_om[l];
      s_qmt[i] = acc;
    }
    float dterm = doubling_scan<false>(omcol, i, L, s_pw, s_scan);
    if (kCofold) {
      const float hi = doubling_scan<false>(i >= ct ? omcol : 0.f, i, L, s_pw,
                                            s_scan2);
      if (i >= ct) dterm = hi;
    }
    float obcol = 0.f;
    if (row) {
      const float qmt_dn = i >= 1 ? s_qmt[i - 1] : 0.f;
      float om1col;
      if (kCofold) {
        om1col = pend + dterm + J1i * qmt_dn;
        sm1 = om1col + (c + 1 != ct ? 1.f : 0.f) * smv * sm1;
      } else {
        om1col = pend + dterm + qmt_dn;
        sm1 = om1col + smv * sm1;
      }
      // ---- ob column c
      const float q2c1 = q2_g[(size_t)b * Lp + c + 1];
      obcol = q1pad * fat(FE, i, c) * q2c1;
      obcol = obcol + fat(FMB, i, c) * sm1;
      // source-column mask of the mirrored window (cofold)
      auto bm = [&](int k) -> float {
        return (!kCofold || c >= ct || k < ct) ? 1.f : 0.f;
      };
      // generic interior (mirror): outer pair (i-u1-1, c+1+u2)
      float gen = 0.f;
      for (int u1 = 1; u1 < kMaxLoop; ++u1) {
        const int r = i - u1 - 1;
        if (r < 0) break;
        float acc = 0.f;
        for (int u2 = 1; u2 <= kMaxLoop - u1; ++u2) {
          const int k = c + 1 + u2;
          if (k >= L) break;
          acc += ob[(size_t)k * L + r] * fat(MOUT, r, k) * bm(k)
                 * s_w2[u1 * kW + u2];
        }
        gen += (kCofold ? m5(u1 + 1, r, ct) : 1.f) * acc;
      }
      obcol = obcol + gen * fat(MINN, i, c);
      // bulges of size >= 2 (mirror)
      float b5 = 0.f, b3 = 0.f;
      if (c + 1 < L) {
        const float bm0 = bm(c + 1);
        for (int m = 2; m <= kMaxLoop; ++m) {
          const int r = i - m - 1;
          if (r < 0) break;
          b5 += s_bk[m] * (kCofold ? m5(m + 1, r, ct) : 1.f)
                * (ob[(size_t)(c + 1) * L + r] * fat(TAU, r, c + 1) * bm0);
        }
      }
      if (i >= 1) {
        const int r = i - 1;
        for (int m = 2; m <= kMaxLoop; ++m) {
          const int k = c + 1 + m;
          if (k >= L) break;
          b3 += ob[(size_t)k * L + r] * fat(TAU, r, k) * bm(k) * s_bk[m];
        }
        if (kCofold) b3 *= m5(1, r, ct);
      }
      obcol = obcol + fat(TAUR, i, c) * (b5 + b3);
      // stacks, small interiors, 1-bulges (mirror): outer (i-di, c+dj)
      auto sp = [&](int f, int di, int dj) -> float {
        const int r = i - di, k = c + dj;
        return (r >= 0 && k < L) ? fat(f, r, k) * ob[(size_t)k * L + r] : 0.f;
      };
      obcol = obcol + sp(PSTK, 1, 1);
      obcol = obcol + sp(P11, 2, 2);
      obcol = obcol + sp(P21A, 2, 3);
      obcol = obcol + sp(P21B, 3, 2);
      obcol = obcol + sp(P22, 3, 3);
      obcol = obcol + sp(PB15, 2, 1);
      obcol = obcol + sp(PB13, 1, 2);
    }
    if (kCofold) {
      // exposed-cut segments: hb = sum_k vvec[k+1] qx(c+1, k) + vvec[c+1]
      const int rrow = c + 1 < L ? c + 1 : L - 1;
      float t = 0.f;
      if (row && i + 1 < L) t = s_vvec[i + 1] * qxN[(size_t)rrow * L + i];
      float hb = block_sum(t, s_red);
      if (c + 1 < L) hb += s_vvec[c + 1];
      if (row) obcol = obcol + (c >= ct ? hb : 0.f) * fat(FE, i, c) * qBp;
      if (c + 1 == ct) {
        // GA[i] = wvec[i-1] + sum_l qx(l, i-1) wvec[l-1]
        if (row) {
          float acc = 0.f;
          for (int l = 1; l < L; ++l) acc += qxN[(size_t)l * L + i] * s_wv[l - 1];
          s_scan2[i] = acc;
        }
        __syncthreads();
        if (row) ga = i >= 1 ? s_wv[i - 1] + s_scan2[i - 1] : 0.f;
        __syncthreads();
      }
      if (row) {
        const float qseg = c + 1 < L ? qxA_g[(size_t)b * L + c + 1] : 0.f;
        obcol = obcol + (c < ct ? qseg : 0.f) * fat(FE, i, c) * ga;
      }
    }
    if (row) obcol = clamp_huge(obcol);
    // ---- scatters feeding later (smaller-c) steps
    if (row) {
      float a = obcol * fat(FMC, i, c) * sg * sg;
      if (kCofold) a = m5(1, i, ct) * (a * (c != ct ? 1.f : 0.f));
      s_a[i] = a;
      const float J1n = (kCofold && i + 1 == ct) ? 0.f : 1.f;
      s_w1[i] = (c >= 1 && i + 1 < L) ? qm1[(size_t)(c - 1) * L + i + 1] * J1n
                                       : 0.f;
      s_w2v[i] = i + 1 < L ? qm1[(size_t)c * L + i + 1] * J1n : 0.f;
    }
    __syncthreads();
    if (row) {
      const float ash = i >= 1 ? s_a[i - 1] : 0.f;
      for (int m = 0; m < c; ++m) {
        float* p = om + (size_t)m * L + i;
        *p = *p + ash * s_w1[m] + omcol * s_w2v[m];
      }
      float acc = 0.f;
      for (int l = 1; l < L; ++l) acc += qmN[(size_t)l * L + i] * s_a[l - 1];
      s_qmt[i] = acc;
      ob[(size_t)c * L + i] = obcol;
    }
    __syncthreads();
    if (row) pend = (kCofold ? J1i : 1.f) * (i >= 1 ? s_qmt[i - 1] : 0.f);
    if (kCofold) {
      const float fcx = row ? fat(FCX, i, c) : 0.f;
      float t = 0.f;
      if (row && i + 1 < L) t = obcol * fcx * qxA_g[(size_t)b * L + i + 1];
      const float vval = block_sum(t, s_red);
      if (i == 0) s_vvec[c] = c >= ct ? vval : 0.f;
      if (row) {
        const float qxBr = qBpref_g[(size_t)b * L + c];
        wv = wv + (c >= ct ? 1.f : 0.f) * obcol * fcx * qxBr;
        s_wv[i] = wv;
      }
    }
    __syncthreads();
  }
}

}  // namespace rt

extern "C" int rt_outside(const float* F, const float* qm, const float* qm1,
                          const float* q1pad, const float* q2, const float* w2k,
                          const float* bulge_k, const float* sig,
                          const float* pows, const int* cut, const float* qx,
                          const float* qxA, const float* qBpref, float* om,
                          float* ob, int B, int L, int cofold, void* stream) {
  using namespace rt;
  const int threads = ((L + 31) / 32) * 32;
  const size_t shmem =
      sizeof(float) * (kW * kW + kW + kPow2 + 1 + 32 + 9 * (size_t)(L + 1));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cofold) {
    cudaFuncSetAttribute(outside_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    outside_kernel<true><<<B, threads, shmem, st>>>(
        F, qm, qm1, q1pad, q2, w2k, bulge_k, sig, pows, cut, qx, qxA, qBpref,
        om, ob, B, L);
  } else {
    cudaFuncSetAttribute(outside_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    outside_kernel<false><<<B, threads, shmem, st>>>(
        F, qm, qm1, q1pad, q2, w2k, bulge_k, sig, pows, cut, qx, qxA, qBpref,
        om, ob, B, L);
  }
  return (int)cudaGetLastError();
}
