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
// Per cell it does up to 435 window multiply-adds (the generic interior
// loop) plus two contractions against the resident qm and qx tables.
//
// Design: one block per instance, kT threads per row i (two for the
// cofold where the block holds them, one for the fold), and a loop over
// the columns inside the block in place of the TPU's sequential grid axis.
// A row's threads split its window's u1 range, its bulges and its
// contractions and sum them with shuffles; every thread of the row then
// holds the row's values and the first one writes them.  Every loop runs
// only over the terms that can be nonzero: qb, qm1 and qm vanish on and
// below the diagonal and past the instance's length n, qx below the
// diagonal, so the window keeps u1 + u2 <= j - i - 3 and the contractions
// l in [i+1, j-2] (qm) and [i, j-2] (qx).  The qm2 column of step j is the
// qm contraction of step j-1 (the extra term is qm(i, j-1) * qm1(j, j-1) =
// 0), carried in shared memory.  The window reads the last 32 columns of
// the premultiplied products qb * minn and qb * taur from rings written
// once per column (and the last 4 raw qb columns for the stack and small
// loops): in shared memory where the 68 L floats fit (L <= 760), else in a
// device-memory scratch the wrapper allocates.  The ml_base suffix scans
// are shuffle scans inside each warp plus one carry across warps, so a
// column takes two barriers.  The resident tables (qm, qx) stay in device
// memory, read back through L1/L2.  The cofold's columns past n are filled
// after the sweep (see there).
#include "dp_common.cuh"

namespace rt {

template <bool kCofold, bool kRingSmem, int kT>
__global__ void __launch_bounds__(1024) inside_kernel(
    const float* __restrict__ F, const float* __restrict__ w2k_g,
    const float* __restrict__ bulge_g, const float* __restrict__ sig_g,
    const float* __restrict__ pows_g, const int* __restrict__ cut_g,
    const int* __restrict__ n_g, float* qm1_o, float* qb_o, float* qm_o,
    float* aux_o, float* q1_o, float* ring_g, int B, int L) {
  extern __shared__ float sh[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int i = tid / kT;                 // the row; kT threads share it
  const int sub = tid % kT;
  const bool lead = sub == 0;             // writes the row's results
  const int Lp = L + 1;
  float* s_w2 = sh;                       // [W*W]
  float* s_bk = s_w2 + kW * kW;           // [W]
  float* s_pw = s_bk + kW;                // [POW2]
  float* s_red = s_pw + kPow2 + 1;        // [32] warp sums
  float* s_tot = s_red + 32;              // [64] warp totals of the scans
  float* s_qm1 = s_tot + 64;              // qm1 column j
  float* s_qm2 = s_qm1 + Lp;              // qm2 column j (read at i+1)
  float* s_q1 = s_qm2 + Lp;               // q1 prefix
  float* s_qxA = s_q1 + Lp;               // qx[:, cut-1] capture (cofold)
  float* s_qbe = s_qxA + Lp;              // qb*fe column (cofold)
  float* s_qxc = s_qbe + Lp;              // [0]: qx(cut, j-1) (cofold)
  // rings: X = qb * minn, A = qb * taur (slot k % 32), R = qb (slot k % 4)
  float* ringX = kRingSmem ? s_qxc + 1 : ring_g + (size_t)b * ring_floats(L);
  float* ringA = ringX + (size_t)kRing * L;
  float* ringR = ringA + (size_t)kRing * L;

  for (int t = tid; t < kW * kW; t += blockDim.x)
    s_w2[t] = w2k_g[b * kW * kW + t];
  for (int t = tid; t < kW; t += blockDim.x) s_bk[t] = bulge_g[b * kW + t];
  for (int t = tid; t < kPow2; t += blockDim.x) s_pw[t] = pows_g[b * kPow2 + t];
  for (int t = tid; t < 5 * Lp + 1; t += blockDim.x) s_qm1[t] = 0.f;
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
  // the instance's length: the fold always sweeps the whole bucket
  const int nb = kCofold ? max(0, min(n_g[b], L)) : L;
  const bool row = i < L;
  // qm2's last column is never produced by the scan (the caller fills it)
  if (!kCofold && row && lead) aux[(size_t)(L - 1) * L + i] = 0.f;
  if (kCofold && ct == 0 && tid == 0) s_qxA[0] = 1.f;  // qx[:, -1]: empty
  __syncthreads();
  const float sm = s_pw[0];
  constexpr int R = 32 / kT;              // rows a warp
  const float apw = pow_bits(s_pw, R - (tid & 31) / kT);
  const float aR = pow_bits(s_pw, R);
  float qm1P = 0.f, qmP = 0.f, qxP = 0.f;   // this row's previous column

  for (int j = 0; j < nb; ++j) {
    const float qxB = (kCofold && j > ct) ? s_qxc[0] : 1.f;
    // ---- qb column (rows past n and on or below the diagonal give 0)
    float qbcol = 0.f, qm1col = 0.f, qbecol = 0.f;
    if (i < nb) {
      // u1 + u2 <= dmax keeps the inner pair (r, k) above the diagonal
      const int dmax = j - i - 3;
      // cofold: an inner pair column k contributes only from the strand
      // side of j, i.e. k >= ct once j >= ct
      const int klo = (kCofold && j >= ct) ? ct : 0;
      // generic interior loops: sum_{u1,u2} w2k[u1,u2] X(i+u1+1, j-1-u2)
      float gen = 0.f;
      const int u1hi = min(kMaxLoop - 1, min(dmax - 1, nb - 2 - i));
      for (int u1 = 1 + sub; u1 <= u1hi; u1 += kT) {
        const int r = i + u1 + 1;
        const int u2hi = min(kMaxLoop - u1, min(dmax - u1, j - 1 - klo));
        float acc = 0.f;
        for (int u2 = 1; u2 <= u2hi; ++u2) {
          const int k = j - 1 - u2;
          acc += s_w2[u1 * kW + u2] * ringX[(k & (kRing - 1)) * L + r];
        }
        gen += (kCofold ? m5(u1 + 1, i, ct) : 1.f) * acc;
      }
      gen = row_sum<kT>(gen) * fat(MOUT, i, j);
      // bulges of size >= 2
      float b5 = 0.f, b3 = 0.f;
      if (j - 1 >= klo) {
        const int mhi = min(kMaxLoop, min(dmax, nb - 2 - i));
        for (int m = 2 + sub; m <= mhi; m += kT) {
          const int r = i + m + 1;
          b5 += s_bk[m] * (kCofold ? m5(m + 1, i, ct) : 1.f)
                * ringA[((j - 1) & (kRing - 1)) * L + r];
        }
      }
      {
        const int mhi = min(kMaxLoop, min(dmax, j - 1 - klo));
        for (int m = 2 + sub; m <= mhi; m += kT) {
          const int k = j - 1 - m;
          b3 += ringA[(k & (kRing - 1)) * L + i + 1] * s_bk[m];
        }
      }
      b5 = row_sum<kT>(b5);
      b3 = row_sum<kT>(b3);
      const float bulges =
          fat(TAU, i, j) * (b5 + (kCofold ? m5(1, i, ct) : 1.f) * b3);
      // stacks, 1x1 / 1x2 / 2x1 / 2x2 interiors, 1-bulges
      auto q = [&](int di, int dj) -> float {
        const int r = i + di, k = j - dj;
        return (r < nb && k >= 0) ? ringR[(k & (kRaw - 1)) * L + r] : 0.f;
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
      const float mlgate = (kCofold && j == ct) ? 0.f : 1.f;
      qm1col = clamp_huge(mlgate * sm * qm1P + qbcol * fat(FMB, i, j));
      qbecol = qbcol * fat(FE, i, j);
      if (lead) {
        ringX[(j & (kRing - 1)) * L + i] = qbcol * fat(MINN, i, j);
        ringA[(j & (kRing - 1)) * L + i] = qbcol * fat(TAUR, i, j);
        ringR[(j & (kRaw - 1)) * L + i] = qbcol;
      }
    }
    if (row && lead) {
      qb[(size_t)j * L + i] = qbcol;
      qm1[(size_t)j * L + i] = qm1col;
      s_qm1[i] = qm1col;
      if (kCofold) s_qbe[i] = qbecol;
    }
    // ---- the exterior prefix term and the ml_base suffix scans (the
    // cofold's second one stops at the cut) up to the column's one barrier
    float term = 0.f;
    if (row && lead && i < j) {
      const float q1pad = i == 0 ? 1.f : s_q1[i - 1];
      term = kCofold ? q1pad * qbecol : q1pad * qbcol * fat(FE, i, j);
    }
    warp_sum(term, s_red);
    float sv[kCofold ? 2 : 1];
    sv[0] = qm1col;
    if (kCofold) sv[kCofold ? 1 : 0] = i < ct ? qm1col : 0.f;
    warp_scan<true, kT>(sv, s_pw, s_tot);
    __syncthreads();
    scan_carry<true>(sv, apw, aR, s_tot);
    const float dterm = (kCofold && i < ct) ? sv[kCofold ? 1 : 0] : sv[0];
    // ---- qm column: the scan + sum_l qm(i, l) qm1(l+1, j)
    float qmcol = 0.f;
    if (row) {
      float acc = 0.f;
      for (int l = i + 1 + sub; l <= j - 2; l += kT)
        acc += qm[(size_t)l * L + i]
               * ((kCofold && l + 1 == ct) ? 0.f : s_qm1[l + 1]);
      acc = row_sum<kT>(acc);
      qmcol = clamp_huge(dterm + acc);
      if (lead) {
        qm[(size_t)j * L + i] = qmcol;
        // qm2 of column j+1 is this contraction (column L-1's stays 0)
        s_qm2[i] = clamp_huge(acc);
        if (!kCofold && j + 1 < L) aux[(size_t)j * L + i] = clamp_huge(acc);
      }
    }
    // ---- exterior prefix q1[j]
    if (tid == 0) {
      const float q1prev = j >= 1 ? s_q1[j - 1] : 1.f;
      const float q1v = clamp_huge(sg * q1prev + sum_red(s_red));
      s_q1[j] = q1v;
      q1_o[(size_t)b * L + j] = q1v;
    }
    // ---- cofold: exterior-segment column qx[:, j]
    if (kCofold && row) {
      float acc = 0.f;
      for (int l = i + sub; l <= j - 2; l += kT)
        acc += aux[(size_t)l * L + i] * s_qbe[l + 1];
      acc = row_sum<kT>(acc);
      const float onej = i == j ? 1.f : 0.f;
      const float qxcol = clamp_huge(sg * (qxP + onej) + acc + qbecol);
      qxP = qxcol;
      if (lead) {
        aux[(size_t)j * L + i] = qxcol;
        if (i == ct) s_qxc[0] = qxcol;
        if (j + 1 == ct) s_qxA[i] = i < ct ? qxcol : (i == ct ? 1.f : 0.f);
      }
    }
    qm1P = qm1col;
    qmP = qmcol;
    __syncthreads();
  }
  // ---- cofold columns past n: no pair closes there (every factor is 0),
  // so qb = 0 and qm1, qx, q1 take one multiplication a column, exactly as
  // the plain version computes them.  qm(i, j) = sm * qm(i, j-1) holds
  // there too, to rounding, while its smallest value stays a normal float;
  // where it would underflow (a small sm over many columns), the rounding
  // of the subnormals depends on the order of operations, so those columns
  // are swept with the scan and contraction the plain version uses.
  if (kCofold && nb < L) {
    const bool nz = row && i < nb && qmP > 0.f;
    const float lo = nz ? __logf(qmP) : 0.f;
    const int any_small = __syncthreads_or(
        nz && lo + (float)(L - nb) * __logf(sm) < kLogNormal);
    float* s_scan = s_qm2;                 // free past n
    float* s_scan2 = s_qbe;
    for (int j = nb; j < L; ++j) {
      qm1P = clamp_huge(sm * qm1P);
      qxP = clamp_huge(sg * (qxP + (i == j ? 1.f : 0.f)));
      if (row && lead) {
        qb[(size_t)j * L + i] = 0.f;
        qm1[(size_t)j * L + i] = qm1P;
        aux[(size_t)j * L + i] = qxP;
      }
      if (!any_small) {
        qmP = clamp_huge(sm * qmP);
        if (row && lead) qm[(size_t)j * L + i] = qmP;
        continue;
      }
      if (row && lead) s_qm1[i] = qm1P;
      float dterm = doubling_scan<true>(qm1P, i, L, s_pw, s_scan);
      const float dlo = doubling_scan<true>(i < ct ? qm1P : 0.f, i, L, s_pw,
                                            s_scan2);
      if (i < ct) dterm = dlo;
      if (row && lead) {
        float acc = 0.f;
        for (int l = i + 1; l <= nb - 2; ++l)
          acc += qm[(size_t)l * L + i] * (l + 1 == ct ? 0.f : s_qm1[l + 1]);
        qm[(size_t)j * L + i] = clamp_huge(dterm + acc);
      }
      __syncthreads();
    }
    if (tid == 0) {
      float q1v = nb >= 1 ? s_q1[nb - 1] : 1.f;
      for (int j = nb; j < L; ++j) {
        q1v = clamp_huge(sg * q1v);
        q1_o[(size_t)b * L + j] = q1v;
      }
    }
  }
}

}  // namespace rt

namespace {

size_t inside_smem(int L, bool ring_smem) {
  using namespace rt;
  return sizeof(float) * (kW * kW + kW + kPow2 + 1 + 96 + 5 * (size_t)(L + 1)
                          + 1 + (ring_smem ? ring_floats(L) : 0));
}

template <bool kCofold, bool kRingSmem, int kT>
void launch_inside(const float* F, const float* w2k, const float* bulge_k,
                   const float* sig, const float* pows, const int* cut,
                   const int* n, float* qm1, float* qb, float* qm, float* aux,
                   float* q1, float* ring, int B, int L, cudaStream_t st) {
  using namespace rt;
  const int threads = kT * ((L + 31) / 32) * 32;
  const size_t shmem = inside_smem(L, kRingSmem);
  cudaFuncSetAttribute(inside_kernel<kCofold, kRingSmem, kT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  inside_kernel<kCofold, kRingSmem, kT><<<B, threads, shmem, st>>>(
      F, w2k, bulge_k, sig, pows, cut, n, qm1, qb, qm, aux, q1, ring, B, L);
}

// threads a row: two for the cofold where a block of 1024 holds them and
// the rings are in shared memory, else one (the fold faulted on the card
// with two; PERF.md)
template <bool kCofold>
void launch_inside(const float* F, const float* w2k, const float* bulge_k,
                   const float* sig, const float* pows, const int* cut,
                   const int* n, float* qm1, float* qb, float* qm, float* aux,
                   float* q1, float* ring, int B, int L, cudaStream_t st) {
  constexpr int kT = kCofold ? 2 : 1;
  if (ring != nullptr)
    launch_inside<kCofold, false, 1>(F, w2k, bulge_k, sig, pows, cut, n, qm1,
                                     qb, qm, aux, q1, ring, B, L, st);
  else if (kT * ((L + 31) / 32) * 32 <= 1024)
    launch_inside<kCofold, true, kT>(F, w2k, bulge_k, sig, pows, cut, n, qm1,
                                     qb, qm, aux, q1, ring, B, L, st);
  else
    launch_inside<kCofold, true, 1>(F, w2k, bulge_k, sig, pows, cut, n, qm1,
                                    qb, qm, aux, q1, ring, B, L, st);
}

}  // namespace

// Bytes of shared memory a block takes with the rings in it; past the
// opt-in limit the caller passes a device-memory ring of B * 68 * L floats.
extern "C" long long rt_inside_smem(int L) {
  return (long long)inside_smem(L, true);
}

extern "C" int rt_inside(const float* F, const float* w2k, const float* bulge_k,
                         const float* sig, const float* pows, const int* cut,
                         const int* n, float* qm1, float* qb, float* qm,
                         float* aux, float* q1, float* ring, int B, int L,
                         int cofold, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cofold)
    launch_inside<true>(F, w2k, bulge_k, sig, pows, cut, n, qm1, qb, qm, aux,
                        q1, ring, B, L, st);
  else
    launch_inside<false>(F, w2k, bulge_k, sig, pows, cut, n, qm1, qb, qm, aux,
                         q1, ring, B, L, st);
  return (int)cudaGetLastError();
}
