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
// (one barrier-separated column step after another), not by bytes or FLOPs:
// a column takes as long as its longest row's chain of dependent shared-
// memory loads (up to 435 window multiply-adds, the bulges, and the
// contractions against qm and, for the cofold, qx), whether one block or
// four share an SM.
//
// Design: one block per instance, kT threads per row i (two for the
// cofold where the block holds them; for the fold four, two or one, the
// most that keeps the batch in the fewest waves), and a loop over the
// columns inside the block in place of the TPU's sequential grid axis.  A
// row's threads split its window's u1 range (in a function kept out of
// line, see window_sum), its bulges and its contractions and sum them with
// shuffles outside any branch; every thread of the row then holds the
// row's values and the first one writes them.  The sweep covers only the
// instance's n columns and rows, and every loop runs only over the terms
// that can be nonzero: qb, qm1 and qm vanish on and below the diagonal and
// past n, qx below the diagonal, so the window keeps u1 + u2 <= j - i - 3
// and the contractions l in [i+1, j-2] (qm) and [i, j-2] (qx).  The qm2
// column of step j is the qm contraction of step j-1 (the extra term is
// qm(i, j-1) * qm1(j, j-1) = 0), carried in shared memory.  The window
// reads the last 32 columns of the premultiplied products qb * minn and
// qb * taur from rings written once per column (and the last 4 raw qb
// columns for the stack and small loops).  Placement (kSmem): the rings in
// shared memory where the 68 L floats fit (L <= 760), else in a device-
// memory scratch the wrapper allocates; qm as a packed strict triangle in
// shared memory beside them where two blocks still fit an SM (L <= 174:
// the cofold's Lc = 192 keeps it in device memory), read one
// column at a time by the lanes of a warp (consecutive banks), else in
// device memory through L1/L2.  The hot loops are unrolled by 4 so that
// their loads overlap.  The ml_base suffix scans are shuffle scans inside
// each warp plus one carry across warps, so a column takes two barriers.
// The columns past n are filled after the sweep (see there).
#include "dp_common.cuh"

namespace rt {

// The generic interior loops of row i at column j, this lane's share:
// sum over u1 = 1 + sub, 1 + sub + kT, ... <= u1hi of sum_{u2} w2k[u1, u2]
// X(i+u1+1, j-1-u2), X the ring of qb * minn.  Kept out of line: inlined
// into the fold's kernel at two or more threads a row, this loop faults on
// the card (an illegal address, every index in range; PERF.md, PR 5).
template <bool kCofold, int kT>
__device__ __noinline__ float window_sum(const float* s_w2, const float* ringX,
                                         int i, int j, int sub, int u1hi,
                                         int dmax, int klo, int ct, int L) {
  float gen = 0.f;
  for (int u1 = 1 + sub; u1 <= u1hi; u1 += kT) {
    const int r = i + u1 + 1;
    const int u2hi = min(kMaxLoop - u1, min(dmax - u1, j - 1 - klo));
    float acc = 0.f;
#pragma unroll 4
    for (int u2 = 1; u2 <= u2hi; ++u2) {
      const int k = j - 1 - u2;
      acc += s_w2[u1 * kW + u2] * ringX[(k & (kRing - 1)) * L + r];
    }
    gen += (kCofold ? m5(u1 + 1, i, ct) : 1.f) * acc;
  }
  return gen;
}

// kSmem: which of the rings (kRingS) and the qm table (kQmS) live in
// shared memory.
template <bool kCofold, int kSmem, int kT>
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
  float* ringX = (kSmem & kRingS) ? s_qxc + 1
                                  : ring_g + (size_t)b * ring_floats(L);
  float* ringA = ringX + (size_t)kRing * L;
  float* ringR = ringA + (size_t)kRing * L;
  // qm(i, l), i < l, at s_qm[tri(l) + i] (kQmS): the contraction's operand
  float* s_qm = ringR + (size_t)kRaw * L;

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
  // the instance's length: the sweep covers its n columns and rows
  const int nb = max(0, min(n_g[b], L));
  const bool row = i < L;
  // qm2's last column is never produced by the scan (the caller fills it)
  if (!kCofold && row && lead) aux[(size_t)(L - 1) * L + i] = 0.f;
  if (kCofold && ct == 0 && tid == 0) s_qxA[0] = 1.f;  // qx[:, -1]: empty
  __syncthreads();
  const float sm = s_pw[0];
  constexpr int R = 32 / kT;              // rows a warp
  const float apw = pow_bits(s_pw, R - (tid & 31) / kT);
  const float aR = pow_bits(s_pw, R);
  // this row's previous column of qm1, qm, qx (cofold) or qm2 (fold)
  float qm1P = 0.f, qmP = 0.f, qxP = 0.f, auxP = 0.f;

  for (int j = 0; j < nb; ++j) {
    const float qxB = (kCofold && j > ct) ? s_qxc[0] : 1.f;
    // ---- qb column (rows past n and on or below the diagonal give 0)
    float qbcol = 0.f, qm1col = 0.f, qbecol = 0.f;
    // u1 + u2 <= dmax keeps the inner pair (r, k) above the diagonal
    const int dmax = j - i - 3;
    // cofold: an inner pair column k contributes only from the strand side
    // of j, i.e. k >= ct once j >= ct
    const int klo = (kCofold && j >= ct) ? ct : 0;
    // the row's lanes split the window and the bulges; their sums are taken
    // outside any branch, where every lane of the warp arrives
    float gen = 0.f, b5 = 0.f, b3 = 0.f;
    if (i < nb) {
      // generic interior loops: sum_{u1,u2} w2k[u1,u2] X(i+u1+1, j-1-u2)
      const int u1hi = min(kMaxLoop - 1, min(dmax - 1, nb - 2 - i));
      gen = window_sum<kCofold, kT>(s_w2, ringX, i, j, sub, u1hi, dmax, klo,
                                    ct, L);
      // bulges of size >= 2
      if (j - 1 >= klo) {
        const int mhi = min(kMaxLoop, min(dmax, nb - 2 - i));
#pragma unroll 4
        for (int m = 2 + sub; m <= mhi; m += kT) {
          const int r = i + m + 1;
          b5 += s_bk[m] * (kCofold ? m5(m + 1, i, ct) : 1.f)
                * ringA[((j - 1) & (kRing - 1)) * L + r];
        }
      }
      {
        const int mhi = min(kMaxLoop, min(dmax, j - 1 - klo));
#pragma unroll 4
        for (int m = 2 + sub; m <= mhi; m += kT) {
          const int k = j - 1 - m;
          b3 += ringA[(k & (kRing - 1)) * L + i + 1] * s_bk[m];
        }
      }
    }
    gen = row_sum<kT>(gen);
    b5 = row_sum<kT>(b5);
    b3 = row_sum<kT>(b3);
    if (i < nb) {
      gen *= fat(MOUT, i, j);
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
    float qmcol = 0.f, acc = 0.f;
    if (row) {
      if (kSmem & kQmS) {
        // the lanes of a warp read one column l at a time: consecutive rows,
        // consecutive banks (rows past l add nothing)
        const int lw = (tid & ~31) / kT + 1;
#pragma unroll 4
        for (int l = lw + sub; l <= j - 2; l += kT)
          if (l > i)
            acc += s_qm[tri(l) + i]
                   * ((kCofold && l + 1 == ct) ? 0.f : s_qm1[l + 1]);
      } else {
#pragma unroll 4
        for (int l = i + 1 + sub; l <= j - 2; l += kT)
          acc += qm[(size_t)l * L + i]
                 * ((kCofold && l + 1 == ct) ? 0.f : s_qm1[l + 1]);
      }
    }
    acc = row_sum<kT>(acc);
    if (row) {
      qmcol = clamp_huge(dterm + acc);
      if (lead) {
        qm[(size_t)j * L + i] = qmcol;
        if ((kSmem & kQmS) && i < j) s_qm[tri(j) + i] = qmcol;
        // qm2 of column j+1 is this contraction (column L-1's stays 0)
        s_qm2[i] = clamp_huge(acc);
        if (!kCofold && j + 1 < L) aux[(size_t)j * L + i] = clamp_huge(acc);
      }
      auxP = clamp_huge(acc);
    }
    // ---- exterior prefix q1[j]
    if (tid == 0) {
      const float q1prev = j >= 1 ? s_q1[j - 1] : 1.f;
      const float q1v = clamp_huge(sg * q1prev + sum_red(s_red));
      s_q1[j] = q1v;
      q1_o[(size_t)b * L + j] = q1v;
    }
    // ---- cofold: exterior-segment column qx[:, j]
    if (kCofold) {
      float acc = 0.f;
      if (row)
        for (int l = i + sub; l <= j - 2; l += kT)
          acc += aux[(size_t)l * L + i] * s_qbe[l + 1];
      acc = row_sum<kT>(acc);
      const float onej = i == j ? 1.f : 0.f;
      const float qxcol = clamp_huge(sg * (qxP + onej) + acc + qbecol);
      qxP = qxcol;
      if (row && lead) {
        aux[(size_t)j * L + i] = qxcol;
        if (i == ct) s_qxc[0] = qxcol;
        if (j + 1 == ct) s_qxA[i] = i < ct ? qxcol : (i == ct ? 1.f : 0.f);
      }
    }
    qm1P = qm1col;
    qmP = qmcol;
    __syncthreads();
  }
  // ---- columns past n: no pair closes there (every factor is 0), so
  // qb = 0 and qm1, q1 (and the cofold's qx) take one multiplication a
  // column, exactly as the plain version computes them.  qm(i, j) =
  // sm * qm(i, j-1) holds there too, to rounding, and so does the fold's
  // qm2(i, j) = sm * qm2(i, j-1) (the qm contraction; column L-1 stays 0),
  // while their smallest values stay normal floats; where one would
  // underflow (a small sm over many columns), the rounding of the subnormals
  // depends on the order of operations, so those columns are swept with the
  // scan and contraction the plain version uses.
  if (nb < L) {
    const float lsm = (float)(L - nb) * __logf(sm);
    const bool nzm = row && i < nb && qmP > 0.f;
    const bool nza = !kCofold && row && i < nb && auxP > 0.f;
    const int any_small = __syncthreads_or(
        (nzm && __logf(qmP) + lsm < kLogNormal)
        || (nza && __logf(auxP) + lsm < kLogNormal));
    float* s_scan = s_qm2;                 // free past n
    float* s_scan2 = s_qbe;
    for (int j = nb; j < L; ++j) {
      qm1P = clamp_huge(sm * qm1P);
      if (kCofold) qxP = clamp_huge(sg * (qxP + (i == j ? 1.f : 0.f)));
      if (row && lead) {
        qb[(size_t)j * L + i] = 0.f;
        qm1[(size_t)j * L + i] = qm1P;
        if (kCofold) aux[(size_t)j * L + i] = qxP;
      }
      if (!any_small) {
        qmP = clamp_huge(sm * qmP);
        auxP = clamp_huge(sm * auxP);
        if (row && lead) {
          qm[(size_t)j * L + i] = qmP;
          if (!kCofold && j + 1 < L) aux[(size_t)j * L + i] = auxP;
        }
        continue;
      }
      if (row && lead) s_qm1[i] = qm1P;
      float dterm = doubling_scan<true>(qm1P, i, L, s_pw, s_scan);
      if (kCofold) {
        const float dlo = doubling_scan<true>(i < ct ? qm1P : 0.f, i, L,
                                              s_pw, s_scan2);
        if (i < ct) dterm = dlo;
      }
      if (row && lead) {
        float acc = 0.f;
        for (int l = i + 1; l <= nb - 2; ++l)
          acc += qm[(size_t)l * L + i]
                 * ((kCofold && l + 1 == ct) ? 0.f : s_qm1[l + 1]);
        qm[(size_t)j * L + i] = clamp_huge(dterm + acc);
        if (!kCofold && j + 1 < L) aux[(size_t)j * L + i] = clamp_huge(acc);
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

using namespace rt;

size_t inside_smem(int L, int smem) {
  return sizeof(float) * (kW * kW + kW + kPow2 + 1 + 96 + 5 * (size_t)(L + 1)
                          + 1 + ((smem & kRingS) ? ring_floats(L) : 0)
                          + ((smem & kQmS) ? (size_t)tri(L) : 0));
}

// Placement at L: the rings in shared memory where they fit, and qm beside
// them where two blocks still fit an SM.
int inside_mode(int L) {
  if (inside_smem(L, kRingS) > (size_t)kSmemBlock) return 0;
  if (blocks_by_smem(inside_smem(L, kRingS | kQmS)) >= 2)
    return kRingS | kQmS;
  return kRingS;
}

using InsideFn = void (*)(const float*, const float*, const float*,
                          const float*, const float*, const int*, const int*,
                          float*, float*, float*, float*, float*, float*, int,
                          int);

// The variant launched at L: its kernel, threads and shared memory.
struct Variant {
  InsideFn fn;
  int threads;
  size_t smem;
};

template <bool kCofold, int kSmem, int kT>
Variant variant(int L) {
  return {inside_kernel<kCofold, kSmem, kT>, kT * ((L + 31) / 32) * 32,
          inside_smem(L, kSmem)};
}

template <bool kCofold, int kT>
Variant variant_at(int L, int mode) {
  if (mode & kQmS) return variant<kCofold, kRingS | kQmS, kT>(L);
  return variant<kCofold, kRingS, kT>(L);
}

// Threads a row where the rings are in shared memory: the cofold two where
// a block of 1024 holds them, else one; the fold four, two or one, the most
// that keeps its B blocks in the fewest waves (512 blocks at L = 96: two,
// at 4 blocks an SM in one wave; the corpus's 8: four).
template <bool kCofold>
Variant pick(int L, int B) {
  const int mode = inside_mode(L);
  if (mode == 0) return variant<kCofold, 0, 1>(L);
  const int rows = ((L + 31) / 32) * 32;
  Variant v = variant_at<kCofold, 1>(L, mode);
  if (2 * rows > 1024) return v;
  if constexpr (kCofold) {
    return variant_at<kCofold, 2>(L, mode);
  } else {
    const Variant w = variant_at<kCofold, 2>(L, mode);
    if (waves(w, B) <= waves(v, B)) v = w;
    if (4 * rows <= 1024) {
      const Variant x = variant_at<kCofold, 4>(L, mode);
      if (waves(x, B) <= waves(v, B)) v = x;
    }
    return v;
  }
}

Variant pick(int L, int cofold, int B) {
  return cofold ? pick<true>(L, B) : pick<false>(L, B);
}

}  // namespace

// Placement bits (kRingS, kQmS) of the inside scan at L: without kRingS the
// caller passes a device-memory ring of B * 68 * L floats.
extern "C" int rt_inside_mode(int L) { return inside_mode(L); }

// Blocks an SM of the variant launched for B instances at L (0 if the
// runtime cannot say).
extern "C" int rt_inside_occupancy(int L, int cofold, int B) {
  return blocks_per_sm(pick(L, cofold, B));
}

// Threads a row of the variant launched for B instances at L.
extern "C" int rt_inside_threads(int L, int cofold, int B) {
  return pick(L, cofold, B).threads / (((L + 31) / 32) * 32);
}

extern "C" int rt_inside(const float* F, const float* w2k, const float* bulge_k,
                         const float* sig, const float* pows, const int* cut,
                         const int* n, float* qm1, float* qb, float* qm,
                         float* aux, float* q1, float* ring, int B, int L,
                         int cofold, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Variant v = pick(L, cofold, B);
  cudaFuncSetAttribute(v.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)v.smem);
  v.fn<<<B, v.threads, v.smem, st>>>(F, w2k, bulge_k, sig, pows, cut, n, qm1,
                                     qb, qm, aux, q1, ring, B, L);
  return (int)cudaGetLastError();
}
