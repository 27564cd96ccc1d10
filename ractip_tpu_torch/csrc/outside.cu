// McCaskill outside column scan, fold (K2) and cut-aware cofold (K5).
//
// Replaces ractip_tpu/ops/scan_pallas.py::outside_pallas_streamed
// (_outside_kernel_streamed) and ractip_tpu/ops/cofold_pallas.py::
// co_outside_pallas_streamed (_co_outside_kernel_streamed): one template,
// kCofold adding the cut masks and the exposed-cut spanning-pair adjoints
// (vvec, wvec and the GA build at c + 1 == cut).
//
// What bounds it on the card: like the inside scan it is sequential in the
// column (here from c = n-1 down to 0) and parallel over rows and the
// batch, so latency bounds it: per column a contraction against qm (qm^T
// om and qm^T ash, fused into one pass), the window adjoints (up to 435
// terms a cell) and a rank-1 update of the om table (O(c) per row).
//
// Design: one block per instance, kT threads per row i, splitting the
// row's window, bulges, contraction and om update and summing with
// shuffles.  The rank-1 scatter om[i, m] += ash[i] w1[m] + omcol[i] w2[m]
// has no race because row i's threads own its entries (each its own m).
// The W-deep rolling ob buffers of the TPU kernel become rings of the last
// 32 columns of ob * mout and ob * tau (and the last 4 raw ob columns),
// written once per column.  Placement (kSmem) and threads a row, chosen by
// the launcher: the rings in shared memory where the 68 L floats fit, om
// (L x L) beside them where it fits (L <= 200), and a copy of qm's rows
// l < n, staged once as a packed strict triangle (rows of a warp on
// consecutive banks), where it fits too; four threads a row where a block
// of 1024 holds them, else two or one.  For the fold, where four threads a
// row with om in shared memory need more waves of the batch than two with
// om in device memory (512 blocks at L = 96: 2 blocks an SM against 4),
// the launcher takes the latter.  om is not packed: the outputs below the
// diagonal, which the plain version also computes, read its entries there.
// Loops run only over terms that can be nonzero: ob vanishes in the
// columns past n and in the rows past n + 2 (the stack and small-loop
// terms reach three rows below an inner pair), qm is strictly upper
// triangular and zero past row n, and qm1(m+1, c) needs m <= c-2; so the
// sweep starts at c = n-1 with every carried vector zero, the contraction
// stops at l < min(i, n) and the window at column n-1.  The hot loops are
// unrolled by 4 so that their loads overlap.  Two barriers a column:
// om(., c-1) is final once column c+1 is done (column c updates m <= c-2
// only), so column c already scans it (shuffle scans inside each warp, one
// carry across warps), contracts it with qm together with ash, and sums
// the next column's exposed-cut term; the block sums are warp sums read
// after the next barrier.
#include "dp_common.cuh"

namespace rt {

// kSmem: which of the rings (kRingS), the om table (kOmS) and a packed copy
// of the resident qm table (kQmS) live in shared memory.
template <bool kCofold, int kSmem, int kT>
__global__ void __launch_bounds__(1024) outside_kernel(
    const float* __restrict__ F, const float* __restrict__ qmN_g,
    const float* __restrict__ qm1_g, const float* __restrict__ q1pad_g,
    const float* __restrict__ q2_g, const float* __restrict__ w2k_g,
    const float* __restrict__ bulge_g, const float* __restrict__ sig_g,
    const float* __restrict__ pows_g, const int* __restrict__ cut_g,
    const int* __restrict__ n_g, const float* __restrict__ qxN_g,
    const float* __restrict__ qxA_g, const float* __restrict__ qBpref_g,
    float* om_s, float* ob_o, float* ring_g, int B, int L) {
  extern __shared__ float sh[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int i = tid / kT;                 // the row; kT threads share it
  const int sub = tid % kT;
  const bool lead = sub == 0;             // writes the row's results
  const int Lp = L + 1;
  float* s_w2 = sh;
  float* s_bk = s_w2 + kW * kW;
  float* s_pw = s_bk + kW;
  float* s_red = s_pw + kPow2 + 1;        // [32] warp sums of vval
  float* s_red2 = s_red + 32;             // [32] warp sums of the next hb
  float* s_tot = s_red2 + 32;             // [64] warp totals of the scans
  float* s_omn = s_tot + 64;              // om column c-1
  float* s_qmt = s_omn + Lp;              // qm^T om (read at i-1)
  float* s_pend = s_qmt + Lp;             // qm^T ash (read at i-1)
  float* s_a = s_pend + Lp;               // a = ob fmc sigma^2 (read at l-1)
  float* s_w1 = s_a + Lp;                 // qm1 column c-1, shifted up
  float* s_w2v = s_w1 + Lp;               // qm1 column c, shifted up
  float* s_ga = s_w2v + Lp;               // GA contraction (cofold)
  float* s_vvec = s_ga + Lp;              // spanning-pair adjoints (cofold)
  float* s_wv = s_vvec + Lp;              // wvec (cofold)
  // rings: OM = ob * mout, OA = ob * tau (slot k % 32), R = ob (slot k % 4)
  float* ringM = (kSmem & kRingS) ? s_wv + Lp
                                  : ring_g + (size_t)b * ring_floats(L);
  float* ringA = ringM + (size_t)kRing * L;
  float* ringR = ringA + (size_t)kRing * L;
  const size_t LL = (size_t)L * L;
  // om(i, m) at [m][i]
  float* om = (kSmem & kOmS) ? ringR + (size_t)kRaw * L : om_s + (size_t)b * LL;
  // qm(l, i), l < i, at s_qmT[qrow(l) + i]: row l of the strict upper
  // triangle packed by rows, so the rows i of a warp read consecutive banks
  float* s_qmT = (kSmem & kOmS) ? om + LL : ringR + (size_t)kRaw * L;
  auto qrow = [&](int l) -> int { return l * (L - 2) - tri(l) - 1; };

  for (int t = tid; t < kW * kW; t += blockDim.x)
    s_w2[t] = w2k_g[b * kW * kW + t];
  for (int t = tid; t < kW; t += blockDim.x) s_bk[t] = bulge_g[b * kW + t];
  for (int t = tid; t < kPow2; t += blockDim.x) s_pw[t] = pows_g[b * kPow2 + t];
  for (int t = tid; t < 128 + 9 * Lp; t += blockDim.x) s_red[t] = 0.f;
  const size_t fstride = (size_t)B * LL;
  const float* Fb = F + (size_t)b * LL;
  auto fat = [&](int f, int r, int col) -> float {
    return Fb[f * fstride + (size_t)col * L + r];
  };
  const float* qmN = qmN_g + (size_t)b * LL;    // qm(l, i) at [l][i]
  const float* qm1 = qm1_g + (size_t)b * LL;    // qm1(r, c) at [c][r]
  const float* qxN = kCofold ? qxN_g + (size_t)b * LL : nullptr;
  float* ob = ob_o + (size_t)b * LL;            // ob(i, c) at [c][i]
  const float sg = sig_g[b];
  const int ct = kCofold ? cut_g[b] : 0;
  // the instance's length and the rows whose ob can be nonzero
  const int nb = max(0, min(n_g[b], L));
  const int nr = min(nb + 3, L);
  const bool row = i < L;
  const bool act = i < nr;
  if (act)
    for (int m = sub; m < nb; m += kT) om[(size_t)m * L + i] = 0.f;
  if (row) {
    for (int c = nb + sub; c < L; c += kT) ob[(size_t)c * L + i] = 0.f;
    if (!act)
      for (int c = sub; c < nb; c += kT) ob[(size_t)c * L + i] = 0.f;
  }
  const float q1pad = act ? q1pad_g[(size_t)b * L + i] : 0.f;
  const float qBp = (kCofold && act) ? qBpref_g[(size_t)b * L + i] : 0.f;
  const float J1i = (kCofold && i == ct) ? 0.f : 1.f;
  const int lhi = min(i, nb);              // qm(l, i) != 0 needs l < min(i, n)
  if (kSmem & kQmS) {                      // stage qm's rows l < n once
    for (int l = tid >> 5; l < nb; l += blockDim.x >> 5)
      for (int c = l + 1 + (tid & 31); c < L; c += 32)
        s_qmT[qrow(l) + c] = qmN[(size_t)l * L + c];
  }
  __syncthreads();
  const float smv = s_pw[0];
  constexpr int R = 32 / kT;              // rows a warp
  const float apw = pow_bits(s_pw, (tid & 31) / kT + 1);
  const float aR = pow_bits(s_pw, R);
  // carried into column c: om(i, c), its prefix scans (warp halves; their
  // totals in s_tot), the direct term pend, the exposed-cut sum hb and
  // qm^T om in s_qmt; all 0 at c = n-1
  float omcol = 0.f, pend = 0.f, hb = 0.f, sm1 = 0.f, ga = 0.f, wv = 0.f;
  float sv[kCofold ? 2 : 1] = {};

  for (int c = nb - 1; c >= 0; --c) {
    if (kCofold && c + 1 == ct) {
      // GA[i] = wvec[i-1] + sum_l qx(l, i-1) wvec[l-1]; qx(l, i) needs l <= i
      if (row) {
        float acc = 0.f;
        for (int l = 1 + sub; l <= min(i, nb); l += kT)
          acc += qxN[(size_t)l * L + i] * s_wv[l - 1];
        acc = row_sum<kT>(acc);
        if (lead) s_ga[i] = acc;
      }
      __syncthreads();
      if (row) ga = i >= 1 ? s_wv[i - 1] + s_ga[i - 1] : 0.f;
      __syncthreads();                     // s_wv is rewritten below
    }
    // ---- om1 column c: pending direct term + ml_base prefix scan + qm^T om
    // (the cofold's second prefix scan starts at the cut)
    scan_carry<false>(sv, apw, aR, s_tot);
    const float dterm = (kCofold && i >= ct) ? sv[kCofold ? 1 : 0] : sv[0];
    float obcol = 0.f;
    if (act) {
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
      // the mirrored window's outer pair column k: below n, and (cofold)
      // on the strand side of c, i.e. k < ct while c < ct
      const int khi = (kCofold && c < ct) ? ct - 1 : nb - 1;
      // generic interior (mirror): outer pair (i-u1-1, c+1+u2)
      float gen = 0.f;
      const int u1hi = min(kMaxLoop - 1, i - 1);
      for (int u1 = 1 + sub; u1 <= u1hi; u1 += kT) {
        const int r = i - u1 - 1;
        const int u2hi = min(kMaxLoop - u1, khi - c - 1);
        float acc = 0.f;
#pragma unroll 4
        for (int u2 = 1; u2 <= u2hi; ++u2) {
          const int k = c + 1 + u2;
          acc += ringM[(k & (kRing - 1)) * L + r] * s_w2[u1 * kW + u2];
        }
        gen += (kCofold ? m5(u1 + 1, r, ct) : 1.f) * acc;
      }
      obcol = obcol + row_sum<kT>(gen) * fat(MINN, i, c);
      // bulges of size >= 2 (mirror)
      float b5 = 0.f, b3 = 0.f;
      if (c + 1 <= khi) {
        const int mhi = min(kMaxLoop, i - 1);
#pragma unroll 4
        for (int m = 2 + sub; m <= mhi; m += kT) {
          const int r = i - m - 1;
          b5 += s_bk[m] * (kCofold ? m5(m + 1, r, ct) : 1.f)
                * ringA[((c + 1) & (kRing - 1)) * L + r];
        }
      }
      if (i >= 1) {
        const int r = i - 1;
        const int mhi = min(kMaxLoop, khi - c - 1);
#pragma unroll 4
        for (int m = 2 + sub; m <= mhi; m += kT) {
          const int k = c + 1 + m;
          b3 += ringA[(k & (kRing - 1)) * L + r] * s_bk[m];
        }
        b3 = row_sum<kT>(b3);
        if (kCofold) b3 *= m5(1, r, ct);
      }
      b5 = row_sum<kT>(b5);
      obcol = obcol + fat(TAUR, i, c) * (b5 + b3);
      // stacks, small interiors, 1-bulges (mirror): outer (i-di, c+dj)
      auto sp = [&](int f, int di, int dj) -> float {
        const int r = i - di, k = c + dj;
        return (r >= 0 && k < nb)
                   ? fat(f, r, k) * ringR[(k & (kRaw - 1)) * L + r] : 0.f;
      };
      obcol = obcol + sp(PSTK, 1, 1);
      obcol = obcol + sp(P11, 2, 2);
      obcol = obcol + sp(P21A, 2, 3);
      obcol = obcol + sp(P21B, 3, 2);
      obcol = obcol + sp(P22, 3, 3);
      obcol = obcol + sp(PB15, 2, 1);
      obcol = obcol + sp(PB13, 1, 2);
      if (kCofold) {
        // exposed-cut segments: hb = sum_k vvec[k+1] qx(c+1, k) + vvec[c+1]
        obcol = obcol + (c >= ct ? hb : 0.f) * fat(FE, i, c) * qBp;
        const float qseg = c + 1 < L ? qxA_g[(size_t)b * L + c + 1] : 0.f;
        obcol = obcol + (c < ct ? qseg : 0.f) * fat(FE, i, c) * ga;
      }
      obcol = clamp_huge(obcol);
      if (lead) {
        ringM[(c & (kRing - 1)) * L + i] = obcol * fat(MOUT, i, c);
        ringA[(c & (kRing - 1)) * L + i] = obcol * fat(TAU, i, c);
        ringR[(c & (kRaw - 1)) * L + i] = obcol;
      }
    }
    // ---- scatters feeding later (smaller-c) steps
    if (row && lead) {
      float a = act ? obcol * fat(FMC, i, c) * sg * sg : 0.f;
      if (kCofold) a = m5(1, i, ct) * (a * (c != ct ? 1.f : 0.f));
      s_a[i] = a;
      const float J1n = (kCofold && i + 1 == ct) ? 0.f : 1.f;
      s_w1[i] = (c >= 1 && i + 1 < L) ? qm1[(size_t)(c - 1) * L + i + 1] * J1n
                                       : 0.f;
      s_w2v[i] = i + 1 < L ? qm1[(size_t)c * L + i + 1] * J1n : 0.f;
      // om(i, c-1) is final: column c updates m <= c-2 only
      s_omn[i] = (act && c >= 1) ? om[(size_t)(c - 1) * L + i] : 0.f;
    }
    if (kCofold) {
      const float fcx = act ? fat(FCX, i, c) : 0.f;
      float t = 0.f;
      if (act && lead && i + 1 < L)
        t = obcol * fcx * qxA_g[(size_t)b * L + i + 1];
      warp_sum(t, s_red);
      if (row) {
        const float qxBr = qBpref_g[(size_t)b * L + c];
        wv = wv + (c >= ct ? 1.f : 0.f) * obcol * fcx * qxBr;
        if (lead) s_wv[i] = wv;
      }
    }
    __syncthreads();
    if (kCofold && tid == 0) s_vvec[c] = c >= ct ? sum_red(s_red) : 0.f;
    if (act) {
      const float ash = i >= 1 ? s_a[i - 1] : 0.f;
      // w1[m], w2[m] = qm1(m+1, c-1), qm1(m+1, c) vanish past m = c-2
      if (ash != 0.f || omcol != 0.f) {
#pragma unroll 4
        for (int m = sub; m <= c - 2; m += kT) {
          float* p = om + (size_t)m * L + i;
          *p = *p + ash * s_w1[m] + omcol * s_w2v[m];
        }
      }
      // qm^T ash for this column's pend, qm^T om for column c-1's om1
      float accp = 0.f, accq = 0.f;
#pragma unroll 4
      for (int l = sub; l < lhi; l += kT) {
        const float q = (kSmem & kQmS) ? s_qmT[qrow(l) + i]
                                        : qmN[(size_t)l * L + i];
        if (l >= 1) accp += q * s_a[l - 1];
        accq += q * s_omn[l];
      }
      accp = row_sum<kT>(accp);
      accq = row_sum<kT>(accq);
      if (lead) {
        s_pend[i] = accp;
        s_qmt[i] = accq;
        ob[(size_t)c * L + i] = obcol;
      }
    }
    omcol = row ? s_omn[i] : 0.f;
    sv[0] = omcol;
    if (kCofold) sv[kCofold ? 1 : 0] = i >= ct ? omcol : 0.f;
    warp_scan<false, kT>(sv, s_pw, s_tot);
    if (kCofold) {
      // the next column's hb: qx(c, k) needs k >= c, vvec[k+1] is final
      float t = 0.f;
      if (row && lead && i >= c && i + 1 < L)
        t = s_vvec[i + 1] * qxN[(size_t)c * L + i];
      warp_sum(t, s_red2);
    }
    __syncthreads();
    if (act) pend = (kCofold ? J1i : 1.f) * (i >= 1 ? s_pend[i - 1] : 0.f);
    if (kCofold) hb = sum_red(s_red2) + s_vvec[c];
  }
}

}  // namespace rt

namespace {

using namespace rt;

// Shared memory of a block with placement kSmem (see outside_kernel).
size_t outside_smem(int L, int smem) {
  return sizeof(float) * (kW * kW + kW + kPow2 + 1 + 128 + 9 * (size_t)(L + 1)
                          + ((smem & kRingS) ? ring_floats(L) : 0)
                          + ((smem & kOmS) ? (size_t)L * L : 0)
                          + ((smem & kQmS) ? (size_t)tri(L) : 0));
}

using OutsideFn = void (*)(const float*, const float*, const float*,
                           const float*, const float*, const float*,
                           const float*, const float*, const float*,
                           const int*, const int*, const float*, const float*,
                           const float*, float*, float*, float*, int, int);

// The variant launched at L: its kernel, threads, shared memory, placement.
struct Variant {
  OutsideFn fn;
  int threads;
  size_t smem;
  int mode;
};

template <bool kCofold, int kSmem, int kT>
Variant variant(int L) {
  return {outside_kernel<kCofold, kSmem, kT>, kT * ((L + 31) / 32) * 32,
          outside_smem(L, kSmem), kSmem};
}

// Placement: the rings in shared memory where they fit, then om, then qm
// beside them where each still fits.  Threads a row: four where a block of
// 1024 holds them and the rings are in shared memory, else two or one (om
// and qm fit only where four do).  The fold's batch of B blocks takes, in
// place of that, two threads a row with om in device memory (a smaller
// block, more of them an SM) where that needs fewer waves: 512 blocks at
// L = 96 take one wave so, two with om in shared memory (PERF.md, PR 5).
template <bool kCofold>
Variant pick(int L, int B) {
  const int rows = ((L + 31) / 32) * 32;
  if (outside_smem(L, kRingS) > (size_t)kSmemBlock)
    return variant<kCofold, 0, 1>(L);
  if (4 * rows > 1024)
    return 2 * rows <= 1024 ? variant<kCofold, kRingS, 2>(L)
                            : variant<kCofold, kRingS, 1>(L);
  int mode = kRingS;
  if (outside_smem(L, mode | kOmS) <= (size_t)kSmemBlock) mode |= kOmS;
  if (outside_smem(L, mode | kQmS) <= (size_t)kSmemBlock) mode |= kQmS;
  Variant v;
  switch (mode) {
    case kRingS | kOmS | kQmS:
      v = variant<kCofold, kRingS | kOmS | kQmS, 4>(L);
      break;
    case kRingS | kOmS: v = variant<kCofold, kRingS | kOmS, 4>(L); break;
    case kRingS | kQmS: v = variant<kCofold, kRingS | kQmS, 4>(L); break;
    default: v = variant<kCofold, kRingS, 4>(L);
  }
  if constexpr (!kCofold) {
    if (mode & kQmS) {
      const Variant w = variant<kCofold, kRingS | kQmS, 2>(L);
      if (waves(w, B) < waves(v, B)) return w;
    }
  }
  return v;
}

Variant pick(int L, int cofold, int B) {
  return cofold ? pick<true>(L, B) : pick<false>(L, B);
}

}  // namespace

// Placement bits (kRingS, kOmS, kQmS) of the outside scan of B instances
// at L: without kRingS the caller passes a device-memory ring of
// B * 68 * L floats, without kOmS an om scratch of B * L * L floats.
extern "C" int rt_outside_mode(int L, int cofold, int B) {
  return pick(L, cofold, B).mode;
}

// Blocks an SM of the variant launched for B instances at L (0 if the
// runtime cannot say).
extern "C" int rt_outside_occupancy(int L, int cofold, int B) {
  return blocks_per_sm(pick(L, cofold, B));
}

// Threads a row of the variant launched for B instances at L.
extern "C" int rt_outside_threads(int L, int cofold, int B) {
  return pick(L, cofold, B).threads / (((L + 31) / 32) * 32);
}

extern "C" int rt_outside(const float* F, const float* qm, const float* qm1,
                          const float* q1pad, const float* q2, const float* w2k,
                          const float* bulge_k, const float* sig,
                          const float* pows, const int* cut, const int* n,
                          const float* qx, const float* qxA,
                          const float* qBpref, float* om, float* ob,
                          float* ring, int B, int L, int cofold,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Variant v = pick(L, cofold, B);
  cudaFuncSetAttribute(v.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)v.smem);
  v.fn<<<B, v.threads, v.smem, st>>>(F, qm, qm1, q1pad, q2, w2k, bulge_k,
                                     sig, pows, cut, n, qx, qxA, qBpref, om,
                                     ob, ring, B, L);
  return (int)cudaGetLastError();
}
