// One IMR step on (B, N) plane pairs, shared by the streamK kernels
// (streamk.cu) and the streamed-plane kernels (stream.cu): the matvec
// T(v) = -i H v and its exact real transpose, the forward stage chain
// (neumann, jacobi, split) with stored iterates, its replay, the transposed
// chain, and the step's H cotangent. H lives in shared memory as two
// row-major (N, N) planes with row stride N + 1 (the pad keeps both the row
// reads of T and the column reads of Tt conflict-free); the kernels differ
// only in how H gets there and where its cotangent goes. The first part of
// the file is the algebra of one stage (T, its transpose, the solver rows);
// the second part is the step, both directions, for a block split into
// roles (the state threads' chain, H's contraction or copy, and its
// cotangent), which every kernel of streamk.cu and stream.cu runs.
//   * neumann  k <- b + a T(k)                    (a = dt/2, b = T(x))
//   * jacobi   k <- Minv (b + a (T(k) - d k)),     Minv = 1/(1 - a d)
//   * split    x <- E (x + dt k(V)) with x first rotated by E = exp(a d) and
//              V the off-diagonal remainder.
#pragma once

namespace {

enum { MODE_NEUMANN = 0, MODE_JACOBI = 1, MODE_SPLIT = 2 };

// Entry (b, i) of T(v) = -i H v: (Im (Hv)_i, -Re (Hv)_i).
__device__ __forceinline__ void apply_T(const float* Hr, const float* Hi,
                                        const float* vr, const float* vi,
                                        int b, int i, int N, float& outr,
                                        float& outi) {
  const float* hr = Hr + i * (N + 1);
  const float* hi = Hi + i * (N + 1);
  const float* xr = vr + b * N;
  const float* xi = vi + b * N;
  float ar = 0.f, ai = 0.f;
  for (int j = 0; j < N; ++j) {
    ar = fmaf(hr[j], xr[j], ar);
    ar = fmaf(-hi[j], xi[j], ar);
    ai = fmaf(hr[j], xi[j], ai);
    ai = fmaf(hi[j], xr[j], ai);
  }
  outr = ai;
  outi = -ar;
}

// Entry (b, q) of the real transpose of T applied to the cotangent u.
__device__ __forceinline__ void apply_Tt(const float* Hr, const float* Hi,
                                         const float* ur, const float* ui,
                                         int b, int q, int N, float& outr,
                                         float& outi) {
  const int ld = N + 1;
  const float* cr = ur + b * N;
  const float* ci = ui + b * N;
  float sr = 0.f, si = 0.f;
  for (int p = 0; p < N; ++p) {
    const float hr = Hr[p * ld + q], hi = Hi[p * ld + q];
    sr = fmaf(cr[p], hi, sr);
    sr = fmaf(-ci[p], hr, sr);
    si = fmaf(cr[p], hr, si);
    si = fmaf(ci[p], hi, si);
  }
  outr = sr;
  outi = si;
}

// elementwise complex products with the per-entry solver rows
__device__ __forceinline__ void cmul(float ar, float ai, float& vr,
                                     float& vi) {  // v <- a v
  const float r = ar * vr - ai * vi;
  vi = ai * vr + ar * vi;
  vr = r;
}

// v <- a v with the products rounded as the one-block forward rounded its
// pre-state rotation, and as stream_bwd's replay (chain_step) still does:
// the FMA takes ar vr in the real part and ai vr in the imaginary part.
// cmul leaves that choice to nvcc, which takes ar vi in the imaginary part
// in some inlined contexts (fwd_chain_step's, read from the SASS), so
// stored and replayed iterates would no longer agree in bits.
__device__ __forceinline__ void cmul_pre(float ar, float ai, float& vr,
                                         float& vi) {
  const float r = fmaf(ar, vr, -__fmul_rn(ai, vi));
  vi = fmaf(ai, vr, __fmul_rn(ar, vi));
  vr = r;
}

__device__ __forceinline__ void cmul_conj(float ar, float ai, float& vr,
                                          float& vi) {  // v <- conj(a) v
  const float r = ar * vr + ai * vi;
  vi = ar * vi - ai * vr;
  vr = r;
}

// What one thread of a step needs: it owns state entry (b, i) of the (B, N)
// planes when act (tid < B N), with that entry's solver rows: jacobi
// (d_r, d_i, minv_r, minv_i) or split (e_r, e_i), each row (N,).
struct StepThread {
  int N, B, BN, iters, tid, b, i;
  bool act, jac, split;
  float dt, a, r0, r1, r2, r3;
};

__device__ __forceinline__ StepThread step_thread(int B, int N, int iters,
                                                  int mode, float dt, float a,
                                                  const float* rows) {
  StepThread s;
  s.N = N;
  s.B = B;
  s.BN = B * N;
  s.iters = iters;
  s.tid = threadIdx.x;
  s.b = s.tid / N;
  s.i = s.tid - s.b * N;
  s.act = s.tid < s.BN;
  s.jac = mode == MODE_JACOBI;
  s.split = mode == MODE_SPLIT;
  s.dt = dt;
  s.a = a;
  s.r0 = s.r1 = s.r2 = s.r3 = 0.f;
  if (s.act) {
    if (s.jac || s.split) {
      s.r0 = rows[s.i];
      s.r1 = rows[N + s.i];
    }
    if (s.jac) {
      s.r2 = rows[2 * N + s.i];
      s.r3 = rows[3 * N + s.i];
    }
  }
  return s;
}

// The first stage iterate k_0 from b = T(x), and k_{j+1} from m = T(k_j).
__device__ __forceinline__ void stage_first(const StepThread& s, float br,
                                            float bi, float& kr, float& ki) {
  kr = br;
  ki = bi;
  if (s.jac) cmul(s.r2, s.r3, kr, ki);
}

__device__ __forceinline__ void stage_next(const StepThread& s, float br,
                                           float bi, float mr, float mi,
                                           float& kr, float& ki) {
  if (s.jac) {
    const float ur = mr - (s.r0 * kr - s.r1 * ki);
    const float ui = mi - (s.r0 * ki + s.r1 * kr);
    kr = br + s.a * ur;
    ki = bi + s.a * ui;
    cmul(s.r2, s.r3, kr, ki);
  } else {
    kr = br + s.a * mr;
    ki = bi + s.a * mi;
  }
}

// ---------------------------------------------------------------------------
// The step on a block split into roles (streamk_fwd, streamk_bwd,
// stream_fwd, stream_bwd): the S state threads run the chain and nothing
// else, other warps contract or copy H and reduce its cotangent beside
// them. The algebra of apply_T above and of its exact transpose, with
// the step's operands in registers (H's row or column, and in the backward
// the history loaded a step ahead), the backward's (cotangent, input) pairs
// left in a ring slot for the other roles, stage syncs over the state
// threads only, and a compile-time N (NC > 0) that unrolls the matvecs over
// registers.

// named barrier 1 (0 is __syncthreads): the state warps, where a stage's
// states span warps; a kernel's own hand-offs take ids from 2
enum { BAR_STATE = 1 };

constexpr int MAX_STORED = 4;   // stored iterates a state thread prefetches

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// One float from global into shared memory by cp.async, which does not
// stall the thread; cp_async_wait() waits for all of the thread's copies (a
// barrier after it shows them to the block).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Entries first, first + step, ... of a coefficient row into shared memory.
__device__ __forceinline__ void stage_row(float* dst, const float* src,
                                          int Ke, int first, int step) {
  for (int k = first; k < Ke; k += step) cp_async4(dst + k, src + k);
}

// Entries e0, e0 + ne, ... of one step's (N, N) plane pair, row-major in
// global memory (coalesced over consecutive e0), into shared memory with
// row stride N + 1.
template <int NC>
__device__ __forceinline__ void copy_planes(const float* gr, const float* gi,
                                            float* Hr, float* Hi, int N,
                                            int e0, int ne) {
  const int n = NC ? NC : N, NN = n * n;
  for (int e = e0; e < NN; e += ne) {
    const int p = e / n, q = e - p * n;
    cp_async4(Hr + p * (n + 1) + q, gr + e);
    cp_async4(Hi + p * (n + 1) + q, gi + e);
  }
}

// One slot of the pairs ring, each (B, N) re/im: the rotated pre-state xp,
// the stage iterates k_0..k_{it-1} and the cotangents cb_0..cb_it. Pair
// p < it is (cb_p, k_{it-1-p}), pair it is (cb_it, xp) (chain_step's).
struct Pairs {
  float *xr, *xi, *kr, *ki, *cr, *ci;
};

__device__ __forceinline__ Pairs pairs_slot(float* P, int BN, int it) {
  Pairs q;
  q.xr = P;
  q.xi = P + BN;
  q.kr = P + 2 * BN;
  q.ki = q.kr + it * BN;
  q.cr = q.ki + it * BN;
  q.ci = q.cr + (it + 1) * BN;
  return q;
}

// A state thread's operands of one reversed step: the pre-state (x0 at
// t = 0, else the previous history entry), the history cotangent and,
// when stored, the stage iterates.
struct StepOps {
  float xr, xi, jr, ji, kr[MAX_STORED], ki[MAX_STORED];
};

__device__ __forceinline__ void load_ops(
    const StepThread& s, int t, size_t st, const float* __restrict__ x0r,
    const float* __restrict__ x0i, const float* __restrict__ hr,
    const float* __restrict__ hi, const float* __restrict__ jr,
    const float* __restrict__ ji, const float* __restrict__ ksr,
    const float* __restrict__ ksi, StepOps& o) {
  if (!s.act) return;
  const size_t BN = s.BN, at = st * BN + s.tid;
  o.jr = jr[at];
  o.ji = ji[at];
  o.xr = t == 0 ? x0r[s.tid] : hr[at - BN];
  o.xi = t == 0 ? x0i[s.tid] : hi[at - BN];
  if (ksr) {
    const size_t ko = st * s.iters * BN + s.tid;
#pragma unroll
    for (int j = 0; j < MAX_STORED; ++j)
      if (j < s.iters) {
        o.kr[j] = ksr[ko + j * BN];
        o.ki[j] = ksi[ko + j * BN];
      }
  }
}

// The end of a stage: a state's N entries are written for its threads.
__device__ __forceinline__ void stage_sync(bool warp_rows, int S) {
  if (warp_rows)
    __syncwarp();
  else
    bar_sync(BAR_STATE, S);
}

// A chain thread's column q of H(t) (Tt reads H by columns), held in
// registers for the step where N is the compile-time NC.
template <int NC>
struct HCol {
  float r[NC > 0 ? NC : 1], i[NC > 0 ? NC : 1];
};

template <int NC>
__device__ __forceinline__ void load_col(const float* Hr, const float* Hi,
                                         int q, HCol<NC>& h) {
  if constexpr (NC > 0) {
#pragma unroll
    for (int p = 0; p < NC; ++p) {
      h.r[p] = Hr[p * (NC + 1) + q];
      h.i[p] = Hi[p * (NC + 1) + q];
    }
  }
}

// A chain thread's row i of H(t) (T reads H by rows), held in registers
// for the step where N is the compile-time NC.
template <int NC>
struct HRow {
  float r[NC > 0 ? NC : 1], i[NC > 0 ? NC : 1];
};

template <int NC>
__device__ __forceinline__ void load_hrow(const float* Hr, const float* Hi,
                                          int i, HRow<NC>& h) {
  if constexpr (NC > 0) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      h.r[j] = Hr[i * (NC + 1) + j];
      h.i[j] = Hi[i * (NC + 1) + j];
    }
  }
}

// A (NC,) row of a plane in shared memory into registers, 16 bytes a load
// (the rows of the (B, N) planes start on 16-byte boundaries).
template <int NC>
__device__ __forceinline__ void load_row(const float* v, float (&out)[NC]) {
  static_assert(NC % 4 == 0, "rows of whole float4s");
  const float4* v4 = reinterpret_cast<const float4*>(v);
#pragma unroll
  for (int m = 0; m < NC / 4; ++m) {
    const float4 t = v4[m];
    out[4 * m] = t.x;
    out[4 * m + 1] = t.y;
    out[4 * m + 2] = t.z;
    out[4 * m + 3] = t.w;
  }
}

// T (and below, its real transpose Tt applied to a cotangent; NC: the
// compile-time N, or 0) with the two products of each output on their own
// accumulators, and at a compile-time N also the even and odd terms:
// dependent chains of N / 2 FMAs, not 2 N.
template <int NC>
__device__ __forceinline__ void apply_T_n(const float* Hr, const float* Hi,
                                          const float* vr, const float* vi,
                                          int b, int i, int N, float& outr,
                                          float& outi) {
  const int n = NC ? NC : N;
  const float* hr = Hr + i * (n + 1);
  const float* hi = Hi + i * (n + 1);
  float a[8] = {};          // ar0, ar1, ai0, ai1 of the even and odd terms
  if constexpr (NC > 0) {
    float xr[NC], xi[NC];
    load_row<NC>(vr + b * NC, xr);
    load_row<NC>(vi + b * NC, xi);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      float* c = a + 4 * (j & 1);
      c[0] = fmaf(hr[j], xr[j], c[0]);
      c[1] = fmaf(-hi[j], xi[j], c[1]);
      c[2] = fmaf(hr[j], xi[j], c[2]);
      c[3] = fmaf(hi[j], xr[j], c[3]);
    }
  } else {
    const float* xr = vr + b * n;
    const float* xi = vi + b * n;
    for (int j = 0; j < n; ++j) {
      a[0] = fmaf(hr[j], xr[j], a[0]);
      a[1] = fmaf(-hi[j], xi[j], a[1]);
      a[2] = fmaf(hr[j], xi[j], a[2]);
      a[3] = fmaf(hi[j], xr[j], a[3]);
    }
  }
  outr = (a[2] + a[6]) + (a[3] + a[7]);
  outi = -((a[0] + a[4]) + (a[1] + a[5]));
}

// apply_T with row i of H from registers at a compile-time N, the state
// row read 16 bytes a load: the same terms in the same order, so the same
// bits as apply_T; apply_T itself at NC = 0.
template <int NC>
__device__ __forceinline__ void apply_T_row(const HRow<NC>& h,
                                            const float* Hr, const float* Hi,
                                            const float* vr, const float* vi,
                                            int b, int i, int N, float& outr,
                                            float& outi) {
  if constexpr (NC > 0) {
    float xr[NC], xi[NC];
    load_row<NC>(vr + b * NC, xr);
    load_row<NC>(vi + b * NC, xi);
    float ar = 0.f, ai = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      ar = fmaf(h.r[j], xr[j], ar);
      ar = fmaf(-h.i[j], xi[j], ar);
      ai = fmaf(h.r[j], xi[j], ai);
      ai = fmaf(h.i[j], xr[j], ai);
    }
    outr = ai;
    outi = -ar;
  } else {
    apply_T(Hr, Hi, vr, vi, b, i, N, outr, outi);
  }
}

// One forward step x <- x + dt k of the chain (split: x rotated by E before
// and after), run by all S state threads, on H's row h (registers at
// NC > 0, else the planes Hr, Hi): apply_T's order of terms. The
// matvec inputs x, k_0, ..., k_{iters-1} go in turn to the two (B, N) slots
// of V (slot q: re at V + 2 q BN, im after it), p the slot the next one
// takes: stage j reads only k_{j-1}, and a stage sync lies between a
// slot's last read and its next write, also across steps. ksr/ksi: the
// step's (iters, B, N) slice of the stored iterates, or null. iters + 1
// stage syncs. PRE_RN: the split pre-state rotation by cmul_pre (stream_fwd,
// whose stored iterates stream_bwd's replay must reproduce), else by cmul.
template <int NC, bool PRE_RN = false>
__device__ __forceinline__ void fwd_chain_step(const StepThread& s,
                                               const HRow<NC>& h,
                                               const float* Hr,
                                               const float* Hi, float* V,
                                               int& p, float* ksr, float* ksi,
                                               bool warp_rows, int S,
                                               float& xr, float& xi) {
  const int BN = s.BN, tid = s.tid;
  if (s.act) {
    if (s.split) {
      if constexpr (PRE_RN)
        cmul_pre(s.r0, s.r1, xr, xi);
      else
        cmul(s.r0, s.r1, xr, xi);
    }
    V[2 * p * BN + tid] = xr;
    V[(2 * p + 1) * BN + tid] = xi;
  }
  stage_sync(warp_rows, S);
  float br = 0.f, bi = 0.f, kr = 0.f, ki = 0.f;
  if (s.act) {
    apply_T_row<NC>(h, Hr, Hi, V + 2 * p * BN, V + (2 * p + 1) * BN, s.b,
                    s.i, s.N, br, bi);
    stage_first(s, br, bi, kr, ki);
    if (ksr && s.iters > 0) {
      ksr[tid] = kr;
      ksi[tid] = ki;
    }
  }
  for (int j = 0; j < s.iters; ++j) {
    p ^= 1;
    if (s.act) {
      V[2 * p * BN + tid] = kr;
      V[(2 * p + 1) * BN + tid] = ki;
    }
    stage_sync(warp_rows, S);
    if (s.act) {
      float mr, mi;
      apply_T_row<NC>(h, Hr, Hi, V + 2 * p * BN, V + (2 * p + 1) * BN, s.b,
                      s.i, s.N, mr, mi);
      stage_next(s, br, bi, mr, mi, kr, ki);
      if (ksr && j + 1 < s.iters) {
        ksr[(j + 1) * BN + tid] = kr;
        ksi[(j + 1) * BN + tid] = ki;
      }
    }
  }
  p ^= 1;
  if (s.act) {
    xr = xr + s.dt * kr;
    xi = xi + s.dt * ki;
    if (s.split) cmul(s.r0, s.r1, xr, xi);
  }
}

template <int NC>
__device__ __forceinline__ void apply_Tt_n(const HCol<NC>& hc,
                                           const float* Hr, const float* Hi,
                                           const float* ur, const float* ui,
                                           int b, int q, int N, float& outr,
                                           float& outi) {
  float a[8] = {};          // sr0, sr1, si0, si1 of the even and odd terms
  if constexpr (NC > 0) {
    float cr[NC], ci[NC];
    load_row<NC>(ur + b * NC, cr);
    load_row<NC>(ui + b * NC, ci);
#pragma unroll
    for (int p = 0; p < NC; ++p) {
      float* c = a + 4 * (p & 1);
      c[0] = fmaf(cr[p], hc.i[p], c[0]);
      c[1] = fmaf(-ci[p], hc.r[p], c[1]);
      c[2] = fmaf(cr[p], hc.r[p], c[2]);
      c[3] = fmaf(ci[p], hc.i[p], c[3]);
    }
  } else {
    const int ld = N + 1;
    const float* cr = ur + b * N;
    const float* ci = ui + b * N;
    for (int p = 0; p < N; ++p) {
      const float hr = Hr[p * ld + q], hi = Hi[p * ld + q];
      a[0] = fmaf(cr[p], hi, a[0]);
      a[1] = fmaf(-ci[p], hr, a[1]);
      a[2] = fmaf(cr[p], hr, a[2]);
      a[3] = fmaf(ci[p], hi, a[3]);
    }
  }
  outr = (a[0] + a[4]) + (a[1] + a[5]);
  outi = (a[2] + a[6]) + (a[3] + a[7]);
}

// apply_Tt with column q of H from registers at a compile-time N, the
// cotangent row read 16 bytes a load: the same terms in the same order (one
// chain of 2 N FMAs per output), so the same bits as apply_Tt; apply_Tt
// itself at NC = 0.
template <int NC>
__device__ __forceinline__ void apply_Tt_col(const HCol<NC>& hc,
                                             const float* Hr, const float* Hi,
                                             const float* ur, const float* ui,
                                             int b, int q, int N, float& outr,
                                             float& outi) {
  if constexpr (NC > 0) {
    float cr[NC], ci[NC];
    load_row<NC>(ur + b * NC, cr);
    load_row<NC>(ui + b * NC, ci);
    float sr = 0.f, si = 0.f;
#pragma unroll
    for (int p = 0; p < NC; ++p) {
      sr = fmaf(cr[p], hc.i[p], sr);
      sr = fmaf(-ci[p], hc.r[p], sr);
      si = fmaf(cr[p], hc.r[p], si);
      si = fmaf(ci[p], hc.i[p], si);
    }
    outr = sr;
    outi = si;
  } else {
    apply_Tt(Hr, Hi, ur, ui, b, q, N, outr, outi);
  }
}

// One reversed step of the chain, run by all S state threads: the exact
// real transpose of fwd_chain_step. g, the cotangent of the post-step state
// (the history cotangent o.j added), becomes that of the pre-step state; the
// step's pairs are left in q for Hb: pair p < it is (cb_p, k_{it-1-p}),
// pair it is (cb_it, xp). Without stored iterates the chain first replays
// k_0..k_{it-1} from xp. ONE_CHAIN: every output of T and Tt summed on one
// chain of 2 N FMAs in apply_T's and apply_Tt's order (H's row, then its
// column, in registers at NC > 0), so the replayed iterates have the bits
// of the ones fwd_chain_step stored, at any NC (stream_bwd); otherwise on
// apply_T_n's and apply_Tt_n's eight accumulators, N / 2 FMAs deep
// (streamk_bwd).
template <int NC, bool ONE_CHAIN = false>
__device__ __forceinline__ void chain_step(const StepThread& s,
                                           const float* Hr, const float* Hi,
                                           const Pairs& q, const StepOps& o,
                                           bool stored, bool warp_rows, int S,
                                           float& gr, float& gi) {
  const int BN = s.BN, tid = s.tid, it = s.iters;
  HCol<NC> hc;
  if constexpr (!ONE_CHAIN) load_col<NC>(Hr, Hi, s.i, hc);
  if (s.act) {
    float xr = o.xr, xi = o.xi;
    gr += o.jr;
    gi += o.ji;
    if (s.split) {            // cotangent and pre-state into the rotated frame
      cmul_conj(s.r0, s.r1, gr, gi);
      cmul(s.r0, s.r1, xr, xi);
    }
    q.xr[tid] = xr;
    q.xi[tid] = xi;
    if (stored) {
#pragma unroll
      for (int j = 0; j < MAX_STORED; ++j)
        if (j < it) {
          q.kr[j * BN + tid] = o.kr[j];
          q.ki[j * BN + tid] = o.ki[j];
        }
    }
  }
  if (!stored && it > 0) {    // replay k_0..k_{it-1} from xp
    float br = 0.f, bi = 0.f, kr = 0.f, ki = 0.f;
    HRow<NC> h;
    if constexpr (ONE_CHAIN) load_hrow<NC>(Hr, Hi, s.i, h);
    auto T = [&](const float* vr, const float* vi, float& outr, float& outi) {
      if constexpr (ONE_CHAIN)
        apply_T_row<NC>(h, Hr, Hi, vr, vi, s.b, s.i, s.N, outr, outi);
      else
        apply_T_n<NC>(Hr, Hi, vr, vi, s.b, s.i, s.N, outr, outi);
    };
    stage_sync(warp_rows, S);
    if (s.act) {
      T(q.xr, q.xi, br, bi);
      stage_first(s, br, bi, kr, ki);
      q.kr[tid] = kr;
      q.ki[tid] = ki;
    }
    for (int j = 1; j < it; ++j) {
      stage_sync(warp_rows, S);
      if (s.act) {
        float mr, mi;
        T(q.kr + (j - 1) * BN, q.ki + (j - 1) * BN, mr, mi);
        stage_next(s, br, bi, mr, mi, kr, ki);
        q.kr[j * BN + tid] = kr;
        q.ki[j * BN + tid] = ki;
      }
    }
  }
  if constexpr (ONE_CHAIN) load_col<NC>(Hr, Hi, s.i, hc);
  auto Tt = [&](const float* ur, const float* ui, float& outr, float& outi) {
    if constexpr (ONE_CHAIN)
      apply_Tt_col<NC>(hc, Hr, Hi, ur, ui, s.b, s.i, s.N, outr, outi);
    else
      apply_Tt_n<NC>(hc, Hr, Hi, ur, ui, s.b, s.i, s.N, outr, outi);
  };
  // transpose of the stage chain, j = it..1; pair p = it - j has input
  // u = k_{j-1}; the last pair (b-bar, x_pre)
  float bbr = 0.f, bbi = 0.f, kbr = s.dt * gr, kbi = s.dt * gi;
  for (int p = 0; p < it; ++p) {
    float cr = 0.f, ci = 0.f;
    if (s.act) {
      if (s.jac) cmul_conj(s.r2, s.r3, kbr, kbi);   // Wt
      bbr += kbr;
      bbi += kbi;
      cr = s.a * kbr;
      ci = s.a * kbi;
      q.cr[p * BN + tid] = cr;
      q.ci[p * BN + tid] = ci;
    }
    stage_sync(warp_rows, S);
    if (s.act) {
      Tt(q.cr + p * BN, q.ci + p * BN, kbr, kbi);
      if (s.jac) {              // minus the transpose of v -> d v
        kbr -= s.r0 * cr + s.r1 * ci;
        kbi -= s.r0 * ci - s.r1 * cr;
      }
    }
  }
  if (s.act) {
    if (s.jac) cmul_conj(s.r2, s.r3, kbr, kbi);
    bbr += kbr;
    bbi += kbi;
    q.cr[it * BN + tid] = bbr;
    q.ci[it * BN + tid] = bbi;
  }
  stage_sync(warp_rows, S);
  if (s.act) {
    float tr, ti;
    Tt(q.cr + it * BN, q.ci + it * BN, tr, ti);
    gr += tr;
    gi += ti;
    if (s.split) cmul_conj(s.r0, s.r1, gr, gi);
  }
}

// Entries e0, e0 + ne, ... of H = sum_k c_k S_k from a coefficient row in
// shared memory, one fmaf chain per entry in k order, so both directions of
// streamk.cu step on the same bits of H. At a compile-time N a thread
// takes the entries in pairs (2 e0, 2 e0 + 1), ..., reading the stacks 8
// bytes a load.
template <int NC>
__device__ __forceinline__ void contract_part(const float* Sr, const float* Si,
                                              const float* c, float* Hr,
                                              float* Hi, int Ke, int N,
                                              int e0, int ne) {
  if constexpr (NC > 0) {
    constexpr int NN = NC * NC, ld = NC + 1;
    for (int e = 2 * e0; e < NN; e += 2 * ne) {
      float hr0 = 0.f, hr1 = 0.f, hi0 = 0.f, hi1 = 0.f;
#pragma unroll 8
      for (int k = 0; k < Ke; ++k) {
        const float ck = c[k];
        const float2 sr = *reinterpret_cast<const float2*>(Sr + k * NN + e);
        const float2 si = *reinterpret_cast<const float2*>(Si + k * NN + e);
        hr0 = fmaf(ck, sr.x, hr0);
        hr1 = fmaf(ck, sr.y, hr1);
        hi0 = fmaf(ck, si.x, hi0);
        hi1 = fmaf(ck, si.y, hi1);
      }
      const int p = e / NC, q = e - p * NC;
      Hr[p * ld + q] = hr0;
      Hr[p * ld + q + 1] = hr1;
      Hi[p * ld + q] = hi0;
      Hi[p * ld + q + 1] = hi1;
    }
  } else {
    const int NN = N * N, ld = N + 1;
    for (int e = e0; e < NN; e += ne) {
      float hr = 0.f, hi = 0.f;
#pragma unroll 8
      for (int k = 0; k < Ke; ++k) {
        const float ck = c[k];
        hr = fmaf(ck, Sr[k * NN + e], hr);
        hi = fmaf(ck, Si[k * NN + e], hi);
      }
      const int p = e / N, q = e - p * N;
      Hr[p * ld + q] = hr;
      Hi[p * ld + q] = hi;
    }
  }
}

// Entries e0, e0 + ne, ... of the step's H cotangent, Hb[p][q] = sum over
// the pairs and the rows b of c[b][p] (x) u[b][q] (the orientation of
// pallas_stream.py:481-486). ONE_CHAIN: both products of each output on
// one chain in pair and row order (stream_bwd); otherwise each product on
// its own accumulator (streamk_bwd). At a compile-time N a thread takes the
// entries in pairs, as contract_part.
template <int NC, bool ONE_CHAIN = false>
__device__ __forceinline__ void hb_part(const Pairs& q, float* Hbr,
                                        float* Hbi, int B, int N, int it,
                                        int e0, int ne) {
  const int n = NC ? NC : N, NN = n * n, BN = B * n, w = NC ? 2 : 1;
  constexpr int o = ONE_CHAIN ? 0 : 1;    // the second product's accumulator
  for (int ent = w * e0; ent < NN; ent += w * ne) {
    const int p = ent / n, qq = ent - p * n;
    float a[8] = {};        // sr0, sr1, si0, si1 of entries qq and qq + 1
    for (int pr = 0; pr <= it; ++pr) {
      const float* ur = pr < it ? q.kr + (it - 1 - pr) * BN : q.xr;
      const float* ui = pr < it ? q.ki + (it - 1 - pr) * BN : q.xi;
      const float* cr = q.cr + pr * BN;
      const float* ci = q.ci + pr * BN;
#pragma unroll 4
      for (int bb = 0; bb < B; ++bb) {
        const float c_r = cr[bb * n + p], c_i = ci[bb * n + p];
        if constexpr (NC > 0) {
          const float2 u_r =
              *reinterpret_cast<const float2*>(ur + bb * NC + qq);
          const float2 u_i =
              *reinterpret_cast<const float2*>(ui + bb * NC + qq);
          a[0] = fmaf(c_r, u_i.x, a[0]);
          a[o] = fmaf(-c_i, u_r.x, a[o]);
          a[2] = fmaf(c_r, u_r.x, a[2]);
          a[2 + o] = fmaf(c_i, u_i.x, a[2 + o]);
          a[4] = fmaf(c_r, u_i.y, a[4]);
          a[4 + o] = fmaf(-c_i, u_r.y, a[4 + o]);
          a[6] = fmaf(c_r, u_r.y, a[6]);
          a[6 + o] = fmaf(c_i, u_i.y, a[6 + o]);
        } else {
          const float u_r = ur[bb * n + qq], u_i = ui[bb * n + qq];
          a[0] = fmaf(c_r, u_i, a[0]);
          a[o] = fmaf(-c_i, u_r, a[o]);
          a[2] = fmaf(c_r, u_r, a[2]);
          a[2 + o] = fmaf(c_i, u_i, a[2 + o]);
        }
      }
    }
    Hbr[ent] = ONE_CHAIN ? a[0] : a[0] + a[1];
    Hbi[ent] = ONE_CHAIN ? a[2] : a[2] + a[3];
    if constexpr (NC > 0) {
      Hbr[ent + 1] = ONE_CHAIN ? a[4] : a[4] + a[5];
      Hbi[ent + 1] = ONE_CHAIN ? a[6] : a[6] + a[7];
    }
  }
}

}  // namespace
