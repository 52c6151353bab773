// One IMR step on (B, N) plane pairs, shared by the streamK kernels
// (streamk.cu) and the streamed-plane kernels (stream.cu): the matvec
// T(v) = -i H v and its exact real transpose, the forward stage chain
// (neumann, jacobi, split) with stored iterates, its replay, the transposed
// chain, and the step's H cotangent. H lives in shared memory as two
// row-major (N, N) planes with row stride N + 1 (the pad keeps both the row
// reads of T and the column reads of Tt conflict-free); the kernels differ
// only in how H gets there and where its cotangent goes.
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

// Forward step x <- x + dt k on H (split: x rotated by E before and after).
// xs: a (B, N) scratch for the pre-state; kb: iters + 1 (B, N) slots for
// the stage iterates. ksr/ksi: the step's (iters, B, N) slice of the stored
// iterates k_0..k_{iters-1} in global memory, or null. Ends on a barrier
// after the last read of H, so the caller may overwrite it.
__device__ __forceinline__ void stage_fwd(const StepThread& s,
                                          const float* Hr, const float* Hi,
                                          float* xs_r, float* xs_i,
                                          float* kb_r, float* kb_i,
                                          float* ksr, float* ksi, float& xr,
                                          float& xi) {
  const int BN = s.BN, tid = s.tid;
  if (s.act) {
    if (s.split) cmul(s.r0, s.r1, xr, xi);
    xs_r[tid] = xr;
    xs_i[tid] = xi;
  }
  __syncthreads();
  float br = 0.f, bi = 0.f, kr = 0.f, ki = 0.f;
  if (s.act) {
    apply_T(Hr, Hi, xs_r, xs_i, s.b, s.i, s.N, br, bi);
    stage_first(s, br, bi, kr, ki);
    kb_r[tid] = kr;
    kb_i[tid] = ki;
    if (ksr && s.iters > 0) {
      ksr[tid] = kr;
      ksi[tid] = ki;
    }
  }
  __syncthreads();
  for (int j = 0; j < s.iters; ++j) {
    if (s.act) {
      float mr, mi;
      apply_T(Hr, Hi, kb_r + j * BN, kb_i + j * BN, s.b, s.i, s.N, mr, mi);
      stage_next(s, br, bi, mr, mi, kr, ki);
      kb_r[(j + 1) * BN + tid] = kr;
      kb_i[(j + 1) * BN + tid] = ki;
      if (ksr && j + 1 < s.iters) {
        ksr[(j + 1) * BN + tid] = kr;
        ksi[(j + 1) * BN + tid] = ki;
      }
    }
    __syncthreads();
  }
  if (s.act) {
    xr = xr + s.dt * kr;
    xi = xi + s.dt * ki;
    if (s.split) cmul(s.r0, s.r1, xr, xi);
  }
}

// The stage iterates k_0..k_{iters-1} of the step again, from the rotated
// pre-state in xp, into ks (the backward did not store them).
__device__ __forceinline__ void stage_replay(const StepThread& s,
                                             const float* Hr, const float* Hi,
                                             const float* xp_r,
                                             const float* xp_i, float* ks_r,
                                             float* ks_i) {
  const int BN = s.BN, tid = s.tid;
  float br = 0.f, bi = 0.f, kr = 0.f, ki = 0.f;
  if (s.act) {
    apply_T(Hr, Hi, xp_r, xp_i, s.b, s.i, s.N, br, bi);
    stage_first(s, br, bi, kr, ki);
    ks_r[tid] = kr;
    ks_i[tid] = ki;
  }
  __syncthreads();
  for (int j = 1; j < s.iters; ++j) {
    if (s.act) {
      float mr, mi;
      apply_T(Hr, Hi, ks_r + (j - 1) * BN, ks_i + (j - 1) * BN, s.b, s.i,
              s.N, mr, mi);
      stage_next(s, br, bi, mr, mi, kr, ki);
      ks_r[j * BN + tid] = kr;
      ks_i[j * BN + tid] = ki;
    }
    __syncthreads();
  }
}

// Backward step, the exact real transpose of stage_fwd: g, the cotangent of
// the post-step state (its injection added), becomes that of the pre-step
// state x. ksr/ksi: the step's stored iterates in global memory, or null to
// replay them. xp (B, N), ks (iters slots) and cb (iters + 1 slots) are
// shared scratch; on return they hold the step's (cotangent, input) pairs,
// pair p < iters (cb_p, k_{iters-1-p}) and pair iters (cb_iters, xp), the
// input of hb_entry. No barrier at the end.
__device__ __forceinline__ void stage_bwd(const StepThread& s,
                                          const float* Hr, const float* Hi,
                                          float xr, float xi,
                                          const float* ksr, const float* ksi,
                                          float* xp_r, float* xp_i,
                                          float* ks_r, float* ks_i,
                                          float* cb_r, float* cb_i, float& gr,
                                          float& gi) {
  const int BN = s.BN, tid = s.tid, iters = s.iters;
  if (s.act) {
    if (s.split) {            // cotangent and pre-state into the rotated frame
      cmul_conj(s.r0, s.r1, gr, gi);
      cmul(s.r0, s.r1, xr, xi);
    }
    xp_r[tid] = xr;
    xp_i[tid] = xi;
    if (ksr) {
      for (int j = 0; j < iters; ++j) {
        ks_r[j * BN + tid] = ksr[j * BN + tid];
        ks_i[j * BN + tid] = ksi[j * BN + tid];
      }
    }
  }
  __syncthreads();
  if (!ksr && iters > 0) stage_replay(s, Hr, Hi, xp_r, xp_i, ks_r, ks_i);

  // transpose of the stage chain, j = iters..1; pair p = iters - j has
  // input u = k_{j-1}; the last pair (b-bar, x_pre)
  float bbr = 0.f, bbi = 0.f, kbr = s.dt * gr, kbi = s.dt * gi;
  for (int p = 0; p < iters; ++p) {
    float cr = 0.f, ci = 0.f;
    if (s.act) {
      if (s.jac) cmul_conj(s.r2, s.r3, kbr, kbi);   // Wt
      bbr += kbr;
      bbi += kbi;
      cr = s.a * kbr;
      ci = s.a * kbi;
      cb_r[p * BN + tid] = cr;
      cb_i[p * BN + tid] = ci;
    }
    __syncthreads();
    if (s.act) {
      apply_Tt(Hr, Hi, cb_r + p * BN, cb_i + p * BN, s.b, s.i, s.N, kbr, kbi);
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
    cb_r[iters * BN + tid] = bbr;
    cb_i[iters * BN + tid] = bbi;
  }
  __syncthreads();
  if (s.act) {
    float tr, ti;
    apply_Tt(Hr, Hi, cb_r + iters * BN, cb_i + iters * BN, s.b, s.i, s.N, tr,
             ti);
    gr += tr;
    gi += ti;
    if (s.split) cmul_conj(s.r0, s.r1, gr, gi);
  }
}

// Entry ent = (p, q) of the step's H cotangent, Hb[p][q] = sum over the
// pairs stage_bwd left and the rows b of c[b][p] (x) u[b][q] (the
// orientation of pallas_stream.py:481-486).
__device__ __forceinline__ void hb_entry(const StepThread& s, int ent,
                                         const float* xp_r, const float* xp_i,
                                         const float* ks_r, const float* ks_i,
                                         const float* cb_r, const float* cb_i,
                                         float& sr, float& si) {
  const int N = s.N, BN = s.BN, iters = s.iters;
  const int p = ent / N, q = ent - (ent / N) * N;
  sr = 0.f;
  si = 0.f;
  for (int pr = 0; pr <= iters; ++pr) {
    const float* ur = pr < iters ? ks_r + (iters - 1 - pr) * BN : xp_r;
    const float* ui = pr < iters ? ks_i + (iters - 1 - pr) * BN : xp_i;
    const float* cr = cb_r + pr * BN;
    const float* ci = cb_i + pr * BN;
    for (int bb = 0; bb < s.B; ++bb) {
      const float c_r = cr[bb * N + p], c_i = ci[bb * N + p];
      const float u_r = ur[bb * N + q], u_i = ui[bb * N + q];
      sr = fmaf(c_r, u_i, sr);
      sr = fmaf(-c_i, u_r, sr);
      si = fmaf(c_r, u_r, si);
      si = fmaf(c_i, u_i, si);
    }
  }
}

}  // namespace
