// Density-matrix (Lindblad) propagation kernels for Hopper (sm_90a): the
// whole IMR time loop of d rho/dt = T(rho) in ONE launch per direction, with
// the state an (N, N) complex matrix and the generator applied as two-sided
// matrix products computed in the kernel body:
//
//   T(rho) = M rho + rho M^dag + sum_l L_l rho L_l^dag,   M = -i H_eff(t),
//   H_eff(t) = sum_k c_k(t) S_k  (the -i/2 sum L^dag L fold sits in S_0).
//
// Replaces quandary_tpu/ops/pallas_rho.py::make_rho_propagate (the TPU kernel
// pair: forward pallas_call at :374, backward at :494) with the step core it
// inlines (pallas_stream.py::_stage_fwd :217, _stage_bwd :331). Same contract
// and the same algebra:
//   * neumann  k <- b + a T(k)                    (a = dt/2, b = T(x))
//   * jacobi   k <- Minv (b + a (T(k) - d k)),     Minv = 1/(1 - a d)
//   * split    x <- E (x + dt k) with x first rotated by E = exp(a d), and the
//              diagonal d subtracted inside T (no extra stack slot);
// d, Minv and E are (N, N) planes applied entry by entry. The backward is the
// exact real transpose of the computed step,
//   Tt(g) = M^dag g + g M + sum_l L_l^dag g L_l,
// and the H_eff cotangent of a step, from every (cotangent c at T's output,
// input u of that T) pair, W = sum_pairs (c u^dag + c^dag u), dA_i = Re W,
// dA_r = -Im W, is reduced in-kernel against every stack slot into
// Cb[t, k] = <dA_r, Sr_k> + <dA_i, Si_k> (pallas_rho.py:464-486). Stack and
// jump-operator cotangents are not computed (zero by the same contract).
//
// Layout: one thread block per (control candidate, initial condition); the
// sequential time loop runs inside the block (the TPU's sequential grid
// axis). A thread owns a TS x TS set of matrix entries, strided by the tile
// count so that neighbouring lanes read neighbouring columns; entries past N
// compute on clamped indices and are never written. M, the operand of the
// current product, the jump intermediate L v and one more (N, N) pair live in
// shared memory (8 planes, row stride N | 1 so that transposed reads of M
// for the M^dag factors are free of bank conflicts); the stacks, the jump
// planes and the entrywise solver planes are read from global memory (a few
// hundred KB, resident in L2). Nothing is padded: the 128-lane tiles, Hs rows
// and lane-group packing of the TPU kernel have no counterpart here.
// Arithmetic is exact f32 FMA on the CUDA cores (the TPU kernel's default is
// a 3-pass bf16 emulation of f32 matmuls).
//
// What bounds it on the H100: operations, on the few SMs that have a block.
// One T is (8 + 8 J) real N^3 products, 21 MFLOP at N = 64 with 4 jump
// operators, and a step runs iters + 1 of them in a dependent chain; a
// launch has E * B blocks, so at E = 1 most of the 132 SMs idle. Spreading a
// density matrix over a cluster and tensor-core products are later work.

#include <cuda_runtime.h>

namespace {

enum { MODE_NEUMANN = 0, MODE_JACOBI = 1, MODE_SPLIT = 2 };

struct Dims {
  int E, nt, B, N, K, J, iters, mode, store;
  float dt, a;
};

// Z += X Y on the thread's entries (rows r[], columns c[]) for complex
// matrices given as plane pairs: X element (row, j) at row * sxr + j * sxj,
// Y element (j, col) at j * syj + col * syc. CX / CY conjugate the operand, so
// that a transposed stride pair reads its Hermitian adjoint.
template <int TS, bool CX, bool CY>
__device__ __forceinline__ void cmm(float (&zr)[TS][TS], float (&zi)[TS][TS],
                                    const float* Xr, const float* Xi, int sxr,
                                    int sxj, const float* Yr, const float* Yi,
                                    int syj, int syc, const int (&r)[TS],
                                    const int (&c)[TS], int n) {
  // unrolled so that the loads of several j are in flight at once (measured
  // on an H100: 15 to 25% off a whole sweep against an unroll of 2)
#pragma unroll(TS == 4 ? 4 : 8)
  for (int j = 0; j < n; ++j) {
    float xr[TS], xi[TS], yr[TS], yi[TS];
#pragma unroll
    for (int a = 0; a < TS; ++a) {
      const int o = r[a] * sxr + j * sxj;
      xr[a] = Xr[o];
      xi[a] = CX ? -Xi[o] : Xi[o];
    }
#pragma unroll
    for (int b = 0; b < TS; ++b) {
      const int o = j * syj + c[b] * syc;
      yr[b] = Yr[o];
      yi[b] = CY ? -Yi[o] : Yi[o];
    }
#pragma unroll
    for (int a = 0; a < TS; ++a) {
#pragma unroll
      for (int b = 0; b < TS; ++b) {
        zr[a][b] = fmaf(xr[a], yr[b], zr[a][b]);
        zr[a][b] = fmaf(-xi[a], yi[b], zr[a][b]);
        zi[a][b] = fmaf(xr[a], yi[b], zi[a][b]);
        zi[a][b] = fmaf(xi[a], yr[b], zi[a][b]);
      }
    }
  }
}

// M = -i sum_k c_k S_k into planes of row stride ld: M_r = A_i, M_i = -A_r.
__device__ __forceinline__ void contract(const float* __restrict__ Sr,
                                         const float* __restrict__ Si,
                                         const float* __restrict__ c,
                                         float* Mr, float* Mi, int K, int N,
                                         int ld) {
  const int NN = N * N;
  for (int e = threadIdx.x; e < NN; e += blockDim.x) {
    float ar = 0.f, ai = 0.f;
    for (int k = 0; k < K; ++k) {
      const float ck = __ldg(c + k);
      ar = fmaf(ck, __ldg(Sr + k * NN + e), ar);
      ai = fmaf(ck, __ldg(Si + k * NN + e), ai);
    }
    const int p = e / N, q = e - p * N;
    Mr[p * ld + q] = ai;
    Mi[p * ld + q] = -ar;
  }
}

// acc = T(v) (ADJ = false) or Tt(v) (ADJ = true) on the thread's entries:
//   T(v)  = M v + v M^dag + sum_l (L_l v) L_l^dag - d * v
//   Tt(u) = M^dag u + u M + sum_l (L_l^dag u) L_l - conj(d) * u
// v and M are shared-memory plane pairs (row stride ld); L is the global
// (4, J, N, N) array [L_r, L_i, Lh_r, Lh_i] with Lh = L^dag; (dr, di) are the
// global planes of the split stepper's diagonal, or null. (tr, ti) is the
// shared scratch pair for L v. Every thread of the block must call it (it
// synchronizes when J > 0); the caller synchronizes before v is rewritten.
template <int TS, bool ADJ>
__device__ __forceinline__ void apply_gen(
    float (&accr)[TS][TS], float (&acci)[TS][TS], const float* Mr,
    const float* Mi, const float* vr, const float* vi, float* tr, float* ti,
    const float* __restrict__ L, const float* __restrict__ dr,
    const float* __restrict__ di, const int (&r)[TS], const int (&c)[TS],
    const bool (&ok)[TS][TS], int N, int ld, int J) {
#pragma unroll
  for (int a = 0; a < TS; ++a)
#pragma unroll
    for (int b = 0; b < TS; ++b) accr[a][b] = acci[a][b] = 0.f;
  if (!ADJ) {
    cmm<TS, false, false>(accr, acci, Mr, Mi, ld, 1, vr, vi, ld, 1, r, c, N);
    cmm<TS, false, true>(accr, acci, vr, vi, ld, 1, Mr, Mi, 1, ld, r, c, N);
  } else {
    cmm<TS, true, false>(accr, acci, Mr, Mi, 1, ld, vr, vi, ld, 1, r, c, N);
    cmm<TS, false, false>(accr, acci, vr, vi, ld, 1, Mr, Mi, ld, 1, r, c, N);
  }
  const int NN = N * N;
  for (int l = 0; l < J; ++l) {
    // first factor L_l (T) or L_l^dag (Tt), second factor the other one
    const float* Ar = L + (size_t)((ADJ ? 2 : 0) * J + l) * NN;
    const float* Ai = L + (size_t)((ADJ ? 3 : 1) * J + l) * NN;
    const float* Br = L + (size_t)((ADJ ? 0 : 2) * J + l) * NN;
    const float* Bi = L + (size_t)((ADJ ? 1 : 3) * J + l) * NN;
    float zr[TS][TS], zi[TS][TS];
#pragma unroll
    for (int a = 0; a < TS; ++a)
#pragma unroll
      for (int b = 0; b < TS; ++b) zr[a][b] = zi[a][b] = 0.f;
    cmm<TS, false, false>(zr, zi, Ar, Ai, N, 1, vr, vi, ld, 1, r, c, N);
    if (l > 0) __syncthreads();     // the previous jump's reads of t are done
#pragma unroll
    for (int a = 0; a < TS; ++a)
#pragma unroll
      for (int b = 0; b < TS; ++b)
        if (ok[a][b]) {
          tr[r[a] * ld + c[b]] = zr[a][b];
          ti[r[a] * ld + c[b]] = zi[a][b];
        }
    __syncthreads();
    cmm<TS, false, false>(accr, acci, tr, ti, ld, 1, Br, Bi, N, 1, r, c, N);
  }
  if (dr != nullptr) {
#pragma unroll
    for (int a = 0; a < TS; ++a)
#pragma unroll
      for (int b = 0; b < TS; ++b) {
        const int o = r[a] * N + c[b], so = r[a] * ld + c[b];
        const float d_r = dr[o], d_i = ADJ ? -di[o] : di[o];
        const float v_r = vr[so], v_i = vi[so];
        accr[a][b] -= d_r * v_r - d_i * v_i;
        acci[a][b] -= d_r * v_i + d_i * v_r;
      }
  }
}

// v <- p v and v <- conj(p) v for an entrywise solver plane pair at offset o
__device__ __forceinline__ void cmul(const float* __restrict__ pr,
                                     const float* __restrict__ pi, int o,
                                     float& vr, float& vi) {
  const float ar = pr[o], ai = pi[o];
  const float t = ar * vr - ai * vi;
  vi = ai * vr + ar * vi;
  vr = t;
}

__device__ __forceinline__ void cmul_conj(const float* __restrict__ pr,
                                          const float* __restrict__ pi, int o,
                                          float& vr, float& vi) {
  const float ar = pr[o], ai = pi[o];
  const float t = ar * vr + ai * vi;
  vi = ar * vi - ai * vr;
  vr = t;
}

// The thread's rows and columns (clamped into range) and which of its
// entries exist.
template <int TS>
__device__ __forceinline__ void ownership(int N, int (&r)[TS], int (&c)[TS],
                                          bool (&ok)[TS][TS]) {
  const int ntile = (N + TS - 1) / TS;
  const bool active = (int)threadIdx.x < ntile * ntile;
  const int t0 = active ? (int)threadIdx.x : 0;
  const int tr = t0 / ntile, tc = t0 - tr * ntile;
#pragma unroll
  for (int a = 0; a < TS; ++a) {
    r[a] = min(tr + a * ntile, N - 1);
    c[a] = min(tc + a * ntile, N - 1);
  }
#pragma unroll
  for (int a = 0; a < TS; ++a)
#pragma unroll
    for (int b = 0; b < TS; ++b)
      ok[a][b] = active && tr + a * ntile < N && tc + b * ntile < N;
}

// One stage update k <- solve step from m = T(k) and the stage's b:
// neumann k = b + a m; jacobi k = Minv (b + a (m - d k)).
__device__ __forceinline__ void stage_update(bool jac, float a, float br,
                                             float bi, float mr, float mi,
                                             const float* e0, const float* e1,
                                             const float* e2, const float* e3,
                                             int o, float& kr, float& ki) {
  if (jac) {
    const float d_r = e0[o], d_i = e1[o];
    const float ur = mr - (d_r * kr - d_i * ki);
    const float ui = mi - (d_r * ki + d_i * kr);
    kr = br + a * ur;
    ki = bi + a * ui;
    cmul(e2, e3, o, kr, ki);
  } else {
    kr = br + a * mr;
    ki = bi + a * mi;
  }
}

}  // namespace

// Forward. Block (e, ib) propagates initial condition ib under candidate e:
// x0 (B, N, N) shared by all candidates; C (E, nt, K); el the entrywise
// solver planes, each (N, N): jacobi (d_r, d_i, minv_r, minv_i), split
// (e_r, e_i, d_r, d_i). Writes xT (E, B, N, N), hist (E, nt, B, N, N) and,
// with store, the stage iterates k_0..k_{iters-1} (E, B, nt, iters, N, N).
template <int TS>
__global__ void __launch_bounds__(TS == 4 ? 256 : 1024)
rho_fwd(const float* __restrict__ Sr, const float* __restrict__ Si,
        const float* __restrict__ L, const float* __restrict__ C,
        const float* __restrict__ x0r, const float* __restrict__ x0i,
        const float* __restrict__ el, float* __restrict__ xTr,
        float* __restrict__ xTi, float* __restrict__ hr,
        float* __restrict__ hi, float* __restrict__ ksr,
        float* __restrict__ ksi, Dims d) {
  extern __shared__ float sm[];
  const int N = d.N, NN = N * N, ld = N | 1, plane = N * ld;
  float* Mr = sm;
  float* Mi = Mr + plane;
  float* vr = Mi + plane;
  float* vi = vr + plane;
  float* tr = vi + plane;
  float* ti = tr + plane;
  float* br = ti + plane;       // b = T(x) of the step, owner-only access
  float* bi = br + plane;

  const int blk = blockIdx.x, e = blk / d.B, ib = blk - e * d.B;
  const bool jac = d.mode == MODE_JACOBI, split = d.mode == MODE_SPLIT;
  const float *e0 = el, *e1 = el + NN, *e2 = el + 2 * NN, *e3 = el + 3 * NN;
  const float* dsr = split ? e2 : nullptr;
  const float* dsi = split ? e3 : nullptr;
  int r[TS], c[TS];
  bool ok[TS][TS];
  ownership<TS>(N, r, c, ok);

  float xr[TS][TS], xi[TS][TS];
#pragma unroll
  for (int a = 0; a < TS; ++a)
#pragma unroll
    for (int b = 0; b < TS; ++b) {
      const int o = r[a] * N + c[b];
      xr[a][b] = x0r[(size_t)ib * NN + o];
      xi[a][b] = x0i[(size_t)ib * NN + o];
    }

  for (int t = 0; t < d.nt; ++t) {
    const size_t st = (size_t)e * d.nt + t;
    const size_t ks0 = ((size_t)blk * d.nt + t) * d.iters * NN;
    __syncthreads();            // the previous step's reads of M, v, t are done
    contract(Sr, Si, C + st * d.K, Mr, Mi, d.K, N, ld);
#pragma unroll
    for (int a = 0; a < TS; ++a)
#pragma unroll
      for (int b = 0; b < TS; ++b) {
        if (!ok[a][b]) continue;
        const int o = r[a] * N + c[b], so = r[a] * ld + c[b];
        if (split) cmul(e0, e1, o, xr[a][b], xi[a][b]);
        vr[so] = xr[a][b];
        vi[so] = xi[a][b];
      }
    __syncthreads();
    float kr[TS][TS], ki[TS][TS];
    apply_gen<TS, false>(kr, ki, Mr, Mi, vr, vi, tr, ti, L, dsr, dsi, r, c, ok,
                         N, ld, d.J);
#pragma unroll
    for (int a = 0; a < TS; ++a)
#pragma unroll
      for (int b = 0; b < TS; ++b) {
        if (!ok[a][b]) continue;
        const int o = r[a] * N + c[b], so = r[a] * ld + c[b];
        br[so] = kr[a][b];
        bi[so] = ki[a][b];
        if (jac) cmul(e2, e3, o, kr[a][b], ki[a][b]);
        if (d.store && d.iters > 0) {
          ksr[ks0 + o] = kr[a][b];
          ksi[ks0 + o] = ki[a][b];
        }
      }
    for (int j = 0; j < d.iters; ++j) {
      __syncthreads();
#pragma unroll
      for (int a = 0; a < TS; ++a)
#pragma unroll
        for (int b = 0; b < TS; ++b)
          if (ok[a][b]) {
            vr[r[a] * ld + c[b]] = kr[a][b];
            vi[r[a] * ld + c[b]] = ki[a][b];
          }
      __syncthreads();
      float mr[TS][TS], mi[TS][TS];
      apply_gen<TS, false>(mr, mi, Mr, Mi, vr, vi, tr, ti, L, dsr, dsi, r, c,
                           ok, N, ld, d.J);
#pragma unroll
      for (int a = 0; a < TS; ++a)
#pragma unroll
        for (int b = 0; b < TS; ++b) {
          if (!ok[a][b]) continue;
          const int o = r[a] * N + c[b], so = r[a] * ld + c[b];
          stage_update(jac, d.a, br[so], bi[so], mr[a][b], mi[a][b], e0, e1,
                       e2, e3, o, kr[a][b], ki[a][b]);
          if (d.store && j + 1 < d.iters) {
            ksr[ks0 + (size_t)(j + 1) * NN + o] = kr[a][b];
            ksi[ks0 + (size_t)(j + 1) * NN + o] = ki[a][b];
          }
        }
    }
#pragma unroll
    for (int a = 0; a < TS; ++a)
#pragma unroll
      for (int b = 0; b < TS; ++b) {
        if (!ok[a][b]) continue;
        const int o = r[a] * N + c[b];
        xr[a][b] += d.dt * kr[a][b];
        xi[a][b] += d.dt * ki[a][b];
        if (split) cmul(e0, e1, o, xr[a][b], xi[a][b]);
        const size_t h = (st * d.B + ib) * NN + o;
        hr[h] = xr[a][b];
        hi[h] = xi[a][b];
      }
  }
#pragma unroll
  for (int a = 0; a < TS; ++a)
#pragma unroll
    for (int b = 0; b < TS; ++b)
      if (ok[a][b]) {
        const size_t o = (size_t)blk * NN + r[a] * N + c[b];
        xTr[o] = xr[a][b];
        xTi[o] = xi[a][b];
      }
}

// Backward: runs the steps in reverse. Inputs as the forward's plus the
// history (E, nt, B, N, N), its cotangent j (same shape) and the final-state
// cotangent gT (E, B, N, N). ks holds the forward's stage iterates
// (E, B, nt, iters, N, N) with store, else it is a scratch (E, B, iters, N, N)
// that the replay of each step fills. Writes the x0 cotangent of every block
// g0 (E, B, N, N), which also parks the running cotangent during a step, and
// the coefficient cotangents of every block Cb (E, B, nt, K).
template <int TS>
__global__ void __launch_bounds__(TS == 4 ? 256 : 1024)
rho_bwd(const float* __restrict__ Sr, const float* __restrict__ Si,
        const float* __restrict__ L, const float* __restrict__ C,
        const float* __restrict__ x0r, const float* __restrict__ x0i,
        const float* __restrict__ hr, const float* __restrict__ hi,
        const float* __restrict__ jr, const float* __restrict__ ji,
        const float* __restrict__ gTr, const float* __restrict__ gTi,
        const float* __restrict__ el, float* ksr, float* ksi, float* g0r,
        float* g0i, float* __restrict__ Cb, Dims d) {
  extern __shared__ float sm[];
  const int N = d.N, NN = N * N, ld = N | 1, plane = N * ld;
  const int iters = d.iters, K = d.K;
  float* Mr = sm;
  float* Mi = Mr + plane;
  float* cr = Mi + plane;       // cotangent operand of Tt and of the pairs
  float* ci = cr + plane;
  float* tr = ci + plane;
  float* ti = tr + plane;
  float* ur = ti + plane;       // the pair's input u (and the replay's operand)
  float* ui = ur + plane;
  float* red = ui + plane;      // (nwarps, K)

  const int blk = blockIdx.x, e = blk / d.B, ib = blk - e * d.B;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool jac = d.mode == MODE_JACOBI, split = d.mode == MODE_SPLIT;
  const float *e0 = el, *e1 = el + NN, *e2 = el + 2 * NN, *e3 = el + 3 * NN;
  const float* dsr = split ? e2 : nullptr;
  const float* dsi = split ? e3 : nullptr;
  int r[TS], c[TS];
  bool ok[TS][TS];
  ownership<TS>(N, r, c, ok);
  const size_t gb = (size_t)blk * NN;

  float gr[TS][TS], gi[TS][TS];
#pragma unroll
  for (int a = 0; a < TS; ++a)
#pragma unroll
    for (int b = 0; b < TS; ++b) {
      const int o = r[a] * N + c[b];
      gr[a][b] = gTr[gb + o];
      gi[a][b] = gTi[gb + o];
    }

  for (int t = d.nt - 1; t >= 0; --t) {
    const size_t st = (size_t)e * d.nt + t;
    const size_t h0 = (st * d.B + ib) * NN;           // hist[e, t, ib]
    const size_t ks0 = d.store ? ((size_t)blk * d.nt + t) * iters * NN
                               : (size_t)blk * iters * NN;
    __syncthreads();
    contract(Sr, Si, C + st * K, Mr, Mi, K, N, ld);
    // history cotangent in, cotangent into the split frame, and parked
#pragma unroll
    for (int a = 0; a < TS; ++a)
#pragma unroll
      for (int b = 0; b < TS; ++b) {
        if (!ok[a][b]) continue;
        const int o = r[a] * N + c[b];
        gr[a][b] += jr[h0 + o];
        gi[a][b] += ji[h0 + o];
        if (split) cmul_conj(e0, e1, o, gr[a][b], gi[a][b]);
        g0r[gb + o] = gr[a][b];
        g0i[gb + o] = gi[a][b];
      }

    if (!d.store && iters > 0) {      // replay the stage iterates into ks
#pragma unroll
      for (int a = 0; a < TS; ++a)
#pragma unroll
        for (int b = 0; b < TS; ++b) {
          if (!ok[a][b]) continue;
          const int o = r[a] * N + c[b], so = r[a] * ld + c[b];
          // pre-step state: x0 at t = 0, else the previous history entry
          float pr = t == 0 ? x0r[(size_t)ib * NN + o]
                            : hr[h0 - (size_t)d.B * NN + o];
          float pi = t == 0 ? x0i[(size_t)ib * NN + o]
                            : hi[h0 - (size_t)d.B * NN + o];
          if (split) cmul(e0, e1, o, pr, pi);
          ur[so] = pr;
          ui[so] = pi;
        }
      __syncthreads();
      float b_r[TS][TS], b_i[TS][TS], kr[TS][TS], ki[TS][TS];
      apply_gen<TS, false>(b_r, b_i, Mr, Mi, ur, ui, tr, ti, L, dsr, dsi, r,
                           c, ok, N, ld, d.J);
#pragma unroll
      for (int a = 0; a < TS; ++a)
#pragma unroll
        for (int b = 0; b < TS; ++b) {
          kr[a][b] = b_r[a][b];
          ki[a][b] = b_i[a][b];
          if (!ok[a][b]) continue;
          const int o = r[a] * N + c[b];
          if (jac) cmul(e2, e3, o, kr[a][b], ki[a][b]);
          ksr[ks0 + o] = kr[a][b];
          ksi[ks0 + o] = ki[a][b];
        }
      for (int j = 1; j < iters; ++j) {
        __syncthreads();
#pragma unroll
        for (int a = 0; a < TS; ++a)
#pragma unroll
          for (int b = 0; b < TS; ++b)
            if (ok[a][b]) {
              ur[r[a] * ld + c[b]] = kr[a][b];
              ui[r[a] * ld + c[b]] = ki[a][b];
            }
        __syncthreads();
        float mr[TS][TS], mi[TS][TS];
        apply_gen<TS, false>(mr, mi, Mr, Mi, ur, ui, tr, ti, L, dsr, dsi, r,
                             c, ok, N, ld, d.J);
#pragma unroll
        for (int a = 0; a < TS; ++a)
#pragma unroll
          for (int b = 0; b < TS; ++b) {
            if (!ok[a][b]) continue;
            const int o = r[a] * N + c[b];
            stage_update(jac, d.a, b_r[a][b], b_i[a][b], mr[a][b], mi[a][b],
                         e0, e1, e2, e3, o, kr[a][b], ki[a][b]);
            ksr[ks0 + (size_t)j * NN + o] = kr[a][b];
            ksi[ks0 + (size_t)j * NN + o] = ki[a][b];
          }
      }
    }

    // transpose of the stage chain, j = iters..1: the pair's cotangent is
    // c = a * k-bar, its input u = k_{j-1}; the last pair is (b-bar, x_pre)
    float bbr[TS][TS], bbi[TS][TS], kbr[TS][TS], kbi[TS][TS];
    float wr[TS][TS], wi[TS][TS];
#pragma unroll
    for (int a = 0; a < TS; ++a)
#pragma unroll
      for (int b = 0; b < TS; ++b) {
        bbr[a][b] = bbi[a][b] = wr[a][b] = wi[a][b] = 0.f;
        kbr[a][b] = kbi[a][b] = 0.f;
        if (!ok[a][b]) continue;
        // from the parked cotangent, so that g holds no registers meanwhile
        kbr[a][b] = d.dt * g0r[gb + r[a] * N + c[b]];
        kbi[a][b] = d.dt * g0i[gb + r[a] * N + c[b]];
      }
    for (int j = iters; j >= 1; --j) {
      __syncthreads();          // the previous pair's reads of c, u are done
#pragma unroll
      for (int a = 0; a < TS; ++a)
#pragma unroll
        for (int b = 0; b < TS; ++b) {
          if (!ok[a][b]) continue;
          const int o = r[a] * N + c[b], so = r[a] * ld + c[b];
          if (jac) cmul_conj(e2, e3, o, kbr[a][b], kbi[a][b]);    // Wt
          bbr[a][b] += kbr[a][b];
          bbi[a][b] += kbi[a][b];
          cr[so] = d.a * kbr[a][b];
          ci[so] = d.a * kbi[a][b];
          ur[so] = ksr[ks0 + (size_t)(j - 1) * NN + o];
          ui[so] = ksi[ks0 + (size_t)(j - 1) * NN + o];
        }
      __syncthreads();
      apply_gen<TS, true>(kbr, kbi, Mr, Mi, cr, ci, tr, ti, L, dsr, dsi, r, c,
                          ok, N, ld, d.J);
      if (jac) {                // minus the transpose of v -> d v
#pragma unroll
        for (int a = 0; a < TS; ++a)
#pragma unroll
          for (int b = 0; b < TS; ++b) {
            if (!ok[a][b]) continue;
            const int o = r[a] * N + c[b], so = r[a] * ld + c[b];
            float qr = cr[so], qi = ci[so];
            cmul_conj(e0, e1, o, qr, qi);
            kbr[a][b] -= qr;
            kbi[a][b] -= qi;
          }
      }
      cmm<TS, false, true>(wr, wi, cr, ci, ld, 1, ur, ui, 1, ld, r, c, N);
      cmm<TS, true, false>(wr, wi, cr, ci, 1, ld, ur, ui, ld, 1, r, c, N);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < TS; ++a)
#pragma unroll
      for (int b = 0; b < TS; ++b) {
        if (!ok[a][b]) continue;
        const int o = r[a] * N + c[b], so = r[a] * ld + c[b];
        if (jac) cmul_conj(e2, e3, o, kbr[a][b], kbi[a][b]);
        cr[so] = bbr[a][b] + kbr[a][b];
        ci[so] = bbi[a][b] + kbi[a][b];
        float pr = t == 0 ? x0r[(size_t)ib * NN + o]
                          : hr[h0 - (size_t)d.B * NN + o];
        float pi = t == 0 ? x0i[(size_t)ib * NN + o]
                          : hi[h0 - (size_t)d.B * NN + o];
        if (split) cmul(e0, e1, o, pr, pi);
        ur[so] = pr;
        ui[so] = pi;
      }
    __syncthreads();
    apply_gen<TS, true>(kbr, kbi, Mr, Mi, cr, ci, tr, ti, L, dsr, dsi, r, c,
                        ok, N, ld, d.J);
    cmm<TS, false, true>(wr, wi, cr, ci, ld, 1, ur, ui, 1, ld, r, c, N);
    cmm<TS, true, false>(wr, wi, cr, ci, 1, ld, ur, ui, ld, 1, r, c, N);
#pragma unroll
    for (int a = 0; a < TS; ++a)
#pragma unroll
      for (int b = 0; b < TS; ++b) {
        gr[a][b] = gi[a][b] = 0.f;
        if (!ok[a][b]) continue;
        const int o = r[a] * N + c[b];
        gr[a][b] = g0r[gb + o] + kbr[a][b];
        gi[a][b] = g0i[gb + o] + kbi[a][b];
        if (split) cmul_conj(e0, e1, o, gr[a][b], gi[a][b]);
      }

    // Cb[t, k] = <dA_r, Sr_k> + <dA_i, Si_k> with dA_i = Re W, dA_r = -Im W
    for (int k = 0; k < K; ++k) {
      float v = 0.f;
#pragma unroll
      for (int a = 0; a < TS; ++a)
#pragma unroll
        for (int b = 0; b < TS; ++b) {
          if (!ok[a][b]) continue;
          const int o = k * NN + r[a] * N + c[b];
          v += wr[a][b] * __ldg(Si + o) - wi[a][b] * __ldg(Sr + o);
        }
      for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
      if (lane == 0) red[warp * K + k] = v;
    }
    __syncthreads();
    if (tid < K) {
      float v = 0.f;
      for (int w = 0; w < nwarps; ++w) v += red[w * K + tid];
      Cb[((size_t)blk * d.nt + t) * K + tid] = v;
    }
  }
#pragma unroll
  for (int a = 0; a < TS; ++a)
#pragma unroll
    for (int b = 0; b < TS; ++b)
      if (ok[a][b]) {
        g0r[gb + r[a] * N + c[b]] = gr[a][b];
        g0i[gb + r[a] * N + c[b]] = gi[a][b];
      }
}

// Plain C entry points, bound from Python with ctypes. Each launches
// E * B blocks of `threads` threads on the given stream and returns
// cudaGetLastError() (0 on success); tile is TS: 1 (one entry per thread, up
// to 1024 threads of 64 registers, N <= 32) or 4 (16 entries per thread, up
// to 256 threads of 255 registers, N <= 64).
namespace {

template <int TS>
int launch_fwd(const float* Sr, const float* Si, const float* L,
               const float* C, const float* x0r, const float* x0i,
               const float* el, float* xTr, float* xTi, float* hr, float* hi,
               float* ksr, float* ksi, const Dims& d, int threads,
               int smem_bytes, cudaStream_t stream) {
  if (smem_bytes > 48 * 1024)
    cudaFuncSetAttribute(rho_fwd<TS>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
  rho_fwd<TS><<<d.E * d.B, threads, smem_bytes, stream>>>(
      Sr, Si, L, C, x0r, x0i, el, xTr, xTi, hr, hi, ksr, ksi, d);
  return (int)cudaGetLastError();
}

template <int TS>
int launch_bwd(const float* Sr, const float* Si, const float* L,
               const float* C, const float* x0r, const float* x0i,
               const float* hr, const float* hi, const float* jr,
               const float* ji, const float* gTr, const float* gTi,
               const float* el, float* ksr, float* ksi, float* g0r, float* g0i,
               float* Cb, const Dims& d, int threads, int smem_bytes,
               cudaStream_t stream) {
  if (smem_bytes > 48 * 1024)
    cudaFuncSetAttribute(rho_bwd<TS>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
  rho_bwd<TS><<<d.E * d.B, threads, smem_bytes, stream>>>(
      Sr, Si, L, C, x0r, x0i, hr, hi, jr, ji, gTr, gTi, el, ksr, ksi, g0r, g0i,
      Cb, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rho_fwd_launch(
    const void* Sr, const void* Si, const void* L, const void* C,
    const void* x0r, const void* x0i, const void* el, void* xTr, void* xTi,
    void* hr, void* hi, void* ksr, void* ksi, int E, int nt, int B, int N,
    int K, int J, int iters, int mode, int store, float dt, float a, int tile,
    int threads, int smem_bytes, void* stream) {
  Dims d{E, nt, B, N, K, J, iters, mode, store, dt, a};
#define RHO_FWD_ARGS                                                          \
  (const float*)Sr, (const float*)Si, (const float*)L, (const float*)C,       \
      (const float*)x0r, (const float*)x0i, (const float*)el, (float*)xTr,    \
      (float*)xTi, (float*)hr, (float*)hi, (float*)ksr, (float*)ksi, d,       \
      threads, smem_bytes, (cudaStream_t)stream
  switch (tile) {
    case 1: return launch_fwd<1>(RHO_FWD_ARGS);
    case 4: return launch_fwd<4>(RHO_FWD_ARGS);
  }
#undef RHO_FWD_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" int rho_bwd_launch(
    const void* Sr, const void* Si, const void* L, const void* C,
    const void* x0r, const void* x0i, const void* hr, const void* hi,
    const void* jr, const void* ji, const void* gTr, const void* gTi,
    const void* el, void* ksr, void* ksi, void* g0r, void* g0i, void* Cb,
    int E, int nt, int B, int N, int K, int J, int iters, int mode, int store,
    float dt, float a, int tile, int threads, int smem_bytes, void* stream) {
  Dims d{E, nt, B, N, K, J, iters, mode, store, dt, a};
#define RHO_BWD_ARGS                                                          \
  (const float*)Sr, (const float*)Si, (const float*)L, (const float*)C,       \
      (const float*)x0r, (const float*)x0i, (const float*)hr,                 \
      (const float*)hi, (const float*)jr, (const float*)ji,                   \
      (const float*)gTr, (const float*)gTi, (const float*)el, (float*)ksr,    \
      (float*)ksi, (float*)g0r, (float*)g0i, (float*)Cb, d, threads,          \
      smem_bytes, (cudaStream_t)stream
  switch (tile) {
    case 1: return launch_bwd<1>(RHO_BWD_ARGS);
    case 4: return launch_bwd<4>(RHO_BWD_ARGS);
  }
#undef RHO_BWD_ARGS
  return (int)cudaErrorInvalidValue;
}
