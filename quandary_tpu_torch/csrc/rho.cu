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
// Layout, both directions: one thread-block cluster of G CTAs per (control
// candidate, initial condition), G in {1, 2, 4, 8, 16} a launch-time value;
// the sequential time loop runs inside the cluster (the TPU's sequential
// grid axis). CTA q of the cluster owns rows [q N / G, (q + 1) N / G) of
// every (N, N) quantity the kernel produces; its threads own TS x TS entries
// of that band, strided so that neighbouring lanes read neighbouring
// columns; entries past the band compute on clamped indices and are never
// written. Every product of T (or Tt) needs the whole of only one factor
// that the chain produces, the operand v: M v and L_l v need all of v, the
// band of v M^dag only v's band, and the band of (L_l v) L_l^dag only that
// band of L_l v. So for every T each thread stores its entries of v in its
// CTA's copy and pushes them by st.async into the other CTAs' copies
// through distributed shared memory; one mbarrier per copy counts the
// bytes, and the CTA waits on it alone. The copy is double-buffered, so no
// other barrier guards it. A cluster barrier would do the same, but its
// acquire drops the SM's L1, from which every T reads the jump and solver
// planes (the exchange section below). Each jump operator has its own
// scratch band for L_l v, so a T passes one CTA barrier between the J first
// factors and the J second factors (where J bands do not fit, as at G = 1
// and N = 64, the jumps go in groups, one barrier pair per group). Each CTA
// contracts M(t) whole. Shared memory rows have stride N | 1, so that the
// transposed reads of M for the M^dag factors are free of bank conflicts;
// the stacks, the jump planes and the entrywise solver planes are read from
// global memory (a few hundred KB, resident in L1 and L2). Nothing is
// padded: the 128-lane tiles, Hs rows and lane-group packing of the TPU
// kernel have no counterpart here. Arithmetic is exact f32 FMA on the CUDA
// cores (the TPU kernel's default is a 3-pass bf16 emulation of f32
// matmuls); every entry is one thread's chain of fmaf in a fixed order and
// every entrywise product is rounded as written, never contracted, so the
// results have the same bits at any G and tile.
//
// Forward: x lives in registers, band by band; x0 is read once. Per step,
// after a CTA barrier (the previous step's reads of M are done) and the
// contraction of M(t): x (rotated by E where split) is exchanged, and
// stage_chain runs b = T(x), k_0 = b (jacobi: Minv b) and iters times an
// exchange of k, m = T(k) and the stage update; then x += dt k (rotated
// where split) and the history's band is written. The stage iterates are
// stored band by band. The backward's replay runs the same stage_chain, so
// stored and replayed iterates have the same bits. Shared memory: two
// mbarriers, M, the operand (two buffers) and the jump bands: six (N, N)
// planes and the bands, so N <= 64 fits one CTA.
//
// Backward: the steps in reverse on the same layout. Per pair the operand
// is the cotangent c; its input u (a stored or replayed iterate, or the
// pre-step state) is whole in device memory, and each CTA copies all of it
// by cp.async a pair ahead, into a second buffer (U). Cb[t, k] is reduced
// over each CTA's warps, pushed into rank 0, and summed there in rank
// order: no atomics, and g0 has the same bits at any G.
//
// What bounds it on the H100: operations. One T is (8 + 8 J) real N^3
// products, 21 MFLOP at N = 64 with 4 jump operators, and a step runs
// iters + 1 of them in a dependent chain, each spread over the G SMs of a
// matrix: E * B * G of the 132 SMs work. Each T (Tt) pays an exchange of
// 8 N^2 (G - 1) / G bytes of distributed shared memory into each CTA, one
// mbarrier wait for it and one CTA barrier per group of jump operators;
// the shape rule (ops/rho.py) stops G where that costs more than the
// products it spreads. Tensor-core products are later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace cg = cooperative_groups;

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

// v <- p v and v <- conj(p) v, rounded as written: no product is contracted
// into an FMA, so an entry's bits do not depend on the instance of the
// kernel that computes it.
__device__ __forceinline__ void cmul_rn(const float* __restrict__ pr,
                                        const float* __restrict__ pi, int o,
                                        float& vr, float& vi) {
  const float ar = pr[o], ai = pi[o];
  const float t = __fsub_rn(__fmul_rn(ar, vr), __fmul_rn(ai, vi));
  vi = __fadd_rn(__fmul_rn(ai, vr), __fmul_rn(ar, vi));
  vr = t;
}

__device__ __forceinline__ void cmul_conj_rn(const float* __restrict__ pr,
                                             const float* __restrict__ pi,
                                             int o, float& vr, float& vi) {
  const float ar = pr[o], ai = pi[o];
  const float t = __fadd_rn(__fmul_rn(ar, vr), __fmul_rn(ai, vi));
  vi = __fsub_rn(__fmul_rn(ar, vi), __fmul_rn(ai, vr));
  vr = t;
}

// One stage update k <- solve step from m = T(k) and the stage's b, rounded
// as written: neumann k = b + a m; jacobi k = Minv (b + a (m - d k)).
__device__ __forceinline__ void stage_update_rn(
    bool jac, float a, float br, float bi, float mr, float mi, const float* e0,
    const float* e1, const float* e2, const float* e3, int o, float& kr,
    float& ki) {
  if (jac) {
    const float d_r = e0[o], d_i = e1[o];
    const float ur =
        __fsub_rn(mr, __fsub_rn(__fmul_rn(d_r, kr), __fmul_rn(d_i, ki)));
    const float ui =
        __fsub_rn(mi, __fadd_rn(__fmul_rn(d_r, ki), __fmul_rn(d_i, kr)));
    kr = __fadd_rn(br, __fmul_rn(a, ur));
    ki = __fadd_rn(bi, __fmul_rn(a, ui));
    cmul_rn(e2, e3, o, kr, ki);
  } else {
    kr = __fadd_rn(br, __fmul_rn(a, mr));
    ki = __fadd_rn(bi, __fmul_rn(a, mi));
  }
}

// The thread's entries of the band of R rows from row r0 (clamped into
// range) and which of them exist. Tile rows are strided by the tile-row
// count of the longest band, Rmax, so every CTA of a cluster maps its
// threads alike.
template <int TS>
__device__ __forceinline__ void band_ownership(int N, int r0, int R, int Rmax,
                                               int (&r)[TS], int (&c)[TS],
                                               bool (&ok)[TS][TS]) {
  const int nrt = (Rmax + TS - 1) / TS, nct = (N + TS - 1) / TS;
  const bool active = (int)threadIdx.x < nrt * nct;
  const int t0 = active ? (int)threadIdx.x : 0;
  const int tr = t0 / nct, tc = t0 - tr * nct;
#pragma unroll
  for (int a = 0; a < TS; ++a) {
    r[a] = r0 + min(tr + a * nrt, R - 1);
    c[a] = min(tc + a * nct, N - 1);
  }
#pragma unroll
  for (int a = 0; a < TS; ++a)
#pragma unroll
    for (int b = 0; b < TS; ++b)
      ok[a][b] = active && tr + a * nrt < R && tc + b * nct < N;
}

// What band_gen reads besides its operand: the step's M (shared memory, row
// stride ld), jb jump scratch bands of Rmax x ld (re, then im) at tb, the
// global (4, J, N, N) jump array [L_r, L_i, Lh_r, Lh_i] with Lh = L^dag, the
// global planes of the split stepper's diagonal (dr, di) or null, and the
// CTA's band from row r0.
struct Gen {
  const float* Mr;
  const float* Mi;
  float* tb;
  const float* L;
  const float* dr;
  const float* di;
  int r0, N, ld, Rmax, J, jb;
};

// acc = T(v) (ADJ = false) or Tt(v) (ADJ = true) on the thread's entries of
// its band, v whole in shared memory (row stride ld):
//   T(v)  = M v + v M^dag + sum_l (L_l v) L_l^dag - d * v
//   Tt(u) = M^dag u + u M + sum_l (L_l^dag u) L_l - conj(d) * u.
// The jump operators go in groups of jb, each with its own scratch band, so
// a group passes one barrier between its first and its second factors; the
// accumulation keeps l's order. Every thread of the block must call it (it
// synchronizes when J > 0); the caller synchronizes before v or the bands
// are rewritten.
template <int TS, bool ADJ>
__device__ __forceinline__ void band_gen(float (&accr)[TS][TS],
                                         float (&acci)[TS][TS], const Gen& g,
                                         const float* vr, const float* vi,
                                         const int (&r)[TS],
                                         const int (&c)[TS],
                                         const bool (&ok)[TS][TS]) {
  const int N = g.N, ld = g.ld;
#pragma unroll
  for (int a = 0; a < TS; ++a)
#pragma unroll
    for (int b = 0; b < TS; ++b) accr[a][b] = acci[a][b] = 0.f;
  if (!ADJ) {
    cmm<TS, false, false>(accr, acci, g.Mr, g.Mi, ld, 1, vr, vi, ld, 1, r, c,
                          N);
    cmm<TS, false, true>(accr, acci, vr, vi, ld, 1, g.Mr, g.Mi, 1, ld, r, c,
                         N);
  } else {
    cmm<TS, true, false>(accr, acci, g.Mr, g.Mi, 1, ld, vr, vi, ld, 1, r, c,
                         N);
    cmm<TS, false, false>(accr, acci, vr, vi, ld, 1, g.Mr, g.Mi, ld, 1, r, c,
                          N);
  }
  const int NN = N * N, bplane = g.Rmax * ld, J = g.J;
  int rl[TS];
#pragma unroll
  for (int a = 0; a < TS; ++a) rl[a] = r[a] - g.r0;
  for (int l0 = 0; l0 < J; l0 += g.jb) {
    const int l1 = min(J, l0 + g.jb);
    if (l0 > 0) __syncthreads();    // the previous group's reads are done
    for (int l = l0; l < l1; ++l) {
      // first factor L_l (T) or L_l^dag (Tt), on the band's rows
      const float* Ar = g.L + (size_t)((ADJ ? 2 : 0) * J + l) * NN;
      const float* Ai = g.L + (size_t)((ADJ ? 3 : 1) * J + l) * NN;
      float zr[TS][TS], zi[TS][TS];
#pragma unroll
      for (int a = 0; a < TS; ++a)
#pragma unroll
        for (int b = 0; b < TS; ++b) zr[a][b] = zi[a][b] = 0.f;
      cmm<TS, false, false>(zr, zi, Ar, Ai, N, 1, vr, vi, ld, 1, r, c, N);
      float* tr = g.tb + (size_t)2 * (l - l0) * bplane;
#pragma unroll
      for (int a = 0; a < TS; ++a)
#pragma unroll
        for (int b = 0; b < TS; ++b)
          if (ok[a][b]) {
            tr[rl[a] * ld + c[b]] = zr[a][b];
            tr[bplane + rl[a] * ld + c[b]] = zi[a][b];
          }
    }
    __syncthreads();
    for (int l = l0; l < l1; ++l) {
      // second factor, the other one of L_l and L_l^dag
      const float* Br = g.L + (size_t)((ADJ ? 0 : 2) * J + l) * NN;
      const float* Bi = g.L + (size_t)((ADJ ? 1 : 3) * J + l) * NN;
      const float* tr = g.tb + (size_t)2 * (l - l0) * bplane;
      cmm<TS, false, false>(accr, acci, tr, tr + bplane, ld, 1, Br, Bi, N, 1,
                            rl, c, N);
    }
  }
  if (g.dr != nullptr) {
#pragma unroll
    for (int a = 0; a < TS; ++a)
#pragma unroll
      for (int b = 0; b < TS; ++b) {
        const int o = r[a] * N + c[b], so = r[a] * ld + c[b];
        const float d_r = g.dr[o], d_i = ADJ ? -g.di[o] : g.di[o];
        const float v_r = vr[so], v_i = vi[so];
        accr[a][b] = __fsub_rn(
            accr[a][b], __fsub_rn(__fmul_rn(d_r, v_r), __fmul_rn(d_i, v_i)));
        acci[a][b] = __fsub_rn(
            acci[a][b], __fadd_rn(__fmul_rn(d_r, v_i), __fmul_rn(d_i, v_r)));
      }
  }
}

// The exchange of the operand between the CTAs of a cluster. Each thread
// stores its entries of the operand in its CTA's buffer and pushes them by
// st.async into the same place of every other CTA's buffer; each push counts
// its bytes on the destination's mbarrier of that buffer. Every thread then
// arrives on its own CTA's mbarrier (one with the bytes the others push) and
// waits for the phase: the whole operand is in shared memory. The wait
// acquires at CTA scope only: a cluster barrier's acquire would drop the
// L1 lines of the jump and solver planes, which every T reads (measured
// on an H100, scripts/cluster_barrier_l1.py: 64 KB of L1-resident loads
// took 2.1 us around a block barrier or an mbarrier, 11 us around
// barrier.cluster). The arrival releases and the wait acquires at CTA
// scope, so an exchange also shows the CTA's earlier shared-memory writes
// (M) to all its threads.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned mapa(unsigned addr, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void push(float* dst, float v, unsigned bar,
                                     int G, int rank) {
  const unsigned a = smem_u32(dst);
  for (int q = 0; q < G; ++q) {
    if (q == rank) continue;
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], "
        "%1, [%2];" ::"r"(mapa(a, q)),
        "r"(__float_as_uint(v)), "r"(mapa(bar, q))
        : "memory");
  }
}

__device__ __forceinline__ void bar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// arrive on a local mbarrier, expecting tx more bytes of pushes (tx > 0 on
// one thread only), and wait for the phase of the given parity to complete
__device__ __forceinline__ void bar_sync(unsigned bar, unsigned tx,
                                         int parity) {
  if (tx > 0)
    asm volatile(
        "{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, "
        "[%0], %1;\n}" ::"r"(bar),
        "r"(tx)
        : "memory");
  else
    asm volatile(
        "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::
            "r"(bar)
        : "memory");
  asm volatile(
      "{\n .reg .pred P;\n WAIT_%=:\n mbarrier.try_wait.parity.shared::cta.b64 "
      "P, [%0], %1;\n @!P bra WAIT_%=;\n}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The operand's two buffers F of (re, im) planes and their mbarriers (8
// bytes apart from bars). Exchange p uses buffer p & 1 and waits for parity
// (p >> 1) & 1: a buffer is rewritten two exchanges later, after every
// thread of the cluster has pushed its part of the exchange between, so
// after it has finished reading the buffer.
struct Exchange {
  float* F;
  int plane, G, rank;
  unsigned bars;
  unsigned tx;    // bytes the other CTAs push per exchange (thread 0), else 0
  int p;          // exchanges so far

  __device__ float* buf() const { return F + (p & 1) * 2 * plane; }

  // this thread's entry `so` of the operand in buffer fr, here and in the
  // other CTAs (one call per entry)
  __device__ void put(float* fr, int so, float vr, float vi) const {
    const unsigned bar = bars + 8 * (p & 1);
    fr[so] = vr;
    fr[plane + so] = vi;
    push(fr + so, vr, bar, G, rank);
    push(fr + plane + so, vi, bar, G, rank);
  }

  __device__ void wait() {
    bar_sync(bars + 8 * (p & 1), tx, (p >> 1) & 1);
    ++p;
  }

  // the thread's existing entries of v into the next buffer, and the wait:
  // returns the buffer, whole
  template <int TS>
  __device__ const float* share(const float (&vr)[TS][TS],
                                const float (&vi)[TS][TS], const int (&r)[TS],
                                const int (&c)[TS], const bool (&ok)[TS][TS],
                                int ld) {
    float* fr = buf();
#pragma unroll
    for (int a = 0; a < TS; ++a)
#pragma unroll
      for (int b = 0; b < TS; ++b)
        if (ok[a][b]) put(fr, r[a] * ld + c[b], vr[a][b], vi[a][b]);
    wait();
    return fr;
  }
};

// The stage chain of one step on the thread's entries of its band, for the
// forward and for the backward's replay: b = T(v) from the pre-step state v
// (rotated by E where split) whole in shared memory; k_0 = b (jacobi:
// Minv b); then for j = 1..n: k exchanged, m = T(k), k <- the stage update.
// k_j is stored at ks + j N^2 for j < iters where ksr is given. Ends with
// k_n in (kr, ki).
template <int TS>
__device__ __forceinline__ void stage_chain(
    float (&kr)[TS][TS], float (&ki)[TS][TS], const float* vr,
    const float* vi, int n, Exchange& ex, const Gen& g, const int (&r)[TS],
    const int (&c)[TS], const bool (&ok)[TS][TS], bool jac, float ha,
    const float* __restrict__ el, int iters, float* ksr, float* ksi) {
  const int N = g.N, NN = N * N;
  const float *e0 = el, *e1 = el + NN, *e2 = el + 2 * NN, *e3 = el + 3 * NN;
  float br[TS][TS], bi[TS][TS];
  band_gen<TS, false>(br, bi, g, vr, vi, r, c, ok);
#pragma unroll
  for (int a = 0; a < TS; ++a)
#pragma unroll
    for (int b = 0; b < TS; ++b) {
      kr[a][b] = br[a][b];
      ki[a][b] = bi[a][b];
      if (!ok[a][b]) continue;
      const int o = r[a] * N + c[b];
      if (jac) cmul_rn(e2, e3, o, kr[a][b], ki[a][b]);
      if (ksr != nullptr && iters > 0) {
        ksr[o] = kr[a][b];
        ksi[o] = ki[a][b];
      }
    }
  for (int j = 1; j <= n; ++j) {
    const float* fr = ex.share<TS>(kr, ki, r, c, ok, g.ld);
    float mr[TS][TS], mi[TS][TS];
    band_gen<TS, false>(mr, mi, g, fr, fr + ex.plane, r, c, ok);
#pragma unroll
    for (int a = 0; a < TS; ++a)
#pragma unroll
      for (int b = 0; b < TS; ++b) {
        if (!ok[a][b]) continue;
        const int o = r[a] * N + c[b];
        stage_update_rn(jac, ha, br[a][b], bi[a][b], mr[a][b], mi[a][b], e0,
                        e1, e2, e3, o, kr[a][b], ki[a][b]);
        if (ksr != nullptr && j < iters) {
          ksr[(size_t)j * NN + o] = kr[a][b];
          ksi[(size_t)j * NN + o] = ki[a][b];
        }
      }
  }
}

// Start the copy of a whole (N, N) pair (sr, si) from device memory into the
// shared planes (Ur, Ui) of row stride ld by cp.async: the thread does not
// wait. finish_u waits for the thread's own copies and, with rot, rotates
// the entries it copied by E (the split frame); a barrier after it shows
// the whole pair to the block.
__device__ __forceinline__ void issue_u(float* Ur, float* Ui, const float* sr,
                                        const float* si, int N, int ld) {
  const int NN = N * N;
  for (int e = threadIdx.x; e < NN; e += blockDim.x) {
    const int p = e / N, o = p * ld + (e - p * N);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                     smem_u32(Ur + o)),
                 "l"(sr + e)
                 : "memory");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                     smem_u32(Ui + o)),
                 "l"(si + e)
                 : "memory");
  }
}

__device__ __forceinline__ void finish_u(float* Ur, float* Ui, int N, int ld,
                                         const float* e0, const float* e1,
                                         bool rot) {
  asm volatile("cp.async.wait_all;" ::: "memory");
  if (!rot) return;
  const int NN = N * N;
  for (int e = threadIdx.x; e < NN; e += blockDim.x) {
    const int p = e / N, o = p * ld + (e - p * N);
    cmul_rn(e0, e1, e, Ur[o], Ui[o]);
  }
}

}  // namespace

// Forward: a cluster of G CTAs per (candidate e, initial condition ib), each
// CTA on its band of rows (see the header). x0 (B, N, N) shared by all
// candidates; C (E, nt, K); el the entrywise solver planes, each (N, N):
// jacobi (d_r, d_i, minv_r, minv_i), split (e_r, e_i, d_r, d_i). Writes xT
// (E, B, N, N), hist (E, nt, B, N, N) and, with store, the stage iterates
// k_0..k_{iters-1} (E, B, nt, iters, N, N). Shared memory: two mbarriers
// (the operand buffers), M, the operand F (two buffers), jb jump bands.
template <int TS>
__global__ void __launch_bounds__(TS == 4 ? 256 : 512)
rho_fwd(const float* __restrict__ Sr, const float* __restrict__ Si,
        const float* __restrict__ L, const float* __restrict__ C,
        const float* __restrict__ x0r, const float* __restrict__ x0i,
        const float* __restrict__ el, float* __restrict__ xTr,
        float* __restrict__ xTi, float* __restrict__ hr,
        float* __restrict__ hi, float* __restrict__ ksr,
        float* __restrict__ ksi, Dims d, int G, int jb) {
  extern __shared__ __align__(16) float smf[];
  cg::cluster_group cl = cg::this_cluster();
  const int N = d.N, NN = N * N, ld = N | 1, plane = N * ld;
  const int rank = (int)cl.block_rank();
  const int r0 = rank * N / G, R = (rank + 1) * N / G - r0;
  const int Rmax = (N + G - 1) / G;
  const unsigned bars = smem_u32(smf);    // 2 mbarriers of 8 bytes
  float* Mr = smf + 8;
  float* Mi = Mr + plane;
  float* F = Mi + plane;        // the operand, 2 buffers of (re, im)
  float* tb = F + 4 * plane;    // jb jump bands of (re, im) Rmax x ld

  const int blk = blockIdx.x / G, e = blk / d.B, ib = blk - e * d.B;
  const bool jac = d.mode == MODE_JACOBI, split = d.mode == MODE_SPLIT;
  const float *e0 = el, *e1 = el + NN;
  int r[TS], c[TS];
  bool ok[TS][TS];
  band_ownership<TS>(N, r0, R, Rmax, r, c, ok);
  const Gen g{Mr, Mi, tb, L, split ? el + 2 * NN : nullptr,
              split ? el + 3 * NN : nullptr, r0, N, ld, Rmax, d.J, jb};
  Exchange ex{F, plane, G, rank, bars,
              threadIdx.x == 0 ? 8u * N * (N - R) : 0u, 0};
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k) bar_init(bars + 8 * k, blockDim.x);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cl.sync();            // every CTA's mbarriers exist before any push

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
    __syncthreads();            // the previous step's reads of M are done
    contract(Sr, Si, C + st * d.K, Mr, Mi, d.K, N, ld);
    if (split) {
#pragma unroll
      for (int a = 0; a < TS; ++a)
#pragma unroll
        for (int b = 0; b < TS; ++b)
          if (ok[a][b]) cmul_rn(e0, e1, r[a] * N + c[b], xr[a][b], xi[a][b]);
    }
    // x whole in every CTA; the exchange also shows M to the block
    const float* xs = ex.share<TS>(xr, xi, r, c, ok, ld);
    float kr[TS][TS], ki[TS][TS];
    stage_chain<TS>(kr, ki, xs, xs + plane, d.iters, ex, g, r, c, ok, jac,
                    d.a, el, d.iters, d.store ? ksr + ks0 : nullptr,
                    d.store ? ksi + ks0 : nullptr);
#pragma unroll
    for (int a = 0; a < TS; ++a)
#pragma unroll
      for (int b = 0; b < TS; ++b) {
        if (!ok[a][b]) continue;
        const int o = r[a] * N + c[b];
        xr[a][b] = fmaf(d.dt, kr[a][b], xr[a][b]);
        xi[a][b] = fmaf(d.dt, ki[a][b], xi[a][b]);
        if (split) cmul_rn(e0, e1, o, xr[a][b], xi[a][b]);
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
  cl.sync();            // no CTA leaves while another may still push to it
}

// Backward: runs the steps in reverse, on a cluster of G CTAs per (candidate
// e, initial condition ib), each CTA on its band of rows (see the header).
// Inputs as the forward's plus the history (E, nt, B, N, N), its cotangent j
// (same shape) and the final-state cotangent gT (E, B, N, N). ks holds the
// forward's stage iterates (E, B, nt, iters, N, N) with store, else it is a
// scratch (E, B, iters, N, N) that the replay of each step fills, band by
// band. Writes the x0 cotangent of every matrix g0 (E, B, N, N), which also
// parks the running cotangent during a step, and the coefficient cotangents
// of every matrix Cb (E, B, nt, K). Shared memory: three mbarriers (the two
// operand buffers, C-bar), M, the operand F and the pair's input U (two
// buffers each), jb jump scratch bands, the warps' C-bar partials and the
// cluster's (rank 0's).
template <int TS>
__global__ void __launch_bounds__(TS == 4 ? 256 : 512)
rho_bwd(const float* __restrict__ Sr, const float* __restrict__ Si,
        const float* __restrict__ L, const float* __restrict__ C,
        const float* __restrict__ x0r, const float* __restrict__ x0i,
        const float* __restrict__ hr, const float* __restrict__ hi,
        const float* __restrict__ jr, const float* __restrict__ ji,
        const float* __restrict__ gTr, const float* __restrict__ gTi,
        const float* __restrict__ el, float* ksr, float* ksi, float* g0r,
        float* g0i, float* __restrict__ Cb, Dims d, int G, int jb) {
  extern __shared__ __align__(16) float smb[];
  cg::cluster_group cl = cg::this_cluster();
  const int N = d.N, NN = N * N, ld = N | 1, plane = N * ld;
  const int iters = d.iters, K = d.K;
  const int rank = (int)cl.block_rank();
  const int r0 = rank * N / G, R = (rank + 1) * N / G - r0;
  const int Rmax = (N + G - 1) / G;
  const unsigned bars = smem_u32(smb);    // 3 mbarriers of 8 bytes
  float* Mr = smb + 8;
  float* Mi = Mr + plane;
  float* F = Mi + plane;        // the operand, 2 buffers of (re, im)
  float* U = F + 4 * plane;     // the pair's input, 2 buffers of (re, im)
  float* tb = U + 4 * plane;    // jb jump bands of (re, im) Rmax x ld
  float* red = tb + (size_t)2 * jb * Rmax * ld;     // (nwarps, K)
  float* slots = red + (blockDim.x >> 5) * K;       // (G, K), rank 0's

  const int blk = blockIdx.x / G, e = blk / d.B, ib = blk - e * d.B;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool jac = d.mode == MODE_JACOBI, split = d.mode == MODE_SPLIT;
  const float *e0 = el, *e1 = el + NN, *e2 = el + 2 * NN, *e3 = el + 3 * NN;
  int r[TS], c[TS];
  bool ok[TS][TS];
  band_ownership<TS>(N, r0, R, Rmax, r, c, ok);
  const Gen g{Mr, Mi, tb, L, split ? e2 : nullptr, split ? e3 : nullptr,
              r0, N, ld, Rmax, d.J, jb};
  const size_t gb = (size_t)blk * NN;
  // bytes the other CTAs push per exchange (thread 0 expects them), and
  // per C-bar reduction into rank 0
  Exchange ex{F, plane, G, rank, bars, tid == 0 ? 8u * N * (N - R) : 0u, 0};
  const unsigned tx_c = tid == 0 ? 4u * (G - 1) * K : 0u;
  if (tid == 0) {
    for (int k = 0; k < 3; ++k) bar_init(bars + 8 * k, blockDim.x);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cl.sync();            // every CTA's mbarriers exist before any push
  int pu = 0;           // pair inputs so far: U buffer pu & 1
  auto Ubuf = [&](int k) { return U + (k & 1) * 2 * plane; };

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
    // pre-step state: x0 at t = 0, else the previous history entry
    const size_t xp = t == 0 ? (size_t)ib * NN : h0 - (size_t)d.B * NN;
    const float* xpr = (t == 0 ? x0r : hr) + xp;
    const float* xpi = (t == 0 ? x0i : hi) + xp;
    // (the previous step's reads of M ended before the C-bar block barrier)
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
        if (split) cmul_conj_rn(e0, e1, o, gr[a][b], gi[a][b]);
        g0r[gb + o] = gr[a][b];
        g0i[gb + o] = gi[a][b];
      }

    if (!d.store && iters > 0) {      // replay the stage iterates into ks
      float* ur = Ubuf(pu++);
      issue_u(ur, ur + plane, xpr, xpi, N, ld);
      finish_u(ur, ur + plane, N, ld, e0, e1, split);
      __syncthreads();
      float kr[TS][TS], ki[TS][TS];
      stage_chain<TS>(kr, ki, ur, ur + plane, iters - 1, ex, g, r, c, ok, jac,
                      d.a, el, iters, ksr + ks0, ksi + ks0);
      // the other CTAs' replayed bands of ks are read whole below: a
      // cluster barrier (its acquire covers device memory) once per step
      if (G > 1)
        cl.sync();
      else
        __syncthreads();
    }

    // transpose of the stage chain, pairs i = 0..iters: for i < iters the
    // pair's cotangent is c = a * k-bar and its input u = k_{iters-1-i};
    // the last pair is (b-bar + k-bar, x_pre). Each pair's u is copied a
    // pair ahead, the first one here.
    {
      const size_t o = ks0 + (size_t)(iters - 1) * NN;
      issue_u(Ubuf(pu), Ubuf(pu) + plane, iters == 0 ? xpr : ksr + o,
              iters == 0 ? xpi : ksi + o, N, ld);
    }
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
    for (int i = 0; i <= iters; ++i) {
      const bool last = i == iters;
      float* fr = ex.buf();
#pragma unroll
      for (int a = 0; a < TS; ++a)
#pragma unroll
        for (int b = 0; b < TS; ++b) {
          if (!ok[a][b]) continue;
          const int o = r[a] * N + c[b], so = r[a] * ld + c[b];
          if (jac) cmul_conj_rn(e2, e3, o, kbr[a][b], kbi[a][b]);    // Wt
          if (last) {
            ex.put(fr, so, bbr[a][b] + kbr[a][b], bbi[a][b] + kbi[a][b]);
          } else {
            bbr[a][b] += kbr[a][b];
            bbi[a][b] += kbi[a][b];
            ex.put(fr, so, d.a * kbr[a][b], d.a * kbi[a][b]);
          }
        }
      float* ur = Ubuf(pu++);
      finish_u(ur, ur + plane, N, ld, e0, e1, split && last);
      ex.wait();
      if (!last) {
        float* un = Ubuf(pu);
        const bool nl = i + 1 == iters;
        const size_t o = ks0 + (size_t)(iters - 2 - i) * NN;
        issue_u(un, un + plane, nl ? xpr : ksr + o, nl ? xpi : ksi + o, N,
                ld);
      }
      band_gen<TS, true>(kbr, kbi, g, fr, fr + plane, r, c, ok);
      if (jac && !last) {       // minus the transpose of v -> d v
#pragma unroll
        for (int a = 0; a < TS; ++a)
#pragma unroll
          for (int b = 0; b < TS; ++b) {
            if (!ok[a][b]) continue;
            const int o = r[a] * N + c[b], so = r[a] * ld + c[b];
            float qr = fr[so], qi = fr[plane + so];
            cmul_conj_rn(e0, e1, o, qr, qi);
            kbr[a][b] -= qr;
            kbi[a][b] -= qi;
          }
      }
      cmm<TS, false, true>(wr, wi, fr, fr + plane, ld, 1, ur, ur + plane, 1,
                           ld, r, c, N);
      cmm<TS, true, false>(wr, wi, fr, fr + plane, 1, ld, ur, ur + plane, ld,
                           1, r, c, N);
    }
#pragma unroll
    for (int a = 0; a < TS; ++a)
#pragma unroll
      for (int b = 0; b < TS; ++b) {
        gr[a][b] = gi[a][b] = 0.f;
        if (!ok[a][b]) continue;
        const int o = r[a] * N + c[b];
        gr[a][b] = g0r[gb + o] + kbr[a][b];
        gi[a][b] = g0i[gb + o] + kbi[a][b];
        if (split) cmul_conj_rn(e0, e1, o, gr[a][b], gi[a][b]);
      }

    // Cb[t, k] = <dA_r, Sr_k> + <dA_i, Si_k> with dA_i = Re W, dA_r = -Im W:
    // each warp's partial over its entries, the CTA's over its warps in
    // order, pushed into rank 0's slot of this rank; rank 0 sums the slots
    // in rank order
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
      float* slot = slots + rank * K + tid;
      if (rank == 0) {
        *slot = v;
      } else {
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
            "[%0], %1, [%2];" ::"r"(mapa(smem_u32(slot), 0)),
            "r"(__float_as_uint(v)), "r"(mapa(bars + 16, 0))
            : "memory");
      }
    }
    if (rank == 0) {
      bar_sync(bars + 16, tx_c, (d.nt - 1 - t) & 1);
      if (tid < K) {
        float v = 0.f;
        for (int q = 0; q < G; ++q) v += slots[q * K + tid];
        Cb[((size_t)blk * d.nt + t) * K + tid] = v;
      }
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
  cl.sync();            // no CTA leaves while another may still push to it
}

// Plain C entry points, bound from Python with ctypes. Each launches on the
// given stream and returns the launch's error (0 on success). Both kernels
// launch E * B clusters of `cluster` CTAs; their tile is 1, 2 (up to 512
// threads) or 4 (up to 256), on the CTA's band.
namespace {

// The jump bands a launch shape leaves room for, or -1 where the shape does
// not fit what the kernel carves: G in {1, 2, 4, 8, 16} and at most N (a
// row per CTA), whole warps covering the band's tiles (and at least
// `least` threads) within the instance's bound, and shared memory for
// `fixed` floats and at least one jump band; jb is what the rest of
// smem_bytes holds, at most J.
template <int TS>
long jump_bands(const Dims& d, int G, int threads, int smem_bytes, long fixed,
                int least) {
  const int N = d.N, ld = N | 1, Rmax = (N + G - 1) / G;
  const long tiles = (long)((Rmax + TS - 1) / TS) * ((N + TS - 1) / TS);
  const long jb = d.J == 0 ? 0
                           : std::min<long>(d.J, (smem_bytes / 4 - fixed) /
                                                     (2L * Rmax * ld));
  if ((G != 1 && G != 2 && G != 4 && G != 8 && G != 16) || G > N ||
      threads % 32 != 0 || threads < tiles || threads < least ||
      threads > (TS == 4 ? 256 : 512) || smem_bytes > 227 * 1024 ||
      smem_bytes / 4 < fixed || (d.J > 0 && jb < 1))
    return -1;
  return jb;
}

// The launch configuration of `clusters` clusters of G CTAs of `kernel`,
// with the kernel's attributes for its shared memory and, for G > 8, for a
// cluster beyond the portable size.
template <typename Kernel>
cudaLaunchConfig_t cluster_config(Kernel kernel, cudaLaunchAttribute* attr,
                                  int clusters, int G, int threads,
                                  int smem_bytes, cudaStream_t stream) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_bytes);
  if (G > 8)
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = G;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * G);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of G CTAs of `kernel` the card can hold at once
// (cudaOccupancyMaxActiveClusters; 0 where it holds none, or on an error).
template <typename Kernel>
int max_clusters(Kernel kernel, int G, int threads, int smem_bytes) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(kernel, attr, 1, G, threads, smem_bytes, nullptr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

// The forward's launch: its shape is checked against the layout (two
// mbarriers in 8 floats, M, the operand's two buffers, the jump bands)
// before anything is launched.
template <int TS>
int launch_fwd(const float* Sr, const float* Si, const float* L,
               const float* C, const float* x0r, const float* x0i,
               const float* el, float* xTr, float* xTi, float* hr, float* hi,
               float* ksr, float* ksi, const Dims& d, int G, int threads,
               int smem_bytes, cudaStream_t stream) {
  const long jb = jump_bands<TS>(d, G, threads, smem_bytes,
                                 8 + 6L * d.N * (d.N | 1), 1);
  if (jb < 0) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      rho_fwd<TS>, attr, d.E * d.B, G, threads, smem_bytes, stream);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, rho_fwd<TS>, Sr, Si, L, C, x0r, x0i, el, xTr,
                         xTi, hr, hi, ksr, ksi, d, G, (int)jb);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The backward's launch: the same check against its layout (three
// mbarriers in 8 floats, M, F and U two buffers each, the warps' and the
// cluster's C-bar partials, the jump bands), and threads for the K stack
// slots.
template <int TS>
int launch_bwd(const float* Sr, const float* Si, const float* L,
               const float* C, const float* x0r, const float* x0i,
               const float* hr, const float* hi, const float* jr,
               const float* ji, const float* gTr, const float* gTi,
               const float* el, float* ksr, float* ksi, float* g0r, float* g0i,
               float* Cb, const Dims& d, int G, int threads, int smem_bytes,
               cudaStream_t stream) {
  const long fixed = 8 + 10L * d.N * (d.N | 1) +
                     (long)(threads / 32) * d.K + (long)G * d.K;
  const long jb = jump_bands<TS>(d, G, threads, smem_bytes, fixed, d.K);
  if (jb < 0) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      rho_bwd<TS>, attr, d.E * d.B, G, threads, smem_bytes, stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, rho_bwd<TS>, Sr, Si, L, C, x0r, x0i, hr, hi, jr, ji, gTr, gTi, el,
      ksr, ksi, g0r, g0i, Cb, d, G, (int)jb);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rho_fwd_launch(
    const void* Sr, const void* Si, const void* L, const void* C,
    const void* x0r, const void* x0i, const void* el, void* xTr, void* xTi,
    void* hr, void* hi, void* ksr, void* ksi, int E, int nt, int B, int N,
    int K, int J, int iters, int mode, int store, float dt, float a, int tile,
    int cluster, int threads, int smem_bytes, void* stream) {
  Dims d{E, nt, B, N, K, J, iters, mode, store, dt, a};
#define RHO_FWD_ARGS                                                          \
  (const float*)Sr, (const float*)Si, (const float*)L, (const float*)C,       \
      (const float*)x0r, (const float*)x0i, (const float*)el, (float*)xTr,    \
      (float*)xTi, (float*)hr, (float*)hi, (float*)ksr, (float*)ksi, d,       \
      cluster, threads, smem_bytes, (cudaStream_t)stream
  switch (tile) {
    case 1: return launch_fwd<1>(RHO_FWD_ARGS);
    case 2: return launch_fwd<2>(RHO_FWD_ARGS);
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
    float dt, float a, int tile, int cluster, int threads, int smem_bytes,
    void* stream) {
  Dims d{E, nt, B, N, K, J, iters, mode, store, dt, a};
#define RHO_BWD_ARGS                                                          \
  (const float*)Sr, (const float*)Si, (const float*)L, (const float*)C,       \
      (const float*)x0r, (const float*)x0i, (const float*)hr,                 \
      (const float*)hi, (const float*)jr, (const float*)ji,                   \
      (const float*)gTr, (const float*)gTi, (const float*)el, (float*)ksr,    \
      (float*)ksi, (float*)g0r, (float*)g0i, (float*)Cb, d, cluster,         \
      threads, smem_bytes, (cudaStream_t)stream
  switch (tile) {
    case 1: return launch_bwd<1>(RHO_BWD_ARGS);
    case 2: return launch_bwd<2>(RHO_BWD_ARGS);
    case 4: return launch_bwd<4>(RHO_BWD_ARGS);
  }
#undef RHO_BWD_ARGS
  return (int)cudaErrorInvalidValue;
}

// How many clusters of G CTAs of either kernel's instance `tile`, with
// `threads` threads and smem_bytes of shared memory each, the card can hold
// at once: clusters of 16 are beyond the portable size.
extern "C" int rho_fwd_max_clusters(int tile, int cluster, int threads,
                                    int smem_bytes) {
  switch (tile) {
    case 1: return max_clusters(rho_fwd<1>, cluster, threads, smem_bytes);
    case 2: return max_clusters(rho_fwd<2>, cluster, threads, smem_bytes);
    case 4: return max_clusters(rho_fwd<4>, cluster, threads, smem_bytes);
  }
  return 0;
}

extern "C" int rho_bwd_max_clusters(int tile, int cluster, int threads,
                                    int smem_bytes) {
  switch (tile) {
    case 1: return max_clusters(rho_bwd<1>, cluster, threads, smem_bytes);
    case 2: return max_clusters(rho_bwd<2>, cluster, threads, smem_bytes);
    case 4: return max_clusters(rho_bwd<4>, cluster, threads, smem_bytes);
  }
  return 0;
}
