// Density-matrix (Lindblad) propagation kernels for Hopper (sm_90a) past the
// size csrc/rho.cu holds: open systems of 64 < N <= 128. This file holds
// the backward, rho_mid_bwd, and the forward's stage chain it replays (in
// the forward's order of terms); the forward itself, rho_mid_fwd, is
// csrc/rho_mid_fwd.cu, and csrc/rho_mid.cuh what both share. The contract
// is rho.cu's (the whole IMR time loop of d rho/dt = T(rho) in ONE launch
// per direction, the (N, N) state as plane pairs), and so is the algebra:
//
//   T(rho) = M rho + rho M^dag + sum_l L_l rho L_l^dag,   M = -i H_eff(t),
//   H_eff(t) = sum_k c_k(t) S_k  (the -i/2 sum L^dag L fold sits in S_0),
//
// neumann, jacobi and split stage solves, the exact real transpose
//   Tt(g) = M^dag g + g M + sum_l L_l^dag g L_l
// in the backward, and Cb[t, k] = <dA_r, Sr_k> + <dA_i, Si_k> of the H_eff
// cotangent W = sum_pairs (c u^dag + c^dag u), dA_i = Re W, dA_r = -Im W.
//
// Replaces the backward pallas_call of
// quandary_tpu/ops/pallas_rho.py::make_rho_propagate (:494; the forward's,
// :374, is csrc/rho_mid_fwd.cu) for 64 < N <= 128, the rest of the
// TPU kernel's range (one 128-lane tile, P_rho = 128: the JAX Problem's
// lane-group line, quandary_tpu/problem.py:517, admits no N past 128).
//
// Why rho.cu cannot simply be widened: each of its CTAs holds M(t) and the
// operand whole, six (N, N) planes forward and ten backward. One plane of
// stride N | 1 is 66 KB at N = 128, so one CTA's 227 KB hold ONE whole
// complex pair beside the bands. Of the factors a band of T needs whole
// (all of v for M v and L_l v; all of M for v M^dag; Tt needs all of M for
// both its M products), at most one can stay in shared memory.
//
// Layout of the backward (the choice "operand whole, M in L2"; the forward's
// is in csrc/rho_mid_fwd.cu): one thread-block cluster of
// G CTAs per (control candidate, density matrix), G in {4, 8, 16}; CTA q
// owns rows [q N / G, (q + 1) N / G) of every (N, N) quantity the kernel
// produces, its threads TS x TS entries of the band as in rho.cu.
//  * The operand v (forward: the state and the stage iterates; backward:
//    the cotangents) stays whole in each CTA, ONE buffer of (re, im) planes.
//    It is exchanged as in rho.cu: each thread stores its entries in its
//    CTA's copy and pushes them by st.async into the others', one mbarrier
//    counting the bytes. Since the buffer is single, a cluster barrier
//    before each exchange tells every CTA that all others have finished
//    reading the previous operand.
//  * M(t) is contracted band by band, each CTA its R rows, into a
//    per-cluster scratch in device memory that L2 serves (2 N^2 floats per
//    layout, double-buffered by step parity), made visible by one cluster
//    barrier per step, and read with ld.global.cg inside the products: the
//    forward keeps it transposed (v M^dag reads M's rows along the lanes),
//    the backward row-major (u M), and transposed too where it replays.
//  * The jump and solver planes are read from device memory as in rho.cu;
//    the jump bands L_l v sit in shared memory.
//  * The backward's two products of the H_eff cotangent need only bands
//    of each pair's input u (the stored or replayed stage iterate, or the
//    pre-step state in the split frame, which each CTA writes band by band
//    into the scratch): u c^dag, the adjoint of c u^dag's band (its factor
//    c^dag is the shared operand read along a row, free of bank
//    conflicts), needs u's row band, and c^dag u, taken by column band,
//    u's column band. Each CTA copies both bands into shared memory by
//    cp.async while the pair's Tt runs. Both halves meet the transposed
//    stacks in C-bar: <c u^dag, S> = <u c^dag, S^T> entry for entry, and
//    c^dag u's entry (c, r) meets S^T(r, c).
//  * Where the backward replays its iterates, the replay runs on clusters
//    of its own a few steps ahead of the adjoint (the 'split' schedule,
//    below), or in the adjoint's chain before each step's pairs.
//
// Arithmetic and order: exact f32 FMA on the CUDA cores; every entry is one
// thread's fixed chain of fmaf (j = 0 .. N-1 in every product, jump
// operators in l's order) and every entrywise product is rounded as
// written, never contracted. So xT, the history, the stored iterates and
// g0 have the same bits at every G and tile. Cb is reduced without
// atomics: each CTA's warps in order, the cluster's ranks in order at rank
// 0.
//
// A fork to retire: the forward's stage chain has two implementations.
// The forward runs its own (csrc/rho_mid_fwd.cu, Cta::gen and band_mma,
// on its layout); the backward's replay runs stage_chain / band_gen below,
// the chain the forward ran before its redesign. Replayed and stored
// iterates have the same bits only while both keep each entry's fmaf order
// (j = 0 .. N-1, the terms M v, v M^dag, then each jump operator's in l's
// order, the stage update as written): chip_smoke.py's stored_replayed
// check and the card tests hold them equal, and an edit to either chain
// has to be made in both. When rho_mid_bwd is next redesigned, Cta::gen
// moves into csrc/rho_mid.cuh and the replay calls it (ROADMAP).
//
// What bounds it on the H100: operations. One T is (8 + 8 J) real N^3
// products, 109 MFLOP at N = 125 with 6 jump operators, and a step runs
// iters + 1 of them in a dependent chain over a matrix's G SMs. Each T pays
// a cluster barrier and an exchange of 8 N^2 (G - 1) / G bytes of
// distributed shared memory per CTA, and reads M and the jump planes from
// L2. The backward's chain is its iters + 1 Tt a step; its replay (iters
// T a step, 40% of the single-role backward at N = 125) runs beside it on
// SMs that would idle, where the card holds both roles. Tensor-core
// products and fewer barriers are later work.

#include <algorithm>

#include "rho_mid.cuh"

namespace {

// loads of a product's factor: shared memory (or read-only planes), or
// device memory written inside this launch, through L2 only
struct LdS {
  static __device__ __forceinline__ float ld(const float* p) { return *p; }
};
struct LdG {
  static __device__ __forceinline__ float ld(const float* p) {
    return __ldcg(p);
  }
};

// Z += X Y on the thread's entries (rows r[], columns c[]) for complex
// matrices given as plane pairs: X element (row, j) at row * sxr + j * sxj,
// Y element (j, col) at j * syj + col * syc. CX / CY conjugate the operand, so
// that a transposed stride pair reads its Hermitian adjoint; LX / LY load.
template <int TS, bool CX, bool CY, class LX, class LY>
__device__ __forceinline__ void cmm(float (&zr)[TS][TS], float (&zi)[TS][TS],
                                    const float* Xr, const float* Xi, int sxr,
                                    int sxj, const float* Yr, const float* Yi,
                                    int syj, int syc, const int (&r)[TS],
                                    const int (&c)[TS], int n) {
#pragma unroll(TS == 4 ? 4 : 8)
  for (int j = 0; j < n; ++j) {
    float xr[TS], xi[TS], yr[TS], yi[TS];
#pragma unroll
    for (int a = 0; a < TS; ++a) {
      const int o = r[a] * sxr + j * sxj;
      xr[a] = LX::ld(Xr + o);
      xi[a] = CX ? -LX::ld(Xi + o) : LX::ld(Xi + o);
    }
#pragma unroll
    for (int b = 0; b < TS; ++b) {
      const int o = j * syj + c[b] * syc;
      yr[b] = LY::ld(Yr + o);
      yi[b] = CY ? -LY::ld(Yi + o) : LY::ld(Yi + o);
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

// The CTA's R rows from r0 of M = -i sum_k c_k S_k (M_r = A_i, M_i = -A_r)
// into the (N, N) scratch planes: row-major into (Mr, Mi) and transposed into
// (Tr, Ti), each where given. The chain over k is rho.cu's.
__device__ __forceinline__ void contract_band(
    const float* __restrict__ Sr, const float* __restrict__ Si,
    const float* __restrict__ c, int K, int N, int r0, int R, float* Mr,
    float* Mi, float* Tr, float* Ti) {
  const int NN = N * N;
  for (int e = r0 * N + threadIdx.x; e < (r0 + R) * N; e += blockDim.x) {
    float ar = 0.f, ai = 0.f;
    for (int k = 0; k < K; ++k) {
      const float ck = __ldg(c + k);
      ar = fmaf(ck, __ldg(Sr + k * NN + e), ar);
      ai = fmaf(ck, __ldg(Si + k * NN + e), ai);
    }
    if (Mr != nullptr) {
      Mr[e] = ai;
      Mi[e] = -ar;
    }
    if (Tr != nullptr) {
      const int p = e / N, q = e - p * N;
      Tr[q * N + p] = ai;
      Ti[q * N + p] = -ar;
    }
  }
}

// v <- conj(p) v, rounded as written.
__device__ __forceinline__ void cmul_conj_rn(const float* __restrict__ pr,
                                             const float* __restrict__ pi,
                                             int o, float& vr, float& vi) {
  const float ar = pr[o], ai = pi[o];
  const float t = __fadd_rn(__fmul_rn(ar, vr), __fmul_rn(ai, vi));
  vi = __fsub_rn(__fmul_rn(ar, vi), __fmul_rn(ai, vr));
  vr = t;
}

// The thread's entries of the band of R rows from row r0 (clamped into
// range) and which of them exist; tile rows strided by the tile-row count of
// the longest band, Rmax, so every CTA of a cluster maps its threads alike.
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

// What band_gen reads besides its operand: the step's M in the scratch
// (transposed for T, row-major for Tt; (N, N) planes of row stride N), jb
// jump scratch bands of Rmax x ld (re, then im) at tb, the global
// (4, J, N, N) jump array [L_r, L_i, Lh_r, Lh_i] with Lh = L^dag, the global
// planes of the split stepper's diagonal (dr, di) or null, and the CTA's
// band from row r0.
struct Gen {
  const float* Mr;
  const float* Mi;
  float* tb;
  const float* L;
  const float* dr;
  const float* di;
  int r0, N, ld, Rmax, J, jb;
};

// acc = T(v) (ADJ = false, M transposed) or Tt(v) (ADJ = true, M row-major)
// on the thread's entries of its band, v whole in shared memory (row stride
// ld), the terms in rho.cu's order:
//   T(v)  = M v + v M^dag + sum_l (L_l v) L_l^dag - d * v
//   Tt(u) = M^dag u + u M + sum_l (L_l^dag u) L_l - conj(d) * u.
// Every thread of the block must call it (it synchronizes when J > 0).
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
    // M v: M(r, j) = Mt(j, r); v M^dag: conj(M(c, j)) = conj(Mt(j, c))
    cmm<TS, false, false, LdG, LdS>(accr, acci, g.Mr, g.Mi, 1, N, vr, vi, ld,
                                    1, r, c, N);
    cmm<TS, false, true, LdS, LdG>(accr, acci, vr, vi, ld, 1, g.Mr, g.Mi, N,
                                   1, r, c, N);
  } else {
    // M^dag u: conj(M(j, r)); u M: M(j, c)
    cmm<TS, true, false, LdG, LdS>(accr, acci, g.Mr, g.Mi, 1, N, vr, vi, ld,
                                   1, r, c, N);
    cmm<TS, false, false, LdS, LdG>(accr, acci, vr, vi, ld, 1, g.Mr, g.Mi, N,
                                    1, r, c, N);
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
      cmm<TS, false, false, LdS, LdS>(zr, zi, Ar, Ai, N, 1, vr, vi, ld, 1, r,
                                      c, N);
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
      cmm<TS, false, false, LdS, LdS>(accr, acci, tr, tr + bplane, ld, 1, Br,
                                      Bi, N, 1, rl, c, N);
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

// The exchange of the operand between the CTAs of a cluster (rho.cu's, on one
// buffer): each thread stores its entries in its CTA's buffer and pushes them
// by st.async into the same place of every other CTA's buffer, each push
// counting its bytes on the destination's mbarrier; every thread then
// arrives on its own CTA's mbarrier and waits for the phase. The wait
// acquires at CTA scope (it also shows the CTA's own stores to all its
// threads). The caller passes a cluster barrier before each exchange, after
// which no CTA reads the buffer's previous contents.
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

struct Exchange {
  float* F;       // the operand, (re, im) planes of row stride ld
  int plane, G, rank;
  unsigned bar;
  unsigned tx;    // bytes the other CTAs push per exchange (thread 0), else 0
  int p;          // exchanges so far

  __device__ void put(int so, float vr, float vi) const {
    F[so] = vr;
    F[plane + so] = vi;
    push(F + so, vr, bar, G, rank);
    push(F + plane + so, vi, bar, G, rank);
  }

  __device__ void wait() {
    bar_sync(bar, tx, p & 1);
    ++p;
  }

  // the thread's existing entries of v into the buffer, and the wait:
  // returns the buffer, whole
  template <int TS>
  __device__ const float* share(const float (&vr)[TS][TS],
                                const float (&vi)[TS][TS], const int (&r)[TS],
                                const int (&c)[TS], const bool (&ok)[TS][TS],
                                int ld) {
#pragma unroll
    for (int a = 0; a < TS; ++a)
#pragma unroll
      for (int b = 0; b < TS; ++b)
        if (ok[a][b]) put(r[a] * ld + c[b], vr[a][b], vi[a][b]);
    wait();
    return F;
  }
};

// The stage chain of one step on the thread's entries of its band, for the
// backward's replay (rho.cu's, and the forward's order of terms and bits,
// csrc/rho_mid_fwd.cu): b = T(v) from the
// pre-step state v (rotated by E where split), already exchanged into the
// operand buffer; k_0 = b (jacobi: Minv b); then for j = 1..n: a cluster
// barrier, k exchanged, m = T(k), k <- the stage update. k_j is stored at
// ks + j N^2 for j < iters where ksr is given. Ends with k_n in (kr, ki).
template <int TS>
__device__ __forceinline__ void stage_chain(
    float (&kr)[TS][TS], float (&ki)[TS][TS], int n, Exchange& ex,
    const Gen& g, const int (&r)[TS], const int (&c)[TS],
    const bool (&ok)[TS][TS], bool jac, float ha,
    const float* __restrict__ el, int iters, float* ksr, float* ksi) {
  const int N = g.N, NN = N * N;
  const float *e0 = el, *e1 = el + NN, *e2 = el + 2 * NN, *e3 = el + 3 * NN;
  float br[TS][TS], bi[TS][TS];
  band_gen<TS, false>(br, bi, g, ex.F, ex.F + ex.plane, r, c, ok);
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
    cluster_sync();     // every CTA has finished reading the operand
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

}  // namespace

// The backward's two roles and their hand-off. With replayed iterates (no
// store, iters > 0) the schedule is either 'chain', one cluster per density
// matrix that replays each step's stage chain before its pairs (the
// single-role order), or 'split': two clusters per matrix, one replaying the
// steps into a ring of W slots of device memory (each slot a step's iters
// iterates, ring slot s mod W for the s-th step in reverse) a few steps
// ahead of the other, the adjoint, which runs only the pairs. flags (ints,
// zeroed by the wrapper): the ticket counter, a claim word per matrix, then
// per (matrix, slot) the count of CTAs that filled it ("full") and of CTAs
// that have copied the last iterate out of it ("empty"). A cluster takes its
// matrix and role by ticket in the order it starts: ticket 2m replays matrix
// m, 2m + 1 is its adjoint, so an adjoint only waits on a replay that
// started before it. The replay writes slot s mod W of step s >= W only
// after the adjoint has emptied step s - W; at step W, if no adjoint has
// claimed the matrix yet (the card holds too few clusters), the replay hands
// the rest of the steps to it and ends: the claim word says from which step
// the adjoint replays in its own chain. So no cluster waits on one that has
// not started.
namespace {

constexpr int CLAIMED = 1 << 30;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The pair input u's row band [r0, r0 + R) into (Ur, Ur + Rmax ld) (row
// stride ld) and its column band into (Uc, Uc + N Rmax) (N rows of stride
// Rmax), from the (N, N) planes ur, ui, by cp.async: the two cotangent
// products read nothing else of u.
__device__ __forceinline__ void copy_bands(float* Ur, float* Uc,
                                           const float* ur, const float* ui,
                                           int N, int r0, int R, int ld,
                                           int Rmax) {
  for (int e = threadIdx.x; e < R * N; e += blockDim.x) {
    const int q = e / N, j = e - q * N;
    cp_async4(Ur + q * ld + j, ur + (r0 + q) * N + j);
    cp_async4(Ur + Rmax * ld + q * ld + j, ui + (r0 + q) * N + j);
    const int jj = e / R, qq = e - jj * R;
    cp_async4(Uc + jj * Rmax + qq, ur + jj * N + r0 + qq);
    cp_async4(Uc + N * Rmax + jj * Rmax + qq, ui + jj * N + r0 + qq);
  }
}

// Everything a backward CTA reads and writes (the kernel's arguments).
struct Bwd {
  const float *Sr, *Si, *St, *L, *C, *x0r, *x0i, *hr, *hi, *jr, *ji, *gTr,
      *gTi, *el;
  float *ksr, *ksi, *g0r, *g0i, *Cb, *scr;
  int* flags;
  Dims d;
  int G, jb, split, W;
};

// device-memory scratch per density matrix, in N^2 floats: per step parity
// the adjoint's M row-major, M transposed (for its own replay) and the
// pre-step state in the split frame, each a (re, im) pair; then the replay
// role's M transposed for the two parities
constexpr int BWD_SCRATCH = 16;

// The CTA's band of the pre-step state of step t (x0 at t = 0, else the
// previous history entry), rotated into the split frame where split.
template <int TS>
__device__ __forceinline__ void pre_state(float (&xr)[TS][TS],
                                          float (&xi)[TS][TS], const Bwd& p,
                                          int e, int ib, int t,
                                          const int (&r)[TS],
                                          const int (&c)[TS],
                                          const bool (&ok)[TS][TS]) {
  const Dims& d = p.d;
  const int N = d.N, NN = N * N;
  const size_t h0 = (((size_t)e * d.nt + t) * d.B + ib) * NN;
  const size_t xp = t == 0 ? (size_t)ib * NN : h0 - (size_t)d.B * NN;
  const float* xpr = (t == 0 ? p.x0r : p.hr) + xp;
  const float* xpi = (t == 0 ? p.x0i : p.hi) + xp;
#pragma unroll
  for (int a = 0; a < TS; ++a)
#pragma unroll
    for (int b = 0; b < TS; ++b) {
      xr[a][b] = xi[a][b] = 0.f;
      if (!ok[a][b]) continue;
      const int o = r[a] * N + c[b];
      xr[a][b] = xpr[o];
      xi[a][b] = xpi[o];
      if (d.mode == MODE_SPLIT) cmul_rn(p.el, p.el + NN, o, xr[a][b], xi[a][b]);
    }
}

// The replay role of matrix blk: each step's stage iterates into ring slot
// s mod W, the forward's stage_chain on M^T it contracts itself, so the
// same bits as stored iterates. hdr: rank 0's header (its decision at step
// W in hdr[3]).
template <int TS>
__device__ __forceinline__ void replay_role(
    const Bwd& p, int blk, Exchange& ex, float* tb, int* hdr, int rank,
    int r0, int R, int Rmax, const int (&r)[TS], const int (&c)[TS],
    const bool (&ok)[TS][TS]) {
  cg::cluster_group cl = cg::this_cluster();
  const Dims& d = p.d;
  const int N = d.N, NN = N * N, ld = N | 1, W = p.W, G = p.G;
  const int e = blk / d.B, ib = blk - e * d.B;
  const bool split = d.mode == MODE_SPLIT;
  float* mts = p.scr + ((size_t)blk * BWD_SCRATCH + 12) * NN;
  int* full = p.flags + 1 + d.E * d.B + (size_t)blk * W;
  int* empty = full + (size_t)d.E * d.B * W;
  for (int s = 0; s < d.nt; ++s) {
    const int t = d.nt - 1 - s, sl = s % W;
    if (s == W && rank == 0 && threadIdx.x == 0)     // unclaimed: hand over
      hdr[3] = atomicCAS(p.flags + 1 + blk, 0, s + 1) == 0;
    float* Mt = mts + (size_t)(t & 1) * 2 * NN;
    contract_band(p.Sr, p.Si, p.C + ((size_t)e * d.nt + t) * d.K, d.K, N, r0,
                  R, nullptr, nullptr, Mt, Mt + NN);
    float xr[TS][TS], xi[TS][TS];
    pre_state<TS>(xr, xi, p, e, ib, t, r, c, ok);
    cluster_sync();     // M^T whole; the operand buffer is free
    if (s == W && cl.map_shared_rank(hdr, 0)[3]) break;
    if (s >= W) {       // the adjoint has emptied step s - W
      if (threadIdx.x == 0) wait_count(empty + sl, G * (s / W));
      __syncthreads();
    }
    const Gen g{Mt, Mt + NN, tb, p.L, split ? p.el + 2 * NN : nullptr,
                split ? p.el + 3 * NN : nullptr, r0, N, ld, Rmax, d.J, p.jb};
    ex.share<TS>(xr, xi, r, c, ok, ld);
    float kr[TS][TS], ki[TS][TS];
    const size_t ks0 = ((size_t)blk * W + sl) * d.iters * NN;
    stage_chain<TS>(kr, ki, d.iters - 1, ex, g, r, c, ok,
                    d.mode == MODE_JACOBI, d.a, p.el, d.iters, p.ksr + ks0,
                    p.ksi + ks0);
    __syncthreads();
    if (threadIdx.x == 0) signal_count(full + sl);
  }
}

// The adjoint role of matrix blk: the steps in reverse, each the transpose
// of its stage chain in iters + 1 (cotangent, input) pairs. Its iterates
// are stored (d.store), come from the replay role's ring for the steps
// before `first`, or are replayed in its own chain from `first` on.
template <int TS>
__device__ __forceinline__ void adjoint_role(
    const Bwd& p, int blk, int first, Exchange& ex, float* tb, float* U,
    float* red, float* slots, unsigned bars, int rank, int r0, int R,
    int Rmax, const int (&r)[TS], const int (&c)[TS],
    const bool (&ok)[TS][TS]) {
  const Dims& d = p.d;
  const int N = d.N, NN = N * N, ld = N | 1, plane = N * ld;
  const int iters = d.iters, K = d.K, W = p.W, G = p.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int e = blk / d.B, ib = blk - e * d.B;
  const bool jac = d.mode == MODE_JACOBI, split = d.mode == MODE_SPLIT;
  const bool replay = !d.store && iters > 0;
  const float *e0 = p.el, *e1 = p.el + NN, *e2 = p.el + 2 * NN,
              *e3 = p.el + 3 * NN;
  const float *SrT = p.St, *SiT = p.St + (size_t)K * NN;
  int* full = p.flags + 1 + d.E * d.B + (size_t)blk * W;
  int* empty = full + (size_t)d.E * d.B * W;
  const unsigned tx_c = tid == 0 ? 4u * (G - 1) * K : 0u;
  float* Ur = U;                          // u's row band (re, im)
  float* Uc = U + 2 * Rmax * ld;          // u's column band (re, im)
  int rl[TS];
#pragma unroll
  for (int a = 0; a < TS; ++a) rl[a] = r[a] - r0;
  const size_t gb = (size_t)blk * NN;

  float gr[TS][TS], gi[TS][TS];
#pragma unroll
  for (int a = 0; a < TS; ++a)
#pragma unroll
    for (int b = 0; b < TS; ++b) {
      const int o = r[a] * N + c[b];
      gr[a][b] = p.gTr[gb + o];
      gi[a][b] = p.gTi[gb + o];
    }

  for (int s = 0; s < d.nt; ++s) {
    const int t = d.nt - 1 - s, sl = s % W;
    const bool own = replay && s >= first;      // replays step t itself
    const bool ring = replay && !own;           // the replay role's iterates
    const size_t st = (size_t)e * d.nt + t;
    const size_t h0 = (st * d.B + ib) * NN;     // hist[e, t, ib]
    const size_t ks0 = d.store ? ((size_t)blk * d.nt + t) * iters * NN
                               : ((size_t)blk * W + sl) * iters * NN;
    float* S = p.scr + ((size_t)blk * BWD_SCRATCH + (t & 1) * 6) * NN;
    float *Mrow = S, *Mt = S + 2 * NN, *xs = S + 4 * NN;
    contract_band(p.Sr, p.Si, p.C + st * K, K, N, r0, R, Mrow, Mrow + NN,
                  own ? Mt : nullptr, own ? Mt + NN : nullptr);
    // the pre-step state's band in the split frame: into the scratch (the
    // last pair's input) and, for the own replay, into the operand below
    float xr[TS][TS], xi[TS][TS];
    pre_state<TS>(xr, xi, p, e, ib, t, r, c, ok);
#pragma unroll
    for (int a = 0; a < TS; ++a)
#pragma unroll
      for (int b = 0; b < TS; ++b)
        if (ok[a][b]) {
          const int o = r[a] * N + c[b];
          xs[o] = xr[a][b];
          xs[NN + o] = xi[a][b];
        }
    // history cotangent in, cotangent into the split frame, and parked
#pragma unroll
    for (int a = 0; a < TS; ++a)
#pragma unroll
      for (int b = 0; b < TS; ++b) {
        if (!ok[a][b]) continue;
        const int o = r[a] * N + c[b];
        gr[a][b] += p.jr[h0 + o];
        gi[a][b] += p.ji[h0 + o];
        if (split) cmul_conj_rn(e0, e1, o, gr[a][b], gi[a][b]);
        p.g0r[gb + o] = gr[a][b];
        p.g0i[gb + o] = gi[a][b];
      }
    if (ring && tid == 0) wait_count(full + sl, G * (s / W + 1));
    // the scratch whole for every CTA; the operand buffer is free
    cluster_sync();

    if (own) {          // the stage iterates into ks, band by band
      const Gen gt{Mt, Mt + NN, tb, p.L, split ? e2 : nullptr,
                   split ? e3 : nullptr, r0, N, ld, Rmax, d.J, p.jb};
      ex.share<TS>(xr, xi, r, c, ok, ld);
      float kr[TS][TS], ki[TS][TS];
      stage_chain<TS>(kr, ki, iters - 1, ex, gt, r, c, ok, jac, d.a, p.el,
                      iters, p.ksr + ks0, p.ksi + ks0);
      // every CTA's bands of ks are read whole below; the buffer is free
      cluster_sync();
    }

    // transpose of the stage chain, pairs i = 0..iters: for i < iters the
    // pair's cotangent is c = a * k-bar and its input u = k_{iters-1-i};
    // the last pair is (b-bar + k-bar, x_pre in the split frame)
    const Gen g{Mrow, Mrow + NN, tb, p.L, split ? e2 : nullptr,
                split ? e3 : nullptr, r0, N, ld, Rmax, d.J, p.jb};
    float bbr[TS][TS], bbi[TS][TS], kbr[TS][TS], kbi[TS][TS];
    float wr[TS][TS], wi[TS][TS], vr[TS][TS], vi[TS][TS];
#pragma unroll
    for (int a = 0; a < TS; ++a)
#pragma unroll
      for (int b = 0; b < TS; ++b) {
        bbr[a][b] = bbi[a][b] = wr[a][b] = wi[a][b] = 0.f;
        vr[a][b] = vi[a][b] = kbr[a][b] = kbi[a][b] = 0.f;
        if (!ok[a][b]) continue;
        // from the parked cotangent, so that g holds no registers meanwhile
        kbr[a][b] = d.dt * p.g0r[gb + r[a] * N + c[b]];
        kbi[a][b] = d.dt * p.g0i[gb + r[a] * N + c[b]];
      }
    for (int i = 0; i <= iters; ++i) {
      const bool last = i == iters;
      // every CTA has finished reading c, and this one its bands of u
      if (i > 0) cluster_sync();
      const size_t uo = ks0 + (size_t)(iters - 1 - i) * NN;
      copy_bands(Ur, Uc, last ? xs : p.ksr + uo, last ? xs + NN : p.ksi + uo,
                 N, r0, R, ld, Rmax);
#pragma unroll
      for (int a = 0; a < TS; ++a)
#pragma unroll
        for (int b = 0; b < TS; ++b) {
          if (!ok[a][b]) continue;
          const int o = r[a] * N + c[b], so = r[a] * ld + c[b];
          if (jac) cmul_conj_rn(e2, e3, o, kbr[a][b], kbi[a][b]);    // Wt
          if (last) {
            ex.put(so, bbr[a][b] + kbr[a][b], bbi[a][b] + kbi[a][b]);
          } else {
            bbr[a][b] += kbr[a][b];
            bbi[a][b] += kbi[a][b];
            ex.put(so, d.a * kbr[a][b], d.a * kbi[a][b]);
          }
        }
      ex.wait();
      const float* fr = ex.F;
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
      cp_async_wait();
      __syncthreads();          // the bands of u, whole in the CTA
      if (ring && i == iters - 1 && tid == 0) signal_count(empty + sl);
      // the H_eff cotangent's parts from shared memory: u c^dag on the
      // band's rows (the adjoint of c u^dag's band; its factor c^dag read
      // along a row of the operand, free of bank conflicts), and c^dag u
      // on the band's columns, entry (c[a], r[b]) in (wr, wi)[a][b]
      cmm<TS, false, true, LdS, LdS>(vr, vi, Ur, Ur + Rmax * ld, ld, 1, fr,
                                     fr + plane, 1, ld, rl, c, N);
      cmm<TS, true, false, LdS, LdS>(wr, wi, fr, fr + plane, 1, ld, Uc,
                                     Uc + N * Rmax, Rmax, 1, c, rl, N);
    }
#pragma unroll
    for (int a = 0; a < TS; ++a)
#pragma unroll
      for (int b = 0; b < TS; ++b) {
        gr[a][b] = gi[a][b] = 0.f;
        if (!ok[a][b]) continue;
        const int o = r[a] * N + c[b];
        gr[a][b] = p.g0r[gb + o] + kbr[a][b];
        gi[a][b] = p.g0i[gb + o] + kbi[a][b];
        if (split) cmul_conj_rn(e0, e1, o, gr[a][b], gi[a][b]);
      }

    // Cb[t, k] = <dA_r, Sr_k> + <dA_i, Si_k> with dA_i = Re W, dA_r = -Im W,
    // W = c u^dag + c^dag u, both parts against S_k^T: c^dag u at (c, r)
    // meets S_k(c, r) = S_k^T(r, c), and u c^dag (conjugate-transposed)
    // likewise; each warp's partial over its entries, the CTA's over its
    // warps in order, pushed into rank 0's slot of this rank; rank 0 sums
    // the slots in rank order
    for (int k = 0; k < K; ++k) {
      float v = 0.f;
#pragma unroll
      for (int a = 0; a < TS; ++a)
#pragma unroll
        for (int b = 0; b < TS; ++b) {
          if (!ok[a][b]) continue;
          const size_t o = (size_t)k * NN + r[a] * N + c[b];
          const float sr = __ldg(SrT + o), si = __ldg(SiT + o);
          v += wr[b][a] * si - wi[b][a] * sr;
          v += vr[a][b] * si + vi[a][b] * sr;
        }
      for (int q = 16; q > 0; q >>= 1) v += __shfl_xor_sync(0xffffffffu, v, q);
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
            "r"(__float_as_uint(v)), "r"(mapa(bars + 8, 0))
            : "memory");
      }
    }
    if (rank == 0) {
      bar_sync(bars + 8, tx_c, s & 1);
      if (tid < K) {
        float v = 0.f;
        for (int q = 0; q < G; ++q) v += slots[q * K + tid];
        p.Cb[((size_t)blk * d.nt + t) * K + tid] = v;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < TS; ++a)
#pragma unroll
    for (int b = 0; b < TS; ++b)
      if (ok[a][b]) {
        p.g0r[gb + r[a] * N + c[b]] = gr[a][b];
        p.g0i[gb + r[a] * N + c[b]] = gi[a][b];
      }
}

}  // namespace

// Backward: the steps in reverse on the same layout. Inputs as the forward's
// plus the transposed stacks St (2, K, N, N) = [Sr^T, Si^T], the history
// (E, nt, B, N, N), its cotangent j (same shape) and the final-state
// cotangent gT (E, B, N, N). ks holds the forward's stage iterates
// (E, B, nt, iters, N, N) with store, else it is the ring (E B, W, iters,
// N, N) the replay fills (W = 1 where each adjoint replays in its chain).
// scr: BWD_SCRATCH N^2 floats per matrix. split: 2 E B clusters, replay and
// adjoint roles by ticket (see above), else E B adjoint clusters. Writes g0
// (E, B, N, N), which also parks the running cotangent during a step, and
// Cb (E, B, nt, K). Shared memory: two mbarriers (the operand, C-bar) and
// the header of 4 ints (matrix, role, first own-replay step, hand-over) in
// 8 floats, the operand F (one buffer), jb jump bands, the pair input's
// row and column bands, the warps' C-bar partials and the cluster's (rank
// 0's).
template <int TS, int MAXT>
__global__ void __launch_bounds__(MAXT) rho_mid_bwd(const Bwd p) {
  extern __shared__ __align__(16) float smb[];
  cg::cluster_group cl = cg::this_cluster();
  const Dims& d = p.d;
  const int N = d.N, ld = N | 1, plane = N * ld, G = p.G;
  const int rank = (int)cl.block_rank();
  const int r0 = rank * N / G, R = (rank + 1) * N / G - r0;
  const int Rmax = (N + G - 1) / G;
  const unsigned bars = smem_u32(smb);    // 2 mbarriers of 8 bytes
  int* hdr = reinterpret_cast<int*>(smb + 4);
  float* F = smb + 8;           // the operand, one buffer of (re, im)
  float* tb = F + 2 * plane;    // jb jump bands of (re, im) Rmax x ld
  float* U = tb + (size_t)2 * p.jb * Rmax * ld;     // u's bands
  float* red = U + (size_t)2 * Rmax * (ld + N);     // (nwarps, K)
  float* slots = red + (blockDim.x >> 5) * d.K;     // (G, K), rank 0's
  int r[TS], c[TS];
  bool ok[TS][TS];
  band_ownership<TS>(N, r0, R, Rmax, r, c, ok);
  Exchange ex{F, plane, G, rank, bars,
              threadIdx.x == 0 ? 8u * N * (N - R) : 0u, 0};
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k) bar_init(bars + 8 * k, blockDim.x);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (rank == 0) {    // the cluster's matrix and role
      int blk = blockIdx.x / G, role = 1, first = 0;
      if (p.split) {
        const int ticket = atomicAdd(p.flags, 1);
        blk = ticket >> 1;
        role = ticket & 1;
        first = d.nt;
        if (role == 1) {
          const int was = atomicOr(p.flags + 1 + blk, CLAIMED);
          if (was != 0) first = was - 1;    // the replay handed over
        }
      }
      hdr[0] = blk;
      hdr[1] = role;
      hdr[2] = first;
    }
  }
  cl.sync();            // every CTA's mbarriers and rank 0's header exist
  const int* h = cl.map_shared_rank(hdr, 0);
  const int blk = h[0], role = h[1], first = h[2];
  if (role == 0)
    replay_role<TS>(p, blk, ex, tb, hdr, rank, r0, R, Rmax, r, c, ok);
  else
    adjoint_role<TS>(p, blk, first, ex, tb, U, red, slots, bars, rank, r0, R,
                     Rmax, r, c, ok);
  cl.sync();            // no CTA leaves while another may still push to it
}

// Plain C entry points, bound from Python with ctypes. The launch launches
// on the given stream and returns the launch's error (0 on success): E * B
// clusters of `cluster` CTAs (2 E B with split); the tile is 1, 2 (up to
// 512 threads) or 4 (up to 256), on the CTA's band. A backward of 2 x 2
// tiles on at most 256 threads takes the instance bounded at 256
// threads, which may hold 255 registers a thread: bounded at
// 512 (128 registers) its adjoint spilled and ran 16-21% slower on an H100
// at N = 125 and 128.
namespace {

// The jump bands a launch shape leaves room for, or -1 where the shape does
// not fit what the kernel carves: G in {1, 2, 4, 8, 16} and at most N, whole
// warps covering the band's tiles (and at least `least` threads) within the
// instance's bound, and shared memory for `fixed` floats and at least one
// jump band; jb is what the rest of smem_bytes holds, at most J.
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

template <int TS, int MAXT>
int launch_bwd(Bwd p, int threads, int smem_bytes, cudaStream_t stream) {
  const Dims& d = p.d;
  const int N = d.N, ld = N | 1, Rmax = (N + p.G - 1) / p.G;
  const long fixed = 8 + 2L * N * ld + 2L * Rmax * (ld + N) +
                     (long)(threads / 32) * d.K + (long)p.G * d.K;
  const long jb = jump_bands<TS>(d, p.G, threads, smem_bytes, fixed, d.K);
  const bool replay = !d.store && d.iters > 0;
  if (jb < 0 || threads > MAXT || p.W < 1 || (p.split && !replay) ||
      (replay && !p.split && p.W != 1))
    return (int)cudaErrorInvalidValue;
  p.jb = (int)jb;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      rho_mid_bwd<TS, MAXT>, attr, (p.split ? 2 : 1) * d.E * d.B, p.G,
      threads, smem_bytes, stream);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, rho_mid_bwd<TS, MAXT>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rho_mid_bwd_launch(
    const void* Sr, const void* Si, const void* St, const void* L,
    const void* C, const void* x0r, const void* x0i, const void* hr,
    const void* hi, const void* jr, const void* ji, const void* gTr,
    const void* gTi, const void* el, void* ksr, void* ksi, void* g0r,
    void* g0i, void* Cb, void* scr, void* flags, int E, int nt, int B, int N,
    int K, int J, int iters, int mode, int store, float dt, float a, int tile,
    int cluster, int threads, int smem_bytes, int split, int ring,
    void* stream) {
  const Bwd p{(const float*)Sr,  (const float*)Si,  (const float*)St,
              (const float*)L,   (const float*)C,   (const float*)x0r,
              (const float*)x0i, (const float*)hr,  (const float*)hi,
              (const float*)jr,  (const float*)ji,  (const float*)gTr,
              (const float*)gTi, (const float*)el,  (float*)ksr,
              (float*)ksi,       (float*)g0r,       (float*)g0i,
              (float*)Cb,        (float*)scr,       (int*)flags,
              Dims{E, nt, B, N, K, J, iters, mode, store, dt, a},
              cluster,           0,                 split,
              ring};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (tile) {
    case 1: return launch_bwd<1, 512>(p, threads, smem_bytes, st);
    case 2:
      return threads <= 256 ? launch_bwd<2, 256>(p, threads, smem_bytes, st)
                            : launch_bwd<2, 512>(p, threads, smem_bytes, st);
    case 4: return launch_bwd<4, 256>(p, threads, smem_bytes, st);
  }
  return (int)cudaErrorInvalidValue;
}

// How many clusters of G CTAs of the backward's instance `tile`, with
// `threads` threads and smem_bytes of shared memory each, the card can hold
// at once: clusters of 16 are beyond the portable size.
extern "C" int rho_mid_bwd_max_clusters(int tile, int cluster, int threads,
                                        int smem_bytes) {
  switch (tile) {
    case 1:
      return max_clusters(rho_mid_bwd<1, 512>, cluster, threads, smem_bytes);
    case 2:
      return threads <= 256 ? max_clusters(rho_mid_bwd<2, 256>, cluster,
                                           threads, smem_bytes)
                            : max_clusters(rho_mid_bwd<2, 512>, cluster,
                                           threads, smem_bytes);
    case 4:
      return max_clusters(rho_mid_bwd<4, 256>, cluster, threads, smem_bytes);
  }
  return 0;
}
