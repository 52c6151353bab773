// The forward of the mid-size density-matrix pair for Hopper (sm_90a), open
// systems of 64 < N <= 128 (the backward, with its replay of this chain, is
// csrc/rho_mid.cu; csrc/rho_mid.cuh what both share): the whole IMR time
// loop of d rho/dt = T(rho) in ONE launch,
//
//   T(v) = M v + v M^dag + sum_l (L_l v) L_l^dag - d v,  M = -i H_eff(t),
//
// with neumann, jacobi and split stage solves. Replaces the forward
// pallas_call of quandary_tpu/ops/pallas_rho.py::make_rho_propagate (:374)
// for 64 < N <= 128, the rest of the TPU kernel's one 128-lane tile.
//
// Layout: one thread-block cluster of G CTAs per (candidate, density
// matrix); CTA q owns rows [2 (q P / G), 2 ((q + 1) P / G)) of every (N, N)
// quantity the kernel produces (P = ceil(N / 2) pairs of rows, integer
// division, the last band ending at N), so that every band starts on an
// even row; a thread owns TR adjacent rows x 2 adjacent columns
// of that band, the warp's lanes running over the band's rows first, so a
// warp reads few rows of a band factor and 16 columns of a whole factor per
// j. Complex values are interleaved (re, im) pairs in shared memory, so one
// 16-byte load brings two entries.
//  * The operand v (the state, then each stage iterate) stays whole in each
//    CTA, one buffer F of row stride ldc (N rounded up to even: rows are
//    16-byte aligned). Each CTA writes its new band into its own F and into
//    vB, its band transposed, then thread q copies the band (contiguous
//    rows) into CTA q's F by a bulk copy, cp.async.bulk shared::cluster,
//    the destination's mbarrier counting the bytes. A cluster barrier
//    before each exchange tells every CTA that the others have finished
//    reading the previous operand (F is single: a second buffer does not
//    fit at N = 128).
//  * The band factors stay in shared memory, transposed (j, row): M's band
//    (MB: each CTA contracts its R rows of M(t) itself), the jump operators'
//    bands L_l (LB, loaded once: they are constant) where the budget holds
//    them, else read from device memory as conj(Lp), two rows a 16-byte
//    load (`lres` 0: clusters of 8 CTAs and fewer; the band's even first
//    row keeps the pairs aligned), and the jump first factors L_l v (tb,
//    jb of them at a time).
//  * The whole factors, M^T for v M^dag and L_l^dag for (L_l v) L_l^dag,
//    are read from device memory, 16 bytes a lane along j (the lanes of a
//    warp on 16 adjacent columns): each CTA writes its columns of M^T into
//    a per-cluster scratch (interleaved, row stride ldc, double-buffered by
//    step parity), read through L2 only; the packed jump planes Lp (J, N,
//    ldc) hold L^dag interleaved. (Staging them through shared memory, by
//    bulk copies of kt-row chunks into a ring or by each warp's cp.async
//    of its strip, cost ~0.6 us a chunk on an H100, more than the chunk's
//    products: PERF.md, section 6.)
//
// Arithmetic and order, those of the forward this file replaced, to the
// bit: every entry is one thread's fixed chain of fmaf, j = 0 .. N-1 in
// every product, the products in the order M v, v M^dag, then per jump
// operator in l's order its second factor (whatever jb), each entrywise
// product rounded as written. So xT, the history and the stored iterates
// keep their bits at every G, tile and jb, and the backward's replay
// (csrc/rho_mid.cu's stage_chain, in the same order) gives the stored
// iterates' bits.
//
// What bounds it on the H100: operations, (8 + 8 J) real N^3 products a T
// (109 MFLOP at N = 125, J = 6), iters + 1 dependent T a step over a
// matrix's G SMs. What holds it back (PERF.md, section 6): the products
// reading a whole factor from L2 wait on its latency (~60% of a T at N =
// 125, G = 16); the products from shared memory run at about twice their
// FMA floor (two 16-byte loads a j, whose wavefronts bound them); each T
// pays a cluster barrier and the exchange, ~5 us.

#include <algorithm>

#include "rho_mid.cuh"

namespace {

// the threads an instance runs at most, one CTA an SM: 256 (up to 255
// registers a thread), 512 at 4 rows a thread (128 registers; the band of
// 32 rows on twice the warps keeps twice the loads of whole factors in
// flight)
__host__ __device__ constexpr int fwd_max_threads(int TR) {
  return TR == 4 ? 512 : 256;
}

// Everything a forward CTA reads and writes (the kernel's arguments).
struct Fwd {
  const float *Sr, *Si, *L, *C, *x0r, *x0i, *el;
  const float2* Lp;
  float *xTr, *xTi, *hr, *hi, *ksr, *ksi;
  float2* scr;
  Dims d;
  int G, jb, lres;
};

// The launch's shape, derived alike on the host and in every CTA: the row
// stride of whole factors (ldc), the longest band (Rmax rows, whole pairs) in
// nrt tiles of TR rows (Rp rows with padding), nct tiles of 2 columns.
struct Shape {
  int ldc, Rmax, nrt, nct, Rp;
};

template <int TR>
__host__ __device__ inline Shape fwd_shape(int N, int G) {
  Shape s;
  s.ldc = N + (N & 1);
  s.Rmax = 2 * (((N + 1) / 2 + G - 1) / G);
  s.nrt = (s.Rmax + TR - 1) / TR;
  s.nct = (N + 1) / 2;
  s.Rp = s.nrt * TR;
  return s;
}

// Shared-memory bytes of a layout: the operand's mbarrier (in 16), F, then
// the transposed bands vB, MB, jb jump first factors and, where resident,
// the J jump bands.
__host__ __device__ inline long fwd_smem(const Shape& s, int N, int J, int jb,
                                         int lres) {
  return 16L + 8L * N * s.ldc + 8L * N * s.Rp * (2 + jb + (lres ? J : 0));
}

// this CTA's shared memory into another CTA's (dst and bar mapped into the
// cluster), completing on the destination's mbarrier
__device__ __forceinline__ void bulk_push(unsigned dst, unsigned src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [%0], [%1], %2, [%3];" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// generic-proxy writes before an asynchronous (bulk) copy reads them
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// loads of two adjacent entries (16 bytes) of a factor: in shared memory,
// in device memory written inside this launch (through L2 only), in
// read-only device memory
struct LdS {
  static __device__ __forceinline__ float4 ld(const float2* p) {
    return *reinterpret_cast<const float4*>(p);
  }
};
struct LdG {
  static __device__ __forceinline__ float4 ld(const float2* p) {
    return __ldcg(reinterpret_cast<const float4*>(p));
  }
};
struct LdR {
  static __device__ __forceinline__ float4 ld(const float2* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
};

// Z[a][b] += X(a, j) Y(j, b) for j in [0, n) on the thread's TR x 2 entries,
// each entry's chain of four fmaf per j as csrc/rho_mid.cu's cmm:
// X(a, j) at X + j xs + a (TR adjacent rows of a transposed band in shared
// memory), Y(j, b) at Y + j ys + b (two adjacent columns, one 16-byte load
// by LY). CY conjugates Y.
template <int TR, bool CY, class LY>
__device__ __forceinline__ void band_mma(float (&zr)[TR][2],
                                         float (&zi)[TR][2], const float2* X,
                                         int xs, const float2* Y, int ys,
                                         int n) {
#pragma unroll(TR <= 2 ? 8 : 4)
  for (int j = 0; j < n; ++j) {
    float xr[TR], xi[TR];
    if (TR == 1) {
      const float2 x = X[(size_t)j * xs];
      xr[0] = x.x;
      xi[0] = x.y;
    } else {
#pragma unroll
      for (int a = 0; a < TR; a += 2) {
        const float4 x =
            *reinterpret_cast<const float4*>(X + (size_t)j * xs + a);
        xr[a] = x.x;
        xi[a] = x.y;
        xr[a + 1] = x.z;
        xi[a + 1] = x.w;
      }
    }
    const float4 y = LY::ld(Y + (size_t)j * ys);
    const float yr[2] = {y.x, y.z};
    const float yi[2] = {CY ? -y.y : y.y, CY ? -y.w : y.w};
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        zr[a][b] = fmaf(xr[a], yr[b], zr[a][b]);
        zr[a][b] = fmaf(-xi[a], yi[b], zr[a][b]);
        zi[a][b] = fmaf(xr[a], yi[b], zi[a][b]);
        zi[a][b] = fmaf(xi[a], yr[b], zi[a][b]);
      }
  }
}

// The same with X read from device memory through L1 / L2 (the jump bands
// where they are not resident): X(a, j) = conj(Lp_l(j, row_a)), two rows a
// 16-byte load (xa[a], even: the column in Lp of rows a, a + 1, clamped
// into the row), one 8-byte load at TR = 1; Y in shared memory.
template <int TR>
__device__ __forceinline__ void band_mma_gx(float (&zr)[TR][2],
                                            float (&zi)[TR][2],
                                            const float2* Lpl,
                                            const int (&xa)[TR], int ldc,
                                            const float2* Y, int ys, int n) {
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    float xr[TR], xi[TR];
    if constexpr (TR == 1) {
      const float2 x = __ldg(Lpl + (size_t)j * ldc + xa[0]);
      xr[0] = x.x;
      xi[0] = -x.y;
    } else {
#pragma unroll
      for (int a = 0; a < TR; a += 2) {
        const float4 x = __ldg(
            reinterpret_cast<const float4*>(Lpl + (size_t)j * ldc + xa[a]));
        xr[a] = x.x;
        xi[a] = -x.y;
        xr[a + 1] = x.z;
        xi[a + 1] = -x.w;
      }
    }
    const float4 y = *reinterpret_cast<const float4*>(Y + (size_t)j * ys);
    const float yr[2] = {y.x, y.z}, yi[2] = {y.y, y.w};
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        zr[a][b] = fmaf(xr[a], yr[b], zr[a][b]);
        zr[a][b] = fmaf(-xi[a], yi[b], zr[a][b]);
        zi[a][b] = fmaf(xr[a], yi[b], zi[a][b]);
        zi[a][b] = fmaf(xi[a], yr[b], zi[a][b]);
      }
  }
}

// What one CTA holds of a launch: its band, its thread's entries and its
// shared-memory buffers.
template <int TR>
struct Cta {
  int N, ldc, Rp, r0, R, rank, G, J, jb, lres, rl0, c0;
  bool ok[TR][2];
  float2 *F, *vB, *MB, *tb, *LB;
  const float2* Lp;
  const float2* Mt;         // this step's M^T in the scratch
  const float *dr, *di;     // split: the generator diagonal (d_r, d_i)
  unsigned fbar;            // the operand's mbarrier
  unsigned tx;              // bytes the other CTAs push (thread 0), else 0
  int fx;                   // exchanges so far

  __device__ int row(int a) const { return r0 + rl0 + a; }

  // The thread's entries of v into its CTA's F and vB, then the exchange:
  // thread q copies the CTA's band rows of F into CTA q's F. Called after
  // a cluster barrier (no CTA still reads its F).
  __device__ void share(const float (&vr)[TR][2], const float (&vi)[TR][2]) {
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
        if (ok[a][b]) {
          const float2 v = make_float2(vr[a][b], vi[a][b]);
          F[(size_t)row(a) * ldc + c0 + b] = v;
          vB[(size_t)(c0 + b) * Rp + rl0 + a] = v;
        }
    fence_async_shared();
    __syncthreads();
    // thread q < G copies the band into CTA q: the copies go out at once
    const int q = threadIdx.x;
    if (q < G && q != rank) {
      const unsigned src = smem_u32(F + (size_t)r0 * ldc);
      bulk_push(mapa(src, q), src, 8u * R * ldc, mapa(fbar, q));
    }
    if (tx > 0)
      bar_arrive_tx(fbar, tx);
    else
      bar_arrive(fbar);
    bar_wait_bounded(fbar, fx & 1);
    ++fx;
  }

  // acc = T(v) on the thread's entries, v exchanged into F (its own entries
  // in vr, vi), the terms in the parent's order. Every thread of the block
  // calls it (it synchronizes when J > 0).
  __device__ void gen(float (&accr)[TR][2], float (&acci)[TR][2],
                      const float (&vr)[TR][2],
                      const float (&vi)[TR][2]) const {
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) accr[a][b] = acci[a][b] = 0.f;
    // M v: X = M's band (MB), Y = v (F)
    band_mma<TR, false, LdS>(accr, acci, MB + rl0, Rp, F + c0, ldc, N);
    // v M^dag: X = v's band (vB), Y = conj(M^T) from the scratch
    band_mma<TR, true, LdG>(accr, acci, vB + rl0, Rp, Mt + c0, ldc, N);
    // the rows' columns in Lp: even pairs within the row at TR > 1 (a row
    // past the band is padding, its entries not kept)
    int xa[TR];
#pragma unroll
    for (int a = 0; a < TR; ++a)
      xa[a] = TR == 1 ? min(row(a), N - 1) : min(row(a), ldc - 2);
    const size_t band = (size_t)N * Rp;
    for (int l0 = 0; l0 < J; l0 += jb) {
      const int l1 = min(J, l0 + jb);
      if (l0 > 0) __syncthreads();    // the previous group's reads are done
      for (int l = l0; l < l1; ++l) {
        // the first factor L_l v on the band's rows
        float zr[TR][2], zi[TR][2];
#pragma unroll
        for (int a = 0; a < TR; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b) zr[a][b] = zi[a][b] = 0.f;
        if (lres)
          band_mma<TR, false, LdS>(zr, zi, LB + l * band + rl0, Rp, F + c0,
                                   ldc, N);
        else
          band_mma_gx<TR>(zr, zi, Lp + (size_t)l * N * ldc, xa, ldc, F + c0,
                          ldc, N);
        float2* t = tb + (l - l0) * band;
#pragma unroll
        for (int a = 0; a < TR; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b)
            if (ok[a][b])
              t[(size_t)(c0 + b) * Rp + rl0 + a] =
                  make_float2(zr[a][b], zi[a][b]);
      }
      __syncthreads();
      for (int l = l0; l < l1; ++l)
        // the second factor: X = (L_l v)'s band, Y = L_l^dag
        band_mma<TR, false, LdR>(accr, acci, tb + (l - l0) * band + rl0, Rp,
                                 Lp + (size_t)l * N * ldc + c0, ldc, N);
    }
    if (dr != nullptr) {
#pragma unroll
      for (int a = 0; a < TR; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int o = min(row(a), N - 1) * N + min(c0 + b, N - 1);
          const float d_r = dr[o], d_i = di[o];
          const float v_r = vr[a][b], v_i = vi[a][b];
          accr[a][b] = __fsub_rn(
              accr[a][b], __fsub_rn(__fmul_rn(d_r, v_r), __fmul_rn(d_i, v_i)));
          acci[a][b] = __fsub_rn(
              acci[a][b], __fadd_rn(__fmul_rn(d_r, v_i), __fmul_rn(d_i, v_r)));
        }
    }
  }
};

}  // namespace

// Forward: a cluster of G CTAs per (candidate e, initial condition ib), each
// CTA on its band of rows (see the header). x0 (B, N, N) shared by all
// candidates; C (E, nt, K); el the entrywise solver planes, each (N, N):
// jacobi (d_r, d_i, minv_r, minv_i), split (e_r, e_i, d_r, d_i); L the
// (4, J, N, N) jump planes [L_r, L_i, L^dag_r, L^dag_i], Lp L^dag packed
// (J, N, ldc) interleaved. Writes xT (E, B, N, N), hist (E, nt, B, N, N)
// and, with store, the stage iterates k_0..k_{iters-1} (E, B, nt, iters, N,
// N). scr: 2 N ldc complex per cluster (M^T, two step parities).
template <int TR>
__global__ void __launch_bounds__(fwd_max_threads(TR), 1)
    rho_mid_fwd(const Fwd p) {
  extern __shared__ __align__(16) float smf[];
  cg::cluster_group cl = cg::this_cluster();
  const Dims& d = p.d;
  const int N = d.N, NN = N * N, J = d.J, G = p.G;
  const Shape sh = fwd_shape<TR>(N, G);
  const int ldc = sh.ldc, Rp = sh.Rp, tid = threadIdx.x;
  const int rank = (int)cl.block_rank();
  const int blk = blockIdx.x / G, e = blk / d.B, ib = blk - e * d.B;
  const bool jac = d.mode == MODE_JACOBI, split = d.mode == MODE_SPLIT;
  const float *e0 = d.mode == MODE_NEUMANN ? nullptr : p.el,
              *e1 = e0 == nullptr ? nullptr : p.el + NN;
  const float *e2 = e1 == nullptr ? nullptr : p.el + 2 * NN,
              *e3 = e1 == nullptr ? nullptr : p.el + 3 * NN;

  Cta<TR> w;
  w.N = N;
  w.ldc = ldc;
  w.Rp = Rp;
  const int P = (N + 1) / 2;
  w.r0 = 2 * (rank * P / G);
  w.R = min(N, 2 * ((rank + 1) * P / G)) - w.r0;
  w.rank = rank;
  w.G = G;
  w.J = J;
  w.jb = p.jb;
  w.lres = p.lres;
  // a thread whose entries do not exist reads the last existing one's
  const bool active = tid < sh.nrt * sh.nct;
  const int t0 = active ? tid : sh.nrt * sh.nct - 1;
  w.rl0 = (t0 % sh.nrt) * TR;
  w.c0 = 2 * (t0 / sh.nrt);
#pragma unroll
  for (int a = 0; a < TR; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      w.ok[a][b] = active && w.rl0 + a < w.R && w.c0 + b < N;
  // carve: the operand's mbarrier, F, vB, MB, tb, LB
  const unsigned bars = smem_u32(smf);
  w.F = reinterpret_cast<float2*>(smf + 4);
  w.vB = w.F + (size_t)N * ldc;
  w.MB = w.vB + (size_t)N * Rp;
  w.tb = w.MB + (size_t)N * Rp;
  w.LB = w.tb + (size_t)p.jb * N * Rp;
  w.Lp = p.Lp;
  w.dr = split ? e2 : nullptr;
  w.di = split ? e3 : nullptr;
  w.fbar = bars;
  w.tx = tid == 0 ? 8u * ldc * (N - w.R) : 0u;
  w.fx = 0;
  if (tid == 0) {
    bar_init(bars, blockDim.x);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the band buffers' padding rows are read (by threads whose entries do
  // not exist) and never written: zero them all, then the resident jump
  // bands L_l(r0 + rl, j) at LB[l][j][rl]
  const size_t nband = (size_t)N * Rp * (2 + p.jb + (p.lres ? J : 0));
  for (size_t i = tid; i < nband; i += blockDim.x)
    w.vB[i] = make_float2(0.f, 0.f);
  __syncthreads();
  if (p.lres)
    for (int i = tid; i < J * w.R * N; i += blockDim.x) {
      const int l = i / (w.R * N), rem = i - l * w.R * N;
      const int rl = rem / N, j = rem - rl * N;
      const size_t o = (size_t)l * NN + (size_t)(w.r0 + rl) * N + j;
      w.LB[((size_t)l * N + j) * Rp + rl] =
          make_float2(p.L[o], p.L[(size_t)J * NN + o]);
    }
  cl.sync();            // every CTA's mbarriers exist before any copy

  float xr[TR][2], xi[TR][2];
#pragma unroll
  for (int a = 0; a < TR; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      xr[a][b] = xi[a][b] = 0.f;
      if (!w.ok[a][b]) continue;
      const size_t o = (size_t)ib * NN + w.row(a) * N + w.c0 + b;
      xr[a][b] = p.x0r[o];
      xi[a][b] = p.x0i[o];
    }

  for (int t = 0; t < d.nt; ++t) {
    const size_t st = (size_t)e * d.nt + t;
    const size_t ks0 = ((size_t)blk * d.nt + t) * d.iters * NN;
    float2* Mt = p.scr + ((size_t)blk * 2 + (t & 1)) * N * ldc;
    w.Mt = Mt;
    // the CTA's R rows of M = -i sum_k c_k S_k (M_r = A_i, M_i = -A_r),
    // each entry's chain over k as the parent's, into M's band (MB) and
    // M^T's columns in the scratch (of this parity, last read two steps
    // ago, before the previous step's cluster barrier)
    const float* c = p.C + st * d.K;
    if (t > 0) __syncthreads();     // every thread's M v of the last T read MB
    for (int i = tid; i < w.R * N; i += blockDim.x) {
      const int e_ = w.r0 * N + i;
      float ar = 0.f, ai = 0.f;
      for (int k = 0; k < d.K; ++k) {
        const float ck = __ldg(c + k);
        ar = fmaf(ck, __ldg(p.Sr + (size_t)k * NN + e_), ar);
        ai = fmaf(ck, __ldg(p.Si + (size_t)k * NN + e_), ai);
      }
      const int pl = i / N, q = i - pl * N;
      const float2 m = make_float2(ai, -ar);
      Mt[(size_t)q * ldc + w.r0 + pl] = m;
      w.MB[(size_t)q * Rp + pl] = m;
    }
    if (split) {
#pragma unroll
      for (int a = 0; a < TR; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
          if (w.ok[a][b])
            cmul_rn(e0, e1, w.row(a) * N + w.c0 + b, xr[a][b], xi[a][b]);
    }
    // M^T whole in the scratch, MB whole in the CTA; the operand is free
    cluster_sync();
    w.share(xr, xi);
    // the stage chain: b = T(x); k_0 = b (jacobi: Minv b); then for
    // j = 1..iters: k exchanged, m = T(k), k <- the stage update
    float br[TR][2], bi[TR][2], kr[TR][2], ki[TR][2];
    w.gen(br, bi, xr, xi);
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        kr[a][b] = br[a][b];
        ki[a][b] = bi[a][b];
        if (!w.ok[a][b]) continue;
        const int o = w.row(a) * N + w.c0 + b;
        if (jac) cmul_rn(e2, e3, o, kr[a][b], ki[a][b]);
        if (d.store && d.iters > 0) {
          p.ksr[ks0 + o] = kr[a][b];
          p.ksi[ks0 + o] = ki[a][b];
        }
      }
    for (int j = 1; j <= d.iters; ++j) {
      cluster_sync();   // every CTA has finished reading the operand
      w.share(kr, ki);
      float mr[TR][2], mi[TR][2];
      w.gen(mr, mi, kr, ki);
#pragma unroll
      for (int a = 0; a < TR; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          if (!w.ok[a][b]) continue;
          const int o = w.row(a) * N + w.c0 + b;
          stage_update_rn(jac, d.a, br[a][b], bi[a][b], mr[a][b], mi[a][b],
                          e0, e1, e2, e3, o, kr[a][b], ki[a][b]);
          if (d.store && j < d.iters) {
            p.ksr[ks0 + (size_t)j * NN + o] = kr[a][b];
            p.ksi[ks0 + (size_t)j * NN + o] = ki[a][b];
          }
        }
    }
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        if (!w.ok[a][b]) continue;
        const int o = w.row(a) * N + w.c0 + b;
        xr[a][b] = fmaf(d.dt, kr[a][b], xr[a][b]);
        xi[a][b] = fmaf(d.dt, ki[a][b], xi[a][b]);
        if (split) cmul_rn(e0, e1, o, xr[a][b], xi[a][b]);
        const size_t h = (st * d.B + ib) * NN + o;
        p.hr[h] = xr[a][b];
        p.hi[h] = xi[a][b];
      }
  }
#pragma unroll
  for (int a = 0; a < TR; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      if (w.ok[a][b]) {
        const size_t o = (size_t)blk * NN + w.row(a) * N + w.c0 + b;
        p.xTr[o] = xr[a][b];
        p.xTi[o] = xi[a][b];
      }
  cl.sync();            // no CTA leaves while another may still copy to it
}

// Plain C entry points, bound from Python with ctypes. The launch launches
// E * B clusters of `cluster` CTAs of instance `tile` (TR = 1, 2 or 4 rows
// a thread, up to fwd_max_threads(TR) threads), with
// the layout ops/rho_mid.py::fwd_layout plans (jb, lres) in
// smem_bytes; it returns the launch's error (0 on success), and
// cudaErrorInvalidValue where the shape does not hold what the kernel
// carves.
namespace {

template <int TR>
int launch_fwd(const Fwd& p, int threads, int smem_bytes,
               cudaStream_t stream) {
  const Dims& d = p.d;
  const int G = p.G;
  const Shape s = fwd_shape<TR>(d.N, G);
  if ((G != 1 && G != 2 && G != 4 && G != 8 && G != 16) || G > d.N ||
      threads % 32 != 0 || threads < s.nrt * s.nct ||
      threads > fwd_max_threads(TR) ||
      (d.J > 0 && (p.jb < 1 || p.jb > d.J || p.Lp == nullptr)) ||
      (d.J == 0 && (p.jb != 0 || p.lres)) || smem_bytes > 227 * 1024 ||
      fwd_smem(s, d.N, d.J, p.jb, p.lres) > smem_bytes)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      rho_mid_fwd<TR>, attr, d.E * d.B, G, threads, smem_bytes, stream);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, rho_mid_fwd<TR>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rho_mid_fwd_launch(
    const void* Sr, const void* Si, const void* L, const void* Lp,
    const void* C, const void* x0r, const void* x0i, const void* el,
    void* xTr, void* xTi, void* hr, void* hi, void* ksr, void* ksi, void* scr,
    int E, int nt, int B, int N, int K, int J, int iters, int mode, int store,
    float dt, float a, int tile, int cluster, int threads, int smem_bytes,
    int jb, int lres, void* stream) {
  const Fwd p{(const float*)Sr,  (const float*)Si, (const float*)L,
              (const float*)C,   (const float*)x0r, (const float*)x0i,
              (const float*)el,  (const float2*)Lp, (float*)xTr,
              (float*)xTi,       (float*)hr,        (float*)hi,
              (float*)ksr,       (float*)ksi,       (float2*)scr,
              Dims{E, nt, B, N, K, J, iters, mode, store, dt, a},
              cluster,           jb,                lres};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (tile) {
    case 1: return launch_fwd<1>(p, threads, smem_bytes, st);
    case 2: return launch_fwd<2>(p, threads, smem_bytes, st);
    case 4: return launch_fwd<4>(p, threads, smem_bytes, st);
  }
  return (int)cudaErrorInvalidValue;
}

// How many clusters of G CTAs of instance `tile`, with `threads` threads and
// smem_bytes of shared memory each, the card can hold at once.
extern "C" int rho_mid_fwd_max_clusters(int tile, int cluster, int threads,
                                        int smem_bytes) {
  switch (tile) {
    case 1: return max_clusters(rho_mid_fwd<1>, cluster, threads, smem_bytes);
    case 2: return max_clusters(rho_mid_fwd<2>, cluster, threads, smem_bytes);
    case 4: return max_clusters(rho_mid_fwd<4>, cluster, threads, smem_bytes);
  }
  return 0;
}
