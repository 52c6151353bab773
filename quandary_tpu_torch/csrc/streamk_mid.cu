// streamK propagation past one thread block, for Hopper (sm_90a): the whole
// IMR time loop of dv/dt = -i H(t) v, H(t) = sum_k c_k(t) S_k contracted
// in-kernel from the operator stacks, in ONE launch per direction, for
// candidates one block of streamk.cu cannot hold (mid size: N = 53 to 1024
// at the flagship's Ke, or more basis states than 1024 threads): closed
// systems, and open ones on the superop route (the vectorized Lindblad
// equation at dimension N^2 with the non-Hermitian stack H' = i L).
//
// Replaces the rest of the range of quandary_tpu/ops/pallas_stream.py::
// make_streamk_propagate (the TPU kernel pair: forward pallas_call at :907,
// backward at :967, with the step core _stage_fwd :217 / _stage_bwd :331 it
// inlines) and of make_streamk_packed_propagate :1059 (pallas_calls :1324 /
// :1415) with per_block_stacks: every candidate then reads its own stack
// and solver rows at the strides strideS, strideR (one system realization
// per candidate, the packed robust objective). Same contract and algebra
// as streamk.cu: neumann, jacobi and split (whose off-diagonal remainder is
// the extra stack slot -diag(h) with coefficient 1, appended by the
// wrapper); the backward is the exact real transpose of the step and
// reduces the step's H cotangent Hb = sum_pairs c u^T against every stack
// slot into
// Cb[t, k] = <Hb_r, Sr_k> + <Hb_i, Si_k>. H is never assumed Hermitian.
//
// Layout: a thread-block cluster of G CTAs (1, 2, 4, 8 or 16) per (control
// candidate, chunk of BC basis states); the basis states of a closed system
// are independent, so clusters never wait on each other (no grid-wide
// sync) and a grid of more clusters than the card holds runs in waves. CTA
// q of a cluster owns the entries [q R, q R + R) of every state vector
// (R = ceil(N / G), the last band ragged). Every stage product needs the
// whole operand vector: each CTA computes its band of the result and
// writes it into every CTA's copy of the operand through distributed shared
// memory, and one cluster barrier per exchange makes the copies whole
// (operand buffers alternate, so the barrier also guards their reuse).
//   forward: the CTA contracts its ROW band of H(t) (R x N) at the start of
//     step t and computes its band of T(v) = -i H v for each stage;
//   backward: it contracts its COLUMN band of H(t), stored transposed
//     (R x (N + 1)), and computes its band of the real transpose Tt(c); a
//     backward that replays the stage iterates (store 0) holds the row band
//     too. The step's (cotangent, input) pairs stay in shared memory: the
//     cotangents whole (they were exchanged), the inputs by band. One pass
//     over the column band's entries per step then forms each entry of Hb
//     in registers, adds it into the CTA's C-bar partials of every slot and,
//     reading the same stack entries, contracts the next step's column band.
//   C-bar: each CTA writes its partial row Cbp[cta, t, :] (a shuffle tree
//     per warp, the warps summed in order); the wrapper sums the rows in a
//     fixed order. No float atomics: two launches give the same bits.
//   That is each direction's 'chain' schedule. Where the launch leaves SMs
//     idle its 'helpers' schedule (streamk_mid_fwd_helpers,
//     streamk_mid_bwd_helpers, below) runs the same chain and moves the
//     contraction of H (the backward's whole pass) onto helper clusters
//     ahead of it.
// Where the bands of H fit shared memory beside the operand buffers
// ("smem" layout) they live there; otherwise ("global" layout) in a
// per-CTA scratch in device memory, which the L2 serves (at N = 1024 a
// 64-row band is 512 KB). The wrapper picks the layout, the cluster size
// and BC (ops/streamk.py::_mid_shape) and logs them.
// Mapping (mid_cluster.cuh's rows_dot and push, shared with stream_mid.cu):
// the warps of a CTA take the band's rows in turn; the lanes of a
// warp stride the contraction index j, each lane holds the partial sums of
// all BC states, and a butterfly of shuffles gives every lane the row's
// sums; lane b then owns entry (b, row): it keeps that entry's stage
// values (x, b, k or g, kb, bb) in the band arrays in shared memory, runs
// the elementwise stage update, writes history and stored iterates, and
// pushes the entry to the cluster. Arithmetic is exact f32 FMA on the CUDA
// cores; no tensor cores.
//
// What bounds it on the H100: a step is iters + 1 (backward up to
// 2 iters + 1) dependent stage products, each (B, N) x (N, N), spread over
// the G SMs of a cluster and ended by a cluster barrier. The products are
// small at B = 1 (4 N^2 FMA, 4 M at N = 1024), so a stage costs the
// reading of the CTA's H band (from shared memory, or 512 KB from L2 in the
// global layout), the warps' shuffle trees, the pushes and the barrier;
// the per-step contraction reads Ke bands of the stacks from L2 (past N =
// 512 from device memory: on the chain the backward's pass cost 521 of a
// 591 us step at N = 1024, the forward's row contraction 275 of 432; on
// helper clusters each direction's chain alone bounds it).
// At B = 256 the products dominate (67 MFLOP a stage at N = 256).

#include "mid_cluster.cuh"

namespace {

constexpr int MID_MAX_THREADS = 512;
constexpr int MID_KG = 8;    // stack slots a thread reduces C-bar for at once

// global: the bands of H in device-memory scratch (else shared memory).
// strideS, strideR: floats between two candidates' stacks and solver rows
// (per-sample stacks, the packed plan of make_streamk_packed_propagate);
// 0 where the candidates share one stack.
struct MidDims {
  int E, nt, B, N, Ke, iters, mode, store;
  float dt, a;
  int G, R, nchunks, global;
  long long strideS, strideR;
};

// Floats of a CTA's bands of H: the forward's row band (R x N, re and im);
// the backward's column band transposed (R x (N + 1)) and, with replay, its
// row band. Shared memory in the smem layout, else device-memory scratch.
__host__ __device__ inline size_t mid_band_floats(int N, int R, bool backward,
                                                  bool replay) {
  const size_t row = 2 * (size_t)R * N, col = 2 * (size_t)R * (N + 1);
  return backward ? col + (replay ? row : 0) : row;
}

// Floats of the forward's shared memory: two operand buffers (re, im) x BC
// x N, the bands of x, b and k (re, im) x BC x R, the solver rows 4 x R and,
// in the smem layout, the row band of H.
__host__ __device__ inline size_t mid_fwd_floats(int BC, int N, int R,
                                                 bool hsmem) {
  return 4 * (size_t)BC * N + 6 * (size_t)BC * R + 4 * (size_t)R +
         (hsmem ? mid_band_floats(N, R, false, false) : 0);
}

// Floats of the backward's shared memory: the it + 1 whole cotangents of the
// step's pairs, with replay two operand buffers, the it + 1 band inputs, the
// bands of g, kb, bb (with replay also b, k), the solver rows, the warps'
// C-bar partials (16 x MID_KG) and, in the smem layout, the bands of H.
__host__ __device__ inline size_t mid_bwd_floats(int BC, int N, int R, int it,
                                                 bool replay, bool hsmem) {
  const size_t BNv = (size_t)BC * N, BR = (size_t)BC * R;
  return 2 * (size_t)(it + 1) * BNv + (replay ? 4 * BNv : 0) +
         2 * (size_t)(it + 1) * BR + (replay ? 10 : 6) * BR + 4 * (size_t)R +
         16 * MID_KG + (hsmem ? mid_band_floats(N, R, true, replay) : 0);
}

// This CTA's part of the grid: candidate e, chunk of basis states
// [b0, b0 + nb), band of entries [r0, r0 + nr).
struct MidBand {
  int e, r0, nr, b0, nb;
};

__device__ __forceinline__ MidBand mid_band(const MidDims& d, int BC,
                                            int rank) {
  MidBand g;
  const int cid = blockIdx.x / d.G;
  g.e = cid / d.nchunks;
  g.r0 = rank * d.R;
  g.nr = min(d.R, d.N - g.r0);
  g.b0 = (cid - g.e * d.nchunks) * BC;
  g.nb = min(BC, d.B - g.b0);
  return g;
}

// The row band of H = sum_k c_k S_k: rows [r0, r0 + nr), row stride N (the
// band is contiguous in the stacks), one fmaf chain per entry in k order.
__device__ __forceinline__ void row_contract(const float* __restrict__ Sr,
                                             const float* __restrict__ Si,
                                             const float* __restrict__ c,
                                             int Ke, int N, int r0, int nr,
                                             float* Hr, float* Hi, int t0,
                                             int nth) {
  const size_t NN = (size_t)N * N, base = (size_t)r0 * N;
  const int n = nr * N;
  for (int idx = t0; idx < n; idx += nth) {
    float hr = 0.f, hi = 0.f;
    for (int k = 0; k < Ke; ++k) {
      const float ck = c[k];
      hr = fmaf(ck, Sr[k * NN + base + idx], hr);
      hi = fmaf(ck, Si[k * NN + base + idx], hi);
    }
    Hr[idx] = hr;
    Hi[idx] = hi;
  }
}

// One pass over the column band's entries (pp, ql), pp < N, ql < nr, in
// pp-major order over the threads (the stack reads are runs of nr floats).
// With npairs > 0: Hb(pp, r0 + ql) from the step's pairs (whole cotangents
// Cs, band inputs U; pair p's cotangent at Cs + 2 p BC N, its input at
// U + 2 p BC R), added against every slot into the CTA's C-bar row cbout
// (the threads' partials, MID_KG slots at a time, summed by a shuffle tree
// per warp and the warps in order). With cn: the column band of
// H = sum_k cn_k S_k, transposed, into HT (row stride N + 1), on the stack
// entries the C-bar partials read. Ke > MID_KG passes again per group of
// slots (Hb recomputed, H carried through HT).
template <int BC>
__device__ void col_pass(const float* __restrict__ Sr,
                         const float* __restrict__ Si, int Ke, int N, int r0,
                         int nr, int R, const float* Cs, const float* U,
                         int npairs, const float* __restrict__ cn, float* HTr,
                         float* HTi, float* red, float* __restrict__ cbout) {
  const size_t NN = (size_t)N * N, BNv = (size_t)BC * N;
  const int BI = BC * R, ld = N + 1, n = N * nr;
  const int tid = threadIdx.x, nth = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5, nwarps = nth >> 5;
  for (int k0 = 0; k0 < Ke; k0 += MID_KG) {
    float cb[MID_KG];
#pragma unroll
    for (int kk = 0; kk < MID_KG; ++kk) cb[kk] = 0.f;
    for (int idx = tid; idx < n; idx += nth) {
      const int pp = idx / nr, ql = idx - pp * nr;
      const size_t off = (size_t)pp * N + r0 + ql;
      float hbr = 0.f, hbi = 0.f;
      for (int pr = 0; pr < npairs; ++pr) {
        const float* c = Cs + 2 * pr * BNv;
        const float* u = U + 2 * pr * BI;
#pragma unroll
        for (int b = 0; b < BC; ++b) {
          const float cr = c[b * N + pp], ci = c[BNv + b * N + pp];
          const float ur = u[b * R + ql], ui = u[BI + b * R + ql];
          hbr = fmaf(cr, ui, hbr);
          hbr = fmaf(-ci, ur, hbr);
          hbi = fmaf(cr, ur, hbi);
          hbi = fmaf(ci, ui, hbi);
        }
      }
      float hnr = 0.f, hni = 0.f;
      if (cn != nullptr && k0 > 0) {
        hnr = HTr[ql * ld + pp];
        hni = HTi[ql * ld + pp];
      }
#pragma unroll
      for (int kk = 0; kk < MID_KG; ++kk) {
        const int k = k0 + kk;
        if (k < Ke) {
          const float sr = Sr[k * NN + off], si = Si[k * NN + off];
          cb[kk] = fmaf(hbr, sr, cb[kk]);
          cb[kk] = fmaf(hbi, si, cb[kk]);
          if (cn != nullptr) {
            hnr = fmaf(cn[k], sr, hnr);
            hni = fmaf(cn[k], si, hni);
          }
        }
      }
      if (cn != nullptr) {
        HTr[ql * ld + pp] = hnr;
        HTi[ql * ld + pp] = hni;
      }
    }
    if (cbout != nullptr) {
#pragma unroll
      for (int kk = 0; kk < MID_KG; ++kk) {
        float v = cb[kk];
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) red[warp * MID_KG + kk] = v;
      }
      __syncthreads();
      if (tid < MID_KG && k0 + tid < Ke) {
        float v = 0.f;
        for (int w = 0; w < nwarps; ++w) v += red[w * MID_KG + tid];
        cbout[k0 + tid] = v;
      }
      __syncthreads();
    }
  }
}

}  // namespace

namespace {

// One CTA's part of the forward's chain, shared by both forward schedules:
// its band of the states of one (candidate, chunk of BC states) in shared
// memory beside the two operand buffers every CTA of the cluster pushes
// into. A step is put_x, a cluster barrier, then stages on the CTA's row
// band of H(t); both schedules run these same products in the same order.
template <int BC>
struct FwdChain {
  MidDims d;
  MidBand g;
  float *V, *X, *Bb, *Kb, *rw;
  size_t BNv;
  int BI, tid, lane, warp, nwarps;
  int p = 0;                      // the operand buffer the next stage reads

  // sm: two buffers x (re, im) x BC x N, the bands of x, b, k (re, then im
  // at + BI) and the solver rows 4 x R (mid_fwd_floats without the band)
  __device__ FwdChain(const MidDims& dims, const MidBand& band, float* sm)
      : d(dims), g(band) {
    BNv = (size_t)BC * d.N;
    BI = BC * d.R;
    V = sm;
    X = V + 4 * BNv;
    Bb = X + 2 * BI;
    Kb = Bb + 2 * BI;
    rw = Kb + 2 * BI;
    tid = threadIdx.x;
    lane = tid & 31;
    warp = tid >> 5;
    nwarps = blockDim.x >> 5;
  }

  // the band of x0 and the solver rows (the buffers zeroed before)
  __device__ void load(const float* __restrict__ x0r,
                       const float* __restrict__ x0i,
                       const float* __restrict__ rows) {
    const int N = d.N, R = d.R;
    for (int i = tid; i < BI; i += blockDim.x) {
      const int b = i / R, il = i - b * R;
      if (b < g.nb && il < g.nr) {
        const size_t o = (size_t)(g.b0 + b) * N + g.r0 + il;
        X[i] = x0r[o];
        X[BI + i] = x0i[o];
      }
    }
    const int nrows = d.mode == MODE_JACOBI ? 4 : d.mode == MODE_SPLIT ? 2 : 0;
    for (int i = tid; i < nrows * R; i += blockDim.x) {
      const int m = i / R, il = i - m * R;
      if (il < g.nr) rw[i] = rows[m * N + g.r0 + il];
    }
  }

  // the entries this thread owns: lane b of the warp that takes row il
  template <typename F>
  __device__ __forceinline__ void owned(F fn) const {
    for (int il = warp; il < g.nr; il += nwarps)
      if (lane < BC) fn(il, lane, lane * d.R + il);
  }

  __device__ __forceinline__ void put(const cg::cluster_group& cl, float* buf,
                                      int b, int il, float vr,
                                      float vi) const {
    push(cl, buf + b * d.N + g.r0 + il, vr, d.G);
    push(cl, buf + BNv + b * d.N + g.r0 + il, vi, d.G);
  }

  // step t's first operand: x (rotated where split) into every CTA
  __device__ void put_x(const cg::cluster_group& cl) {
    const bool split = d.mode == MODE_SPLIT;
    owned([&](int il, int b, int ib) {
      float xr = X[ib], xi = X[BI + ib];
      if (split) cmul(rw[il], rw[d.R + il], xr, xi);
      X[ib] = xr;
      X[BI + ib] = xi;
      put(cl, V + 2 * p * BNv, b, il, xr, xi);
    });
  }

  // After the barrier that made x whole: stage j = 0..iters, each the band
  // of T of the operand from the row band of H(t) (Hr, Hi, row stride ld;
  // L2: a band other SMs wrote during the launch, read from L2), the stage
  // update and k_j exchanged for stage j + 1 (iters cluster barriers); then
  // x's update, the history and (store) the stage iterates of step t.
  template <bool L2>
  __device__ void stages(const cg::cluster_group& cl, const float* Hr,
                         const float* Hi, int ld, int t, float* hr,
                         float* hi, float* ksr, float* ksi) {
    const int N = d.N, R = d.R, it = d.iters;
    const bool jac = d.mode == MODE_JACOBI, split = d.mode == MODE_SPLIT;
    const size_t BN = (size_t)d.B * N;
    const size_t st = (size_t)g.e * d.nt + t;
    for (int j = 0; j <= it; ++j) {
      const float* Vr = V + 2 * p * BNv;
      float* Vn = V + 2 * (p ^ 1) * BNv;
      auto stage = [&](int il, int b, float sr, float si) {
        const int ib = b * R + il;
        const float tr = si, ti = -sr;     // T(v) = -i H v
        float kr = Kb[ib], ki = Kb[BI + ib];
        if (j == 0) {
          Bb[ib] = tr;
          Bb[BI + ib] = ti;
          mid_first(jac, rw, R, il, tr, ti, kr, ki);
        } else {
          mid_next(jac, d.a, rw, R, il, Bb[ib], Bb[BI + ib], tr, ti, kr, ki);
        }
        Kb[ib] = kr;
        Kb[BI + ib] = ki;
        if (j < it) {
          if (d.store && b < g.nb) {
            const size_t o =
                (st * it + j) * BN + (size_t)(g.b0 + b) * N + g.r0 + il;
            ksr[o] = kr;
            ksi[o] = ki;
          }
          put(cl, Vn, b, il, kr, ki);
        }
      };
      if constexpr (L2)
        rows_dot_l2<BC, false>(Hr, Hi, ld, g.nr, Vr, Vr + BNv, N, warp,
                               nwarps, lane, stage);
      else
        rows_dot<BC, false>(Hr, Hi, ld, g.nr, Vr, Vr + BNv, N, warp, nwarps,
                            lane, stage);
      if (j < it) {
        p ^= 1;
        cl.sync();
      }
    }
    p ^= 1;
    owned([&](int il, int b, int ib) {
      float xr = X[ib] + d.dt * Kb[ib], xi = X[BI + ib] + d.dt * Kb[BI + ib];
      if (split) cmul(rw[il], rw[R + il], xr, xi);
      X[ib] = xr;
      X[BI + ib] = xi;
      if (b < g.nb) {
        const size_t o = st * BN + (size_t)(g.b0 + b) * N + g.r0 + il;
        hr[o] = xr;
        hi[o] = xi;
      }
    });
  }

  __device__ void write_xT(float* xTr, float* xTi) const {
    owned([&](int il, int b, int ib) {
      if (b < g.nb) {
        const size_t o = ((size_t)g.e * d.B + g.b0 + b) * d.N + g.r0 + il;
        xTr[o] = X[ib];
        xTi[o] = X[BI + ib];
      }
    });
  }
};

}  // namespace

// Forward: x0 (B, N) shared by all candidates; C (E, nt, Ke); rows: jacobi
// (d_r, d_i, minv_r, minv_i) or split (e_r, e_i), each (N,). Writes xT
// (E, B, N), hist (E, nt, B, N) and, with store, the stage iterates
// k_0..k_{iters-1} (E, nt, iters, B, N), each CTA its band of its chunk's
// states. scratch: the global layout's row bands, mid_band_floats per CTA.
// Per step: the row band of H(t), x (rotated where split) exchanged, then
// stage j = 0..iters: the band of T of the operand, the stage update, and
// k_j exchanged for stage j + 1: iters + 1 cluster barriers. This is the
// forward's 'chain' schedule (the row contraction in each step's chain);
// its 'helpers' schedule (streamk_mid_fwd_helpers, below) moves the
// contraction onto helper clusters a step ahead.
template <int BC>
__global__ void __launch_bounds__(MID_MAX_THREADS)
streamk_mid_fwd(const float* __restrict__ Sr, const float* __restrict__ Si,
                const float* __restrict__ C, const float* __restrict__ x0r,
                const float* __restrict__ x0i, const float* __restrict__ rows,
                float* __restrict__ xTr, float* __restrict__ xTi,
                float* __restrict__ hr, float* __restrict__ hi,
                float* __restrict__ ksr, float* __restrict__ ksi,
                float* __restrict__ scratch, MidDims d) {
  extern __shared__ float sm[];
  const cg::cluster_group cl = cg::this_cluster();
  const int N = d.N, R = d.R, Ke = d.Ke, nt = d.nt;
  const int tid = threadIdx.x;
  const MidBand g = mid_band(d, BC, (int)cl.block_rank());
  Sr += g.e * d.strideS;          // this candidate's stack and solver rows
  Si += g.e * d.strideS;
  rows += g.e * d.strideR;
  FwdChain<BC> c(d, g, sm);
  float* Hr = d.global ? scratch + (size_t)blockIdx.x *
                                       mid_band_floats(N, R, false, false)
                       : c.rw + 4 * R;
  float* Hi = Hr + (size_t)R * N;

  const size_t nsm = mid_fwd_floats(BC, N, R, !d.global);
  for (size_t i = tid; i < nsm; i += blockDim.x) sm[i] = 0.f;
  __syncthreads();
  c.load(x0r, x0i, rows);
  cl.sync();    // every CTA's buffers are zeroed before the first push

  const float* Ce = C + (size_t)g.e * nt * Ke;
  for (int t = 0; t < nt; ++t) {
    __syncthreads();              // step t - 1's stages are done with H
    row_contract(Sr, Si, Ce + (size_t)t * Ke, Ke, N, g.r0, g.nr, Hr, Hi, tid,
                 blockDim.x);
    c.put_x(cl);
    cl.sync();
    c.template stages<false>(cl, Hr, Hi, N, t, hr, hi, ksr, ksi);
  }
  c.write_xT(xTr, xTi);
  cl.sync();    // no CTA leaves while another may still address it
}

// Backward: the steps in reverse. Inputs as the forward's plus the history
// (E, nt, B, N), its cotangent j (E, nt, B, N), the final-state cotangent
// gT (E, B, N) and, with store, the forward's stage iterates. Writes the x0
// cotangent per candidate g0 (E, B, N), each CTA its band, and per CTA a
// row of C-bar partials Cbp (CTAs, nt, Ke), which the wrapper sums over the
// chunks and bands in order. Per step: the operands (g += j, the pre-state
// xp; split: both rotated), with replay the stage iterates again from the
// exchanged xp on the row band (iters barriers), then the transposed chain
// on the column band, each of its iters + 1 cotangents exchanged whole
// (iters + 1 barriers), then the pass that reduces C-bar and contracts the
// next column (and row) band, and one barrier before the next step's
// pushes into the cotangent slots the other CTAs' passes read.
template <int BC>
__global__ void __launch_bounds__(MID_MAX_THREADS)
streamk_mid_bwd(const float* __restrict__ Sr, const float* __restrict__ Si,
                const float* __restrict__ C, const float* __restrict__ x0r,
                const float* __restrict__ x0i, const float* __restrict__ hr,
                const float* __restrict__ hi, const float* __restrict__ jr,
                const float* __restrict__ ji, const float* __restrict__ gTr,
                const float* __restrict__ gTi, const float* __restrict__ rows,
                const float* __restrict__ ksr, const float* __restrict__ ksi,
                float* __restrict__ g0r, float* __restrict__ g0i,
                float* __restrict__ Cbp, float* __restrict__ scratch,
                MidDims d) {
  extern __shared__ float sm[];
  const cg::cluster_group cl = cg::this_cluster();
  const int N = d.N, R = d.R, Ke = d.Ke, nt = d.nt, it = d.iters, G = d.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool jac = d.mode == MODE_JACOBI, split = d.mode == MODE_SPLIT;
  const bool replay = d.store == 0 && it > 0;
  const MidBand g = mid_band(d, BC, (int)cl.block_rank());
  Sr += g.e * d.strideS;          // this candidate's stack and solver rows
  Si += g.e * d.strideS;
  rows += g.e * d.strideR;
  const size_t BNv = (size_t)BC * N, BN = (size_t)d.B * N;
  const int BI = BC * R;
  float* Cs = sm;                           // it + 1 whole cotangents
  float* V = Cs + 2 * (size_t)(it + 1) * BNv;   // replay: two buffers
  float* U = V + (replay ? 4 * BNv : 0);    // it + 1 band inputs
  float* Gb = U + 2 * (it + 1) * BI;        // the bands of g, kb, bb
  float* KB = Gb + 2 * BI;
  float* BB = KB + 2 * BI;
  float* Bb = BB + 2 * BI;                  // replay: the bands of b, k
  float* Kb = Bb + 2 * BI;
  float* rw = BB + 2 * BI + (replay ? 4 * BI : 0);    // solver rows, 4 x R
  float* red = rw + 4 * R;                  // 16 warps x MID_KG partials
  float* HTr = d.global ? scratch + (size_t)blockIdx.x *
                                        mid_band_floats(N, R, true, replay)
                        : red + 16 * MID_KG;
  float* HTi = HTr + (size_t)R * (N + 1);
  float* Hr = HTi + (size_t)R * (N + 1);    // replay: the row band
  float* Hi = Hr + (size_t)R * N;

  const size_t nsm = mid_bwd_floats(BC, N, R, it, replay, !d.global);
  for (size_t i = tid; i < nsm; i += blockDim.x) sm[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < BI; i += blockDim.x) {
    const int b = i / R, il = i - b * R;
    if (b < g.nb && il < g.nr) {
      const size_t o = ((size_t)g.e * d.B + g.b0 + b) * N + g.r0 + il;
      Gb[i] = gTr[o];
      Gb[BI + i] = gTi[o];
    }
  }
  const int nrows = jac ? 4 : split ? 2 : 0;
  for (int i = tid; i < nrows * R; i += blockDim.x) {
    const int m = i / R, il = i - m * R;
    if (il < g.nr) rw[i] = rows[m * N + g.r0 + il];
  }
  const float* Ce = C + (size_t)g.e * nt * Ke;
  if (nt > 0) {       // the bands of H(nt - 1)
    col_pass<BC>(Sr, Si, Ke, N, g.r0, g.nr, R, Cs, U, 0,
                 Ce + (size_t)(nt - 1) * Ke, HTr, HTi, red, nullptr);
    if (replay)
      row_contract(Sr, Si, Ce + (size_t)(nt - 1) * Ke, Ke, N, g.r0, g.nr, Hr,
                   Hi, tid, blockDim.x);
  }
  cl.sync();    // every CTA's buffers are zeroed before the first push

  auto owned = [&](auto fn) {
    for (int il = warp; il < g.nr; il += nwarps)
      if (lane < BC) fn(il, lane, lane * R + il);
  };
  auto put = [&](float* buf, int b, int il, float vr, float vi) {
    push(cl, buf + b * N + g.r0 + il, vr, G);
    push(cl, buf + BNv + b * N + g.r0 + il, vi, G);
  };
  int p = 0;                      // replay: the operand buffer next read
  for (int t = nt - 1; t >= 0; --t) {
    const size_t st = (size_t)g.e * nt + t;
    owned([&](int il, int b, int ib) {
      float gr = Gb[ib], gi = Gb[BI + ib], xr = 0.f, xi = 0.f;
      if (b < g.nb) {
        const size_t col = (size_t)(g.b0 + b) * N + g.r0 + il;
        gr += jr[st * BN + col];
        gi += ji[st * BN + col];
        xr = t == 0 ? x0r[col] : hr[(st - 1) * BN + col];
        xi = t == 0 ? x0i[col] : hi[(st - 1) * BN + col];
        if (d.store)
          for (int q = 0; q < it; ++q) {  // pair q's input is k_{it-1-q}
            const size_t o = (st * it + it - 1 - q) * BN + col;
            U[2 * q * BI + ib] = ksr[o];
            U[2 * q * BI + BI + ib] = ksi[o];
          }
      }
      if (split) {        // cotangent and pre-state into the rotated frame
        cmul_conj(rw[il], rw[R + il], gr, gi);
        cmul(rw[il], rw[R + il], xr, xi);
      }
      Gb[ib] = gr;
      Gb[BI + ib] = gi;
      U[2 * it * BI + ib] = xr;
      U[2 * it * BI + BI + ib] = xi;
      if (replay) put(V + 2 * p * BNv, b, il, xr, xi);
    });
    if (replay) {         // k_0..k_{it-1} again from xp, on the row band
      cl.sync();
      for (int j = 0; j < it; ++j) {
        const float* Vr = V + 2 * p * BNv;
        float* Vn = V + 2 * (p ^ 1) * BNv;
        rows_dot<BC, false>(
            Hr, Hi, N, g.nr, Vr, Vr + BNv, N, warp, nwarps, lane,
            [&](int il, int b, float sr, float si) {
              const int ib = b * R + il;
              const float tr = si, ti = -sr;
              float kr = Kb[ib], ki = Kb[BI + ib];
              if (j == 0) {
                Bb[ib] = tr;
                Bb[BI + ib] = ti;
                mid_first(jac, rw, R, il, tr, ti, kr, ki);
              } else {
                mid_next(jac, d.a, rw, R, il, Bb[ib], Bb[BI + ib], tr, ti, kr,
                         ki);
              }
              Kb[ib] = kr;
              Kb[BI + ib] = ki;
              const int q = it - 1 - j;
              U[2 * q * BI + ib] = kr;
              U[2 * q * BI + BI + ib] = ki;
              if (j + 1 < it) put(Vn, b, il, kr, ki);
            });
        if (j + 1 < it) {
          p ^= 1;
          cl.sync();
        }
      }
      p ^= 1;
    }
    // the transposed chain: pair q < it has cotangent a kb (its input
    // k_{it-1-q}), pair it the cotangent bb (its input xp)
    owned([&](int il, int b, int ib) {
      KB[ib] = d.dt * Gb[ib];
      KB[BI + ib] = d.dt * Gb[BI + ib];
      BB[ib] = BB[BI + ib] = 0.f;
    });
    for (int q = 0; q <= it; ++q) {
      float* cq = Cs + 2 * q * BNv;
      owned([&](int il, int b, int ib) {
        float kr = KB[ib], ki = KB[BI + ib];
        if (jac) cmul_conj(rw[2 * R + il], rw[3 * R + il], kr, ki);   // Wt
        const float br = BB[ib] + kr, bi = BB[BI + ib] + ki;
        BB[ib] = br;
        BB[BI + ib] = bi;
        if (q < it)
          put(cq, b, il, d.a * kr, d.a * ki);
        else
          put(cq, b, il, br, bi);
      });
      cl.sync();
      rows_dot<BC, true>(
          HTr, HTi, N + 1, g.nr, cq, cq + BNv, N, warp, nwarps, lane,
          [&](int il, int b, float sr, float si) {
            const int ib = b * R + il;
            float tr = -si, ti = sr;           // Tt(c) from conj(H)^T c
            if (q < it) {
              if (jac) {      // minus the transpose of v -> d v
                const float cr = cq[b * N + g.r0 + il];
                const float ci = cq[BNv + b * N + g.r0 + il];
                tr -= rw[il] * cr + rw[R + il] * ci;
                ti -= rw[il] * ci - rw[R + il] * cr;
              }
              KB[ib] = tr;
              KB[BI + ib] = ti;
            } else {
              float gr = Gb[ib] + tr, gi = Gb[BI + ib] + ti;
              if (split) cmul_conj(rw[il], rw[R + il], gr, gi);
              Gb[ib] = gr;
              Gb[BI + ib] = gi;
            }
          });
    }
    __syncthreads();    // the chain is done with this step's bands of H
    col_pass<BC>(Sr, Si, Ke, N, g.r0, g.nr, R, Cs, U, it + 1,
                 t > 0 ? Ce + (size_t)(t - 1) * Ke : nullptr, HTr, HTi, red,
                 Cbp + ((size_t)blockIdx.x * nt + t) * Ke);
    if (replay && t > 0)
      row_contract(Sr, Si, Ce + (size_t)(t - 1) * Ke, Ke, N, g.r0, g.nr, Hr,
                   Hi, tid, blockDim.x);
    cl.sync();    // every CTA's pass has read the slots
  }
  owned([&](int il, int b, int ib) {
    if (b < g.nb) {
      const size_t o = ((size_t)g.e * d.B + g.b0 + b) * N + g.r0 + il;
      g0r[o] = Gb[ib];
      g0i[o] = Gb[BI + ib];
    }
  });
}

// ---------------------------------------------------------------------------
// The backward's 'helpers' schedule: the column pass off the chain. Above,
// 'chain': each step's pass (Hb, C-bar, the next bands of H) runs in the
// cluster's own chain after its transposed stages. Here the chain clusters
// run only the operand loads, the replay and the transposed stages, and the
// pass runs beside them, on helper clusters the launch adds where the card
// would leave SMs idle (ops/streamk.py::bwd_schedule).
//
// A group is one chain cluster (candidate, chunk of BC states) and its
// helpers. Its hand-off memory (ring, split_ring_floats floats):
//   the H ring, 2 slots, each H(t)^T (N rows of ldr floats, row q the
//     column q of H) and, with replay, H(t) row-major, re then im;
//   the pairs ring, 2 slots, each the step's it + 1 (cotangent, input)
//     pairs, whole vectors: pair q at 4 q BC N, cotangent (re, im), then
//     input (re, im), each BC x N.
// The pass is cut in tiles of TILE_P rows (pp) x TILE_Q columns (q) of the
// whole matrix; pass i (0 <= i <= nt + 1) of the steps in reverse contracts
// H(nt - 1 - i) (i < nt) into H slot i & 1 and reduces C-bar of step
// s = i - 2's pairs (i >= 2; pairs slot s & 1) into each tile's row of
// Cbt (groups, tiles, nt, Ke), which the wrapper sums in a fixed order.
// Chain step s waits for pass s (its H) and then writes pairs slot s & 1,
// which pass s read; pass i writes H slot i & 1 only after the pairs of
// step i - 2, whose chain last read that slot, are published. So two slots
// each, and the passes run one step ahead of the chain.
// flags (ints, zeroed by the wrapper): a ticket counter, then per group the
// tiles claimed and the tiles done of each pass (nt + 2 each) and the chain
// CTAs that published each step's pairs (nt). A cluster takes group and
// role by ticket in the order it starts: ticket (1 + helpers) m + 0 is
// group m's chain, the next `helpers` its helpers, so a helper waits only
// on a chain that started before it. Tiles are claimed by an atomic counter,
// by the helpers and, while its pass is not done, by the chain's CTAs
// themselves: no chain waits on a CTA that has not started, and a tile's
// result does not depend on which CTA ran it (the same bits with any number
// of helpers, none included).
// Numerics: H's entries are the same fmaf chains in k order as the chain
// schedule's, and the chain's stages the same products in the same order,
// so g0 has its bits; C-bar is summed by tiles, in another order than the
// chain schedule's CTA partials.
// ---------------------------------------------------------------------------
namespace {

constexpr int TILE_P = 32;      // rows pp of a pass tile
constexpr int TILE_Q = 64;      // columns q of a pass tile
constexpr int TILE_LD = TILE_P + 1;     // row stride of a staged tile

struct SplitDims {
  int ldr;        // row stride of the rings' planes: N rounded up to 4
  int tq;         // tiles across a row of the matrix
  int ntiles;     // tiles of a pass
  int helpers;    // helper clusters per chain cluster
};

__host__ __device__ inline int split_ldr(int N) { return (N + 3) & ~3; }

__host__ __device__ inline size_t round4(size_t n) {
  return (n + 3) & ~(size_t)3;
}

// floats of one group's hand-off memory: the H ring, then the pairs ring
__host__ __device__ inline size_t split_ring_floats(int BC, int N, int it,
                                                    bool replay) {
  return 2 * (size_t)(replay ? 2 : 1) * 2 * N * split_ldr(N) +
         2 * (size_t)(it + 1) * 4 * BC * N;
}

__host__ __device__ inline size_t split_flag_ints(int nt) {
  return 3 * (size_t)nt + 4;
}

// floats of a tile's scratch: the tile of H staged transposed (re, im), the
// warps' C-bar partials, the npairs pairs' cotangents on its rows and inputs
// on its columns (the backward's it + 1; none for the forward)
__host__ __device__ inline size_t tile_floats(int BC, int npairs) {
  return 2 * TILE_Q * TILE_LD + 16 * MID_KG +
         (size_t)npairs * BC * 2 * (TILE_P + TILE_Q);
}

// Floats of the helpers schedule's shared memory: a header of 8 words, the
// it + 1 whole cotangents, with replay two operand buffers, the bands of g,
// kb, bb (with replay also b, k), the solver rows, two slots of a step's
// operands (j, the pre-state and the stored iterates, by band), then one
// region, 16-byte aligned, that holds either the step's bands of H (the
// smem layout) or a tile's scratch.
__host__ __device__ inline size_t mid_split_floats(int BC, int N, int R,
                                                   int it, bool replay,
                                                   bool stored, bool hsmem) {
  const size_t BNv = (size_t)BC * N, BR = (size_t)BC * R;
  const size_t head = 8 + 2 * (size_t)(it + 1) * BNv +
                      (replay ? 4 * BNv : 0) + (replay ? 10 : 6) * BR +
                      4 * (size_t)R + 2 * (4 + 2 * (stored ? it : 0)) * BR;
  const size_t band =
      hsmem ? 2 * (size_t)R * split_ldr(N) * (replay ? 2 : 1) : 0;
  const size_t tile = tile_floats(BC, it + 1);
  return round4(head) + (band > tile ? band : tile);
}

// The forward's 'helpers' schedule (streamk_mid_fwd_helpers): a group's
// ring of H, FWD_SLOTS slots, each H(t) row-major (N rows of ldr floats, re
// then im); its counters (per step: tiles claimed, tiles done, chain CTAs
// that released the slot); its shared memory: a header of 8 words, the
// chain's (mid_fwd_floats without the band), then one region, 16-byte
// aligned, that holds either the step's row band of H (the smem layout) or
// a tile's scratch.
constexpr int FWD_SLOTS = 3;

__host__ __device__ inline size_t fwd_ring_floats(int N) {
  return (size_t)FWD_SLOTS * 2 * N * split_ldr(N);
}

__host__ __device__ inline size_t fwd_flag_ints(int nt) {
  return 3 * (size_t)nt;
}

__host__ __device__ inline size_t mid_fwd_split_floats(int BC, int N, int R,
                                                       bool hsmem) {
  const size_t head = 8 + mid_fwd_floats(BC, N, R, false);
  const size_t band = hsmem ? 2 * (size_t)R * split_ldr(N) : 0;
  const size_t tile = tile_floats(BC, 0);
  return round4(head) + (band > tile ? band : tile);
}

// Four consecutive stack entries of a row from device memory, streamed
// (evict-first in L2, so the rings stay); 16 bytes where the row is aligned,
// else one by one, zero past the row's end (left entries remain).
__device__ __forceinline__ void load4(const float* p, bool vec, int left,
                                      float (&v)[4]) {
  if (vec) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < left ? __ldcs(p + e) : 0.f;
  }
}

// One tile of a pass, by the whole CTA: rows [p0, p0 + TILE_P) x columns
// [q0, q0 + TILE_Q) of the matrix. With cbout: Hb(pp, q) from the npairs
// pairs at P (the chain schedule's formula), added against every slot into
// the tile's C-bar row cbout (each thread's partials over its entries, a
// shuffle tree per warp, the warps in order). With cn: H = sum_k cn_k S_k
// (fmaf in k order, carried through the staged tile across groups of
// MID_KG slots), written transposed into HT (row q: column q of H) and,
// with Hrow, row-major, both of row stride ldr, 16 bytes a lane,
// consecutive lanes on consecutive floats. The stacks are read 16 bytes a
// lane where N % 4 == 0. Ends with a barrier.
template <int BC>
__device__ void tile_pass(const float* __restrict__ Sr,
                          const float* __restrict__ Si, int Ke, int N,
                          int ldr, int npairs, const float* P,
                          const float* __restrict__ cn, float* HT,
                          float* Hrow, int tile, int tq, float* ts,
                          float* __restrict__ cbout) {
  const int tid = threadIdx.x, nth = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5, nwarps = nth >> 5;
  const size_t NN = (size_t)N * N, NL = (size_t)N * ldr;
  const int p0 = (tile / tq) * TILE_P, q0 = (tile % tq) * TILE_Q;
  float* Tr = ts;                             // the tile of H, transposed
  float* Ti = Tr + TILE_Q * TILE_LD;
  float* red = Ti + TILE_Q * TILE_LD;         // 16 warps x MID_KG
  float* Pc = red + 16 * MID_KG;              // npairs x 2 x BC x TILE_P
  float* Pu = Pc + npairs * 2 * BC * TILE_P;  // npairs x 2 x BC x TILE_Q
  for (int i = tid; i < npairs * 2 * BC * TILE_P; i += nth) {
    const int m = i / TILE_P, pp = p0 + i - m * TILE_P;
    const int pr = m / (2 * BC), rest = m - pr * 2 * BC;
    Pc[i] = pp < N ? __ldcg(P + (size_t)(pr * 4 * BC + rest) * N + pp) : 0.f;
  }
  for (int i = tid; i < npairs * 2 * BC * TILE_Q; i += nth) {
    const int m = i / TILE_Q, q = q0 + i - m * TILE_Q;
    const int pr = m / (2 * BC), rest = m - pr * 2 * BC;
    Pu[i] = q < N ? __ldcg(P + (size_t)(pr * 4 * BC + 2 * BC + rest) * N + q)
                  : 0.f;
  }
  __syncthreads();
  const bool vec = (N & 3) == 0;
  constexpr int QR = TILE_Q / 4;              // quads of a tile row
  for (int k0 = 0; k0 < Ke; k0 += MID_KG) {
    float cb[MID_KG];
#pragma unroll
    for (int kk = 0; kk < MID_KG; ++kk) cb[kk] = 0.f;
    for (int idx = tid; idx < TILE_P * QR; idx += nth) {
      const int pl = idx / QR, c4 = idx - pl * QR;
      const int pp = p0 + pl, qa = q0 + 4 * c4;
      if (pp >= N || qa >= N) continue;
      float hbr[4] = {0.f, 0.f, 0.f, 0.f}, hbi[4] = {0.f, 0.f, 0.f, 0.f};
      for (int pr = 0; pr < npairs; ++pr) {
#pragma unroll
        for (int b = 0; b < BC; ++b) {
          const int mr = (pr * 2) * BC + b, mi = mr + BC;
          const float cr = Pc[mr * TILE_P + pl], ci = Pc[mi * TILE_P + pl];
          const float4 u4r =
              *reinterpret_cast<const float4*>(Pu + mr * TILE_Q + 4 * c4);
          const float4 u4i =
              *reinterpret_cast<const float4*>(Pu + mi * TILE_Q + 4 * c4);
          const float ur[4] = {u4r.x, u4r.y, u4r.z, u4r.w};
          const float ui[4] = {u4i.x, u4i.y, u4i.z, u4i.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            hbr[e] = fmaf(cr, ui[e], hbr[e]);
            hbr[e] = fmaf(-ci, ur[e], hbr[e]);
            hbi[e] = fmaf(cr, ur[e], hbi[e]);
            hbi[e] = fmaf(ci, ui[e], hbi[e]);
          }
        }
      }
      float hnr[4], hni[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hnr[e] = k0 > 0 ? Tr[(4 * c4 + e) * TILE_LD + pl] : 0.f;
        hni[e] = k0 > 0 ? Ti[(4 * c4 + e) * TILE_LD + pl] : 0.f;
      }
      const size_t off = (size_t)pp * N + qa;
#pragma unroll
      for (int kk = 0; kk < MID_KG; ++kk) {
        const int k = k0 + kk;
        if (k < Ke) {
          float sr[4], si[4];
          load4(Sr + k * NN + off, vec, N - qa, sr);
          load4(Si + k * NN + off, vec, N - qa, si);
          if (cbout != nullptr) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              cb[kk] = fmaf(hbr[e], sr[e], cb[kk]);
              cb[kk] = fmaf(hbi[e], si[e], cb[kk]);
            }
          }
          if (cn != nullptr) {
            const float c = cn[k];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              hnr[e] = fmaf(c, sr[e], hnr[e]);
              hni[e] = fmaf(c, si[e], hni[e]);
            }
          }
        }
      }
      if (cn != nullptr) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          Tr[(4 * c4 + e) * TILE_LD + pl] = hnr[e];
          Ti[(4 * c4 + e) * TILE_LD + pl] = hni[e];
        }
      }
    }
    if (cbout != nullptr) {
#pragma unroll
      for (int kk = 0; kk < MID_KG; ++kk) {
        float v = cb[kk];
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) red[warp * MID_KG + kk] = v;
      }
      __syncthreads();
      if (tid < MID_KG && k0 + tid < Ke) {
        float v = 0.f;
        for (int w = 0; w < nwarps; ++w) v += red[w * MID_KG + tid];
        cbout[k0 + tid] = v;
      }
      __syncthreads();
    }
  }
  __syncthreads();      // the staged tile is whole
  if (HT != nullptr) {  // row q of H^T: TILE_P floats from column pp = p0
    constexpr int QP = TILE_P / 4;
    for (int idx = tid; idx < TILE_Q * QP; idx += nth) {
      const int ql = idx / QP, c4 = idx - ql * QP;
      const int q = q0 + ql, pa = p0 + 4 * c4;
      if (q >= N || pa >= N) continue;
      const float* tr = Tr + ql * TILE_LD + 4 * c4;
      const float* ti = Ti + ql * TILE_LD + 4 * c4;
      *reinterpret_cast<float4*>(HT + (size_t)q * ldr + pa) =
          make_float4(tr[0], tr[1], tr[2], tr[3]);
      *reinterpret_cast<float4*>(HT + NL + (size_t)q * ldr + pa) =
          make_float4(ti[0], ti[1], ti[2], ti[3]);
    }
  }
  if (Hrow != nullptr) {
    for (int idx = tid; idx < TILE_P * QR; idx += nth) {
      const int pl = idx / QR, c4 = idx - pl * QR;
      const int pp = p0 + pl, qa = q0 + 4 * c4;
      if (pp >= N || qa >= N) continue;
      const float* tr = Tr + 4 * c4 * TILE_LD + pl;
      const float* ti = Ti + 4 * c4 * TILE_LD + pl;
      *reinterpret_cast<float4*>(Hrow + (size_t)pp * ldr + qa) = make_float4(
          tr[0], tr[TILE_LD], tr[2 * TILE_LD], tr[3 * TILE_LD]);
      *reinterpret_cast<float4*>(Hrow + NL + (size_t)pp * ldr + qa) =
          make_float4(ti[0], ti[TILE_LD], ti[2 * TILE_LD], ti[3 * TILE_LD]);
    }
  }
  __syncthreads();      // the scratch is free for the next tile
}

}  // namespace

// ---------------------------------------------------------------------------
// The forward's 'helpers' schedule: the row contraction off the chain. In
// the chain schedule (streamk_mid_fwd) each CTA contracts its row band of
// H(t) at the top of step t, on the dependent chain, from stacks that pass
// L2 past N = 512 (64 MB at N = 1024), with 4-byte loads on the cluster's
// SMs. Here the chain clusters run only the stages, and H(t) is contracted
// by the backward's pass tiles of the whole matrix (tile_pass, no pairs,
// the row-major write only) on helper clusters the launch adds where the
// card would leave SMs idle (ops/streamk.py::fwd_schedule), into a ring of
// FWD_SLOTS steps of H in device memory, so that they run up to
// FWD_SLOTS - 1 steps ahead of the chain.
// A group is one chain cluster (candidate, chunk of BC states) and its
// helpers, with its ring (fwd_ring_floats) and counters. Pass t contracts
// H(t) into slot t % FWD_SLOTS once the chain's G CTAs released the slot's
// step t - FWD_SLOTS (released[t - FWD_SLOTS] == G); chain step t waits
// until the pass's tiles are done (done[t] == tiles) and then reads its row
// band: in the smem layout copied into shared memory before the step's
// first stage (the slot released right after), in the global layout from
// L2 (released at the step's end). flags (ints, zeroed by the wrapper): a
// ticket counter, then per group claimed, done and released (nt each).
// Tickets, as in the backward's: ticket (1 + helpers) m + 0 is group m's
// chain and the next `helpers` its helpers, so a helper waits only on a
// chain that started before it; tiles are claimed by an atomic counter, by
// the helpers and by the chain's own CTAs, which claim whatever is left of
// step t's pass at its top: no chain waits on a cluster that has not
// started, and any helper count (none too) gives the same bits.
// Numerics: each entry of H is one fmaf chain from 0 in k order, as
// row_contract computes it, and the chain's stages are FwdChain's, the
// chain schedule's products in the same order: xT, the history and the
// stored iterates have the chain schedule's bits.
// ---------------------------------------------------------------------------
template <int BC>
__global__ void __launch_bounds__(MID_MAX_THREADS)
streamk_mid_fwd_helpers(
    const float* __restrict__ Sr, const float* __restrict__ Si,
    const float* __restrict__ C, const float* __restrict__ x0r,
    const float* __restrict__ x0i, const float* __restrict__ rows,
    float* __restrict__ xTr, float* __restrict__ xTi, float* __restrict__ hr,
    float* __restrict__ hi, float* __restrict__ ksr, float* __restrict__ ksi,
    float* ring, int* flags, MidDims d, SplitDims s) {
  extern __shared__ float sm[];
  const cg::cluster_group cl = cg::this_cluster();
  int* hdr = reinterpret_cast<int*>(sm);
  const int rank = (int)cl.block_rank();
  if (rank == 0 && threadIdx.x == 0) hdr[0] = atomicAdd(flags, 1);
  cl.sync();
  const int ticket = *cl.map_shared_rank(hdr, 0);
  cl.sync();    // rank 0's ticket is read before any CTA moves on
  const int grp = ticket / (1 + s.helpers);
  const bool chain = ticket % (1 + s.helpers) == 0;

  const int N = d.N, R = d.R, Ke = d.Ke, nt = d.nt, G = d.G, ldr = s.ldr;
  const int tid = threadIdx.x;
  const size_t NL = (size_t)N * ldr;
  float* Hring = ring + grp * fwd_ring_floats(N);
  int* claim = flags + 1 + grp * fwd_flag_ints(nt);
  int* done = claim + nt;
  int* released = done + nt;
  const int e = grp / d.nchunks;
  Sr += e * d.strideS;            // this candidate's stack and solver rows
  Si += e * d.strideS;
  rows += e * d.strideR;
  const float* Ce = C + (size_t)e * nt * Ke;

  // the tiles of pass t (H(t) into its slot) this CTA can claim, until none
  // is left, once the slot's last reader released it
  auto run_pass = [&](int t, float* ts) {
    if (t >= FWD_SLOTS) {
      if (tid == 0) wait_count(released + t - FWD_SLOTS, G);
      __syncthreads();
    }
    float* Hs = Hring + (size_t)(t % FWD_SLOTS) * 2 * NL;
    for (;;) {
      if (tid == 0) hdr[1] = atomicAdd(claim + t, 1);
      __syncthreads();
      const int tile = hdr[1];
      __syncthreads();
      if (tile >= s.ntiles) break;
      tile_pass<BC>(Sr, Si, Ke, N, ldr, 0, nullptr, Ce + (size_t)t * Ke,
                    nullptr, Hs, tile, s.tq, ts, nullptr);
      if (tid == 0) signal_count(done + t);
    }
  };

  if (!chain) {
    for (int t = 0; t < nt; ++t) run_pass(t, sm + 8);
    return;
  }

  MidBand g;      // the group's candidate and chunk, this CTA's band
  g.e = e;
  g.r0 = rank * R;
  g.nr = min(R, N - g.r0);
  g.b0 = (grp - e * d.nchunks) * BC;
  g.nb = min(BC, d.B - g.b0);
  FwdChain<BC> c(d, g, sm + 8);
  float* region = sm + round4(8 + mid_fwd_floats(BC, N, R, false));
  for (size_t i = 8 + tid; i < (size_t)(region - sm); i += blockDim.x)
    sm[i] = 0.f;
  __syncthreads();
  c.load(x0r, x0i, rows);
  cl.sync();    // every CTA's buffers are zeroed before the first push

  for (int t = 0; t < nt; ++t) {
    // H(t): pass t, run by the helpers, or by this CTA where it can
    run_pass(t, region);
    if (tid == 0) wait_count(done + t, s.ntiles);
    __syncthreads();
    const float* Hs =
        Hring + (size_t)(t % FWD_SLOTS) * 2 * NL + (size_t)g.r0 * ldr;
    if (!d.global) {      // the band into shared memory
      const int nb4 = g.nr * ldr / 4;
      for (int i = tid; i < 2 * nb4; i += blockDim.x) {
        const int m = i / nb4, o = 4 * (i - m * nb4);
        cp_async16_l2(region + (size_t)m * R * ldr + o, Hs + m * NL + o);
      }
    }
    c.put_x(cl);
    cp_async_wait();
    cl.sync();    // x whole in every CTA; this CTA's band in shared memory
    if (d.global) {
      c.template stages<true>(cl, Hs, Hs + NL, ldr, t, hr, hi, ksr, ksi);
      __syncthreads();    // the CTA's reads of the slot are done
      if (tid == 0) signal_count(released + t);
    } else {
      if (tid == 0) signal_count(released + t);   // the band is copied
      c.template stages<false>(cl, region, region + (size_t)R * ldr, ldr, t,
                               hr, hi, ksr, ksi);
    }
  }
  c.write_xT(xTr, xTi);
  cl.sync();    // no CTA leaves while another may still address it
}

// Backward, 'helpers' schedule: the chain schedule's contract (inputs, g0,
// the steps in reverse and each step's chain in the same order), with
// C-bar by tiles into Cbt and the pass beside the chain (see above). ring,
// flags: the groups' hand-off memory and counters, sized by the wrapper.
template <int BC>
__global__ void __launch_bounds__(MID_MAX_THREADS)
streamk_mid_bwd_helpers(
    const float* __restrict__ Sr, const float* __restrict__ Si,
    const float* __restrict__ C, const float* __restrict__ x0r,
    const float* __restrict__ x0i, const float* __restrict__ hr,
    const float* __restrict__ hi, const float* __restrict__ jr,
    const float* __restrict__ ji, const float* __restrict__ gTr,
    const float* __restrict__ gTi, const float* __restrict__ rows,
    const float* __restrict__ ksr, const float* __restrict__ ksi,
    float* __restrict__ g0r, float* __restrict__ g0i,
    float* __restrict__ Cbt, float* ring, int* flags, MidDims d,
    SplitDims s) {
  extern __shared__ float sm[];
  const cg::cluster_group cl = cg::this_cluster();
  int* hdr = reinterpret_cast<int*>(sm);
  const int rank = (int)cl.block_rank();
  if (rank == 0 && threadIdx.x == 0) hdr[0] = atomicAdd(flags, 1);
  cl.sync();
  const int ticket = *cl.map_shared_rank(hdr, 0);
  cl.sync();    // rank 0's ticket is read before any CTA moves on
  const int grp = ticket / (1 + s.helpers);
  const bool chain = ticket % (1 + s.helpers) == 0;

  const int N = d.N, R = d.R, Ke = d.Ke, nt = d.nt, it = d.iters, G = d.G;
  const int ldr = s.ldr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool jac = d.mode == MODE_JACOBI, split = d.mode == MODE_SPLIT;
  const bool replay = d.store == 0 && it > 0;
  const bool stored = d.store != 0 && it > 0;
  const size_t NL = (size_t)N * ldr;
  const size_t hslot = (replay ? 4 : 2) * NL;
  const size_t pslot = (size_t)(it + 1) * 4 * BC * N;
  float* Hring = ring + grp * split_ring_floats(BC, N, it, replay);
  float* Pring = Hring + 2 * hslot;
  int* claim = flags + 1 + grp * split_flag_ints(nt);
  int* done = claim + nt + 2;
  int* ready = done + nt + 2;
  const int e = grp / d.nchunks;
  Sr += e * d.strideS;            // this candidate's stack and solver rows
  Si += e * d.strideS;
  rows += e * d.strideR;
  const float* Ce = C + (size_t)e * nt * Ke;
  float* cbg = Cbt + (size_t)grp * s.ntiles * nt * Ke;

  // the tiles of pass i this CTA can claim, until none is left
  auto run_pass = [&](int i, float* ts) {
    const bool cbar = i >= 2, contract = i < nt;
    if (!cbar && !contract) return;
    if (cbar) {
      if (tid == 0) wait_count(ready + i - 2, G);
      __syncthreads();
    }
    float* Hs = Hring + (i & 1) * hslot;
    for (;;) {
      if (tid == 0) hdr[1] = atomicAdd(claim + i, 1);
      __syncthreads();
      const int tile = hdr[1];
      __syncthreads();
      if (tile >= s.ntiles) break;
      tile_pass<BC>(Sr, Si, Ke, N, ldr, cbar ? it + 1 : 0,
                    Pring + (i & 1) * pslot,
                    contract ? Ce + (size_t)(nt - 1 - i) * Ke : nullptr,
                    contract ? Hs : nullptr,
                    contract && replay ? Hs + 2 * NL : nullptr, tile, s.tq,
                    ts, cbar ? cbg + ((size_t)tile * nt + nt + 1 - i) * Ke
                              : nullptr);
      if (tid == 0) signal_count(done + i);
    }
  };

  if (!chain) {
    for (int i = 0; i < nt + 2; ++i) run_pass(i, sm + 8);
    return;
  }

  MidBand g;      // the group's candidate and chunk, this CTA's band
  g.e = e;
  g.r0 = rank * R;
  g.nr = min(R, N - g.r0);
  g.b0 = (grp - e * d.nchunks) * BC;
  g.nb = min(BC, d.B - g.b0);
  const size_t BNv = (size_t)BC * N, BN = (size_t)d.B * N;
  const int BI = BC * R;
  float* Cs = sm + 8;                       // it + 1 whole cotangents
  float* V = Cs + 2 * (size_t)(it + 1) * BNv;   // replay: two buffers
  float* Gb = V + (replay ? 4 * BNv : 0);   // the bands of g, kb, bb
  float* KB = Gb + 2 * BI;
  float* BB = KB + 2 * BI;
  float* Bb = BB + 2 * BI;                  // replay: the bands of b, k
  float* Kb = Bb + 2 * BI;
  float* rw = BB + 2 * BI + (replay ? 4 * BI : 0);    // solver rows, 4 x R
  float* OP = rw + 4 * R;                   // two slots of step operands
  const int opw = (4 + 2 * (stored ? it : 0)) * BI;
  float* region = sm + round4(OP + 2 * opw - sm);
  const float *HTr, *HTi, *Hr, *Hi;         // this step's bands of H

  for (size_t i = 8 + tid; i < (size_t)(region - sm); i += blockDim.x)
    sm[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < BI; i += blockDim.x) {
    const int b = i / R, il = i - b * R;
    if (b < g.nb && il < g.nr) {
      const size_t o = ((size_t)g.e * d.B + g.b0 + b) * N + g.r0 + il;
      Gb[i] = gTr[o];
      Gb[BI + i] = gTi[o];
    }
  }
  const int nrows = jac ? 4 : split ? 2 : 0;
  for (int i = tid; i < nrows * R; i += blockDim.x) {
    const int m = i / R, il = i - m * R;
    if (il < g.nr) rw[i] = rows[m * N + g.r0 + il];
  }

  auto owned = [&](auto fn) {
    for (int il = warp; il < g.nr; il += nwarps)
      if (lane < BC) fn(il, lane, lane * R + il);
  };
  auto put = [&](float* buf, int b, int il, float vr, float vi) {
    push(cl, buf + b * N + g.r0 + il, vr, G);
    push(cl, buf + BNv + b * N + g.r0 + il, vi, G);
  };
  // pair q's cotangent (cu = 0) or input (cu = 2) entry into the pairs ring
  auto put_pair = [&](float* P, int q, int cu, int b, int il, float vr,
                      float vi) {
    float* o = P + (size_t)(q * 4 + cu) * BNv + b * N + g.r0 + il;
    o[0] = vr;
    o[BNv] = vi;
  };
  // step t's operands (j, the pre-state, the stored iterates) into slot sl
  // by their owners' cp.async, a step ahead
  auto fetch = [&](int t, int sl) {
    if (t < 0) return;
    float* o = OP + sl * opw;
    const size_t st = (size_t)g.e * nt + t;
    owned([&](int il, int b, int ib) {
      if (b >= g.nb) return;
      const size_t col = (size_t)(g.b0 + b) * N + g.r0 + il;
      cp_async4(o + ib, jr + st * BN + col);
      cp_async4(o + BI + ib, ji + st * BN + col);
      cp_async4(o + 2 * BI + ib,
                t == 0 ? x0r + col : hr + (st - 1) * BN + col);
      cp_async4(o + 3 * BI + ib,
                t == 0 ? x0i + col : hi + (st - 1) * BN + col);
      if (stored)
        for (int q = 0; q < it; ++q) {    // pair q's input is k_{it-1-q}
          const size_t k = (st * it + it - 1 - q) * BN + col;
          cp_async4(o + (4 + 2 * q) * BI + ib, ksr + k);
          cp_async4(o + (5 + 2 * q) * BI + ib, ksi + k);
        }
    });
  };
  fetch(nt - 1, 0);
  cl.sync();    // every CTA's buffers are zeroed before the first push

  int p = 0;                      // replay: the operand buffer next read
  for (int sidx = 0; sidx < nt; ++sidx) {
    const int t = nt - 1 - sidx;
    // H(t): pass sidx, run by the helpers, or by this CTA where it can
    run_pass(sidx, region);
    if (tid == 0) wait_count(done + sidx, s.ntiles);
    __syncthreads();
    const float* Hs = Hring + (sidx & 1) * hslot + (size_t)g.r0 * ldr;
    if (d.global) {
      HTr = Hs;
      HTi = Hs + NL;
      Hr = Hs + 2 * NL;
      Hi = Hs + 3 * NL;
    } else {      // the bands into shared memory
      const int nb4 = g.nr * ldr / 4, nplanes = replay ? 4 : 2;
      for (int i = tid; i < nplanes * nb4; i += blockDim.x) {
        const int m = i / nb4, o = 4 * (i - m * nb4);
        cp_async16_l2(region + (size_t)m * R * ldr + o, Hs + m * NL + o);
      }
      HTr = region;
      HTi = region + (size_t)R * ldr;
      Hr = region + 2 * (size_t)R * ldr;
      Hi = region + 3 * (size_t)R * ldr;
    }
    cp_async_wait();      // the bands, and the thread's operands of step t
    float* Pw = Pring + (sidx & 1) * pslot;     // this step's pairs
    const float* o = OP + (sidx & 1) * opw;
    owned([&](int il, int b, int ib) {
      float gr = Gb[ib], gi = Gb[BI + ib], xr = 0.f, xi = 0.f;
      if (b < g.nb) {
        gr += o[ib];
        gi += o[BI + ib];
        xr = o[2 * BI + ib];
        xi = o[3 * BI + ib];
      }
      if (split) {        // cotangent and pre-state into the rotated frame
        cmul_conj(rw[il], rw[R + il], gr, gi);
        cmul(rw[il], rw[R + il], xr, xi);
      }
      Gb[ib] = gr;
      Gb[BI + ib] = gi;
      put_pair(Pw, it, 2, b, il, xr, xi);
      if (stored)
        for (int q = 0; q < it; ++q)
          put_pair(Pw, q, 2, b, il, b < g.nb ? o[(4 + 2 * q) * BI + ib] : 0.f,
                   b < g.nb ? o[(5 + 2 * q) * BI + ib] : 0.f);
      if (replay) put(V + 2 * p * BNv, b, il, xr, xi);
    });
    fetch(t - 1, (sidx + 1) & 1);
    __syncthreads();      // the bands are whole in shared memory
    if (replay) {         // k_0..k_{it-1} again from xp, on the row band
      cl.sync();
      for (int j = 0; j < it; ++j) {
        const float* Vr = V + 2 * p * BNv;
        float* Vn = V + 2 * (p ^ 1) * BNv;
        auto stage = [&](int il, int b, float sr, float si) {
          const int ib = b * R + il;
          const float tr = si, ti = -sr;
          float kr = Kb[ib], ki = Kb[BI + ib];
          if (j == 0) {
            Bb[ib] = tr;
            Bb[BI + ib] = ti;
            mid_first(jac, rw, R, il, tr, ti, kr, ki);
          } else {
            mid_next(jac, d.a, rw, R, il, Bb[ib], Bb[BI + ib], tr, ti, kr,
                     ki);
          }
          Kb[ib] = kr;
          Kb[BI + ib] = ki;
          put_pair(Pw, it - 1 - j, 2, b, il, kr, ki);
          if (j + 1 < it) put(Vn, b, il, kr, ki);
        };
        if (d.global)
          rows_dot_l2<BC, false>(Hr, Hi, ldr, g.nr, Vr, Vr + BNv, N, warp,
                                 nwarps, lane, stage);
        else
          rows_dot<BC, false>(Hr, Hi, ldr, g.nr, Vr, Vr + BNv, N, warp,
                              nwarps, lane, stage);
        if (j + 1 < it) {
          p ^= 1;
          cl.sync();
        }
      }
      p ^= 1;
    }
    // the transposed chain: pair q < it has cotangent a kb (its input
    // k_{it-1-q}), pair it the cotangent bb (its input xp)
    owned([&](int il, int b, int ib) {
      KB[ib] = d.dt * Gb[ib];
      KB[BI + ib] = d.dt * Gb[BI + ib];
      BB[ib] = BB[BI + ib] = 0.f;
    });
    for (int q = 0; q <= it; ++q) {
      float* cq = Cs + 2 * q * BNv;
      owned([&](int il, int b, int ib) {
        float kr = KB[ib], ki = KB[BI + ib];
        if (jac) cmul_conj(rw[2 * R + il], rw[3 * R + il], kr, ki);   // Wt
        const float br = BB[ib] + kr, bi = BB[BI + ib] + ki;
        BB[ib] = br;
        BB[BI + ib] = bi;
        const float cr = q < it ? d.a * kr : br;
        const float ci = q < it ? d.a * ki : bi;
        put(cq, b, il, cr, ci);
        put_pair(Pw, q, 0, b, il, cr, ci);
      });
      cl.sync();
      auto stage = [&](int il, int b, float sr, float si) {
        const int ib = b * R + il;
        float tr = -si, ti = sr;           // Tt(c) from conj(H)^T c
        if (q < it) {
          if (jac) {      // minus the transpose of v -> d v
            const float cr = cq[b * N + g.r0 + il];
            const float ci = cq[BNv + b * N + g.r0 + il];
            tr -= rw[il] * cr + rw[R + il] * ci;
            ti -= rw[il] * ci - rw[R + il] * cr;
          }
          KB[ib] = tr;
          KB[BI + ib] = ti;
        } else {
          float gr = Gb[ib] + tr, gi = Gb[BI + ib] + ti;
          if (split) cmul_conj(rw[il], rw[R + il], gr, gi);
          Gb[ib] = gr;
          Gb[BI + ib] = gi;
        }
      };
      if (d.global)
        rows_dot_l2<BC, true>(HTr, HTi, ldr, g.nr, cq, cq + BNv, N, warp,
                              nwarps, lane, stage);
      else
        rows_dot<BC, true>(HTr, HTi, ldr, g.nr, cq, cq + BNv, N, warp,
                           nwarps, lane, stage);
    }
    __syncthreads();
    if (tid == 0) signal_count(ready + sidx);     // the step's pairs
    // the next step's first pushes (into cotangent slot 0, or with replay
    // into an operand buffer) wait until every CTA has read that slot:
    // with stored iterates and it >= 1 each CTA read slot 0 before the
    // barrier of stage 1, which this CTA has passed
    if (replay || it == 0) cl.sync();
  }
  // the C-bar of the last two steps' pairs, where no helper took it
  run_pass(nt, region);
  run_pass(nt + 1, region);
  owned([&](int il, int b, int ib) {
    if (b < g.nb) {
      const size_t o = ((size_t)g.e * d.B + g.b0 + b) * N + g.r0 + il;
      g0r[o] = Gb[ib];
      g0i[o] = Gb[BI + ib];
    }
  });
}

// Plain C entry points, bound from Python with ctypes. Each launches on the
// given stream a grid of E * ceil(B / BC) clusters of G CTAs and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue, launching
// nothing, for a shape the kernels do not take: G not in {1, 2, 4, 8, 16}
// or past N bands, BC not in {1, 2, 4, 8}, threads not whole warps up to
// MID_MAX_THREADS, shared memory below the layout or above 227 KB, the
// global layout without scratch, or a negative stride. strideS, strideR:
// floats between two candidates' stacks (Ke x N x N) and solver rows; 0 for
// the shared stack (the launch then reads what it read before the strides).
// helpers >= 0 takes a direction's 'helpers' schedule: E * ceil(B / BC) *
// (1 + helpers) clusters, ring and flags as the kernel reads them (flags
// zeroed; the backward's Cbp its tiles' C-bar rows (groups, tiles, nt,
// Ke)); -1 the chain schedule (scratch for the global layout; the
// backward's Cbp a row per CTA).
namespace {

// The dims of a launch, or false for a shape the kernels do not take.
// helpers >= 0: the direction's 'helpers' schedule with that many helper
// clusters per chain cluster (ring and flags given); -1: the chain schedule.
bool mid_dims(MidDims& d, int E, int nt, int B, int N, int Ke, int iters,
              int mode, int store, float dt, float a, int G, int BC,
              int threads, int smem_bytes, int global, bool backward,
              const void* scratch, long long strideS, long long strideR,
              int helpers = -1, const void* ring = nullptr,
              const void* flags = nullptr) {
  if (G != 1 && G != 2 && G != 4 && G != 8 && G != 16) return false;
  if (BC != 1 && BC != 2 && BC != 4 && BC != 8) return false;
  const int R = (N + G - 1) / G;
  if (N < 1 || B < 1 || (G - 1) * R >= N || threads % 32 != 0 ||
      threads < 32 || threads > MID_MAX_THREADS || Ke < 1 || iters < 0)
    return false;
  const bool replay = backward && store == 0 && iters > 0;
  size_t floats = backward
                      ? mid_bwd_floats(BC, N, R, iters, replay, !global)
                      : mid_fwd_floats(BC, N, R, !global);
  if (helpers >= 0) {
    if (ring == nullptr || flags == nullptr || helpers > 64) return false;
    floats = backward ? mid_split_floats(BC, N, R, iters, replay,
                                         store && iters > 0, !global)
                      : mid_fwd_split_floats(BC, N, R, !global);
  } else if (global && scratch == nullptr) {
    return false;
  }
  if ((size_t)smem_bytes < 4 * floats || smem_bytes > 227 * 1024 ||
      strideS < 0 || strideR < 0)
    return false;
  d = MidDims{E, nt, B, N, Ke, iters, mode, store, dt, a,
              G, R, (B + BC - 1) / BC, global, strideS, strideR};
  return true;
}

template <int BC>
int launch_fwd(const float* Sr, const float* Si, const float* C,
               const float* x0r, const float* x0i, const float* rows,
               float* xTr, float* xTi, float* hr, float* hi, float* ksr,
               float* ksi, float* scratch, const MidDims& d, int threads,
               int smem_bytes, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(streamk_mid_fwd<BC>, attr, d.E * d.nchunks, d.G, threads,
                     smem_bytes, stream);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, streamk_mid_fwd<BC>, Sr, Si, C, x0r, x0i, rows,
                         xTr, xTi, hr, hi, ksr, ksi, scratch, d);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The 'helpers' schedules' tiles of a pass at N
SplitDims split_dims(int N, int helpers) {
  const int tq = (N + TILE_Q - 1) / TILE_Q;
  return SplitDims{split_ldr(N), tq, ((N + TILE_P - 1) / TILE_P) * tq,
                   helpers};
}

template <int BC>
int launch_fwd_helpers(const float* Sr, const float* Si, const float* C,
                       const float* x0r, const float* x0i, const float* rows,
                       float* xTr, float* xTi, float* hr, float* hi,
                       float* ksr, float* ksi, float* ring, int* flags,
                       const MidDims& d, int helpers, int threads,
                       int smem_bytes, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(streamk_mid_fwd_helpers<BC>, attr,
                     d.E * d.nchunks * (1 + helpers), d.G, threads,
                     smem_bytes, stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, streamk_mid_fwd_helpers<BC>, Sr, Si, C, x0r, x0i, rows, xTr, xTi,
      hr, hi, ksr, ksi, ring, flags, d, split_dims(d.N, helpers));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int BC>
int launch_bwd(const float* Sr, const float* Si, const float* C,
               const float* x0r, const float* x0i, const float* hr,
               const float* hi, const float* jr, const float* ji,
               const float* gTr, const float* gTi, const float* rows,
               const float* ksr, const float* ksi, float* g0r, float* g0i,
               float* Cbp, float* scratch, const MidDims& d, int threads,
               int smem_bytes, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(streamk_mid_bwd<BC>, attr, d.E * d.nchunks, d.G, threads,
                     smem_bytes, stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, streamk_mid_bwd<BC>, Sr, Si, C, x0r, x0i, hr, hi, jr, ji, gTr,
      gTi, rows, ksr, ksi, g0r, g0i, Cbp, scratch, d);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int BC>
int launch_bwd_helpers(const float* Sr, const float* Si, const float* C,
                       const float* x0r, const float* x0i, const float* hr,
                       const float* hi, const float* jr, const float* ji,
                       const float* gTr, const float* gTi, const float* rows,
                       const float* ksr, const float* ksi, float* g0r,
                       float* g0i, float* Cbt, float* ring, int* flags,
                       const MidDims& d, int helpers, int threads,
                       int smem_bytes, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(streamk_mid_bwd_helpers<BC>, attr,
                     d.E * d.nchunks * (1 + helpers), d.G, threads,
                     smem_bytes, stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, streamk_mid_bwd_helpers<BC>, Sr, Si, C, x0r, x0i, hr, hi, jr,
      ji, gTr, gTi, rows, ksr, ksi, g0r, g0i, Cbt, ring, flags, d,
      split_dims(d.N, helpers));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int streamk_mid_fwd_launch(
    const void* Sr, const void* Si, const void* C, const void* x0r,
    const void* x0i, const void* rows, void* xTr, void* xTi, void* hr,
    void* hi, void* ksr, void* ksi, void* scratch, int E, int nt, int B,
    int N, int Ke, int iters, int mode, int store, float dt, float a, int G,
    int BC, int threads, int smem_bytes, int global, void* stream,
    long long strideS, long long strideR, int helpers, void* ring,
    void* flags) {
  MidDims d;
  if (!mid_dims(d, E, nt, B, N, Ke, iters, mode, store, dt, a, G, BC,
                threads, smem_bytes, global, false, scratch, strideS,
                strideR, helpers, ring, flags) ||
      (store && iters > 0 && ksr == nullptr))
    return (int)cudaErrorInvalidValue;
#define MID_FWD_ARGS                                                          \
  (const float*)Sr, (const float*)Si, (const float*)C, (const float*)x0r,     \
      (const float*)x0i, (const float*)rows, (float*)xTr, (float*)xTi,        \
      (float*)hr, (float*)hi, (float*)ksr, (float*)ksi
#define MID_FWD_CHAIN                                                         \
  MID_FWD_ARGS, (float*)scratch, d, threads, smem_bytes, (cudaStream_t)stream
#define MID_FWD_HELPERS                                                       \
  MID_FWD_ARGS, (float*)ring, (int*)flags, d, helpers, threads, smem_bytes,   \
      (cudaStream_t)stream
  if (helpers >= 0) {
    switch (BC) {
      case 1: return launch_fwd_helpers<1>(MID_FWD_HELPERS);
      case 2: return launch_fwd_helpers<2>(MID_FWD_HELPERS);
      case 4: return launch_fwd_helpers<4>(MID_FWD_HELPERS);
      case 8: return launch_fwd_helpers<8>(MID_FWD_HELPERS);
    }
  } else {
    switch (BC) {
      case 1: return launch_fwd<1>(MID_FWD_CHAIN);
      case 2: return launch_fwd<2>(MID_FWD_CHAIN);
      case 4: return launch_fwd<4>(MID_FWD_CHAIN);
      case 8: return launch_fwd<8>(MID_FWD_CHAIN);
    }
  }
#undef MID_FWD_HELPERS
#undef MID_FWD_CHAIN
#undef MID_FWD_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" int streamk_mid_bwd_launch(
    const void* Sr, const void* Si, const void* C, const void* x0r,
    const void* x0i, const void* hr, const void* hi, const void* jr,
    const void* ji, const void* gTr, const void* gTi, const void* rows,
    const void* ksr, const void* ksi, void* g0r, void* g0i, void* Cbp,
    void* scratch, int E, int nt, int B, int N, int Ke, int iters, int mode,
    int store, float dt, float a, int G, int BC, int threads, int smem_bytes,
    int global, void* stream, long long strideS, long long strideR,
    int helpers, void* ring, void* flags) {
  MidDims d;
  if (!mid_dims(d, E, nt, B, N, Ke, iters, mode, store, dt, a, G, BC,
                threads, smem_bytes, global, true, scratch, strideS,
                strideR, helpers, ring, flags) ||
      (store && iters > 0 && ksr == nullptr))
    return (int)cudaErrorInvalidValue;
#define MID_BWD_ARGS                                                          \
  (const float*)Sr, (const float*)Si, (const float*)C, (const float*)x0r,     \
      (const float*)x0i, (const float*)hr, (const float*)hi,                  \
      (const float*)jr, (const float*)ji, (const float*)gTr,                  \
      (const float*)gTi, (const float*)rows, (const float*)ksr,               \
      (const float*)ksi, (float*)g0r, (float*)g0i, (float*)Cbp
#define MID_BWD_CHAIN                                                         \
  MID_BWD_ARGS, (float*)scratch, d, threads, smem_bytes, (cudaStream_t)stream
#define MID_BWD_HELPERS                                                       \
  MID_BWD_ARGS, (float*)ring, (int*)flags, d, helpers, threads, smem_bytes,   \
      (cudaStream_t)stream
  if (helpers >= 0) {
    switch (BC) {
      case 1: return launch_bwd_helpers<1>(MID_BWD_HELPERS);
      case 2: return launch_bwd_helpers<2>(MID_BWD_HELPERS);
      case 4: return launch_bwd_helpers<4>(MID_BWD_HELPERS);
      case 8: return launch_bwd_helpers<8>(MID_BWD_HELPERS);
    }
  } else {
    switch (BC) {
      case 1: return launch_bwd<1>(MID_BWD_CHAIN);
      case 2: return launch_bwd<2>(MID_BWD_CHAIN);
      case 4: return launch_bwd<4>(MID_BWD_CHAIN);
      case 8: return launch_bwd<8>(MID_BWD_CHAIN);
    }
  }
#undef MID_BWD_HELPERS
#undef MID_BWD_CHAIN
#undef MID_BWD_ARGS
  return (int)cudaErrorInvalidValue;
}

// How many clusters of G CTAs of one kernel, with `threads` threads and
// smem_bytes of shared memory each, the card can hold at once (0 where it
// holds none: the launch would fail). kernel 0: the forward's chain
// schedule, instance BC; 1: the backward's chain schedule; 2: its 'helpers'
// schedule; 3: the forward's 'helpers' schedule.
extern "C" int streamk_mid_max_clusters(int kernel, int BC, int G,
                                        int threads, int smem_bytes) {
#define MID_MAX(bc)                                                           \
  case bc:                                                                    \
    switch (kernel) {                                                         \
      case 0: return max_clusters(streamk_mid_fwd<bc>, G, threads,            \
                                  smem_bytes);                                \
      case 1: return max_clusters(streamk_mid_bwd<bc>, G, threads,            \
                                  smem_bytes);                                \
      case 2: return max_clusters(streamk_mid_bwd_helpers<bc>, G, threads,    \
                                  smem_bytes);                                \
      case 3: return max_clusters(streamk_mid_fwd_helpers<bc>, G, threads,    \
                                  smem_bytes);                                \
    }                                                                         \
    return 0;
  switch (BC) {
    MID_MAX(1)
    MID_MAX(2)
    MID_MAX(4)
    MID_MAX(8)
  }
#undef MID_MAX
  return 0;
}
