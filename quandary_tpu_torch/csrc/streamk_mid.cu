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
// the per-step contraction reads Ke bands of the stacks from L2. At
// B = 256 the products dominate (67 MFLOP a stage at N = 256).

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

// Forward: x0 (B, N) shared by all candidates; C (E, nt, Ke); rows: jacobi
// (d_r, d_i, minv_r, minv_i) or split (e_r, e_i), each (N,). Writes xT
// (E, B, N), hist (E, nt, B, N) and, with store, the stage iterates
// k_0..k_{iters-1} (E, nt, iters, B, N), each CTA its band of its chunk's
// states. scratch: the global layout's row bands, mid_band_floats per CTA.
// Per step: the row band of H(t), x (rotated where split) exchanged, then
// stage j = 0..iters: the band of T of the operand, the stage update, and
// k_j exchanged for stage j + 1: iters + 1 cluster barriers.
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
  const int N = d.N, R = d.R, Ke = d.Ke, nt = d.nt, it = d.iters, G = d.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool jac = d.mode == MODE_JACOBI, split = d.mode == MODE_SPLIT;
  const MidBand g = mid_band(d, BC, (int)cl.block_rank());
  Sr += g.e * d.strideS;          // this candidate's stack and solver rows
  Si += g.e * d.strideS;
  rows += g.e * d.strideR;
  const size_t BNv = (size_t)BC * N, BN = (size_t)d.B * N;
  const int BI = BC * R;
  float* V = sm;                  // two buffers x (re, im) x BC x N
  float* X = V + 4 * BNv;         // the bands of x, b, k: re, then im at + BI
  float* Bb = X + 2 * BI;
  float* Kb = Bb + 2 * BI;
  float* rw = Kb + 2 * BI;        // solver rows, 4 x R
  float* Hr = d.global ? scratch + (size_t)blockIdx.x *
                                       mid_band_floats(N, R, false, false)
                       : rw + 4 * R;
  float* Hi = Hr + (size_t)R * N;

  const size_t nsm = mid_fwd_floats(BC, N, R, !d.global);
  for (size_t i = tid; i < nsm; i += blockDim.x) sm[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < BI; i += blockDim.x) {
    const int b = i / R, il = i - b * R;
    if (b < g.nb && il < g.nr) {
      const size_t o = (size_t)(g.b0 + b) * N + g.r0 + il;
      X[i] = x0r[o];
      X[BI + i] = x0i[o];
    }
  }
  const int nrows = jac ? 4 : split ? 2 : 0;
  for (int i = tid; i < nrows * R; i += blockDim.x) {
    const int m = i / R, il = i - m * R;
    if (il < g.nr) rw[i] = rows[m * N + g.r0 + il];
  }
  cl.sync();    // every CTA's buffers are zeroed before the first push

  // the entries this thread owns: lane b of the warp that takes row il
  auto owned = [&](auto fn) {
    for (int il = warp; il < g.nr; il += nwarps)
      if (lane < BC) fn(il, lane, lane * R + il);
  };
  auto put = [&](float* buf, int b, int il, float vr, float vi) {
    push(cl, buf + b * N + g.r0 + il, vr, G);
    push(cl, buf + BNv + b * N + g.r0 + il, vi, G);
  };
  const float* Ce = C + (size_t)g.e * nt * Ke;
  int p = 0;                      // the operand buffer the next stage reads
  for (int t = 0; t < nt; ++t) {
    __syncthreads();              // step t - 1's stages are done with H
    row_contract(Sr, Si, Ce + (size_t)t * Ke, Ke, N, g.r0, g.nr, Hr, Hi, tid,
                 blockDim.x);
    owned([&](int il, int b, int ib) {
      float xr = X[ib], xi = X[BI + ib];
      if (split) cmul(rw[il], rw[R + il], xr, xi);
      X[ib] = xr;
      X[BI + ib] = xi;
      put(V + 2 * p * BNv, b, il, xr, xi);
    });
    cl.sync();
    const size_t st = (size_t)g.e * nt + t;
    for (int j = 0; j <= it; ++j) {
      const float* Vr = V + 2 * p * BNv;
      float* Vn = V + 2 * (p ^ 1) * BNv;
      rows_dot<BC, false>(
          Hr, Hi, N, g.nr, Vr, Vr + BNv, N, warp, nwarps, lane,
          [&](int il, int b, float sr, float si) {
            const int ib = b * R + il;
            const float tr = si, ti = -sr;     // T(v) = -i H v
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
            if (j < it) {
              if (d.store && b < g.nb) {
                const size_t o = (st * it + j) * BN +
                                 (size_t)(g.b0 + b) * N + g.r0 + il;
                ksr[o] = kr;
                ksi[o] = ki;
              }
              put(Vn, b, il, kr, ki);
            }
          });
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
  owned([&](int il, int b, int ib) {
    if (b < g.nb) {
      const size_t o = ((size_t)g.e * d.B + g.b0 + b) * N + g.r0 + il;
      xTr[o] = X[ib];
      xTi[o] = X[BI + ib];
    }
  });
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

// Plain C entry points, bound from Python with ctypes. Each launches on the
// given stream a grid of E * ceil(B / BC) clusters of G CTAs and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue, launching
// nothing, for a shape the kernels do not take: G not in {1, 2, 4, 8, 16}
// or past N bands, BC not in {1, 2, 4, 8}, threads not whole warps up to
// MID_MAX_THREADS, shared memory below the layout or above 227 KB, the
// global layout without scratch, or a negative stride. strideS, strideR:
// floats between two candidates' stacks (Ke x N x N) and solver rows; 0 for
// the shared stack (the launch then reads what it read before the strides).
namespace {

// The dims of a launch, or false for a shape the kernels do not take.
bool mid_dims(MidDims& d, int E, int nt, int B, int N, int Ke, int iters,
              int mode, int store, float dt, float a, int G, int BC,
              int threads, int smem_bytes, int global, bool backward,
              const void* scratch, long long strideS, long long strideR) {
  if (G != 1 && G != 2 && G != 4 && G != 8 && G != 16) return false;
  if (BC != 1 && BC != 2 && BC != 4 && BC != 8) return false;
  const int R = (N + G - 1) / G;
  if (N < 1 || B < 1 || (G - 1) * R >= N || threads % 32 != 0 ||
      threads < 32 || threads > MID_MAX_THREADS || Ke < 1 || iters < 0)
    return false;
  const bool replay = backward && store == 0 && iters > 0;
  const size_t floats = backward
                            ? mid_bwd_floats(BC, N, R, iters, replay, !global)
                            : mid_fwd_floats(BC, N, R, !global);
  if ((size_t)smem_bytes < 4 * floats || smem_bytes > 227 * 1024 ||
      (global && scratch == nullptr) || strideS < 0 || strideR < 0)
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

}  // namespace

extern "C" int streamk_mid_fwd_launch(
    const void* Sr, const void* Si, const void* C, const void* x0r,
    const void* x0i, const void* rows, void* xTr, void* xTi, void* hr,
    void* hi, void* ksr, void* ksi, void* scratch, int E, int nt, int B,
    int N, int Ke, int iters, int mode, int store, float dt, float a, int G,
    int BC, int threads, int smem_bytes, int global, void* stream,
    long long strideS, long long strideR) {
  MidDims d;
  if (!mid_dims(d, E, nt, B, N, Ke, iters, mode, store, dt, a, G, BC,
                threads, smem_bytes, global, false, scratch, strideS,
                strideR) ||
      (store && iters > 0 && ksr == nullptr))
    return (int)cudaErrorInvalidValue;
#define MID_FWD_ARGS                                                          \
  (const float*)Sr, (const float*)Si, (const float*)C, (const float*)x0r,     \
      (const float*)x0i, (const float*)rows, (float*)xTr, (float*)xTi,        \
      (float*)hr, (float*)hi, (float*)ksr, (float*)ksi, (float*)scratch, d,   \
      threads, smem_bytes, (cudaStream_t)stream
  switch (BC) {
    case 1: return launch_fwd<1>(MID_FWD_ARGS);
    case 2: return launch_fwd<2>(MID_FWD_ARGS);
    case 4: return launch_fwd<4>(MID_FWD_ARGS);
    case 8: return launch_fwd<8>(MID_FWD_ARGS);
  }
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
    int global, void* stream, long long strideS, long long strideR) {
  MidDims d;
  if (!mid_dims(d, E, nt, B, N, Ke, iters, mode, store, dt, a, G, BC,
                threads, smem_bytes, global, true, scratch, strideS,
                strideR) ||
      (store && iters > 0 && ksr == nullptr))
    return (int)cudaErrorInvalidValue;
#define MID_BWD_ARGS                                                          \
  (const float*)Sr, (const float*)Si, (const float*)C, (const float*)x0r,     \
      (const float*)x0i, (const float*)hr, (const float*)hi,                  \
      (const float*)jr, (const float*)ji, (const float*)gTr,                  \
      (const float*)gTi, (const float*)rows, (const float*)ksr,               \
      (const float*)ksi, (float*)g0r, (float*)g0i, (float*)Cbp,               \
      (float*)scratch, d, threads, smem_bytes, (cudaStream_t)stream
  switch (BC) {
    case 1: return launch_bwd<1>(MID_BWD_ARGS);
    case 2: return launch_bwd<2>(MID_BWD_ARGS);
    case 4: return launch_bwd<4>(MID_BWD_ARGS);
    case 8: return launch_bwd<8>(MID_BWD_ARGS);
  }
#undef MID_BWD_ARGS
  return (int)cudaErrorInvalidValue;
}

// How many clusters of G CTAs of the forward (backward != 0: the backward)
// instance BC, with `threads` threads and smem_bytes of shared memory each,
// the card can hold at once; 0 where it holds none (the launch would fail).
extern "C" int streamk_mid_max_clusters(int backward, int BC, int G,
                                        int threads, int smem_bytes) {
#define MID_MAX(bc)                                                           \
  case bc:                                                                    \
    return backward                                                           \
               ? max_clusters(streamk_mid_bwd<bc>, G, threads, smem_bytes)    \
               : max_clusters(streamk_mid_fwd<bc>, G, threads, smem_bytes);
  switch (BC) {
    MID_MAX(1)
    MID_MAX(2)
    MID_MAX(4)
    MID_MAX(8)
  }
#undef MID_MAX
  return 0;
}
