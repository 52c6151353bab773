// Streamed-plane propagation past one thread block, for Hopper (sm_90a): the
// whole IMR time loop of dv/dt = -i H(t) v in ONE launch per direction, with
// the per-step planes H(t) built outside the kernel and read from device
// memory, for candidates that one block of stream.cu cannot hold (B*N past
// 1024 threads, or the inline layout past 227 KB of shared memory).
//
// Replaces the rest of the range of three TPU kernels of one family, as
// stream.cu does below one block:
//   * stream_mid_fwd / stream_mid_bwd: quandary_tpu/ops/pallas_stream.py::
//     make_stream_propagate (:490; forward pallas_call :613, backward :657),
//     neumann, jacobi and split, stage iterates stored or replayed, the step
//     core _stage_fwd :217 / _stage_bwd :331 inlined;
//   * chunk_mid_fwd / chunk_mid_bwd: ops/pallas_adjoint.py::
//     make_pallas_propagate (:167; pallas_calls :202 / :211), plain Neumann,
//     the backward always replays;
//   * dense_mid_fwd: ops/pallas_kernels.py::pallas_propagate_dense (:76;
//     pallas_call :111), the Neumann forward without history, xT only.
// The entry points hold each member to its contract and run the same two
// __global__ functions; HIST drops the history writes. For split the planes
// carry the off-diagonal remainder (the caller subtracts diag(h)); the
// kernel applies the rotations E = exp((dt/2) d). H is never assumed
// Hermitian (the open superop route streams H' = iL).
//
// Layout, as streamk_mid.cu's: a thread-block cluster of G CTAs (1, 2, 4, 8
// or 16) per (control candidate, chunk of BC basis states); clusters never
// wait on each other and run in waves. CTA q owns the entries [q R, q R + R)
// of every state vector (R = ceil(N / G), the last band ragged). Every stage
// product needs the whole operand: each CTA computes its band of the result
// and pushes it into every CTA's copy through distributed shared memory.
// The backward ends each exchange with a cluster barrier; the forward
// pushes by st.async and waits on an mbarrier at CTA scope, with no cluster
// barrier in its time loop (see stream_mid_fwd).
//   forward: the CTA reads its ROW band of H(t) (R x N of each plane) and
//     computes its band of T(v) = -i H v for each stage;
//   backward: it reads its COLUMN band of H(t), transposed (R x (N + 1)),
//     and computes its band of the real transpose Tt(c) for each transposed
//     stage; a backward that replays the stage iterates (store 0, and always
//     for chunk) reads the row band too. The step's (cotangent, input) pairs
//     stay in shared memory, the cotangents whole (they were exchanged), the
//     inputs by band, and one pass over the column band's entries writes
//     Hb(t)[:, band] = sum over pairs c u^T straight to device memory. The
//     backward's grid holds `tracks` clusters per candidate (1 to the
//     number of chunks of states): the cluster of track l runs the chunks
//     l, l + tracks, ... in turn into one partial Hb, the first writing it
//     and the others adding to it; with more than one track the wrapper
//     sums the partials in a fixed order. Each entry of a partial has one
//     writer, so no float atomics: two launches give the same bits.
// Where the bands fit shared memory they are copied there: "smem2" two
// slots, the next step's band streamed in while the step runs; "smem1" one
// slot (the forward: the rows that fit a second slot copied a step ahead,
// the others refilled in place as the step's last stage has read them; the
// backward: copied at the step's start). Otherwise ("global") the forward
// keeps the band rows that fit in shared memory (refilled in place) and
// reads the rest straight from the plane array (contiguous rows, served by
// L2), and the backward transposes its column band into a per-CTA scratch
// in device memory at the step's start. The wrapper picks the layout, G,
// BC and the forward's band rows (ops/stream.py::_mid_shape).
// Mapping (mid_cluster.cuh's rows_dot, as streamk_mid.cu's): the warps of a
// CTA take the band's rows in turn, the lanes stride the contraction index,
// each lane holds the partial sums of all BC states, a butterfly of
// shuffles gives every lane the row's sums, and lane b owns entry (b, row):
// it runs the elementwise stage update and writes history and stored
// iterates. The backward's lane b pushes the entry too; the forward
// (rows_dot_all, its operand's re and im side by side) spreads the row's
// pushes over the lanes. The
// forward and the backward's replay run the same products in the same
// order on the same row band, and the same updates, so stored and replayed
// iterates are equal in bits. Exact f32 FMA on the CUDA cores; no tensor
// cores.
//
// What bounds it on the H100: bytes, as a bound. The forward reads the
// plane pair once, 2 x nt x N^2 x 4 bytes per candidate (1 GB at N = 512,
// 1000 steps: 0.63 ms at 3.35 TB/s); the backward reads it again (and the
// row band once more on a replay) and writes as many bytes of Hb. In
// practice the dependent chain sets the time: iters + 1 stage products a
// step (backward: up to 2 iters + 1), each ended by an exchange. The design
// keeps the band reads off that chain where it can: in smem2 the next
// step's band arrives during the current step, and the forward's smem1 and
// global rows arrive while the step's last stage and the next exchange
// run.

#include <stdint.h>

#include <algorithm>

#include "mid_cluster.cuh"

namespace {

constexpr int SM_MAX_THREADS = 512;

// slots: bands of H in shared memory (2 or 1 slots), or 0 (global layout).
// The forward's band instead: `ahead` rows in two slots, `inplace` in one,
// the rest in L2; bulk: its rows copied by the bulk-copy engine (N % 4 == 0
// and 16-byte aligned planes), else by cp.async.
struct SMDims {
  int E, nt, B, N, iters, mode, store;
  float dt, a;
  int G, R, nchunks, slots, tracks;
  int ahead, inplace, bulk;
};

__host__ __device__ inline size_t pad4(size_t n) {
  return (n + 3) & ~(size_t)3;
}

// Floats of one slot of a CTA's bands of H, each plane padded to 16 bytes:
// the forward's row band (R x N, re and im); the backward's column band
// transposed (R x (N + 1)) and, with replay, its row band.
__host__ __device__ inline size_t sm_band_floats(int N, int R, bool backward,
                                                 bool replay) {
  const size_t row = pad4((size_t)R * N), col = pad4((size_t)R * (N + 1));
  return backward ? 2 * col + (replay ? 2 * row : 0) : 2 * row;
}

// The forward's mbarriers (two of the exchange, one a warp's band, up to 16
// warps) in the first SM_FWD_HEAD floats of its shared memory.
constexpr int SM_FWD_HEAD = 40;

// Floats of the forward's shared memory: the mbarriers, 2 ahead + inplace
// band rows (re N, im N each), two operand buffers BC x N of (re, im)
// pairs, the bands of x, b and k (re, im) x BC x R and the solver rows
// 4 x R.
__host__ __device__ inline size_t sm_fwd_floats(int BC, int N, int R,
                                                int ahead, int inplace) {
  return SM_FWD_HEAD + (2 * (size_t)ahead + inplace) * 2 * N +
         4 * (size_t)BC * N + 6 * (size_t)BC * R + 4 * (size_t)R;
}

// Floats of the backward's shared memory: `slots` band slots, the it + 1
// whole cotangents of the step's pairs, with replay two operand buffers,
// the it + 1 band inputs, the bands of g, kb, bb (with replay also b, k)
// and the solver rows.
__host__ __device__ inline size_t sm_bwd_floats(int BC, int N, int R, int it,
                                                bool replay, int slots) {
  const size_t BNv = (size_t)BC * N, BR = (size_t)BC * R;
  return slots * sm_band_floats(N, R, true, replay) +
         2 * (size_t)(it + 1) * BNv + (replay ? 4 * BNv : 0) +
         2 * (size_t)(it + 1) * BR + (replay ? 10 : 6) * BR + 4 * (size_t)R;
}

// This CTA's part of the grid: candidate e, chunk c of basis states
// [b0, b0 + nb), band of entries [r0, r0 + nr). The grid holds d.tracks
// clusters per candidate; the cluster of track l takes the chunks l,
// l + tracks, ... in turn (the forward: one chunk each, tracks = nchunks).
struct SMBand {
  int e, c, r0, nr, b0, nb;
};

__device__ __forceinline__ SMBand sm_chunk(SMBand g, const SMDims& d, int BC,
                                           int c) {
  g.c = c;
  g.b0 = c * BC;
  g.nb = min(BC, d.B - g.b0);
  return g;
}

// the band of this CTA at its track's first chunk
__device__ __forceinline__ SMBand sm_band(const SMDims& d, int BC, int rank) {
  SMBand g;
  const int cid = blockIdx.x / d.G;
  g.e = cid / d.tracks;
  g.r0 = rank * d.R;
  g.nr = min(d.R, d.N - g.r0);
  return sm_chunk(g, d, BC, cid - g.e * d.tracks);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most `n` of the thread's newest copy groups are pending
template <int n>
__device__ __forceinline__ void cp_wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

// n contiguous floats from device memory into shared memory by the CTA's
// threads, 16 bytes a copy where both ends are aligned to 16 bytes.
__device__ __forceinline__ void copy_run(float* dst, const float* src, int n) {
  const int tid = threadIdx.x, nth = blockDim.x;
  int i0 = 0;
  if ((((uintptr_t)src | (uintptr_t)dst) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = tid; i < n4; i += nth) cp_async16(dst + 4 * i, src + 4 * i);
    i0 = 4 * n4;
  }
  for (int i = i0 + tid; i < n; i += nth) cp_async4(dst + i, src + i);
}

// The first plane of step t of candidate e, at row r0.
__device__ __forceinline__ const float* plane_rows(const float* gH,
                                                   const SMDims& d, int e,
                                                   int t, int r0) {
  return gH + ((size_t)e * d.nt + t) * d.N * d.N + (size_t)r0 * d.N;
}

}  // namespace

// Forward: planes H (E, nt, N, N) x2; x0 (B, N) shared by all candidates;
// rows: jacobi (d_r, d_i, minv_r, minv_i) or split (e_r, e_i), each (N,).
// Writes xT (E, B, N), with HIST the history (E, nt, B, N) and, with store,
// the stage iterates k_0..k_{iters-1} (E, nt, iters, B, N), each CTA its
// band of its chunk's states.
//
// One chain of exchanges, no cluster barrier in the time loop. Exchange 0
// is x0 (rotated where split); the stage that reads exchange e makes
// exchange e + 1: k_j for stages j < iters, and at the step's last stage
// (j = iters, whose k is not exchanged) the next step's x, rotated where
// split. A step runs 1 + iters stages and the launch nt (1 + iters)
// exchanges, whatever the parity of 1 + iters. Exchange e goes into the
// operand buffer e & 1 and completes phase e >> 1 of that buffer's
// mbarrier: a warp's lanes push the row's entries of every state, lane l the
// (state, CTA) pairs l, l + 32, ..., by st.async of (re, im) into the other
// CTAs' buffers (8 bytes counted on the destination's mbarrier) and a
// local store into its own; each warp then arrives on its CTA's mbarrier
// (the arrival of warp 0's lane 0 expecting the bytes the other CTAs push,
// (N - nr) nb x 8) and every thread waits for the phase at CTA scope.
// Why a buffer is not rewritten before every CTA has read it: CTA X writes
// exchange e + 2 (buffer e & 1) only in the stage that reads exchange e + 1,
// so after its wait for e + 1, which needs every byte of e + 1 from every
// other CTA Y. Each warp of Y pushes its rows' entries of e + 1 after its
// products of those rows, the last of its reads of exchange e; so all of
// Y's warps are done with buffer e & 1, and they waited for phase e before,
// so X's bytes of e + 2 count on the phase after (they may land before Y's
// expect_tx: the phase cannot complete before Y's warps arrive). X's own
// warps arrived on e + 1 after their reads of e. ops/stream.py
// mid_fwd_exchanges is the Python twin of the sequence
// (tests/test_torch_stream_mid.py checks it on a model of the cluster).
//
// The row band of H(t): rows [0, ahead) have two slots (A and P, by the
// step's parity) and are copied a step ahead, rows [ahead, ahead + inplace)
// one (A), refilled for step t + 1 as soon as step t's last stage has read
// them, the rest read from the plane array (L2). smem2: ahead = R; smem1:
// the ahead rows that fit beside one slot, the rest in place; global:
// inplace = the rows that fit, none where the launch's CTAs exceed one a
// SM. A row is read only by the warp that owns it (rows_dot_all's mapping),
// so each warp copies its own rows, counted on its own mbarrier (a phase a
// step): by the bulk-copy engine where rows are 16-byte aligned, else by
// cp.async with an arrival once they land.
//
// MINB: the CTAs an SM must hold at once. 1 (up to 128 registers a
// thread) unless the launch's clusters are more than the card holds of
// that instance and two CTAs fit an SM's shared memory: then 2 (at most
// 64), so that the card packs them two CTAs an SM (fwd_min_blocks).
template <int BC, bool HIST, int MINB>
__global__ void __launch_bounds__(SM_MAX_THREADS, MINB)
stream_mid_fwd(const float* __restrict__ gHr, const float* __restrict__ gHi,
               const float* __restrict__ x0r, const float* __restrict__ x0i,
               const float* __restrict__ rows, float* __restrict__ xTr,
               float* __restrict__ xTi, float* __restrict__ hr,
               float* __restrict__ hi, float* __restrict__ ksr,
               float* __restrict__ ksi, SMDims d) {
  extern __shared__ __align__(16) float sm[];
  const cg::cluster_group cl = cg::this_cluster();
  const int N = d.N, R = d.R, nt = d.nt, it = d.iters, G = d.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool jac = d.mode == MODE_JACOBI, split = d.mode == MODE_SPLIT;
  const int rank = (int)cl.block_rank();
  const SMBand g = sm_band(d, BC, rank);
  const size_t BN = (size_t)d.B * N;
  const int BI = BC * R, nA = d.ahead, nS = d.ahead + d.inplace;
  // mbarriers: the exchange's two, then one a warp for its band rows
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm);
  float* A = sm + SM_FWD_HEAD;             // nS band rows: re N, im N each
  float* P = A + (size_t)nS * 2 * N;       // the second slot of the ahead rows
  float2* V = reinterpret_cast<float2*>(P + (size_t)nA * 2 * N);
  float* X = reinterpret_cast<float*>(V + 2 * (size_t)BC * N);
  float* Bb = X + 2 * BI;                  // the bands of x, b, k: re, im
  float* Kb = Bb + 2 * BI;
  float* rw = Kb + 2 * BI;                 // solver rows, 4 x R

  const size_t nsm = sm_fwd_floats(BC, N, R, d.ahead, d.inplace);
  for (size_t i = (float*)V - sm + tid; i < nsm; i += blockDim.x) sm[i] = 0.f;
  if (tid == 0) {
    mb_init(smem_addr(bars), nwarps);
    mb_init(smem_addr(bars + 1), nwarps);
    for (int w = 0; w < nwarps; ++w) mb_init(smem_addr(bars + 2 + w), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
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
  cl.sync();    // every CTA's mbarriers and zeroed buffers exist

  // the band: row il of step t, where it lies, and its copy into its slot
  auto slot = [&](int il, int t) {
    return (il < nA && (t & 1) ? P : A) + (size_t)il * 2 * N;
  };
  auto band_row = [&](int t, int il, const float*& mr, const float*& mi) {
    if (il < nS) {
      mr = slot(il, t);
      mi = mr + N;
    } else {
      mr = plane_rows(gHr, d, g.e, t, g.r0 + il);
      mi = plane_rows(gHi, d, g.e, t, g.r0 + il);
    }
  };
  const unsigned wbar = smem_addr(bars + 2 + warp);
  auto copy_row = [&](int il, int t) {
    float* s = slot(il, t);
    const float* gr = plane_rows(gHr, d, g.e, t, g.r0 + il);
    const float* gi = plane_rows(gHi, d, g.e, t, g.r0 + il);
    if (d.bulk) {
      if (lane == 0) {
        bulk_g2s(smem_addr(s), gr, 4 * N, wbar);
        bulk_g2s(smem_addr(s + N), gi, 4 * N, wbar);
      }
    } else {
      for (int j = lane; j < N; j += 32) {
        cp_async4(s + j, gr + j);
        cp_async4(s + N + j, gi + j);
      }
    }
  };
  int wrows = 0;                // this warp's rows in shared memory
  for (int il = warp; il < min(g.nr, nS); il += nwarps) ++wrows;
  // the warp's arrival on its band mbarrier for a step: on the bulk path
  // before its copies, expecting all their bytes; on cp.async after them,
  // each lane's copies arriving as they land
  auto band_arrive = [&](bool before) {
    if (before != (d.bulk != 0)) return;
    if (!d.bulk) cp_async_arrive(wbar);
    __syncwarp();
    if (lane == 0) mb_arrive(wbar, d.bulk ? 8u * N * wrows : 0u);
  };

  // the exchange: push_row puts a row's entries of every state into
  // exchange e; wait_exchange waits for the whole of it
  const unsigned tx = 8u * (N - g.nr) * g.nb;
  const int per = 32 / G, q = lane & (G - 1), bq = lane / G;
  auto push_row = [&](int e, int il, const float (&vr)[BC],
                      const float (&vi)[BC]) {
    float2* buf = V + (size_t)(e & 1) * BC * N + g.r0 + il;
    const unsigned bar = smem_addr(bars + (e & 1));
    for (int b0 = 0; b0 < g.nb; b0 += per) {
      const int b = b0 + bq;
      if (b >= g.nb) break;
      float pr = vr[0], pi = vi[0];
#pragma unroll
      for (int c = 1; c < BC; ++c)
        if (b == c) {
          pr = vr[c];
          pi = vi[c];
        }
      float2* dst = buf + (size_t)b * N;
      if (q == rank)
        *dst = make_float2(pr, pi);
      else
        st_async2(rank_addr(smem_addr(dst), q), pr, pi, rank_addr(bar, q));
    }
  };
  auto wait_exchange = [&](int e) {
    const unsigned bar = smem_addr(bars + (e & 1));
    __syncwarp();
    if (lane == 0) mb_arrive(bar, warp == 0 ? tx : 0u);
    mb_wait(bar, (e >> 1) & 1);
  };

  // every lane: the row's entries of every state in X (the bands of x)
  // into exchange e
  auto push_x = [&](int e, int il) {
    float xr[BC], xi[BC];
#pragma unroll
    for (int b = 0; b < BC; ++b) {
      xr[b] = X[b * R + il];
      xi[b] = X[BI + b * R + il];
    }
    push_row(e, il, xr, xi);
  };
  // lane b < BC: its entry of the row rotated where split, as the step
  // starts
  auto rotate_x = [&](int il) {
    if (lane < BC) {
      const int ib = lane * R + il;
      float xr = X[ib], xi = X[BI + ib];
      if (split) cmul(rw[il], rw[R + il], xr, xi);
      X[ib] = xr;
      X[BI + ib] = xi;
    }
    __syncwarp();
  };

  // a warp's rows two at a time (each operand entry loaded once for both)
  // where it owns two or more, one state a cluster
  const bool pairs = BC == 1 && R >= 2 * nwarps;
  int e = 0;                    // the exchange the next stage reads
  if (nt > 0) {                 // step 0's band rows; x0 into exchange 0
    band_arrive(true);
    for (int il = warp; il < min(g.nr, nS); il += nwarps) copy_row(il, 0);
    band_arrive(false);
    for (int il = warp; il < g.nr; il += nwarps) {
      rotate_x(il);
      push_x(0, il);
    }
    wait_exchange(0);
  }
  for (int t = 0; t < nt; ++t) {
    mb_wait(wbar, t & 1);       // the warp's rows of H(t) have landed
    const bool more = t + 1 < nt;
    if (more) {                 // its ahead rows of H(t + 1), into the
      band_arrive(true);        // other slot
      for (int il = warp; il < min(g.nr, nA); il += nwarps)
        copy_row(il, t + 1);
    }
    const size_t st = (size_t)g.e * nt + t;
    for (int j = 0; j <= it; ++j) {
      const bool last = j == it;
      auto row = [&](int il, const float*& mr, const float*& mi) {
        band_row(t, il, mr, mi);
      };
      auto update = [&](int il, int b, float sr, float si) {  // lane b
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
        if (!last && d.store && b < g.nb) {
          const size_t o = (st * it + j) * BN + (size_t)(g.b0 + b) * N +
                           g.r0 + il;
          ksr[o] = kr;
          ksi[o] = ki;
        }
      };
      auto finish = [&](int il) {  // every lane
        if (!last) {                // k_j into the next exchange
          float kr[BC], ki[BC];
#pragma unroll
          for (int b = 0; b < BC; ++b) {
            kr[b] = Kb[b * R + il];
            ki[b] = Kb[BI + b * R + il];
          }
          push_row(e + 1, il, kr, ki);
          return;
        }
        // the step's end: x + dt k (rotated where split), its
        // history, and the next step's x (rotated again) into the next
        // exchange; then, in place, this row's band for the next step
        if (lane < BC) {
          const int ib = lane * R + il;
          float xr = X[ib] + d.dt * Kb[ib];
          float xi = X[BI + ib] + d.dt * Kb[BI + ib];
          if (split) cmul(rw[il], rw[R + il], xr, xi);
          X[ib] = xr;
          X[BI + ib] = xi;
          if (HIST && lane < g.nb) {
            const size_t o = st * BN + (size_t)(g.b0 + lane) * N +
                             g.r0 + il;
            hr[o] = xr;
            hi[o] = xi;
          }
        }
        if (more) {
          rotate_x(il);
          push_x(e + 1, il);
          if (il >= nA && il < nS) copy_row(il, t + 1);
        }
      };
      const float2* Ve = V + (size_t)(e & 1) * BC * N;
      if (pairs)
        rows_dot_all<BC, 2>(row, g.nr, Ve, N, warp, nwarps, lane,
                            update, finish);
      else
        rows_dot_all<BC, 1>(row, g.nr, Ve, N, warp, nwarps, lane,
                            update, finish);
      if (last && more) band_arrive(false);
      if (!last || more) wait_exchange(++e);
    }
  }
  for (int il = warp; il < g.nr; il += nwarps)
    if (lane < g.nb) {
      const size_t o = ((size_t)g.e * d.B + g.b0 + lane) * N + g.r0 + il;
      xTr[o] = X[lane * R + il];
      xTi[o] = X[BI + lane * R + il];
    }
  cl.sync();    // no CTA leaves while another may still address it
}

// Backward: the steps in reverse. Inputs as the forward's plus the history
// (E, nt, B, N), its cotangent j (E, nt, B, N), the final-state cotangent
// gT (E, B, N) and, with store, the forward's stage iterates. Writes the x0
// cotangent per candidate g0 (E, B, N), each CTA its band, and the plane
// cotangents Hb (E, tracks, nt, N, N) x2, each CTA the column band of its
// track's, the sum over the track's chunks. scratch: the global layout's
// column bands, per CTA. Per chunk, per step:
// the bands of H(t) in place; the operands (g += j, the pre-state xp;
// split: both rotated), with replay the stage iterates again from the
// exchanged xp on the row band (iters barriers), then the transposed chain
// on the column band, each of its iters + 1 cotangents exchanged whole
// (iters + 1 barriers), then the pass that writes Hb(t)'s column band, and
// one barrier before the next step's pushes into the cotangent slots the
// other CTAs' passes read.
template <int BC>
__global__ void __launch_bounds__(SM_MAX_THREADS)
stream_mid_bwd(const float* __restrict__ gHr, const float* __restrict__ gHi,
               const float* __restrict__ x0r, const float* __restrict__ x0i,
               const float* __restrict__ hr, const float* __restrict__ hi,
               const float* __restrict__ jr, const float* __restrict__ ji,
               const float* __restrict__ gTr, const float* __restrict__ gTi,
               const float* __restrict__ rows, const float* __restrict__ ksr,
               const float* __restrict__ ksi, float* __restrict__ g0r,
               float* __restrict__ g0i, float* __restrict__ Hbr,
               float* __restrict__ Hbi, float* __restrict__ scratch,
               SMDims d) {
  extern __shared__ __align__(16) float sm[];
  const cg::cluster_group cl = cg::this_cluster();
  const int N = d.N, R = d.R, nt = d.nt, it = d.iters, G = d.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool jac = d.mode == MODE_JACOBI, split = d.mode == MODE_SPLIT;
  const bool replay = d.store == 0 && it > 0;
  // the track's chunks in turn, each through the whole time loop; the
  // first writes its Hb band, the others add to it (the same thread
  // each time, so in a fixed order)
  const SMBand gl = sm_band(d, BC, (int)cl.block_rank());
  for (int ch = gl.c; ch < d.nchunks; ch += d.tracks) {
    const SMBand g = sm_chunk(gl, d, BC, ch);
    const bool first = ch == gl.c;
    const size_t BNv = (size_t)BC * N, BN = (size_t)d.B * N, NN = (size_t)N * N;
    const int BI = BC * R, ld = N + 1;
    const size_t bandf = sm_band_floats(N, R, true, replay);
    const size_t colp = pad4((size_t)R * ld), rowp = pad4((size_t)R * N);
    float* Hs = sm;                           // slots x (HT re, im[, row band])
    float* Cs = Hs + d.slots * bandf;         // it + 1 whole cotangents
    float* V = Cs + 2 * (size_t)(it + 1) * BNv;   // replay: two buffers
    float* U = V + (replay ? 4 * BNv : 0);    // it + 1 band inputs
    float* Gb = U + 2 * (it + 1) * BI;        // the bands of g, kb, bb
    float* KB = Gb + 2 * BI;
    float* BB = KB + 2 * BI;
    float* Bb = BB + 2 * BI;                  // replay: the bands of b, k
    float* Kb = Bb + 2 * BI;
    float* rw = BB + 2 * BI + (replay ? 4 * BI : 0);    // solver rows, 4 x R

    const size_t nsm = sm_bwd_floats(BC, N, R, it, replay, d.slots);
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
    // the column band of H(t) transposed (HT[ql][pp] = H[pp][r0 + ql]) and,
    // with replay, its row band: in the slot of step t, or in the global
    // layout the column band into this CTA's scratch (the row band is read
    // in place)
    float* const scr = scratch + (size_t)blockIdx.x * 2 * colp;
    auto slot = [&](int t) {
      return d.slots == 0 ? scr : Hs + (d.slots > 1 ? (t & 1) : 0) * bandf;
    };
    auto fetch = [&](int t) {
      float* HT = slot(t);
      const float* sr = plane_rows(gHr, d, g.e, t, 0) + g.r0;
      const float* si = plane_rows(gHi, d, g.e, t, 0) + g.r0;
      const int n = N * g.nr;
      if (d.slots == 0) {
        for (int idx = tid; idx < n; idx += blockDim.x) {
          const int pp = idx / g.nr, ql = idx - pp * g.nr;
          HT[ql * ld + pp] = sr[(size_t)pp * N + ql];
          HT[colp + ql * ld + pp] = si[(size_t)pp * N + ql];
        }
        return;
      }
      for (int idx = tid; idx < n; idx += blockDim.x) {
        const int pp = idx / g.nr, ql = idx - pp * g.nr;
        cp_async4(HT + ql * ld + pp, sr + (size_t)pp * N + ql);
        cp_async4(HT + colp + ql * ld + pp, si + (size_t)pp * N + ql);
      }
      if (replay) {
        copy_run(HT + 2 * colp, plane_rows(gHr, d, g.e, t, g.r0), g.nr * N);
        copy_run(HT + 2 * colp + rowp, plane_rows(gHi, d, g.e, t, g.r0),
                 g.nr * N);
      }
      cp_commit();
    };
    if (d.slots == 2 && nt > 0) fetch(nt - 1);
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
      // the bands of H(t); the previous step's chain is done with the slot
      // (the cluster barrier that ended it)
      if (d.slots == 2) {
        if (t > 0) {                // H(t - 1) into the slot step t + 1 read
          fetch(t - 1);
          cp_wait_group<1>();
        } else {
          cp_wait_group<0>();
        }
      } else {
        fetch(t);
        cp_wait_group<0>();
      }
      __syncthreads();              // H(t)'s bands are in place
      float* HTr = slot(t);
      float* HTi = HTr + colp;
      const float* Rr = d.slots == 0 ? plane_rows(gHr, d, g.e, t, g.r0)
                                     : HTr + 2 * colp;
      const float* Ri = d.slots == 0 ? plane_rows(gHi, d, g.e, t, g.r0)
                                     : HTr + 2 * colp + rowp;
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
              Rr, Ri, N, g.nr, Vr, Vr + BNv, N, warp, nwarps, lane,
              [&](int il, int b, float sr, float si) {
                const int ib = b * R + il;
                const float tr = si, ti = -sr;
                float kr = Kb[ib], ki = Kb[BI + ib];
                if (j == 0) {
                  Bb[ib] = tr;
                  Bb[BI + ib] = ti;
                  mid_first(jac, rw, R, il, tr, ti, kr, ki);
                } else {
                  mid_next(jac, d.a, rw, R, il, Bb[ib], Bb[BI + ib], tr, ti,
                            kr, ki);
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
            HTr, HTi, ld, g.nr, cq, cq + BNv, N, warp, nwarps, lane,
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
      __syncthreads();    // every pair's band input is written
      // Hb(t)[pp, r0 + ql] = sum over the pairs and the chunk's states of
      // c[b][pp] (x) u[b][ql], one chain per output in pair and state order
      {
        const size_t ho = (((size_t)g.e * d.tracks + gl.c) * nt + t) * NN;
        const int n = N * g.nr;
        for (int idx = tid; idx < n; idx += blockDim.x) {
          const int pp = idx / g.nr, ql = idx - pp * g.nr;
          float hbr = 0.f, hbi = 0.f;
          for (int pr = 0; pr <= it; ++pr) {
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
          const size_t o = ho + (size_t)pp * N + g.r0 + ql;
          Hbr[o] = first ? hbr : Hbr[o] + hbr;
          Hbi[o] = first ? hbi : Hbi[o] + hbi;
        }
      }
      cl.sync();    // every CTA's pass has read the cotangent slots
    }
    owned([&](int il, int b, int ib) {
      if (b < g.nb) {
        const size_t o = ((size_t)g.e * d.B + g.b0 + b) * N + g.r0 + il;
        g0r[o] = Gb[ib];
        g0i[o] = Gb[BI + ib];
      }
    });
  }
}

// ---------------------------------------------------------------------------
// The backward's 'helpers' schedule: the replay, the plane-cotangent pass
// and the column band's transposition off the chain. Above, 'chain': each
// step of a cluster replays its stage iterates (where they are not
// stored), copies its column band of H(t) in transposed with 4-byte copies
// (or, in the global layout, transposes it into scratch), runs the
// transposed chain and then the pass that writes Hb(t)'s column band, all
// on its one dependent chain. Here the chain clusters run only the step's
// operand loads and the transposed chain with its exchanges; the rest runs
// beside them on clusters the launch adds where the card would leave SMs
// idle (ops/stream.py::mid_bwd_schedule).
//
// A group is one chain cluster (candidate, track of chunks) with its replay
// cluster (replayed iterates) and its helper clusters. The group runs a
// sequence of S steps: its track's chunks in turn, each the nt steps in
// reverse (step s: chunk l + tracks (s / nt), time step nt - 1 - s % nt).
// Its hand-off memory (ring, help_ring_floats floats):
//   the H^T ring, 2 slots, each H(t)^T (N rows of ldr floats, row q the
//     column q of H; re, then im);
//   the pairs ring, 2 slots, each the step's it + 1 (cotangent, input)
//     pairs, whole vectors: pair q at 4 q BC N, cotangent (re, im), then
//     input (re, im), each BC x N;
//   with replay the iterate ring, HELP_W slots, each a step's k_0..k_{it-1}
//     (re, im), each BC x N.
// The pass is cut in tiles of HTILE_P rows (pp) x HTILE_Q columns (q) of
// the whole matrix. Pass i (0 <= i < S + 2) copies H of step i (i < S)
// transposed into H^T slot i & 1 and writes Hb of step i - 2 (i >= 2) from
// pairs slot i & 1, the first chunk of the track writing it, the others
// adding to it (after pass i - nt, the previous chunk's). Chain step s
// waits for pass s (its H^T, and Hb of step s - 2, which read the pairs
// slot it writes), reads its column band of H^T (copied into shared memory
// by 16-byte copies, or in the global layout in place from L2), and
// publishes its pairs; pass i starts once step i - 2's pairs are
// published, after which the chain does not read H^T slot i & 1. The
// replay cluster runs step s's stage chain from the pre-state on the row
// band of H(t) (the chain schedule's products in the same order) into
// iterate slot s % HELP_W once the chain emptied step s - HELP_W.
// flags (ints, zeroed by the wrapper): a ticket counter, then per group a
// claim word, the iterate slots' full and empty counts, and the tiles
// claimed, the tiles done and the chain CTAs that published each step's
// pairs (S + 2 each). A cluster takes group and role by ticket in the order
// it starts: ticket (nrep + 1 + helpers) m is group m's replay (with
// replay), the next its chain, the next `helpers` its helpers, so a chain
// waits only on a replay that started before it and a helper on a chain.
// The replay's wait on the chain: at step HELP_W, if the chain has not
// claimed the group (the card holds too few clusters), the replay writes
// HELP_W + 1 into the claim word and ends, and the chain replays the steps
// from HELP_W on in its own chain (the claim word says from which). Tiles
// are claimed by an atomic counter, by the helpers and, while its pass is
// not done, by the chain's CTAs themselves. So no cluster waits on one that
// has not started, and a tile's result does not depend on which CTA ran it.
// Numerics: g0 and the iterates are the chain schedule's products in the
// same order on the same values of H; each entry of Hb is its fmaf chain in
// pair then state order: the chain schedule's bits with any number of
// helper clusters (none included) and with or without the hand-over.
// ---------------------------------------------------------------------------
namespace {

constexpr int HTILE_P = 32;     // rows pp of a pass tile
constexpr int HTILE_Q = 64;     // columns q of a pass tile
constexpr int HTILE_LD = HTILE_P + 1;   // row stride of a staged tile
constexpr int HELP_W = 4;       // slots of the iterate ring
constexpr int CLAIMED = 1 << 30;

struct SMHelp {
  int helpers;    // helper clusters per group
  int nrep;       // replay clusters per group: 1 with replay, else 0
  int hsmem;      // the chain's column band copied into shared memory
  int rslots;     // the replay's row band slots in shared memory (0: L2)
  int ldr;        // row stride of the H^T ring: N rounded up to 4
  int tq;         // tiles across a row of the matrix
  int ntiles;     // tiles of a pass
  int S;          // steps of the longest track's sequence
};

__host__ __device__ inline int help_ldr(int N) { return (N + 3) & ~3; }

// floats of one group's hand-off memory: the H^T ring, the pairs ring and,
// with replay, the iterate ring
__host__ __device__ inline size_t help_ring_floats(int BC, int N, int it,
                                                   bool replay) {
  return 2 * 2 * (size_t)N * help_ldr(N) + 2 * (size_t)(it + 1) * 4 * BC * N +
         (replay ? (size_t)HELP_W * it * 2 * BC * N : 0);
}

// ints of one group's counters: the claim word, full and empty per
// iterate slot, then claimed, done and ready per pass
__host__ __device__ inline size_t help_flag_ints(int S) {
  return 1 + 2 * (size_t)HELP_W + 3 * ((size_t)S + 2);
}

// floats of a tile's scratch: the tile of H staged transposed (re, im),
// the it + 1 pairs' cotangents on its rows and inputs on its columns
__host__ __device__ inline size_t help_tile_floats(int BC, int it) {
  return 2 * HTILE_Q * HTILE_LD +
         (size_t)(it + 1) * 2 * BC * (HTILE_P + HTILE_Q);
}

// The chain's shared memory: two exchange buffers (re, im) x BC x N, the
// bands of g, kb, bb (with replay also b, k), the solver rows, two slots
// of a step's operands (j, the pre-state and the stored iterates, by band),
// then one region, 16-byte aligned, that holds either the step's column
// band of H^T (hsmem) or a tile's scratch.
__host__ __device__ inline size_t help_chain_floats(int BC, int N, int R,
                                                    int it, bool replay,
                                                    bool stored, bool hsmem) {
  const size_t BNv = (size_t)BC * N, BR = (size_t)BC * R;
  const size_t head = 4 * BNv + (replay ? 10 : 6) * BR + 4 * (size_t)R +
                      2 * (4 + 2 * (size_t)(stored ? it : 0)) * BR;
  const size_t band = hsmem ? 2 * (size_t)R * help_ldr(N) : 0;
  const size_t tile = help_tile_floats(BC, it);
  return pad4(head) + (band > tile ? band : tile);
}

// The replay's: two exchange buffers, the bands of b and k, the solver
// rows, then `rslots` slots of the row band of H(t), 16-byte aligned.
__host__ __device__ inline size_t help_replay_floats(int BC, int N, int R,
                                                     int rslots) {
  return pad4(4 * (size_t)BC * N + 4 * (size_t)BC * R + 4 * (size_t)R) +
         rslots * sm_band_floats(N, R, false, false);
}

// A CTA's shared memory on the helpers schedule: a header of 8 words, then
// the largest of the chain's, the replay's (with replay) and a tile's.
__host__ __device__ inline size_t help_floats(int BC, int N, int R, int it,
                                              bool replay, bool stored,
                                              bool hsmem, int rslots) {
  size_t f = help_chain_floats(BC, N, R, it, replay, stored, hsmem);
  const size_t rp = replay ? help_replay_floats(BC, N, R, rslots) : 0;
  const size_t tile = help_tile_floats(BC, it);
  if (rp > f) f = rp;
  if (tile > f) f = tile;
  return 8 + f;
}

// One tile of a pass, by the whole CTA: rows [p0, p0 + HTILE_P) x columns
// [q0, q0 + HTILE_Q) of the N x N matrix. With Hr: the tile of H(t) (its
// planes Hr, Hi, row-major) written transposed into HT (row q: column q of
// H, row stride ldr; im NL floats on), 16 bytes a lane. With P (a pairs
// slot, npairs pairs): Hb[pp, q] = the sum over the pairs and the BC states
// of c[b][pp] (x) u[b][q], one fmaf chain per entry in pair then state
// order (the chain schedule's), written into Hb (re at Hbr, im at Hbi, row
// stride N) where `first`, else added to it. The planes are read 16 bytes a
// lane where N % 4 == 0. Ends with a barrier.
template <int BC>
__device__ void help_tile(const float* __restrict__ Hr,
                          const float* __restrict__ Hi, float* HT, int ldr,
                          const float* P, int npairs, float* Hbr, float* Hbi,
                          bool first, int N, int tile, int tq, float* ts) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const size_t NL = (size_t)N * ldr;
  const int p0 = (tile / tq) * HTILE_P, q0 = (tile % tq) * HTILE_Q;
  float* Tr = ts;                               // the tile of H, transposed
  float* Ti = Tr + HTILE_Q * HTILE_LD;
  float* Pc = Ti + HTILE_Q * HTILE_LD;          // npairs x 2 x BC x HTILE_P
  float* Pu = Pc + npairs * 2 * BC * HTILE_P;   // npairs x 2 x BC x HTILE_Q
  const bool vec = (N & 3) == 0;
  constexpr int QR = HTILE_Q / 4;               // quads of a tile row
  if (P != nullptr) {
    for (int i = tid; i < npairs * 2 * BC * HTILE_P; i += nth) {
      const int m = i / HTILE_P, pp = p0 + i - m * HTILE_P;
      const int pr = m / (2 * BC), rest = m - pr * 2 * BC;
      Pc[i] = pp < N ? __ldcg(P + (size_t)(pr * 4 * BC + rest) * N + pp)
                     : 0.f;
    }
    for (int i = tid; i < npairs * 2 * BC * HTILE_Q; i += nth) {
      const int m = i / HTILE_Q, q = q0 + i - m * HTILE_Q;
      const int pr = m / (2 * BC), rest = m - pr * 2 * BC;
      Pu[i] = q < N ? __ldcg(P + (size_t)(pr * 4 * BC + 2 * BC + rest) * N +
                             q)
                    : 0.f;
    }
  }
  if (Hr != nullptr) {
    for (int idx = tid; idx < HTILE_P * QR; idx += nth) {
      const int pl = idx / QR, c4 = idx - pl * QR;
      const int pp = p0 + pl, qa = q0 + 4 * c4;
      if (pp >= N || qa >= N) continue;
      const size_t off = (size_t)pp * N + qa;
      float vr[4], vi[4];
      if (vec) {
        const float4 a = __ldcs(reinterpret_cast<const float4*>(Hr + off));
        const float4 b = __ldcs(reinterpret_cast<const float4*>(Hi + off));
        vr[0] = a.x; vr[1] = a.y; vr[2] = a.z; vr[3] = a.w;
        vi[0] = b.x; vi[1] = b.y; vi[2] = b.z; vi[3] = b.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          vr[e] = qa + e < N ? __ldcs(Hr + off + e) : 0.f;
          vi[e] = qa + e < N ? __ldcs(Hi + off + e) : 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Tr[(4 * c4 + e) * HTILE_LD + pl] = vr[e];
        Ti[(4 * c4 + e) * HTILE_LD + pl] = vi[e];
      }
    }
  }
  __syncthreads();      // the pairs and the tile of H are staged
  if (P != nullptr) {
    for (int idx = tid; idx < HTILE_P * QR; idx += nth) {
      const int pl = idx / QR, c4 = idx - pl * QR;
      const int pp = p0 + pl, qa = q0 + 4 * c4;
      if (pp >= N || qa >= N) continue;
      float hbr[4] = {0.f, 0.f, 0.f, 0.f}, hbi[4] = {0.f, 0.f, 0.f, 0.f};
      for (int pr = 0; pr < npairs; ++pr) {
#pragma unroll
        for (int b = 0; b < BC; ++b) {
          const int mr = (pr * 2) * BC + b, mi = mr + BC;
          const float cr = Pc[mr * HTILE_P + pl], ci = Pc[mi * HTILE_P + pl];
          const float4 u4r =
              *reinterpret_cast<const float4*>(Pu + mr * HTILE_Q + 4 * c4);
          const float4 u4i =
              *reinterpret_cast<const float4*>(Pu + mi * HTILE_Q + 4 * c4);
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
      const size_t o = (size_t)pp * N + qa;
      if (vec) {
        float4* wr = reinterpret_cast<float4*>(Hbr + o);
        float4* wi = reinterpret_cast<float4*>(Hbi + o);
        float4 ar = make_float4(hbr[0], hbr[1], hbr[2], hbr[3]);
        float4 ai = make_float4(hbi[0], hbi[1], hbi[2], hbi[3]);
        if (!first) {
          const float4 br = __ldcg(wr), bi = __ldcg(wi);
          ar = make_float4(br.x + ar.x, br.y + ar.y, br.z + ar.z,
                           br.w + ar.w);
          ai = make_float4(bi.x + ai.x, bi.y + ai.y, bi.z + ai.z,
                           bi.w + ai.w);
        }
        *wr = ar;
        *wi = ai;
      } else {
        for (int e = 0; e < 4 && qa + e < N; ++e) {
          Hbr[o + e] = first ? hbr[e] : __ldcg(Hbr + o + e) + hbr[e];
          Hbi[o + e] = first ? hbi[e] : __ldcg(Hbi + o + e) + hbi[e];
        }
      }
    }
  }
  if (Hr != nullptr) {  // row q of H^T: HTILE_P floats from column pp = p0
    constexpr int QP = HTILE_P / 4;
    for (int idx = tid; idx < HTILE_Q * QP; idx += nth) {
      const int ql = idx / QP, c4 = idx - ql * QP;
      const int q = q0 + ql, pa = p0 + 4 * c4;
      if (q >= N || pa >= N) continue;
      const float* tr = Tr + ql * HTILE_LD + 4 * c4;
      const float* ti = Ti + ql * HTILE_LD + 4 * c4;
      *reinterpret_cast<float4*>(HT + (size_t)q * ldr + pa) =
          make_float4(tr[0], tr[1], tr[2], tr[3]);
      *reinterpret_cast<float4*>(HT + NL + (size_t)q * ldr + pa) =
          make_float4(ti[0], ti[1], ti[2], ti[3]);
    }
  }
  __syncthreads();      // the scratch is free for the next tile
}

}  // namespace

// Backward, 'helpers' schedule: the chain schedule's contract (inputs, g0,
// Hb, the tracks and each step's chain in the same order), with the
// replay, the pass and the column band's transposition beside the chain
// (see above). ring, flags: the groups' hand-off memory and counters, sized
// by the wrapper.
template <int BC>
__global__ void __launch_bounds__(SM_MAX_THREADS)
stream_mid_bwd_helpers(
    const float* __restrict__ gHr, const float* __restrict__ gHi,
    const float* __restrict__ x0r, const float* __restrict__ x0i,
    const float* __restrict__ hr, const float* __restrict__ hi,
    const float* __restrict__ jr, const float* __restrict__ ji,
    const float* __restrict__ gTr, const float* __restrict__ gTi,
    const float* __restrict__ rows, const float* __restrict__ ksr,
    const float* __restrict__ ksi, float* __restrict__ g0r,
    float* __restrict__ g0i, float* __restrict__ Hbr,
    float* __restrict__ Hbi, float* ring, int* flags, SMDims d, SMHelp s) {
  extern __shared__ __align__(16) float sm[];
  const cg::cluster_group cl = cg::this_cluster();
  int* hdr = reinterpret_cast<int*>(sm);
  const int rank = (int)cl.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  if (rank == 0 && tid == 0) hdr[0] = atomicAdd(flags, 1);
  cl.sync();
  const int ticket = *cl.map_shared_rank(hdr, 0);
  cl.sync();    // rank 0's ticket is read before any CTA moves on
  const int roles = s.nrep + 1 + s.helpers;
  const int grp = ticket / roles, role = ticket - grp * roles;

  const int N = d.N, R = d.R, nt = d.nt, it = d.iters, G = d.G;
  const int ldr = s.ldr;
  const bool jac = d.mode == MODE_JACOBI, split = d.mode == MODE_SPLIT;
  const bool replay = d.store == 0 && it > 0;
  const bool stored = d.store != 0 && it > 0;
  const int e = grp / d.tracks, l = grp - e * d.tracks;
  const int S = (d.nchunks - l + d.tracks - 1) / d.tracks * nt;
  const size_t NL = (size_t)N * ldr, BNv = (size_t)BC * N;
  const size_t BN = (size_t)d.B * N, NN = (size_t)N * N;
  const int BI = BC * R;
  const size_t hslot = 2 * NL, pslot = (size_t)(it + 1) * 4 * BNv;
  const size_t kslot = (size_t)it * 2 * BNv;
  float* HTring = ring + grp * help_ring_floats(BC, N, it, replay);
  float* Pring = HTring + 2 * hslot;
  float* Kring = Pring + 2 * pslot;
  int* claimw = flags + 1 + grp * help_flag_ints(s.S);
  int* full = claimw + 1;
  int* empty = full + HELP_W;
  int* claimed = empty + HELP_W;
  int* done = claimed + s.S + 2;
  int* ready = done + s.S + 2;
  // step st of the group's sequence: its chunk and time step
  auto chunk_of = [&](int st) { return l + d.tracks * (st / nt); };
  auto t_of = [&](int st) { return nt - 1 - st % nt; };
  SMBand gb;      // this CTA's band of the group's candidate
  gb.e = e;
  gb.r0 = rank * R;
  gb.nr = min(R, N - gb.r0);

  // the tiles of pass i this CTA can claim, until none is left
  auto run_pass = [&](int i, float* ts) {
    const bool tr = i < S, hb = i >= 2 && i - 2 < S;
    if (!tr && !hb) return;
    if (hb) {     // step i - 2's pairs, and the previous chunk's Hb(t)
      if (tid == 0) {
        wait_count(ready + i - 2, G);
        if (i - 2 >= nt) wait_count(done + i - nt, s.ntiles);
      }
      __syncthreads();
    }
    const float *Hr = nullptr, *Hi = nullptr;
    if (tr) {
      Hr = plane_rows(gHr, d, e, t_of(i), 0);
      Hi = plane_rows(gHi, d, e, t_of(i), 0);
    }
    float *br = nullptr, *bi = nullptr;
    if (hb) {
      const size_t ho = (((size_t)e * d.tracks + l) * nt + t_of(i - 2)) * NN;
      br = Hbr + ho;
      bi = Hbi + ho;
    }
    for (;;) {
      if (tid == 0) hdr[1] = atomicAdd(claimed + i, 1);
      __syncthreads();
      const int tile = hdr[1];
      __syncthreads();
      if (tile >= s.ntiles) break;
      help_tile<BC>(Hr, Hi, HTring + (i & 1) * hslot, ldr,
                    hb ? Pring + (i & 1) * pslot : nullptr, it + 1, br, bi,
                    i - 2 < nt, N, tile, s.tq, ts);
      if (tid == 0) signal_count(done + i);
    }
  };

  auto owned = [&](int nr, auto fn) {
    for (int il = warp; il < nr; il += nwarps)
      if (lane < BC) fn(il, lane, lane * R + il);
  };
  auto put = [&](float* buf, int b, int il, float vr, float vi) {
    push(cl, buf + b * N + gb.r0 + il, vr, G);
    push(cl, buf + BNv + b * N + gb.r0 + il, vi, G);
  };
  // the stage chain of one step from the pre-state pushed into exchange
  // buffer p & 1 (the chain schedule's replay): k_j of entry (b, il) to
  // out(j, il, b, kr, ki); p counts the exchanges
  auto replay_step = [&](float* X, float* Bb, float* Kb, const float* rw,
                         const float* Rr, const float* Ri, int nr, int& p,
                         auto out) {
    for (int j = 0; j < it; ++j) {
      const float* Vr = X + 2 * (p & 1) * BNv;
      float* Vn = X + 2 * ((p + 1) & 1) * BNv;
      rows_dot<BC, false>(
          Rr, Ri, N, nr, Vr, Vr + BNv, N, warp, nwarps, lane,
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
            out(j, il, b, kr, ki);
            if (j + 1 < it) put(Vn, b, il, kr, ki);
          });
      ++p;
      if (j + 1 < it) cl.sync();
    }
  };
  // the pre-state of step t of the chunk at g, rotated where split
  auto pre_state = [&](const SMBand& g, int t, int il, int b, float& xr,
                       float& xi, const float* rw) {
    xr = xi = 0.f;
    if (b < g.nb) {
      const size_t col = (size_t)(g.b0 + b) * N + g.r0 + il;
      const size_t st = (size_t)e * nt + t;
      xr = t == 0 ? x0r[col] : hr[(st - 1) * BN + col];
      xi = t == 0 ? x0i[col] : hi[(st - 1) * BN + col];
    }
    if (split) cmul(rw[il], rw[R + il], xr, xi);
  };
  const int nrows = jac ? 4 : split ? 2 : 0;

  if (role > s.nrep) {          // a helper: the passes in order
    for (int i = 0; i < S + 2; ++i) run_pass(i, sm + 8);
    return;
  }

  if (role < s.nrep) {          // the replay: iterates into the ring
    float* X = sm + 8;          // two exchange buffers x (re, im) x BC x N
    float* Bb = X + 4 * BNv;    // the bands of b, k
    float* Kb = Bb + 2 * BI;
    float* rw = Kb + 2 * BI;    // solver rows, 4 x R
    float* Hs = sm + 8 + pad4(4 * BNv + 4 * (size_t)BI + 4 * (size_t)R);
    const size_t bandf = sm_band_floats(N, R, false, false);
    const size_t rowp = pad4((size_t)R * N);
    for (int i = tid; i < nrows * R; i += blockDim.x) {
      const int m = i / R, il = i - m * R;
      if (il < gb.nr) rw[i] = rows[m * N + gb.r0 + il];
    }
    auto fetch = [&](int st) {  // the row band of step st's H into its slot
      float* dst = Hs + (s.rslots > 1 ? (st & 1) : 0) * bandf;
      copy_run(dst, plane_rows(gHr, d, e, t_of(st), gb.r0), gb.nr * N);
      copy_run(dst + rowp, plane_rows(gHi, d, e, t_of(st), gb.r0),
               gb.nr * N);
      cp_commit();
    };
    if (s.rslots == 2 && S > 0) fetch(0);
    __syncthreads();
    int p = 0;
    for (int st = 0; st < S; ++st) {
      const int sl = st % HELP_W, t = t_of(st);
      const SMBand g = sm_chunk(gb, d, BC, chunk_of(st));
      if (st == HELP_W) {       // the chain has not claimed: hand over
        if (rank == 0 && tid == 0) {
          const int was = atomicCAS(claimw, 0, HELP_W + 1);
          hdr[2] = ((was == 0 ? HELP_W + 1 : was) & ~CLAIMED) == HELP_W + 1;
        }
        cl.sync();
        if (*cl.map_shared_rank(hdr + 2, 0)) break;
      }
      if (st >= HELP_W) {       // the chain has emptied step st - HELP_W
        if (tid == 0) wait_count(empty + sl, G * (st / HELP_W));
        __syncthreads();
      }
      const float *Rr, *Ri;
      if (s.rslots == 0) {
        Rr = plane_rows(gHr, d, e, t, gb.r0);
        Ri = plane_rows(gHi, d, e, t, gb.r0);
      } else {
        __syncthreads();        // step st - 1's stages are done with H
        if (s.rslots == 1) {
          fetch(st);
          cp_wait_group<0>();
        } else if (st + 1 < S) {
          fetch(st + 1);
          cp_wait_group<1>();
        } else {
          cp_wait_group<0>();
        }
        __syncthreads();        // H(t)'s row band is in its slot
        Rr = Hs + (s.rslots > 1 ? (st & 1) : 0) * bandf;
        Ri = Rr + rowp;
      }
      float* Ks = Kring + sl * kslot;
      float* Xp = X + 2 * (p & 1) * BNv;
      owned(g.nr, [&](int il, int b, int ib) {
        float xr, xi;
        pre_state(g, t, il, b, xr, xi, rw);
        put(Xp, b, il, xr, xi);
      });
      cl.sync();
      replay_step(X, Bb, Kb, rw, Rr, Ri, g.nr, p,
                  [&](int j, int il, int b, float kr, float ki) {
                    float* o = Ks + j * 2 * BNv + b * N + g.r0 + il;
                    o[0] = kr;
                    o[BNv] = ki;
                  });
      __syncthreads();
      if (tid == 0) signal_count(full + sl);
    }
    cp_wait_group<0>();
    cl.sync();    // no CTA leaves while another may still address it
    return;
  }

  // the chain
  float* X = sm + 8;                        // two exchange buffers
  float* Gb = X + 4 * BNv;                  // the bands of g, kb, bb
  float* KB = Gb + 2 * BI;
  float* BB = KB + 2 * BI;
  float* Bb = BB + 2 * BI;                  // replay: the bands of b, k
  float* Kb = Bb + 2 * BI;
  float* rw = BB + 2 * BI + (replay ? 4 * BI : 0);   // solver rows, 4 x R
  float* OP = rw + 4 * R;                   // two slots of step operands
  const int opw = (4 + 2 * (stored ? it : 0)) * BI;
  float* region = sm + 8 + pad4(OP + 2 * opw - (sm + 8));
  for (size_t i = 8 + tid; i < (size_t)(region - sm); i += blockDim.x)
    sm[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < nrows * R; i += blockDim.x) {
    const int m = i / R, il = i - m * R;
    if (il < gb.nr) rw[i] = rows[m * N + gb.r0 + il];
  }
  if (replay && rank == 0 && tid == 0) {    // claim the group's replay
    const int was = atomicOr(claimw, CLAIMED) & ~CLAIMED;
    hdr[2] = was != 0 ? was - 1 : S;
  }
  // pair q's cotangent (cu = 0) or input (cu = 2) entry into the pairs ring
  auto put_pair = [&](float* P, int q, int cu, int b, int il, float vr,
                      float vi) {
    float* o = P + (size_t)(q * 4 + cu) * BNv + b * N + gb.r0 + il;
    o[0] = vr;
    o[BNv] = vi;
  };
  // step st's operands (j, the pre-state, the stored iterates) into slot sl
  // by their owners' cp.async, a step ahead
  auto fetch = [&](int st) {
    if (st >= S) return;
    float* o = OP + (st & 1) * opw;
    const SMBand g = sm_chunk(gb, d, BC, chunk_of(st));
    const int t = t_of(st);
    const size_t sq = (size_t)e * nt + t;
    owned(g.nr, [&](int il, int b, int ib) {
      if (b >= g.nb) return;
      const size_t col = (size_t)(g.b0 + b) * N + g.r0 + il;
      cp_async4(o + ib, jr + sq * BN + col);
      cp_async4(o + BI + ib, ji + sq * BN + col);
      cp_async4(o + 2 * BI + ib, t == 0 ? x0r + col : hr + (sq - 1) * BN + col);
      cp_async4(o + 3 * BI + ib, t == 0 ? x0i + col : hi + (sq - 1) * BN + col);
      if (stored)
        for (int q = 0; q < it; ++q) {    // pair q's input is k_{it-1-q}
          const size_t k = (sq * it + it - 1 - q) * BN + col;
          cp_async4(o + (4 + 2 * q) * BI + ib, ksr + k);
          cp_async4(o + (5 + 2 * q) * BI + ib, ksi + k);
        }
    });
  };
  fetch(0);
  cl.sync();    // rank 0's claim; every CTA has zeroed its buffers
  const int first = replay ? *cl.map_shared_rank(hdr + 2, 0) : S;

  int p = 0;                      // exchanges so far
  for (int st = 0; st < S; ++st) {
    const int t = t_of(st), sl = st % HELP_W;
    const SMBand g = sm_chunk(gb, d, BC, chunk_of(st));
    const bool own = replay && st >= first;     // replays step t itself
    const bool from_ring = replay && !own;
    if (st % nt == 0)             // a chunk begins: its final cotangent
      owned(g.nr, [&](int il, int b, int ib) {
        const size_t o = ((size_t)e * d.B + g.b0 + b) * N + g.r0 + il;
        Gb[ib] = b < g.nb ? gTr[o] : 0.f;
        Gb[BI + ib] = b < g.nb ? gTi[o] : 0.f;
      });
    // H(t)^T: pass st, run by the helpers, or by this CTA where tiles are
    // left (no claim where the helpers have done it)
    if (tid == 0) hdr[3] = ld_acquire(done + st) >= s.ntiles;
    __syncthreads();
    if (!hdr[3]) {
      run_pass(st, region);
      if (tid == 0) wait_count(done + st, s.ntiles);
    }
    if (tid == 0 && from_ring) wait_count(full + sl, G * (st / HELP_W + 1));
    __syncthreads();
    const float* HTs = HTring + (st & 1) * hslot + (size_t)g.r0 * ldr;
    const float *HTr = HTs, *HTi = HTs + NL;
    if (s.hsmem) {          // the column band into shared memory
      const int nb4 = g.nr * ldr / 4;
      for (int i = tid; i < 2 * nb4; i += blockDim.x) {
        const int m = i / nb4, o = 4 * (i - m * nb4);
        cp_async16_l2(region + (size_t)m * R * ldr + o, HTs + m * NL + o);
      }
      HTr = region;
      HTi = region + (size_t)R * ldr;
    }
    cp_async_wait();        // the band, and this thread's operands of step st
    float* Pw = Pring + (st & 1) * pslot;       // this step's pairs
    const float* o = OP + (st & 1) * opw;
    const float* Ks = Kring + sl * kslot;
    float* Xp = X + 2 * (p & 1) * BNv;
    owned(g.nr, [&](int il, int b, int ib) {
      float gr = Gb[ib], gi = Gb[BI + ib], xr = 0.f, xi = 0.f;
      if (b < g.nb) {
        gr += o[ib];
        gi += o[BI + ib];
        xr = o[2 * BI + ib];
        xi = o[3 * BI + ib];
      }
      if (split) {          // cotangent and pre-state into the rotated frame
        cmul_conj(rw[il], rw[R + il], gr, gi);
        cmul(rw[il], rw[R + il], xr, xi);
      }
      Gb[ib] = gr;
      Gb[BI + ib] = gi;
      put_pair(Pw, it, 2, b, il, xr, xi);
      for (int q = 0; q < it && !own; ++q) {  // pair q's input: k_{it-1-q}
        float ur = 0.f, ui = 0.f;
        if (from_ring) {
          const float* k = Ks + (it - 1 - q) * 2 * BNv + b * N + g.r0 + il;
          ur = __ldcg(k);
          ui = __ldcg(k + BNv);
        } else if (b < g.nb) {
          ur = o[(4 + 2 * q) * BI + ib];
          ui = o[(5 + 2 * q) * BI + ib];
        }
        put_pair(Pw, q, 2, b, il, ur, ui);
      }
      if (own) put(Xp, b, il, xr, xi);
    });
    fetch(st + 1);
    if (from_ring) {        // the slot is read: the replay may refill it
      __syncthreads();
      if (tid == 0) signal_count(empty + sl);
    }
    if (own) {              // k_0..k_{it-1} from xp, on the row band in L2
      cl.sync();
      replay_step(X, Bb, Kb, rw, plane_rows(gHr, d, e, t, g.r0),
                  plane_rows(gHi, d, e, t, g.r0), g.nr, p,
                  [&](int j, int il, int b, float kr, float ki) {
                    put_pair(Pw, it - 1 - j, 2, b, il, kr, ki);
                  });
    }
    // the transposed chain: pair q < it has cotangent a kb (its input
    // k_{it-1-q}), pair it the cotangent bb (its input xp)
    owned(g.nr, [&](int il, int b, int ib) {
      KB[ib] = d.dt * Gb[ib];
      KB[BI + ib] = d.dt * Gb[BI + ib];
      BB[ib] = BB[BI + ib] = 0.f;
    });
    for (int q = 0; q <= it; ++q) {
      float* cq = X + 2 * (p & 1) * BNv;
      owned(g.nr, [&](int il, int b, int ib) {
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
      if (s.hsmem)
        rows_dot<BC, true>(HTr, HTi, ldr, g.nr, cq, cq + BNv, N, warp,
                           nwarps, lane, stage);
      else
        rows_dot_l2<BC, true>(HTr, HTi, ldr, g.nr, cq, cq + BNv, N, warp,
                              nwarps, lane, stage);
      ++p;
    }
    __syncthreads();
    if (tid == 0) signal_count(ready + st);     // the step's pairs
    if (st % nt == nt - 1)        // the chunk's x0 cotangent
      owned(g.nr, [&](int il, int b, int ib) {
        if (b < g.nb) {
          const size_t o = ((size_t)e * d.B + g.b0 + b) * N + g.r0 + il;
          g0r[o] = Gb[ib];
          g0i[o] = Gb[BI + ib];
        }
      });
  }
  // the Hb of the last two steps' pairs, where no helper took it
  run_pass(S, region);
  run_pass(S + 1, region);
  cl.sync();    // no CTA leaves while another may still address it
}

// Plain C entry points, bound from Python with ctypes. Each launches on the
// given stream a grid of clusters of G CTAs, E * ceil(B / BC) for the
// forward and E * tracks for the backward, and returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue, launching nothing, for a call
// outside the member's contract or a shape the kernels do not take: G not
// in {1, 2, 4, 8, 16} or past N bands, BC not in {1, 2, 4, 8}, threads not
// whole warps up to SM_MAX_THREADS, slots not in {0, 1, 2}, tracks not in
// [1, ceil(B / BC)], shared memory below the layout or above 227 KB, or the
// backward's global layout without scratch. The forward's band_rows are its
// band rows in shared memory past its whole slots: with one slot the rows
// copied a step ahead (below R; the others refilled in place), with none
// the rows resident (up to R; the others read from L2), with two none. The
// backward's helpers >= 0
// takes its 'helpers' schedule: E * tracks * (nrep + 1 + helpers) clusters
// (nrep 1 with replayed iterates, else 0), hsmem and rslots its layout
// (help_floats), ring and flags as the kernel reads them (flags zeroed;
// slots and scratch unused); -1 the chain schedule. The launch
// configuration and the clusters the card holds: mid_cluster.cuh's
// cluster_config and max_clusters.
namespace {

// The dims of a launch, or false for a shape the kernels do not take.
bool sm_dims(SMDims& d, int E, int nt, int B, int N, int iters, int mode,
             int store, float dt, float a, int G, int BC, int threads,
             int smem_bytes, int slots, int tracks, bool backward,
             const void* scratch, int rows = 0) {
  if (G != 1 && G != 2 && G != 4 && G != 8 && G != 16) return false;
  if (BC != 1 && BC != 2 && BC != 4 && BC != 8) return false;
  const int R = (N + G - 1) / G;
  const int nchunks = B < 1 ? 0 : (B + BC - 1) / BC;
  if (!backward) tracks = nchunks;
  if (N < 1 || B < 1 || E < 1 || nt < 0 || (G - 1) * R >= N ||
      threads % 32 != 0 || threads < 32 || threads > SM_MAX_THREADS ||
      iters < 0 || slots < 0 || slots > 2 || tracks < 1 || tracks > nchunks)
    return false;
  const bool replay = backward && store == 0 && iters > 0;
  const int ahead = backward ? 0 : slots == 2 ? R : slots == 1 ? rows : 0;
  const int inplace = backward ? 0 : slots == 1 ? R - rows : slots ? 0 : rows;
  if (rows < 0 || (backward || slots == 2 ? rows != 0 : rows > R) ||
      (slots == 1 && rows == R))
    return false;
  const size_t floats = backward
                            ? sm_bwd_floats(BC, N, R, iters, replay, slots)
                            : sm_fwd_floats(BC, N, R, ahead, inplace);
  if ((size_t)smem_bytes < 4 * floats || smem_bytes > 227 * 1024 ||
      (backward && slots == 0 && scratch == nullptr))
    return false;
  d = SMDims{E, nt, B, N, iters, mode, store, dt, a, G, R, nchunks,
             slots, tracks, ahead, inplace, 0};
  return true;
}

// The forward's MINB for `clusters` clusters of a launch shape: 2 where the
// card holds fewer of the instance of one CTA an SM and two CTAs fit an
// SM's 228 KB of shared memory (1 KB of it reserved a CTA), else 1.
template <int BC, bool HIST>
int fwd_min_blocks(int clusters, int G, int threads, int smem_bytes) {
  return 2 * (smem_bytes + 1024) <= 228 * 1024 &&
                 max_clusters(stream_mid_fwd<BC, HIST, 1>, G, threads,
                              smem_bytes) < clusters
             ? 2
             : 1;
}

template <int BC, bool HIST, int MINB>
int launch_fwd_minb(const void* Hr, const void* Hi, const void* x0r,
                    const void* x0i, const void* rows, void* xTr, void* xTi,
                    void* hr, void* hi, void* ksr, void* ksi,
                    const SMDims& d, int threads, int smem_bytes,
                    void* stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(stream_mid_fwd<BC, HIST, MINB>, attr, d.E * d.nchunks,
                     d.G, threads, smem_bytes, (cudaStream_t)stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, stream_mid_fwd<BC, HIST, MINB>, (const float*)Hr,
      (const float*)Hi, (const float*)x0r, (const float*)x0i,
      (const float*)rows, (float*)xTr, (float*)xTi, (float*)hr, (float*)hi,
      (float*)ksr, (float*)ksi, d);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int BC, bool HIST>
int launch_fwd(const void* Hr, const void* Hi, const void* x0r,
               const void* x0i, const void* rows, void* xTr, void* xTi,
               void* hr, void* hi, void* ksr, void* ksi, const SMDims& d,
               int threads, int smem_bytes, void* stream) {
  return fwd_min_blocks<BC, HIST>(d.E * d.nchunks, d.G, threads,
                                  smem_bytes) == 2
             ? launch_fwd_minb<BC, HIST, 2>(Hr, Hi, x0r, x0i, rows, xTr, xTi,
                                            hr, hi, ksr, ksi, d, threads,
                                            smem_bytes, stream)
             : launch_fwd_minb<BC, HIST, 1>(Hr, Hi, x0r, x0i, rows, xTr, xTi,
                                            hr, hi, ksr, ksi, d, threads,
                                            smem_bytes, stream);
}

template <int BC>
int launch_bwd(const void* Hr, const void* Hi, const void* x0r,
               const void* x0i, const void* hr, const void* hi,
               const void* jr, const void* ji, const void* gTr,
               const void* gTi, const void* rows, const void* ksr,
               const void* ksi, void* g0r, void* g0i, void* Hbr, void* Hbi,
               void* scratch, const SMDims& d, int threads, int smem_bytes,
               void* stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(stream_mid_bwd<BC>, attr, d.E * d.tracks, d.G, threads,
                     smem_bytes, (cudaStream_t)stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, stream_mid_bwd<BC>, (const float*)Hr, (const float*)Hi,
      (const float*)x0r, (const float*)x0i, (const float*)hr,
      (const float*)hi, (const float*)jr, (const float*)ji,
      (const float*)gTr, (const float*)gTi, (const float*)rows,
      (const float*)ksr, (const float*)ksi, (float*)g0r, (float*)g0i,
      (float*)Hbr, (float*)Hbi, (float*)scratch, d);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The 'helpers' schedule's dims of a launch, or false for a shape it does
// not take.
bool help_dims(SMHelp& s, const SMDims& d, int BC, int helpers, int hsmem,
               int rslots, int smem_bytes, const void* ring,
               const void* flags) {
  const bool replay = d.store == 0 && d.iters > 0;
  if (ring == nullptr || flags == nullptr || helpers < 0 || helpers > 64 ||
      rslots < 0 || rslots > 2 || (size_t)smem_bytes <
          4 * help_floats(BC, d.N, d.R, d.iters, replay,
                          d.store != 0 && d.iters > 0, hsmem != 0, rslots))
    return false;
  const int tq = (d.N + HTILE_Q - 1) / HTILE_Q;
  s = SMHelp{helpers, replay ? 1 : 0, hsmem != 0, rslots, help_ldr(d.N), tq,
             (d.N + HTILE_P - 1) / HTILE_P * tq,
             (d.nchunks + d.tracks - 1) / d.tracks * d.nt};
  return true;
}

template <int BC>
int launch_bwd_helpers(const void* Hr, const void* Hi, const void* x0r,
                       const void* x0i, const void* hr, const void* hi,
                       const void* jr, const void* ji, const void* gTr,
                       const void* gTi, const void* rows, const void* ksr,
                       const void* ksi, void* g0r, void* g0i, void* Hbr,
                       void* Hbi, void* ring, void* flags, const SMDims& d,
                       const SMHelp& s, int threads, int smem_bytes,
                       void* stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      stream_mid_bwd_helpers<BC>, attr,
      d.E * d.tracks * (s.nrep + 1 + s.helpers), d.G, threads, smem_bytes,
      (cudaStream_t)stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, stream_mid_bwd_helpers<BC>, (const float*)Hr, (const float*)Hi,
      (const float*)x0r, (const float*)x0i, (const float*)hr,
      (const float*)hi, (const float*)jr, (const float*)ji,
      (const float*)gTr, (const float*)gTi, (const float*)rows,
      (const float*)ksr, (const float*)ksi, (float*)g0r, (float*)g0i,
      (float*)Hbr, (float*)Hbi, (float*)ring, (int*)flags, d, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool HIST>
int fwd_any(const void* Hr, const void* Hi, const void* x0r, const void* x0i,
            const void* rows, void* xTr, void* xTi, void* hr, void* hi,
            void* ksr, void* ksi, int E, int nt, int B, int N, int iters,
            int mode, int store, float dt, float a, int G, int BC,
            int threads, int smem_bytes, int slots, int band_rows,
            void* stream) {
  SMDims d;
  if (!sm_dims(d, E, nt, B, N, iters, mode, store, dt, a, G, BC, threads,
               smem_bytes, slots, 0, false, nullptr, band_rows) ||
      (store && iters > 0 && ksr == nullptr) || (HIST && hr == nullptr))
    return (int)cudaErrorInvalidValue;
  d.bulk = N % 4 == 0 && (((uintptr_t)Hr | (uintptr_t)Hi) & 15) == 0;
#define SM_FWD_ARGS                                                           \
  Hr, Hi, x0r, x0i, rows, xTr, xTi, hr, hi, ksr, ksi, d, threads, smem_bytes, \
      stream
  switch (BC) {
    case 1: return launch_fwd<1, HIST>(SM_FWD_ARGS);
    case 2: return launch_fwd<2, HIST>(SM_FWD_ARGS);
    case 4: return launch_fwd<4, HIST>(SM_FWD_ARGS);
    case 8: return launch_fwd<8, HIST>(SM_FWD_ARGS);
  }
#undef SM_FWD_ARGS
  return (int)cudaErrorInvalidValue;
}

int bwd_any(const void* Hr, const void* Hi, const void* x0r, const void* x0i,
            const void* hr, const void* hi, const void* jr, const void* ji,
            const void* gTr, const void* gTi, const void* rows,
            const void* ksr, const void* ksi, void* g0r, void* g0i,
            void* Hbr, void* Hbi, void* scratch, int E, int nt, int B, int N,
            int iters, int mode, int store, float dt, float a, int G, int BC,
            int threads, int smem_bytes, int slots, int tracks, void* stream,
            int helpers, int hsmem, int rslots, void* ring, void* flags) {
  SMDims d;
  if (helpers >= 0) {
    SMHelp s;
    if (!sm_dims(d, E, nt, B, N, iters, mode, store, dt, a, G, BC, threads,
                 227 * 1024, 0, tracks, true, ring) ||
        !help_dims(s, d, BC, helpers, hsmem, rslots, smem_bytes, ring,
                   flags) ||
        smem_bytes > 227 * 1024 || (store && iters > 0 && ksr == nullptr))
      return (int)cudaErrorInvalidValue;
#define SM_HELP_ARGS                                                        \
  Hr, Hi, x0r, x0i, hr, hi, jr, ji, gTr, gTi, rows, ksr, ksi, g0r, g0i, Hbr, \
      Hbi, ring, flags, d, s, threads, smem_bytes, stream
    switch (BC) {
      case 1: return launch_bwd_helpers<1>(SM_HELP_ARGS);
      case 2: return launch_bwd_helpers<2>(SM_HELP_ARGS);
      case 4: return launch_bwd_helpers<4>(SM_HELP_ARGS);
      case 8: return launch_bwd_helpers<8>(SM_HELP_ARGS);
    }
#undef SM_HELP_ARGS
    return (int)cudaErrorInvalidValue;
  }
  if (!sm_dims(d, E, nt, B, N, iters, mode, store, dt, a, G, BC, threads,
               smem_bytes, slots, tracks, true, scratch) ||
      (store && iters > 0 && ksr == nullptr))
    return (int)cudaErrorInvalidValue;
#define SM_BWD_ARGS                                                         \
  Hr, Hi, x0r, x0i, hr, hi, jr, ji, gTr, gTi, rows, ksr, ksi, g0r, g0i, Hbr, \
      Hbi, scratch, d, threads, smem_bytes, stream
  switch (BC) {
    case 1: return launch_bwd<1>(SM_BWD_ARGS);
    case 2: return launch_bwd<2>(SM_BWD_ARGS);
    case 4: return launch_bwd<4>(SM_BWD_ARGS);
    case 8: return launch_bwd<8>(SM_BWD_ARGS);
  }
#undef SM_BWD_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#define SM_FWD_PARAMS                                                       \
  const void *Hr, const void *Hi, const void *x0r, const void *x0i,         \
      const void *rows, void *xTr, void *xTi, void *hr, void *hi,           \
      void *ksr, void *ksi, int E, int nt, int B, int N, int iters,         \
      int mode, int store, float dt, float a, int G, int BC, int threads,   \
      int smem_bytes, int slots, int band_rows, void *stream
#define SM_BWD_PARAMS                                                       \
  const void *Hr, const void *Hi, const void *x0r, const void *x0i,         \
      const void *hr, const void *hi, const void *jr, const void *ji,       \
      const void *gTr, const void *gTi, const void *rows, const void *ksr,  \
      const void *ksi, void *g0r, void *g0i, void *Hbr, void *Hbi,          \
      void *scratch, int E, int nt, int B, int N, int iters, int mode,      \
      int store, float dt, float a, int G, int BC, int threads,             \
      int smem_bytes, int slots, int tracks, void *stream, int helpers,     \
      int hsmem, int rslots, void *ring, void *flags
#define SM_FWD_CALL                                                         \
  Hr, Hi, x0r, x0i, rows, xTr, xTi, hr, hi, ksr, ksi, E, nt, B, N, iters,   \
      mode, store, dt, a, G, BC, threads, smem_bytes, slots, band_rows,     \
      stream
#define SM_BWD_CALL                                                         \
  Hr, Hi, x0r, x0i, hr, hi, jr, ji, gTr, gTi, rows, ksr, ksi, g0r, g0i,     \
      Hbr, Hbi, scratch, E, nt, B, N, iters, mode, store, dt, a, G, BC,     \
      threads, smem_bytes, slots, tracks, stream, helpers, hsmem, rslots,   \
      ring, flags

// B3: any solver, stored or replayed stage iterates.
extern "C" int stream_mid_fwd_launch(SM_FWD_PARAMS) {
  return fwd_any<true>(SM_FWD_CALL);
}

extern "C" int stream_mid_bwd_launch(SM_BWD_PARAMS) {
  return bwd_any(SM_BWD_CALL);
}

// B5: plain Neumann, the backward replays its stage iterates.
extern "C" int chunk_mid_fwd_launch(SM_FWD_PARAMS) {
  if (mode != MODE_NEUMANN || store) return (int)cudaErrorInvalidValue;
  return fwd_any<true>(SM_FWD_CALL);
}

extern "C" int chunk_mid_bwd_launch(SM_BWD_PARAMS) {
  if (mode != MODE_NEUMANN || store) return (int)cudaErrorInvalidValue;
  return bwd_any(SM_BWD_CALL);
}

// B6: plain Neumann forward, xT only (no history, nothing stored).
extern "C" int dense_mid_fwd_launch(SM_FWD_PARAMS) {
  if (mode != MODE_NEUMANN || store || hr || hi || ksr || ksi)
    return (int)cudaErrorInvalidValue;
  return fwd_any<false>(SM_FWD_CALL);
}

// How many clusters of G CTAs of one kernel (kind 0: the forward with
// history, 1: without, 2: the backward's chain schedule, 3: its 'helpers'
// schedule) of instance BC (the forward: the more of its two MINB
// instances), with `threads` threads and smem_bytes of shared memory each,
// the card can hold at once; 0 where it holds none (the launch would
// fail).
extern "C" int stream_mid_max_clusters(int kind, int BC, int G, int threads,
                                       int smem_bytes) {
#define SM_FWD_MAX(bc, hist)                                                \
  std::max(max_clusters(stream_mid_fwd<bc, hist, 1>, G, threads,            \
                        smem_bytes),                                        \
           max_clusters(stream_mid_fwd<bc, hist, 2>, G, threads,            \
                        smem_bytes))
#define SM_MAX(bc)                                                          \
  case bc:                                                                  \
    return kind == 3 ? max_clusters(stream_mid_bwd_helpers<bc>, G, threads, \
                                    smem_bytes)                             \
           : kind == 2 ? max_clusters(stream_mid_bwd<bc>, G, threads,       \
                                      smem_bytes)                           \
           : kind == 1 ? SM_FWD_MAX(bc, false)                              \
                       : SM_FWD_MAX(bc, true);
  switch (BC) {
    SM_MAX(1)
    SM_MAX(2)
    SM_MAX(4)
    SM_MAX(8)
  }
#undef SM_MAX
#undef SM_FWD_MAX
  return 0;
}
