// streamK propagation kernels for Hopper (sm_90a): the whole IMR time loop
// of dv/dt = -i H(t) v in ONE launch per direction, H(t) = sum_k c_k(t) S_k
// contracted in-kernel from operator stacks held in shared memory.
//
// Replaces quandary_tpu/ops/pallas_stream.py::make_streamk_propagate (the
// TPU kernel pair: forward pallas_call at :907, backward at :967) together
// with the step core it inlines (_stage_fwd :217, _stage_bwd :331,
// _bwd_step :429). Same contract and the same algebra, the step of
// imr_step.cuh (neumann, jacobi, split; for split the off-diagonal remainder
// V is an extra stack slot -diag(h) with coefficient 1, appended by the
// wrapper).
// The same pair also replaces make_streamk_packed_propagate (:1059, forward
// pallas_call at :1324, backward at :1415) with per_block_stacks: every
// candidate of a launch may carry its own operator stack and its own solver
// rows (strideS, strideR below), so one launch propagates S realizations of
// the system under one control. The TPU kernel packs the candidates into
// the lanes of one 128-lane tile with block-diagonal planes; here a
// candidate is a thread block and reads its own stack from global memory.
// The backward is the exact real transpose of the computed forward step; the
// step's H cotangent Hb = sum_pairs c u^T is reduced in-kernel against every
// stack slot into Cb[t, k] = <Hb_r, Sr_k> + <Hb_i, Si_k> (pallas_stream.py
// :947-958). Stack cotangents are not computed (zero by the same contract);
// the streamed-plane kernels of stream.cu emit the per-step H cotangent
// from which they follow.
//
// Layout: one thread block per control candidate; the sequential time loop
// runs inside the block (the TPU's sequential grid axis). The stacks, the
// per-step H planes and the matvec inputs live in shared memory; one thread
// owns one (b, i) state entry and keeps its own b, k, x values in
// registers. Arithmetic is exact f32 FMA on the CUDA cores (the TPU kernel's
// default is a 3-pass bf16 emulation of f32 matmuls, pallas_stream.py:52-119;
// this one is more accurate, not less). No tensor cores: at N = 16 a
// complex matvec is 4 * N^2 * B = 4 kFLOP.
//
// What bounds it on the H100: neither bytes nor FLOPs. The CNOT flagship
// (N = 16, B = 4, ntime = 1221, split with 3 iterations) does about 40 MFLOP
// per forward sweep, under a microsecond of the card's f32 rate, and reads
// (ntime * Ke) coefficients. The bound is latency: a chain of
// ntime * (iters + 1) dependent matvecs. The design keeps that chain on-chip
// (no global round trip per step, no per-step launch) and runs E candidates
// as E independent blocks, so a batch of up to one block per SM costs the
// same wall time as one.
// Both kernels split the block into roles (imr_step.cuh's second part). The
// state threads, the first S = roundup32(B N), run the chain and nothing
// else. Helper warps after them contract H a step or two ahead into a
// two-slot ring, from coefficient rows they copy into shared memory
// (cp.async, strided over the helpers, so any Ke) a step before use; in the
// backward they also reduce C-bar a step behind. So the chain waits on no
// global load (x0 or the backward's operands are loaded ahead; history and
// stored iterates are plain stores), runs no contraction and passes no
// block-wide barrier: a stage synchronizes only the threads of one basis
// state (__syncwarp where N divides 32, else a named barrier over the state
// warps), and the roles hand off through named barriers per ring slot
// (bar.arrive by the producer, bar.sync by the consumer). At the
// compile-time N = 16 a chain thread holds the step's row (forward) or
// column (backward) of H in registers and reads each operand row 16 bytes
// a load. The forward keeps apply_T's order of terms (two chains of 2 N
// FMAs), so it gives the bits of stream.cu's forward on the same H; the
// backward sums over 8 accumulators, N / 2 FMAs deep.
// What bounds it then is one matvec per stage, a shared-memory round trip
// and its FMA chain, iters + 1 times per step (a backward replay adds
// iters), with the helpers' work beside it.
// Inline branch: where the helpers or the second slots do not fit (1024
// threads, 227 KB) the launcher gives no helpers, and the whole block
// contracts H(t) (and in the backward reduces Cb[t, :]) around the chain of
// step t, on one buffer of each kind: the same device functions and
// arithmetic, with two (forward) or four (backward) block-wide barriers per
// step.

#include <cuda_runtime.h>

#include "imr_step.cuh"

namespace {

// strideS, strideR: floats between two candidates' operator stacks
// (Ke * N * N) and solver rows (nrows * N); 0 when all candidates share one.
// helpers: the helper threads after the state threads, 0 for the inline
// branch (set by the launcher).
struct Dims {
  int E, nt, B, N, Ke, iters, mode, store;
  float dt, a;
  size_t strideS, strideR;
  int helpers;
};

// named barriers after imr_step.cuh's BAR_STATE; the per-slot ones take
// id + slot
enum {
  BAR_HELP = 2,     // the helper warps among themselves
  BAR_H_FULL = 3,   // H(t) contracted: helpers arrive, the chain waits
  BAR_H_FREE = 5,   // forward: step t is done with H(t)'s slot
  BAR_P_FULL = 5,   // backward: step t's pairs written and its H read
  BAR_P_FREE = 7,   // backward: step t's pairs reduced into Cb
};

// Floats of the forward's shared memory: the stacks; per slot (two with
// helpers, one inline) the H planes; the two (B, N) slots of the matvec
// inputs; per slot a coefficient row. Every buffer but the last starts on a
// 16-byte boundary where N is a multiple of 4.
__host__ __device__ inline size_t fwd_floats(int B, int N, int Ke,
                                             bool split) {
  const size_t NN = (size_t)N * N, BN = (size_t)B * N, slots = split ? 2 : 1;
  return 2 * Ke * NN + slots * (2 * N * (N + 1) + Ke) + 4 * BN;
}

}  // namespace

// Forward: x0 (B, N) shared by all candidates; C (E, nt, Ke); rows: jacobi
// (d_r, d_i, minv_r, minv_i) or split (e_r, e_i), each (N,). Block e reads
// the stack at gS + e * strideS and the rows at rows + e * strideR. Writes xT
// (E, B, N), hist (E, nt, B, N) and, with store, the stage iterates
// k_0..k_{iters-1} (E, nt, iters, B, N). Roles: the S state threads run
// fwd_chain_step for t = 0, 1, ...; the d.helpers helper threads contract
// H(t) into ring slot t & 1 and copy c(t + 1) into the other row slot while
// the chain runs step t - 1 or t - 2. A chain step waits for H_FULL of its
// slot and gives the slot back on H_FREE as soon as it no longer reads it:
// at the compile-time N = 16 (NC; helpers only, at most 512 threads) right
// after it has read its row of H into registers, at NC = 0 (any N) at the
// end of the step. The launch bounds ask for one block per SM so that
// ptxas may give a thread up to 128 registers (asked for none, it held
// streamk_fwd<16> to 64 and spilled).
template <int NC>
__global__ void __launch_bounds__(NC > 0 ? 512 : 1024, 1)
streamk_fwd(const float* __restrict__ gSr, const float* __restrict__ gSi,
            const float* __restrict__ C, const float* __restrict__ x0r,
            const float* __restrict__ x0i, const float* __restrict__ rows,
            float* __restrict__ xTr, float* __restrict__ xTi,
            float* __restrict__ hr, float* __restrict__ hi,
            float* __restrict__ ksr, float* __restrict__ ksi, Dims d) {
  extern __shared__ float sm[];
  const int N = NC ? NC : d.N, NN = N * N, BN = d.B * N, Ke = d.Ke;
  const int nt = d.nt, S = (BN + 31) & ~31, Hh = d.helpers;
  const int slots = Hh > 0 ? 2 : 1, ldH = N * (N + 1), Hsz = 2 * ldH;
  float* Sr = sm;
  float* Si = Sr + Ke * NN;
  float* Hbuf = Si + Ke * NN;           // slots x (Hr, Hi)
  float* V = Hbuf + slots * Hsz;        // two (B, N) slots, re and im
  float* crow = V + 4 * BN;             // slots x coefficient row

  const int e = blockIdx.x, tid = threadIdx.x;
  gSr += (size_t)e * d.strideS;
  gSi += (size_t)e * d.strideS;
  rows += (size_t)e * d.strideR;
  for (int idx = tid; idx < Ke * NN; idx += blockDim.x) {
    Sr[idx] = gSr[idx];
    Si[idx] = gSi[idx];
  }
  const StepThread s = step_thread(d.B, N, d.iters, d.mode, d.dt, d.a, rows);
  const size_t base = (size_t)e * nt;
  const float* Ce = C + base * Ke;      // this candidate's coefficient rows
  const bool warp_rows = 32 % N == 0;
  float xr = 0.f, xi = 0.f;
  if (s.act) {
    xr = x0r[tid];
    xi = x0i[tid];
  }
  __syncthreads();

  // the chain's step t on H(t) in Hr, Hi; its outputs are plain stores
  int p = 0;
  auto step = [&](int t, const HRow<NC>& h, const float* Hr, const float* Hi) {
    const size_t st = base + t, ko = st * d.iters * BN;
    fwd_chain_step<NC>(s, h, Hr, Hi, V, p, d.store ? ksr + ko : nullptr,
                       d.store ? ksi + ko : nullptr, warp_rows, S, xr, xi);
    if (s.act) {
      hr[st * BN + tid] = xr;
      hi[st * BN + tid] = xi;
    }
  };

  if (Hh > 0) {
    const int nall = S + Hh;
    if (tid < S) {            // the chain
      for (int t = 0; t < nt; ++t) {
        const int sl = t & 1;
        const float* Hr = Hbuf + sl * Hsz;
        const bool reused = t + 2 < nt;   // the helpers contract H(t + 2) here
        bar_sync(BAR_H_FULL + sl, nall);
        HRow<NC> h;
        load_hrow<NC>(Hr, Hr + ldH, s.i, h);
        if (NC > 0 && reused) bar_arrive(BAR_H_FREE + sl, nall);
        step(t, h, Hr, Hr + ldH);
        if (NC == 0 && reused) bar_arrive(BAR_H_FREE + sl, nall);
      }
    } else {                  // the helpers, one or two steps ahead
      const int hh = tid - S;
      auto stage = [&](int u) {
        stage_row(crow + (u & 1) * Ke, Ce + (size_t)u * Ke, Ke, hh, Hh);
      };
      if (nt > 0) stage(0);
      cp_async_wait();
      for (int u = 0; u < nt; ++u) {
        const int sl = u & 1;
        // c(u) copied by every helper; from u = 2 the chain has released
        // the slot (H(u - 2)); c(u + 1) overwrites the row H(u - 1) read
        if (u >= 2)
          bar_sync(BAR_H_FREE + sl, nall);
        else
          bar_sync(BAR_HELP, Hh);
        if (u + 1 < nt) stage(u + 1);
        contract_part<NC>(Sr, Si, crow + sl * Ke, Hbuf + sl * Hsz,
                          Hbuf + sl * Hsz + ldH, Ke, N, hh, Hh);
        bar_arrive(BAR_H_FULL + sl, nall);
        cp_async_wait();
      }
    }
  } else if constexpr (NC == 0) {   // inline: every role in turn
    const HRow<0> h{};
    if (nt > 0) stage_row(crow, Ce, Ke, tid, blockDim.x);
    cp_async_wait();
    for (int t = 0; t < nt; ++t) {
      __syncthreads();              // c(t) copied; the chain is done with H
      contract_part<0>(Sr, Si, crow, Hbuf, Hbuf + ldH, Ke, N, tid,
                       blockDim.x);
      __syncthreads();
      if (t + 1 < nt)
        stage_row(crow, Ce + (size_t)(t + 1) * Ke, Ke, tid, blockDim.x);
      if (tid < S) step(t, h, Hbuf, Hbuf + ldH);
      cp_async_wait();
    }
  }
  if (s.act) {
    xTr[(size_t)e * BN + tid] = xr;
    xTi[(size_t)e * BN + tid] = xi;
  }
}

// ---------------------------------------------------------------------------
// Backward. Roles: the state threads (the first S = roundup32(B N), one per
// (b, i) entry as in the forward) run the dependent chain of each reversed
// step and nothing else: its transposed stages and, without stored
// iterates, their replay. The helper threads after them (d.helpers of them,
// whole warps, one per two entries of H) run what the recursion for g never
// reads, beside the chain:
//   * while the chain runs step t - 1 they contract H(t - 2) from the stacks
//     into the H buffer that step t released (two buffers, a ring);
//   * at the same time they reduce the (cotangent, input) pairs that step t
//     left in one slot of a two-slot ring into Hb(t), once, into shared
//     memory, and then into Cb[t, :]: each helper warp owns stack slots
//     k, k + nwarps, ... and writes each Cb[t, k] from one shuffle tree (no
//     atomics: two launches give the same bits);
//   * they copy each coefficient row into shared memory (cp.async, strided
//     over the helpers, so any Ke) a step before the contraction reads it.
// The chain reads its step operands (the injection, the pre-state, the
// stored iterates) from registers it loaded one step ahead; at the
// compile-time N = 16 a chain thread also holds its column of H(t) and, per
// stage, the cotangent row it contracts in registers (16-byte loads). A stage
// synchronizes only the threads of one basis state: where N divides 32 a
// state's N entries lie in one warp and a stage ends on __syncwarp,
// otherwise on a named barrier over the state warps. The hand-offs between
// the roles are named barriers per ring slot (bar.arrive by the producer,
// bar.sync by the consumer); no stage waits on a block-wide barrier. The
// chain, the contraction and Hb are imr_step.cuh's split-role step.
// Inline branch: where the helpers or the second buffers do not fit (1024
// threads, 227 KB) the launcher gives no helpers, and the whole block
// contracts H(t) and reduces Cb[t, :] around the chain of step t, on one
// buffer of each kind: the same device functions and arithmetic, four
// block-wide barriers per step.
namespace {

// Floats of the backward's shared memory: the stacks; per slot (two with
// helpers, one inline) the H planes and the pairs; Hb; per slot a
// coefficient row. Every buffer but the last starts on a 16-byte boundary
// where N is a multiple of 4.
__host__ __device__ inline size_t bwd_floats(int B, int N, int Ke, int it,
                                             bool split) {
  const size_t NN = (size_t)N * N, BN = (size_t)B * N, slots = split ? 2 : 1;
  return 2 * Ke * NN + slots * (2 * N * (N + 1) + (4 * it + 4) * BN + Ke) +
         2 * NN;
}

// cb[k] = <Hb_r, Sr_k> + <Hb_i, Si_k> for k = warp, warp + nwarps, ...: one
// warp per stack slot, one shuffle tree each, written by its lane 0. At a
// compile-time N a lane holds its NN / 32 entries of Hb in registers for
// all its warp's slots and reads 16 bytes a load.
template <int NC>
__device__ __forceinline__ void cbar_part(const float* Sr, const float* Si,
                                          const float* Hbr, const float* Hbi,
                                          float* __restrict__ cb, int Ke,
                                          int NN, int warp, int nwarps,
                                          int lane) {
  if constexpr (NC > 0) {
    constexpr int V = NC * NC / 128;  // float4s of Hb a lane holds
    static_assert(NC * NC % 128 == 0, "whole float4s per lane");
    if (warp >= Ke) return;
    float4 hr[V], hi[V];
#pragma unroll
    for (int m = 0; m < V; ++m) {
      hr[m] = reinterpret_cast<const float4*>(Hbr)[lane + 32 * m];
      hi[m] = reinterpret_cast<const float4*>(Hbi)[lane + 32 * m];
    }
    for (int k = warp; k < Ke; k += nwarps) {
      const float4* sr = reinterpret_cast<const float4*>(Sr + k * NC * NC);
      const float4* si = reinterpret_cast<const float4*>(Si + k * NC * NC);
      float v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int m = 0; m < V; ++m) {
        const float4 a = sr[lane + 32 * m], b = si[lane + 32 * m];
        v0 = fmaf(hr[m].x, a.x, v0);
        v0 = fmaf(hr[m].y, a.y, v0);
        v0 = fmaf(hr[m].z, a.z, v0);
        v0 = fmaf(hr[m].w, a.w, v0);
        v1 = fmaf(hi[m].x, b.x, v1);
        v1 = fmaf(hi[m].y, b.y, v1);
        v1 = fmaf(hi[m].z, b.z, v1);
        v1 = fmaf(hi[m].w, b.w, v1);
      }
      float v = v0 + v1;
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) cb[k] = v;
    }
  } else {
    for (int k = warp; k < Ke; k += nwarps) {
      const float* sr = Sr + k * NN;
      const float* si = Si + k * NN;
      float v0 = 0.f, v1 = 0.f;
#pragma unroll 8
      for (int ent = lane; ent < NN; ent += 32) {
        v0 = fmaf(Hbr[ent], sr[ent], v0);
        v1 = fmaf(Hbi[ent], si[ent], v1);
      }
      float v = v0 + v1;
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) cb[k] = v;
    }
  }
}

}  // namespace

// Backward: runs the steps in reverse. Inputs as the forward's plus the
// history (E, nt, B, N), its cotangent j (E, nt, B, N), the final-state
// cotangent gT (E, B, N) and, with store, the forward's stage iterates.
// Writes the x0 cotangent per candidate g0 (E, B, N) and the coefficient
// cotangents Cb (E, nt, Ke). d.helpers: the helper threads after the S state
// threads, 0 for the inline branch. NC: N, where the kernel is compiled for
// it (16: the flagship's, and open configuration 1's superop dimension;
// helpers only, at most 512 threads, so up to 128 registers a thread), or 0
// for any N.
template <int NC>
__global__ void __launch_bounds__(NC > 0 ? 512 : 1024)
streamk_bwd(const float* __restrict__ gSr, const float* __restrict__ gSi,
            const float* __restrict__ C, const float* __restrict__ x0r,
            const float* __restrict__ x0i, const float* __restrict__ hr,
            const float* __restrict__ hi, const float* __restrict__ jr,
            const float* __restrict__ ji, const float* __restrict__ gTr,
            const float* __restrict__ gTi, const float* __restrict__ rows,
            const float* __restrict__ ksr, const float* __restrict__ ksi,
            float* __restrict__ g0r, float* __restrict__ g0i,
            float* __restrict__ Cb, Dims d) {
  extern __shared__ float sm[];
  const int N = NC ? NC : d.N, NN = N * N, BN = d.B * N, Ke = d.Ke;
  const int it = d.iters, nt = d.nt, S = (BN + 31) & ~31, Hh = d.helpers;
  const int slots = Hh > 0 ? 2 : 1, ldH = N * (N + 1);
  const int Hsz = 2 * ldH, Psz = (4 * it + 4) * BN;
  float* Sr = sm;
  float* Si = Sr + Ke * NN;
  float* Hbuf = Si + Ke * NN;           // slots x (Hr, Hi)
  float* Pbuf = Hbuf + slots * Hsz;     // slots x pairs
  float* Hbr = Pbuf + slots * Psz;
  float* Hbi = Hbr + NN;
  float* crow = Hbi + NN;               // slots x coefficient row

  const int e = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  gSr += (size_t)e * d.strideS;
  gSi += (size_t)e * d.strideS;
  rows += (size_t)e * d.strideR;
  for (int idx = tid; idx < Ke * NN; idx += blockDim.x) {
    Sr[idx] = gSr[idx];
    Si[idx] = gSi[idx];
  }
  const StepThread s = step_thread(d.B, N, it, d.mode, d.dt, d.a, rows);
  const size_t base = (size_t)e * nt;
  const float* Ce = C + base * Ke;      // this candidate's coefficient rows
  const bool stored = d.store != 0, warp_rows = 32 % N == 0;
  const float* kr_ = stored ? ksr : nullptr;
  float gr = 0.f, gi = 0.f;
  StepOps cur = {}, nxt = {};
  if (s.act) {
    gr = gTr[(size_t)e * BN + tid];
    gi = gTi[(size_t)e * BN + tid];
  }
  if (tid < S && nt > 0)
    load_ops(s, nt - 1, base + nt - 1, x0r, x0i, hr, hi, jr, ji, kr_, ksi,
             cur);
  __syncthreads();

  if (Hh > 0) {
    const int nall = S + Hh;
    if (tid < S) {            // the chain
      for (int t = nt - 1; t >= 0; --t) {
        const int sl = t & 1;
        bar_sync(BAR_H_FULL + sl, nall);
        if (t <= nt - 3) bar_sync(BAR_P_FREE + sl, nall);
        if (t > 0)
          load_ops(s, t - 1, base + t - 1, x0r, x0i, hr, hi, jr, ji, kr_, ksi,
                   nxt);
        chain_step<NC>(s, Hbuf + sl * Hsz, Hbuf + sl * Hsz + ldH,
                       pairs_slot(Pbuf + sl * Psz, BN, it), cur, stored,
                       warp_rows, S, gr, gi);
        bar_arrive(BAR_P_FULL + sl, nall);
        cur = nxt;
      }
    } else {                  // the helpers, one step apart from the chain
      const int h = tid - S, hw = h >> 5, nhw = Hh >> 5;
      // coefficient row c(u) into crow slot u & 1, a step before its use
      auto stage = [&](int u) {
        stage_row(crow + (u & 1) * Ke, Ce + (size_t)u * Ke, Ke, h, Hh);
      };
      stage(nt - 1);
      if (nt >= 2) stage(nt - 2);
      cp_async_wait();
      bar_sync(BAR_HELP, Hh);
      for (int u = nt - 1; u >= 0 && u >= nt - 2; --u) {
        const int sl = u & 1;
        contract_part<NC>(Sr, Si, crow + sl * Ke, Hbuf + sl * Hsz,
                          Hbuf + sl * Hsz + ldH, Ke, N, h, Hh);
        bar_arrive(BAR_H_FULL + sl, nall);
      }
      bar_sync(BAR_HELP, Hh);
      if (nt >= 3) stage(nt - 3);   // contracted at t = nt - 1
      cp_async_wait();
      for (int t = nt - 1; t >= 0; --t) {
        const int sl = t & 1;
        bar_sync(BAR_P_FULL + sl, nall);
        if (t >= 2) {               // H(t - 2) into the buffer step t released
          contract_part<NC>(Sr, Si, crow + sl * Ke, Hbuf + sl * Hsz,
                            Hbuf + sl * Hsz + ldH, Ke, N, h, Hh);
          bar_arrive(BAR_H_FULL + sl, nall);
        }
        if (t >= 3) stage(t - 3);   // contracted at t - 1
        hb_part<NC>(pairs_slot(Pbuf + sl * Psz, BN, it), Hbr, Hbi, d.B, N, it,
                    h, Hh);
        cp_async_wait();
        bar_sync(BAR_HELP, Hh);
        cbar_part<NC>(Sr, Si, Hbr, Hbi, Cb + (base + t) * Ke, Ke, NN, hw, nhw,
                      lane);
        if (t >= 2) bar_arrive(BAR_P_FREE + sl, nall);
      }
    }
  } else if constexpr (NC == 0) {   // inline: every role in turn
    float* Hr = Hbuf;
    float* Hi = Hbuf + ldH;
    const Pairs q = pairs_slot(Pbuf, BN, it);
    if (nt > 0)
      stage_row(crow, Ce + (size_t)(nt - 1) * Ke, Ke, tid, blockDim.x);
    cp_async_wait();
    for (int t = nt - 1; t >= 0; --t) {
      __syncthreads();
      contract_part<0>(Sr, Si, crow, Hr, Hi, Ke, N, tid, blockDim.x);
      __syncthreads();
      if (t >= 1)                   // c(t - 1) for the next step
        stage_row(crow, Ce + (size_t)(t - 1) * Ke, Ke, tid, blockDim.x);
      if (tid < S) {
        if (t > 0)
          load_ops(s, t - 1, base + t - 1, x0r, x0i, hr, hi, jr, ji, kr_, ksi,
                   nxt);
        chain_step<0>(s, Hr, Hi, q, cur, stored, warp_rows, S, gr, gi);
        cur = nxt;
      }
      cp_async_wait();
      __syncthreads();
      hb_part<0>(q, Hbr, Hbi, d.B, N, it, tid, blockDim.x);
      __syncthreads();
      cbar_part<0>(Sr, Si, Hbr, Hbi, Cb + (base + t) * Ke, Ke, NN, tid >> 5,
                   blockDim.x >> 5, lane);
    }
  }
  if (s.act) {
    g0r[(size_t)e * BN + tid] = gr;
    g0i[(size_t)e * BN + tid] = gi;
  }
}

// Plain C entry points, bound from Python with ctypes. Each launches on the
// given stream and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue, launching nothing, for a launch shape that cannot
// hold the roles. The packed entry points take the per-candidate strides of
// the stacks and the solver rows; the plain ones run every candidate on one
// shared stack (stride 0).
// STREAMK_NC: the N of both kernels' compile-time instances, 16 (0 builds
// none and runs every N on streamk_fwd<0> / streamk_bwd<0>: a build with
// -DSTREAMK_NC=0 times the two against each other).
#ifndef STREAMK_NC
#define STREAMK_NC 16
#endif

namespace {

// The roles go to helper warps when the caller's launch shape holds them:
// threads past the state warps and the two-slot layout's shared memory
// (floats(true) bytes); else the inline branch, on floats(false).
template <typename Floats>
int helper_threads(const Dims& d, int threads, int smem_bytes,
                   Floats floats) {
  const int S = (d.B * d.N + 31) & ~31;
  const int helpers =
      threads > S && (size_t)smem_bytes >= 4 * floats(true) ? threads - S : 0;
  if (threads < S || threads % 32 != 0 ||
      (size_t)smem_bytes < 4 * floats(helpers > 0))
    return -1;
  return helpers;
}

template <typename Kernel>
void allow_smem(Kernel kernel, int smem_bytes) {
  if (smem_bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
}

int launch_fwd(const void* Sr, const void* Si, const void* C, const void* x0r,
               const void* x0i, const void* rows, void* xTr, void* xTi,
               void* hr, void* hi, void* ksr, void* ksi, const Dims& d,
               int threads, int smem_bytes, void* stream) {
  Dims df = d;
  df.helpers = helper_threads(d, threads, smem_bytes, [&](bool split) {
    return fwd_floats(d.B, d.N, d.Ke, split);
  });
  if (df.helpers < 0) return (int)cudaErrorInvalidValue;
  auto kernel = STREAMK_NC > 0 && d.N == STREAMK_NC && df.helpers > 0 &&
                        threads <= 512
                    ? streamk_fwd<STREAMK_NC>
                    : streamk_fwd<0>;
  allow_smem(kernel, smem_bytes);
  kernel<<<d.E, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)Sr, (const float*)Si, (const float*)C,
      (const float*)x0r, (const float*)x0i, (const float*)rows,
      (float*)xTr, (float*)xTi, (float*)hr, (float*)hi, (float*)ksr,
      (float*)ksi, df);
  return (int)cudaGetLastError();
}

int launch_bwd(const void* Sr, const void* Si, const void* C, const void* x0r,
               const void* x0i, const void* hr, const void* hi,
               const void* jr, const void* ji, const void* gTr,
               const void* gTi, const void* rows, const void* ksr,
               const void* ksi, void* g0r, void* g0i, void* Cb, const Dims& d,
               int threads, int smem_bytes, void* stream) {
  Dims db = d;
  db.helpers = helper_threads(d, threads, smem_bytes, [&](bool split) {
    return bwd_floats(d.B, d.N, d.Ke, d.iters, split);
  });
  if (db.helpers < 0 || (d.store && d.iters > MAX_STORED))
    return (int)cudaErrorInvalidValue;
  auto kernel = STREAMK_NC > 0 && d.N == STREAMK_NC && db.helpers > 0 &&
                        threads <= 512
                    ? streamk_bwd<STREAMK_NC>
                    : streamk_bwd<0>;
  allow_smem(kernel, smem_bytes);
  kernel<<<d.E, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)Sr, (const float*)Si, (const float*)C,
      (const float*)x0r, (const float*)x0i, (const float*)hr,
      (const float*)hi, (const float*)jr, (const float*)ji,
      (const float*)gTr, (const float*)gTi, (const float*)rows,
      (const float*)ksr, (const float*)ksi, (float*)g0r, (float*)g0i,
      (float*)Cb, db);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int streamk_fwd_launch(
    const void* Sr, const void* Si, const void* C, const void* x0r,
    const void* x0i, const void* rows, void* xTr, void* xTi, void* hr,
    void* hi, void* ksr, void* ksi, int E, int nt, int B, int N, int Ke,
    int iters, int mode, int store, float dt, float a, int threads,
    int smem_bytes, void* stream) {
  Dims d{E, nt, B, N, Ke, iters, mode, store, dt, a, 0, 0};
  return launch_fwd(Sr, Si, C, x0r, x0i, rows, xTr, xTi, hr, hi, ksr, ksi, d,
                    threads, smem_bytes, stream);
}

extern "C" int streamk_bwd_launch(
    const void* Sr, const void* Si, const void* C, const void* x0r,
    const void* x0i, const void* hr, const void* hi, const void* jr,
    const void* ji, const void* gTr, const void* gTi, const void* rows,
    const void* ksr, const void* ksi, void* g0r, void* g0i, void* Cb, int E,
    int nt, int B, int N, int Ke, int iters, int mode, int store, float dt,
    float a, int threads, int smem_bytes, void* stream) {
  Dims d{E, nt, B, N, Ke, iters, mode, store, dt, a, 0, 0};
  return launch_bwd(Sr, Si, C, x0r, x0i, hr, hi, jr, ji, gTr, gTi, rows, ksr,
                    ksi, g0r, g0i, Cb, d, threads, smem_bytes, stream);
}

// Sr, Si: (E, Ke, N, N); rows: (E, nrows, N). stride_s = Ke * N * N and
// stride_r = nrows * N floats.
extern "C" int streamk_packed_fwd_launch(
    const void* Sr, const void* Si, const void* C, const void* x0r,
    const void* x0i, const void* rows, void* xTr, void* xTi, void* hr,
    void* hi, void* ksr, void* ksi, int E, int nt, int B, int N, int Ke,
    int iters, int mode, int store, float dt, float a, int threads,
    int smem_bytes, void* stream, long long stride_s, long long stride_r) {
  Dims d{E, nt, B, N, Ke, iters, mode, store, dt, a, (size_t)stride_s,
         (size_t)stride_r};
  return launch_fwd(Sr, Si, C, x0r, x0i, rows, xTr, xTi, hr, hi, ksr, ksi, d,
                    threads, smem_bytes, stream);
}

extern "C" int streamk_packed_bwd_launch(
    const void* Sr, const void* Si, const void* C, const void* x0r,
    const void* x0i, const void* hr, const void* hi, const void* jr,
    const void* ji, const void* gTr, const void* gTi, const void* rows,
    const void* ksr, const void* ksi, void* g0r, void* g0i, void* Cb, int E,
    int nt, int B, int N, int Ke, int iters, int mode, int store, float dt,
    float a, int threads, int smem_bytes, void* stream, long long stride_s,
    long long stride_r) {
  Dims d{E, nt, B, N, Ke, iters, mode, store, dt, a, (size_t)stride_s,
         (size_t)stride_r};
  return launch_bwd(Sr, Si, C, x0r, x0i, hr, hi, jr, ji, gTr, gTi, rows, ksr,
                    ksi, g0r, g0i, Cb, d, threads, smem_bytes, stream);
}
