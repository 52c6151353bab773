// Streamed-plane propagation kernels for Hopper (sm_90a): the whole IMR time
// loop of dv/dt = -i H(t) v in ONE launch per direction, with the per-step
// Hamiltonian planes H(t) = sum_k c_k(t) S_k built OUTSIDE the kernel and
// read from global memory one step at a time. The backward emits the
// per-step plane cotangent Hb(t), from which the caller gets both the
// coefficient cotangents and the operator-stack cotangents
// (Sb = sum_t c(t) Hb(t)): the route for differentiating the Hamiltonian
// itself (calibration), which the streamK kernels of streamk.cu refuse by
// contract.
//
// One kernel pair is the counterpart of three TPU kernels of one family:
//   * stream_fwd / stream_bwd: quandary_tpu/ops/pallas_stream.py::
//     make_stream_propagate (:490; forward pallas_call :613, backward :657),
//     neumann, jacobi and split, stage iterates stored (iters <= 4) or
//     replayed, the step core _stage_fwd :217 / _stage_bwd :331 inlined.
//   * chunk_fwd / chunk_bwd: ops/pallas_adjoint.py::make_pallas_propagate
//     (:167; _multistep_kernel :64 at :202, _multistep_vjp_kernel :94 at
//     :211): plain Neumann, the backward always replays. Its Tc steps per
//     launch under lax.scan are TPU VMEM scheduling; here the time loop runs
//     inside one launch.
//   * dense_fwd: ops/pallas_kernels.py::pallas_propagate_dense (:76;
//     _step_kernel :46 at :111): the Neumann forward without the history,
//     xT only (one launch per step under lax.scan on the TPU).
// The entry points enforce each member's contract (chunk and dense: neumann,
// nothing stored; dense: no history) and run the same two __global__
// functions; HIST drops the history writes.
//
// For split the planes carry the off-diagonal remainder: the caller
// subtracts diag(h) outside (pallas_stream.py:515-523, :573-575); the
// kernel only applies the rotations E = exp((dt/2) d).
//
// Layout and step as streamk.cu's (the step functions of imr_step.cuh): one
// thread block per control candidate with the sequential time loop inside;
// the step's plane pair (row stride N + 1) and the matvec inputs in shared
// memory; one thread owns one (b, i) state entry. Exact f32
// FMA on the CUDA cores (the TPU stream kernel defaults to a 3-pass bf16
// emulation, pallas_stream.py:52-119; the chunk and dense kernels run f32
// HIGHEST). The backward keeps a thread's entries of Hb(t) in registers
// over the step's (cotangent, input) pairs and writes them once, coalesced,
// to the (E, nt, N, N) outputs.
//
// What bounds it on the H100: the dependent chain of ntime * (iters + 1)
// matvecs, as for streamK. Bytes: the planes are read once forward and
// once backward and Hb written once, E * nt * 2 N^2 floats each; at E = 128
// that is 320 MB per direction, about 0.1 ms of the card's memory rate,
// far below the chain. Both directions split the block into roles
// (imr_step.cuh's second part), as streamk_fwd and streamk_bwd do: helper
// warps copy each step's plane pair (2 N^2 floats, 2 KB at the flagship's
// N = 16) from global memory a step or two ahead of its use, so that the
// chain waits on no global load and passes no block-wide barrier (below, at
// stream_fwd and stream_bwd).

#include <cuda_runtime.h>

#include "imr_step.cuh"

// STREAMK_NC: the N of the compile-time instances stream_fwd<., 16> and
// stream_bwd<16, 512>, 16, as in streamk.cu (0 builds none and runs every N
// on the generic stream_fwd<., 0> and stream_bwd<0, .>: a build with
// -DSTREAMK_NC=0 times the two against each other).
#ifndef STREAMK_NC
#define STREAMK_NC 16
#endif

namespace {

struct Dims {
  int E, nt, B, N, iters, mode, store;
  float dt, a;
};

// named barriers after imr_step.cuh's BAR_STATE; the per-slot ones take
// id + slot
enum {
  BAR_H_FULL = 2,       // forward: helpers arrive, the chain waits
  BAR_H_FREE = 4,       // forward: the chain arrives, helpers wait
  BAR_STEP_READY = 2,   // backward: helpers arrive, the chain waits
  BAR_PAIRS_FULL = 4,   // backward: the chain arrives, helpers wait
};

// Floats of the forward's shared memory: per slot (two with helpers, one
// inline) the H planes, and the two (B, N) slots of the matvec inputs,
// which start on a 16-byte boundary where N is a multiple of 4.
__host__ __device__ inline size_t fwd_floats(int B, int N, bool split) {
  const size_t BN = (size_t)B * N, slots = split ? 2 : 1;
  return slots * 2 * N * (N + 1) + 4 * BN;
}

// Forward: planes H (E, nt, N, N) x2; x0 (B, N) shared by all candidates;
// rows: jacobi (d_r, d_i, minv_r, minv_i) or split (e_r, e_i), each (N,).
// Writes xT (E, B, N), with HIST the history (E, nt, B, N) and, with store,
// the stage iterates k_0..k_{iters-1} (E, nt, iters, B, N). Roles, as in
// streamk_fwd: the S = roundup32(B N) state threads run fwd_chain_step for
// t = 0, 1, ... and nothing else (x0 loaded before the loop; history and
// stored iterates are plain stores); the `helpers` threads after them copy
// H(u)'s plane pair into ring slot u & 1 (cp.async, strided over the
// helpers) one or two steps ahead. A chain step waits for H_FULL of its
// slot and gives the slot back on H_FREE as soon as it no longer reads it:
// at the compile-time N = 16 (NC; helpers only, at most 512 threads) right
// after it has read its row of H into registers, at NC = 0 (any N) at the
// end of the step. fwd_chain_step keeps apply_T's order of terms and, with
// PRE_RN, the one-block forward's rounding of the split rotation, so xT,
// the history and the stored iterates do not depend on the launch shape
// (either layout, either instance), and stream_bwd's replay reproduces the
// stored iterates. Inline branch (helpers 0): where the helpers or the
// second slot do not fit (1024 threads, 227 KB) the whole block copies
// H(t) into one slot around the chain of step t, two block-wide barriers
// per step. The launch bounds ask for one block per SM, as streamk_fwd's.
template <bool HIST, int NC>
__global__ void __launch_bounds__(NC > 0 ? 512 : 1024, 1)
stream_fwd(const float* __restrict__ gHr, const float* __restrict__ gHi,
           const float* __restrict__ x0r, const float* __restrict__ x0i,
           const float* __restrict__ rows, float* __restrict__ xTr,
           float* __restrict__ xTi, float* __restrict__ hr,
           float* __restrict__ hi, float* __restrict__ ksr,
           float* __restrict__ ksi, Dims d, int helpers) {
  extern __shared__ float sm[];
  const int N = NC ? NC : d.N, NN = N * N, BN = d.B * N;
  const int nt = d.nt, S = (BN + 31) & ~31, Hh = helpers;
  const int slots = Hh > 0 ? 2 : 1, ldH = N * (N + 1), Hsz = 2 * ldH;
  float* Hbuf = sm;                     // slots x (Hr, Hi)
  float* V = Hbuf + slots * Hsz;        // two (B, N) slots, re and im

  const int e = blockIdx.x, tid = threadIdx.x;
  const StepThread s = step_thread(d.B, N, d.iters, d.mode, d.dt, d.a, rows);
  const size_t base = (size_t)e * nt;
  const bool warp_rows = 32 % N == 0;
  float xr = 0.f, xi = 0.f;
  if (s.act) {
    xr = x0r[tid];
    xi = x0i[tid];
  }
  // H(u) into ring slot u & 1, entries e0, e0 + ne, ... of the pair
  auto copy = [&](int u, int e0, int ne) {
    float* H = Hbuf + (slots > 1 ? (u & 1) : 0) * Hsz;
    copy_planes<NC>(gHr + (base + u) * NN, gHi + (base + u) * NN, H,
                    H + ldH, N, e0, ne);
  };
  // the chain's step t on H(t) in Hr, Hi; its outputs are plain stores
  int p = 0;
  auto step = [&](int t, const HRow<NC>& h, const float* Hr, const float* Hi) {
    const size_t st = base + t, ko = st * d.iters * BN;
    fwd_chain_step<NC, true>(s, h, Hr, Hi, V, p,
                             d.store ? ksr + ko : nullptr,
                             d.store ? ksi + ko : nullptr, warp_rows, S, xr,
                             xi);
    if (HIST && s.act) {
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
        const bool reused = t + 2 < nt;   // the helpers copy H(t + 2) here
        bar_sync(BAR_H_FULL + sl, nall);
        HRow<NC> h;
        load_hrow<NC>(Hr, Hr + ldH, s.i, h);
        if (NC > 0 && reused) bar_arrive(BAR_H_FREE + sl, nall);
        step(t, h, Hr, Hr + ldH);
        if (NC == 0 && reused) bar_arrive(BAR_H_FREE + sl, nall);
      }
    } else {                  // the helpers, one or two steps ahead
      const int hh = tid - S;
      for (int u = 0; u < nt; ++u) {
        if (u >= 2) bar_sync(BAR_H_FREE + (u & 1), nall);
        copy(u, hh, Hh);
        cp_async_wait();
        bar_arrive(BAR_H_FULL + (u & 1), nall);
      }
    }
  } else if constexpr (NC == 0) {   // inline: every role in turn
    const HRow<0> h{};
    for (int t = 0; t < nt; ++t) {
      copy(t, tid, blockDim.x);
      cp_async_wait();
      __syncthreads();              // H(t) copied
      if (tid < S) step(t, h, Hbuf, Hbuf + ldH);
      __syncthreads();              // the chain is done with H(t)
    }
  }
  if (s.act) {
    xTr[(size_t)e * BN + tid] = xr;
    xTi[(size_t)e * BN + tid] = xi;
  }
}

// ---------------------------------------------------------------------------
// Backward. Roles, as in streamk_bwd: the state threads (the first
// S = roundup32(B N), one per (b, i) entry) run the dependent chain of each
// reversed step and nothing else (imr_step.cuh chain_step: the transposed
// stages and, without stored iterates, their replay in the forward's order
// of terms, so that stored and replayed iterates give the same bits). The
// helper threads after them (`helpers` of them, whole warps) run beside
// the chain what its recursion never reads:
//   * while the chain runs step t they copy H(t - 1)'s plane pair from
//     global memory into the free slot of a two-slot ring (cp.async, 4
//     bytes an entry into rows of stride N + 1, coalesced over the
//     helpers), a step ahead of its use;
//   * at the same time they reduce the (cotangent, input) pairs that step
//     t + 1 left in one slot of a two-slot ring into Hb(t + 1), a step
//     behind, from registers straight to the (E, nt, N, N) outputs (each
//     entry written once, no atomics: two launches give the same bits).
// The chain reads its step operands (the injection, the pre-state, the
// stored iterates) from registers it loaded a step ahead (load_ops); a
// stage synchronizes only the threads of one basis state (__syncwarp where
// N divides 32, else a named barrier over the state warps). The hand-offs
// are named barriers per ring slot (bar.arrive by the producer, bar.sync by
// the consumer): STEP_READY (H(t) copied and the pairs slot of step t + 2
// reduced) and PAIRS_FULL (step t's pairs written and H(t) read). No stage
// waits on a block-wide barrier or a global load. Every output of T and Tt
// is summed on one chain of FMAs in apply_T's and apply_Tt's order, and Hb
// in pair and row order (chain_step's and hb_part's ONE_CHAIN): replayed
// iterates have the bits of stored ones, and g0 and Hb do not depend on the
// launch shape (either layout, either instance). streamk_bwd's eight
// accumulators would move the 'stream' route's L-BFGS history off the
// streamK route's (tests/test_torch_cuda.py, 1e-5 of J). NC: N,
// where the kernel is compiled for it (16, the flagship's; helpers only,
// and a chain thread holds H's row for the replay and its column for the
// transposed stages in registers), or 0 for any N. C-bar and the stack
// cotangents come from Hb outside the kernel, by the planes einsum's
// backward (ops/stream.py).
// Inline branch: where the helpers or the second slots do not fit (1024
// threads, 227 KB) the launcher gives no helpers, and the whole block
// copies H(t - 1) and reduces Hb(t) after the chain of step t, on one slot
// of each: the same device functions and arithmetic, two block-wide
// barriers per step.

// Floats of the backward's shared memory: per slot (two with helpers, one
// inline) the H planes and the step's pairs. Every buffer starts on a
// 16-byte boundary where N is a multiple of 4.
__host__ __device__ inline size_t bwd_floats(int B, int N, int it,
                                             bool split) {
  const size_t BN = (size_t)B * N, slots = split ? 2 : 1;
  return slots * (2 * N * (N + 1) + (4 * it + 4) * BN);
}

// Backward: the steps in reverse. Inputs as the forward's plus the history
// (E, nt, B, N), its cotangent j (E, nt, B, N), the final-state cotangent
// gT (E, B, N) and, with store, the forward's stage iterates. Writes the x0
// cotangent per candidate g0 (E, B, N) and the plane cotangents Hb
// (E, nt, N, N) x2. helpers: the helper threads after the S state threads,
// 0 for the inline branch. MAXT: the most threads a launch may have (512 or
// 1024), which caps a thread's registers at 65536 / MAXT: at 1024 the
// generic instance spills (ptxas), so launches of at most 512 threads run
// one built for them.
template <int NC, int MAXT>
__global__ void __launch_bounds__(MAXT)
stream_bwd(const float* __restrict__ gHr, const float* __restrict__ gHi,
           const float* __restrict__ x0r, const float* __restrict__ x0i,
           const float* __restrict__ hr, const float* __restrict__ hi,
           const float* __restrict__ jr, const float* __restrict__ ji,
           const float* __restrict__ gTr, const float* __restrict__ gTi,
           const float* __restrict__ rows, const float* __restrict__ ksr,
           const float* __restrict__ ksi, float* __restrict__ g0r,
           float* __restrict__ g0i, float* __restrict__ Hbr,
           float* __restrict__ Hbi, Dims d, int helpers) {
  extern __shared__ float sm[];
  const int N = NC ? NC : d.N, NN = N * N, BN = d.B * N, it = d.iters;
  const int nt = d.nt, S = (BN + 31) & ~31, Hh = helpers;
  const int slots = Hh > 0 ? 2 : 1, ldH = N * (N + 1);
  const int Hsz = 2 * ldH, Psz = (4 * it + 4) * BN;
  float* Hbuf = sm;                     // slots x (Hr, Hi)
  float* Pbuf = Hbuf + slots * Hsz;     // slots x pairs

  const int e = blockIdx.x, tid = threadIdx.x;
  const StepThread s = step_thread(d.B, N, it, d.mode, d.dt, d.a, rows);
  const size_t base = (size_t)e * nt;
  const bool stored = d.store != 0, warp_rows = 32 % N == 0;
  const float* kr_ = stored ? ksr : nullptr;
  // H(u) into ring slot u & 1, entries e0, e0 + ne, ... of the pair
  auto copy = [&](int u, int e0, int ne) {
    float* H = Hbuf + (slots > 1 ? (u & 1) : 0) * Hsz;
    copy_planes<NC>(gHr + (base + u) * NN, gHi + (base + u) * NN, H,
                    H + ldH, N, e0, ne);
  };
  // Hb(u) from the pairs in slot sl, entries e0, e0 + ne, ...
  auto reduce = [&](int u, int sl, int e0, int ne) {
    hb_part<NC, true>(pairs_slot(Pbuf + sl * Psz, BN, it),
                      Hbr + (base + u) * NN, Hbi + (base + u) * NN, d.B, N,
                      it, e0, ne);
  };
  float gr = 0.f, gi = 0.f;
  StepOps cur = {}, nxt = {};
  if (s.act) {
    gr = gTr[(size_t)e * BN + tid];
    gi = gTi[(size_t)e * BN + tid];
  }
  if (tid < S && nt > 0)
    load_ops(s, nt - 1, base + nt - 1, x0r, x0i, hr, hi, jr, ji, kr_, ksi,
             cur);

  if (Hh > 0) {
    const int nall = S + Hh;
    if (tid < S) {            // the chain
      for (int t = nt - 1; t >= 0; --t) {
        const int sl = t & 1;
        bar_sync(BAR_STEP_READY + sl, nall);
        if (t > 0)
          load_ops(s, t - 1, base + t - 1, x0r, x0i, hr, hi, jr, ji, kr_, ksi,
                   nxt);
        chain_step<NC, true>(s, Hbuf + sl * Hsz, Hbuf + sl * Hsz + ldH,
                             pairs_slot(Pbuf + sl * Psz, BN, it), cur, stored,
                             warp_rows, S, gr, gi);
        bar_arrive(BAR_PAIRS_FULL + sl, nall);
        cur = nxt;
      }
    } else {                  // the helpers: H a step ahead, Hb a step behind
      const int h = tid - S;
      for (int u = nt - 1; u >= 0 && u >= nt - 2; --u) {
        copy(u, h, Hh);
        cp_async_wait();
        bar_arrive(BAR_STEP_READY + (u & 1), nall);
      }
      for (int t = nt - 1; t >= 0; --t) {
        const int sl = t & 1;
        bar_sync(BAR_PAIRS_FULL + sl, nall);
        if (t >= 2) copy(t - 2, h, Hh);   // into the slot step t released
        reduce(t, sl, h, Hh);
        cp_async_wait();
        if (t >= 2) bar_arrive(BAR_STEP_READY + sl, nall);
      }
    }
  } else if constexpr (NC == 0) {   // inline: every role in turn
    const int nb = blockDim.x;
    if (nt > 0) copy(nt - 1, tid, nb);
    cp_async_wait();
    for (int t = nt - 1; t >= 0; --t) {
      __syncthreads();              // H(t) copied; Hb(t + 1) reduced
      if (tid < S) {
        if (t > 0)
          load_ops(s, t - 1, base + t - 1, x0r, x0i, hr, hi, jr, ji, kr_, ksi,
                   nxt);
        chain_step<0, true>(s, Hbuf, Hbuf + ldH, pairs_slot(Pbuf, BN, it),
                            cur, stored, warp_rows, S, gr, gi);
        cur = nxt;
      }
      __syncthreads();              // step t's pairs written, H(t) read
      if (t > 0) copy(t - 1, tid, nb);
      reduce(t, 0, tid, nb);
      cp_async_wait();
    }
  }
  if (s.act) {
    g0r[(size_t)e * BN + tid] = gr;
    g0i[(size_t)e * BN + tid] = gi;
  }
}

// The roles go to helper warps when the caller's launch shape holds them:
// threads past the state warps and the two-slot layout's shared memory
// (floats(true) floats); else the inline branch, on floats(false). Returns
// the helper threads, or -1 for a shape that cannot take either.
template <typename Floats>
int helper_threads(const Dims& d, int threads, int smem_bytes,
                   Floats floats) {
  const int S = (d.B * d.N + 31) & ~31;
  const int helpers =
      threads > S && (size_t)smem_bytes >= 4 * floats(true) ? threads - S : 0;
  if (threads < S || threads % 32 != 0 || threads > 1024 ||
      (size_t)smem_bytes < 4 * floats(helpers > 0))
    return -1;
  return helpers;
}

template <typename Kernel>
int allow_smem(Kernel kernel, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

template <bool HIST>
int launch_fwd(const void* Hr, const void* Hi, const void* x0r,
               const void* x0i, const void* rows, void* xTr, void* xTi,
               void* hr, void* hi, void* ksr, void* ksi, const Dims& d,
               int threads, int smem_bytes, void* stream) {
  const int helpers = helper_threads(
      d, threads, smem_bytes,
      [&](bool split) { return fwd_floats(d.B, d.N, split); });
  if (helpers < 0) return (int)cudaErrorInvalidValue;
  auto kernel = STREAMK_NC > 0 && d.N == STREAMK_NC && helpers > 0 &&
                        threads <= 512
                    ? stream_fwd<HIST, STREAMK_NC>
                    : stream_fwd<HIST, 0>;
  if (const int err = allow_smem(kernel, smem_bytes)) return err;
  kernel<<<d.E, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)Hr, (const float*)Hi, (const float*)x0r,
      (const float*)x0i, (const float*)rows, (float*)xTr, (float*)xTi,
      (float*)hr, (float*)hi, (float*)ksr, (float*)ksi, d, helpers);
  return (int)cudaGetLastError();
}

int launch_bwd(const void* Hr, const void* Hi, const void* x0r,
               const void* x0i, const void* hr, const void* hi,
               const void* jr, const void* ji, const void* gTr,
               const void* gTi, const void* rows, const void* ksr,
               const void* ksi, void* g0r, void* g0i, void* Hbr, void* Hbi,
               const Dims& d, int threads, int smem_bytes, void* stream) {
  const int helpers = helper_threads(
      d, threads, smem_bytes,
      [&](bool split) { return bwd_floats(d.B, d.N, d.iters, split); });
  if (helpers < 0 || (d.store && d.iters > MAX_STORED))
    return (int)cudaErrorInvalidValue;
  auto kernel = threads > 512 ? stream_bwd<0, 1024>
                : STREAMK_NC > 0 && d.N == STREAMK_NC && helpers > 0
                    ? stream_bwd<STREAMK_NC, 512>
                    : stream_bwd<0, 512>;
  if (const int err = allow_smem(kernel, smem_bytes)) return err;
  kernel<<<d.E, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)Hr, (const float*)Hi, (const float*)x0r,
      (const float*)x0i, (const float*)hr, (const float*)hi,
      (const float*)jr, (const float*)ji, (const float*)gTr,
      (const float*)gTi, (const float*)rows, (const float*)ksr,
      (const float*)ksi, (float*)g0r, (float*)g0i, (float*)Hbr, (float*)Hbi,
      d, helpers);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound from Python with ctypes; one signature per
// direction for the three members. Each launches on the given stream and
// returns cudaGetLastError() (0 on success); a call outside the member's
// contract, or a backward launch shape that holds neither layout
// (helper_threads), returns cudaErrorInvalidValue and launches nothing.
#define FWD_ARGS                                                            \
  const void *Hr, const void *Hi, const void *x0r, const void *x0i,         \
      const void *rows, void *xTr, void *xTi, void *hr, void *hi,           \
      void *ksr, void *ksi, int E, int nt, int B, int N, int iters,         \
      int mode, int store, float dt, float a, int threads, int smem_bytes,  \
      void *stream
#define BWD_ARGS                                                            \
  const void *Hr, const void *Hi, const void *x0r, const void *x0i,         \
      const void *hr, const void *hi, const void *jr, const void *ji,       \
      const void *gTr, const void *gTi, const void *rows, const void *ksr,  \
      const void *ksi, void *g0r, void *g0i, void *Hbr, void *Hbi, int E,   \
      int nt, int B, int N, int iters, int mode, int store, float dt,       \
      float a, int threads, int smem_bytes, void *stream

extern "C" int stream_fwd_launch(FWD_ARGS) {
  const Dims d{E, nt, B, N, iters, mode, store, dt, a};
  return launch_fwd<true>(Hr, Hi, x0r, x0i, rows, xTr, xTi, hr, hi, ksr, ksi,
                          d, threads, smem_bytes, stream);
}

extern "C" int stream_bwd_launch(BWD_ARGS) {
  const Dims d{E, nt, B, N, iters, mode, store, dt, a};
  return launch_bwd(Hr, Hi, x0r, x0i, hr, hi, jr, ji, gTr, gTi, rows, ksr,
                    ksi, g0r, g0i, Hbr, Hbi, d, threads, smem_bytes, stream);
}

// B5: plain Neumann, the backward replays its stage iterates.
extern "C" int chunk_fwd_launch(FWD_ARGS) {
  if (mode != MODE_NEUMANN || store) return (int)cudaErrorInvalidValue;
  const Dims d{E, nt, B, N, iters, mode, 0, dt, a};
  return launch_fwd<true>(Hr, Hi, x0r, x0i, rows, xTr, xTi, hr, hi, ksr, ksi,
                          d, threads, smem_bytes, stream);
}

extern "C" int chunk_bwd_launch(BWD_ARGS) {
  if (mode != MODE_NEUMANN || store) return (int)cudaErrorInvalidValue;
  const Dims d{E, nt, B, N, iters, mode, 0, dt, a};
  return launch_bwd(Hr, Hi, x0r, x0i, hr, hi, jr, ji, gTr, gTi, rows, ksr,
                    ksi, g0r, g0i, Hbr, Hbi, d, threads, smem_bytes, stream);
}

// B6: plain Neumann forward, xT only (no history, nothing stored).
extern "C" int dense_fwd_launch(FWD_ARGS) {
  if (mode != MODE_NEUMANN || store || hr || hi || ksr || ksi)
    return (int)cudaErrorInvalidValue;
  const Dims d{E, nt, B, N, iters, mode, 0, dt, a};
  return launch_fwd<false>(Hr, Hi, x0r, x0i, rows, xTr, xTi, hr, hi, ksr,
                           ksi, d, threads, smem_bytes, stream);
}
