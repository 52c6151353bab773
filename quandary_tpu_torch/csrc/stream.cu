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
// the step's plane pair, the state and the stage iterates in shared memory
// (row stride N + 1); one thread owns one (b, i) state entry. Exact f32 FMA on the CUDA cores (the TPU stream
// kernel defaults to a 3-pass bf16 emulation, pallas_stream.py:52-119; the
// chunk and dense kernels run f32 HIGHEST). The backward keeps a thread's
// entries of Hb(t) in registers over the step's (cotangent, input) pairs and
// writes them once, coalesced, to the (E, nt, N, N) outputs.
//
// What bounds it on the H100: the dependent chain of ntime * (iters + 1)
// barrier-separated matvecs, as for streamK, plus one global-memory round
// trip per step for the plane pair (2 N^2 floats, 2 KB at the flagship's
// N = 16), which this first version does not prefetch. Bytes: the planes
// are read once forward and once backward and Hb written once, E * nt *
// 2 N^2 floats each; at E = 128 that is 320 MB per direction, about 0.1 ms
// of the card's memory rate, far below the chain.

#include <cuda_runtime.h>

#include "imr_step.cuh"

namespace {

struct Dims {
  int E, nt, B, N, iters, mode, store;
  float dt, a;
};

// One step's (N, N) plane pair, row-major in global memory, into shared
// memory with row stride N + 1.
__device__ __forceinline__ void load_planes(const float* __restrict__ gr,
                                            const float* __restrict__ gi,
                                            float* Hr, float* Hi, int N) {
  const int NN = N * N, ld = N + 1;
  for (int e = threadIdx.x; e < NN; e += blockDim.x) {
    const int p = e / N, q = e - p * N;
    Hr[p * ld + q] = __ldg(gr + e);
    Hi[p * ld + q] = __ldg(gi + e);
  }
}

// Forward: planes H (E, nt, N, N) x2; x0 (B, N) shared by all candidates;
// rows: jacobi (d_r, d_i, minv_r, minv_i) or split (e_r, e_i), each (N,).
// Writes xT (E, B, N), with HIST the history (E, nt, B, N) and, with store,
// the stage iterates k_0..k_{iters-1} (E, nt, iters, B, N).
template <bool HIST>
__global__ void __launch_bounds__(1024)
stream_fwd(const float* __restrict__ gHr, const float* __restrict__ gHi,
           const float* __restrict__ x0r, const float* __restrict__ x0i,
           const float* __restrict__ rows, float* __restrict__ xTr,
           float* __restrict__ xTi, float* __restrict__ hr,
           float* __restrict__ hi, float* __restrict__ ksr,
           float* __restrict__ ksi, Dims d) {
  extern __shared__ float sm[];
  const int N = d.N, NN = N * N, BN = d.B * N, iters = d.iters;
  float* Hr = sm;
  float* Hi = Hr + N * (N + 1);
  float* xs_r = Hi + N * (N + 1);
  float* xs_i = xs_r + BN;
  float* kb_r = xs_i + BN;
  float* kb_i = kb_r + (iters + 1) * BN;

  const int e = blockIdx.x, tid = threadIdx.x;
  const StepThread s = step_thread(d.B, N, iters, d.mode, d.dt, d.a, rows);
  float xr = 0.f, xi = 0.f;
  if (s.act) {
    xr = x0r[tid];
    xi = x0i[tid];
  }

  for (int t = 0; t < d.nt; ++t) {
    const size_t st = (size_t)e * d.nt + t;
    load_planes(gHr + st * NN, gHi + st * NN, Hr, Hi, N);
    const size_t ko = st * iters * BN;
    stage_fwd(s, Hr, Hi, xs_r, xs_i, kb_r, kb_i, d.store ? ksr + ko : nullptr,
              d.store ? ksi + ko : nullptr, xr, xi);
    if (HIST && s.act) {
      hr[st * BN + tid] = xr;
      hi[st * BN + tid] = xi;
    }
  }
  if (s.act) {
    xTr[(size_t)e * BN + tid] = xr;
    xTi[(size_t)e * BN + tid] = xi;
  }
}

// Backward: the steps in reverse. Inputs as the forward's plus the history
// (E, nt, B, N), its cotangent j (E, nt, B, N), the final-state cotangent
// gT (E, B, N) and, with store, the forward's stage iterates. Writes the x0
// cotangent per candidate g0 (E, B, N) and the plane cotangents Hb
// (E, nt, N, N) x2 (hb_entry).
__global__ void __launch_bounds__(1024)
stream_bwd(const float* __restrict__ gHr, const float* __restrict__ gHi,
           const float* __restrict__ x0r, const float* __restrict__ x0i,
           const float* __restrict__ hr, const float* __restrict__ hi,
           const float* __restrict__ jr, const float* __restrict__ ji,
           const float* __restrict__ gTr, const float* __restrict__ gTi,
           const float* __restrict__ rows, const float* __restrict__ ksr,
           const float* __restrict__ ksi, float* __restrict__ g0r,
           float* __restrict__ g0i, float* __restrict__ Hbr,
           float* __restrict__ Hbi, Dims d) {
  extern __shared__ float sm[];
  const int N = d.N, NN = N * N, BN = d.B * N, iters = d.iters;
  float* Hr = sm;
  float* Hi = Hr + N * (N + 1);
  float* xp_r = Hi + N * (N + 1);
  float* xp_i = xp_r + BN;
  float* ks_r = xp_i + BN;                // k_0..k_{iters-1}
  float* ks_i = ks_r + iters * BN;
  float* cb_r = ks_i + iters * BN;        // cotangents of the iters+1 pairs
  float* cb_i = cb_r + (iters + 1) * BN;

  const int e = blockIdx.x, tid = threadIdx.x;
  const StepThread s = step_thread(d.B, N, iters, d.mode, d.dt, d.a, rows);
  float gr = 0.f, gi = 0.f;
  if (s.act) {
    gr = gTr[(size_t)e * BN + tid];
    gi = gTi[(size_t)e * BN + tid];
  }

  for (int t = d.nt - 1; t >= 0; --t) {
    const size_t st = (size_t)e * d.nt + t;
    load_planes(gHr + st * NN, gHi + st * NN, Hr, Hi, N);
    float xr = 0.f, xi = 0.f;
    if (s.act) {
      gr += jr[st * BN + tid];
      gi += ji[st * BN + tid];
      // pre-step state: x0 at t = 0, else the previous history entry
      xr = t == 0 ? x0r[tid] : hr[(st - 1) * BN + tid];
      xi = t == 0 ? x0i[tid] : hi[(st - 1) * BN + tid];
    }
    const size_t ko = st * iters * BN;
    stage_bwd(s, Hr, Hi, xr, xi, d.store ? ksr + ko : nullptr,
              d.store ? ksi + ko : nullptr, xp_r, xp_i, ks_r, ks_i, cb_r,
              cb_i, gr, gi);
    // the step's plane cotangent, summed over the pairs in registers and
    // written once
    for (int ent = tid; ent < NN; ent += blockDim.x) {
      float sr, si;
      hb_entry(s, ent, xp_r, xp_i, ks_r, ks_i, cb_r, cb_i, sr, si);
      Hbr[st * NN + ent] = sr;
      Hbi[st * NN + ent] = si;
    }
    __syncthreads();    // the next step overwrites H, xp, ks and cb
  }
  if (s.act) {
    g0r[(size_t)e * BN + tid] = gr;
    g0i[(size_t)e * BN + tid] = gi;
  }
}

template <bool HIST>
int launch_fwd(const void* Hr, const void* Hi, const void* x0r,
               const void* x0i, const void* rows, void* xTr, void* xTi,
               void* hr, void* hi, void* ksr, void* ksi, const Dims& d,
               int threads, int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stream_fwd<HIST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  stream_fwd<HIST><<<d.E, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)Hr, (const float*)Hi, (const float*)x0r,
      (const float*)x0i, (const float*)rows, (float*)xTr, (float*)xTi,
      (float*)hr, (float*)hi, (float*)ksr, (float*)ksi, d);
  return (int)cudaGetLastError();
}

int launch_bwd(const void* Hr, const void* Hi, const void* x0r,
               const void* x0i, const void* hr, const void* hi,
               const void* jr, const void* ji, const void* gTr,
               const void* gTi, const void* rows, const void* ksr,
               const void* ksi, void* g0r, void* g0i, void* Hbr, void* Hbi,
               const Dims& d, int threads, int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stream_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  stream_bwd<<<d.E, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)Hr, (const float*)Hi, (const float*)x0r,
      (const float*)x0i, (const float*)hr, (const float*)hi,
      (const float*)jr, (const float*)ji, (const float*)gTr,
      (const float*)gTi, (const float*)rows, (const float*)ksr,
      (const float*)ksi, (float*)g0r, (float*)g0i, (float*)Hbr, (float*)Hbi,
      d);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound from Python with ctypes; one signature per
// direction for the three members. Each launches on the given stream and
// returns cudaGetLastError() (0 on success); a call outside the member's
// contract returns cudaErrorInvalidValue and launches nothing.
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
