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
// per-step H planes, the state and the stage iterates live in shared memory;
// one thread owns one (b, i) state entry and keeps its own b, k, x values in
// registers. Arithmetic is exact f32 FMA on the CUDA cores (the TPU kernel's
// default is a 3-pass bf16 emulation of f32 matmuls, pallas_stream.py:52-119;
// this one is more accurate, not less). No tensor cores: at N = 16 a
// complex matvec is 4 * N^2 * B = 4 kFLOP.
//
// What bounds it on the H100: neither bytes nor FLOPs. The CNOT flagship
// (N = 16, B = 4, ntime = 1221, split with 3 iterations) does about 40 MFLOP
// per forward sweep, under a microsecond of the card's f32 rate, and reads
// (ntime * Ke) coefficients. The bound is latency: a chain of
// ntime * (iters + 1) dependent matvecs, each followed by a block-wide
// barrier. The design keeps that chain on-chip (no global round trip per
// step, no per-step launch) and runs E candidates as E independent blocks,
// so a batch of up to one block per SM costs the same wall time as one.

#include <cuda_runtime.h>

#include "imr_step.cuh"

namespace {

// strideS, strideR: floats between two candidates' operator stacks
// (Ke * N * N) and solver rows (nrows * N); 0 when all candidates share one.
struct Dims {
  int E, nt, B, N, Ke, iters, mode, store;
  float dt, a;
  size_t strideS, strideR;
};

// H = sum_k c_k S_k into row-major planes with row stride N + 1 (the pad
// keeps both the row reads of T and the column reads of Tt conflict-free).
__device__ __forceinline__ void contract(const float* Sr, const float* Si,
                                         const float* __restrict__ c,
                                         float* Hr, float* Hi, int Ke,
                                         int N) {
  const int NN = N * N, ld = N + 1;
  for (int e = threadIdx.x; e < NN; e += blockDim.x) {
    float hr = 0.f, hi = 0.f;
    for (int k = 0; k < Ke; ++k) {
      const float ck = __ldg(c + k);
      hr = fmaf(ck, Sr[k * NN + e], hr);
      hi = fmaf(ck, Si[k * NN + e], hi);
    }
    const int p = e / N, q = e - p * N;
    Hr[p * ld + q] = hr;
    Hi[p * ld + q] = hi;
  }
}

}  // namespace

// Forward: x0 (B, N) shared by all candidates; C (E, nt, Ke); rows: jacobi
// (d_r, d_i, minv_r, minv_i) or split (e_r, e_i), each (N,). Block e reads
// the stack at gS + e * strideS and the rows at rows + e * strideR. Writes xT
// (E, B, N), hist (E, nt, B, N) and, with store, the stage iterates
// k_0..k_{iters-1} (E, nt, iters, B, N).
__global__ void __launch_bounds__(1024)
streamk_fwd(const float* __restrict__ gSr, const float* __restrict__ gSi,
            const float* __restrict__ C, const float* __restrict__ x0r,
            const float* __restrict__ x0i, const float* __restrict__ rows,
            float* __restrict__ xTr, float* __restrict__ xTi,
            float* __restrict__ hr, float* __restrict__ hi,
            float* __restrict__ ksr, float* __restrict__ ksi, Dims d) {
  extern __shared__ float sm[];
  const int N = d.N, NN = N * N, BN = d.B * N, Ke = d.Ke, iters = d.iters;
  float* Sr = sm;
  float* Si = Sr + Ke * NN;
  float* Hr = Si + Ke * NN;
  float* Hi = Hr + N * (N + 1);
  float* xs_r = Hi + N * (N + 1);
  float* xs_i = xs_r + BN;
  float* kb_r = xs_i + BN;
  float* kb_i = kb_r + (iters + 1) * BN;

  const int e = blockIdx.x, tid = threadIdx.x;
  gSr += (size_t)e * d.strideS;
  gSi += (size_t)e * d.strideS;
  rows += (size_t)e * d.strideR;
  for (int idx = tid; idx < Ke * NN; idx += blockDim.x) {
    Sr[idx] = gSr[idx];
    Si[idx] = gSi[idx];
  }
  const StepThread s = step_thread(d.B, N, iters, d.mode, d.dt, d.a, rows);
  float xr = 0.f, xi = 0.f;
  if (s.act) {
    xr = x0r[tid];
    xi = x0i[tid];
  }
  __syncthreads();

  for (int t = 0; t < d.nt; ++t) {
    const size_t st = (size_t)e * d.nt + t;
    contract(Sr, Si, C + st * Ke, Hr, Hi, Ke, N);
    const size_t ko = st * iters * BN;
    stage_fwd(s, Hr, Hi, xs_r, xs_i, kb_r, kb_i, d.store ? ksr + ko : nullptr,
              d.store ? ksi + ko : nullptr, xr, xi);
    if (s.act) {
      hr[st * BN + tid] = xr;
      hi[st * BN + tid] = xi;
    }
  }
  if (s.act) {
    xTr[(size_t)e * BN + tid] = xr;
    xTi[(size_t)e * BN + tid] = xi;
  }
}

// Backward: runs the steps in reverse. Inputs as the forward's plus the
// history (E, nt, B, N), its cotangent j (E, nt, B, N), the final-state
// cotangent gT (E, B, N) and, with store, the forward's stage iterates.
// Writes the x0 cotangent per candidate g0 (E, B, N) and the coefficient
// cotangents Cb (E, nt, Ke).
__global__ void __launch_bounds__(1024)
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
  const int N = d.N, NN = N * N, BN = d.B * N, Ke = d.Ke, iters = d.iters;
  float* Sr = sm;
  float* Si = Sr + Ke * NN;
  float* Hr = Si + Ke * NN;
  float* Hi = Hr + N * (N + 1);
  float* Hbr = Hi + N * (N + 1);
  float* Hbi = Hbr + NN;
  float* xp_r = Hbi + NN;
  float* xp_i = xp_r + BN;
  float* ks_r = xp_i + BN;                // k_0..k_{iters-1}
  float* ks_i = ks_r + iters * BN;
  float* cb_r = ks_i + iters * BN;        // cotangents of the iters+1 pairs
  float* cb_i = cb_r + (iters + 1) * BN;
  float* red = cb_i + (iters + 1) * BN;   // (nwarps, Ke)

  const int e = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  gSr += (size_t)e * d.strideS;
  gSi += (size_t)e * d.strideS;
  rows += (size_t)e * d.strideR;
  for (int idx = tid; idx < Ke * NN; idx += blockDim.x) {
    Sr[idx] = gSr[idx];
    Si[idx] = gSi[idx];
  }
  const StepThread s = step_thread(d.B, N, iters, d.mode, d.dt, d.a, rows);
  float gr = 0.f, gi = 0.f;
  if (s.act) {
    gr = gTr[(size_t)e * BN + tid];
    gi = gTi[(size_t)e * BN + tid];
  }
  __syncthreads();

  for (int t = d.nt - 1; t >= 0; --t) {
    const size_t st = (size_t)e * d.nt + t;
    contract(Sr, Si, C + st * Ke, Hr, Hi, Ke, N);
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

    // the step's H cotangent, then reduced against every stack slot
    for (int ent = tid; ent < NN; ent += blockDim.x) {
      float sr, si;
      hb_entry(s, ent, xp_r, xp_i, ks_r, ks_i, cb_r, cb_i, sr, si);
      Hbr[ent] = sr;
      Hbi[ent] = si;
    }
    for (int k = 0; k < Ke; ++k) {
      float v = 0.f;
      for (int ent = tid; ent < NN; ent += blockDim.x)
        v += Hbr[ent] * Sr[k * NN + ent] + Hbi[ent] * Si[k * NN + ent];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) red[warp * Ke + k] = v;
    }
    __syncthreads();
    if (tid < Ke) {
      float v = 0.f;
      for (int w = 0; w < nwarps; ++w) v += red[w * Ke + tid];
      Cb[st * Ke + tid] = v;
    }
  }
  if (s.act) {
    g0r[(size_t)e * BN + tid] = gr;
    g0i[(size_t)e * BN + tid] = gi;
  }
}

// Plain C entry points, bound from Python with ctypes. Each launches on the
// given stream and returns cudaGetLastError() (0 on success). The packed
// entry points take the per-candidate strides of the stacks and the solver
// rows; the plain ones run every candidate on one shared stack (stride 0).
namespace {

int launch_fwd(const void* Sr, const void* Si, const void* C, const void* x0r,
               const void* x0i, const void* rows, void* xTr, void* xTi,
               void* hr, void* hi, void* ksr, void* ksi, const Dims& d,
               int threads, int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024)
    cudaFuncSetAttribute(streamk_fwd,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
  streamk_fwd<<<d.E, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)Sr, (const float*)Si, (const float*)C,
      (const float*)x0r, (const float*)x0i, (const float*)rows,
      (float*)xTr, (float*)xTi, (float*)hr, (float*)hi, (float*)ksr,
      (float*)ksi, d);
  return (int)cudaGetLastError();
}

int launch_bwd(const void* Sr, const void* Si, const void* C, const void* x0r,
               const void* x0i, const void* hr, const void* hi,
               const void* jr, const void* ji, const void* gTr,
               const void* gTi, const void* rows, const void* ksr,
               const void* ksi, void* g0r, void* g0i, void* Cb, const Dims& d,
               int threads, int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024)
    cudaFuncSetAttribute(streamk_bwd,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
  streamk_bwd<<<d.E, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)Sr, (const float*)Si, (const float*)C,
      (const float*)x0r, (const float*)x0i, (const float*)hr,
      (const float*)hi, (const float*)jr, (const float*)ji,
      (const float*)gTr, (const float*)gTi, (const float*)rows,
      (const float*)ksr, (const float*)ksi, (float*)g0r, (float*)g0i,
      (float*)Cb, d);
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
