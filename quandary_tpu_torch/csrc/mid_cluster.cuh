// The band arithmetic of a thread-block cluster that shares the state
// vectors of one (candidate, chunk of basis states) among its CTAs, each
// CTA on a band of the entries: shared by the mid-size kernel pairs
// csrc/streamk_mid.cu and csrc/stream_mid.cu. A warp forms a band row's
// products with the BC whole operand vectors (rows_dot), the row's owner
// lane runs the stage update of its entry (mid_first, mid_next) and pushes
// the result into every CTA's copy of the next operand (push); the host
// side sets a launch up as clusters of G CTAs (cluster_config) and asks the
// card how many it holds (max_clusters). stream_mid_fwd exchanges on
// mbarriers instead of cluster barriers: rows_dot_all (a row's owner lanes,
// then every lane), st_async2 and the mb_* primitives, bulk_g2s and
// cp_async_arrive for its band copies. For hand-offs between CTAs through
// device memory (streamk_mid_bwd's 'helpers' schedule): rows_dot_l2 and
// cp_async16_l2, with the counters of handoff.cuh.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "handoff.cuh"
#include "imr_step.cuh"

namespace {

namespace cg = cooperative_groups;

// For the rows il = warp, warp + nwarps, ... < nr of a band matrix M (re at
// Mr, im at Mi, row stride ld) and the BC whole vectors v (re at Vr + b N,
// im at Vi + b N): s_b = sum_j m_j v_j (CONJ: conj(m_j) v_j). The lanes
// stride j, each product on its own accumulator; a butterfly of shuffles
// gives every lane the same sums, and lane b < BC calls f(il, b, s_r, s_i).
template <int BC, bool CONJ, typename F>
__device__ __forceinline__ void rows_dot(const float* Mr, const float* Mi,
                                         int ld, int nr, const float* Vr,
                                         const float* Vi, int N, int warp,
                                         int nwarps, int lane, F f) {
  for (int il = warp; il < nr; il += nwarps) {
    const float* mr = Mr + (size_t)il * ld;
    const float* mi = Mi + (size_t)il * ld;
    float a[BC][4];
#pragma unroll
    for (int b = 0; b < BC; ++b) a[b][0] = a[b][1] = a[b][2] = a[b][3] = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float hr = mr[j], hi = mi[j];
#pragma unroll
      for (int b = 0; b < BC; ++b) {
        const float vr = Vr[b * N + j], vi = Vi[b * N + j];
        a[b][0] = fmaf(hr, vr, a[b][0]);
        a[b][1] = fmaf(CONJ ? hi : -hi, vi, a[b][1]);
        a[b][2] = fmaf(hr, vi, a[b][2]);
        a[b][3] = fmaf(CONJ ? -hi : hi, vr, a[b][3]);
      }
    }
#pragma unroll
    for (int b = 0; b < BC; ++b) {
      float sr = a[b][0] + a[b][1], si = a[b][2] + a[b][3];
      for (int o = 16; o > 0; o >>= 1) {
        sr += __shfl_xor_sync(0xffffffffu, sr, o);
        si += __shfl_xor_sync(0xffffffffu, si, o);
      }
      if (lane == b) f(il, b, sr, si);
    }
  }
}

// The stage updates of one entry (imr_step.cuh's stage_first, stage_next)
// with its solver rows in the band array rw (4 x R): jacobi (d, minv),
// split (e).
__device__ __forceinline__ void mid_first(bool jac, const float* rw, int R,
                                          int il, float br, float bi,
                                          float& kr, float& ki) {
  kr = br;
  ki = bi;
  if (jac) cmul(rw[2 * R + il], rw[3 * R + il], kr, ki);
}

__device__ __forceinline__ void mid_next(bool jac, float a, const float* rw,
                                         int R, int il, float br, float bi,
                                         float mr, float mi, float& kr,
                                         float& ki) {
  if (jac) {
    const float r0 = rw[il], r1 = rw[R + il];
    const float ur = mr - (r0 * kr - r1 * ki);
    const float ui = mi - (r0 * ki + r1 * kr);
    kr = br + a * ur;
    ki = bi + a * ui;
    cmul(rw[2 * R + il], rw[3 * R + il], kr, ki);
  } else {
    kr = br + a * mr;
    ki = bi + a * mi;
  }
}

// rows_dot on a band that other SMs wrote during the launch (a ring in
// device memory): the same products in the same order, each entry of M read
// from L2 (ld.global.cg), never from an SM's L1, which may hold a line of
// the ring from before the writer's release.
template <int BC, bool CONJ, typename F>
__device__ __forceinline__ void rows_dot_l2(const float* Mr, const float* Mi,
                                            int ld, int nr, const float* Vr,
                                            const float* Vi, int N, int warp,
                                            int nwarps, int lane, F f) {
  for (int il = warp; il < nr; il += nwarps) {
    const float* mr = Mr + (size_t)il * ld;
    const float* mi = Mi + (size_t)il * ld;
    float a[BC][4];
#pragma unroll
    for (int b = 0; b < BC; ++b) a[b][0] = a[b][1] = a[b][2] = a[b][3] = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float hr = __ldcg(mr + j), hi = __ldcg(mi + j);
#pragma unroll
      for (int b = 0; b < BC; ++b) {
        const float vr = Vr[b * N + j], vi = Vi[b * N + j];
        a[b][0] = fmaf(hr, vr, a[b][0]);
        a[b][1] = fmaf(CONJ ? hi : -hi, vi, a[b][1]);
        a[b][2] = fmaf(hr, vi, a[b][2]);
        a[b][3] = fmaf(CONJ ? -hi : hi, vr, a[b][3]);
      }
    }
#pragma unroll
    for (int b = 0; b < BC; ++b) {
      float sr = a[b][0] + a[b][1], si = a[b][2] + a[b][3];
      for (int o = 16; o > 0; o >>= 1) {
        sr += __shfl_xor_sync(0xffffffffu, sr, o);
        si += __shfl_xor_sync(0xffffffffu, si, o);
      }
      if (lane == b) f(il, b, sr, si);
    }
  }
}

// An entry into the same place of every CTA's copy of an operand buffer
// (its own included), through distributed shared memory.
__device__ __forceinline__ void push(const cg::cluster_group& cl, float* dst,
                                     float v, int G) {
  for (int q = 0; q < G; ++q) *cl.map_shared_rank(dst, q) = v;
}

// rows_dot on a band whose rows need not lie in one array (row(il, mr, mi)
// gives row il's re and im), with the BC vectors interleaved (v_b at
// V + b N, re and im side by side): the same products in the same order,
// lane b < BC calls g(il, b, s_r, s_i) as rows_dot calls f, and then every
// lane calls f(il) (after g's writes, which it may read from shared
// memory). A warp takes RP of its rows at a time (each entry of v loaded
// once for them), and a lane loads its entries of M DOT_BATCH / RP at a
// time before their products, so that many loads are in flight (a row read
// from L2 waits on them).
constexpr int DOT_BATCH = 8;

template <int BC, int RP, typename Row, typename G, typename F>
__device__ __forceinline__ void rows_dot_all(Row row, int nr, const float2* V,
                                             int N, int warp, int nwarps,
                                             int lane, G g, F f) {
  constexpr int U = DOT_BATCH / RP;
  for (int il0 = warp; il0 < nr; il0 += RP * nwarps) {
    const float *mr[RP], *mi[RP];
#pragma unroll
    for (int p = 0; p < RP; ++p)
      row(il0 + p * nwarps < nr ? il0 + p * nwarps : il0, mr[p], mi[p]);
    float a[RP][BC][4];
#pragma unroll
    for (int p = 0; p < RP; ++p)
#pragma unroll
      for (int b = 0; b < BC; ++b)
        a[p][b][0] = a[p][b][1] = a[p][b][2] = a[p][b][3] = 0.f;
    for (int j0 = lane; j0 < N; j0 += 32 * U) {
      float hr[RP][U], hi[RP][U];
#pragma unroll
      for (int p = 0; p < RP; ++p)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + 32 * u;
          hr[p][u] = j < N ? mr[p][j] : 0.f;
          hi[p][u] = j < N ? mi[p][j] : 0.f;
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + 32 * u;
        if (j >= N) break;
#pragma unroll
        for (int b = 0; b < BC; ++b) {
          const float2 v = V[b * N + j];
#pragma unroll
          for (int p = 0; p < RP; ++p) {
            a[p][b][0] = fmaf(hr[p][u], v.x, a[p][b][0]);
            a[p][b][1] = fmaf(-hi[p][u], v.y, a[p][b][1]);
            a[p][b][2] = fmaf(hr[p][u], v.y, a[p][b][2]);
            a[p][b][3] = fmaf(hi[p][u], v.x, a[p][b][3]);
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < RP; ++p) {
      const int il = il0 + p * nwarps;
      if (il >= nr) break;
#pragma unroll
      for (int b = 0; b < BC; ++b) {
        float sr = a[p][b][0] + a[p][b][1], si = a[p][b][2] + a[p][b][3];
        for (int o = 16; o > 0; o >>= 1) {
          sr += __shfl_xor_sync(0xffffffffu, sr, o);
          si += __shfl_xor_sync(0xffffffffu, si, o);
        }
        if (lane == b) g(il, b, sr, si);
      }
      __syncwarp();
      f(il);
    }
  }
}

// mbarriers in shared memory and what completes on them (stream_mid_fwd's
// exchange and band copies): a CTA's own address of a shared object, the
// same address in CTA `rank` of the cluster, init, arrive (with expected
// bytes of asynchronous writes), and a CTA-scope wait for a phase that
// traps past WAIT_LIMIT_NS (handoff.cuh).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned rank_addr(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mb_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mb_arrive(unsigned bar, unsigned tx) {
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
}

__device__ __forceinline__ void mb_wait(unsigned bar, int parity) {
  unsigned long long t0 = 0;
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred P;\n mbarrier.try_wait.parity.shared::cta.b64 P, "
        "[%1], %2;\n selp.u32 %0, 1, 0, P;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = global_ns();
    else if (global_ns() - t0 > WAIT_LIMIT_NS)
      __trap();
  }
}

// (re, im) into another CTA's shared memory (dst, bar: cluster addresses,
// rank_addr), counting its 8 bytes on that CTA's mbarrier
__device__ __forceinline__ void st_async2(unsigned dst, float re, float im,
                                          unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];" ::"r"(dst),
      "f"(re), "f"(im), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from device memory
// into this CTA's shared memory by the bulk-copy engine, counted on bar
__device__ __forceinline__ void bulk_g2s(unsigned dst, const float* src,
                                         unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// an arrival on bar once the thread's earlier cp.async copies have landed
// (the pending count raised by one first: no net arrival)
__device__ __forceinline__ void cp_async_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(bar)
               : "memory");
}

// 16 bytes from L2 (not L1) into shared memory by cp.async; cp_async_wait
// (imr_step.cuh) waits for them with the thread's other copies.
__device__ __forceinline__ void cp_async16_l2(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

// The launch configuration of `clusters` clusters of G CTAs of `kernel`,
// with the kernel's attributes for its shared memory and, for G > 8, for a
// cluster beyond the portable size (as csrc/rho.cu's).
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

}  // namespace
