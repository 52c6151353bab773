// What the two directions of the mid-size density-matrix pair share
// (csrc/rho_mid_fwd.cu, the forward; csrc/rho_mid.cu, the backward and its
// replay of the forward's stage chain): the launch's dimensions, the
// entrywise products and stage updates rounded as written, the mbarrier and
// cluster-barrier primitives, and the host side of a cluster launch.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "handoff.cuh"

namespace {

namespace cg = cooperative_groups;

enum { MODE_NEUMANN = 0, MODE_JACOBI = 1, MODE_SPLIT = 2 };

struct Dims {
  int E, nt, B, N, K, J, iters, mode, store;
  float dt, a;
};

// v <- p v, rounded as written.
__device__ __forceinline__ void cmul_rn(const float* __restrict__ pr,
                                        const float* __restrict__ pi, int o,
                                        float& vr, float& vi) {
  const float ar = pr[o], ai = pi[o];
  const float t = __fsub_rn(__fmul_rn(ar, vr), __fmul_rn(ai, vi));
  vi = __fadd_rn(__fmul_rn(ai, vr), __fmul_rn(ar, vi));
  vr = t;
}

// One stage update k <- solve step from m = T(k) and the stage's b, rounded
// as written: neumann k = b + a m; jacobi k = Minv (b + a (m - d k)).
__device__ __forceinline__ void stage_update_rn(
    bool jac, float a, float br, float bi, float mr, float mi, const float* e0,
    const float* e1, const float* e2, const float* e3, int o, float& kr,
    float& ki) {
  if (jac) {
    const float d_r = e0[o], d_i = e1[o];
    const float ur =
        __fsub_rn(mr, __fsub_rn(__fmul_rn(d_r, kr), __fmul_rn(d_i, ki)));
    const float ui =
        __fsub_rn(mi, __fadd_rn(__fmul_rn(d_r, ki), __fmul_rn(d_i, kr)));
    kr = __fadd_rn(br, __fmul_rn(a, ur));
    ki = __fadd_rn(bi, __fmul_rn(a, ui));
    cmul_rn(e2, e3, o, kr, ki);
  } else {
    kr = __fadd_rn(br, __fmul_rn(a, mr));
    ki = __fadd_rn(bi, __fmul_rn(a, mi));
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the same shared-memory address in CTA `rank` of the cluster
__device__ __forceinline__ unsigned mapa(unsigned addr, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void bar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::
          "r"(bar)
      : "memory");
}

// arrive, expecting tx more bytes of asynchronous copies on the phase
__device__ __forceinline__ void bar_arrive_tx(unsigned bar, unsigned tx) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, "
      "[%0], %1;\n}" ::"r"(bar),
      "r"(tx)
      : "memory");
}

// wait for the phase of the given parity to complete (acquire, CTA scope)
__device__ __forceinline__ void bar_wait(unsigned bar, int parity) {
  asm volatile(
      "{\n .reg .pred P;\n WAIT_%=:\n mbarrier.try_wait.parity.shared::cta.b64 "
      "P, [%0], %1;\n @!P bra WAIT_%=;\n}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// bar_wait, trapping past WAIT_LIMIT_NS (handoff.cuh)
__device__ __forceinline__ void bar_wait_bounded(unsigned bar, int parity) {
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

// arrive on a local mbarrier, expecting tx more bytes of pushes (tx > 0 on
// one thread only), and wait for the phase of the given parity to complete
__device__ __forceinline__ void bar_sync(unsigned bar, unsigned tx,
                                         int parity) {
  if (tx > 0)
    bar_arrive_tx(bar, tx);
  else
    bar_arrive(bar);
  bar_wait(bar, parity);
}

// the cluster barrier: every CTA's earlier stores (shared and device
// memory) are visible to all, and every CTA has finished its earlier reads
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

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
