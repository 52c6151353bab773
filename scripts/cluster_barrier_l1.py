"""What a barrier costs a kernel that rereads L1-resident data, on one CUDA
card: one cluster of G CTAs (256 threads each) loops 2000 times over an
optional read of 64 KB through the read-only path (__ldg, resident in L1
after the first pass) and one barrier, and the time per iteration is
timed with CUDA events. Barriers: __syncthreads, barrier.cluster (the
cooperative-groups cluster.sync(): arrive.release, wait.acquire), the same
with a relaxed arrive, and an mbarrier in shared memory awaited at CTA
scope and at cluster scope. It shows why csrc/rho.cu's backward exchanges
its operand through mbarriers awaited at CTA scope: an acquire at cluster
scope drops the SM's L1. Prints one JSON line with the card's name and
power limit.

    python3 scripts/cluster_barrier_l1.py
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from quandary_tpu_torch.ops import cuda_build  # noqa: E402

SRC = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__device__ void mbar_sync(unsigned long long* bar, int it, bool cluster) {
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}"
               ::"r"(b) : "memory");
  if (cluster)
    asm volatile("{\n .reg .pred P;\n W1_%=:\n mbarrier.try_wait.parity.acquire"
                 ".cluster.shared::cta.b64 P, [%0], %1;\n @!P bra W1_%=;\n}"
                 ::"r"(b), "r"(it & 1) : "memory");
  else
    asm volatile("{\n .reg .pred P;\n W2_%=:\n mbarrier.try_wait.parity"
                 ".shared::cta.b64 P, [%0], %1;\n @!P bra W2_%=;\n}"
                 ::"r"(b), "r"(it & 1) : "memory");
}

// kind: 0 __syncthreads, 1 cluster.sync(), 2 relaxed arrive + wait,
// 3 mbarrier at CTA scope, 4 mbarrier at cluster scope
__global__ void loop(const float* __restrict__ a, int n, int iters, int kind,
                     float* out) {
  __shared__ __align__(8) unsigned long long bar;
  cg::cluster_group cl = cg::this_cluster();
  if (threadIdx.x == 0)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 ::"r"((unsigned)__cvta_generic_to_shared(&bar)),
                 "r"((int)blockDim.x) : "memory");
  __syncthreads();
  float s = 0.f;
  for (int it = 0; it < iters; ++it) {
    for (int e = threadIdx.x; e < n; e += blockDim.x) s += __ldg(a + e);
    if (kind == 0) __syncthreads();
    else if (kind == 1) cl.sync();
    else if (kind == 2)
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
                   "barrier.cluster.wait.aligned;" ::: "memory");
    else mbar_sync(&bar, it, kind == 4);
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int run(const void* a, int n, int iters, int kind, void* out,
                   int G, void* stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(256);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, loop, (const float*)a, n, iters, kind,
                                 (float*)out);
}
"""

KINDS = ("syncthreads", "cluster_sync", "cluster_relaxed_arrive",
         "mbarrier_cta", "mbarrier_cluster")


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(cuda_build.BUILD_DIR, "cluster_barrier_l1.cu")
    lib_path = os.path.join(cuda_build.BUILD_DIR, "libcluster_barrier_l1.so")
    with open(src, "w") as f:
        f.write(SRC)
    res = subprocess.run(cuda_build.nvcc_command(src, lib_path),
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.run.argtypes, lib.run.restype = [p, i, i, i, p, i, p], i
    a = torch.randn(16384, device="cuda")       # 64 KB
    out = torch.empty(16 * 256, device="cuda")
    iters = 2000
    report = {"card": smi, "us_per_iteration": {}}
    for G in (1, 2, 8):
        for kind, name in enumerate(KINDS):
            for n in (0, a.numel()):
                def launch():
                    err = lib.run(a.data_ptr(), n, iters, kind,
                                  out.data_ptr(), G,
                                  torch.cuda.current_stream().cuda_stream)
                    if err != 0:
                        raise RuntimeError(f"launch failed: CUDA error {err}")
                launch()
                torch.cuda.synchronize()
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                launch()
                t1.record()
                torch.cuda.synchronize()
                key = f"G{G}_{name}" + ("_after_64KB_reads" if n else "")
                report["us_per_iteration"][key] = \
                    1e3 * t0.elapsed_time(t1) / iters
    print(json.dumps(report))


if __name__ == "__main__":
    main()
