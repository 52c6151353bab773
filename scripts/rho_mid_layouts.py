"""Where the whole factor of a band product should live, for the mid-size
density-matrix kernels (csrc/rho_mid.cu), on one CUDA card.

Past N = 64 one CTA holds one whole (N, N) complex pair beside its bands,
so of the two factors a band of T(v) = M v + v M^dag + sum_l (L_l v) L_l^dag
needs whole (v for M v and every L_l v, M for v M^dag; Tt needs M in both of
its M products), one must be read from elsewhere:

(a) v whole in every CTA, M in device-memory scratch served by L2: per T
    the forward reads M from L2 in its two M products (one as the factor
    along the lanes, one as the broadcast factor), the backward likewise;
(b) M whole in every CTA, v in its owners' shared memory: per T the 1 + J
    products with v as the right factor read it through distributed shared
    memory (or copy it there k-tile by k-tile first, which moves the same
    bytes as (a)'s exchange of v plus a barrier per tile).

The kernel here times one complex band product Z = X Y of (a) and (b)'s
shape, X a band of rows in shared memory, on 3 clusters of 16 CTAs (the
qudits125 launch: 3 density matrices), 2 x 2 entries per thread as in
csrc/rho_mid.cu, with the whole factor Y read from: this CTA's shared
memory (local, what neither layout has); device memory through L2
(ld.global.cg, layout (a)); the owners' shared memory through distributed
shared memory (ld.shared::cluster, layout (b)); and, for (a)'s broadcast
product, X from L2 with Y local. It prints one JSON line with the card's
name and power limit, us per product for each source at N = 96 and 128,
and what each layout adds to a T with J jump operators over the local
product: (a) the two L2 products, (b) 1 + J distributed products.

    python3 scripts/rho_mid_layouts.py
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

// SRC 0: Y whole in this CTA's shared memory; 1: Y in device memory through
// L2; 2: Y's row band q in CTA q's shared memory, read through distributed
// shared memory; 3: X (the broadcast factor) in device memory through L2,
// Y whole in shared memory
template <int SRC>
__global__ void prod(const float* __restrict__ g, float* out, int N, int G,
                     int reps) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int ld = N | 1, NN = N * N, rank = (int)cl.block_rank();
  const int R = N / G, r0 = rank * R;
  float* X = sm;                    // the band, R x ld, (re, im)
  float* Y = X + 2 * R * ld;        // whole (SRC 0, 3) or the own band (2)
  const int ry = SRC == 2 ? R : N, y0 = SRC == 2 ? r0 : 0;
  for (int e = threadIdx.x; e < R * N; e += blockDim.x) {
    const int p = e / N, q = e - p * N;
    X[p * ld + q] = g[(r0 + p) * N + q];
    X[R * ld + p * ld + q] = g[NN + (r0 + p) * N + q];
  }
  for (int e = threadIdx.x; e < ry * N; e += blockDim.x) {
    const int p = e / N, q = e - p * N;
    Y[p * ld + q] = g[(y0 + p) * N + q];
    Y[ry * ld + p * ld + q] = g[NN + (y0 + p) * N + q];
  }
  cl.sync();
  const int nrt = (R + 1) / 2, nct = (N + 1) / 2;
  const int tr = threadIdx.x / nct, tc = threadIdx.x - tr * nct;
  int r[2], c[2];
  for (int a = 0; a < 2; ++a) {
    r[a] = min(tr + a * nrt, R - 1);
    c[a] = min(tc + a * nct, N - 1);
  }
  const unsigned ybase = (unsigned)__cvta_generic_to_shared(Y);
  float zr[2][2] = {}, zi[2][2] = {};
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll 8
    for (int j = 0; j < N; ++j) {
      float xr[2], xi[2], yr[2], yi[2];
      for (int a = 0; a < 2; ++a) {
        if (SRC == 3) {
          xr[a] = __ldcg(g + (r0 + r[a]) * N + j);
          xi[a] = __ldcg(g + NN + (r0 + r[a]) * N + j);
        } else {
          xr[a] = X[r[a] * ld + j];
          xi[a] = X[R * ld + r[a] * ld + j];
        }
      }
      for (int b = 0; b < 2; ++b) {
        if (SRC == 1) {
          yr[b] = __ldcg(g + j * N + c[b]);
          yi[b] = __ldcg(g + NN + j * N + c[b]);
        } else if (SRC == 2) {
          const int q = j / R;
          unsigned a0, a1;
          const unsigned o = ybase + 4u * ((j - q * R) * ld + c[b]);
          asm("mapa.shared::cluster.u32 %0, %1, %2;"
              : "=r"(a0) : "r"(o), "r"(q));
          asm("mapa.shared::cluster.u32 %0, %1, %2;"
              : "=r"(a1) : "r"(o + 4u * R * ld), "r"(q));
          asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(yr[b])
                       : "r"(a0));
          asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(yi[b])
                       : "r"(a1));
        } else {
          yr[b] = Y[j * ld + c[b]];
          yi[b] = Y[ry * ld + j * ld + c[b]];
        }
      }
      for (int a = 0; a < 2; ++a)
        for (int b = 0; b < 2; ++b) {
          zr[a][b] = fmaf(xr[a], yr[b], zr[a][b]);
          zr[a][b] = fmaf(-xi[a], yi[b], zr[a][b]);
          zi[a][b] = fmaf(xr[a], yi[b], zi[a][b]);
          zi[a][b] = fmaf(xi[a], yr[b], zi[a][b]);
        }
    }
  }
  float s = 0.f;
  for (int a = 0; a < 2; ++a)
    for (int b = 0; b < 2; ++b) s += zr[a][b] + zi[a][b];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  cl.sync();            // no CTA leaves while another may still read it
}

template <int SRC>
int launch(const float* g, float* out, int N, int G, int clusters,
           int threads, int reps, cudaStream_t stream) {
  const int ld = N | 1, R = N / G;
  const int smem = 4 * (2 * R * ld + 2 * (SRC == 2 ? R : N) * ld);
  cudaFuncSetAttribute(prod<SRC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaFuncSetAttribute(prod<SRC>,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * G);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, prod<SRC>, g, out, N, G, reps);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

extern "C" int run(int src, const void* g, void* out, int N, int G,
                   int clusters, int threads, int reps, void* stream) {
  const float* gp = (const float*)g;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (src) {
    case 0: return launch<0>(gp, o, N, G, clusters, threads, reps, s);
    case 1: return launch<1>(gp, o, N, G, clusters, threads, reps, s);
    case 2: return launch<2>(gp, o, N, G, clusters, threads, reps, s);
    case 3: return launch<3>(gp, o, N, G, clusters, threads, reps, s);
  }
  return (int)cudaErrorInvalidValue;
}
"""

SOURCES = ("local", "l2", "dsmem", "l2_broadcast")
G, CLUSTERS, REPS = 16, 3, 100
JUMPS = {96: 4, 128: 6}     # qudits128's J = 4, qudits125's J = 6


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(cuda_build.BUILD_DIR, "rho_mid_layouts.cu")
    lib_path = os.path.join(cuda_build.BUILD_DIR, "librho_mid_layouts.so")
    with open(src, "w") as f:
        f.write(SRC)
    res = subprocess.run(cuda_build.nvcc_command(src, lib_path),
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.run.argtypes, lib.run.restype = [i, p, p] + [i] * 5 + [p], i
    report = {"card": smi, "G": G, "clusters": CLUSTERS,
              "us_per_product": {}, "us_added_per_T": {}}
    for N in (96, 128):
        g = torch.randn(2, N, N, device="cuda") / N
        threads = 32 * -(-((N // G + 1) // 2 * ((N + 1) // 2)) // 32)
        out = torch.empty(CLUSTERS * G * threads, device="cuda")
        us = {}
        for k, name in enumerate(SOURCES):
            def launch():
                err = lib.run(k, g.data_ptr(), out.data_ptr(), N, G,
                              CLUSTERS, threads, REPS,
                              torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            launch()
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(5):
                launch()
            t1.record()
            torch.cuda.synchronize()
            us[name] = 1e3 * t0.elapsed_time(t1) / (5 * REPS)
        report["us_per_product"][f"N{N}"] = us
        report["us_added_per_T"][f"N{N}_J{JUMPS[N]}"] = {
            "a_M_in_L2": (us["l2"] - us["local"])
            + (us["l2_broadcast"] - us["local"]),
            "b_v_in_dsmem": (1 + JUMPS[N]) * (us["dsmem"] - us["local"])}
    print(json.dumps(report))


if __name__ == "__main__":
    main()
