"""Time the streamK kernels' two instances against each other on one CUDA
card: streamk_fwd<16> / streamk_bwd<16>, compiled for N = 16 (the
launchers' pick at N = 16 with helper warps), and streamk_fwd<0> /
streamk_bwd<0>, which take any N, from one build of csrc/streamk.cu each
(the second with -DSTREAMK_NC=0, built beside the first). Shapes: the
closed CNOT flagship at E = 1 and E = 128 (split-3, stored iterates) and
open configuration 1 on the superop route (B = 16, dim 16, jacobi-8
replayed), as chip_smoke.py phases 6 and 16 build them. Each shape is
timed <16>, <0>, <0>, <16> with CUDA events, both directions, and the two
instances' outputs are compared. Prints one JSON line with the card's name
and power limit.

    python3 scripts/streamk_instances.py
"""

import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from quandary_tpu_torch.ops import cuda_build, streamk  # noqa: E402
from quandary_tpu_torch.problem import Problem  # noqa: E402


def build_generic():
    """csrc/streamk.cu built with no compile-time instance: every N runs
    streamk_fwd<0> and streamk_bwd<0>."""
    out = os.path.join(cuda_build.BUILD_DIR, "libstreamk_generic.so")
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    cmd = cuda_build.nvcc_command(streamk._SRC, out) + ["-DSTREAMK_NC=0"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(out)
    streamk._bind(lib)
    return lib, out


def max_rel_diff(a, b):
    return max(float((x - y).abs().max() / y.abs().max())
               for x, y in zip(a, b) if y is not None)


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        nc16 = pool.submit(streamk.build_kernels)
        generic = pool.submit(build_generic)
        nc16.result()
        libs = {"nc16": cuda_build.LIBS[streamk._SRC], "generic":
                generic.result()}

    to_card = lambda a: torch.as_tensor(a, device="cuda", dtype=torch.float32)
    prob = Problem(cs.flagship_setup())
    x = to_card(cs.bench_params(prob.setup.nparams))
    Ps = to_card(cs.bench_params(prob.setup.nparams, cs.E_BIG, seed=7))
    p4 = Problem(cs.OPEN_CONFIGS["cnot4"]())
    P1 = to_card(cs.bench_params(p4.setup.nparams))[None]
    shapes = {
        "flagship_E1": (prob, streamk.extend_coeffs(
            prob._plan, prob.coeff_rows_mid(x)[None, :, 0]), 20),
        f"flagship_E{cs.E_BIG}": (prob, streamk.extend_coeffs(
            prob._plan, prob.coeff_rows_mid(Ps)[:, :, 0]), 10),
        "open1": (p4, streamk.extend_coeffs(
            p4._plan, p4.coeff_rows_mid(P1)[..., 0, :]), 5),
    }
    report = {"card": smi}
    for name, (pr, C, reps) in shapes.items():
        plan, x0r, x0i = pr._plan, pr._x0r, pr._x0i
        B, N = x0r.shape
        times = {(w, k): [] for w in ("nc16", "generic")
                 for k in ("fwd", "bwd")}
        fwds, bwds = {}, {}
        for which in ("nc16", "generic", "generic", "nc16"):
            cuda_build.LIBS[streamk._SRC] = libs[which]
            ms = cs.kernel_ms(plan, x0r, x0i, C, reps, 0)
            for k in ("fwd", "bwd"):
                times[which, k].append(ms[k])
            fwds[which] = streamk._kernel_fwd(plan, x0r, x0i, C)
            ones_T = torch.ones_like(fwds[which][0])
            ones_h = torch.ones_like(fwds[which][2])
            bwds[which] = streamk._kernel_bwd(plan, x0r, x0i, C,
                                              *fwds[which][2:], ones_T,
                                              ones_T, ones_h, ones_h)
        torch.cuda.synchronize()
        report[name] = dict(
            B=B, N=N, E=C.shape[0], Ke=plan.Ke, iters=plan.iters,
            fwd_helpers=streamk._fwd_shape(plan.Ke, plan.iters, B, N)[2],
            bwd_helpers=streamk._bwd_shape(plan.Ke, plan.iters, B, N)[2],
            **{f"{k}_ms_{w}": v for (w, k), v in times.items()},
            fwd_max_rel_diff=max_rel_diff(fwds["generic"], fwds["nc16"]),
            bwd_max_rel_diff=max_rel_diff(bwds["generic"], bwds["nc16"]))
    cuda_build.LIBS[streamk._SRC] = libs["nc16"]
    print(json.dumps(report))


if __name__ == "__main__":
    main()
