"""Time variants of csrc/rho.cu against the source as it is, on one CUDA
card: each variant is the source with a few lines replaced (below), built
into its own library, and both kernels are timed with it at the open
configurations of chip_smoke.py phase 16 (N = 16 at E = 1 and 8, N = 27,
N = 64), each at the G the shape rule picks, with CUDA events, in the order
of VARIANTS there and back. A variant that keeps every barrier must give
the same bits as the source (checked); one that drops a barrier may give
wrong results, and only its time is used. Prints one JSON line with the
card's name and power limit and writes it to chiprun_out/rho_variants.json.

    python3 scripts/rho_variants.py
"""

import concurrent.futures
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from quandary_tpu_torch.ops import cuda_build, rho  # noqa: E402
from quandary_tpu_torch.problem import Problem  # noqa: E402

# name -> (replacements (old, new), whether the results stay exact)
VARIANTS = {
    "source": ((), True),
    # the forward's CTA barrier before M(t) is contracted: what double
    # buffering M could save at most
    "no_m_guard": (((
        "    __syncthreads();            // the previous step's reads of M "
        "are done\n", ""),), False),
    # at G = 1 the exchange waits on a block barrier in place of the
    # mbarrier that every thread arrives on
    "block_barrier_at_g1": (((
        "    bar_sync(bars + 8 * (p & 1), tx, (p >> 1) & 1);\n",
        "    if (G == 1)\n      __syncthreads();\n    else\n"
        "      bar_sync(bars + 8 * (p & 1), tx, (p >> 1) & 1);\n"),), True),
    # the forward's one-entry tile compiled for up to 1024 threads, so within
    # 64 registers, as the earlier one-block forward was
    "fwd_tile1_64_registers": (((
        "__global__ void __launch_bounds__(TS == 4 ? 256 : 512)\nrho_fwd(",
        "__global__ void __launch_bounds__(TS == 4 ? 256 : TS == 2 ? 512 : "
        "1024)\nrho_fwd("),), True),
}
CONFIGS = (("cnot16", 1, 3), ("cnot16", cs.E_OPEN, 3), ("qutrits27", 1, 2),
           ("qudits64", 1, 2))


def variant_sources():
    """{name: path of its source}, the variants written into the build
    directory."""
    with open(rho._SRC) as f:
        src = f.read()
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    paths = {}
    for name, (subs, _) in VARIANTS.items():
        if not subs:
            paths[name] = rho._SRC
            continue
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                sys.exit(f"{name}: csrc/rho.cu does not hold {old!r} once")
            text = text.replace(old, new)
        paths[name] = os.path.join(cuda_build.BUILD_DIR, f"rho_{name}.cu")
        with open(paths[name], "w") as f:
            f.write(text)
    return paths


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    paths = variant_sources()
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        for fut in [pool.submit(cuda_build.build_library, p, rho._bind)
                    for p in paths.values()]:
            fut.result()
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    report = {"card": smi}
    try:
        for name, E, reps in CONFIGS:
            pr = Problem(cs.OPEN_CONFIGS[name]())
            P = torch.as_tensor(cs.bench_params(pr.setup.nparams, E, seed=7),
                                device="cuda", dtype=torch.float32)
            C = pr.coeff_rows_mid(P)[..., 0, :].contiguous()
            plan, x0r, x0i = pr._plan, pr._x0r, pr._x0i
            fwd = rho._kernel_fwd(plan, x0r, x0i, C)
            oT, oh = torch.ones_like(fwd[0]), torch.ones_like(fwd[2])
            args = (plan, x0r, x0i, C, *fwd[2:], oT, oT, oh, oh)
            ref = (fwd, rho._kernel_bwd(*args))
            ms = {v: dict(fwd=[], bwd=[]) for v in VARIANTS}
            same = {}
            for v in order:
                rho._SRC = paths[v]
                ms[v]["fwd"].append(cs.event_ms(
                    lambda: rho._kernel_fwd(plan, x0r, x0i, C), reps))
                ms[v]["bwd"].append(cs.event_ms(
                    lambda: rho._kernel_bwd(*args), reps))
                if v not in same:
                    got = (rho._kernel_fwd(plan, x0r, x0i, C),
                           rho._kernel_bwd(*args))
                    same[v] = all(a is b or torch.equal(a, b)
                                  for x, y in zip(got, ref)
                                  for a, b in zip(x, y))
            rho._SRC = paths["source"]
            nt = C.shape[1]
            G = {k: fn(cuda_build.library(rho._SRC, rho._bind), plan, E, nt,
                       x0r.shape[0], fwd[4] is not None)[-3]
                 for k, fn in (("fwd", rho._fwd_args),
                               ("bwd", rho._bwd_args))}
            report[f"{name}_E{E}"] = dict(G=G, ms=ms, same_bits=same)
            del fwd, args, ref
            print(json.dumps({f"{name}_E{E}": report[f"{name}_E{E}"]}),
                  flush=True)
            bad = [v for v, ok in same.items() if VARIANTS[v][1] and not ok]
            if bad:
                sys.exit(f"{name}: exact variants changed the bits: {bad}")
    finally:
        rho._SRC = paths["source"]
    line = json.dumps(report)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "rho_variants.json"),
              "w") as f:
        f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
