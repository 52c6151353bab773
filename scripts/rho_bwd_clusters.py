"""Time rho_fwd and rho_bwd (csrc/rho.cu) on clusters of G = 1, 2, 4, 8 and
16 CTAs per density matrix against each other on one CUDA card, at the
open configurations of chip_smoke.py phase 16: the guarded open CNOT
(N = 16, 16 basis matrices, ntime 1221, jacobi-8) at E = 1 and E = 8
candidates, and the mid-size systems of scripts/perf/rho_bench.py (N = 27
with 6 jump operators, N = 64 with 4; 3 initial conditions, ntime 1000,
jacobi-6). Each configuration times each kernel at G = 1, 2, 4, 8, 16, 16,
8, 4, 2, 1 with CUDA events (a G the card refuses is reported as refused).
rho_fwd's xT, history and stored stage iterates must have the same bits at
every G, as must rho_bwd's g0, and Cb agree to 1e-6 of max. Prints one JSON
line, with the card's name and power limit and the G that ops/rho.py's
shape rule picks for each kernel, and writes it to
chiprun_out/rho_bwd_clusters.json.

    python3 scripts/rho_bwd_clusters.py
"""

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

CLUSTERS = (1, 2, 4, 8, 16)


def sweep(launch, reps):
    """{G: [ms, ms]} in the order of CLUSTERS there and back, {G: output of
    one more launch} and {G: why it was refused}."""
    times, out, refused = {G: [] for G in CLUSTERS}, {}, {}
    for G in CLUSTERS + CLUSTERS[::-1]:
        if G in refused:
            continue
        try:
            times[G].append(cs.event_ms(lambda: launch(G), reps))
            if G not in out:
                out[G] = launch(G)
        except (RuntimeError, NotImplementedError) as err:
            refused[G] = str(err)
    torch.cuda.synchronize()
    return {G: t for G, t in times.items() if t}, out, refused


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    rho.build_kernels()
    lib = cuda_build.library(rho._SRC, rho._bind)
    report = {"card": smi}
    for name, E, reps in (("cnot16", 1, 3), ("cnot16", cs.E_OPEN, 3),
                          ("qutrits27", 1, 2), ("qudits64", 1, 1)):
        pr = Problem(cs.OPEN_CONFIGS[name]())
        P = torch.as_tensor(cs.bench_params(pr.setup.nparams, E, seed=7),
                            device="cuda", dtype=torch.float32)
        C = pr.coeff_rows_mid(P)[..., 0, :].contiguous()
        plan, x0r, x0i = pr._plan, pr._x0r, pr._x0i
        B, N, nt = x0r.shape[0], plan.N, C.shape[1]

        fwd_ms, fwd_out, fwd_refused = sweep(
            lambda G: rho._kernel_fwd(plan, x0r, x0i, C, _cluster=G), reps)
        ref = fwd_out[1]
        fwd_bits = {G: all(a is b or torch.equal(a, b)
                           for a, b in zip(o, ref))
                    for G, o in fwd_out.items()}
        hr, hi, ksr, ksi = ref[2:]
        del fwd_out
        oT, oh = torch.ones_like(ref[0]), torch.ones_like(hr)
        args = (plan, x0r, x0i, C, hr, hi, ksr, ksi, oT, oT, oh, oh)
        bwd_ms, bwd_out, bwd_refused = sweep(
            lambda G: rho._kernel_bwd(*args, _cluster=G), reps)
        g1 = bwd_out[1]
        store = ksr is not None
        rule = {key: fn(lib, plan, E, nt, B, store)[-4:]
                for key, fn in (("fwd", rho._fwd_args),
                                ("bwd", rho._bwd_args))}
        report[f"{name}_E{E}"] = dict(
            E=E, B=B, N=N, J=plan.njump, K=plan.K, iters=plan.iters, nt=nt,
            stored=store,
            rule={k: dict(tile=v[0], G=v[1], threads=v[2], smem=v[3])
                  for k, v in rule.items()},
            fwd_ms=fwd_ms, bwd_ms=bwd_ms,
            fwd_us_per_step={G: 1e3 * min(t) / nt for G, t in fwd_ms.items()},
            bwd_us_per_step={G: 1e3 * min(t) / nt for G, t in bwd_ms.items()},
            ctas={G: E * B * G for G in set(fwd_ms) | set(bwd_ms)},
            fwd_bits_equal=fwd_bits,
            g0_bits_equal={G: bool(torch.equal(o[0], g1[0])
                                   and torch.equal(o[1], g1[1]))
                           for G, o in bwd_out.items()},
            cb_rel={G: float((o[2] - g1[2]).abs().max()
                             / g1[2].abs().max()) for G, o in bwd_out.items()},
            fwd_refused=fwd_refused, bwd_refused=bwd_refused)
        del args, bwd_out, g1, ref, ksr, ksi, hr, hi
        print(json.dumps({name: report[f"{name}_E{E}"]}), flush=True)
        if not all(fwd_bits.values()):
            sys.exit(f"{name}: rho_fwd's outputs differ across G: {fwd_bits}")
    line = json.dumps(report)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "rho_bwd_clusters.json"),
              "w") as f:
        f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
