"""Time rho_bwd (csrc/rho.cu) on clusters of G = 1, 2, 4, 8 and 16 CTAs per
density matrix against each other on one CUDA card, at the open
configurations of chip_smoke.py phase 16: the guarded open CNOT (N = 16,
16 basis matrices, ntime 1221, jacobi-8) at E = 1 and E = 8 candidates, and
the mid-size systems of scripts/perf/rho_bench.py (N = 27 with 6 jump
operators, N = 64 with 4; 3 initial conditions, ntime 1000, jacobi-6).
Each configuration is timed G = 1, 2, 4, 8, 16, 16, 8, 4, 2, 1 with CUDA
events (a G the card refuses is reported as refused), with rho_fwd before
and after as the yardstick; g0 must have the same bits at every G and Cb
agree to 1e-6 of max. Prints one JSON line, with the card's name and power
limit and the G that ops/rho.py's shape rule picks, and writes it to
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
from quandary_tpu_torch.ops import rho  # noqa: E402
from quandary_tpu_torch.problem import Problem  # noqa: E402

CLUSTERS = (1, 2, 4, 8, 16)


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    rho.build_kernels()
    report = {"card": smi}
    for name, E, reps in (("cnot16", 1, 3), ("cnot16", cs.E_OPEN, 3),
                          ("qutrits27", 1, 2), ("qudits64", 1, 1)):
        pr = Problem(cs.OPEN_CONFIGS[name]())
        P = torch.as_tensor(cs.bench_params(pr.setup.nparams, E, seed=7),
                            device="cuda", dtype=torch.float32)
        C = pr.coeff_rows_mid(P)[..., 0, :].contiguous()
        plan, x0r, x0i = pr._plan, pr._x0r, pr._x0i
        fwd = rho._kernel_fwd(plan, x0r, x0i, C)
        hr, hi, ksr, ksi = fwd[2:]
        oT, oh = torch.ones_like(fwd[0]), torch.ones_like(hr)
        args = (plan, x0r, x0i, C, hr, hi, ksr, ksi, oT, oT, oh, oh)
        B, N, nt = x0r.shape[0], plan.N, C.shape[1]
        times = {G: [] for G in CLUSTERS}
        fwd_ms = [cs.event_ms(lambda: rho._kernel_fwd(plan, x0r, x0i, C),
                              reps)]
        out, refused = {}, {}
        for G in CLUSTERS + CLUSTERS[::-1]:
            if G in refused:
                continue
            try:
                times[G].append(cs.event_ms(
                    lambda: rho._kernel_bwd(*args, _cluster=G), reps))
                out[G] = rho._kernel_bwd(*args, _cluster=G)
            except (RuntimeError, NotImplementedError) as err:
                refused[G] = str(err)
        fwd_ms.append(cs.event_ms(lambda: rho._kernel_fwd(plan, x0r, x0i, C),
                                  reps))
        torch.cuda.synchronize()
        ref = out[1]
        G0, tile, threads, smem = rho._bwd_shape(E, B, N, plan.K,
                                                 plan.njump)
        report[f"{name}_E{E}"] = dict(
            E=E, B=B, N=N, J=plan.njump, K=plan.K, iters=plan.iters, nt=nt,
            stored=ksr is not None, rule_G=G0, rule_tile=tile,
            rule_threads=threads, rule_smem=smem,
            rho_fwd_ms=fwd_ms,
            bwd_ms={G: t for G, t in times.items() if t},
            us_per_step={G: 1e3 * min(t) / nt for G, t in times.items()
                         if t},
            ctas={G: E * B * G for G in out},
            g0_bits_equal={G: bool(torch.equal(o[0], ref[0])
                                   and torch.equal(o[1], ref[1]))
                           for G, o in out.items()},
            cb_rel={G: float((o[2] - ref[2]).abs().max()
                             / ref[2].abs().max()) for G, o in out.items()},
            refused=refused)
        del fwd, args, out, ref, ksr, ksi, hr, hi
        print(json.dumps({name: report[f"{name}_E{E}"]}), flush=True)
    line = json.dumps(report)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "rho_bwd_clusters.json"),
              "w") as f:
        f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
