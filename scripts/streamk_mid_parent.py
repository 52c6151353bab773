"""Hold the mid streamK backward (streamk_mid_bwd, csrc/streamk_mid.cu) to
another commit's build of it, on one CUDA card: g0's bits and both times,
interleaved.

Builds, one nvcc each and at once: csrc/streamk_mid.cu as checked out (into
build/quandary_tpu_torch/) and the streamk_mid.cu of the directory given with
--parent (its quandary_tpu_torch/csrc/), for example the parent commit:

    mkdir -p build/parent && git archive HEAD~1 quandary_tpu_torch/csrc \\
        | tar -x -C build/parent

The parent's backward is launched through its own C signature (the
single-schedule launcher, the column pass in each cluster's chain) on its
own planner's shape (`parent_shape`); the change's through
ops/streamk_mid.py on each schedule it can take at the case ('helpers': the
column pass on CTAs of their own; 'chain': in the chain). Both read the
same forward's history and stored iterates (the forward is not compared).

Cases (CASES): phase 25's N = 256 pure, N = 256 basis (B = 256), N = 512
and N = 1024 pure (1000 steps), SWAP02 (N = 64, B = 8, 1000 steps of 0.1
ns), the closed SWAP02 packed with S = 2 detuned realizations (per-sample
stacks), and phase 28's superop N = 27 (dim 729, B = 3, 1000 steps,
jacobi-6 replayed). Each case times the backwards with CUDA events in the
order parent, change, change, parent (each of the change's schedules at its
turn), and compares one more launch of each: g0 must equal the parent's in
bits on every schedule, a second launch must repeat the change's g0 and Cb
in bits, and Cb is reported as its largest difference from the parent's
relative to the parent's largest entry (the 'helpers' schedule sums C-bar
by tiles of the whole matrix, so in another order). Prints one JSON line
per case, each with the card's name and power limit, and a last one with
all of them, also written to chiprun_out/streamk_mid_parent.json; exits
non-zero where g0 differs or a repeat does.

    python3 scripts/streamk_mid_parent.py --parent build/parent [--steps N]
"""

import argparse
import concurrent.futures
import ctypes
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from quandary_tpu_torch.ops import cuda_build, streamk, streamk_mid  # noqa

CASES = ("n256_pure", "n256_basis", "n512_pure", "n1024_pure", "swap02",
         "swap02_packed", "superop27")
KG = 8      # the parent's C-bar group (MID_KG)


def parent_bind(lib):
    """The parent's entry points: the backward's 18 pointers (the
    forward's 13), then E, nt, B, N, Ke, iters, mode, store, dt, a, G, BC,
    threads, shared-memory bytes, global, the stream and the two strides."""
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    tail = [i] * 8 + [f, f] + [i] * 5 + [p, ll, ll]
    lib.streamk_mid_bwd_launch.argtypes = [p] * 18 + tail
    lib.streamk_mid_bwd_launch.restype = i
    lib.streamk_mid_max_clusters.argtypes = [i] * 5
    lib.streamk_mid_max_clusters.restype = i


def build_parent(src, name):
    """Compile the parent's streamk_mid.cu at `src` (its headers beside it)
    into its own library in build/quandary_tpu_torch/<name>/ and load it."""
    out = os.path.join(cuda_build.BUILD_DIR, name, f"lib{name}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    res = subprocess.run(cuda_build.nvcc_command(src, out),
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {src} failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(out)
    parent_bind(lib)
    return lib


def parent_floats(bc, N, R, it, replay, hsmem):
    """The parent's backward shared memory in floats (mid_bwd_floats)."""
    bands = 2 * R * (N + 1) + (2 * R * N if replay else 0) if hsmem else 0
    return (2 * (it + 1) * bc * N + (4 * bc * N if replay else 0)
            + 2 * (it + 1) * bc * R + (10 if replay else 6) * bc * R + 4 * R
            + 16 * KG + bands)


def parent_shape(E, B, N, iters, store):
    """The parent planner's backward shape (G, Bc, threads, shared-memory
    bytes, layout): streamk.cluster_shape on the parent's layout."""
    replay = not store and iters > 0
    G, bc, slots, threads, smem = streamk.cluster_shape(
        E, B, N, lambda G, bc, slots: parent_floats(
            bc, N, -(-N // G), iters, replay, slots > 0))
    return G, bc, threads, smem, "smem" if slots else "global"


def parent_bwd(lib, plan, x0r, x0i, C, hr, hi, ksr, ksi, gTr, gTi, jr, ji):
    """One launch of the parent's streamk_mid_bwd on its own shape: (g0
    summed over the candidates, Cb (E, nt, Ke)), as the parent's
    ops/streamk_mid.py::_kernel_bwd returned them."""
    E, nt, Ke = C.shape
    B, N = x0r.shape
    store = ksr is not None
    G, bc, threads, smem, layout = parent_shape(E, B, N, plan.iters, store)
    dev = C.device
    g0r = torch.empty((E, B, N), dtype=torch.float32, device=dev)
    g0i = torch.empty_like(g0r)
    Cbp = torch.empty((E, -(-B // bc) * G, nt, Ke), dtype=torch.float32,
                      device=dev)
    scratch = None
    if layout == "global":
        R = -(-N // G)
        band = 2 * R * (N + 1) + (2 * R * N if not store and plan.iters
                                  else 0)
        scratch = torch.empty(E * -(-B // bc) * G * band,
                              dtype=torch.float32, device=dev)
    err = lib.streamk_mid_bwd_launch(
        *map(streamk._ptr, (plan.Sr, plan.Si, C, x0r, x0i, hr, hi, jr, ji,
                            gTr, gTi, plan.rows, ksr, ksi, g0r, g0i, Cbp,
                            scratch)),
        *streamk._dims(plan, E, nt, B, N), G, bc, threads, smem,
        int(layout == "global"), torch.cuda.current_stream(dev).cuda_stream,
        *streamk.stack_strides(plan))
    if err != 0:
        raise RuntimeError(f"parent streamk_mid_bwd launch failed: CUDA "
                           f"error {err}")
    return g0r.sum(0), g0i.sum(0), Cbp.sum(1)


def smi_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def case_inputs(name, steps):
    """(plan, x0r, x0i, C) of a case at `steps` steps, the bench's
    parameter draw (chip_smoke.bench_params)."""
    import chip_smoke as cs
    from quandary_tpu_torch.optim import robust
    from quandary_tpu_torch.problem import Problem
    card = lambda a: torch.as_tensor(a, device="cuda", dtype=torch.float32)
    if name.startswith("n") and name[1].isdigit():
        N, init = name[1:].split("_")
        pr = Problem(cs.midsize_closed_setup(int(N), init, ntime=steps))
    elif name == "swap02":
        pr = Problem(cs.swap02_setup(ntime=steps, T=0.1 * steps))
    elif name == "swap02_packed":
        det = np.random.default_rng(6).uniform(-0.002, 0.002, (2, 3))
        samples = [Problem(cs.swap02_setup(
            ntime=steps, T=0.1 * steps,
            freq3=[f + d for f, d in zip(cs.FREQ3, dd)])) for dd in det]
        obj = robust.build_packed_robust_objective(
            samples, np.full(2, 0.5))
        x = cs.bench_params(samples[0].setup.nparams).astype(np.float32)
        return (obj.plan, *obj.x0, obj.coeff_rows(card(x)).contiguous())
    elif name == "superop27":
        pr = Problem(dataclasses.replace(cs.midsize_setup(27, ntime=steps),
                                         fused_rho="superop"))
        P = card(cs.bench_params(pr.setup.nparams))[None]
        C = streamk.extend_coeffs(pr._plan,
                                  pr.coeff_rows_mid(P)[..., 0, :])
        return pr._plan, pr._x0r, pr._x0i, C
    else:
        raise ValueError(name)
    x = card(cs.bench_params(pr.setup.nparams))
    C = streamk.extend_coeffs(pr._plan, pr.coeff_rows_mid(x)[None, :, 0])
    return pr._plan, pr._x0r, pr._x0i, C


def forward_and_cotangents(plan, x0r, x0i, C, seed=20):
    """The (checked-out) forward's history and iterates, and seeded normal
    cotangents gT, j: the backward's inputs after (plan, x0r, x0i, C)."""
    fwd = streamk_mid._kernel_fwd(plan, x0r, x0i, C)
    hr, hi, ksr, ksi = fwd[2:]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = lambda t: torch.randn(t.shape, device="cuda", generator=gen)
    gTr, gTi, jr, ji = w(fwd[0]), w(fwd[1]), w(hr), w(hi)
    return hr, hi, ksr, ksi, gTr, gTi, jr, ji


def case_report(lib, name, steps, reps):
    import chip_smoke as cs
    plan, x0r, x0i, C = case_inputs(name, steps)
    args = (plan, x0r, x0i, C) + forward_and_cotangents(plan, x0r, x0i, C)
    schedules = [s for s in streamk.MID_SCHEDULES if streamk._mid_bwd_shape(
        C.shape[0], *x0r.shape, plan.Ke, plan.iters, plan.store_iters, s)
        is not None]
    runs = {"parent": lambda: parent_bwd(lib, *args)}
    for s in schedules:
        runs[s] = (lambda s=s: streamk_mid._kernel_bwd(*args, _schedule=s))
    order = ["parent"] + list(schedules) + list(schedules)[::-1] \
        + ["parent"]
    ms = {k: [] for k in runs}
    ref = runs["parent"]()
    out, shapes = {}, {}
    for k in order:
        ms[k].append(cs.event_ms(runs[k], reps))
        if k not in out and k != "parent":
            out[k] = (runs[k](), runs[k]())
            shapes[k] = dict(streamk_mid.mid_layouts["bwd"])
    torch.cuda.synchronize()
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    rep = dict(E=C.shape[0], B=x0r.shape[0], N=x0r.shape[1], Ke=plan.Ke,
               iters=plan.iters, nt=C.shape[1], stored=plan.store_iters,
               per_block=plan.per_block, ms=ms,
               parent_shape=parent_shape(C.shape[0], *x0r.shape,
                                         plan.iters, plan.store_iters),
               ratio={k: mean[k] / mean["parent"] for k in schedules},
               card=smi_line())
    for s in schedules:
        (g0r, g0i, Cb), again = out[s]
        rep[s] = dict(
            shape=shapes[s],
            g0_bits_equal_parent=torch.equal(g0r, ref[0])
            and torch.equal(g0i, ref[1]),
            repeat_bits=all(torch.equal(a, b) for a, b in
                            zip(out[s][0], again)),
            cbar_rel_parent=float((Cb - ref[2]).abs().max()
                                  / ref[2].abs().max()),
            finite=all(bool(torch.isfinite(t).all()) for t in out[s][0]))
    return rep


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=os.path.join(ROOT, "build", "parent"),
                    help="a directory holding the other commit's "
                         "quandary_tpu_torch/csrc/")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--cases", default=",".join(CASES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    src = os.path.join(args.parent, "quandary_tpu_torch", "csrc",
                       "streamk_mid.cu")
    if not os.path.isfile(src):
        sys.exit(f"{args.parent} holds no quandary_tpu_torch/csrc/"
                 "streamk_mid.cu")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        fp = pool.submit(build_parent, src, "streamk_mid_parent")
        fc = pool.submit(streamk_mid.build_kernels)
        lib = fp.result()
        fc.result()
    report = {"card": smi_line(), "steps": args.steps}
    bad = []
    for name in args.cases.split(","):
        report[name] = case_report(lib, name, args.steps, args.reps)
        print(json.dumps({name: report[name]}), flush=True)
        bad += [f"{name}/{s}" for s, v in report[name].items()
                if isinstance(v, dict) and "finite" in v
                and not (v["g0_bits_equal_parent"] and v["repeat_bits"]
                         and v["finite"])]
        torch.cuda.empty_cache()
    line = json.dumps(report)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "streamk_mid_parent.json"),
              "w") as f:
        f.write(line + "\n")
    print(line)
    if bad:
        sys.exit(f"g0 differs from the parent's, a repeat differs, or an "
                 f"output is not finite: {bad}")


if __name__ == "__main__":
    main()
