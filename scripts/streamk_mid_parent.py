"""Hold the mid streamK pair (streamk_mid_fwd / streamk_mid_bwd,
csrc/streamk_mid.cu) to another commit's build of it, on one CUDA card:
the outputs' bits and both times, interleaved.

Builds, one nvcc each and at once: csrc/streamk_mid.cu as checked out (into
build/quandary_tpu_torch/) and the streamk_mid.cu of the directory given with
--parent (its quandary_tpu_torch/csrc/), for example the parent commit:

    mkdir -p build/parent && git archive HEAD~1 quandary_tpu_torch/csrc \\
        | tar -x -C build/parent

The parent is launched through its own C signature (`parent_bind`: a
commit before the per-sample strides takes no stride arguments, one before
a direction's helpers schedule no helper arguments) on its chain schedule
and its own planner's shape (`parent_shape`, `parent_fwd_shape`); the change through
ops/streamk_mid.py on each schedule it can take at the case (`--schedules`
narrows them). This module also holds what the split scripts share: the
parent build, its launchers and the cases' inputs.

Backward (the default): the parent's single-schedule backward (the column
pass in each cluster's chain) against the change's 'helpers' (the pass on
CTAs of their own) and 'chain'. Both read the same forward's history and
stored iterates. g0 must equal the parent's in bits on every schedule, a
second launch must repeat the change's g0 and Cb in bits, and Cb is
reported as its largest difference from the parent's relative to the
parent's largest entry (the 'helpers' schedule sums C-bar by tiles of the
whole matrix, so in another order).

Forward (--fwd-only): the parent's forward against the change's on each of
its schedules ('helpers': the row contraction on helper clusters a step
ahead; 'chain': in each cluster's chain). xT, the history and the stored
iterates must equal the parent's in bits on every schedule, and a second
launch must repeat them. With --ptxas the builds' ptxas lines
(registers, spills) of the forward's instances are printed beside.

Cases (CASES): phase 25's N = 256 pure, N = 256 basis (B = 256), N = 512
and N = 1024 pure (1000 steps), SWAP02 (N = 64, B = 8, 1000 steps of 0.1
ns), the closed SWAP02 packed with S = 2 detuned realizations (per-sample
stacks), and phase 28's superop N = 27 (dim 729, B = 3, 1000 steps,
jacobi-6 replayed), open configuration 2 on superop (dim 256, B = 16,
1221 steps, jacobi-8 replayed) and the three open qubits packed (S = 2,
dim 64, B = 64, 400 steps; its steps fixed by phase 28). Each case times the kernels with CUDA events in the
order parent, change, change, parent (each of the change's schedules at its
turn). Prints one JSON line per case, each with the card's name and power
limit, and a last one with all of them, also written to
chiprun_out/streamk_mid_parent.json (with --fwd-only
streamk_mid_parent_fwd.json); exits non-zero where bits differ.

    python3 scripts/streamk_mid_parent.py --parent build/parent \\
        [--fwd-only] [--steps N] [--cases a,b] [--schedules chain]
"""

import argparse
import concurrent.futures
import ctypes
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import parent_common as pc  # noqa: E402
from parent_common import interleaved, smi_line  # noqa: E402,F401
from quandary_tpu_torch.ops import streamk, streamk_mid  # noqa: E402

CASES = ("n256_pure", "n256_basis", "n512_pure", "n1024_pure", "swap02",
         "swap02_packed", "superop27", "open2_superop", "open8_packed")
KG = 8      # the parent's C-bar group (MID_KG)


def parent_bind(lib, text):
    """The parent's entry points as its source `text` declares them: the
    backward's 18 pointers (the forward's 13), then E, nt, B, N, Ke, iters,
    mode, store, dt, a, G, BC, threads, shared-memory bytes, global, the
    stream and, where the parent has them (older commits have neither),
    the two strides of per-sample stacks and a direction's helpers schedule
    (its helper count, ring and flags), which the launchers below pass as
    -1 (the chain schedule)."""
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.strides = "long long strideS" in text
    lib.helpers = {}
    for d, npt in (("fwd", 13), ("bwd", 18)):
        head = text.index(f'extern "C" int streamk_mid_{d}_launch(')
        lib.helpers[d] = "int helpers" in text[head:text.index(")", head)]
        fn = getattr(lib, f"streamk_mid_{d}_launch")
        fn.argtypes = ([p] * npt + [i] * 8 + [f, f] + [i] * 5 + [p]
                       + ([ll, ll] if lib.strides else [])
                       + ([i, p, p] if lib.helpers[d] else []))
        fn.restype = i


def parent_tail(lib, plan, direction):
    """The parent's trailing arguments: the strides and the chain schedule
    where its signature has them."""
    return ((streamk.stack_strides(plan) if lib.strides else ())
            + ((-1, None, None) if lib.helpers[direction] else ()))


def build_parent(src, name, verbose=False):
    """Compile the parent's streamk_mid.cu at `src` (its headers beside it)
    into its own library in build/quandary_tpu_torch/<name>/ and load it;
    with `verbose` also return ptxas's report."""
    return pc.build_parent(src, name, parent_bind, verbose)


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
        *parent_tail(lib, plan, "bwd"))
    if err != 0:
        raise RuntimeError(f"parent streamk_mid_bwd launch failed: CUDA "
                           f"error {err}")
    return g0r.sum(0), g0i.sum(0), Cbp.sum(1)


def parent_fwd_shape(E, B, N, Ke, iters, store):
    """The parent planner's forward shape: the forward's chain layout and
    planner have not changed since the mid pair was written
    (streamk._mid_shape)."""
    return streamk._mid_shape(E, B, N, Ke, iters, store)


def parent_fwd(lib, plan, x0r, x0i, C):
    """One launch of the parent's streamk_mid_fwd on its own shape: (xTr,
    xTi, hr, hi, ksr, ksi), as the parent's ops/streamk_mid.py::_kernel_fwd
    returned them."""
    E, nt, Ke = C.shape
    B, N = x0r.shape
    store = plan.store_iters and plan.iters > 0
    G, bc, threads, smem, layout = parent_fwd_shape(E, B, N, Ke, plan.iters,
                                                    store)
    dev = C.device
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    xTr, xTi, hr, hi = new(E, B, N), new(E, B, N), new(E, nt, B, N), \
        new(E, nt, B, N)
    ksr = ksi = scratch = None
    if store:
        ksr, ksi = new(E, nt, plan.iters, B, N), new(E, nt, plan.iters, B, N)
    if layout == "global":
        scratch = new(E * -(-B // bc) * G * 2 * -(-N // G) * N)
    if plan.per_block and not lib.strides:
        raise ValueError("the parent takes no per-sample stacks")
    err = lib.streamk_mid_fwd_launch(
        *map(streamk._ptr, (plan.Sr, plan.Si, C, x0r, x0i, plan.rows, xTr,
                            xTi, hr, hi, ksr, ksi, scratch)),
        *streamk._dims(plan, E, nt, B, N), G, bc, threads, smem,
        int(layout == "global"), torch.cuda.current_stream(dev).cuda_stream,
        *parent_tail(lib, plan, "fwd"))
    if err != 0:
        raise RuntimeError(f"parent streamk_mid_fwd launch failed: CUDA "
                           f"error {err}")
    return xTr, xTi, hr, hi, ksr, ksi


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
    elif name == "open8_packed":
        det = np.random.default_rng(6).uniform(-0.002, 0.002, (2, 3))
        samples = [Problem(cs.swap02_setup(
            ntime=cs.SWAP02_OPEN_NT, freq3=[f + d for f, d in
                                            zip(cs.FREQ3, dd)],
            guards=False, lindblad=True)) for dd in det]
        obj = robust.build_packed_robust_objective(
            samples, np.full(2, 0.5))
        x = cs.bench_params(samples[0].setup.nparams).astype(np.float32)
        return (obj.plan, *obj.x0, obj.coeff_rows(card(x)).contiguous())
    elif name in ("superop27", "open2_superop"):
        setup = cs.midsize_setup(27, ntime=steps) if name == "superop27" \
            else cs.open_cnot_setup(True)
        pr = Problem(dataclasses.replace(setup, fused_rho="superop"))
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


def case_report(lib, name, steps, reps, only=None):
    """The backward's report of one case (`only`: the change's schedules
    to run, default every one that fits)."""
    plan, x0r, x0i, C = case_inputs(name, steps)
    args = (plan, x0r, x0i, C) + forward_and_cotangents(plan, x0r, x0i, C)
    schedules = [s for s in streamk.MID_SCHEDULES if streamk._mid_bwd_shape(
        C.shape[0], *x0r.shape, plan.Ke, plan.iters, plan.store_iters, s)
        is not None and (only is None or s in only)]
    runs = {"parent": lambda: parent_bwd(lib, *args)}
    for s in schedules:
        runs[s] = (lambda s=s: streamk_mid._kernel_bwd(*args, _schedule=s))
    ref = runs["parent"]()
    out, shapes = {}, {}
    for s in schedules:
        out[s] = (runs[s](), runs[s]())
        shapes[s] = dict(streamk_mid.mid_layouts["bwd"])
    ms = interleaved(runs, "parent", reps)
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
            bits_equal_parent=torch.equal(g0r, ref[0])
            and torch.equal(g0i, ref[1]),
            repeat_bits=all(torch.equal(a, b) for a, b in
                            zip(out[s][0], again)),
            cbar_rel_parent=float((Cb - ref[2]).abs().max()
                                  / ref[2].abs().max()),
            finite=all(bool(torch.isfinite(t).all()) for t in out[s][0]))
    return rep


def same(a, b):
    """Two forwards' outputs (xT, history, stored iterates) in equal bits."""
    return all((u is None and v is None) or (
        u is not None and v is not None and torch.equal(u, v))
        for u, v in zip(a, b))


def fwd_report(lib, name, steps, reps, only=None):
    """The forward's report of one case: the parent's forward against the
    change's on each schedule that fits (`only` narrows them)."""
    plan, x0r, x0i, C = case_inputs(name, steps)
    E, (B, N) = C.shape[0], x0r.shape
    store = plan.store_iters and plan.iters > 0
    schedules = [s for s in streamk.MID_SCHEDULES if streamk._mid_fwd_shape(
        E, B, N, plan.Ke, plan.iters, store, s) is not None
        and (only is None or s in only)]
    runs = {"parent": lambda: parent_fwd(lib, plan, x0r, x0i, C)}
    for s in schedules:
        runs[s] = (lambda s=s: streamk_mid._kernel_fwd(plan, x0r, x0i, C,
                                                       _schedule=s))
    ref = runs["parent"]()
    out, shapes = {}, {}
    for s in schedules:
        out[s] = (runs[s](), runs[s]())
        shapes[s] = dict(streamk_mid.mid_layouts["fwd"])
    ms = interleaved(runs, "parent", reps)
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    rep = dict(E=E, B=B, N=N, Ke=plan.Ke, iters=plan.iters, nt=C.shape[1],
               stored=plan.store_iters, per_block=plan.per_block, ms=ms,
               parent_shape=parent_fwd_shape(E, B, N, plan.Ke, plan.iters,
                                             store),
               ratio={k: mean[k] / mean["parent"] for k in schedules},
               card=smi_line())
    for s in schedules:
        got, again = out[s]
        rep[s] = dict(shape=shapes[s], bits_equal_parent=same(got, ref),
                      repeat_bits=same(got, again),
                      finite=all(bool(torch.isfinite(t).all())
                                 for t in got if t is not None))
    return rep


def main():
    import chip_smoke as cs
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=os.path.join(ROOT, "build", "parent"),
                    help="a directory holding the other commit's "
                         "quandary_tpu_torch/csrc/")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--fwd-only", action="store_true",
                    help="hold the forward instead of the backward")
    ap.add_argument("--schedules", default=None,
                    help="the change's schedules to run (default: all that "
                         "fit)")
    ap.add_argument("--ptxas", action="store_true",
                    help="print both builds' ptxas lines of the forward")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    src = os.path.join(args.parent, "quandary_tpu_torch", "csrc",
                       "streamk_mid.cu")
    if not os.path.isfile(src):
        sys.exit(f"{args.parent} holds no quandary_tpu_torch/csrc/"
                 "streamk_mid.cu")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        fp = pool.submit(build_parent, src, "streamk_mid_parent", True)
        fc = pool.submit(streamk_mid.build_kernels, True)
        lib, plog = fp.result()
        clog = fc.result()[2]
    report = {"card": smi_line(), "steps": args.steps}
    if args.ptxas:
        name = "streamk_mid_fwd"
        report["ptxas"] = dict(
            parent=cs.ptxas_kernels(plog, name),
            change={k: v for n in (name, name + "_helpers")
                    for k, v in cs.ptxas_kernels(clog, n).items()})
        print(json.dumps({"ptxas": report["ptxas"]}), flush=True)
    only = args.schedules.split(",") if args.schedules else None
    what = fwd_report if args.fwd_only else case_report
    bad = []
    for name in args.cases.split(","):
        report[name] = what(lib, name, args.steps, args.reps, only)
        print(json.dumps({name: report[name]}), flush=True)
        bad += [f"{name}/{s}" for s, v in report[name].items()
                if isinstance(v, dict) and "finite" in v
                and not (v["bits_equal_parent"] and v["repeat_bits"]
                         and v["finite"])]
        torch.cuda.empty_cache()
    line = json.dumps(report)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    out = "streamk_mid_parent_fwd.json" if args.fwd_only \
        else "streamk_mid_parent.json"
    with open(os.path.join(ROOT, "chiprun_out", out), "w") as f:
        f.write(line + "\n")
    print(line)
    if bad:
        sys.exit(f"bits differ from the parent's (g0, or the forward's xT, "
                 f"history and iterates), a repeat differs, or an output is "
                 f"not finite: {bad}")


if __name__ == "__main__":
    main()
