"""Hold the mid density-matrix pair (rho_mid_fwd, csrc/rho_mid_fwd.cu;
rho_mid_bwd, csrc/rho_mid.cu) to another commit's build of the pair (both
kernels in its csrc/rho_mid.cu), on one CUDA card: their bits and their
times, interleaved.

Builds, one nvcc each and all at once: csrc/rho_mid_fwd.cu and
csrc/rho_mid.cu as checked out (into build/quandary_tpu_torch/) and the
rho_mid.cu of the directory given with --parent (its
quandary_tpu_torch/csrc/), for example the parent commit:

    mkdir -p build/parent && git archive HEAD~1 quandary_tpu_torch/csrc \\
        | tar -x -C build/parent

The parent's kernels are launched through their own C signatures and
layouts (`parent_fwd`; `parent_bwd`: the single-role launcher, one cluster
per density matrix with the replay in its chain; a parent whose backward
has the two roles (the checkout's C signature) is launched through
ops/rho_mid.py on its schedule for the card); the change's through
ops/rho_mid.py, the backward on each of its schedules: 'split' (the replay
on clusters of its own, a ring of iterates between the roles), 'chain'
(the replay in the adjoint's chain) and, with stored iterates, 'store'.

The forward (FWD_SHAPES; --fwd-only skips the backward): qudits125 and
qudits128 at E = 1 (E B = 3), 1000 steps, and qudits125 at E = 8 (E B =
24) cut to 250 steps, iterates not stored (as at full depth), timed in the
order parent, change, change, parent (at E B = 24 the change also on
clusters of 8 and 16 CTAs, between its two turns and again in reverse);
xT and the history must equal the parent's in bits on every cluster size;
and at N = 65, 96, 125 and 128 (FWD_BITS, 40 steps) the stored iterates
too.

The backward (--bwd-only skips the forward):
Shapes: chip_smoke.py's qudits125 (N = 125, K = 11, J = 6, B = 3, jacobi-6)
and qudits128 (N = 128, K = 7, J = 4) at E = 1 (E B = 3), 1000 steps, and
qudits125 at E = 8 (E B = 24, the device driver's trial steps) cut to 250
steps, with the iterates replayed as the byte rule replays them there, and
qudits125 with stored ones (the forward's as input). Each shape times the
backwards with CUDA events
in the order parent, change, change, parent (each of the change's schedules
at its turn), and compares one more launch of each: g0 must equal the
parent's in bits on every schedule, Cb is reported as its largest difference
from the parent's relative to the parent's largest entry (the change takes
the c^dag u half of the H_eff cotangent by column band, so its sum runs in
another order). Prints one JSON line per shape and a last one with all of
them and the card's name and power limit; exits non-zero where g0, or the
forward's outputs, differ.

    python3 scripts/rho_mid_parent.py --parent build/parent [--fwd-only]
"""

import argparse
import concurrent.futures
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch  # noqa: E402

import parent_common as pc  # noqa: E402
from parent_common import smi_line  # noqa: E402,F401
from quandary_tpu_torch.ops import rho, rho_mid  # noqa: E402


def parent_bind(lib):
    """The parent's entry points: the backward's 20 pointers, the
    forward's 14, then E, nt, B, N, K, J, iters, mode, store, dt, a, tile,
    cluster, threads, shared-memory bytes and the stream."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rho_mid_bwd_launch.argtypes = [p] * 20 + [i] * 9 + [f, f] \
        + [i] * 4 + [p]
    lib.rho_mid_fwd_launch.argtypes = [p] * 14 + [i] * 9 + [f, f] \
        + [i] * 4 + [p]
    for name in ("rho_mid_bwd", "rho_mid_fwd"):
        getattr(lib, name + "_launch").restype = i
        fn = getattr(lib, name + "_max_clusters")
        fn.argtypes, fn.restype = [i] * 4, i


def build_parent(src, name):
    """Compile the parent's rho_mid.cu at `src` into its own library in
    build/quandary_tpu_torch/<name>/ and load it."""

    def bind(lib, text):
        parent_bind(lib)
        lib.two_role = "int split, int ring" in text
        if lib.two_role:    # the backward's launcher is the checkout's
            rho_mid._bind(lib)

    return pc.build_parent(src, name, bind)


def parent_layout_bytes(N, G, K, jb, threads):
    """The parent's backward layout: two mbarriers (8 floats), the operand
    (one buffer), jb jump bands, the warps' C-bar partials and the
    cluster's."""
    ld, R = N | 1, -(-N // G)
    return 4 * (8 + 2 * N * ld + 2 * jb * R * ld
                + (threads // 32 + G) * K)


def parent_fwd_layout_bytes(N, G, K, jb, threads):
    """The parent's forward layout: one mbarrier (8 floats), the operand
    (one buffer of (re, im) planes of row stride N | 1) and jb jump bands
    of ceil(N / G) rows."""
    ld, R = N | 1, -(-N // G)
    return 4 * (8 + 2 * N * ld + 2 * jb * R * ld)


def parent_fwd_shape(lib, E, B, N, K, J, G=None):
    """The parent's forward launch shape (G, tile, threads, shared-memory
    bytes): rho._cluster_shape on its layout, 8 where the card holds no
    cluster of 16."""
    shape = rho._cluster_shape("rho_mid_fwd", parent_fwd_layout_bytes, 1, E,
                               B, N, K, J, G)
    if G is None and shape[0] == 16 and lib.rho_mid_fwd_max_clusters(
            shape[1], 16, shape[2], shape[3]) < 1:
        shape = rho._cluster_shape("rho_mid_fwd", parent_fwd_layout_bytes, 1,
                                   E, B, N, K, J, None, 8)
    return shape


def parent_fwd(lib, plan, x0r, x0i, C, store, G=None):
    """One launch of the parent's rho_mid_fwd on its own launch shape:
    (xTr, xTi, hr, hi, ksr, ksi), the iterates None unless `store`."""
    E, nt, _ = C.shape
    B, N, _ = x0r.shape
    G, tile, threads, smem = parent_fwd_shape(lib, E, B, N, plan.K,
                                              plan.njump, G)
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=C.device)
    xTr, xTi = new(E, B, N, N), new(E, B, N, N)
    hr, hi = new(E, nt, B, N, N), new(E, nt, B, N, N)
    ksr = ksi = None
    if store:
        ksr = new(E, B, nt, plan.iters, N, N)
        ksi = new(E, B, nt, plan.iters, N, N)
    scr = new(E * B * 4 * N * N)
    err = lib.rho_mid_fwd_launch(
        *map(rho._ptr, (plan.Sr, plan.Si, plan.L, C, x0r, x0i, plan.planes,
                        xTr, xTi, hr, hi, ksr, ksi, scr)),
        *rho._dims(plan, E, nt, B, store), tile, G, threads, smem,
        torch.cuda.current_stream(C.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"parent rho_mid_fwd launch failed: CUDA error "
                           f"{err}")
    return xTr, xTi, hr, hi, ksr, ksi


def parent_bwd(lib, plan, x0r, x0i, C, hr, hi, ksr, ksi, gTr, gTi, jr, ji,
               G=None):
    """One launch of the parent's rho_mid_bwd on its own launch shape:
    (g0 summed over the candidates, Cb summed over the matrices), as the
    parent's ops/rho_mid.py::_kernel_bwd returned them."""
    E, nt, K = C.shape
    B, N, _ = x0r.shape
    shape = rho._cluster_shape("rho_mid_bwd", parent_layout_bytes, K, E, B,
                               N, K, plan.njump, G)
    if G is None and shape[0] == 16 and lib.rho_mid_bwd_max_clusters(
            shape[1], 16, shape[2], shape[3]) < 1:
        shape = rho._cluster_shape("rho_mid_bwd", parent_layout_bytes, K, E,
                                   B, N, K, plan.njump, None, 8)
    G, tile, threads, smem = shape
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=C.device)
    store = ksr is not None
    if not store:
        ksr = new(E, B, max(plan.iters, 1), N, N)
        ksi = torch.empty_like(ksr)
    St = plan.St if plan.St is not None else rho_mid.transposed_stacks(
        plan.Sr, plan.Si)
    g0r, g0i, Cb = new(E, B, N, N), new(E, B, N, N), new(E, B, nt, K)
    scr = new(E * B * 12 * N * N)
    err = lib.rho_mid_bwd_launch(
        *map(rho._ptr, (plan.Sr, plan.Si, St, plan.L, C, x0r, x0i, hr, hi,
                        jr, ji, gTr, gTi, plan.planes, ksr, ksi, g0r, g0i, Cb,
                        scr)),
        *rho._dims(plan, E, nt, B, store), tile, G, threads, smem,
        torch.cuda.current_stream(C.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"parent rho_mid_bwd launch failed: CUDA error "
                           f"{err}")
    return g0r.sum(0), g0i.sum(0), Cb.sum(1)


def inputs(name, E, steps=1000, seed=7):
    """(plan, x0r, x0i, C) of chip_smoke.py's configuration `name` (or the
    midsize system of that N) at E candidates and `steps` steps (the
    bench's parameter draw)."""
    import chip_smoke as cs
    from quandary_tpu_torch.problem import Problem
    setup = cs.midsize_setup if isinstance(name, int) else \
        cs.OPEN_CONFIGS[name]
    pr = Problem(setup(name, ntime=steps) if isinstance(name, int)
                 else setup(ntime=steps))
    P = torch.as_tensor(cs.bench_params(pr.setup.nparams, E, seed=seed),
                        device="cuda", dtype=torch.float32)
    C = pr.coeff_rows_mid(P)[..., 0, :].contiguous()
    return pr._plan, pr._x0r, pr._x0i, C


def shape_report(lib, name, E, steps, store, reps):
    """Parent and change on one shape: times interleaved, g0's bits and
    Cb's difference on each of the change's schedules."""
    import chip_smoke as cs
    plan, x0r, x0i, C = inputs(name, E, steps)
    nt = C.shape[1]
    with cs.iterates_budget((1 << 62) if store else 0):
        fwd = rho._kernel_fwd(plan, x0r, x0i, C)
    hr, hi, ksr, ksi = fwd[2:]
    del fwd
    gen = torch.Generator(device="cuda").manual_seed(18)
    w = lambda t: torch.randn(t.shape, device="cuda", generator=gen)
    gT = w(x0r.new_empty(C.shape[0], *x0r.shape))
    jr, ji = w(hr), w(hi)
    args = (plan, x0r, x0i, C, hr, hi, ksr, ksi, gT, gT, jr, ji)
    schedules = ("store",) if store else ("split", "chain")
    runs = {"parent": lambda: parent_bwd(lib, *args)}
    if lib.two_role:        # launched as ops/rho_mid.py launches its own
        def parent_two_role():
            own = rho_mid._lib
            rho_mid._lib = lambda: lib
            try:
                return rho_mid._kernel_bwd(*args)
            finally:
                rho_mid._lib = own
        runs["parent"] = parent_two_role
    for s in schedules:
        runs[s] = (lambda s=s: rho_mid._kernel_bwd(*args, _schedule=s))
    order = ["parent"] + list(schedules) + list(schedules)[::-1] \
        + ["parent"]
    ms = {k: [] for k in runs}
    ref = runs["parent"]()
    out = {}
    for k in order:
        ms[k].append(cs.event_ms(runs[k], reps))
        if k not in out and k != "parent":
            out[k] = runs[k]()
            out[k + "_layout"] = dict(rho_mid.mid_layouts["bwd"])
    torch.cuda.synchronize()
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    rep = dict(E=C.shape[0], B=x0r.shape[0], N=plan.N, K=plan.K,
               J=plan.njump, iters=plan.iters, nt=nt, stored=store, ms=ms,
               ratio={k: mean[k] / mean["parent"] for k in schedules})
    for s in schedules:
        g0r, g0i, Cb = out[s]
        rep[s] = dict(
            layout=out[s + "_layout"],
            g0_bits_equal_parent=torch.equal(g0r, ref[0])
            and torch.equal(g0i, ref[1]),
            cbar_rel_parent=float((Cb - ref[2]).abs().max()
                                  / ref[2].abs().max()),
            finite=all(bool(torch.isfinite(t).all()) for t in out[s]))
    return rep


# (configuration, E, steps, reps, the change's other cluster sizes) of the
# forward's times; the N of its checks of the stored iterates' bits, at
# FWD_BITS_STEPS steps
FWD_SHAPES = (("qudits125", 1, 1000, 2, ()), ("qudits128", 1, 1000, 2, ()),
              ("qudits125", 8, 250, 1, (8, 16)))
FWD_BITS, FWD_BITS_STEPS = (65, 96, 125, 128), 40


def fwd_report(lib, name, E, steps, reps, clusters=()):
    """Parent and change forwards on one shape, iterates not stored: times
    interleaved, xT and the history's bits; the change also on clusters of
    each G in `clusters` (key change_G<G>: its time, layout and bits)."""
    import chip_smoke as cs
    plan, x0r, x0i, C = inputs(name, E, steps)
    runs = {"parent": lambda: parent_fwd(lib, plan, x0r, x0i, C, False),
            "change": lambda: rho_mid._kernel_fwd(plan, x0r, x0i, C)}
    for G in clusters:
        runs[f"change_G{G}"] = (lambda G=G: rho_mid._kernel_fwd(
            plan, x0r, x0i, C, _cluster=G))
    ms = {k: [] for k in runs}
    alts = list(runs)[1:]
    with cs.iterates_budget(0):
        for k in ["parent"] + alts + alts[::-1] + ["parent"]:
            ms[k].append(cs.event_ms(runs[k], reps))
        ref, got = runs["parent"](), runs["change"]()
        layout = dict(rho_mid.mid_layouts["fwd"])
        other = {}
        for k in alts[1:]:
            out = runs[k]()
            other[k] = dict(layout=dict(rho_mid.mid_layouts["fwd"]),
                            bits_equal_parent=all(
                                torch.equal(a, b)
                                for a, b in zip(ref[:4], out[:4])))
            del out
    torch.cuda.synchronize()
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    return dict(E=E, B=x0r.shape[0], N=plan.N, K=plan.K, J=plan.njump,
                iters=plan.iters, nt=C.shape[1], ms=ms,
                ratio=mean["change"] / mean["parent"],
                ratios={k: mean[k] / mean["parent"] for k in alts},
                other_clusters=other, layout=layout,
                parent_shape=parent_fwd_shape(lib, E, x0r.shape[0], plan.N,
                                              plan.K, plan.njump),
                bits_equal_parent=all(torch.equal(a, b)
                                      for a, b in zip(ref[:4], got[:4])),
                finite=all(bool(torch.isfinite(t).all()) for t in got[:4]))


def fwd_bits(lib, N, steps):
    """xT, the history and the stored iterates of both forwards at N, E = 1:
    equal in bits (one flag per output)."""
    import chip_smoke as cs
    plan, x0r, x0i, C = inputs(N, 1, steps)
    with cs.iterates_budget(1 << 62):
        got = rho_mid._kernel_fwd(plan, x0r, x0i, C)
    ref = parent_fwd(lib, plan, x0r, x0i, C, True)
    torch.cuda.synchronize()
    names = ("xTr", "xTi", "hr", "hi", "ksr", "ksi")
    return dict(N=N, nt=steps, layout=dict(rho_mid.mid_layouts["fwd"]),
                **{k: a is not None and torch.equal(a, b)
                   for k, a, b in zip(names, got, ref)})


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=os.path.join(ROOT, "build", "parent"),
                    help="a directory holding the other commit's "
                         "quandary_tpu_torch/csrc/")
    ap.add_argument("--fwd-only", action="store_true",
                    help="the forward's comparisons alone")
    ap.add_argument("--bwd-only", action="store_true",
                    help="the backward's comparisons alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    src = os.path.join(args.parent, "quandary_tpu_torch", "csrc",
                       "rho_mid.cu")
    if not os.path.isfile(src):
        sys.exit(f"{args.parent} holds no quandary_tpu_torch/csrc/rho_mid.cu")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        fp = pool.submit(build_parent, src, "rho_mid_parent")
        fc = pool.submit(rho_mid.build_kernels)
        lib = fp.result()
        fc.result()
    report = {"card": smi_line()}
    bad = []
    for name, E, steps, reps, clusters in () if args.bwd_only \
            else FWD_SHAPES:
        key = f"fwd_{name}_E{E}"
        report[key] = fwd_report(lib, name, E, steps, reps, clusters)
        print(json.dumps({key: report[key]}), flush=True)
        if not (report[key]["bits_equal_parent"] and report[key]["finite"]
                and all(v["bits_equal_parent"] for v in
                        report[key]["other_clusters"].values())):
            bad.append(key)
    for N in () if args.bwd_only else FWD_BITS:
        key = f"fwd_bits_N{N}"
        report[key] = fwd_bits(lib, N, FWD_BITS_STEPS)
        print(json.dumps({key: report[key]}), flush=True)
        if not all(v for k, v in report[key].items()
                   if k not in ("N", "nt", "layout")):
            bad.append(key)
    for name, E, steps, store, reps in () if args.fwd_only else (
            ("qudits125", 1, 1000, False, 2), ("qudits128", 1, 1000, False, 2),
            ("qudits125", 8, 250, False, 1), ("qudits125", 1, 1000, True, 2)):
        key = f"{name}_E{E}" + ("_stored" if store else "")
        report[key] = shape_report(lib, name, E, steps, store, reps)
        print(json.dumps({key: report[key]}), flush=True)
        bad += [f"{key}/{s}" for s, v in report[key].items()
                if isinstance(v, dict) and "finite" in v
                and not (v["g0_bits_equal_parent"] and v["finite"])]
    line = json.dumps(report)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "rho_mid_parent.json"),
              "w") as f:
        f.write(line + "\n")
    print(line)
    if bad:
        sys.exit(f"outputs differ from the parent's or are not finite: "
                 f"{bad}")


if __name__ == "__main__":
    main()
