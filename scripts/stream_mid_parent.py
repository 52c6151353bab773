"""Hold the mid streamed-plane backward (stream_mid_bwd / chunk_mid_bwd,
csrc/stream_mid.cu) to another commit's build of it, on one CUDA card:
g0's and Hb's bits and the times, interleaved.

Builds, one nvcc each and at once: csrc/stream_mid.cu as checked out (into
build/quandary_tpu_torch/) and the stream_mid.cu of the directory given
with --parent (its quandary_tpu_torch/csrc/), for example the parent
commit:

    mkdir -p build/parent && git archive HEAD~1 quandary_tpu_torch/csrc \\
        | tar -x -C build/parent

The parent is launched through its own C signature (`parent_bind`: a
commit before the backward's 'helpers' schedule takes no helper arguments)
on the chain schedule's shape (`parent_shape`: ops/stream.py's chain
planner, _mid_shape and mid_tracks, unchanged since the pair was written);
the change through ops/stream_mid.py on each backward schedule that fits
the case ('helpers': the replay, the plane-cotangent pass and the column
band's transposition on clusters of their own; 'chain': all of it in each
cluster's chain). Both read one forward's history and stored iterates (the
checkout's forward) and the same seeded cotangents. g0 and Hb must equal
the parent's in bits on every schedule, and a second launch must repeat
them.

Cases (CASES), chip_smoke.py phase 27's systems: stream256 and stream512
(midsize_bench's N = 256 / 512 pure on 'stream', split-4, stored, 1000
steps), chunk256 (N = 256 on 'chunk', neumann-8, replayed, 1000 steps of
0.001 ns), stream512r (N = 512 on 'stream' at split-8, replayed),
chunk1024 (N = 1024 on 'chunk', 300 steps of 0.00025 ns: past 341 steps
its planes exceed the port's plane budget) and open2 (the guarded open CNOT on
'stream', superop at dim 256, B = 16, jacobi-8 replayed, 1221 steps; the
card full: 'chain'). Each case times the backwards with CUDA events in the
order parent, change, change, parent (each of the change's schedules at its
turn). Prints one JSON line per case, each with the card's name and power
limit, and a last one with all of them, also written to
chiprun_out/stream_mid_parent.json; exits non-zero where bits differ.

Forward (--fwd-only): the parent's forward (`parent_fwd`, launched through
its own C signature on its own planner's shape, `parent_fwd_shape`) against
the change's through ops/stream_mid.py, on the planner's layout and on
every other layout that fits the case at the same G (`_layout`). xT, the
history and the stored iterates must equal the parent's in bits on each,
and a second launch must repeat them. Cases (FWD_CASES): stream256,
stream512, chunk256, chunk1024 as above, dense256 and dense1024 (the dense
member on the 'chunk' cases' planes), open2 and stream256e8 (stream256 on
E = 8 candidates, the bench's draw of 8 parameter vectors, E8_STEPS steps:
the full card).
Timed parent, change, change, parent; where the planner takes the global
layout also with no band row resident in shared memory (`_rows=0`, the
rest of the band from L2 and L1 alone: 'l1'). With --ptxas the ptxas lines
(registers, spills) of both builds' forward instances are printed first.
Written to chiprun_out/stream_mid_parent_fwd.json.

    python3 scripts/stream_mid_parent.py --parent build/parent \\
        [--fwd-only [--ptxas]] [--cases a,b] [--steps N] [--reps R]
"""

import argparse
import concurrent.futures
import ctypes
import dataclasses
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch  # noqa: E402

import parent_common as pc  # noqa: E402
from quandary_tpu_torch.ops import stream, stream_mid, streamk  # noqa: E402

CASES = ("stream256", "stream512", "chunk256", "stream512r", "chunk1024",
         "open2")
FWD_CASES = ("stream256", "stream512", "chunk256", "chunk1024", "dense1024",
             "dense256", "open2", "stream256e8")
# stream256e8's steps: its six plane arrays within stream.PLANE_BUDGET_BYTES
# (the gate refuses 1000 steps at E = 8)
E8_STEPS = 600
# the 'chunk' cases' step (ns): dt/2 |d|max = 0.147 at N = 256 (phase 27's
# CHUNK_MID_T over 1000 steps) and 0.163 at N = 1024 (|d|max = 1300.1
# rad/ns), under the 0.215 past which Problem trades plain Neumann-8 for
# jacobi
CHUNK_DT = {256: 0.001, 1024: 0.00025}


def parent_bind(lib, text):
    """The parent's backward entry points as its source `text` declares
    them: 18 pointers, E, nt, B, N, iters, mode, store, dt, a, G, BC,
    threads, shared-memory bytes, slots, tracks, the stream and, where the
    parent has the 'helpers' schedule, its helper arguments (passed as the
    chain schedule)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    head = text.index("#define SM_BWD_PARAMS")
    lib.helpers = "int helpers" in text[head:text.index("#define", head + 8)]
    for name in ("stream_mid_bwd_launch", "chunk_mid_bwd_launch"):
        fn = getattr(lib, name)
        fn.argtypes = ([p] * 18 + [i] * 7 + [f, f] + [i] * 6 + [p]
                       + ([i, i, i, p, p] if lib.helpers else []))
        fn.restype = i


def build_parent(src, name="stream_mid_parent", verbose=False):
    """The parent's stream_mid.cu at `src` built and bound (parent_bind)."""
    return pc.build_parent(src, name, parent_bind, verbose)


def parent_shape(E, B, N, nt, iters, store):
    """The parent's backward launch: (G, Bc, threads, shared-memory bytes,
    layout, tracks) of the chain planner."""
    G, bc, threads, smem, layout = stream._mid_shape(E, B, N, iters, store,
                                                     True)
    return G, bc, threads, smem, layout, stream.mid_tracks(E, B, N, nt, G,
                                                           bc)


def parent_bwd(lib, plan, Hr, Hi, x0r, x0i, hr, hi, ksr, ksi, gTr, gTi, jr,
               ji):
    """One launch of the parent's backward on its own shape: (g0 summed
    over the candidates, Hb (E, nt, N, N) pair), as the parent's
    ops/stream_mid.py::_kernel_bwd returned them."""
    E, nt, N = Hr.shape[0], Hr.shape[1], Hr.shape[-1]
    B = x0r.shape[0]
    G, bc, threads, smem, layout, tracks = parent_shape(
        E, B, N, nt, plan.iters, ksr is not None)
    dev = Hr.device
    g0r = torch.empty((E, B, N), dtype=torch.float32, device=dev)
    g0i = torch.empty_like(g0r)
    Hbr = torch.empty((E, tracks, nt, N, N), dtype=torch.float32, device=dev)
    Hbi = torch.empty_like(Hbr)
    scratch = None
    if layout == "global":
        R = -(-N // G)
        scratch = torch.empty(E * tracks * G * 2 * stream._pad4(R * (N + 1)),
                              dtype=torch.float32, device=dev)
    err = getattr(lib, f"{plan.kind}_mid_bwd_launch")(
        *map(streamk._ptr, (Hr, Hi, x0r, x0i, hr, hi, jr, ji, gTr, gTi,
                            plan.rows, ksr, ksi, g0r, g0i, Hbr, Hbi,
                            scratch)),
        *stream._dims(plan, E, nt, B, N), G, bc, threads, smem,
        stream.MID_SLOTS[layout], tracks,
        torch.cuda.current_stream(dev).cuda_stream,
        *((-1, 0, 0, None, None) if lib.helpers else ()))
    if err != 0:
        raise RuntimeError(f"parent {plan.kind}_mid_bwd launch failed: CUDA "
                           f"error {err}")
    if tracks == 1:
        return g0r.sum(0), g0i.sum(0), Hbr[:, 0], Hbi[:, 0]
    return g0r.sum(0), g0i.sum(0), Hbr.sum(1), Hbi.sum(1)


def parent_fwd_bind(lib, text):
    """The parent's forward entry points as its source `text` declares
    them: 11 pointers, E, nt, B, N, iters, mode, store, dt, a, G, BC,
    threads, shared-memory bytes, slots, where the parent has them its
    band rows in shared memory past the slots, and the stream."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    head = text.index("#define SM_FWD_PARAMS")
    params = text[head:text.index("#define", head + 8)]
    lib.fwd_rows = "int band_rows" in params
    for name in ("stream_mid_fwd_launch", "chunk_mid_fwd_launch",
                 "dense_mid_fwd_launch"):
        fn = getattr(lib, name)
        fn.argtypes = ([p] * 11 + [i] * 7 + [f, f] + [i] * 5
                       + [i] * lib.fwd_rows + [p])
        fn.restype = i


def parent_fwd_shape(E, B, N, iters, store):
    """The forward's launch as a890352's planner gave it: (G, Bc, slots,
    threads, shared-memory bytes), its shared memory `slots` whole row bands
    (two: 'smem2', one: 'smem1', none: 'global'), two operand buffers, the
    bands of x, b, k and the solver rows."""
    def floats(G, bc, slots):
        R = -(-N // G)
        return (slots * 2 * stream._pad4(R * N) + 4 * bc * N + 6 * bc * R
                + 4 * R)
    return streamk.cluster_shape(E, B, N, floats, max_slots=2)


def parent_fwd(lib, plan, Hr, Hi, x0r, x0i):
    """One launch of the parent's forward on its own shape: (xTr, xTi, hr,
    hi, ksr, ksi) as ops/stream_mid.py::_kernel_fwd returns them."""
    E, nt, N = Hr.shape[0], Hr.shape[1], Hr.shape[-1]
    B = x0r.shape[0]
    store = plan.store_iters and plan.iters > 0
    G, bc, slots, threads, smem = parent_fwd_shape(E, B, N, plan.iters,
                                                   store)
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=Hr.device)
    xTr, xTi = new(E, B, N), new(E, B, N)
    hr = hi = ksr = ksi = None
    if plan.kind != "dense":
        hr, hi = new(E, nt, B, N), new(E, nt, B, N)
    if store:
        ksr, ksi = new(E, nt, plan.iters, B, N), new(E, nt, plan.iters, B, N)
    err = getattr(lib, f"{plan.kind}_mid_fwd_launch")(
        *map(streamk._ptr, (Hr, Hi, x0r, x0i, plan.rows, xTr, xTi, hr, hi,
                            ksr, ksi)),
        *stream._dims(plan, E, nt, B, N), G, bc, threads, smem, slots,
        *((0,) if lib.fwd_rows else ()),
        torch.cuda.current_stream(Hr.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"parent {plan.kind}_mid_fwd launch failed: CUDA "
                           f"error {err}")
    return xTr, xTi, hr, hi, ksr, ksi


def case_problem(name, steps=None):
    """The Problem of a case (its own depth unless `steps`)."""
    import chip_smoke as cs
    from quandary_tpu_torch.problem import Problem
    if name == "open2":
        setup = cs.open_cnot_setup(True, **({} if steps is None
                                            else dict(ntime=steps)))
        return Problem(dataclasses.replace(setup, fused_mode="stream"))
    N = int(re.search(r"\d+", name).group())
    if name.startswith("chunk"):
        nt = steps or (300 if N == 1024 else 1000)
        setup = cs.midsize_closed_setup(
            N, "pure", ntime=nt, T=CHUNK_DT[N] * nt, linsolver="neumann",
            iters=8)
        mode = "chunk"
    else:
        setup = cs.midsize_closed_setup(N, "pure", ntime=steps or 1000,
                                        iters=8 if name.endswith("r")
                                        else 4)
        mode = "stream"
    return Problem(dataclasses.replace(setup, fused_mode=mode))


def case_inputs(name, steps=None, seed=22):
    """(plan, backward inputs) of a case: the planes of the bench's
    parameter draw, the checkout's forward (history, stored iterates) and
    seeded normal cotangents gT, j. The inputs are (Hr, Hi, x0r, x0i, hr,
    hi, ksr, ksi, gTr, gTi, jr, ji), the backward's arguments after the
    plan."""
    import chip_smoke as cs
    pr = case_problem(name, steps)
    plan = pr._plan
    P = torch.as_tensor(cs.bench_params(pr.setup.nparams), device="cuda",
                        dtype=torch.float32)[None]
    with torch.no_grad():
        C = pr.coeff_rows_mid(P)[..., 0, :].contiguous()
        H = [h.contiguous() for h in stream.planes(plan, pr._Sr, pr._Si, C)]
    fwd = stream_mid._kernel_fwd(plan, *H, pr._x0r, pr._x0i)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = lambda t: torch.randn(t.shape, device="cuda", generator=gen)
    return plan, (*H, pr._x0r, pr._x0i, *fwd[2:], w(fwd[0]), w(fwd[1]),
                  w(fwd[2]), w(fwd[3]))


def fwd_case_inputs(name, steps=None):
    """(plan, (Hr, Hi, x0r, x0i)) of a forward case: the planes of the
    bench's parameter draw (8 draws for the e8 cases), the dense cases on
    the 'chunk' cases' problems with a dense plan."""
    import chip_smoke as cs
    E = 8 if name.endswith("e8") else None
    pr = case_problem(name.replace("dense", "chunk").replace("e8", ""),
                      steps or (E8_STEPS if E else None))
    plan = pr._plan
    if name.startswith("dense"):
        plan = stream.make_plan(pr._Sr, pr.setup.dt, 8, kind="dense")
    P = torch.as_tensor(cs.bench_params(pr.setup.nparams, E), device="cuda",
                        dtype=torch.float32)
    with torch.no_grad():
        C = pr.coeff_rows_mid(P if E else P[None])[..., 0, :].contiguous()
        H = [h.contiguous() for h in stream.planes(plan, pr._Sr, pr._Si, C)]
    return plan, (*H, pr._x0r, pr._x0i)


def same_bits(a, b):
    """Every output of two forwards equal in bits (None where not made)."""
    return all((u is None and v is None) or (
        u is not None and v is not None and torch.equal(u, v))
        for u, v in zip(a, b))


def fwd_report(lib, name, steps, reps):
    plan, ins = fwd_case_inputs(name, steps)
    E, nt, N = ins[0].shape[0], ins[0].shape[1], ins[0].shape[-1]
    B = ins[2].shape[0]
    runs = {"parent": lambda: parent_fwd(lib, plan, *ins),
            "change": lambda: stream_mid._kernel_fwd(plan, *ins)}
    ref = runs["parent"]()
    got = runs["change"]()
    shape = dict(stream_mid.mid_layouts["fwd"])
    rep = dict(E=E, B=B, N=N, iters=plan.iters, nt=nt, kind=plan.kind,
               stored=got[4] is not None, shape=shape,
               parent_shape=parent_fwd_shape(E, B, N, plan.iters,
                                             got[4] is not None),
               bits_equal_parent=same_bits(got, ref),
               repeat_bits=same_bits(got, runs["change"]()),
               finite=all(bool(torch.isfinite(t).all()) for t in got
                          if t is not None))
    del got
    layouts = {}
    for lay in stream.MID_SLOTS:
        if lay == shape["layout"]:
            continue
        try:
            out = stream_mid._kernel_fwd(plan, *ins, _layout=lay)
        except NotImplementedError:
            continue
        layouts[lay] = dict(stream_mid.mid_layouts["fwd"],
                            bits_equal_parent=same_bits(out, ref))
        del out
    if shape["layout"] == "global":
        runs["l1"] = lambda: stream_mid._kernel_fwd(plan, *ins, _rows=0)
        layouts["l1"] = dict(bits_equal_parent=same_bits(runs["l1"](), ref))
    rep["layouts"] = layouts
    del ref
    ms = pc.interleaved(runs, "parent", reps)
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    rep.update(ms=ms, ratio={k: mean[k] / mean["parent"] for k in runs
                             if k != "parent"},
               us_per_step={k: 1e3 * v / nt for k, v in mean.items()},
               card=pc.smi_line())
    rep["ok"] = (rep["bits_equal_parent"] and rep["repeat_bits"]
                 and rep["finite"]
                 and all(v["bits_equal_parent"] for v in layouts.values()))
    return rep


def ptxas_lines(log):
    """ptxas's lines of the forward's instances (registers, spills)."""
    lines, keep = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties" in ln:
            keep = "stream_mid_fwd" in ln
        if keep and ("registers" in ln or "spill" in ln
                     or "Compiling entry" in ln):
            lines.append(ln.strip())
    return lines


def schedules_of(plan, ins):
    """The change's backward schedules that fit the case."""
    E, nt, N = ins[0].shape[0], ins[0].shape[1], ins[0].shape[-1]
    out = []
    for s in stream.MID_SCHEDULES:
        try:
            stream.mid_bwd_schedule(E, ins[2].shape[0], N, plan.iters, nt,
                                    ins[6] is not None, plan.kind, s)
            out.append(s)
        except ValueError:
            pass
    return out


def case_report(lib, name, steps, reps):
    plan, ins = case_inputs(name, steps)
    schedules = schedules_of(plan, ins)
    runs = {"parent": lambda: parent_bwd(lib, plan, *ins)}
    for s in schedules:
        runs[s] = (lambda s=s: stream_mid._kernel_bwd(plan, *ins,
                                                      _schedule=s))
    ref = runs["parent"]()
    out, shapes = {}, {}
    for s in schedules:
        out[s] = (runs[s](), runs[s]())
        shapes[s] = dict(stream_mid.mid_layouts["bwd"])
    stream_mid._kernel_bwd(plan, *ins)
    planner = stream_mid.mid_layouts["bwd"]["schedule"]
    ms = pc.interleaved(runs, "parent", reps)
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    E, nt, N = ins[0].shape[0], ins[0].shape[1], ins[0].shape[-1]
    rep = dict(E=E, B=ins[2].shape[0], N=N, iters=plan.iters, nt=nt,
               kind=plan.kind, stored=ins[6] is not None, planner=planner,
               ms=ms, parent_shape=parent_shape(
                   E, ins[2].shape[0], N, nt, plan.iters, ins[6] is not None),
               ratio={k: mean[k] / mean["parent"] for k in schedules},
               us_per_step={k: 1e3 * v / nt for k, v in mean.items()},
               card=pc.smi_line())
    for s in schedules:
        got, again = out[s]
        rep[s] = dict(
            shape=shapes[s],
            g0_bits_equal_parent=all(torch.equal(a, b) for a, b in
                                     zip(got[:2], ref[:2])),
            hb_bits_equal_parent=all(torch.equal(a, b) for a, b in
                                     zip(got[2:], ref[2:])),
            repeat_bits=all(torch.equal(a, b) for a, b in zip(got, again)),
            finite=all(bool(torch.isfinite(t).all()) for t in got))
    return rep


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=os.path.join(ROOT, "build", "parent"),
                    help="a directory holding the other commit's "
                         "quandary_tpu_torch/csrc/")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps of every case (default: each its own)")
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--cases", default=None)
    ap.add_argument("--fwd-only", action="store_true",
                    help="the forward instead of the backward")
    ap.add_argument("--ptxas", action="store_true",
                    help="with --fwd-only: print the forward instances' "
                         "ptxas lines of both builds")
    args = ap.parse_args()
    args.cases = args.cases or ",".join(FWD_CASES if args.fwd_only
                                        else CASES)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    src = os.path.join(args.parent, "quandary_tpu_torch", "csrc",
                       "stream_mid.cu")
    if not os.path.isfile(src):
        sys.exit(f"{args.parent} holds no quandary_tpu_torch/csrc/"
                 "stream_mid.cu")
    if args.fwd_only:
        return fwd_main(args, src)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        fp = pool.submit(build_parent, src)
        fc = pool.submit(stream_mid.build_kernels)
        lib = fp.result()
        fc.result()
    report = {"card": pc.smi_line()}
    bad = []
    for name in args.cases.split(","):
        report[name] = case_report(lib, name, args.steps, args.reps)
        print(json.dumps({name: report[name]}), flush=True)
        bad += [f"{name}/{s}" for s, v in report[name].items()
                if isinstance(v, dict) and "finite" in v
                and not (v["g0_bits_equal_parent"] and v["hb_bits_equal_parent"]
                         and v["repeat_bits"] and v["finite"])]
        torch.cuda.empty_cache()
    line = json.dumps(report)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "stream_mid_parent.json"),
              "w") as f:
        f.write(line + "\n")
    print(line)
    if bad:
        sys.exit(f"g0 or Hb differ from the parent's, a repeat differs, or "
                 f"an output is not finite: {bad}")


def fwd_main(args, src):
    """The --fwd-only report."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        fp = pool.submit(pc.build_parent, src, "stream_mid_parent_fwd",
                         parent_fwd_bind, args.ptxas)
        fc = pool.submit(stream_mid.build_kernels, args.ptxas)
        lib = fp.result()
        log = fc.result()[2]
    if args.ptxas:
        lib, plog = lib
        print(json.dumps(dict(parent=ptxas_lines(plog),
                              change=ptxas_lines(log))), flush=True)
    report = {"card": pc.smi_line()}
    bad = []
    for name in args.cases.split(","):
        report[name] = fwd_report(lib, name, args.steps, args.reps)
        print(json.dumps({name: report[name]}), flush=True)
        if not report[name]["ok"]:
            bad.append(name)
        torch.cuda.empty_cache()
    line = json.dumps(report)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "stream_mid_parent_fwd.json"),
              "w") as f:
        f.write(line + "\n")
    print(line)
    if bad:
        sys.exit(f"xT, the history or the stored iterates differ from the "
                 f"parent's, a repeat differs, or an output is not finite: "
                 f"{bad}")


if __name__ == "__main__":
    main()
