"""Time the streamed-plane kernels of csrc/stream.cu (stream_fwd, chunk_fwd,
dense_fwd, stream_bwd, chunk_bwd) against another commit's build of the
same source, and their two compile-time instances against each other, on
one CUDA card; and hold the kernels that share its header (streamk_fwd /
streamk_bwd, rho_fwd / rho_bwd) to their bits and times in that build.

Builds, one nvcc each and all at once, into build/quandary_tpu_torch/:
  * change: csrc/stream.cu, streamk.cu and rho.cu as checked out
    (stream_fwd<., 16> and stream_bwd<16, 512> at N = 16 with helper
    warps);
  * generic: csrc/stream.cu with -DSTREAMK_NC=0 (stream_fwd<., 0> and
    stream_bwd<0, .> at every N);
  * parent: stream.cu, streamk.cu and rho.cu of the directory given with
    --parent (its quandary_tpu_torch/csrc/), for example the parent commit:

        git archive HEAD~1 quandary_tpu_torch/csrc | tar -x -C build/parent

    Its kernels are launched on the shapes parent_shape gives them: the
    one-block forward that preceded the split-role one (streamk._threads,
    its layout's floats copied below) and the backward's role layout.

Shapes, as chip_smoke.py phases 17-21 build them: the 'stream' route at the
CNOT flagship (split-3, stored iterates) at E = 1 and E = 128 and with
jacobi-8 (replayed) at E = 1; the 'chunk' route and the dense forward at
ntime 4884 (neumann-8, replayed); streamK at the flagship, E = 1 and 128;
rho at open configuration 2 (N = 16, E = 1). Then random non-Hermitian
stacks (seed 21) at the sizes the generic instances take: N = 27 at B = 3
(split-3 stored, jacobi-6 replayed), N = 8 at B = 8, N = 52 at B = 4
(helper warps, 1024 threads) and N = 154 at B = 4 (the inline branches,
200 steps). Each N = 16 shape times its kernels with CUDA events in the
order parent, change, generic, generic, change, parent (the generic build
only where it differs: the stream.cu kernels at N = 16), the others parent,
change, change, parent; the outputs of one more launch per build are
compared: every kernel must have the parent's bits (the forwards' xT,
history and stored iterates, the backwards' g0 and Hb: both chains keep
apply_T's and apply_Tt's order of terms), and the <16> instances those of
the <0> ones. Prints one JSON line per shape as it goes (with each kernel's
change / parent time ratio) and a last one with all of them and the card's
name and power limit; exits non-zero if any bits differ.

    python3 scripts/stream_parent.py --parent build/parent
"""

import argparse
import concurrent.futures
import contextlib
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from quandary_tpu_torch.ops import (cuda_build, rho, stream,  # noqa: E402
                                    streamk)
from quandary_tpu_torch.problem import Problem  # noqa: E402

MODULES = {"stream": stream, "streamk": streamk, "rho": rho}


def nvcc(src, out, *flags):
    """Build `src` into the shared library `out` and load it: (lib, out)."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    res = subprocess.run(cuda_build.nvcc_command(src, out) + list(flags),
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {src} failed:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(out), out


def build_all(parent):
    """{build: {module name: (lib, path)}} for change, generic and parent;
    every source of every build compiled at once."""
    jobs = {("change", m): mod.build_kernels for m, mod in MODULES.items()}
    out_dir = os.path.join(cuda_build.BUILD_DIR, "stream_parent")
    jobs[("generic", "stream")] = lambda: nvcc(
        stream._SRC, os.path.join(out_dir, "libstream_generic.so"),
        "-DSTREAMK_NC=0")
    for m in MODULES:
        src = os.path.join(parent, "quandary_tpu_torch", "csrc", f"{m}.cu")
        jobs[("parent", m)] = (lambda s=src, m=m: nvcc(
            s, os.path.join(out_dir, f"lib{m}_parent.so")))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(fn) for k, fn in jobs.items()}
        done = {k: f.result() for k, f in futs.items()}
    libs = {"change": {}, "generic": {}, "parent": {}}
    for (which, m), res in done.items():
        if which == "change":
            res = cuda_build.LIBS[MODULES[m]._SRC]
        else:
            MODULES[m]._bind(res[0])
        libs[which][m] = res
    return libs


def parent_shape(plan, E, nt, B, N, backward):
    """The launch shape the parent's ops/stream.py gave each direction: the
    backward's _bwd_shape (the role layout, unchanged since), and for the
    one-block forward that preceded the split-role one one block of
    streamk._threads(B, N) with the H planes, the pre-state and iters + 1
    slots of stage iterates."""
    why = stream.launch_refusal(plan, B, N, nt, E)
    if why is not None:
        raise NotImplementedError(why)
    if backward:
        return stream._bwd_shape(plan.iters, B, N)[:2]
    BN = B * N
    return streamk._threads(B, N), 4 * (2 * N * (N + 1) + 2 * BN
                                        + 2 * (plan.iters + 1) * BN)


@contextlib.contextmanager
def using(libs, which):
    """The modules launch the kernels of build `which` (generic: only
    stream.cu differs) on that build's launch shape."""
    saved = dict(cuda_build.LIBS)
    shape = stream._launch_shape
    for m, entry in libs.get(which, {}).items():
        cuda_build.LIBS[MODULES[m]._SRC] = entry
    if which == "parent":
        stream._launch_shape = parent_shape
    try:
        yield
    finally:
        cuda_build.LIBS.clear()
        cuda_build.LIBS.update(saved)
        stream._launch_shape = shape


def interleaved(libs, order, time_fn, run_fn):
    """{build: [time_fn() per visit]} over `order`, and {build: run_fn()}
    once per build, on the first visit."""
    times, outs = {}, {}
    for which in order:
        with using(libs, which):
            times.setdefault(which, []).append(time_fn())
            if which not in outs:
                outs[which] = run_fn()
    torch.cuda.synchronize()
    return times, outs


def same_bits(a, b):
    return all(x is None and y is None or torch.equal(x, y)
               for x, y in zip(a, b))


def ratios(times):
    """Each build's mean time over the parent's."""
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    return {k: v / mean["parent"] for k, v in mean.items() if k != "parent"}


def stream_shape(libs, plan, Hr, Hi, x0r, x0i, reps, rng):
    """The plan member's forward and (but for 'dense') backward on one
    shape."""
    E, nt = Hr.shape[:2]
    B, N = x0r.shape
    dense = plan.kind == "dense"
    order = ("parent", "change", "generic", "generic", "change", "parent") \
        if N == 16 else ("parent", "change", "change", "parent")
    w = lambda *s: torch.as_tensor(rng.normal(size=s), device="cuda",
                                   dtype=torch.float32)
    gT, jh = (w(E, B, N), w(E, B, N)), (w(E, nt, B, N), w(E, nt, B, N))

    def run():
        fwd = stream._kernel_fwd(plan, Hr, Hi, x0r, x0i)
        return fwd, () if dense else stream._kernel_bwd(
            plan, Hr, Hi, x0r, x0i, *fwd[2:], *gT, *jh)

    times, outs = interleaved(
        libs, order,
        lambda: cs.stream_kernel_ms(plan, Hr, Hi, x0r, x0i, reps, False),
        run)
    fwd_ms = {k: [t["fwd"] for t in v] for k, v in times.items()}
    gen = outs.get("generic", outs["change"])
    threads, smem, helpers = stream._fwd_shape(B, N)
    out = dict(
        E=E, nt=nt, B=B, N=N, iters=plan.iters, stored=plan.store_iters,
        fwd_threads=threads, fwd_smem=smem, fwd_helpers=helpers,
        fwd_ms=fwd_ms, fwd_ratio=ratios(fwd_ms),
        fwd_us_per_step={k: 1e3 * min(v) / nt for k, v in fwd_ms.items()},
        fwd_bits_equal_generic=same_bits(outs["change"][0], gen[0]),
        bits_equal_parent=same_bits(outs["change"][0], outs["parent"][0])
        and same_bits(outs["change"][1], outs["parent"][1]),
        finite=all(bool(torch.isfinite(t).all()) for t in outs["change"][0]
                   + outs["change"][1] if t is not None))
    if not dense:
        bwd_ms = {k: [t["bwd"] for t in v] for k, v in times.items()}
        threads, smem, helpers = stream._bwd_shape(plan.iters, B, N)
        out.update(
            bwd_threads=threads, bwd_smem=smem, bwd_helpers=helpers,
            bwd_ms=bwd_ms, bwd_ratio=ratios(bwd_ms),
            bwd_us_per_step={k: 1e3 * min(v) / nt for k, v in bwd_ms.items()},
            bwd_bits_equal_generic=same_bits(outs["change"][1], gen[1]))
    return out


def timed(times, outs):
    """A control kernel pair's times, ratios and bits against the parent."""
    fwd_ms = {k: [t["fwd"] for t in v] for k, v in times.items()}
    bwd_ms = {k: [t["bwd"] for t in v] for k, v in times.items()}
    return dict(fwd_ms=fwd_ms, fwd_ratio=ratios(fwd_ms), bwd_ms=bwd_ms,
                bwd_ratio=ratios(bwd_ms),
                bits_equal_parent=same_bits(outs["change"][0],
                                            outs["parent"][0])
                and same_bits(outs["change"][1], outs["parent"][1]))


def synthetic(solver, iters, B, N, nt, rng, K=5):
    """A plan, its (1, nt, N, N) planes and x0 on random non-Hermitian
    stacks of norm about 1 (dt 0.01)."""
    card = lambda a: torch.as_tensor(np.ascontiguousarray(a), device="cuda",
                                     dtype=torch.float32)
    stack = ((rng.normal(size=(K, N, N)) + 1j * rng.normal(size=(K, N, N)))
             / np.sqrt(N)).astype(np.complex64)
    plan = stream.make_plan(card(stack.real), 0.01, iters,
                            -1j * np.diag(stack[0]).astype(np.complex128),
                            solver)
    C = card(rng.normal(size=(1, nt, K)) * 0.3)
    with torch.no_grad():
        H = [h.contiguous() for h in stream.planes(
            plan, card(stack.real), card(stack.imag), C)]
    x0 = rng.normal(size=(2, B, N))
    return plan, H, card(x0[0]), card(x0[1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=os.path.join(ROOT, "build", "parent"),
                    help="a directory holding the other commit's "
                         "quandary_tpu_torch/csrc/")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    if not os.path.isfile(os.path.join(args.parent, "quandary_tpu_torch",
                                       "csrc", "stream.cu")):
        sys.exit(f"{args.parent} holds no quandary_tpu_torch/csrc/stream.cu")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    libs = build_all(args.parent)
    to_card = lambda a: torch.as_tensor(a, device="cuda",
                                        dtype=torch.float32)
    rng = np.random.default_rng(21)
    report = {"card": smi}

    # the streamed-plane kernels
    x1 = to_card(cs.bench_params(cs.flagship_setup().nparams, 1))
    xE = to_card(cs.bench_params(cs.flagship_setup().nparams, cs.E_BIG,
                                 seed=7))
    ps = Problem(cs.flagship_setup(fused_mode="stream"))
    pj = Problem(cs.flagship_setup("neumann", 8, fused_mode="stream"))
    pc = Problem(cs.flagship_setup("neumann", 8, ntime=cs.NT_FINE,
                                   fused_mode="chunk"))
    dplan = stream.make_plan(pc._Sr, pc.setup.dt, 8, kind="dense")
    for name, pr, plan, P, reps in (
            ("stream_split3_E1", ps, ps._plan, x1, 50),
            (f"stream_split3_E{cs.E_BIG}", ps, ps._plan, xE, 20),
            ("stream_jacobi8_E1", pj, pj._plan, x1, 20),
            ("chunk_neumann8_E1", pc, pc._plan, x1, 10),
            ("dense_neumann8_E1", pc, dplan, x1, 10)):
        with torch.no_grad():
            H = [h.contiguous() for h in stream.planes(
                plan, pr._Sr, pr._Si, pr.coeff_rows_mid(P)[..., 0, :])]
        report[name] = stream_shape(libs, plan, *H, pr._x0r, pr._x0i, reps,
                                    rng)
        del H
        print(json.dumps({name: report[name]}), flush=True)

    for name, solver, iters, B, N, nt, reps in (
            ("stream_split3_N27", "split", 3, 3, 27, 1221, 10),
            ("stream_jacobi6_N27", "jacobi", 6, 3, 27, 1221, 5),
            ("stream_split3_N8_B8", "split", 3, 8, 8, 1221, 10),
            ("stream_split3_N52", "split", 3, 4, 52, 1221, 5),
            ("stream_split3_N154_inline", "split", 3, 4, 154, 200, 3)):
        plan, H, x0r, x0i = synthetic(solver, iters, B, N, nt, rng)
        report[name] = stream_shape(libs, plan, *H, x0r, x0i, reps, rng)
        del H
        print(json.dumps({name: report[name]}), flush=True)

    # streamK and rho: the parent's bits and times
    prob = Problem(cs.flagship_setup())
    ones = lambda t: torch.ones_like(t)
    for name, P, reps in (("streamk_E1", x1, 50),
                          (f"streamk_E{cs.E_BIG}", xE, 20)):
        C = streamk.extend_coeffs(prob._plan,
                                  prob.coeff_rows_mid(P)[..., 0, :])
        plan, x0r, x0i = prob._plan, prob._x0r, prob._x0i

        def run():
            f = streamk._kernel_fwd(plan, x0r, x0i, C)
            return f, streamk._kernel_bwd(plan, x0r, x0i, C, *f[2:],
                                          ones(f[0]), ones(f[0]), ones(f[2]),
                                          ones(f[2]))

        times, outs = interleaved(
            libs, ("parent", "change", "change", "parent"),
            lambda: cs.kernel_ms(plan, x0r, x0i, C, reps, 0), run)
        report[name] = timed(times, outs)
        print(json.dumps({name: report[name]}), flush=True)
    p16 = Problem(cs.OPEN_CONFIGS["cnot16"]())
    C = p16.coeff_rows_mid(to_card(cs.bench_params(p16.setup.nparams, 1,
                                                   seed=7)))[..., 0, :]
    C = C.contiguous()
    plan, x0r, x0i = p16._plan, p16._x0r, p16._x0i

    def run_rho():
        f = rho._kernel_fwd(plan, x0r, x0i, C)
        return f, rho._kernel_bwd(plan, x0r, x0i, C, *f[2:], ones(f[0]),
                                  ones(f[0]), ones(f[2]), ones(f[2]))

    times, outs = interleaved(
        libs, ("parent", "change", "change", "parent"),
        lambda: cs.rho_kernel_ms(plan, x0r, x0i, C, 3, False), run_rho)
    report["rho_cnot16_E1"] = timed(times, outs)
    print(json.dumps({"rho_cnot16_E1": report["rho_cnot16_E1"]}), flush=True)

    print(json.dumps(report))
    kept = [k for k, v in report.items() if isinstance(v, dict) and not (
        v["bits_equal_parent"] and v.get("fwd_bits_equal_generic", True)
        and v.get("bwd_bits_equal_generic", True) and v.get("finite", True))]
    if kept:
        sys.exit(f"outputs that must keep the parent's bits differ: {kept}")


if __name__ == "__main__":
    main()
