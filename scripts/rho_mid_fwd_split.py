"""Split one step of the mid density-matrix forward (rho_mid_fwd of the
csrc/rho_mid.cu before its redesign, one CTA per band of rows with M^T and
the jump planes read from device memory and the operand pushed by st.async)
into its parts, on one CUDA card, by timing variants of its source: each
variant is the source with a few lines removed, replaced or doubled, built
into its own library and launched through the forward's launcher
(`rho_mid_parent.parent_fwd`). Only the source's results are right; a
variant's time is all that is used.

Variants (the forward's time loop):
  source          as it is (iterates not stored, as at full depth)
  no_contract     the contraction of M's band into the scratch
  no_mv           the product M v (M read from L2)
  no_vmdag        the product v M^dag (M^T read from L2)
  no_jump_first   the jump first factors L_l v (L_l by plain loads)
  no_jump_second  the jump second factors (L_l v) L_l^dag (L_l^dag by
                  plain loads)
  no_exchange     the st.async pushes of the operand to the other CTAs
                  (and the bytes the mbarrier expects); the local stores
                  and the cluster barrier stay
  barrier_x2      a second cluster barrier beside each stage's: the cost
                  of one barrier (removing it would let the exchange race)
  no_hist         the history writes

With --new, the same for the redesigned forward (csrc/rho_mid_fwd.cu, the
checkout's unless --src names another), launched through
ops/rho_mid.py::_kernel_fwd on each variant's library (NEW_VARIANTS):
  no_whole_products  the products that read a whole factor from device
                     memory: v M^dag and (L_l v) L_l^dag
  no_mv, no_jump_first, no_exchange (the bulk pushes), barrier_x2
                     as above
  plain_wait         the operand's wait without its trap after
                     WAIT_LIMIT_NS
  unroll_8           the products' loops unrolled 8 times at every tile
and the source on other layouts (NEW_LAYOUTS: 4 rows a thread, one jump
first factor at a time, the jump bands from L2), where they fit.

Shapes: chip_smoke.py's qudits125 (N = 125, K = 11, J = 6, B = 3,
jacobi-6, G = 16) and qudits128 (N = 128, K = 7, J = 4) at E = 1 cut to
--steps steps, and qudits125 at E = 8 (E B = 24, G = 4, tile 4) cut to
--steps-wide. Each shape times every variant with CUDA events in the order
of VARIANTS there and back, and reports us per step of each part (the
source's time less the variant's; the barrier's the variant's less the
source's, times the stage barriers a step) and per T. Prints one JSON line
per shape, then one with all of them and the card's name and power limit,
also written to chiprun_out/rho_mid_fwd_split.json.

    python3 scripts/rho_mid_fwd_split.py [--src DIR] [--steps 200]

DIR holds the quandary_tpu_torch/csrc/rho_mid.cu to split (default:
build/parent, unpacked as scripts/rho_mid_parent.py says).
"""

import argparse
import concurrent.futures
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import rho_mid_parent as rp  # noqa: E402
from quandary_tpu_torch.ops import cuda_build  # noqa: E402

BARRIER = ("    cluster_sync();     // every CTA has finished reading the "
           "operand\n")
VARIANTS = {
    "source": (),
    "no_contract": ((
        "    contract_band(Sr, Si, C + st * d.K, d.K, N, r0, R, nullptr, "
        "nullptr, Mt,\n                  Mt + NN);\n", ""),),
    "no_mv": ((
        "    cmm<TS, false, false, LdG, LdS>(accr, acci, g.Mr, g.Mi, 1, N, "
        "vr, vi, ld,\n                                    1, r, c, N);\n",
        ""),),
    "no_vmdag": ((
        "    cmm<TS, false, true, LdS, LdG>(accr, acci, vr, vi, ld, 1, g.Mr, "
        "g.Mi, N,\n                                   1, r, c, N);\n", ""),),
    "no_jump_first": ((
        "      cmm<TS, false, false, LdS, LdS>(zr, zi, Ar, Ai, N, 1, vr, vi, "
        "ld, 1, r,\n                                      c, N);\n", ""),),
    "no_jump_second": ((
        "      cmm<TS, false, false, LdS, LdS>(accr, acci, tr, tr + bplane, "
        "ld, 1, Br,\n                                      Bi, N, 1, rl, c, "
        "N);\n", ""),),
    "no_exchange": ((
        "    push(F + so, vr, bar, G, rank);\n"
        "    push(F + plane + so, vi, bar, G, rank);\n", ""), (
        "  Exchange ex{F, plane, G, rank, bars,\n"
        "              threadIdx.x == 0 ? 8u * N * (N - R) : 0u, 0};\n"
        "  if (threadIdx.x == 0) {\n    bar_init(bars, blockDim.x);\n",
        "  Exchange ex{F, plane, G, rank, bars, 0u, 0};\n"
        "  if (threadIdx.x == 0) {\n    bar_init(bars, blockDim.x);\n")),
    "barrier_x2": ((BARRIER, BARRIER + BARRIER),),
    "no_hist": (("        hr[h] = xr[a][b];\n        hi[h] = xi[a][b];\n",
                 ""),),
}
PARTS = {"no_contract": "contraction", "no_mv": "mv", "no_vmdag": "vmdag",
         "no_jump_first": "jump_first", "no_jump_second": "jump_second",
         "no_exchange": "exchange", "no_hist": "history"}
NEW_VARIANTS = {
    "source": (),
    "no_whole_products": ((
        "    band_mma<TR, true, LdG>(accr, acci, vB + rl0, Rp, Mt + c0, ldc, "
        "N);\n", ""), (
        "        band_mma<TR, false, LdR>(accr, acci, tb + (l - l0) * band + "
        "rl0, Rp,\n                                 Lp + (size_t)l * N * ldc "
        "+ c0, ldc, N);\n", "        (void)l;\n")),
    "no_mv": ((
        "    band_mma<TR, false, LdS>(accr, acci, MB + rl0, Rp, F + c0, ldc, "
        "N);\n", ""),),
    "no_jump_first": ((
        "        if (lres)\n"
        "          band_mma<TR, false, LdS>(zr, zi, LB + l * band + rl0, Rp, "
        "F + c0,\n                                   ldc, N);\n"
        "        else\n"
        "          band_mma_gx<TR>(zr, zi, Lp + (size_t)l * N * ldc, xa, ldc, "
        "F + c0,\n                          ldc, N);\n", ""),),
    "no_exchange": ((
        "      bulk_push(mapa(src, q), src, 8u * R * ldc, mapa(fbar, q));\n",
        ""), (
        "  w.tx = tid == 0 ? 8u * ldc * (N - w.R) : 0u;\n",
        "  w.tx = 0u;\n")),
    "barrier_x2": ((
        "      cluster_sync();   // every CTA has finished reading the "
        "operand\n", "      cluster_sync();   // every CTA has finished "
        "reading the operand\n      cluster_sync();\n"),),
    "plain_wait": (("bar_wait_bounded(", "bar_wait("),),
    "unroll_8": (("#pragma unroll(TR <= 2 ? 8 : 4)", "#pragma unroll 8"),),
}
NEW_PARTS = {"no_whole_products": "whole_factor_products", "no_mv": "mv",
             "no_jump_first": "jump_first", "no_exchange": "exchange",
             "plain_wait": "wait_traps"}
NEW_LAYOUTS = {"tile4": dict(tile=4), "jb1": dict(jb=1),
               "jump_bands_l2": dict(lres=0)}
# (configuration, candidates, steps argument)
SHAPES = (("qudits125", 1, "steps"), ("qudits128", 1, "steps"),
          ("qudits125", 8, "steps_wide"))


def variant_sources(src, variants=VARIANTS):
    """{name: path of its source}, written into the build directory (beside
    the headers of the source's directory)."""
    with open(src) as f:
        text0 = f.read()
    out_dir = os.path.join(cuda_build.BUILD_DIR, "rho_mid_fwd_split")
    os.makedirs(out_dir, exist_ok=True)
    for h in os.listdir(os.path.dirname(src)):
        if h.endswith(".cuh"):
            with open(os.path.join(os.path.dirname(src), h)) as f, \
                    open(os.path.join(out_dir, h), "w") as g:
                g.write(f.read())
    paths = {}
    for name, subs in variants.items():
        text = text0
        for old, new in subs:
            if text.count(old) != 1 and not old.endswith("("):
                sys.exit(f"{name}: {src} does not hold {old!r} once")
            text = text.replace(old, new)
        paths[name] = os.path.join(out_dir, f"rho_mid_{name}.cu")
        with open(paths[name], "w") as f:
            f.write(text)
    return paths


def split(ms, nt, iters):
    """us per step of each part from the variants' mean times, and us per
    T (iters + 1 a step) of the step and of each product."""
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    full = mean["source"]
    us = lambda t: 1e3 * t / nt
    parts = {PARTS[k]: us(full - mean[k]) for k in PARTS}
    # one cluster barrier, times the iters stage barriers and the step's
    parts["cluster_barriers"] = us(mean["barrier_x2"] - full) \
        * (iters + 1) / max(iters, 1)
    parts["step"] = us(full)
    parts["rest"] = parts["step"] - sum(v for k, v in parts.items()
                                        if k != "step")
    per_t = {k: v / (iters + 1) for k, v in parts.items()
             if k not in ("contraction", "history")}
    return parts, per_t


def new_split(ms, nt, iters):
    """us per step of each part of the redesigned forward (the source's
    time less the variant's; the barrier's as in `split`), and us per T."""
    mean = {k: sum(v) / len(v) for k, v in ms.items() if v}
    full = mean["source"]
    us = lambda t: 1e3 * t / nt
    parts = {NEW_PARTS[k]: us(full - mean[k]) for k in NEW_PARTS}
    parts["cluster_barriers"] = us(mean["barrier_x2"] - full) \
        * (iters + 1) / max(iters, 1)
    parts["step"] = us(full)
    layouts = {k: us(mean[k]) for k in NEW_LAYOUTS if k in mean}
    per_t = {k: v / (iters + 1) for k, v in parts.items()}
    return parts, per_t, layouts


def main_new(args):
    """The split of the redesigned forward (--new)."""
    from quandary_tpu_torch.ops import rho_mid
    src_dir = args.src if args.src else os.path.join(ROOT, "quandary_tpu_torch",
                                                     "csrc")
    if os.path.isdir(os.path.join(src_dir, "quandary_tpu_torch")):
        src_dir = os.path.join(src_dir, "quandary_tpu_torch", "csrc")
    paths = variant_sources(os.path.join(src_dir, "rho_mid_fwd.cu"),
                            NEW_VARIANTS)

    def build(name, path):
        out = os.path.join(cuda_build.BUILD_DIR, f"rho_mid_nsplit_{name}",
                           "lib.so")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        import subprocess
        res = subprocess.run(cuda_build.nvcc_command(path, out),
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc {path}:\n{res.stdout}{res.stderr}")
        import ctypes
        lib = ctypes.CDLL(out)
        rho_mid._bind_fwd(lib)
        return lib

    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        futs = {k: pool.submit(build, k, p) for k, p in paths.items()}
        libs = {k: f.result() for k, f in futs.items()}
    names = list(NEW_VARIANTS) + list(NEW_LAYOUTS)
    order = names + names[::-1]
    report = {"card": rp.smi_line(), "steps": args.steps,
              "steps_wide": args.steps_wide, "new": True}
    real = rho_mid._fwd_lib
    for name, E, steps_key in SHAPES:
        steps = getattr(args, steps_key)
        plan, x0r, x0i, C = rp.inputs(name, E, steps)
        ms = {k: [] for k in names}
        shapes = {}
        for k in order:
            lay = NEW_LAYOUTS.get(k)
            lib = libs["source" if lay else k]
            rho_mid._fwd_lib = lambda lib=lib: lib
            rho_mid._SCHEDULED.clear()
            try:
                with cs.iterates_budget(0):
                    ms[k].append(cs.event_ms(lambda: rho_mid._kernel_fwd(
                        plan, x0r, x0i, C, _layout=lay), 2))
                shapes[k] = dict(rho_mid.mid_layouts["fwd"])
            except ValueError:
                pass            # the layout does not fit this shape
            finally:
                rho_mid._fwd_lib = real
        torch.cuda.synchronize()
        parts, per_t, layouts = new_split(ms, steps, plan.iters)
        key = f"{name}_E{E}"
        report[key] = dict(N=plan.N, K=plan.K, J=plan.njump,
                           iters=plan.iters, B=x0r.shape[0], E=E, nt=steps,
                           layout=shapes["source"], layouts=shapes, ms=ms,
                           us_per_step=parts, us_per_T=per_t,
                           us_per_step_layouts=layouts)
        print(json.dumps({key: report[key]}), flush=True)
    line = json.dumps(report)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "rho_mid_fwd_split_new.json"),
              "w") as f:
        f.write(line + "\n")
    print(line)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None,
                    help="a directory holding quandary_tpu_torch/csrc/"
                         "rho_mid.cu with the parent's forward (default "
                         "build/parent; with --new, the checkout)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--steps-wide", type=int, default=50)
    ap.add_argument("--new", action="store_true",
                    help="split the redesigned forward (csrc/rho_mid_fwd.cu)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    if args.new:
        return main_new(args)
    args.src = args.src or os.path.join(ROOT, "build", "parent")
    src = os.path.join(args.src, "quandary_tpu_torch", "csrc", "rho_mid.cu")
    if not os.path.isfile(src):
        sys.exit(f"{args.src} holds no quandary_tpu_torch/csrc/rho_mid.cu")
    paths = variant_sources(src)
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        futs = {k: pool.submit(rp.build_parent, p, f"rho_mid_fsplit_{k}")
                for k, p in paths.items()}
        libs = {k: f.result() for k, f in futs.items()}
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    report = {"card": rp.smi_line(), "steps": args.steps,
              "steps_wide": args.steps_wide}
    for name, E, steps_key in SHAPES:
        steps = getattr(args, steps_key)
        plan, x0r, x0i, C = rp.inputs(name, E, steps)
        ms = {k: [] for k in VARIANTS}
        for k in order:
            ms[k].append(cs.event_ms(lambda k=k: rp.parent_fwd(
                libs[k], plan, x0r, x0i, C, False), 2))
        torch.cuda.synchronize()
        G, tile, threads, smem = rp.parent_fwd_shape(
            libs["source"], E, x0r.shape[0], plan.N, plan.K, plan.njump)
        parts, per_t = split(ms, steps, plan.iters)
        key = f"{name}_E{E}"
        report[key] = dict(N=plan.N, K=plan.K, J=plan.njump,
                           iters=plan.iters, B=x0r.shape[0], E=E, nt=steps,
                           G=G, tile=tile, threads=threads, smem=smem, ms=ms,
                           us_per_step=parts, us_per_T=per_t)
        print(json.dumps({key: report[key]}), flush=True)
    line = json.dumps(report)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "rho_mid_fwd_split.json"),
              "w") as f:
        f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
