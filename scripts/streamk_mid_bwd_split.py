"""Split one step of the single-schedule mid streamK backward
(streamk_mid_bwd of csrc/streamk_mid.cu with the column pass in each
cluster's chain) into its parts, on one CUDA card, by timing variants of its
source: each variant is the source with a few lines removed or replaced,
built into its own library and launched through that source's launcher
(`streamk_mid_parent.parent_bwd`). Only the source's results are right; a
variant's time is all that is used.

Variants (the backward's time loop):
  source            as it is (and in the other iterate mode: stored
                    against replayed gives the replay's cost)
  no_loads          the step's operand loads (j, the pre-state, the
                    stored iterates) replaced by constants
  no_row_contract   the replay's contraction of the next row band
  no_tt_exchange    the transposed stages' pushes and cluster barriers
                    (each push a local store, each barrier the CTA's)
  no_tt_product     the transposed stages' band products (rows_dot)
  no_col_pass       the column pass (Hb, C-bar, contraction, writes)
  col_no_hb         the pass's Hb from the pairs (Hb = 0)
  col_no_cbar       the pass's C-bar FMAs (and with them Hb, now dead)
  col_no_contract   the pass's contraction of the next column band
  col_no_writes     the pass's transposed writes of that band
  no_step_barrier   the cluster barrier that closes each step

Parts, us per step: loads, replay (replayed less stored, less the row
contraction; where the case stores its iterates it is reported beside the
step as replay_if_replayed, the row contraction included), row_contract,
tt_exchange, tt_product, col_pass (the whole pass) and within it hb,
cbar_fma (col_no_cbar's saving less hb), contract, writes and col_rest
(the stack loads, the loop and the reductions), and step_barrier; "rest"
is the step less the top-level parts.

Cases: streamk_mid_parent.py's n256_pure, n256_basis, n512_pure,
n1024_pure and superop27 at --steps steps (time per step is what is read),
in the iterate mode each takes at full depth; every variant timed with CUDA
events in the order of VARIANTS there and back. Prints one JSON line per
case, then one with all of them and the card's name and power limit, also
written to chiprun_out/streamk_mid_bwd_split.json.

    python3 scripts/streamk_mid_bwd_split.py [--src DIR] [--steps 200]

DIR holds the quandary_tpu_torch/csrc/streamk_mid.cu to split and its
headers (default: the checkout's parent, unpacked as
scripts/streamk_mid_parent.py says, in build/parent).

With --new, a step of the checkout's backward on its 'helpers' schedule
(the column pass on helper clusters, H handed over through a ring) instead,
by variants of its streamk_mid_bwd_helpers launched through
ops/streamk_mid.py (NEW_VARIANTS):
  source            as it is
  chain_alone       the chain neither runs nor waits for the passes (it
                    reads whatever the ring holds): the chain's own time
  pass_alone        the chain runs no stages (nor the replay): the time of
                    the passes and the hand-offs
  no_band_copy      the step's copy of the bands into shared memory
and the source with no helper cluster (the chain's CTAs run every tile).
Each case reports us per step of each and the shape, at --steps steps,
written to chiprun_out/streamk_mid_bwd_split_new.json.

With --fwd, a step of the single-schedule forward (streamk_mid_fwd, the row
contraction in each cluster's chain) of the source in DIR instead, by
variants of its text between FWD_SCOPE's two marks, launched through that
source's launcher (`streamk_mid_parent.parent_fwd`) (FWD_VARIANTS):
  source            as it is
  no_row_contract   the step's contraction of the CTA's row band of H(t)
  no_product        the stages' band products (rows_dot over no entries:
                    the band reads and FMAs; the shuffle trees stay)
  no_exchange       the pushes of x and of each stage's k and the cluster
                    barriers after them (each push a local store, each
                    barrier the CTA's)
  no_stores         the history's and the stored iterates' writes
  no_strides        the three lines that offset the stack and solver rows
                    by the candidate (per-sample stacks; every case here
                    shares one stack, so its results are the source's)
Parts, us per step: row_contract, product, exchange, stores, strides and
"rest" (the step less them: shuffle trees, stage updates, loop). Cases:
FWD_CONFIGS (phase 25's sizes, superop27 and SWAP02 at N = 64, B = 8),
written to chiprun_out/streamk_mid_fwd_split.json.
"""

import argparse
import concurrent.futures
import dataclasses
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import parent_common as pc  # noqa: E402
import streamk_mid_parent as sp  # noqa: E402

VARIANTS = {
    "source": (),
    "no_loads": ((
        "        gr += jr[st * BN + col];\n"
        "        gi += ji[st * BN + col];\n"
        "        xr = t == 0 ? x0r[col] : hr[(st - 1) * BN + col];\n"
        "        xi = t == 0 ? x0i[col] : hi[(st - 1) * BN + col];\n",
        "        gr += 1e-3f;\n        gi -= 1e-3f;\n"
        "        xr = 0.5f;\n        xi = 0.25f;\n"), (
        "            U[2 * q * BI + ib] = ksr[o];\n"
        "            U[2 * q * BI + BI + ib] = ksi[o];\n",
        "            U[2 * q * BI + ib] = 0.125f + o;\n"
        "            U[2 * q * BI + BI + ib] = 0.0625f;\n")),
    "no_row_contract": ((
        "    if (replay && t > 0)\n"
        "      row_contract(Sr, Si, Ce + (size_t)(t - 1) * Ke, Ke, N, g.r0, "
        "g.nr, Hr,\n                   Hi, tid, blockDim.x);\n", ""),),
    "no_tt_exchange": ((
        "        if (q < it)\n"
        "          put(cq, b, il, d.a * kr, d.a * ki);\n"
        "        else\n"
        "          put(cq, b, il, br, bi);\n"
        "      });\n"
        "      cl.sync();\n",
        "        cq[b * N + g.r0 + il] = q < it ? d.a * kr : br;\n"
        "        cq[BNv + b * N + g.r0 + il] = q < it ? d.a * ki : bi;\n"
        "      });\n"
        "      __syncthreads();\n"),),
    "no_tt_product": ((
        "      rows_dot<BC, true>(\n"
        "          HTr, HTi, N + 1, g.nr, cq, cq + BNv, N, warp, nwarps, lane,",
        "      if (false) rows_dot<BC, true>(\n"
        "          HTr, HTi, N + 1, g.nr, cq, cq + BNv, N, warp, nwarps, lane,"
    ),),
    "no_col_pass": ((
        "    col_pass<BC>(Sr, Si, Ke, N, g.r0, g.nr, R, Cs, U, it + 1,\n",
        "    if (false) col_pass<BC>(Sr, Si, Ke, N, g.r0, g.nr, R, Cs, U, "
        "it + 1,\n"),),
    "col_no_hb": ((
        "      for (int pr = 0; pr < npairs; ++pr) {",
        "      for (int pr = 0; pr < 0; ++pr) {"),),
    "col_no_cbar": ((
        "          cb[kk] = fmaf(hbr, sr, cb[kk]);\n"
        "          cb[kk] = fmaf(hbi, si, cb[kk]);\n", ""),),
    "col_no_contract": ((
        "            hnr = fmaf(cn[k], sr, hnr);\n"
        "            hni = fmaf(cn[k], si, hni);\n", ""),),
    "col_no_writes": ((
        "        HTr[ql * ld + pp] = hnr;\n"
        "        HTi[ql * ld + pp] = hni;\n",
        "        if (hnr == 1.2345e-30f) HTr[ql * ld + pp] = hni;\n"),),
    "no_step_barrier": ((
        "    cl.sync();    // every CTA's pass has read the slots\n", ""),),
}
CONFIGS = ("n256_pure", "n256_basis", "n512_pure", "n1024_pure",
           "superop27")
NEW_VARIANTS = {
    "source": (),
    "chain_alone": ((
        "    run_pass(sidx, region);\n"
        "    if (tid == 0) wait_count(done + sidx, s.ntiles);\n", ""),),
    "pass_alone": ((
        "    if (replay) {         // k_0..k_{it-1} again from xp, on the row "
        "band\n", "    if (replay && N < 0) {\n"), (
        "    for (int q = 0; q <= it; ++q) {\n      float* cq = Cs + 2 * q * "
        "BNv;\n      owned([&](int il, int b, int ib) {\n        float kr = "
        "KB[ib], ki = KB[BI + ib];\n        if (jac) cmul_conj(rw[2 * R + "
        "il], rw[3 * R + il], kr, ki);   // Wt\n        const float br = "
        "BB[ib] + kr, bi = BB[BI + ib] + ki;\n        BB[ib] = br;\n"
        "        BB[BI + ib] = bi;\n        const float cr",
        "    for (int q = 0; q <= it && N < 0; ++q) {\n      float* cq = Cs + "
        "2 * q * BNv;\n      owned([&](int il, int b, int ib) {\n        "
        "float kr = KB[ib], ki = KB[BI + ib];\n        if (jac) cmul_conj("
        "rw[2 * R + il], rw[3 * R + il], kr, ki);   // Wt\n        const "
        "float br = BB[ib] + kr, bi = BB[BI + ib] + ki;\n        BB[ib] = "
        "br;\n        BB[BI + ib] = bi;\n        const float cr")),
    "no_band_copy": ((
        "        cp_async16_l2(region + (size_t)m * R * ldr + o, Hs + m * NL "
        "+ o);\n", "        if (o < 0) cp_async16_l2(region, Hs);\n"),),
}


FWD_SCOPE = ("streamk_mid_fwd(const float* __restrict__ Sr",
             "// Backward: the steps in reverse")
FWD_VARIANTS = {
    "source": (),
    "no_row_contract": ((
        "    row_contract(Sr, Si, Ce + (size_t)t * Ke, Ke, N, g.r0, g.nr, Hr, "
        "Hi, tid,\n                 blockDim.x);\n", ""),),
    "no_product": ((
        "Hr, Hi, N, g.nr, Vr, Vr + BNv, N, warp, nwarps, lane,",
        "Hr, Hi, N, g.nr, Vr, Vr + BNv, 0, warp, nwarps, lane,"),),
    "no_exchange": ((
        "    push(cl, buf + b * N + g.r0 + il, vr, G);\n"
        "    push(cl, buf + BNv + b * N + g.r0 + il, vi, G);\n",
        "    buf[b * N + g.r0 + il] = vr;\n"
        "    buf[BNv + b * N + g.r0 + il] = vi;\n"), (
        "    cl.sync();\n    const size_t st",
        "    __syncthreads();\n    const size_t st"), (
        "        p ^= 1;\n        cl.sync();\n",
        "        p ^= 1;\n        __syncthreads();\n")),
    "no_stores": ((
        "                ksr[o] = kr;\n                ksi[o] = ki;\n",
        "                if (kr == 1.2345e-30f) ksr[o] = ki;\n"), (
        "        hr[o] = xr;\n        hi[o] = xi;\n",
        "        if (xr == 1.2345e-30f) hr[o] = xi;\n")),
    "no_strides": ((
        "  Sr += g.e * d.strideS;          // this candidate's stack and "
        "solver rows\n  Si += g.e * d.strideS;\n  rows += g.e * "
        "d.strideR;\n", ""),),
}
FWD_CONFIGS = ("n256_pure", "n512_pure", "n1024_pure", "n256_basis",
               "superop27", "swap02")


def variant_sources(src, variants=VARIANTS, after=None, until=None):
    """parent_common.variant_sources, the variants named
    streamk_mid_split_<name>.cu."""
    return pc.variant_sources(src, variants, after, until,
                              "streamk_mid_split")


def new_split(args):
    """The --new report: a step of the checkout's helpers schedule."""
    from quandary_tpu_torch.ops import cuda_build, streamk_mid
    out_dir = os.path.join(cuda_build.BUILD_DIR, "streamk_mid_split_new")
    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(cuda_build.CSRC_DIR):
        if name.endswith(".cuh") or name == "streamk_mid.cu":
            shutil.copy(os.path.join(cuda_build.CSRC_DIR, name), out_dir)
    paths = variant_sources(os.path.join(out_dir, "streamk_mid.cu"),
                            NEW_VARIANTS, "streamk_mid_bwd_helpers(")

    def build(path, name):
        lib = pc.nvcc(path, os.path.join(out_dir, f"lib{name}.so"))[0]
        streamk_mid._bind(lib)
        return lib

    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        futs = {k: pool.submit(build, p, f"split_new_{k}")
                for k, p in paths.items()}
        libs = {k: f.result() for k, f in futs.items()}
    runs = dict(NEW_VARIANTS, helpers0=())
    order = list(runs) + list(runs)[::-1]
    report = {"card": sp.smi_line(), "steps": args.steps}
    own = streamk_mid._lib
    for name in args.cases.split(","):
        plan, x0r, x0i, C = sp.case_inputs(name, args.steps)
        ins = sp.forward_and_cotangents(plan, x0r, x0i, C)
        ms, shapes = {k: [] for k in runs}, {}
        try:
            for k in order:
                streamk_mid._lib = (lambda k=k: libs[
                    "source" if k == "helpers0" else k])
                ms[k].append(cs.event_ms(lambda k=k: streamk_mid._kernel_bwd(
                    plan, x0r, x0i, C, *ins, _schedule="helpers",
                    _helpers=0 if k == "helpers0" else None), 1))
                shapes[k] = dict(streamk_mid.mid_layouts["bwd"])
        finally:
            streamk_mid._lib = own
        torch.cuda.synchronize()
        us = {k: 1e3 * sum(v) / len(v) / args.steps for k, v in ms.items()}
        report[name] = dict(N=x0r.shape[1], B=x0r.shape[0], Ke=plan.Ke,
                            iters=plan.iters, stored=plan.store_iters,
                            shape=shapes["source"], ms=ms, us_per_step=us)
        del ins
        torch.cuda.empty_cache()
        print(json.dumps({name: report[name]}), flush=True)
    line = json.dumps(report)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "streamk_mid_bwd_split_new.json"), "w") as f:
        f.write(line + "\n")
    print(line)


def fwd_split(args):
    """The --fwd report: a step of the single-schedule forward."""
    src = os.path.join(args.src, "quandary_tpu_torch", "csrc",
                       "streamk_mid.cu")
    paths = variant_sources(src, FWD_VARIANTS, *FWD_SCOPE)
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        futs = {k: pool.submit(sp.build_parent, p, f"streamk_mid_fsplit_{k}")
                for k, p in paths.items()}
        libs = {k: f.result() for k, f in futs.items()}
    report = {"card": sp.smi_line(), "steps": args.steps}
    for name in args.cases.split(","):
        plan, x0r, x0i, C = sp.case_inputs(name, args.steps)
        runs = {k: (lambda k=k: sp.parent_fwd(libs[k], plan, x0r, x0i, C))
                for k in FWD_VARIANTS}
        ms = sp.interleaved(runs, "source", 1)
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        us = lambda t: 1e3 * t / args.steps
        parts = dict(step=us(mean["source"]))
        for k in FWD_VARIANTS:
            if k != "source":
                parts[k[3:]] = us(mean["source"] - mean[k])
        parts["rest"] = parts["step"] - sum(v for k, v in parts.items()
                                            if k != "step")
        E, (B, N) = C.shape[0], x0r.shape
        report[name] = dict(
            N=N, B=B, Ke=plan.Ke, iters=plan.iters, stored=plan.store_iters,
            shape=sp.parent_fwd_shape(E, B, N, plan.Ke, plan.iters,
                                      plan.store_iters and plan.iters > 0),
            ms=ms, us_per_step=parts)
        torch.cuda.empty_cache()
        print(json.dumps({name: report[name]}), flush=True)
    line = json.dumps(report)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "streamk_mid_fwd_split.json"),
              "w") as f:
        f.write(line + "\n")
    print(line)


def split(ms, nt, replayed):
    """us per step of each part from the variants' mean times."""
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    full = mean["source"]
    us = lambda t: 1e3 * t / nt
    less = lambda k: us(full - mean[k])
    parts = dict(step=us(full), loads=less("no_loads"),
                 row_contract=less("no_row_contract"),
                 tt_exchange=less("no_tt_exchange"),
                 tt_product=less("no_tt_product"),
                 col_pass=less("no_col_pass"),
                 step_barrier=less("no_step_barrier"))
    # the replay's cost: replayed less stored time, less the row band's
    # contraction, a part of the step where it replays, else beside it
    other = us(mean["source_other_mode"] - full)
    if replayed:
        parts["replay"] = -other - parts["row_contract"]
    else:
        parts["row_contract"] = 0.0
    parts["rest"] = parts["step"] - sum(v for k, v in parts.items()
                                        if k != "step")
    if not replayed:
        parts["replay_if_replayed"] = other
    col = dict(hb=less("col_no_hb"), contract=less("col_no_contract"),
               writes=less("col_no_writes"))
    col["cbar_fma"] = less("col_no_cbar") - col["hb"]
    col["col_rest"] = parts["col_pass"] - sum(col.values())
    parts["col_pass_parts"] = col
    return parts


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "build", "parent"),
                    help="a directory holding quandary_tpu_torch/csrc/"
                         "streamk_mid.cu with the single-schedule launcher")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--cases", default=None)
    ap.add_argument("--new", action="store_true",
                    help="split the checkout's helpers schedule instead")
    ap.add_argument("--fwd", action="store_true",
                    help="split the single-schedule forward instead")
    args = ap.parse_args()
    if args.cases is None:
        args.cases = ",".join(FWD_CONFIGS if args.fwd else CONFIGS)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    if args.new:
        return new_split(args)
    if args.fwd:
        return fwd_split(args)
    src = os.path.join(args.src, "quandary_tpu_torch", "csrc",
                       "streamk_mid.cu")
    if not os.path.isfile(src):
        sys.exit(f"{args.src} holds no quandary_tpu_torch/csrc/"
                 "streamk_mid.cu")
    paths = variant_sources(src)
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        futs = {k: pool.submit(sp.build_parent, p, f"streamk_mid_split_{k}")
                for k, p in paths.items()}
        libs = {k: f.result() for k, f in futs.items()}
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    report = {"card": sp.smi_line(), "steps": args.steps}
    for name in args.cases.split(","):
        plan, x0r, x0i, C = sp.case_inputs(name, args.steps)
        other = dataclasses.replace(plan, store_iters=not plan.store_iters)
        ins = {m: sp.forward_and_cotangents(p, x0r, x0i, C)
               for m, p in (("own", plan), ("other", other))}
        ms = {k: [] for k in VARIANTS}
        ms["source_other_mode"] = []
        for k in order:
            run = lambda k=k, p=plan, m="own": sp.parent_bwd(
                libs[k], p, x0r, x0i, C, *ins[m])
            ms[k].append(cs.event_ms(run, 1))
            if k == "source":
                ms["source_other_mode"].append(cs.event_ms(
                    lambda: sp.parent_bwd(libs[k], other, x0r, x0i, C,
                                          *ins["other"]), 1))
        torch.cuda.synchronize()
        replayed = not plan.store_iters and plan.iters > 0
        report[name] = dict(
            N=x0r.shape[1], B=x0r.shape[0], Ke=plan.Ke, iters=plan.iters,
            replayed=replayed, shape=sp.parent_shape(
                1, *x0r.shape, plan.iters, plan.store_iters), ms=ms,
            us_per_step=split(ms, args.steps, replayed))
        del ins
        torch.cuda.empty_cache()
        print(json.dumps({name: report[name]}), flush=True)
    line = json.dumps(report)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "streamk_mid_bwd_split.json"),
              "w") as f:
        f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
