"""Split one step of the single-schedule mid streamed-plane backward
(stream_mid_bwd of csrc/stream_mid.cu, the chain schedule: the replay, the
column band's fetch, the transposed chain and the plane-cotangent pass all
in each cluster's chain) into its parts, on one CUDA card, by timing
variants of its source: each variant is the source with a few lines removed
or replaced, built into its own library and launched through that source's
launcher (`stream_mid_parent.parent_bwd`). Only the source's results are
right; a variant's time is all that is used.

Variants (the backward's time loop, VARIANTS):
  source            as it is
  no_loads          the step's operand loads (j, the pre-state, the
                    stored iterates) replaced by constants
  no_replay         the replay's stage chain (its band products, pushes
                    and cluster barriers; the row band is still fetched)
  no_tt_exchange    the transposed stages' pushes and cluster barriers
                    (each push a local store, each barrier the CTA's)
  no_tt_product     the transposed stages' band products (rows_dot)
  no_fetch          the column band's transposing copies (cp.async of 4
                    bytes, or the global layout's scalar transposition)
  no_hb             the plane-cotangent pass (its FMAs and writes)
  hb_no_writes      the pass's writes of Hb (the FMAs stay)
  no_step_barrier   the cluster barrier that closes each step

Parts, us per step: loads, replay, tt_exchange, tt_product, fetch, hb (the
whole pass) and within it hb_writes, step_barrier, and "rest" (the step
less the top-level parts: the band waits, shuffle trees, stage updates,
the loop).

Cases: stream_mid_parent.py's CASES (stream256, stream512, chunk256,
stream512r, chunk1024, open2) at their own depth (--steps to change it);
every variant timed with CUDA events in the order of VARIANTS there and
back. Prints one JSON line per case, then one with all of them and the
card's name and power limit, also written to
chiprun_out/stream_mid_bwd_split.json.

    python3 scripts/stream_mid_bwd_split.py [--src DIR] [--steps N]

DIR holds the quandary_tpu_torch/csrc/stream_mid.cu to split and its
headers (default: the checkout's parent, unpacked as
scripts/parent_common.py says, in build/parent).

With --fwd, a step of the forward stream_mid_fwd as a890352 has it (a
cluster barrier after each exchange, the band copied by cp.async), by
variants of its text between FWD_SCOPE's two marks, launched through that
source's launcher (`stream_mid_parent.parent_fwd`) (FWD_VARIANTS):
  source            as it is
  no_fetch          the band's copies into shared memory (smem2, smem1;
                    the global layout reads its band in the products)
  no_product        the stage products (rows_dot over no entry)
  no_push           the pushes into the other CTAs (each a local store)
  no_barrier        the cluster barriers of the time loop (each the CTA's)
  no_stores         the history and stored-iterate writes
Parts, us per step: fetch, product, push, barrier, stores and "rest" (the
step less those: the stage updates, shuffle trees, band waits, the loop).
Cases FWD_SPLIT_CASES (stream256, stream512, chunk256, chunk1024,
dense1024, open2; stream_mid_parent.fwd_case_inputs), each variant timed
in the order source, the others, the others reversed, source. Written to
chiprun_out/stream_mid_fwd_split.json.

    python3 scripts/stream_mid_bwd_split.py --fwd [--new] [--src DIR]
        [--steps N]

With --fwd --new, a step of the checkout's forward (st.async exchange on
mbarriers, band rows a step ahead, in place or from L2) by variants of its
text from NEW_FWD_SCOPE's mark on, launched through ops/stream_mid.py
(NEW_FWD_VARIANTS):
  source            as it is
  no_product        the stage products (rows_dot_all over no entry)
  local_exchange    each push a local store, no byte expected from another
                    CTA (the exchange a CTA's own arrival and wait)
  no_band           the band rows' copies (bulk or cp.async), no byte
                    expected
  no_stores         the history and stored-iterate writes
  minb1             the instances of one CTA an SM everywhere (up to 128
                    registers; the source takes two, at most 64, where
                    the card holds too few clusters of those and two fit
                    an SM's shared memory)
  single            a warp's rows one at a time everywhere
  pairs             a warp's rows two at a time wherever Bc = 1 (each
                    operand entry loaded once for both)
and the source on other band layouts (NEW_FWD_LAYOUTS: 'smem1' with every
row refilled in place, 'global' with every row from L2), where they fit.
Written to chiprun_out/stream_mid_fwd_split_new.json.

With --new, a step of the checkout's backward on its 'helpers' schedule
instead, by variants of stream_mid_bwd_helpers launched through
ops/stream_mid.py (NEW_VARIANTS):
  source            as it is
  chain_alone       the chain neither runs nor waits for the passes (it
                    reads whatever the H^T ring holds): the chain's own time
  no_band_copy      the chain's copy of its column band of H^T into shared
                    memory
  no_pairs          the chain's writes of its pairs into the pairs ring
and the source with no helper cluster (helpers0) and with every replay
handing its steps from the fifth on over to its chain (handoff). Each case
(by default those whose planner takes 'helpers') reports us per step of
each and the shape, written to chiprun_out/stream_mid_bwd_split_new.json.
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

import parent_common as pc  # noqa: E402
import stream_mid_parent as smp  # noqa: E402

SCOPE = ("stream_mid_bwd(const float* __restrict__ gHr",
         "// Plain C entry points")
VARIANTS = {
    "source": (),
    "no_loads": ((
        "          gr += jr[st * BN + col];\n"
        "          gi += ji[st * BN + col];\n"
        "          xr = t == 0 ? x0r[col] : hr[(st - 1) * BN + col];\n"
        "          xi = t == 0 ? x0i[col] : hi[(st - 1) * BN + col];\n",
        "          gr += 1e-3f;\n          gi -= 1e-3f;\n"
        "          xr = 0.5f;\n          xi = 0.25f;\n"), (
        "              U[2 * q * BI + ib] = ksr[o];\n"
        "              U[2 * q * BI + BI + ib] = ksi[o];\n",
        "              U[2 * q * BI + ib] = 0.125f + o;\n"
        "              U[2 * q * BI + BI + ib] = 0.0625f;\n")),
    "no_replay": ((
        "      if (replay) {         // k_0..k_{it-1} again from xp, on the "
        "row band\n", "      if (replay && N < 0) {\n"),),
    "no_tt_exchange": ((
        "          if (q < it)\n"
        "            put(cq, b, il, d.a * kr, d.a * ki);\n"
        "          else\n"
        "            put(cq, b, il, br, bi);\n"
        "        });\n"
        "        cl.sync();\n",
        "          cq[b * N + g.r0 + il] = q < it ? d.a * kr : br;\n"
        "          cq[BNv + b * N + g.r0 + il] = q < it ? d.a * ki : bi;\n"
        "        });\n"
        "        __syncthreads();\n"),),
    "no_tt_product": ((
        "        rows_dot<BC, true>(\n"
        "            HTr, HTi, ld, g.nr, cq, cq + BNv, N, warp, nwarps, lane,",
        "        if (N < 0) rows_dot<BC, true>(\n"
        "            HTr, HTi, ld, g.nr, cq, cq + BNv, N, warp, nwarps, lane,"
    ),),
    "no_fetch": ((
        "          HT[ql * ld + pp] = sr[(size_t)pp * N + ql];\n"
        "          HT[colp + ql * ld + pp] = si[(size_t)pp * N + ql];\n",
        ""), (
        "        cp_async4(HT + ql * ld + pp, sr + (size_t)pp * N + ql);\n"
        "        cp_async4(HT + colp + ql * ld + pp, si + (size_t)pp * N + "
        "ql);\n", "")),
    "no_hb": ((
        "        const int n = N * g.nr;\n"
        "        for (int idx = tid; idx < n; idx += blockDim.x) {\n",
        "        const int n = N * g.nr;\n"
        "        for (int idx = tid; idx < n && N < 0; idx += blockDim.x) {\n"
    ),),
    "hb_no_writes": ((
        "          Hbr[o] = first ? hbr : Hbr[o] + hbr;\n"
        "          Hbi[o] = first ? hbi : Hbi[o] + hbi;\n",
        "          if (hbr == 1.2345e-30f) Hbr[o] = hbi;\n"),),
    "no_step_barrier": ((
        "      cl.sync();    // every CTA's pass has read the cotangent "
        "slots\n", ""),),
}


FWD_SCOPE = ("stream_mid_fwd(const float* __restrict__ gHr",
             "// Backward: the steps in reverse")
FWD_VARIANTS = {
    "source": (),
    "no_fetch": ((
        "    copy_run(dst, plane_rows(gHr, d, g.e, t, g.r0), g.nr * N);\n"
        "    copy_run(dst + rowp, plane_rows(gHi, d, g.e, t, g.r0), g.nr * "
        "N);\n", ""),),
    "no_product": ((
        "Hr, Hi, N, g.nr, Vr, Vr + BNv, N, warp, nwarps, lane,",
        "Hr, Hi, N, g.nr, Vr, Vr + BNv, 0, warp, nwarps, lane,"),),
    "no_push": ((
        "    push(cl, buf + b * N + g.r0 + il, vr, G);\n"
        "    push(cl, buf + BNv + b * N + g.r0 + il, vi, G);\n",
        "    buf[b * N + g.r0 + il] = vr;\n"
        "    buf[BNv + b * N + g.r0 + il] = vi;\n"),),
    "no_barrier": ((
        "    cl.sync();\n    const size_t st",
        "    __syncthreads();\n    const size_t st"), (
        "        p ^= 1;\n        cl.sync();\n",
        "        p ^= 1;\n        __syncthreads();\n")),
    "no_stores": ((
        "                ksr[o] = kr;\n                ksi[o] = ki;\n",
        "                if (kr == 1.2345e-30f) ksr[o] = ki;\n"), (
        "        hr[o] = xr;\n        hi[o] = xi;\n",
        "        if (xr == 1.2345e-30f) hr[o] = xi;\n")),
}
NEW_FWD_SCOPE = ("// Forward: planes H (E, nt, N, N) x2;", None)
NEW_FWD_VARIANTS = {
    "source": (),
    "no_product": (("rows_dot_all<BC, 2>(row, g.nr, Ve, N, warp",
                    "rows_dot_all<BC, 2>(row, g.nr, Ve, 0, warp"),
                   ("rows_dot_all<BC, 1>(row, g.nr, Ve, N, warp",
                    "rows_dot_all<BC, 1>(row, g.nr, Ve, 0, warp")),
    "local_exchange": ((
        "  const unsigned tx = 8u * (N - g.nr) * g.nb;",
        "  const unsigned tx = 0;"), (
        "        st_async2(rank_addr(smem_addr(dst), q), pr, pi, "
        "rank_addr(bar, q));", "        *dst = make_float2(pr, pi);")),
    "no_band": ((
        "        bulk_g2s(smem_addr(s), gr, 4 * N, wbar);\n"
        "        bulk_g2s(smem_addr(s + N), gi, 4 * N, wbar);\n", ""), (
        "        cp_async4(s + j, gr + j);\n"
        "        cp_async4(s + N + j, gi + j);\n", ""), (
        "mb_arrive(wbar, d.bulk ? 8u * N * wrows : 0u);",
        "mb_arrive(wbar, 0u);")),
    "no_stores": ((
        "          ksr[o] = kr;\n          ksi[o] = ki;\n",
        "          if (kr == 1.2345e-30f) ksr[o] = ki;\n"), (
        "            hr[o] = xr;\n            hi[o] = xi;\n",
        "            if (xr == 1.2345e-30f) hr[o] = xi;\n")),
    "minb1": (("  return 2 * (smem_bytes + 1024) <= 228 * 1024 &&",
               "  return false &&"),),
    "single": (("  const bool pairs = BC == 1 && R >= 2 * nwarps;",
                "  const bool pairs = false;"),),
    "pairs": (("  const bool pairs = BC == 1 && R >= 2 * nwarps;",
               "  const bool pairs = BC == 1;"),),
}
NEW_FWD_LAYOUTS = {"inplace": ("smem1", 0), "l2": ("global", 0)}
FWD_SPLIT_CASES = ("stream256", "stream512", "chunk256", "chunk1024",
                   "dense1024", "open2")


def fwd_split(args, src):
    """The --fwd report: a step of a890352's forward by source variants."""
    import chip_smoke as cs
    paths = pc.variant_sources(src, FWD_VARIANTS, *FWD_SCOPE,
                               stem="stream_mid_fsplit")
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        futs = {k: pool.submit(pc.build_parent, p, f"stream_mid_fsplit_{k}",
                               smp.parent_fwd_bind)
                for k, p in paths.items()}
        libs = {k: f.result() for k, f in futs.items()}
    report = {"card": pc.smi_line()}
    for name in args.cases.split(","):
        plan, ins = smp.fwd_case_inputs(name, args.steps)
        runs = {k: (lambda k=k: smp.parent_fwd(libs[k], plan, *ins))
                for k in FWD_VARIANTS}
        ms = pc.interleaved(runs, "source", 1)
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        E, nt, N = ins[0].shape[0], ins[0].shape[1], ins[0].shape[-1]
        B = ins[2].shape[0]
        us = lambda t: 1e3 * t / nt
        parts = dict(step=us(mean["source"]))
        for k in FWD_VARIANTS:
            if k != "source":
                parts[k[3:]] = us(mean["source"] - mean[k])
        parts["rest"] = parts["step"] - sum(v for k, v in parts.items()
                                            if k != "step")
        store = plan.store_iters and plan.iters > 0
        report[name] = dict(
            N=N, B=B, iters=plan.iters, nt=nt, kind=plan.kind, stored=store,
            shape=smp.parent_fwd_shape(E, B, N, plan.iters, store), ms=ms,
            us_per_step=parts)
        del ins
        torch.cuda.empty_cache()
        print(json.dumps({name: report[name]}), flush=True)
    line = json.dumps(report)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "stream_mid_fwd_split.json"),
              "w") as f:
        f.write(line + "\n")
    print(line)


def fwd_new_split(args):
    """The --fwd --new report: a step of the checkout's forward."""
    import shutil
    import chip_smoke as cs
    from quandary_tpu_torch.ops import cuda_build, stream_mid
    out_dir = os.path.join(cuda_build.BUILD_DIR, "stream_mid_fsplit_new")
    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(cuda_build.CSRC_DIR):
        if name.endswith(".cuh") or name == "stream_mid.cu":
            shutil.copy(os.path.join(cuda_build.CSRC_DIR, name), out_dir)
    paths = pc.variant_sources(os.path.join(out_dir, "stream_mid.cu"),
                               NEW_FWD_VARIANTS, *NEW_FWD_SCOPE,
                               stem="stream_mid_fsplit_new")

    def build(path, name):
        lib = pc.nvcc(path, os.path.join(out_dir, f"lib{name}.so"))[0]
        stream_mid._bind(lib)
        return lib

    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        futs = {k: pool.submit(build, p, f"fsplit_new_{k}")
                for k, p in paths.items()}
        libs = {k: f.result() for k, f in futs.items()}
    report = {"card": pc.smi_line()}
    own = stream_mid._lib
    for name in args.cases.split(","):
        plan, ins = smp.fwd_case_inputs(name, args.steps)
        runs, shapes = {}, {}
        for k in NEW_FWD_VARIANTS:
            runs[k] = (k, {})
        for k, (lay, rows) in NEW_FWD_LAYOUTS.items():
            try:
                stream_mid._kernel_fwd(plan, *ins, _layout=lay, _rows=rows)
                runs[k] = ("source", dict(_layout=lay, _rows=rows))
            except NotImplementedError:
                pass
        ms = {k: [] for k in runs}
        try:
            for k in list(runs) + list(runs)[::-1]:
                lib, kw = runs[k]
                stream_mid._lib = lambda lib=lib: libs[lib]
                ms[k].append(cs.event_ms(lambda kw=kw: stream_mid._kernel_fwd(
                    plan, *ins, **kw), 1))
                shapes[k] = dict(stream_mid.mid_layouts["fwd"])
        finally:
            stream_mid._lib = own
        torch.cuda.synchronize()
        nt = ins[0].shape[1]
        us = {k: 1e3 * sum(v) / len(v) / nt for k, v in ms.items()}
        parts = {k: us["source"] - us[k] for k in NEW_FWD_VARIANTS
                 if k not in ("source", "minb1", "single", "pairs")}
        parts["rest"] = us["source"] - sum(parts.values())
        report[name] = dict(N=ins[0].shape[-1], B=ins[2].shape[0],
                            iters=plan.iters, nt=nt, kind=plan.kind,
                            shape=shapes["source"], ms=ms, us_per_step=us,
                            parts=parts,
                            layouts={k: shapes[k] for k in NEW_FWD_LAYOUTS
                                     if k in shapes})
        del ins
        torch.cuda.empty_cache()
        print(json.dumps({name: report[name]}), flush=True)
    line = json.dumps(report)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "stream_mid_fwd_split_new.json"), "w") as f:
        f.write(line + "\n")
    print(line)


NEW_VARIANTS = {
    "source": (),
    "chain_alone": ((
        "    if (!hdr[3]) {\n      run_pass(st, region);\n", "    if (N < 0) "
        "{\n      run_pass(st, region);\n"),),
    "no_band_copy": ((
        "        cp_async16_l2(region + (size_t)m * R * ldr + o, HTs + m * NL "
        "+ o);\n", "        if (o < 0) cp_async16_l2(region, HTs);\n"),),
    "no_pairs": ((
        "    o[0] = vr;\n    o[BNv] = vi;\n  };\n",
        "    if (vr == 1.2345e-30f) o[0] = vi;\n  };\n"),),
}


def new_split(args):
    """The --new report: a step of the checkout's helpers schedule."""
    import shutil
    import chip_smoke as cs
    from quandary_tpu_torch.ops import cuda_build, stream_mid
    out_dir = os.path.join(cuda_build.BUILD_DIR, "stream_mid_split_new")
    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(cuda_build.CSRC_DIR):
        if name.endswith(".cuh") or name == "stream_mid.cu":
            shutil.copy(os.path.join(cuda_build.CSRC_DIR, name), out_dir)
    paths = pc.variant_sources(os.path.join(out_dir, "stream_mid.cu"),
                               NEW_VARIANTS, "stream_mid_bwd_helpers(",
                               stem="stream_mid_split_new")

    def build(path, name):
        lib = pc.nvcc(path, os.path.join(out_dir, f"lib{name}.so"))[0]
        stream_mid._bind(lib)
        return lib

    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        futs = {k: pool.submit(build, p, f"split_new_{k}")
                for k, p in paths.items()}
        libs = {k: f.result() for k, f in futs.items()}
    extra = dict(helpers0=dict(_helpers=0), handoff=dict(_handoff=True))
    runs = dict(NEW_VARIANTS, **extra)
    order = list(runs) + list(runs)[::-1]
    report = {"card": pc.smi_line()}
    own = stream_mid._lib
    for name in args.cases.split(","):
        plan, ins = smp.case_inputs(name, args.steps)
        ms, shapes = {k: [] for k in runs}, {}
        try:
            for k in order:
                stream_mid._lib = (lambda k=k: libs[k if k in libs
                                                    else "source"])
                kw = extra.get(k, {})
                ms[k].append(cs.event_ms(lambda kw=kw: stream_mid._kernel_bwd(
                    plan, *ins, _schedule="helpers", **kw), 1))
                shapes[k] = dict(stream_mid.mid_layouts["bwd"])
        finally:
            stream_mid._lib = own
        torch.cuda.synchronize()
        nt = ins[0].shape[1]
        us = {k: 1e3 * sum(v) / len(v) / nt for k, v in ms.items()}
        report[name] = dict(N=ins[0].shape[-1], B=ins[2].shape[0],
                            iters=plan.iters, nt=nt, kind=plan.kind,
                            stored=ins[6] is not None,
                            shape=shapes["source"], ms=ms, us_per_step=us)
        del ins
        torch.cuda.empty_cache()
        print(json.dumps({name: report[name]}), flush=True)
    line = json.dumps(report)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "stream_mid_bwd_split_new.json"), "w") as f:
        f.write(line + "\n")
    print(line)


def split(ms, nt):
    """us per step of each part from the variants' mean times."""
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    us = lambda t: 1e3 * t / nt
    less = lambda k: us(mean["source"] - mean[k])
    parts = dict(step=us(mean["source"]), loads=less("no_loads"),
                 replay=less("no_replay"), tt_exchange=less("no_tt_exchange"),
                 tt_product=less("no_tt_product"), fetch=less("no_fetch"),
                 hb=less("no_hb"), step_barrier=less("no_step_barrier"))
    parts["rest"] = parts["step"] - sum(v for k, v in parts.items()
                                        if k != "step")
    parts["hb_writes"] = less("hb_no_writes")
    return parts


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "build", "parent"),
                    help="a directory holding quandary_tpu_torch/csrc/"
                         "stream_mid.cu with the single-schedule backward")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--cases", default=",".join(smp.CASES))
    ap.add_argument("--new", action="store_true",
                    help="split the checkout's helpers schedule instead")
    ap.add_argument("--fwd", action="store_true",
                    help="split a step of a890352's forward instead (with "
                         "--new: the checkout's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    if args.fwd and args.new:
        if args.cases == ",".join(smp.CASES):
            args.cases = ",".join(FWD_SPLIT_CASES)
        return fwd_new_split(args)
    if args.new:
        if args.cases == ",".join(smp.CASES):
            args.cases = ",".join(c for c in smp.CASES if c != "open2")
        return new_split(args)
    src = os.path.join(args.src, "quandary_tpu_torch", "csrc",
                       "stream_mid.cu")
    if not os.path.isfile(src):
        sys.exit(f"{args.src} holds no quandary_tpu_torch/csrc/"
                 "stream_mid.cu")
    if args.fwd:
        if args.cases == ",".join(smp.CASES):
            args.cases = ",".join(FWD_SPLIT_CASES)
        return fwd_split(args, src)
    paths = pc.variant_sources(src, VARIANTS, *SCOPE,
                               stem="stream_mid_split")
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        futs = {k: pool.submit(smp.build_parent, p, f"stream_mid_split_{k}")
                for k, p in paths.items()}
        libs = {k: f.result() for k, f in futs.items()}
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    report = {"card": pc.smi_line()}
    for name in args.cases.split(","):
        plan, ins = smp.case_inputs(name, args.steps)
        ms = {k: [] for k in VARIANTS}
        import chip_smoke as cs
        for k in order:
            ms[k].append(cs.event_ms(
                lambda k=k: smp.parent_bwd(libs[k], plan, *ins), 1))
        torch.cuda.synchronize()
        E, nt, N = ins[0].shape[0], ins[0].shape[1], ins[0].shape[-1]
        B = ins[2].shape[0]
        report[name] = dict(
            N=N, B=B, iters=plan.iters, nt=nt, kind=plan.kind,
            stored=ins[6] is not None,
            shape=smp.parent_shape(E, B, N, nt, plan.iters,
                                   ins[6] is not None),
            ms=ms, us_per_step=split(ms, nt))
        del ins
        torch.cuda.empty_cache()
        print(json.dumps({name: report[name]}), flush=True)
    line = json.dumps(report)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "stream_mid_bwd_split.json"),
              "w") as f:
        f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
