"""Split one step of the single-role mid density-matrix backward
(rho_mid_bwd of csrc/rho_mid.cu before its replay moved to clusters of its
own) into its parts, on one CUDA card, by timing variants of its source:
each variant is the source with a few lines removed or replaced, built
into its own library and launched
through the single-role launcher (`rho_mid_parent.parent_bwd`). Only the
source's results are right; a variant's time is all that is used.

Variants (the backward's time loop):
  source            as it is, iterates replayed (and stored: the replay's
                    cost is the difference)
  no_products       the two cotangent products c^dag u and u c^dag of each
                    pair (u read from device memory through L2)
  cbar_no_loads     the C-bar reduction's stack loads (the sums stay, so
                    the products are not dead code)
  no_contract       the contraction of M's band (and M^T's for the replay)
  no_pair_barrier   the cluster barrier that opens each pair
  no_tt             the pair's Tt band (band_gen<TS, true>)

Shapes: chip_smoke.py's qudits125 (N = 125, K = 11, J = 6, B = 3,
jacobi-6, G = 16) and qudits128 (N = 128, K = 7, J = 4) at E = 1, cut to
--steps steps (time per step is what is read). Each shape times every
variant with CUDA events in the order of VARIANTS there and back, and
reports us per step of each part: a part is the source's replayed time
less the variant's. Prints one JSON line per shape, then one with all of
them and the card's name and power limit, also written to
chiprun_out/rho_mid_bwd_split.json.

    python3 scripts/rho_mid_bwd_split.py [--src DIR] [--steps 200]

DIR holds the quandary_tpu_torch/csrc/rho_mid.cu to split (default: the
checkout's parent, unpacked as scripts/rho_mid_parent.py says, in
build/parent).
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
from quandary_tpu_torch.ops import cuda_build, rho  # noqa: E402

VARIANTS = {
    "source": (),
    "no_products": ((
        "      cmm<TS, true, false, LdS, LdG>(wr, wi, fr, fr + plane, 1, ld, "
        "ur, ui,\n                                     N, 1, r, c, N);\n"
        "      cmm<TS, false, true, LdG, LdS>(vr, vi, ur, ui, N, 1, fr, "
        "fr + plane, 1,\n                                     ld, r, c, N);"
        "\n", ""),),
    "cbar_no_loads": ((
        "          v += wr[a][b] * __ldg(Si + o) - wi[a][b] * __ldg(Sr + o);\n"
        "          v += vr[a][b] * __ldg(SiT + o) + vi[a][b] * "
        "__ldg(SrT + o);\n",
        "          v += (wr[a][b] - wi[a][b]) + (vr[a][b] + vi[a][b]);\n"),),
    "no_contract": ((
        "    contract_band(Sr, Si, C + st * K, K, N, r0, R, Mrow, Mrow + NN,\n"
        "                  replay ? Mt : nullptr, replay ? Mt + NN : nullptr);"
        "\n", ""),),
    "no_pair_barrier": ((
        "      if (i > 0) cluster_sync();    // every CTA has finished "
        "reading c\n", ""),),
    "no_tt": ((
        "      band_gen<TS, true>(kbr, kbi, g, fr, fr + plane, r, c, ok);\n",
        ""),),
}
CONFIGS = ("qudits125", "qudits128")


def variant_sources(src):
    """{name: path of its source}, written into the build directory."""
    with open(src) as f:
        text0 = f.read()
    out_dir = os.path.join(cuda_build.BUILD_DIR, "rho_mid_bwd_split")
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for name, subs in VARIANTS.items():
        text = text0
        for old, new in subs:
            if text.count(old) != 1:
                sys.exit(f"{name}: {src} does not hold {old!r} once")
            text = text.replace(old, new)
        paths[name] = os.path.join(out_dir, f"rho_mid_{name}.cu")
        with open(paths[name], "w") as f:
            f.write(text)
    return paths


def split(ms, nt, iters):
    """us per step of each part from the variants' mean times."""
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    full = mean["source_replayed"]
    us = lambda t: 1e3 * t / nt
    parts = dict(
        step=us(full), replay=us(full - mean["source_stored"]),
        products=us(full - mean["no_products"]),
        cbar_loads=us(full - mean["cbar_no_loads"]),
        contraction=us(full - mean["no_contract"]),
        pair_barriers=us(full - mean["no_pair_barrier"]),
        tt=us(full - mean["no_tt"]))
    parts["rest"] = parts["step"] - sum(v for k, v in parts.items()
                                        if k != "step")
    parts["products_per_pair"] = parts["products"] / (iters + 1)
    parts["tt_per_pair"] = parts["tt"] / (iters + 1)
    return parts


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "build", "parent"),
                    help="a directory holding quandary_tpu_torch/csrc/"
                         "rho_mid.cu with the single-role launcher")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    src = os.path.join(args.src, "quandary_tpu_torch", "csrc", "rho_mid.cu")
    if not os.path.isfile(src):
        sys.exit(f"{args.src} holds no quandary_tpu_torch/csrc/rho_mid.cu")
    paths = variant_sources(src)
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        futs = {k: pool.submit(rp.build_parent, p, f"rho_mid_split_{k}")
                for k, p in paths.items()}
        libs = {k: f.result() for k, f in futs.items()}
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    report = {"card": rp.smi_line(), "steps": args.steps}
    for name in CONFIGS:
        plan, x0r, x0i, C = rp.inputs(name, 1, args.steps)
        with cs.iterates_budget(1 << 62):
            fwd = rho._kernel_fwd(plan, x0r, x0i, C)
        hr, hi, ksr, ksi = fwd[2:]
        oT, oh = torch.ones_like(fwd[0]), torch.ones_like(hr)
        del fwd
        ms = {"source_stored": []}
        ms.update({("source_replayed" if k == "source" else k): []
                   for k in VARIANTS})
        for k in order:
            run = lambda kr=None, ki=None, k=k: rp.parent_bwd(
                libs[k], plan, x0r, x0i, C, hr, hi, kr, ki, oT, oT, oh, oh)
            ms["source_replayed" if k == "source" else k].append(
                cs.event_ms(run, 2))
            if k == "source":
                ms["source_stored"].append(cs.event_ms(
                    lambda: run(ksr, ksi), 2))
        torch.cuda.synchronize()
        report[name] = dict(N=plan.N, K=plan.K, J=plan.njump,
                            iters=plan.iters, B=x0r.shape[0], ms=ms,
                            us_per_step=split(ms, args.steps, plan.iters))
        del hr, hi, ksr, ksi, oT, oh
        print(json.dumps({name: report[name]}), flush=True)
    line = json.dumps(report)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "rho_mid_bwd_split.json"),
              "w") as f:
        f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
