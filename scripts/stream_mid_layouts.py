"""Which layout of the bands of H the mid-size streamed-plane pair
(csrc/stream_mid.cu) should take, on one CUDA GPU.

For scripts/perf/midsize_bench.py's closed systems at N = 256 and 512
(chip_smoke.py's midsize_closed_setup: pure, 1000 steps, split-4) on the
'stream' route, the planes of the bench's parameter draw, both kernels are
timed by CUDA events in every layout that fits a CTA:

* smem2: two band slots in shared memory, the next step's band streamed in
  by cp.async while the step runs;
* smem1: one slot, copied at the step's start;
* global: the row band read from the plane array through L2, the
  backward's column band transposed into a device-memory scratch at the
  step's start;

with the stage iterates stored and replayed, in turns (a, b, c, c, b, a),
and every layout's outputs are checked for the same bits (the chain reads
the same values in the same order wherever the band lives). Each line is
one JSON object with the card's name and power limit; 'planned' is the
layout ops/stream.py::_mid_shape picks.

Run from the repository root:  python3 scripts/stream_mid_layouts.py
"""

import dataclasses
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from quandary_tpu_torch.ops import stream, stream_mid  # noqa: E402
from quandary_tpu_torch.problem import Problem  # noqa: E402

REPS = 3
LAYOUTS = ("smem2", "smem1", "global")


def fitting(plan, B, N, backward):
    store = plan.store_iters and plan.iters > 0
    return [lay for lay in LAYOUTS if stream._mid_shape(
        1, B, N, plan.iters, store, backward, lay) is not None]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for N in (256, 512):
        setup = dataclasses.replace(
            chip_smoke.midsize_closed_setup(N, "pure"), fused_mode="stream")
        pr = Problem(setup)
        x = torch.as_tensor(chip_smoke.bench_params(setup.nparams),
                            device="cuda", dtype=torch.float32)
        with torch.no_grad():
            C = pr.coeff_rows_mid(x)[None, :, 0, :].to(torch.float32)
            Hr, Hi = (h.contiguous() for h in stream.planes(
                pr._plan, pr._Sr, pr._Si, C))
        x0r, x0i = pr._x0r, pr._x0i
        B = x0r.shape[0]
        for store in (True, False):
            plan = dataclasses.replace(pr._plan, store_iters=store)
            out = dict(N=N, B=B, ntime=setup.ntime, iters=plan.iters,
                       stored=store, card=smi)
            fwd0 = stream_mid._kernel_fwd(plan, Hr, Hi, x0r, x0i)
            hr, hi, ksr, ksi = fwd0[2:]
            oT, oh = torch.ones_like(fwd0[0]), torch.ones_like(hr)
            same = True
            for key, backward in (("fwd", False), ("bwd", True)):
                lays = fitting(plan, B, N, backward)

                def run(lay, backward=backward):
                    if backward:
                        return stream_mid._kernel_bwd(
                            plan, Hr, Hi, x0r, x0i, hr, hi, ksr, ksi, oT, oT,
                            oh, oh, _layout=lay)
                    return stream_mid._kernel_fwd(plan, Hr, Hi, x0r, x0i,
                                                  _layout=lay)

                ms = {lay: [] for lay in lays}
                ref = None
                for lay in lays + lays[::-1]:
                    got = run(lay)
                    if ref is None:
                        ref = got
                    same &= all((a is None and b is None) or torch.equal(a, b)
                                for a, b in zip(ref, got))
                    ms[lay].append(chip_smoke.event_ms(lambda: run(lay),
                                                       REPS))
                out[key] = {lay: sum(v) / len(v) for lay, v in ms.items()}
                out[f"{key}_runs"] = ms
                # (G, Bc, threads, shared-memory bytes, layout)
                out[f"{key}_planned"] = stream._mid_shape(
                    1, B, N, plan.iters, store, backward)
            out["same_bits"] = bool(same)
            print(json.dumps(out), flush=True)
            if not same:
                raise SystemExit("layouts disagree in bits")
        del Hr, Hi, pr
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
