"""Where the time of the mid-size streamK pair (csrc/streamk_mid.cu) goes,
on one CUDA GPU.

For scripts/perf/midsize_bench.py's closed systems (chip_smoke.py's
midsize_closed_setup: N = 256, 512, 1024 pure, 1000 steps, split), times
both kernels by CUDA events at 0, 1, 2 and 4 stage iterations (stored
iterates) and fits ms per step = fixed + stages x per-stage, so that the
cost of a stage (a cluster exchange and the band's product) and of a step's
fixed work (the contraction of the H band, the history, in the backward the
C-bar pass) come apart. Then, at N = 256 and 512, the same launch on
clusters of other sizes and with the bands of H forced into device-memory
scratch (the 'global' layout), and the N = 256 basis sweep (B = 256) at the
planner's shape. Each line is one JSON object with the card's name and
power limit.

Run from the repository root:  python3 scripts/streamk_mid_stages.py
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from quandary_tpu_torch.ops import streamk, streamk_mid  # noqa: E402
from quandary_tpu_torch.problem import Problem  # noqa: E402

REPS = 3
_planned = streamk._mid_shape
_force = {}


def _shape(E, B, N, Ke, iters, store, backward=False):
    """The planner's shape, or the forced cluster size and layout."""
    if not _force:
        return _planned(E, B, N, Ke, iters, store, backward)
    G, layout = _force["G"], _force["layout"]
    _, bc, _, _, _ = _planned(E, B, N, Ke, iters, store, backward)
    R = -(-N // G)
    replay = backward and not store and iters > 0
    smem = 4 * streamk._mid_floats(bc, N, R, iters, backward, replay,
                                   layout == "smem")
    return G, bc, 32 * max(4, min(16, R)), smem, layout


streamk._mid_shape = _shape


def times(plan, x0r, x0i, C):
    """(fwd ms, bwd ms, the launches' shapes) by CUDA events."""
    fwd = streamk_mid._kernel_fwd(plan, x0r, x0i, C)
    hr, hi, ksr, ksi = fwd[2:]
    oT, oh = torch.ones_like(fwd[0]), torch.ones_like(hr)
    f = chip_smoke.event_ms(lambda: streamk_mid._kernel_fwd(plan, x0r, x0i, C),
                            REPS)
    b = chip_smoke.event_ms(lambda: streamk_mid._kernel_bwd(
        plan, x0r, x0i, C, hr, hi, ksr, ksi, oT, oT, oh, oh), REPS)
    return f, b, {k: dict(v) for k, v in streamk_mid.mid_layouts.items()}


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("streamk_mid_stages.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    streamk_mid.build_kernels()
    for N, init in ((256, "pure"), (512, "pure"), (1024, "pure"),
                    (256, "basis")):
        pr = Problem(chip_smoke.midsize_closed_setup(N, init))
        x = torch.as_tensor(chip_smoke.bench_params(pr.setup.nparams),
                            device="cuda", dtype=torch.float32)
        C = streamk.extend_coeffs(pr._plan, pr.coeff_rows_mid(x)[None, :, 0])
        nt = C.shape[1]
        if init == "basis":
            f, b, shapes = times(pr._plan, pr._x0r, pr._x0i, C)
            print(json.dumps(dict(N=N, B=pr.ninit, iters=pr._plan.iters,
                                  stored=pr._plan.store_iters, fwd_ms=f,
                                  bwd_ms=b, shapes=shapes, card=smi)),
                  flush=True)
            continue
        rows = []
        for it in (0, 1, 2, 4):
            plan = streamk.make_plan(pr._Sr, pr._Si, pr.setup.dt, it,
                                     pr.gen_diag, pr.linsolver)
            f, b, shapes = times(plan, pr._x0r, pr._x0i, C)
            rows.append((it + 1, 1e3 * f / nt, 1e3 * b / nt))
            print(json.dumps(dict(N=N, B=1, iters=it, fwd_ms=f, bwd_ms=b,
                                  shapes=shapes, card=smi)), flush=True)
        st = np.array([r[0] for r in rows], dtype=float)
        fit = {}
        for j, key in ((1, "fwd"), (2, "bwd")):
            slope, icpt = np.polyfit(st, [r[j] for r in rows], 1)
            fit[key] = dict(us_per_stage=slope, us_fixed_per_step=icpt)
        print(json.dumps(dict(N=N, fit=fit, card=smi)), flush=True)
        if N == 1024:
            continue
        plan = pr._plan
        for G, layout in ((4, "smem"), (8, "smem"), (16, "smem"),
                          (16, "global")):
            if any(4 * streamk._mid_floats(1, N, -(-N // G), plan.iters, bw,
                                           False, layout == "smem")
                   > streamk._MAX_SMEM for bw in (False, True)):
                continue
            _force.update(G=G, layout=layout)
            f, b, shapes = times(plan, pr._x0r, pr._x0i, C)
            _force.clear()
            print(json.dumps(dict(N=N, B=1, iters=plan.iters, forced=dict(
                G=G, layout=layout), fwd_ms=f, bwd_ms=b, shapes=shapes,
                card=smi)), flush=True)


if __name__ == "__main__":
    main()
