"""The device optimizer's chunk on the plain route on one CUDA card: eager
chunks against the same chunk captured as a CUDA graph.

The problem is config_template.cfg's as setup_from_config builds it
(complex128, so off the kernels: 2 transmons, N = 4, 4 basis states,
ntime 1000, 20 stage iterations), on the sequential time loop
(time_parallel=False; 'auto' takes the time-parallel scan at this size). For each chunk length (iterations per
chunk) the script times, after synchronizing the card:

* eager_s: one chunk of build_device_optimizer(graph=False);
* first_s: the first chunk of build_device_optimizer(graph=True), which
  runs one eager warm-up chunk, captures one iteration to count its graph
  nodes, captures the chunk as graphs of consecutive iterations, each
  under half device_driver.GRAPH_NODE_LIMIT nodes, and replays them once;
* replay_s: a second call of that chunk, a replay alone, then a third
  (replay3_s); one graph of a chunk of 10 at 1000 steps (3.1M nodes)
  faulted at its second replay on an H100 (illegal address, ROADMAP C1),
  which the segments avoid;

tells whether the graph's rows equal the eager chunk's in bits (after each
of the three calls, against three eager chunks), and prints one JSON line
with these seconds, their ratios per iteration, the graph nodes of one
iteration, the iterations of each graph and the chunks after which the
graphs have paid for their capture, (first_s - replay_s) / (eager_s -
replay_s).

Run from the repository root, on a machine with a CUDA card:

    python3 scripts/plain_route_graph.py [--chunks 1,2] [--ntime 1000] \
        [--probe]

(--ntime other than the file's 1000 keeps the horizon and refines or
coarsens the step. The driver's default `graph`, device_driver.default_graph,
runs the plain route eagerly; the script captures anyway. --probe prints
each captured graph's node count before its first replay, see
probe_graphs.)
"""

import argparse
import ctypes
import dataclasses
import inspect
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from quandary_tpu_torch.io.configfile import Config, setup_from_config  # noqa: E402
from quandary_tpu_torch.optim.device_driver import (  # noqa: E402
    build_device_optimizer, default_graph)
from quandary_tpu_torch.optim.driver import build_bounds  # noqa: E402
from quandary_tpu_torch.problem import Problem  # noqa: E402


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def probe_graphs():
    """Makes every CUDA graph the script captures keep its cudaGraph_t and
    print, at capture_end and before any replay, its node count
    (cuGraphGetNodes) as one JSON line; where this PyTorch has it,
    capture_begin also tracks the graph's external inputs
    (check_input_liveness: a replay after one of them was freed raises)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    base = torch.cuda.CUDAGraph
    live = "check_input_liveness" in inspect.signature(
        base.capture_begin).parameters

    class Probe(base):
        def __new__(cls, keep_graph=False):
            return super().__new__(cls, True)

        def __init__(self, keep_graph=False):
            super().__init__(True)

        def capture_begin(self, *a, **k):
            if live:
                k["check_input_liveness"] = True
            return super().capture_begin(*a, **k)

        def capture_end(self):
            super().capture_end()
            n = ctypes.c_size_t(0)
            rc = cuda.cuGraphGetNodes(ctypes.c_void_p(self.raw_cuda_graph()),
                                      None, ctypes.byref(n))
            print(json.dumps(dict(graph_nodes=n.value, rc=rc,
                                  input_liveness=live)), flush=True)
            self.instantiate()

    torch.cuda.CUDAGraph = Probe


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", default="1,2")
    ap.add_argument("--ntime", type=int, default=0)
    ap.add_argument("--probe", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if args.probe:
        probe_graphs()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    setup, spec = setup_from_config(
        Config.read(os.path.join(root, "config_template.cfg")), root)
    setup = dataclasses.replace(setup, time_parallel=False)
    if args.ntime:
        setup = dataclasses.replace(setup, ntime=args.ntime,
                                    dt=setup.dt * setup.ntime / args.ntime)
    problem = Problem(setup)
    if problem.fused_form is not None:
        raise SystemExit(f"expected the plain route, got {problem.fused_form}")
    lb, ub = build_bounds(setup.oscillators, spec.control_bounds)
    x0 = spec.params0
    out = dict(card=smi, ntime=setup.ntime, N=problem.N, B=problem.ninit,
               iters=setup.linsolve_iters, linsolver=problem.linsolver,
               default_graph=default_graph(problem))
    for chunk in (int(c) for c in args.chunks.split(",")):
        kw = dict(chunk=chunk, maxiter=10 ** 6, gatol=0.0, grtol=0.0,
                  fatol=0.0, inftol=0.0)
        init_e, step_e = build_device_optimizer(problem, lb, ub, graph=False,
                                                **kw)
        init_g, step_g = build_device_optimizer(problem, lb, ub, graph=True,
                                                **kw)
        (se, rows_e, _), eager_s = timed(lambda: step_e(init_e(x0, x0)))
        (se2, rows_e2, _), _ = timed(lambda: step_e(se))
        rows_e3 = step_e(se2)[1]
        st = init_g(x0, x0)
        (st2, rows_g, _), first_s = timed(lambda: step_g(st))
        same = [bool(torch.equal(rows_e, rows_g))]
        (st3, rows_g, _), replay_s = timed(lambda: step_g(st2))
        same.append(bool(torch.equal(rows_e2, rows_g)))
        (_, rows_g, _), replay3_s = timed(lambda: step_g(st3))
        same.append(bool(torch.equal(rows_e3, rows_g)))
        paid = ((first_s - replay_s) / (eager_s - replay_s)
                if eager_s > replay_s else None)
        cap = getattr(step_g, "captured", {})
        out[f"chunk{chunk}"] = dict(
            eager_s=eager_s, first_s=first_s, replay_s=replay_s,
            replay3_s=replay3_s,
            eager_s_per_iter=eager_s / chunk,
            replay_s_per_iter=replay_s / chunk,
            chunks_to_pay=paid, rows_equal=all(same), rows_equal_per_call=same,
            nodes_per_iteration=cap.get("nodes_per_iteration"),
            segments=cap.get("segments"))
        print(json.dumps({f"chunk{chunk}": out[f"chunk{chunk}"]}),
              flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
