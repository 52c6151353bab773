"""On-device production optimizer: the L-BFGS-B loop runs on the device in
chunks of iterations, so a real optimization pays no host round trip per
iteration.

The host driver (driver.run_optimization) fetches (f, g, aux)
synchronously for every line-search trial and copies the parameters to the
device each time. Here the whole iteration (two-loop direction, parallel
backtracking line search, curvature update, stopping tests) is a sequence
of tensor operations with no host synchronization; `chunk` iterations run
back to back and the host fetches only their scalar rows (chunk x 11
floats) and a done flag, once per chunk. The parameter vector and the
curvature memory stay on the device between chunks. On CUDA the chunk is
captured once as a CUDA graph and replayed, which also removes the launch
overhead of the many small operations of an iteration. A chunk of the
plain route (millions of graph nodes: every stage solve of every step is
a few kernels) is captured as a sequence of graphs, each under half
GRAPH_NODE_LIMIT nodes, replayed in order.

Line search: parallel Armijo backtracking. All `ls_lengths` trial steps
are evaluated in ONE ensemble call and the first satisfying length is
selected. With a fused path (streamK, stream or rho kernels) the search is
speculative: value and gradient at all trial points come out of one forward
and one backward launch, and the gradient at the accepted point is already
there.

Counterpart of quandary_tpu/optim/device_driver.py (its jitted lax.scan
chunk is the CUDA-graph chunk here).
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np
import torch

from ..io import output as out_io
from ..ops import (rho, rho_mid, solvers, stream, stream_mid, streamk,
                   streamk_mid)
from .batched_lbfgs import _direction, _remember
from .driver import OptimHistoryRow, OptimResult
from .lbfgsb import bounded_residual

AUX_KEYS = ("fidelity", "obj_cost", "obj_regul", "obj_penal",
            "obj_penal_dpdm", "obj_penal_energy", "obj_penal_variation")


# the modules whose wrappers count kernel launches
_KERNEL_MODULES = (streamk, streamk_mid, rho, rho_mid, stream, stream_mid)


def _add_launches(per_module, times=1):
    for m, counts in zip(_KERNEL_MODULES, per_module):
        m.add_launches(counts, times)


# The most nodes one CUDA graph may hold: graphs of one-element kernels,
# with nothing of this package in them, replayed right up to 2,600,000
# nodes, and at 2,900,000 and 3,200,000 a replay skipped 18 to 22 of them
# without an error, on an H100 80GB HBM3 (700 W, torch 2.11 with CUDA
# 12.8; scripts/graph_node_limit.py); a plain-route chunk of 3,136,215
# nodes faulted at its second replay (ROADMAP C1). A captured chunk keeps
# every graph under half of this.
GRAPH_NODE_LIMIT = 2_600_000


def graph_nodes(graph) -> int:
    """Nodes of a CUDA graph captured with keep_graph=True and not yet
    instantiated (cuGraphGetNodes)."""
    n = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    return n.value


def graph_segments(chunk: int, nodes_per_iteration: int) -> List[int]:
    """Iterations per graph of a captured chunk: as many as keep a graph's
    nodes under GRAPH_NODE_LIMIT / 2 (at least one), the last graph
    taking the rest."""
    k = max(1, (GRAPH_NODE_LIMIT // 2) // max(1, nodes_per_iteration))
    k = min(k, chunk)
    return [k] * (chunk // k) + ([chunk % k] if chunk % k else [])


def build_device_optimizer(problem, lb, ub, *, chunk=10, history=8,
                           ls_lengths=8, c1=1e-4, maxiter=200,
                           gatol=1e-8, grtol=1e-4, fatol=1e-8, inftol=1e-5,
                           graph=None):
    """Returns (init_fn, chunk_fn):
    state = init_fn(params0, params_ref); state, rows, done = chunk_fn(state).
    state is a dict of tensors on the problem's device; rows is (chunk, 11):
    [valid, f, gnorm, step, fidelity, cost, tik, penalty, dpdm, energy,
    variation]; done a 0-dim bool tensor.

    graph: replay the chunk as a CUDA graph (None: default_graph). The
    graph is captured at the first chunk_fn call, after one eager warm-up
    chunk; a capture that fails raises. On the plain route the chunk is
    captured as graph_segments(chunk, n) graphs of consecutive iterations,
    n the nodes of one iteration's graph, captured first and counted
    (graph_nodes); a kernel route's chunk is one graph. Each replay adds
    the kernel launches it stands for to the kernels' launch counters. On CUDA a
    kernel route that does not take ls_lengths candidates in one launch
    (Problem.ensemble_refusal) raises here, before any iteration."""
    rdtype, dev = problem.rdtype, problem.device
    on_cuda = dev.type == "cuda"
    graph = default_graph(problem) if graph is None else bool(graph)
    if graph and not on_cuda:
        raise ValueError("graph=True needs a problem on a CUDA device")
    why = problem.ensemble_refusal(ls_lengths) if on_cuda \
        and problem.use_fused else None
    if why is not None:
        raise NotImplementedError(
            f"device driver: the line search evaluates ls_lengths = "
            f"{ls_lengths} trial steps in one launch, which the route's "
            f"kernels do not take: {why}")
    kw = dict(dtype=rdtype, device=dev)
    lb = torch.as_tensor(np.asarray(lb, dtype=np.float64), **kw)
    ub = torch.as_tensor(np.asarray(ub, dtype=np.float64), **kw)
    m = int(history)
    ts = 0.5 ** torch.arange(ls_lengths, **kw)

    vg = problem.build_value_and_grad()
    # With a fused path the line search goes SPECULATIVE:
    # value_and_grad at ALL trial lengths in one ensemble call (one forward
    # and one backward launch per iteration), then select; the gradient at
    # the accepted point comes out of the same launches, so the separate
    # post-selection sweep disappears. The trial WINDOW is adaptive:
    # lengths are tscale * 0.5^j with tscale remembered across iterations
    # (grown back toward the unit step on acceptance), so 8 trials reach
    # arbitrarily small steps across iterations. On the plain path the
    # objective-only probes plus one value_and_grad stay cheaper (the
    # probes skip the backward pass).
    speculative = problem.use_fused
    evg = problem.build_ensemble_value_and_grad()
    eobj = problem._ensemble_objective()

    def project(x):
        return torch.minimum(torch.maximum(x, lb), ub)

    def fb_residual(x, g):
        # TAO's Fischer-Burmeister bounded residual (lbfgsb.bounded_residual:
        # reproduces the reference's ||Pr(grad)|| column exactly)
        def phi(a, b):
            return torch.sqrt(a * a + b * b) - a - b
        return phi(x - lb, phi(ub - x, -g))

    def aux_vec(aux, lead=()):
        return torch.stack([aux[k].to(rdtype).expand(lead) for k in AUX_KEYS],
                           dim=-1)

    def init(params0, params_ref):
        x = project(problem._param_tensor(params0))
        ref = problem._param_tensor(params_ref).clone()
        (f, aux), g = vg(x, ref)
        n = x.shape[0]
        zero = torch.zeros((), **kw)
        izero = torch.zeros((), dtype=torch.int64, device=dev)
        return dict(
            x=x, f=f.to(rdtype), g=g, aux=aux_vec(aux), ref=ref,
            S=torch.zeros((m, n), **kw), Y=torch.zeros((m, n), **kw),
            rho=torch.zeros((m,), **kw), count=izero, it=izero.clone(),
            gnorm0=torch.linalg.vector_norm(fb_residual(x, g)),
            done=torch.zeros((), dtype=torch.bool, device=dev),
            step=zero, tscale=torch.ones((), **kw),
        )

    def one_iteration(st):
        x, f, g = st["x"], st["f"], st["g"]
        d = _direction(x[None], g[None], st["S"][None], st["Y"][None],
                       st["rho"][None], st["count"][None], lb, ub)[0]

        # parallel Armijo backtracking: all trial lengths in one batched
        # call, in the adaptive window tscale * {1, 1/2, ..., 1/2^(L-1)}
        ts_row = st["tscale"] * ts
        xc = project(x[None, :] + ts_row[:, None] * d[None, :])
        if speculative:
            # f AND g at every trial length from one launch per direction;
            # the accepted point's gradient is already here
            (fc, auxc), gc = evg(xc, st["ref"])
        else:
            fc, _ = eobj(xc, st["ref"])
        fc = fc.to(rdtype)
        armijo = fc <= f + c1 * ((xc - x[None, :]) @ g)
        any_ok = armijo.any()
        # first satisfying length, as a 1-element index (no host sync)
        pick = torch.where(any_ok, armijo.to(torch.int8).argmax(), 0)[None]
        x_new = torch.where(any_ok, xc[pick][0], x)
        t_pick = ts_row[pick][0]
        step = torch.where(any_ok, t_pick, 0.0)
        # remember the accepted length, grown back toward the unit step;
        # on TOTAL rejection shift the window below the smallest tried
        # length and retry next iteration
        tscale = torch.where(any_ok, torch.clamp(2.0 * t_pick, max=1.0),
                             ts_row[-1] * 0.5)
        if speculative:
            f_new = torch.where(any_ok, fc[pick][0], f)
            g_new = torch.where(any_ok, gc[pick][0], g)
            av = torch.where(any_ok, aux_vec(auxc, fc.shape)[pick][0],
                             st["aux"])
        else:
            (f_new, aux_new), g_new = vg(x_new, st["ref"])
            f_new = f_new.to(rdtype)
            av = aux_vec(aux_new)

        s = x_new - x
        y = g_new - g
        good = any_ok & (torch.dot(s, y) > 1e-12)
        S, Y, rho, count = _remember(
            st["S"][None], st["Y"][None], st["rho"][None], st["count"][None],
            s[None], y[None], good[None])

        gnorm = torch.linalg.vector_norm(fb_residual(x_new, g_new))
        # stopping tests (driver.run_optimization / optimproblem.cpp:607-624).
        # A rejected window alone is NOT failure: the shrunken window
        # retries next iteration; the line search has genuinely failed only
        # once the window has collapsed to f32-negligible steps.
        done = ((1.0 - av[0] <= inftol) | (av[1] <= fatol)
                | (gnorm < gatol) | (gnorm / st["gnorm0"] < grtol)
                | (~any_ok & (tscale < 1e-7))
                | (st["it"] + 1 >= maxiter))
        return dict(st, x=x_new, f=f_new, g=g_new, aux=av, S=S[0], Y=Y[0],
                    rho=rho[0], count=count[0], it=st["it"] + 1, done=done,
                    step=step, tscale=tscale)

    def run_iterations(st, n):
        rows = []
        for _ in range(n):
            nxt = one_iteration(st)
            was_done = st["done"]
            # freeze once done: later iterations in the chunk are no-ops
            st = {k: torch.where(was_done, st[k], nxt[k]) for k in st}
            gnorm = torch.linalg.vector_norm(fb_residual(st["x"], st["g"]))
            rows.append(torch.cat([
                torch.stack([(~was_done).to(rdtype), st["f"], gnorm,
                             st["step"]]), st["aux"]]))
        return st, torch.stack(rows), st["done"]

    def chunk_eager(st):
        return run_iterations(st, chunk)

    if not graph:
        return init, chunk_eager

    captured = {}

    def capture_segment(static, n, rows_out=None, keep_graph=False):
        """A graph of n iterations on the static state buffers (and, with
        rows_out, their rows written into it)."""
        g = torch.cuda.CUDAGraph(keep_graph=keep_graph)
        with solvers.graph_capture(g):
            new, rows, _ = run_iterations(static, n)
            for k in static:
                static[k].copy_(new[k])
            if rows_out is not None:
                rows_out.copy_(rows)
        return g, rows

    def capture(st):
        """One eager warm-up chunk on a side stream (autograd and the
        allocator settle there), then the chunk captured on static state
        buffers: one graph on a kernel route; on the plain route one graph
        of one iteration, whose nodes are counted, then graph_segments'
        graphs. chunk_eager does not modify its input, so the state
        survives the warm-up."""
        static = {k: v.clone() for k, v in st.items()}
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            chunk_eager(static)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = [m.launch_counts() for m in _KERNEL_MODULES]
        if problem.use_fused:
            g, rows = capture_segment(static, chunk)
            graphs, segments = [g], [chunk]
        else:
            probe, _ = capture_segment(static, 1, keep_graph=True)
            per_iteration = graph_nodes(probe)
            del probe
            segments = graph_segments(chunk, per_iteration)
            rows = torch.empty((chunk, 4 + len(AUX_KEYS)), **kw)
            graphs, i0 = [], 0
            for n in segments:
                graphs.append(capture_segment(static, n,
                                              rows[i0:i0 + n])[0])
                i0 += n
            captured["nodes_per_iteration"] = per_iteration
        # the wrappers counted the captured launches, which did not run
        per_chunk = [{k: v - b[k] for k, v in m.launch_counts().items()}
                     for m, b in zip(_KERNEL_MODULES, before)]
        _add_launches(per_chunk, -1)
        captured.update(graphs=graphs, segments=segments, static=static,
                        rows=rows, per_chunk=per_chunk)

    def chunk_graph(st):
        if not captured:
            capture(st)
        static = captured["static"]
        if st is not static:
            for k in static:
                static[k].copy_(st[k])
        for g in captured["graphs"]:
            g.replay()
        _add_launches(captured["per_chunk"])
        return static, captured["rows"], static["done"]

    chunk_graph.captured = captured
    return init, chunk_graph


def default_graph(problem) -> bool:
    """The default of build_device_optimizer's `graph`: a CUDA graph of the
    chunk on a CUDA problem on a kernel route (use_fused). The plain route
    runs its chunks eagerly: its chunk is millions of graph nodes, whose
    capture costs about three eager chunks (154 s against 45 s for 10
    iterations at 1000 steps on an H100 80GB HBM3 at 700 W;
    scripts/plain_route_graph.py; graph=True captures it in segments under
    GRAPH_NODE_LIMIT / 2). It launches no kernel of the port, so nothing
    falls back from a kernel."""
    return problem.device.type == "cuda" and problem.use_fused


def run_optimization_device(
    problem,
    params0: np.ndarray,
    lb: np.ndarray,
    ub: np.ndarray,
    *,
    maxiter: int = 200,
    gatol: float = 1e-8,
    grtol: float = 1e-4,
    fatol: float = 1e-8,
    inftol: float = 1e-5,
    monitor_freq: int = 1,
    verbose: bool = True,
    chunk: int = 10,
    history: int = 8,
    ls_lengths: int = 8,
    datadir: Optional[str] = None,
    output_frequency: int = 1,
    graph: Optional[bool] = None,
) -> OptimResult:
    """Drop-in alternative to driver.run_optimization that keeps the whole
    loop on the device (one host fetch per `chunk` iterations). History
    rows are produced for every iteration; durability writes land once per
    chunk. `graph` as in build_device_optimizer.

    The (init_fn, chunk_fn) pair, with its captured CUDA graph, is memoized
    on the problem: re-running the same problem (restarts, warm campaigns,
    parameter sweeps) skips the warm-up and the capture."""
    # The memo key covers the driver scalars; a dict (not a single slot) so
    # alternating configurations do not evict each other. The Problem's
    # physics (model operators, setup) must not be mutated between calls.
    key = (np.ascontiguousarray(lb, dtype=np.float64).tobytes(),
           np.ascontiguousarray(ub, dtype=np.float64).tobytes(),
           chunk, history, ls_lengths, maxiter,
           float(gatol), float(grtol), float(fatol), float(inftol), graph)
    cache = getattr(problem, "_device_opt_cache", None)
    if not isinstance(cache, dict):
        cache = {}
        problem._device_opt_cache = cache
    if key not in cache:
        if len(cache) >= 8:     # bound growth across long sweeps
            cache.pop(next(iter(cache)))
        cache[key] = build_device_optimizer(
            problem, lb, ub, chunk=chunk, history=history,
            ls_lengths=ls_lengths, gatol=gatol, grtol=grtol, fatol=fatol,
            inftol=inftol, maxiter=maxiter, graph=graph)
    init_fn, chunk_fn = cache[key]

    st = init_fn(params0, np.asarray(params0, dtype=np.float64))

    hist_writer = None
    if datadir is not None:
        os.makedirs(datadir, exist_ok=True)
        hist_writer = out_io.OptimHistoryWriter(
            os.path.join(datadir, "optim_history.dat"))

    def host(t):
        return t.detach().cpu().double().numpy()

    def make_row(it, vals):
        f, gnorm, step = float(vals[1]), float(vals[2]), float(vals[3])
        a = [float(v) for v in vals[4:]]
        return OptimHistoryRow(
            iter=it, objective=f, gnorm=gnorm, step=step, fidelity=a[0],
            cost=a[1], tikhonov=a[2], penalty=a[3], penalty_dpdm=a[4],
            penalty_energy=a[5], penalty_variation=a[6])

    history_rows: List[OptimHistoryRow] = []
    # iteration-0 row from the init state
    res0 = bounded_residual(host(st["x"]), host(st["g"]),
                            np.asarray(lb, float), np.asarray(ub, float))
    row0 = make_row(0, np.concatenate([
        [1.0, float(st["f"]), np.linalg.norm(res0), 0.0], host(st["aux"])]))
    history_rows.append(row0)
    if hist_writer is not None:
        hist_writer.write_row(row0)
    if verbose:
        print(f"0  Objective {row0.objective:.14e}  Fidelity "
              f"{row0.fidelity:.8f}  ||Pr(grad)|| {row0.gnorm:.6e}")

    # iteration-0 stopping tests (an already-converged start never enters
    # the device loop)
    done_host = (1.0 - row0.fidelity <= inftol or row0.cost <= fatol
                 or row0.gnorm < gatol)

    it = 0
    try:
        while not done_host and it < maxiter:
            st, rows, done = chunk_fn(st)
            # ONE fetch per chunk: the rows and the done flag together
            fetched = host(torch.cat([rows.reshape(-1),
                                      done.to(rows.dtype)[None]]))
            for r in fetched[:-1].reshape(rows.shape):
                if r[0] < 0.5 or it >= maxiter:
                    break
                it += 1
                row = make_row(it, r)
                history_rows.append(row)
                if verbose and it % monitor_freq == 0:
                    print(f"{it}  Objective {row.objective:.14e}  Fidelity "
                          f"{row.fidelity:.8f}  ||Pr(grad)|| {row.gnorm:.6e}")
                if hist_writer is not None and it % monitor_freq == 0:
                    hist_writer.write_row(row)
            done_host = fetched[-1] > 0.5 or it >= maxiter
    finally:
        if hist_writer is not None:
            hist_writer.close()

    last = history_rows[-1]
    if 1.0 - last.fidelity <= inftol:
        reason = "converged: small infidelity"
    elif last.cost <= fatol:
        reason = "converged: small final time cost"
    elif last.gnorm < gatol:
        reason = "converged: small projected gradient norm (atol)"
    elif it >= maxiter:
        reason = "maxiter reached"
    else:
        reason = "line search failed or gradient reduction reached"

    x_final = host(st["x"])
    if datadir is not None:
        out_io.write_params(os.path.join(datadir, "params.dat"), x_final)
        ts_o, p, q, flab = problem.controls_on_output_grid(x_final)
        out_io.write_controls(datadir, ts_o, p, q, flab, output_frequency)

    return OptimResult(
        params=x_final, objective=last.objective,
        infidelity=1.0 - last.fidelity, history=history_rows,
        reason=reason, niter=it)
