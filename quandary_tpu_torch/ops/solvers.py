"""Propagation drivers: Python time loops over the whole state batch.

One loop advances every initial condition (and every control candidate on
leading axes) at once, so each RHS application is one batched matmul.
Gradients come from torch autograd through the loop, which stores the
in-step intermediates; the kernel path (ops/streamk.py) has a hand-written
adjoint instead. Also the observables the output files report (per-level
and reduced populations, expected energies).
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable

import torch

from .rhs import state_population


def propagate(step_fn: Callable, x0, C):
    """Run the time loop and return the final state.

    step_fn : (x, c_stages) -> x_next, with c_stages (..., nstages, K).
    x0 : initial state batch.
    C : (ntime, ..., nstages, K) coefficient rows at the stage midpoints.
    """
    x = x0
    for n in range(C.shape[0]):
        x = step_fn(x, C[n])
    return x


GRAPH_STEPS = 64     # steps per CUDA graph of a trajectory without autograd


@contextlib.contextmanager
def graph_capture(graph):
    """torch.cuda.graph(graph) with Python's cyclic garbage collector paused
    for the capture. A collection inside a capture can destroy a CUDA graph
    that only a reference cycle kept alive (a Problem and the device
    optimizer it caches, optim/device_driver.py, form one), and that
    graph's teardown invalidates the capture under way
    (cudaErrorStreamCaptureInvalidated); paused, the collector frees it
    after the capture. Every capture of the port goes through here."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            yield
    finally:
        if enabled:
            gc.enable()


def propagate_trajectory(step_fn: Callable, x0, C):
    """All intermediate states, shape (ntime+1, *x0.shape). On a CUDA
    device without autograd (and outside a graph capture) the steps are
    replayed from a CUDA graph of GRAPH_STEPS steps, captured once per
    call: the same kernels as the loop, launched without the host's cost
    per operation."""
    nt = C.shape[0]
    if (x0.is_cuda and not torch.is_grad_enabled() and nt >= GRAPH_STEPS
            and not torch.cuda.is_current_stream_capturing()):
        return _trajectory_graph(step_fn, x0, C)
    xs = [x0]
    for n in range(nt):
        xs.append(step_fn(xs[-1], C[n]))
    return torch.stack(xs, dim=0)


def propagate_trajectory_remat(step_fn: Callable, x0, C):
    """propagate_trajectory for a gradient that keeps one state per step:
    each step is recomputed in the backward (torch.utils.checkpoint), as
    the reference's 'remat' scan checkpoints its step
    (quandary_tpu/ops/solvers.py:40)."""
    from torch.utils.checkpoint import checkpoint
    xs = [x0]
    for n in range(C.shape[0]):
        xs.append(checkpoint(step_fn, xs[-1], C[n], use_reentrant=False))
    return torch.stack(xs, dim=0)


def _trajectory_graph(step_fn, x0, C, S=GRAPH_STEPS):
    nt = C.shape[0]
    out = torch.empty((nt + 1,) + tuple(x0.shape), dtype=x0.dtype,
                      device=x0.device)
    out[0] = x0
    x_in, c_in = x0.clone(), C[:S].clone()
    states = torch.empty((S,) + tuple(x0.shape), dtype=x0.dtype,
                         device=x0.device)

    def steps():
        x = x_in
        for i in range(S):
            x = step_fn(x, c_in[i])
            states[i].copy_(x)

    # warm up on a side stream (the step's device constants are made
    # there), then capture
    side = torch.cuda.Stream(x0.device)
    side.wait_stream(torch.cuda.current_stream(x0.device))
    with torch.cuda.stream(side):
        steps()
    torch.cuda.current_stream(x0.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with graph_capture(graph):
        steps()
    n0 = 0
    while n0 + S <= nt:
        x_in.copy_(out[n0])
        c_in.copy_(C[n0:n0 + S])
        graph.replay()
        out[n0 + 1:n0 + S + 1] = states
        n0 += S
    for n in range(n0, nt):
        out[n + 1] = step_fn(out[n], C[n])
    return out


# ----- observables (oscillator.cpp:430-566, mastereq.cpp:2897-2973) -----

def population_full(x, lindblad: bool):
    """Per-level population of the full system, shape (..., N):
    |psi_i|^2 or Re(rho_ii)."""
    return state_population(x, lindblad)


def reduced_population(pop_full, dims, k: int):
    """Population of oscillator k: reduce the full per-level population over
    all other oscillators. pop_full (..., N) -> (..., dims[k])."""
    lead = tuple(pop_full.shape[:-1])
    t = pop_full.reshape(lead + tuple(dims))
    axes = tuple(len(lead) + i for i in range(len(dims)) if i != k)
    return torch.sum(t, dim=axes) if axes else t


def expected_energy(pop_full, dims, k: int):
    """<N_k> = sum_l l * pop_k[l] (oscillator.cpp:430-473)."""
    red = reduced_population(pop_full, dims, k)
    levels = torch.arange(dims[k], dtype=pop_full.dtype,
                          device=pop_full.device)
    return torch.sum(red * levels, dim=-1)


def expected_energy_composite(pop_full, dims):
    """Composite expected energy: sum_i i * pop_i with the 'number operator'
    N_m = diag(0, 1, ..., N-1) over the GLOBAL index, i.e. the flat index
    itself, not the sum of per-oscillator number operators
    (mastereq.cpp:2897-2934, num_diag = i)."""
    idx = torch.arange(pop_full.shape[-1], dtype=pop_full.dtype,
                       device=pop_full.device)
    return torch.sum(pop_full * idx, dim=-1)
