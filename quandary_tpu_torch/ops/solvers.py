"""Propagation drivers: Python time loops over the whole state batch.

One loop advances every initial condition (and every control candidate on
leading axes) at once, so each RHS application is one batched matmul.
Gradients come from torch autograd through the loop, which stores the
in-step intermediates; the kernel path (ops/streamk.py) has a hand-written
adjoint instead.
"""

from __future__ import annotations

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


def propagate_trajectory(step_fn: Callable, x0, C):
    """All intermediate states, shape (ntime+1, *x0.shape)."""
    xs = [x0]
    for n in range(C.shape[0]):
        xs.append(step_fn(xs[-1], C[n]))
    return torch.stack(xs, dim=0)


# ----- observables (oscillator.cpp:430-566, mastereq.cpp:2897-2973) -----

def population_full(x, lindblad: bool):
    """Per-level population of the full system, shape (..., N):
    |psi_i|^2 or Re(rho_ii)."""
    return state_population(x, lindblad)
