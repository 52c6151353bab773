"""The implicit midpoint rule (IMR) in plain torch.

    x_{n+1} = x_n + dt * k,   (I - dt/2 M^{n+1/2}) k = M^{n+1/2} x_n

The stage equation is solved by a fixed-iteration Neumann series
k <- b + (dt/2) M k, b = M x_n (timestepper.cpp:697-727), by its
Jacobi-preconditioned form, or the step is the diagonally-split stepper
(see make_step_fn). This is the plain (non-kernel) propagation path and the
algebra the streamK kernels implement (ops/streamk.py). The compositional
IMR4/IMR8 schemes, explicit Euler and the GMRES stage solve are not ported
yet.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def stage_gammas(timestepper: str) -> np.ndarray:
    if timestepper.upper() == "IMR":
        return np.array([1.0])
    raise NotImplementedError(
        f"timestepper {timestepper!r} is not ported to quandary_tpu_torch "
        "yet (IMR only)")


def stage_midpoint_times(ntime: int, dt: float, timestepper: str) -> np.ndarray:
    """(ntime, nstages) array of the times at which the RHS is evaluated:
    the sub-interval midpoints (timestepper.cpp:784-800)."""
    g = stage_gammas(timestepper)
    starts = np.concatenate([[0.0], np.cumsum(g)[:-1]])
    offs = (starts + g / 2.0) * dt
    t0 = np.arange(ntime)[:, None] * dt
    return t0 + offs[None, :]


def neumann_solve(matvec: Callable, b, half_dt, iters: int):
    """Solve (I - half_dt*M) k = b by the fixed-iteration Neumann recursion
    k <- b + half_dt * M k (timestepper.cpp:697-727)."""
    k = b
    for _ in range(iters):
        k = b + half_dt * matvec(k)
    return k


def jacobi_neumann_solve(matvec: Callable, diag, b, half_dt, iters: int):
    """Jacobi-preconditioned Neumann iteration for (I - half_dt*M) k = b:

        k <- (I - a D)^{-1} (b + a (M - D) k),   a = half_dt

    with D the generator's elementwise diagonal. It contracts at rate
    ~ a*||M - D|| regardless of the diagonal's stiffness."""
    Minv = 1.0 / (1.0 - half_dt * diag)
    k = Minv * b
    for _ in range(iters):
        k = Minv * (b + half_dt * (matvec(k) - diag * k))
    return k


def make_step_fn(rhs: Callable, dt: float, timestepper: str = "IMR",
                 linsolve_iters: int = 10, linsolver: str = "neumann",
                 gen_diag=None):
    """Build the one-step update x_n -> x_{n+1}.

    rhs(c, x): applies M(t) given the coefficient row c.
    gen_diag: host diagonal of the generator in the state's shape ((N,), or
        (N, N) for density matrices), needed by 'jacobi' and 'split'.
    linsolver: 'neumann' | 'jacobi' | 'split'. 'split' is a diagonally-split
        STEPPER: x -> E_{h/2} . IMR_V(h) . E_{h/2} x with the stiff diagonal
        D integrated exactly by E_s = exp(s*D) (computed in f64 on the host)
        and only the off-diagonal remainder V = M - D solved by Neumann.
    Returns step(x, c_stages) with c_stages of shape (..., nstages, K).
    """
    gammas = stage_gammas(timestepper)
    if linsolver not in ("neumann", "jacobi", "split"):
        raise NotImplementedError(
            f"linsolver {linsolver!r} is not ported to quandary_tpu_torch "
            "yet (neumann, jacobi, split)")
    if linsolver in ("jacobi", "split") and gen_diag is None:
        raise ValueError(f"linsolver={linsolver!r} requires gen_diag")
    d64 = None if gen_diag is None else np.asarray(gen_diag, np.complex128)

    def step(x, c_stages):
        d = None if d64 is None else torch.as_tensor(
            d64, device=x.device).to(x.dtype)
        for i, g in enumerate(gammas):
            h = float(g) * float(dt)
            c = c_stages[..., i, :]
            if linsolver == "split":
                E = torch.as_tensor(np.exp((h / 2.0) * d64),
                                    device=x.device).to(x.dtype)
                mv = lambda y, c=c: rhs(c, y) - d * y
                x = E * x
                k = neumann_solve(mv, mv(x), h / 2.0, linsolve_iters)
                x = E * (x + h * k)
            else:
                mv = lambda y, c=c: rhs(c, y)
                b = mv(x)
                if linsolver == "jacobi":
                    k = jacobi_neumann_solve(mv, d, b, h / 2.0,
                                             linsolve_iters)
                else:
                    k = neumann_solve(mv, b, h / 2.0, linsolve_iters)
                x = x + h * k
        return x

    return step
