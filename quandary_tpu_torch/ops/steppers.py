"""Time-stepping schemes in plain torch: IMR (default), IMR4, IMR8 and
explicit Euler.

The implicit midpoint rule:

    x_{n+1} = x_n + dt * k,   (I - dt/2 M^{n+1/2}) k = M^{n+1/2} x_n

The stage equation is solved by a fixed-iteration Neumann series
k <- b + (dt/2) M k, b = M x_n (timestepper.cpp:697-727), by its
Jacobi-preconditioned form, by one GMRES cycle (the reference's
linearsolver_type=gmres), or the step is the diagonally-split stepper (see
make_step_fn). The compositional schemes IMR4 (3 stages, Yoshida) and IMR8
(15 stages) perform IMR sub-steps of gamma_i * dt (timestepper.cpp:731-802);
explicit Euler takes one x <- x + dt M x. This is the plain (non-kernel)
propagation path and the algebra the streamK kernels implement
(ops/streamk.py, IMR only).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

# Compositional coefficients (timestepper.cpp:736-757)
GAMMA_IMR4 = np.array([
    1.0 / (2.0 - 2.0 ** (1.0 / 3.0)),
    -(2.0 ** (1.0 / 3.0)) / (2.0 - 2.0 ** (1.0 / 3.0)),
    1.0 / (2.0 - 2.0 ** (1.0 / 3.0)),
])
GAMMA_IMR8 = np.array([
    0.74167036435061295344822780,
    -0.40910082580003159399730010,
    0.19075471029623837995387626,
    -0.57386247111608226665638773,
    0.29906418130365592384446354,
    0.33462491824529818378495798,
    0.31529309239676659663205666,
    -0.79688793935291635401978884,
    0.31529309239676659663205666,
    0.33462491824529818378495798,
    0.29906418130365592384446354,
    -0.57386247111608226665638773,
    0.19075471029623837995387626,
    -0.40910082580003159399730010,
    0.74167036435061295344822780,
])


def stage_gammas(timestepper: str) -> np.ndarray:
    t = timestepper.upper()
    if t in ("IMR", "EE"):
        return np.array([1.0])
    if t == "IMR4":
        return GAMMA_IMR4
    if t == "IMR8":
        return GAMMA_IMR8
    raise ValueError(f"unknown timestepper {timestepper}")


def stage_midpoint_times(ntime: int, dt: float, timestepper: str) -> np.ndarray:
    """(ntime, nstages) array of the times at which the RHS is evaluated:
    IMR at the sub-interval midpoints t_cur + gamma_i*dt/2, where t_cur
    accumulates the previous stages' gamma*dt (timestepper.cpp:784-800);
    explicit Euler at the interval start."""
    g = stage_gammas(timestepper)
    starts = np.concatenate([[0.0], np.cumsum(g)[:-1]])
    if timestepper.upper() == "EE":
        offs = starts * dt
    else:
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


def gmres_solve(matvec: Callable, b, half_dt, iters: int,
                vec_ndim: Optional[int] = None):
    """GMRES stage solve of (I - half_dt*M) k = b from k = b: ONE Krylov
    cycle of `iters` inner iterations (the reference's KSP maxits
    semantics, timestepper.cpp:541-550), with the absolute and relative
    tolerance 1e-12 of quandary_tpu's jax.scipy GMRES call (restart=iters,
    maxiter=1, batched: Arnoldi with classical Gram-Schmidt twice, the
    Hessenberg least-squares problem by its normal equations).

    The last `vec_ndim` axes of b form one vector (None: all of them);
    leading axes are independent systems (control candidates)."""
    def op(y):
        return y - half_dt * matvec(y)

    nd = b.ndim if vec_ndim is None else vec_ndim
    lead = tuple(b.shape[:b.ndim - nd])
    n = math.prod(b.shape[b.ndim - nd:])
    m = min(int(iters), n)
    eps = torch.finfo(b.real.dtype).eps
    flat = lambda y: y.reshape(lead + (n,))

    def normalize(v, thresh):
        nrm = torch.linalg.vector_norm(v, dim=-1)
        use = nrm > thresh
        unit = torch.where(use[..., None], v / nrm.to(v.dtype)[..., None],
                           torch.zeros_like(v))
        return unit, torch.where(use, nrm, torch.zeros_like(nrm))

    bf = flat(b)
    unit_r, rnorm = normalize(bf - flat(op(b)), eps)
    atol = torch.clamp(1e-12 * torch.linalg.vector_norm(bf, dim=-1),
                       min=1e-12)
    active = rnorm > atol           # the outer loop runs one cycle, if any
    V = [unit_r]
    H = torch.eye(m, m + 1, dtype=b.dtype, device=b.device).expand(
        lead + (m, m + 1)).clone()
    alive = torch.ones(lead, dtype=torch.bool, device=b.device)
    for k in range(m):
        w = flat(op(V[k].reshape(b.shape)))
        _, w_norm0 = normalize(w, eps)
        Q = torch.stack(V, dim=-1)                       # (..., n, k+1)
        h = torch.zeros(lead + (k + 1,), dtype=b.dtype, device=b.device)
        for _ in range(2):                               # twice is enough
            proj = (Q.conj() * w[..., None]).sum(dim=-2)
            w = w - (Q @ proj[..., None])[..., 0]
            h = h + proj
        unit_w, w_norm1 = normalize(w, eps * w_norm0)
        row = torch.cat([h, w_norm1.to(b.dtype)[..., None],
                         torch.zeros(lead + (m - k - 1,), dtype=b.dtype,
                                     device=b.device)], dim=-1)
        H[..., k, :] = torch.where(alive[..., None], row, H[..., k, :])
        V.append(torch.where(alive[..., None], unit_w,
                             torch.zeros_like(unit_w)))
        alive = alive & (w_norm1 != 0)
    A = H.transpose(-1, -2)                              # (..., m+1, m)
    beta = torch.zeros(lead + (m + 1,), dtype=b.dtype, device=b.device)
    beta[..., 0] = rnorm.to(b.dtype)
    Ah = A.conj().transpose(-1, -2)
    y = torch.linalg.solve(Ah @ A, (Ah @ beta[..., None]))[..., 0]
    dx = (torch.stack(V[:m], dim=-1) @ y[..., None])[..., 0]
    dx = torch.where(active[..., None], dx, torch.zeros_like(dx))
    return b + dx.reshape(b.shape)


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


def _stage_iterates(A, b, engine, a, iters, d, jacobi):
    """The stage recursion of _StageSolve: (k, the iterates k enters each
    iteration with, P)."""
    if d is None:
        mv = lambda y: engine.apply(A, y)
    else:
        mv = lambda y: engine.apply(A, y) - d * y
    P = 1.0 / (1.0 - a * d) if jacobi else None
    k = P * b if jacobi else b
    ks = []
    for _ in range(iters):
        ks.append(k)
        k = P * (b + a * mv(k)) if jacobi else b + a * mv(k)
    return k, ks, P


class _StageSolve(torch.autograd.Function):
    """The stage solve of an assembled H_eff A as one autograd node:
    Neumann k <- b + a V k from k = b, or its Jacobi form
    k <- P (b + a V k) from k = P b with P = 1 / (1 - a D), where
    V = M - D (D = 0 for plain Neumann) and M = engine.apply(A, .). The
    forward computes what neumann_solve / jacobi_neumann_solve compute, in
    the same order (the same bits); the backward is the transposed
    recursion with engine.apply_adjoint, and A's cotangent is
    engine.apply_vjp_A over all stored iterates at once. A backward that
    builds a graph itself (create_graph, as a Hessian's double backward
    asks) differentiates the recursion run again in differentiable ops
    instead, so that second derivatives reach the iterates."""

    @staticmethod
    def forward(ctx, A, b, engine, a, iters, d, jacobi):
        k, ks, P = _stage_iterates(A, b, engine, a, iters, d, jacobi)
        ctx.engine, ctx.a, ctx.d, ctx.P, ctx.ks = engine, a, d, P, ks
        ctx.iters, ctx.jacobi = iters, jacobi
        ctx.save_for_backward(A, b)
        return k

    @staticmethod
    def backward(ctx, kbar):
        A, b = ctx.saved_tensors
        engine, a, d, P, ks = ctx.engine, ctx.a, ctx.d, ctx.P, ctx.ks
        if torch.is_grad_enabled():
            # fresh nodes on A and b: b's own history may lead to A (b =
            # M(A) x), a path the outer graph already differentiates
            A, b = A.clone(), b.clone()
            want = [t for t, n in zip((A, b), ctx.needs_input_grad) if n]
            k, _, _ = _stage_iterates(A, b, engine, a, ctx.iters, d,
                                      ctx.jacobi)
            got = iter(torch.autograd.grad(k, want, kbar, create_graph=True,
                                           allow_unused=True))
            return (next(got) if ctx.needs_input_grad[0] else None,
                    next(got) if ctx.needs_input_grad[1] else None,
                    None, None, None, None, None)
        Pc = None if P is None else P.conj()
        dc = None if d is None else d.conj()
        lam, bbar, mus = kbar, 0.0, []
        for _ in reversed(ks):
            mu = lam if Pc is None else Pc * lam
            bbar = bbar + mu
            mus.append(a * mu)
            lam = engine.apply_adjoint(A, mu)
            lam = a * (lam if dc is None else lam - dc * mu)
        bbar = bbar + (lam if Pc is None else Pc * lam)
        Abar = None
        if ctx.needs_input_grad[0] and ks:
            Abar = engine.apply_vjp_A(A, torch.stack(ks),
                                      torch.stack(mus[::-1]))
        return Abar, bbar, None, None, None, None, None


def make_step_fn(rhs: Callable, dt: float, timestepper: str = "IMR",
                 linsolve_iters: int = 10, linsolver: str = "neumann",
                 gen_diag=None, vec_ndim: Optional[int] = None,
                 engine=None):
    """Build the one-step update x_n -> x_{n+1}.

    rhs(c, x): applies M(t) given the coefficient row c.
    gen_diag: host diagonal of the generator in the state's shape ((N,), or
        (N, N) for density matrices), needed by 'jacobi' and 'split'.
    linsolver: 'neumann' | 'jacobi' | 'gmres' | 'split'. 'split' is a
        diagonally-split STEPPER: x -> E_{h/2} . IMR_V(h) . E_{h/2} x with
        the stiff diagonal D integrated exactly by E_s = exp(s*D) (computed
        in f64 on the host) and only the off-diagonal remainder V = M - D
        solved by Neumann.
    vec_ndim: for 'gmres', the trailing axes of the state that form one
        system's vector (gmres_solve).
    engine: optional, the object whose `rhs` this is, with assemble(c)
        and apply(A, x): each stage then assembles its operator once for
        all of its matvecs (the same bits as rhs). Where the engine also
        has apply_adjoint(A, y) and apply_vjp_A (ops/rhs.py DenseEngine),
        the Neumann, Jacobi and split stage solves run as one autograd node
        each with a hand-written transpose (_StageSolve), instead of a node
        per operation of every iteration.
    Returns step(x, c_stages) with c_stages of shape (..., nstages, K). The
    diagonal and the split factors go to a device once, at the first step
    there, so a step on the card copies nothing from the host.
    """
    gammas = stage_gammas(timestepper)
    explicit = timestepper.upper() == "EE"
    if linsolver not in ("neumann", "jacobi", "gmres", "split"):
        raise ValueError(f"unknown linsolver {linsolver!r}")
    if linsolver in ("jacobi", "split") and gen_diag is None:
        raise ValueError(f"linsolver={linsolver!r} requires gen_diag")
    d64 = None if gen_diag is None else np.asarray(gen_diag, np.complex128)
    consts = {}

    def on_device(x):
        """(d, {h: E_{h/2}}) on x's device and dtype, built once each."""
        key = (x.device, x.dtype)
        if key not in consts:
            put = lambda a: torch.as_tensor(a, device=x.device).to(x.dtype)
            d = None if d64 is None else put(d64)
            E = {}
            if linsolver == "split":
                for g in gammas:
                    h = float(g) * float(dt)
                    E[h] = put(np.exp((h / 2.0) * d64))
            consts[key] = (d, E)
        return consts[key]

    node = engine is not None and hasattr(engine, "apply_adjoint")

    def solve(mv, b, h, A, d, jacobi):
        if node:
            return _StageSolve.apply(A, b, engine, h / 2.0, linsolve_iters,
                                     d, jacobi)
        if jacobi:
            return jacobi_neumann_solve(mv, d, b, h / 2.0, linsolve_iters)
        return neumann_solve(mv, b, h / 2.0, linsolve_iters)

    def step(x, c_stages):
        d, E_half = on_device(x)
        for i, g in enumerate(gammas):
            h = float(g) * float(dt)
            c = c_stages[..., i, :]
            A = None if engine is None else engine.assemble(c)
            if A is None:
                mv = lambda y, c=c: rhs(c, y)
            else:
                mv = lambda y, A=A: engine.apply(A, y)
            if explicit:
                x = x + h * mv(x)
            elif linsolver == "split":
                E = E_half[h]
                mvd = lambda y, mv=mv: mv(y) - d * y
                x = E * x
                k = solve(mvd, mvd(x), h, A, d, False)
                x = E * (x + h * k)
            elif linsolver == "gmres":
                k = gmres_solve(mv, mv(x), h / 2.0, linsolve_iters, vec_ndim)
                x = x + h * k
            else:
                jacobi = linsolver == "jacobi"
                k = solve(mv, mv(x), h, A, d if jacobi else None, jacobi)
                x = x + h * k
        return x

    return step
