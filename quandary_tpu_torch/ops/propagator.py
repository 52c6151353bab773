"""Time-parallel propagation: batched step matrices and a prefix scan.

The port of quandary_tpu/ops/propagator.py. The dynamics are linear,
x_{n+1} = S_n x_n, with the IMR step operator

    S_n = I + dt K_n,   K_n = (I - dt/2 M_n)^{-1} M_n,   M_n = -i H(t_n + dt/2)

so instead of a loop of 2 ntime dependent small products the problem

 1. assembles every step generator M_n at once (one (ntime nstages, K) x
    (K, N, N) product),
 2. runs the matrix Neumann (or Jacobi) recursion batched over all steps,
 3. combines the stages into the per-step operators S_n,
 4. forms every prefix propagator P_n = S_n ... S_1 by the odd/even
    recursion of jax.lax.associative_scan, in the same order of products:
    about 2 ntime matrix products in 2 log2(ntime) rounds,
 5. applies them to the initial states, x_n = P_n x0.

Every step of it is a batched torch.matmul, as the reference computes it
with XLA products outside any Pallas kernel; the same numbers as the step
loop, the products reassociated. Leading axes of the coefficient rows
(control candidates) ride along as batch axes.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .steppers import stage_gammas


def build_step_matrices_dense(stack, C, dt: float, timestepper: str,
                              linsolve_iters: int,
                              lindblad_superop: Optional[Callable] = None,
                              gen_diag=None, linsolver: str = "neumann"):
    """All per-step IMR operators S (..., ntime, N, N) from the coefficient
    rows C (..., ntime, nstages, K).

    stack: (K, N, N) complex operator stack (closed systems: generator
    M = -i sum_j c_j O_j). For open systems pass `lindblad_superop`
    (lindblad_superop_builder), which maps rows (..., K) to the
    (..., N^2, N^2) vectorized generators instead.

    linsolver='jacobi' (with gen_diag, the generator's elementwise diagonal
    flattened as the state is: (N,) or the column-major (N^2,)) runs the
    matrix form of steppers.jacobi_neumann_solve,
    K <- (I - aD)^{-1} (M + a (M K - D K)), the inverse and D K as row
    scalings; otherwise the Neumann recursion K <- M + a M K, a = h / 2.
    'EE' takes S = I + dt M."""
    gammas = stage_gammas(timestepper)
    *lead, ntime, nstages, K = C.shape
    explicit = timestepper.upper() == "EE"
    Cf = C.reshape(tuple(lead) + (ntime * nstages, K))
    if lindblad_superop is None:
        M = -1j * torch.tensordot(Cf.to(stack.dtype), stack, dims=1)
    else:
        M = lindblad_superop(Cf)
    N = M.shape[-1]
    eye = torch.eye(N, dtype=M.dtype, device=M.device)
    use_jacobi = linsolver == "jacobi" and gen_diag is not None
    if use_jacobi:
        dcol = torch.as_tensor(gen_diag, device=M.device).reshape(-1).to(
            M.dtype)[:, None]                 # scales the rows of (N, N)

    Ms = M.reshape(tuple(lead) + (ntime, nstages, N, N))
    S_total = None
    for i, g in enumerate(gammas):
        h = float(g) * float(dt)
        Mi = Ms[..., i, :, :]
        if explicit:
            Si = eye + h * Mi
        else:
            half = h / 2.0
            if use_jacobi:
                minv = 1.0 / (1.0 - half * dcol)
                Km = minv * Mi
                for _ in range(linsolve_iters):
                    Km = minv * (Mi + half * (Mi @ Km - dcol * Km))
            else:
                Km = Mi
                for _ in range(linsolve_iters):
                    Km = Mi + half * (Mi @ Km)
            Si = eye + h * Km
        S_total = Si if S_total is None else Si @ S_total
    return S_total


def prefix_propagators(S):
    """P (..., T, N, N) with P_n = S_n @ ... @ S_1, over the axis -3.

    jax.lax.associative_scan's recursion (jax/_src/lax/control_flow/
    loops.py, its inner _scan) with combine(a, b) = b @ a: combine the
    adjacent pairs, scan the half by recursion (the odd positions), fill in
    the even positions from it, interleave. The reference's products in
    the reference's order: about 2 T products in 2 log2(T) rounds, and
    autograd keeps the operands of those products only."""
    T = S.shape[-3]
    if T < 2:
        return S
    odd = prefix_propagators(S[..., 1::2, :, :] @ S[..., 0:T - 1:2, :, :])
    rest = S[..., 2::2, :, :]
    even = torch.cat([S[..., :1, :, :],
                      rest @ (odd[..., :-1, :, :] if T % 2 == 0 else odd)],
                     dim=-3)
    n = odd.shape[-3]
    out = torch.stack([even[..., :n, :, :], odd], dim=-3).reshape(
        S.shape[:-3] + (2 * n,) + S.shape[-2:])
    return out if T == 2 * n else torch.cat([out, even[..., n:, :, :]],
                                            dim=-3)


def propagate_states(P, x0):
    """States after every step, x_n = P_n x0: P (..., T, N, N) and x0
    (B, N) give (..., T, B, N). Density matrices go in column-major
    vectorized by the caller."""
    return (P @ x0.transpose(-1, -2)).transpose(-1, -2)


def lindblad_superop_builder(stack, Ls):
    """A function mapping coefficient rows (..., K) to the vectorized
    Lindblad generators (..., N^2, N^2) on column-major vec(rho)
    (user_guide.md:283-302):

        L(c) = I (x) (-i Heff) - (-i Heff^dag)^T (x) I + sum_l conj(L_l) (x) L_l

    with Heff = sum_j c_j O_j, the -i/2 sum L^dag L already folded into the
    constant slot of `stack` (ops/rhs.py DenseEngine). stack (K, N, N) and
    Ls (nL, N, N) or None are device tensors; the per-term stacks
    I (x) O_j and conj(O_j) (x) I and the jump part (summed once) are built
    on their device. For small N only: each is (K, N^2, N^2)."""
    N = stack.shape[-1]
    eye = torch.eye(N, dtype=stack.dtype, device=stack.device)
    jump = torch.zeros((N * N, N * N), dtype=stack.dtype, device=stack.device)
    for L in (() if Ls is None else Ls):
        jump = jump + torch.kron(L.conj(), L)
    left = torch.stack([torch.kron(eye, O) for O in stack])
    right_c = torch.stack([torch.kron(O.conj(), eye) for O in stack])

    def build(Cf):
        A = torch.tensordot(Cf.to(left.dtype), left, dims=1)
        Bm = torch.tensordot(Cf.to(right_c.dtype), right_c, dims=1)
        return -1j * A + 1j * Bm + jump

    return build
