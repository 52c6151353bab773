"""Physics sanity checks, the SANITY_CHECK build-flag analog
(util.cpp:430-565; per-step assertions timestepper.cpp:156-158).

Vectorized over whole trajectories instead of per step."""

from __future__ import annotations

import numpy as np


def is_unitary(V: np.ndarray, tol: float = 1e-10) -> bool:
    """util.cpp:699 isUnitary."""
    V = np.asarray(V)
    return bool(np.abs(V @ V.conj().T - np.eye(V.shape[0])).max() < tol)


def check_density_trajectory(traj, tol: float = 1e-8) -> dict:
    """Hermiticity / trace-1 / near-positivity of a density-matrix
    trajectory (..., N, N). Returns max violations."""
    traj = np.asarray(traj)
    herm = np.abs(traj - np.conj(np.swapaxes(traj, -1, -2))).max()
    tr = np.abs(np.trace(traj, axis1=-2, axis2=-1).real - 1.0).max()
    # smallest eigenvalue of the final state only (eigh over the full
    # trajectory can be expensive)
    w = np.linalg.eigvalsh(traj.reshape(-1, *traj.shape[-2:])[-1])
    return {
        "hermiticity": float(herm),
        "trace": float(tr),
        "min_eig_final": float(w.min()),
        "ok": bool(herm < tol and tr < tol and w.min() > -tol),
    }


def check_state_trajectory(traj, tol: float = 1e-8) -> dict:
    """Norm preservation of a Schroedinger trajectory (ntime+1, ..., N):
    |psi(t)|^2 must stay at its initial value (IMR is norm-preserving)."""
    traj = np.asarray(traj)
    norms = np.sum(np.abs(traj) ** 2, axis=-1)      # (ntime+1, ...)
    err = float(np.abs(norms - norms[0]).max())
    return {"norm_drift": err, "ok": bool(err < tol)}


def stage_truncation_estimate(problem, params) -> dict:
    """Runtime health check of the fixed-iteration IMR stage solve at THIS
    parameter point, the analog of the reference's GMRES residual warning
    (timestepper.cpp:612-614), which fires when the linear solve is no
    longer accurate. The stage solves use a FIXED iteration count, so
    instead of a residual the truncation error is bounded analytically:
    the Neumann recursion's relative error after `iters` iterations is
    ~u^(iters+1) with u = (dt/2) * ||M(t)||, and ||M(t)|| is bounded by
    sum_k max_t |c_k(t)| * ||O_k||_2. The jacobi/split solvers handle the
    stiff DIAGONAL exactly, so their contraction factor excludes the
    operators' diagonals. The setup-time guard (the problem's stiffness
    switch) covers the static drift; THIS check covers the
    control-amplitude-dependent part that only exists once parameters are
    known (e.g. an optimizer parked on an unphysically large amplitude
    bound).

    Returns {"supported": False} for models without a dense (K, N, N)
    stack, and otherwise a dict with u, per_step_error, horizon_error, ok.
    """
    stack = getattr(problem.model, "stack", None)
    if stack is None or getattr(stack, "ndim", 0) != 3:
        return {"supported": False}
    stack = np.asarray(stack)
    C = problem.coeff_rows_mid(problem._param_tensor(params))
    C = C.detach().cpu().numpy()                   # (ntime, nstages, K)
    cmax = np.abs(C).reshape(-1, C.shape[-1]).max(axis=0)
    if problem.linsolver in ("jacobi", "split"):
        # diagonal handled exactly (elementwise inverse / exact rotation):
        # only the off-diagonal remainder is iterated
        norms = np.array([np.linalg.norm(S - np.diag(np.diagonal(S)), 2)
                          for S in stack])
    else:
        norms = np.array([np.linalg.norm(S, 2) for S in stack])
    u = 0.5 * float(problem.setup.dt) * float(cmax @ norms)
    iters = int(problem.setup.linsolve_iters)
    per_step = float(min(u, 1e6)) ** (iters + 1) if u < 1.0 else float("inf")
    horizon = per_step * int(problem.setup.ntime)
    return {
        "supported": True,
        "solver": problem.linsolver,
        "u": u,
        "per_step_error": per_step,
        "horizon_error": horizon,
        "ok": bool(horizon < 1e-3),
    }
