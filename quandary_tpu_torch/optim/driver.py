"""Optimization driver: bounds and the host L-BFGS-B loop over the problem's
gradient sweep — the counterpart of OptimProblem + TaoMonitor
(optimproblem.cpp). History files, checkpoints and the stage-truncation
warning of the JAX package's driver are not ported yet."""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..problem import Problem
from .lbfgsb import minimize_lbfgsb


def build_bounds(oscillators, bounds_ghz_per_osc) -> tuple:
    """Per-parameter box bounds from per-oscillator amplitude bounds [GHz]:
    bound = c_max / (sqrt(2) * N_f) * 2*pi per coefficient
    (optimproblem.cpp:138-163); spline_amplitude phase parameters are
    unbounded (1e10)."""
    lbs: List[float] = []
    ubs: List[float] = []
    for k, osc in enumerate(oscillators):
        nf = len(osc.carrier_freqs)
        vals = bounds_ghz_per_osc[k] if k < len(bounds_ghz_per_osc) else [1e4]
        if np.isscalar(vals):
            vals = [float(vals)]
        for iseg, seg in enumerate(osc.segments):
            v = vals[iseg] if iseg < len(vals) else vals[-1]
            b = float(v) / (np.sqrt(2.0) * nf) * 2.0 * np.pi
            npc = seg.nparams_per_carrier()
            for f in range(nf):
                for i in range(npc):
                    if seg.kind == "spline_amplitude" and i == npc - 1:
                        lbs.append(-1e10)
                        ubs.append(1e10)
                    else:
                        lbs.append(-b)
                        ubs.append(b)
    return np.asarray(lbs), np.asarray(ubs)


@dataclasses.dataclass
class OptimHistoryRow:
    """One row of optim_history.dat (output.cpp:36, 80-86)."""
    iter: int
    objective: float
    gnorm: float
    step: float
    fidelity: float
    cost: float
    tikhonov: float
    penalty: float
    penalty_dpdm: float
    penalty_energy: float
    penalty_variation: float


@dataclasses.dataclass
class OptimResult:
    params: np.ndarray
    objective: float
    infidelity: float
    history: List[OptimHistoryRow]
    reason: str
    niter: int


def run_optimization(
    problem: Problem,
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
    linesearch: str = "wolfe",
    datadir=None,
) -> OptimResult:
    """Bound-constrained L-BFGS over the problem's value_and_grad, with the
    reference's custom stopping tests (optimproblem.cpp:607-624). Only
    ``datadir=None`` is ported: no files are written."""
    if datadir is not None:
        raise NotImplementedError(
            "run_optimization: history files and checkpoints (datadir) are "
            "not ported to quandary_tpu_torch yet")
    vg = problem.build_value_and_grad()
    params_ref = np.asarray(params0, dtype=np.float64)

    def fun_and_grad(x):
        (f, aux), g = vg(x, params_ref)
        auxf = {k: float(v) for k, v in aux.items()}
        return float(f), g.detach().cpu().double().numpy(), auxf

    history: List[OptimHistoryRow] = []

    def callback(it, x, f, gnorm, step, aux):
        row = OptimHistoryRow(
            iter=it, objective=f, gnorm=gnorm, step=step,
            fidelity=aux["fidelity"], cost=aux["obj_cost"],
            tikhonov=aux["obj_regul"], penalty=aux["obj_penal"],
            penalty_dpdm=aux["obj_penal_dpdm"],
            penalty_energy=aux["obj_penal_energy"],
            penalty_variation=aux["obj_penal_variation"],
        )
        history.append(row)
        if verbose and it % monitor_freq == 0:
            print(f"{it}  Objective {f:.14e}  Fidelity {aux['fidelity']:.8f}"
                  f"  ||Pr(grad)|| {gnorm:.6e}")
        if 1.0 - aux["fidelity"] <= inftol:
            return "converged: small infidelity"
        if aux["obj_cost"] <= fatol:
            return "converged: small final time cost"
        return None

    res = minimize_lbfgsb(
        fun_and_grad, np.asarray(params0, dtype=np.float64), lb, ub,
        maxiter=maxiter, gatol=gatol, grtol=grtol, callback=callback,
        linesearch=linesearch)
    infid = 1.0 - history[-1].fidelity if history else 1.0
    return OptimResult(
        params=res.x, objective=res.f, infidelity=infid,
        history=history, reason=res.converged_reason, niter=res.niter,
    )
