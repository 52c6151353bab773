"""Optimization driver: bounds, stopping criteria, history and durable
output around the host L-BFGS-B loop over the problem's gradient sweep, the
counterpart of OptimProblem + TaoMonitor (optimproblem.cpp)."""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import List, Optional

import numpy as np

from ..io import output as out_io
from ..problem import Problem
from ..utils.sanity import stage_truncation_estimate
from .lbfgsb import load_state, minimize_lbfgsb


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

    def as_tuple(self):
        return (self.iter, self.objective, self.gnorm, self.step,
                self.fidelity, self.cost, self.tikhonov, self.penalty,
                self.penalty_dpdm, self.penalty_energy, self.penalty_variation)


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
    datadir: Optional[str] = None,
    output_frequency: int = 1,
    resume: bool = False,
) -> OptimResult:
    """Bound-constrained L-BFGS over the problem's value_and_grad, with the
    reference's custom stopping tests (optimproblem.cpp:607-624).

    With `datadir`, the run is DURABLE: every `monitor_freq` iterations
    the history row is appended + flushed to optim_history.dat (the
    reference's writeOptimFile streaming semantics, output.cpp:80-86),
    params.dat + control<k>.dat are rewritten with the current iterate
    (a superset of the reference, which rewrites controls only at start
    and convergence, optimproblem.cpp:573,646), and the L-BFGS state
    (iterate + curvature memory) is checkpointed to optim_state.npz.
    `resume=True` restarts from that checkpoint after a crash/kill:
    iteration numbering continues and optim_history.dat is appended."""
    vg = problem.build_value_and_grad()
    params_ref = np.asarray(params0, dtype=np.float64)

    def fun_and_grad(x):
        (f, aux), g = vg(x, params_ref)
        auxf = {k: float(v) for k, v in aux.items()}
        return float(f), g.detach().cpu().double().numpy(), auxf

    checkpoint_path = None
    resume_state = None
    it0 = 0
    hist_writer = None
    if datadir is not None:
        os.makedirs(datadir, exist_ok=True)
        checkpoint_path = os.path.join(datadir, "optim_state.npz")
        if resume and os.path.exists(checkpoint_path):
            resume_state = load_state(checkpoint_path)
            it0 = resume_state["it"]
        hist_writer = out_io.OptimHistoryWriter(
            os.path.join(datadir, "optim_history.dat"),
            append=resume_state is not None)

    history: List[OptimHistoryRow] = []
    written_iters = set()

    def write_intermediate(row, x):
        hist_writer.write_row(row)
        written_iters.add(row.iter)
        out_io.write_params(os.path.join(datadir, "params.dat"), x)
        ts, p, q, flab = problem.controls_on_output_grid(x)
        out_io.write_controls(datadir, ts, p, q, flab, output_frequency)

    def callback(it, x, f, gnorm, step, aux):
        it = it + it0
        row = OptimHistoryRow(
            iter=it, objective=f, gnorm=gnorm, step=step,
            fidelity=aux["fidelity"], cost=aux["obj_cost"],
            tikhonov=aux["obj_regul"], penalty=aux["obj_penal"],
            penalty_dpdm=aux["obj_penal_dpdm"],
            penalty_energy=aux["obj_penal_energy"],
            penalty_variation=aux["obj_penal_variation"],
        )
        history.append(row)  # keep all rows; file writer decimates
        if verbose and it % monitor_freq == 0:
            print(f"{it}  Objective {f:.14e}  Fidelity {aux['fidelity']:.8f}"
                  f"  ||Pr(grad)|| {gnorm:.6e}")
        if (hist_writer is not None and it % monitor_freq == 0
                and not (resume_state is not None and it == it0)):
            # (the it == it0 row is the re-evaluation AT the restored
            # checkpoint: the run before the crash already streamed it)
            write_intermediate(row, x)
        # custom stopping tests (optimproblem.cpp:607-624)
        if 1.0 - aux["fidelity"] <= inftol:
            return "converged: small infidelity"
        if aux["obj_cost"] <= fatol:
            return "converged: small final time cost"
        return None

    try:
        res = minimize_lbfgsb(
            fun_and_grad, np.asarray(params0, dtype=np.float64), lb, ub,
            maxiter=maxiter, gatol=gatol, grtol=grtol, callback=callback,
            linesearch=linesearch,
            checkpoint_path=checkpoint_path,
            checkpoint_every=monitor_freq if checkpoint_path else 0,
            resume_state=resume_state,
            iter_offset=it0,
        )
        if hist_writer is not None and history \
                and history[-1].iter not in written_iters:
            # the final row always lands in the file (lastIter semantics,
            # optimproblem.cpp:632), even off the monitor stride
            write_intermediate(history[-1], res.x)
    finally:
        if hist_writer is not None:
            hist_writer.close()
    warn_if_truncated(problem, res.x)
    infid = 1.0 - history[-1].fidelity if history else 1.0
    return OptimResult(
        params=res.x, objective=res.f, infidelity=infid,
        history=history, reason=res.converged_reason, niter=res.niter,
    )


def warn_if_truncated(problem, params) -> None:
    """Stage-solve health at the FINAL point. The reference warns when its
    GMRES residual exceeds 1e-3 (timestepper.cpp:612-614); the stage solves
    here are fixed-iteration, so the analytic truncation bound is checked
    instead. The setup-time stiffness guard covers the static drift; this
    covers the control-amplitude part that only exists once parameters are
    known."""
    est = stage_truncation_estimate(problem, params)
    if est.get("supported") and not est["ok"]:
        warnings.warn(
            f"Stage solve under-resolved at the optimum: estimated "
            f"relative truncation {est['horizon_error']:.1e} over the "
            f"horizon (u={est['u']:.2f}, {problem.setup.linsolve_iters} "
            f"iterations, solver {est['solver']!r}). Results may be "
            "inaccurate at these control amplitudes: raise "
            "linsolve_iters, use linsolver='split', or tighten the "
            "control bounds.")
