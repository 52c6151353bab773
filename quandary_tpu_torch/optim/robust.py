"""Robust (ensemble) optimal control: one pulse, many system realizations.

Optimizes the weighted average objective over an ensemble of Hamiltonian
samples (parameter uncertainty in detunings, Kerr coefficients, coupling
strengths, ...):

    J_robust(alpha) = sum_s w_s J_s(alpha)

Each sample is a full Problem (its own operator stack); torch autograd
delivers the exact ensemble gradient. build_robust_objective propagates the
samples one after the other (one streamK launch per sample and direction);
build_packed_robust_objective propagates ALL of them in one launch per
direction, each thread block reading its own sample's operator stack and
solver rows (ops/streamk.make_streamk_packed_propagate with
per_block_stacks). Counterpart of quandary_tpu/optim/robust.py.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import streamk


def _weights(S: int, weights) -> np.ndarray:
    w = np.asarray(weights if weights is not None else np.full(S, 1.0 / S),
                   dtype=float)
    return w / w.sum()


def _weighted(per_sample, w, like):
    """(J_total, aux) from the samples' (J, aux) pairs: weighted terms, the
    worst-case, mean and per-sample fidelities."""
    J_total = 0.0
    terms = None
    for (J, aux), ws in zip(per_sample, w):
        J_total = J_total + ws * J
        if terms is None:
            terms = {k: ws * v for k, v in aux.items() if k != "fidelity"}
        else:
            for k in terms:
                terms[k] = terms[k] + ws * aux[k]
    fids = torch.stack([aux["fidelity"] for _, aux in per_sample])
    aux_out = dict(terms)
    aux_out["fidelity"] = torch.min(fids)                   # worst case
    aux_out["fidelity_mean"] = torch.sum(
        fids * torch.as_tensor(w, dtype=like.dtype, device=like.device))
    aux_out["fidelity_per_sample"] = fids
    return J_total, aux_out


def build_robust_objective(problems: Sequence,
                           weights: Optional[Sequence[float]] = None):
    """objective(params, params_ref) -> (J_robust, aux) averaging over the
    sample Problems, differentiable in params. aux carries per-sample
    fidelities and the weighted penalty/cost terms."""
    w = _weights(len(problems), weights)

    def objective(params, params_ref):
        return _weighted([p.objective(params, params_ref) for p in problems],
                         w, params)

    return objective


def build_robust_value_and_grad(problems, weights=None):
    """fn(params, params_ref) -> ((J_robust, aux), grad)."""
    objective = build_robust_objective(problems, weights)
    p0 = problems[0]

    def vg(params, params_ref):
        x = p0._param_tensor(params).requires_grad_(True)
        J, aux = objective(x, p0._param_tensor(params_ref))
        (g,) = torch.autograd.grad(J, x)
        return p0._detached(J, aux), g

    return vg


def sample_standard_models(base_kwargs: dict, param_samples: Sequence[dict],
                           setup_kwargs: dict, device=None):
    """Convenience: build one Problem per Hamiltonian sample.

    base_kwargs: arguments of build_standard_model common to all samples;
    param_samples: per-sample overrides (e.g. {'freq01_ghz': [...]});
    setup_kwargs: the common Setup fields (everything but `model`);
    device: the Problems' device (None: the CUDA device).
    """
    from ..models.hamiltonian import build_standard_model
    from ..problem import Problem, Setup

    problems = []
    for over in param_samples:
        kw = dict(base_kwargs)
        kw.update(over)
        model = build_standard_model(**kw)
        problems.append(Problem(Setup(model=model, **setup_kwargs),
                                device=device))
    return problems


def build_packed_robust_objective(problems: Sequence,
                                  weights: Optional[Sequence[float]] = None):
    """Packed variant of build_robust_objective: ALL system realizations
    propagate through ONE kernel launch per direction, one thread block per
    sample with its own operator stack. Requirements (validated): every
    Problem runs the fused streamK path (Setup.fused_mode 'streamk': the
    packed route is streamK's only) on the same device, same discretization
    and shape, identical initial conditions. The size limit is the kernels'
    own, one thread block per sample, which each such Problem on the card
    has already passed (Problem.fused_ok)."""
    S = len(problems)
    p0 = problems[0]
    s0 = p0.setup
    for p in problems:
        if p.lindblad:
            raise NotImplementedError(
                "the packed robust objective of open (Lindblad) systems is "
                "not ported to quandary_tpu_torch yet; "
                "build_robust_objective runs them sample by sample")
        if p.setup.fused_mode != "streamk":
            raise NotImplementedError(
                f"the packed robust objective runs the streamK kernels only, "
                f"not fused_mode={p.setup.fused_mode!r}; "
                f"build_robust_objective runs such samples one by one")
        if not p.use_fused:
            raise ValueError("packed robust objective needs the fused "
                             "streamK path on every sample Problem")
        if (p.N != p0.N or p.setup.ntime != s0.ntime or p.setup.dt != s0.dt
                or p.linsolver != p0.linsolver
                or p.setup.linsolve_iters != s0.linsolve_iters
                or p.model.K != p0.model.K or p.nstages != 1
                or p.device != p0.device or p.rdtype != p0.rdtype):
            raise ValueError("sample Problems must share shape, "
                             "discretization, device and dtype for packing")
        if not np.array_equal(p.x0, p0.x0):
            raise ValueError("sample Problems must share initial conditions")
    w = _weights(S, weights)
    Sr = torch.stack([p._Sr for p in problems])
    Si = torch.stack([p._Si for p in problems])
    prop = streamk.make_streamk_packed_propagate(
        s0.dt, s0.linsolve_iters,
        gen_diag=np.stack([np.asarray(p.gen_diag) for p in problems]),
        linsolver=p0.linsolver, group=S, per_block_stacks=True)

    def objective(params, params_ref):
        # the carrier phases depend on the sample's model: rows per sample
        Cg = torch.stack([p.coeff_rows_mid(params)[:, 0, :]
                          for p in problems], dim=1)        # (ntime, S, K)
        (xTr, xTi), (hr, hi) = prop(Sr, Si, (p0._x0r, p0._x0i), Cg)
        per_sample = []
        for g, p in enumerate(problems):
            pens = p._history_penalties_real(hr[:, g], hi[:, g])
            per_sample.append(p._assemble_objective_real(
                params, params_ref, xTr[g], xTi[g], *pens,
                p._energy_integral(params)))
        return _weighted(per_sample, w, params)

    return objective
