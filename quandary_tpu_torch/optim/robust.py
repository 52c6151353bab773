"""Robust (ensemble) optimal control: one pulse, many system realizations.

Optimizes the weighted average objective over an ensemble of Hamiltonian
samples (parameter uncertainty in detunings, Kerr coefficients, coupling
strengths, ...):

    J_robust(alpha) = sum_s w_s J_s(alpha)

Each sample is a full Problem (its own operator stack); torch autograd
delivers the exact ensemble gradient. build_robust_objective propagates the
samples one after the other (one launch per sample and direction);
build_packed_robust_objective propagates ALL of them in one launch per
direction, each thread block (or, past one block, each thread-block
cluster) reading its own sample's operator stack and solver rows
(the per-block plan of ops/streamk.make_streamk_packed_propagate with
per_block_stacks); open samples run there on the superop form at dimension
N^2. Counterpart of
quandary_tpu/optim/robust.py.
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


def _superop_form(p):
    """A sample's states and stacks on the superop route, whatever route its
    own Problem took: the (K, N^2, N^2) pseudo-Hamiltonian stack pair
    H' = i L (streamk.lindblad_prime_stack) and the column-major vec(x0)
    pair (B, N^2), on the sample's device in its real dtype. A closed
    sample's own stack and x0."""
    if not p.lindblad or p._flat:
        return p._Sr, p._Si, p._x0r, p._x0i
    Hp = streamk.lindblad_prime_stack(p.engine.stack_np, p.engine.Ls_np)
    rt = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                   device=p.device).to(p.rdtype)
    vec = lambda x: x.transpose(-1, -2).reshape(p.ninit, -1).contiguous()
    return rt(Hp.real), rt(Hp.imag), vec(p._x0r), vec(p._x0i)


def _sample_layout(p, x):
    """Flat kernel states (..., B, N^2) in the sample Problem's own layout:
    (..., B, N, N) density matrices where its route is 'rho' (the inverse of
    the column-major vec), unchanged on the superop route and closed."""
    if not p.lindblad or p._flat:
        return x
    return x.reshape(x.shape[:-1] + (p.N, p.N)).transpose(-1, -2)


def _gen_diag(p):
    """A sample's generator diagonal in the flat layout of the kernels
    (column-major vec for open systems, quandary_tpu/optim/robust.py
    :122-127), or None."""
    if p.gen_diag is None:
        return None
    gd = np.asarray(p.gen_diag)
    return gd.T.reshape(-1) if p.lindblad else gd.reshape(-1)


def packed_refusal(problems) -> Optional[str]:
    """Why neither streamK kernel pair takes the samples in one packed
    launch per direction (a sentence naming the limit), or None: the
    one-block pair holds a sample's B*dim state entries and stacks, else
    the mid pair (csrc/streamk_mid.cu) takes them, each cluster reading its
    sample's stack; both refuse only past streamk.DEVICE_BUDGET_BYTES (the
    S samples' history, cotangents, stored iterates, stacks and scratch).
    dim is N for closed samples, N^2 for open ones."""
    p0, s0 = problems[0], problems[0].setup
    dim = p0.N * p0.N if p0.lindblad else p0.N
    Ke = p0.model.K + (p0.linsolver == "split")
    iters = s0.linsolve_iters
    why = streamk.route_refusal(p0.ninit, dim, Ke, iters, s0.ntime,
                                E=len(problems), store=iters <= 4,
                                per_block=True)
    if why is None:
        return None
    return (f"packed robust objective of {len(problems)} samples at "
            f"dimension {dim}: {why}; build_robust_objective runs them one "
            "by one")


def build_packed_robust_objective(problems: Sequence,
                                  weights: Optional[Sequence[float]] = None):
    """Packed variant of build_robust_objective: ALL system realizations
    propagate through ONE kernel launch per direction, each sample with its
    own operator stack and solver rows (one thread block per sample, or
    past one block a thread-block cluster per sample and chunk of states).
    Open (Lindblad) samples run on the superop form at dimension N^2, each
    with its own H' = i L stack, whichever route (superop or rho) its own
    Problem took; the objective tail then reads the states in that
    Problem's layout (quandary_tpu/optim/robust.py:81-165).

    Requirements (validated): every Problem runs a fused streamK route
    (Setup.fused_mode 'streamk': the packed route is streamK's only) on the
    same device, with the same discretization and shape, identical initial
    conditions, all open or all closed, all with a generator diagonal or
    none, all sharded over one mesh's 'init' axis or none (each rank then
    packs its share of the batch; coeff_rows_mid and the objective tail
    hold the collectives). The size limit is the kernels'
    (``packed_refusal``): the reference packs while S * dim <= 128 (one
    128-lane tile); the port takes whatever the one-block or the mid pair
    holds within streamk.DEVICE_BUDGET_BYTES, and raises ValueError naming
    the limit past that. The returned objective carries its launch's inputs
    (`.plan`, `.x0`, `.coeff_rows(params)`) for timing the kernels alone."""
    S = len(problems)
    p0 = problems[0]
    s0 = p0.setup
    for p in problems:
        if p.setup.fused_mode != "streamk":
            raise NotImplementedError(
                f"the packed robust objective runs the streamK kernels only, "
                f"not fused_mode={p.setup.fused_mode!r}; "
                f"build_robust_objective runs such samples one by one")
        if not p.use_fused:
            raise ValueError("packed robust objective needs the fused "
                             "streamK path on every sample Problem")
        if (p.N != p0.N or p.lindblad != p0.lindblad
                or p.setup.ntime != s0.ntime or p.setup.dt != s0.dt
                or p.linsolver != p0.linsolver
                or p.setup.linsolve_iters != s0.linsolve_iters
                or p.model.K != p0.model.K or p.nstages != 1
                or p.device != p0.device or p.rdtype != p0.rdtype):
            raise ValueError("sample Problems must share shape, "
                             "discretization, device and dtype for packing")
        if p.mesh is not p0.mesh:
            raise ValueError("sample Problems must be sharded over the same "
                             "mesh (parallel/mesh.py::shard_problem) or none")
        if not np.array_equal(p.x0, p0.x0):
            raise ValueError("sample Problems must share initial conditions")
        if (p.gen_diag is None) != (p0.gen_diag is None):
            raise ValueError(
                "sample Problems must agree on gen_diag presence: a mixed "
                "ensemble would run one sample with a zeroed drift diagonal "
                "under the jacobi/split solvers")
    why = packed_refusal(problems)
    if why is not None:
        raise ValueError(why)
    w = _weights(S, weights)
    forms = [_superop_form(p) for p in problems]
    x0r, x0i = forms[0][2:]
    gen_diag = None if p0.gen_diag is None else \
        np.stack([_gen_diag(p) for p in problems])
    # one system per candidate: (S, Ke, dim, dim) stacks, (S, nrows, dim)
    # solver rows (the packed plan of make_streamk_packed_propagate)
    plan = streamk.make_plan(torch.stack([f[0] for f in forms]),
                             torch.stack([f[1] for f in forms]), s0.dt,
                             s0.linsolve_iters, gen_diag, p0.linsolver)

    def coeff_rows(params):
        """(S, ntime, Ke) rows of the packed launch: the carrier phases
        depend on the sample's model, so each sample has its own."""
        return streamk.extend_coeffs(plan, torch.stack(
            [p.coeff_rows_mid(params)[:, 0, :] for p in problems]))

    def objective(params, params_ref):
        xTr, xTi, hr, hi = streamk.streamk_propagate(plan, x0r, x0i,
                                                     coeff_rows(params))
        per_sample = []
        for g, p in enumerate(problems):
            lay = lambda x: _sample_layout(p, x)
            pens = p._history_penalties_real(lay(hr[g]), lay(hi[g]))
            per_sample.append(p._assemble_objective_real(
                params, params_ref, lay(xTr[g]), lay(xTi[g]), *pens,
                p._energy_integral(params)))
        return _weighted(per_sample, w, params)

    # the launch's inputs, for timing its kernels alone
    objective.plan, objective.x0 = plan, (x0r, x0i)
    objective.coeff_rows = coeff_rows
    return objective
