"""Hessian tools: the AD Hessian, its finite-difference check and its
eigen-analysis.

The port of quandary_tpu/optim/hessian.py, the counterparts of the
reference's developer harnesses TEST_FD_HESS (main.cpp:545-658: an FD
Hessian and its symmetry) and HESSIAN_DECOMPOSITION (main.cpp:660-719:
the Hessian's eigen-analysis).

`hessian` differentiates the objective twice by autograd, which runs where
every node of the gradient has a double backward: the time-parallel scan
and the plain route's stored adjoint. The fused route's kernels and the
reversible and grouped adjoints are autograd.Functions with a hand-written
first backward only (the JAX package's jax.hessian cannot pass its
custom_vjps either), so there it raises NotImplementedError naming the
route; so it does on a problem sharded over the 'init' axis, whose pair of
collectives (parallel/mesh.py) has a first backward only. `fd_hessian`
takes central differences of build_value_and_grad's gradient and runs on
every route, the kernels included.
"""

from __future__ import annotations

import numpy as np
import torch


def hessian(problem, params, params_ref=None):
    """The exact (AD) Hessian of the full objective at `params`, an
    (nparams, nparams) numpy array in the problem's real dtype. Raises
    NotImplementedError naming the route where autograd cannot
    differentiate the gradient again; fd_hessian runs there."""
    why = None
    if problem.use_fused:
        why = (f"the fused route ({problem.fused_form!r} on "
               f"fused_mode={problem.setup.fused_mode!r}): its kernels' "
               "autograd.Functions have no double backward")
    elif problem.adjoint_route != "stored":
        why = (f"the {problem.adjoint_route!r} adjoint: its "
               "autograd.Function has no double backward")
    elif problem.mesh is not None:
        why = ("a problem sharded over the 'init' axis: its collectives "
               "(parallel/mesh.py copy_to / reduce_from) have no double "
               "backward (ROADMAP C4 item 16)")
    if why is not None:
        raise NotImplementedError(f"hessian: {why}; fd_hessian runs on "
                                  "every route")
    p = problem._param_tensor(params)
    ref = problem._param_tensor(params if params_ref is None
                                else params_ref)
    H = torch.autograd.functional.hessian(
        lambda x: problem.objective(x, ref)[0], p)
    return H.cpu().numpy()


def fd_hessian(problem, params, params_ref=None, eps: float = 1e-5):
    """The central-difference Hessian of build_value_and_grad's gradient
    (main.cpp:545-658), column i from the gradients at params +- eps e_i;
    (nparams, nparams) float64 numpy."""
    params = np.asarray(params, dtype=float)
    ref = params if params_ref is None else np.asarray(params_ref)
    vg = problem.build_value_and_grad()

    def grad(p):
        return vg(p, ref)[1].double().cpu().numpy()

    n = params.size
    H = np.zeros((n, n))
    for i in range(n):
        e = np.zeros(n)
        e[i] = eps
        H[:, i] = (grad(params + e) - grad(params - e)) / (2 * eps)
    return H


def hessian_eigen(problem, params, params_ref=None):
    """The eigen-decomposition of the symmetrized AD Hessian, the
    curvature spectrum of the control landscape (HESSIAN_DECOMPOSITION):
    (eigenvalues ascending, eigenvectors)."""
    H = hessian(problem, params, params_ref)
    return np.linalg.eigh(0.5 * (H + H.T))
