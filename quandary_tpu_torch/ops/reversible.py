"""Reversible (O(1)-memory) discrete adjoint for closed systems.

Counterpart of quandary_tpu/ops/reversible.py. The IMR update is
time-symmetric: the same scheme at -dt on the same midpoint coefficients
inverts a step (to stage-solve tolerance), as the reference recomputes
primal states backward in its Schroedinger adjoint (timestepper.cpp:229-231).
As a torch.autograd.Function:

* forward: the steps in a loop, keeping only the final state and the
  per-step penalties summed at the post-step states;
* backward: one reverse loop that reconstructs x_{n-1} = step_bwd(x_n),
  takes that one step's vector-Jacobian product (torch.autograd.grad of the
  step and its penalty) for the state, the coefficient row and the penalty
  cotangents, and moves on. No graph of the horizon is kept.

For norm-preserving (Schroedinger) dynamics; Lindblad dynamics are not
stably reversible and keep the stored-state adjoint.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def make_reversible_propagate(step_fwd: Callable, step_bwd: Callable,
                              penalty_fn: Optional[Callable] = None):
    """propagate(x0, C, extras) -> (xT, *pen_sums) with the reversible
    backward.

    step_fwd(x, c) / step_bwd(x, c): one step and its inverse, c = C[n].
    x: one tensor or a tuple of tensors (real planes).
    C: (ntime, ...) per-step coefficient rows.
    extras: tuple of (ntime, ...) per-step tensors handed to penalty_fn.
    penalty_fn(x, extra) -> tuple of penalty tensors at a post-step state
        (summed over the steps), with extra = tuple(e[n] for e in extras).
    The result is xT (the same structure as x0) followed by the sums; C
    is differentiated, x0 and the extras are constants."""
    return lambda x0, C, extras=(): _Reversible.apply(
        step_fwd, step_bwd, penalty_fn, _tuple(x0), C, tuple(extras))


def _tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _pens(penalty_fn, x, extras: Sequence[torch.Tensor], n: int):
    if penalty_fn is None:
        return ()
    return tuple(penalty_fn(x, tuple(e[n] for e in extras)))


class _Reversible(torch.autograd.Function):

    @staticmethod
    def forward(ctx, step_fwd, step_bwd, penalty_fn, x0: Tuple, C, extras):
        single = len(x0) == 1
        x = x0[0] if single else x0
        sums = None
        for n in range(C.shape[0]):
            x = step_fwd(x, C[n])
            p = _pens(penalty_fn, x, extras, n)
            sums = p if sums is None else tuple(a + b for a, b in
                                                zip(sums, p))
        xT = _tuple(x)
        ctx.fns = (step_fwd, step_bwd, penalty_fn, single, len(xT))
        ctx.extras = extras
        ctx.save_for_backward(C, *xT)
        return (*xT, *(sums or ()))

    @staticmethod
    def backward(ctx, *cots):
        step_fwd, step_bwd, penalty_fn, single, nx = ctx.fns
        C, *xT = ctx.saved_tensors
        extras = ctx.extras
        xbar = [torch.zeros_like(x) if g is None else g
                for x, g in zip(xT, cots[:nx])]
        pen_bar = cots[nx:]
        x = xT[0] if single else tuple(xT)
        C_bar = torch.zeros_like(C) if ctx.needs_input_grad[4] else None
        for n in reversed(range(C.shape[0])):
            with torch.no_grad():
                x_prev = step_bwd(x, C[n])
            with torch.enable_grad():
                xp = tuple(t.detach().requires_grad_(True)
                           for t in _tuple(x_prev))
                cc = C[n].detach().requires_grad_(C_bar is not None)
                xn = _tuple(step_fwd(xp[0] if single else xp, cc))
                outs, grads = list(xn), list(xbar)
                p = _pens(penalty_fn, xn[0] if single else xn, extras, n)
                for t, g in zip(p, pen_bar):
                    if g is not None and t.requires_grad:
                        outs.append(t)
                        grads.append(g)
                ins = xp + ((cc,) if C_bar is not None else ())
                got = torch.autograd.grad(outs, ins, grads, allow_unused=True)
            xbar = [torch.zeros_like(t) if g is None else g
                    for t, g in zip(xp, got[:nx])]
            if C_bar is not None and got[nx] is not None:
                C_bar[n] = got[nx]
            x = tuple(t.detach() for t in xp)
            x = x[0] if single else x
        return None, None, None, None, C_bar, None
