"""Host-driven time stepping: one step at a time, the states on the host.

The port of quandary_tpu/ops/hostloop.py. The JAX package compiles one step
and drives the loop from the host, for problems whose whole time loop is
too large to compile; torch runs eagerly, so here the runner's point is
memory: the forward keeps one state on the device and, when asked, the
states of every step in host memory, and the gradient is the reference's
evolveBWD (timestepper.cpp:631-694), the transposed step applied backward
from those stored states as one-step vector-Jacobian products. Each step
is the problem's own step_fn, so the numbers are those of the plain loop.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


class HostLoopRunner:
    """Drives `problem.step_fn` (a quandary_tpu_torch.problem.Problem's)
    from the host, one step per call, on the problem's device."""

    def __init__(self, problem):
        self.problem = problem

    def forward(self, params, store_states: bool = False,
                callback: Optional[Callable] = None):
        """Propagate the batch of initial states: (xT, stored), xT on the
        device and stored the list of ntime + 1 states in host memory when
        `store_states` (else None). callback(n, x) is called after each
        step n (and with n = 0 before the first) with the device state, to
        stream observables without keeping the trajectory."""
        prob = self.problem
        with torch.no_grad():
            C = prob.coeff_rows_mid(prob._param_tensor(params))
            x = prob._x0c
            stored = [x.cpu()] if store_states else None
            if callback is not None:
                callback(0, x)
            for n in range(prob.setup.ntime):
                x = prob.step_fn(x, C[n])
                if store_states:
                    stored.append(x.cpu())
                if callback is not None:
                    callback(n + 1, x)
        return x, stored

    def gradient(self, params, loss_on_final: Callable):
        """(loss, gradient) of loss_on_final(xT, params), a real scalar, at
        `params`: a forward that stores every state in host memory, the
        loss's vector-Jacobian product at xT, a backward loop of one-step
        products (autograd of step_fn at each stored state, in x and in the
        step's coefficient rows), and the rows' cotangents chained through
        coeff_rows_mid. The gradient is a tensor on the problem's device;
        device memory stays O(1) in ntime but for the rows. Raises on a
        problem sharded over the 'init' axis: the loss sees this rank's
        share of the batch only (ROADMAP C4 item 16)."""
        prob = self.problem
        if prob.mesh is not None:
            raise NotImplementedError(
                "HostLoopRunner.gradient on a problem sharded over the "
                "'init' axis: loss_on_final would see one rank's share of "
                "the batch (ROADMAP C4 item 16)")
        dev = prob.device
        p = prob._param_tensor(params).requires_grad_(True)
        C = prob.coeff_rows_mid(p)
        Cd = C.detach()
        _, states = self.forward(p.detach(), store_states=True)

        xT = states[-1].to(dev).requires_grad_(True)
        loss = loss_on_final(xT, p)
        xbar, pbar = torch.autograd.grad(loss, (xT, p), allow_unused=True)

        Cbar = torch.zeros_like(Cd)
        for n in range(prob.setup.ntime - 1, -1, -1):
            x = states[n].to(dev).requires_grad_(True)
            c = Cd[n].clone().requires_grad_(True)
            with torch.enable_grad():
                y = prob.step_fn(x, c)
            xbar, Cbar[n] = torch.autograd.grad(y, (x, c), xbar)

        (g,) = torch.autograd.grad(C, p, Cbar)
        if pbar is not None:
            g = g + pbar
        return float(loss.detach()), g
