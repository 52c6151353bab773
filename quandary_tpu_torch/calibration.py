"""Hamiltonian calibration from trajectory data: the stack cotangents of the
stream route in user position. Counterpart of
examples/example_calibration.py of the JAX package, on
ops/stream.py::make_stream_propagate.

Model: a single transmon qudit (n levels) in the rotating frame with an
uncertain self-Kerr coefficient xi,

    H(t; xi) = -xi/2 (a^dag a)(a^dag a - 1) + p(t)(a + a^dag)/sqrt2
                                            + i q(t)(a - a^dag)/sqrt2.

"Measured" states are synthesized from the true xi* (every tenth state of
the history), and xi is recovered from a 7% miscalibrated guess by a secant
iteration on the gradient of the trajectory misfit (the loss is locally
quadratic in xi, so this is Newton with a difference Hessian). The gradient
reaches xi only through the operator stack, so it needs Sr-bar / Si-bar:
the stream kernels emit them; on the streamK route (ops/streamk.py) the
trajectory is not connected to the stacks at all, and asking for the
gradient raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import stream

XI_TRUE = 0.2198 * 2 * np.pi


def kerr_parts(n: int = 4):
    """Constant operator parts (kerr_op, re-drive, im-drive), complex
    (n, n); the coefficient layout is [xi (drift slot), p(t), q(t)]."""
    a = np.diag(np.sqrt(np.arange(1, n)), 1)
    num = a.conj().T @ a
    kerr = -0.5 * (num @ (num - np.eye(n)))
    re_drive = (a + a.conj().T) / np.sqrt(2.0)
    im_drive = 1j * (a - a.conj().T) / np.sqrt(2.0)
    return kerr, re_drive, im_drive


class KerrCalibration:
    """The example's calibration problem (n = 4 levels, 200 steps of
    dt = 0.05, Neumann with `iters` stage iterations, two initial states) on
    `device` (the CUDA device unless another is named), in float32."""

    def __init__(self, device=None, n: int = 4, ntime: int = 200,
                 dt: float = 0.05, iters: int = 6):
        self.device = torch.device("cuda" if device is None else device)
        kw = dict(dtype=torch.float32, device=self.device)
        parts = np.stack(kerr_parts(n))
        self._parts_r = torch.as_tensor(parts.real, **kw)
        self._parts_i = torch.as_tensor(parts.imag, **kw)
        ts = (np.arange(ntime) + 0.5) * dt
        pt = 0.02 * np.cos(0.8 * ts) + 0.01 * np.sin(2.3 * ts)
        qt = 0.015 * np.sin(1.1 * ts)
        self.C = torch.as_tensor(np.stack([np.ones(ntime), pt, qt], axis=1),
                                 **kw)
        x0 = np.zeros((2, n), np.complex64)
        x0[0, 0] = 1.0
        x0[1, :2] = [1 / np.sqrt(2), 1 / np.sqrt(2)]
        self.x0 = (torch.as_tensor(x0.real, **kw),
                   torch.as_tensor(x0.imag, **kw))
        self.propagate = stream.make_stream_propagate(dt, iters)
        with torch.no_grad():
            self.data = self.trajectory(torch.tensor(XI_TRUE, **kw))

    def stacks(self, xi):
        """(3, n, n) real and imaginary stack planes at the Kerr
        coefficient xi (a 0-dim tensor): slot 0 is xi * kerr_op."""
        scale = torch.stack([xi, xi.new_ones(()), xi.new_ones(())])
        return (scale[:, None, None] * self._parts_r,
                scale[:, None, None] * self._parts_i)

    def trajectory(self, xi, propagate=None):
        """Every tenth state of the history, (re, im) of (ntime/10, 2, n)."""
        Sr, Si = self.stacks(xi)
        _, (hr, hi) = (propagate or self.propagate)(Sr, Si, self.x0, self.C)
        return hr[::10], hi[::10]

    def loss(self, xi, propagate=None):
        hr, hi = self.trajectory(xi, propagate)
        return torch.sum((hr - self.data[0]) ** 2 + (hi - self.data[1]) ** 2)

    def grad(self, xi: float, propagate=None) -> float:
        """d loss / d xi at xi through `propagate` (the stream route by
        default)."""
        x = torch.tensor(xi, dtype=torch.float32, device=self.device,
                         requires_grad=True)
        (g,) = torch.autograd.grad(self.loss(x, propagate), x)
        return float(g)

    def run(self, miscalibration: float = 1.07, maxiter: int = 30):
        """The example's secant iteration from xi* x miscalibration: returns
        (recovered xi, relative error, iterations)."""
        xi_prev = XI_TRUE * miscalibration
        xi = xi_prev * 0.999
        g_prev = self.grad(xi_prev)
        it = 0
        for it in range(maxiter):
            gi = self.grad(xi)
            if abs(gi) < 1e-9 or gi == g_prev:
                break
            xi, xi_prev, g_prev = (xi - gi * (xi - xi_prev) / (gi - g_prev),
                                   xi, gi)
        return xi, abs(xi - XI_TRUE) / XI_TRUE, it + 1
