"""Dense RHS engine: apply the time-dependent generator to a batch of states.

:class:`DenseEngine` assembles H(t) = sum_j c_j O_j as a dense (N, N) matrix
per evaluation and applies it to the whole state batch with batched
matmuls. States are complex: Schroedinger vectors (..., B, N), Lindblad
density matrices (..., B, N, N); the coefficient rows may carry leading
candidate axes that broadcast against the state's.

Lindblad in matrix form:

    drho/dt = -i (Heff rho - rho Heff^dag) + sum_c L_c rho L_c^dag

with Heff = H(t) - (i/2) sum_c L_c^dag L_c. The constant -i/2 sum L^dag L
term is folded into the constant slot of the operator stack (coefficient 1).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.hamiltonian import HamiltonianModel


class DenseEngine:
    """Dense operator-stack engine.

    Parameters
    ----------
    model : HamiltonianModel
    dtype : torch complex dtype of the stack (complex128 for validation,
        complex64 for speed).
    device : torch device the stack lives on.
    """

    def __init__(self, model: HamiltonianModel, dtype, device):
        self.model = model
        self.dtype = dtype
        self.device = torch.device(device)
        self.lindblad = model.lindblad
        self.N = model.N
        npdt = np.complex64 if dtype == torch.complex64 else np.complex128
        stack = np.array(model.stack, dtype=np.complex128)
        has_jumps = self.lindblad and len(model.collapse_ops) > 0
        if has_jumps:
            G = np.zeros((model.N, model.N), dtype=np.complex128)
            for L in model.collapse_ops:
                G += L.conj().T @ L
            stack = stack.copy()
            stack[0] = stack[0] - 0.5j * G
        # host copy (numpy) for setup-time analysis; device copy for rhs
        self.stack_np = stack.astype(npdt)
        self.stack = torch.as_tensor(self.stack_np, device=self.device)
        self.Ls_np = np.stack(model.collapse_ops).astype(npdt) \
            if has_jumps else None
        self.Ls = None if self.Ls_np is None else torch.as_tensor(
            self.Ls_np, device=self.device)

    def gen_diag(self):
        """Elementwise diagonal of the generator (host numpy, state-shaped,
        no batch): Schroedinger -i h_i, (N,); Lindblad -i(h_i - conj(h_j))
        plus the diagonal jump contribution sum_c L_ii conj(L_jj) (nonzero
        for dephasing), (N, N). Used by the Jacobi-preconditioned solve and
        the split stepper."""
        h = np.diagonal(self.stack_np[0])
        if not self.lindblad:
            return (-1j * h).astype(self.stack_np.dtype)
        d = -1j * (h[:, None] - np.conj(h)[None, :])
        if self.Ls_np is not None:
            for L in self.Ls_np:
                dl = np.diagonal(L)
                d = d + dl[:, None] * np.conj(dl)[None, :]
        return d.astype(self.stack_np.dtype)

    def assemble(self, c):
        """H_eff(t) from the (..., K) coefficient row(s): (..., N, N)."""
        return torch.tensordot(c.to(self.dtype), self.stack, dims=1)

    def rhs(self, c, x):
        """Apply the generator to the state batch x: (..., B, N)
        [Schroedinger] or (..., B, N, N) [Lindblad]."""
        A = self.assemble(c)
        if not self.lindblad:
            # dpsi/dt = -i H psi
            return -1j * (x @ A.transpose(-1, -2))
        # drho/dt = -i(Heff rho - rho Heff^dag) + sum_c L rho L^dag
        A = A.unsqueeze(-3)                 # against the batch axis B
        out = -1j * (A @ x - x @ A.conj().transpose(-1, -2))
        if self.Ls is not None:
            Lh = self.Ls.conj().transpose(-1, -2)
            out = out + torch.sum(
                self.Ls @ x.unsqueeze(-3) @ Lh, dim=-3)
        return out


def state_population(x, lindblad: bool):
    """Real per-level population: |psi_i|^2 (Schroedinger) or Re(rho_ii)
    (Lindblad), the quantities used by the observables and penalties
    (oscillator.cpp:430-566, timestepper.cpp:272-295)."""
    if lindblad:
        return torch.diagonal(x, dim1=-2, dim2=-1).real
    return x.abs() ** 2
