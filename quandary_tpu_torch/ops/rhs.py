"""Dense RHS engine: apply the time-dependent generator to a batch of states.

:class:`DenseEngine` assembles H(t) = sum_j c_j O_j as a dense (N, N) matrix
per evaluation and applies it to the whole state batch with one batched
matmul. States are complex Schroedinger vectors (..., B, N); the
coefficient rows may carry leading candidate axes that broadcast against
the state's. Open systems (the matrix-form Lindblad generator) are not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.hamiltonian import HamiltonianModel


class DenseEngine:
    """Dense operator-stack engine for closed systems.

    Parameters
    ----------
    model : HamiltonianModel
    dtype : torch complex dtype of the stack (complex128 for validation,
        complex64 for speed).
    device : torch device the stack lives on.
    """

    def __init__(self, model: HamiltonianModel, dtype, device):
        if model.lindblad:
            raise NotImplementedError(
                "DenseEngine: the Lindblad (open-system) generator is not "
                "ported to quandary_tpu_torch yet")
        self.model = model
        self.dtype = dtype
        self.device = torch.device(device)
        self.N = model.N
        npdt = np.complex64 if dtype == torch.complex64 else np.complex128
        # host copy (numpy) for setup-time analysis; device copy for rhs
        self.stack_np = np.asarray(model.stack).astype(npdt)
        self.stack = torch.as_tensor(self.stack_np, device=self.device)

    def gen_diag(self):
        """Elementwise diagonal of the generator, -i h_i (host numpy, (N,)).
        Used by the Jacobi-preconditioned solve and the split stepper."""
        h = np.diagonal(self.stack_np[0])
        return (-1j * h).astype(self.stack_np.dtype)

    def assemble(self, c):
        """H(t) from the (..., K) coefficient row(s): (..., N, N)."""
        return torch.tensordot(c.to(self.dtype), self.stack, dims=1)

    def rhs(self, c, x):
        """dpsi/dt = -i H psi for the state batch x (..., B, N)."""
        A = self.assemble(c)
        return -1j * (x @ A.transpose(-1, -2))
