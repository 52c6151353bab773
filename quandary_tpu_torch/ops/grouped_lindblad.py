"""Grouped (matricized) RHS engine for large-N Lindblad systems.

Counterpart of quandary_tpu/ops/grouped_lindblad.py: the oscillators split
into Left / Right groups of dims m1 x m2 as in ops/grouped_rhs.py, and the
density matrix is viewed as the rank-4 tensor rho[..., b, r1, r2, c1, c2].
Every commutator term is a group GEMM (contraction rank m ~ sqrt(N)), the
decay jump a rho a^dag a group GEMM on each side, and every other
dissipator term a broadcast elementwise mask. Same coefficient layout and
conventions as TensorEngine; the two agree to rounding.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.operators import embed, lowering
from .grouped_rhs import GroupedEngine, embed_device
from .tensor_rhs import StructuredModel, coeff, gen_diag_structured

# contractions of a (m, m) operator with one axis of (..., B, m1, m2, m1, m2)
_ROW_L = "...ip,...bpqlm->...biqlm"      # M on r1 from the left
_ROW_R = "...jq,...bpqlm->...bpjlm"      # M on r2 from the left
_COL_L = "...pl,...bijpq->...bijlq"      # M on c1 from the right
_COL_R = "...qm,...bijlq->...bijlm"      # M on c2 from the right


class GroupedLindbladEngine:
    """rhs(c, x) with x (..., B, N, N) density matrices; Lindblad only."""

    def __init__(self, model: StructuredModel, dtype, device):
        if not model.lindblad:
            raise ValueError("GroupedLindbladEngine is Lindblad-only")
        # the grouping of H is the closed engine's: its stacks, cross-Kerr
        # mask and cross-JC ladders; only the dissipators are new
        closed = dataclasses.replace(
            model, gamma_decay=(0.0,) * model.n_osc,
            gamma_dephase=(0.0,) * model.n_osc, lindblad=False)
        h = GroupedEngine(closed, dtype, device)
        self.model = model
        self.dtype = dtype
        self.device = h.device
        self.lindblad = True
        self.N = model.N
        s = self.split = h.split
        self.m1, self.m2, self.K = h.m1, h.m2, model.K
        cplx = lambda r, i: torch.complex(r, i).to(dtype)
        self.stackL = cplx(h.SLr, h.SLi)
        self.stackR = cplx(h.SRr, h.SRi)
        self.cross_diag = None if h.cross_diag is None \
            else h.cross_diag.to(dtype)
        self.crossA = None if h.crossA is None else h.crossA.to(dtype)
        self.crossB = None if h.crossB is None else h.crossB.to(dtype)
        self.cross_idx, self.cross_J = h.cross_idx, h.cross_J

        dims = model.dims
        dimsL, dimsR = dims[:s], dims[s:]
        rdt = np.float32 if dtype == torch.complex64 else np.float64
        # decay jumps g1 a rho a^dag: group-embedded lowering operators,
        # built on the device; (side, operator, g1)
        self._jumps = []
        for k in range(model.n_osc):
            g1 = model.gamma_decay[k]
            if g1 > 0.0:
                side, ax, dg = ("L", k, dimsL) if k < s \
                    else ("R", k - s, dimsR)
                a = embed_device(lowering(dims[k]), ax, dg, self.device)
                self._jumps.append((side, a.to(dtype), g1))
        # group-embedded level vectors of the elementwise dissipator parts;
        # (side, vector, g1, g2)
        self._levels = []
        for k in range(model.n_osc):
            g1, g2 = model.gamma_decay[k], model.gamma_dephase[k]
            if g1 <= 0.0 and g2 <= 0.0:
                continue
            side, ax, dg = ("L", k, dimsL) if k < s else ("R", k - s, dimsR)
            lv = np.diag(embed(np.diag(np.arange(dims[k], dtype=float)),
                               ax, dg)).astype(rdt)
            self._levels.append(
                (side, torch.as_tensor(lv, device=self.device), g1, g2))

    def gen_diag(self):
        """Elementwise generator diagonal, (N, N) numpy: the TensorEngine's
        (drift commutator diagonal and every elementwise dissipator part)."""
        return gen_diag_structured(self.model, self.dtype)

    def _commutator_side(self, c, X, row: bool):
        """H rho (row=True) or rho H (row=False) on the rank-5 view."""
        cc = c.to(self.dtype)
        HL = torch.tensordot(cc, self.stackL, dims=1)
        HR = torch.tensordot(cc, self.stackR, dims=1)
        ein = torch.einsum
        if row:
            Y = ein(_ROW_L, HL, X) + ein(_ROW_R, HR, X)
        else:
            Y = ein(_COL_L, HL, X) + ein(_COL_R, HR, X)
        if self.cross_diag is not None:
            D = self.cross_diag
            Y = Y + X * (D[:, :, None, None] if row else D)
        Q, n_jc = self.model.n_osc, self.model.n_jc
        for i, j in enumerate(self.cross_idx):
            J = self.cross_J[i]
            A, Bm = self.crossA[i], self.crossB[i]
            z = (J * (coeff(c, 1 + 2 * Q + j, X)
                      + 1j * coeff(c, 1 + 2 * Q + n_jc + j, X))).to(self.dtype)
            if row:
                # (z A (x) B + conj(z) A^T (x) B^T) rho on the row indices
                t1 = ein(_ROW_R, Bm, ein(_ROW_L, A, X))
                t2 = ein(_ROW_R, Bm.T, ein(_ROW_L, A.T, X))
            else:
                # rho (z A (x) B + conj(z) A^T (x) B^T) on the col indices
                t1 = ein(_COL_R, Bm, ein(_COL_L, A, X))
                t2 = ein(_COL_R, Bm.T, ein(_COL_L, A.T, X))
            Y = Y + z * t1 + torch.conj(z) * t2
        return Y

    def rhs(self, c, x):
        m1, m2 = self.m1, self.m2
        X = x.reshape(x.shape[:-2] + (m1, m2, m1, m2))
        # -i (H rho - rho H)
        Y = -1j * (self._commutator_side(c, X, row=True)
                   - self._commutator_side(c, X, row=False))
        # elementwise dissipator parts
        for side, lv, g1, g2 in self._levels:
            if side == "L":
                nr, nc = lv[:, None, None, None], lv[:, None]
            else:
                nr, nc = lv[:, None, None], lv
            if g1 > 0.0:
                Y = Y - (g1 / 2.0) * X * (nr + nc).to(self.dtype)
            if g2 > 0.0:
                Y = Y + g2 * X * (nr * nc - 0.5 * nr * nr
                                  - 0.5 * nc * nc).to(self.dtype)
        # decay jumps g1 a rho a^dag (a group GEMM on each side's axis pair)
        ein = torch.einsum
        for side, a, g1 in self._jumps:
            if side == "L":
                Z = ein(_COL_L, a.T, ein(_ROW_L, a, X))
            else:
                Z = ein(_COL_R, a.T, ein(_ROW_R, a, X))
            Y = Y + g1 * Z
        return Y.reshape(x.shape)
