"""Tensor (matrix-free) RHS engine: per-axis contractions for large N.

Counterpart of quandary_tpu/ops/tensor_rhs.py. The state is a rank-Q (or
2Q for Lindblad) tensor and every Hamiltonian term is a small (n_k x n_k)
matrix contracted along one axis, so the cost is O(N * sum_k n_k) per RHS
application and no (N, N) operator is ever built. Diagonal terms
(detuning, Kerr, cross-Kerr, the diagonal Lindblad pieces) are broadcast
per-axis level vectors.

Coefficient layout matches the dense engine:
    c = [1, p_0..p_{Q-1}, q_0..q_{Q-1}, cos(eta t).., sin(eta t)..]

States carry leading candidate axes before the batch axis B, and the
coefficient rows the same leading axes before K: x (..., B, N) closed,
(..., B, N, N) open, c (..., K).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils.operators import coupling_pairs, drift_diagonal, lowering


@dataclasses.dataclass(frozen=True)
class StructuredModel:
    """Closed-form standard-model parameters (all rad/ns) for the
    structured engines: the structural counterpart of HamiltonianModel's
    dense stack (quandary_tpu/ops/tensor_rhs.py:38)."""
    dims: Tuple[int, ...]
    detune: Tuple[float, ...]
    selfkerr: Tuple[float, ...]
    crosskerr: Tuple[float, ...]        # per (k<l) pair, len Q(Q-1)/2
    jkl: Tuple[float, ...]              # per NONZERO jkl pair
    etas: Tuple[float, ...]             # per NONZERO jkl pair
    jc_pairs: Tuple[Tuple[int, int], ...]
    gamma_decay: Tuple[float, ...]      # 1/T1 per oscillator (0 = off)
    gamma_dephase: Tuple[float, ...]    # 1/T2 per oscillator
    lindblad: bool

    @property
    def n_osc(self) -> int:
        return len(self.dims)

    @property
    def N(self) -> int:
        return int(np.prod(self.dims, dtype=np.int64))

    @property
    def n_jc(self) -> int:
        return len(self.jc_pairs)

    @property
    def K(self) -> int:
        return 1 + 2 * self.n_osc + 2 * self.n_jc

    def jc_columns(self, ts) -> np.ndarray:
        """(nt, 2 n_jc) f64 columns [cos(eta t).., sin(eta t)..] of the JC
        phases on the host time grid ts."""
        phase = np.asarray(ts, dtype=np.float64)[:, None] \
            * np.asarray(self.etas, dtype=np.float64)[None, :]
        return np.concatenate([np.cos(phase), np.sin(phase)], axis=1)

    def coeff_rows(self, p, q, ts, jc=None):
        """The (..., nt, K) coefficient tensor from p, q (..., nt, Q), as
        HamiltonianModel.coeff_rows: the JC phase columns from the host
        grid ts in f64, or `jc`, already on the device."""
        cols = [torch.ones(p.shape[:-1] + (1,), dtype=p.dtype,
                           device=p.device), p, q]
        if self.n_jc > 0:
            col = torch.as_tensor(self.jc_columns(ts) if jc is None else jc,
                                  dtype=p.dtype, device=p.device)
            cols.append(col.expand(p.shape[:-1] + col.shape[-1:]))
        return torch.cat(cols, dim=-1)


def build_structured_model(
    *,
    nlevels: Sequence[int],
    freq01_ghz: Sequence[float],
    rotfreq_ghz: Sequence[float],
    selfkerr_ghz: Sequence[float],
    crosskerr_ghz: Sequence[float] = (),
    jkl_ghz: Sequence[float] = (),
    decay_time: Sequence[float] = (),
    dephase_time: Sequence[float] = (),
    lindblad: bool = False,
) -> StructuredModel:
    """The standard model (GHz and ns in, rad/ns out) in closed form, with
    the fields of quandary_tpu's build_structured_model in the same
    order."""
    dims = tuple(int(n) for n in nlevels)
    Q = len(dims)
    twopi = 2.0 * np.pi
    pairs = coupling_pairs(Q)
    ck = (list(crosskerr_ghz) + [0.0] * len(pairs))[: len(pairs)]
    jj = (list(jkl_ghz) + [0.0] * len(pairs))[: len(pairs)]
    rot = list(rotfreq_ghz)
    jc_pairs, etas, jvals = [], [], []
    for idkl, (k, l) in enumerate(pairs):
        if abs(jj[idkl]) > 1e-14:
            jc_pairs.append((k, l))
            jvals.append(twopi * jj[idkl])
            etas.append(twopi * (rot[k] - rot[l]))
    T1 = list(decay_time) + [0.0] * Q
    T2 = list(dephase_time) + [0.0] * Q
    g1 = tuple((1.0 / t if (lindblad and t > 1e-14) else 0.0) for t in T1[:Q])
    g2 = tuple((1.0 / t if (lindblad and t > 1e-14) else 0.0) for t in T2[:Q])
    return StructuredModel(
        dims=dims,
        detune=tuple(twopi * (f - r) for f, r in zip(freq01_ghz, rot)),
        selfkerr=tuple(twopi * x for x in selfkerr_ghz),
        crosskerr=tuple(twopi * x for x in ck),
        jkl=tuple(jvals),
        etas=tuple(etas),
        jc_pairs=tuple(jc_pairs),
        gamma_decay=g1,
        gamma_dephase=g2,
        lindblad=lindblad,
    )


def _lmul(M, x, axis):
    """Contract tensor axis `axis` with M from the left:
    out[..., i, ...] = sum_j M[i, j] x[..., j, ...]."""
    return (x.movedim(axis, -1) @ M.transpose(-1, -2)).movedim(-1, axis)


def _rmul(M, x, axis):
    """Right multiplication along a column axis:
    out[..., j, ...] = sum_l x[..., l, ...] M[l, j]."""
    return (x.movedim(axis, -1) @ M).movedim(-1, axis)


def bcast(v, x):
    """v, of x's leading (candidate) axes, shaped to broadcast against x."""
    return v.reshape(v.shape + (1,) * (x.ndim - v.ndim))


def coeff(c, j, x):
    """Column j of the coefficient rows c (..., K), shaped to broadcast
    against a state x whose leading axes are c's."""
    return bcast(c[..., j], x)


def gen_diag_structured(model: StructuredModel, dtype) -> np.ndarray:
    """Elementwise generator diagonal (host numpy, state-shaped): -i h,
    (N,), closed; (N, N) open, with every elementwise dissipator term (the
    dephasing jump n rho n included)."""
    ndt = np.complex64 if dtype == torch.complex64 else np.complex128
    m = model
    d = drift_diagonal(m.dims, m.detune, m.selfkerr, m.crosskerr)
    if not m.lindblad:
        return (-1j * d).astype(ndt)
    N = m.N
    out = (-1j * (d[:, None] - d[None, :])).astype(np.complex128)
    idx = np.arange(N)
    for k in range(m.n_osc):
        post = int(np.prod(m.dims[k + 1:])) if k + 1 < m.n_osc else 1
        nk = (idx // post) % m.dims[k]
        nr = nk[:, None].astype(float)
        nc = nk[None, :].astype(float)
        g1, g2 = m.gamma_decay[k], m.gamma_dephase[k]
        if g1 > 0:
            out = out - (g1 / 2.0) * (nr + nc)
        if g2 > 0:
            out = out + g2 * (nr * nc - 0.5 * nr * nr - 0.5 * nc * nc)
    return out.astype(ndt)


class TensorEngine:
    """rhs(c, x) with x (..., B, N) [Schroedinger] or (..., B, N, N)
    [Lindblad]; quandary_tpu/ops/tensor_rhs.py:139."""

    def __init__(self, model: StructuredModel, dtype, device):
        self.model = model
        self.dtype = dtype
        self.device = torch.device(device)
        self.lindblad = model.lindblad
        self.dims = model.dims
        self.N = model.N
        Q = self.Q = model.n_osc
        rdt = torch.float64 if dtype == torch.complex128 else torch.float32
        put = lambda a, dt: torch.as_tensor(a, device=self.device).to(dt)
        a = [lowering(d) for d in model.dims]
        self.a = [put(ak, dtype) for ak in a]
        self.apad = [put(ak + ak.T, dtype) for ak in a]         # a + a^dag
        self.amad = [put(ak - ak.T, dtype) for ak in a]         # a - a^dag
        self.levels = [put(np.arange(d), rdt) for d in model.dims]
        # H_diag = sum_k f_k(n_k) - sum_{k<l} xi_kl n_k n_l with
        # f_k(n) = detune_k n - xi_k/2 n (n - 1)
        self.fk = [model.detune[k] * self.levels[k]
                   - model.selfkerr[k] / 2.0 * self.levels[k]
                   * (self.levels[k] - 1.0) for k in range(Q)]
        self.ck_pairs = [(idx, kl) for idx, kl in enumerate(coupling_pairs(Q))
                         if idx < len(model.crosskerr)
                         and abs(model.crosskerr[idx]) > 1e-14]

    def gen_diag(self):
        """Elementwise generator diagonal (numpy, state-shaped)."""
        return gen_diag_structured(self.model, self.dtype)

    def _along(self, v, axis):
        """Vector v shaped to lie along (negative) tensor axis `axis`."""
        return v.reshape((-1,) + (1,) * (-axis - 1))

    def _hdiag_mul(self, x, first):
        """H_diag on the index group whose oscillator 0 is at (negative)
        axis `first`, as broadcast elementwise products."""
        y = torch.zeros_like(x)
        for k in range(self.Q):
            y = y + x * self._along(self.fk[k], first + k).to(x.dtype)
        for idx, (k, l) in self.ck_pairs:
            nk = self._along(self.levels[k], first + k)
            nl = self._along(self.levels[l], first + l)
            y = y - self.model.crosskerr[idx] * x * (nk * nl).to(x.dtype)
        return y

    def _apply_H(self, c, x, first, mul):
        """H(t) x with contractions via `mul` (_lmul rows / _rmul cols)."""
        Q, m = self.Q, self.model
        y = self._hdiag_mul(x, first)
        for k in range(Q):
            pk = coeff(c, 1 + k, x).to(self.dtype)
            qk = coeff(c, 1 + Q + k, x).to(self.dtype)
            y = y + pk * mul(self.apad[k], x, first + k)
            y = y + (1j * qk) * mul(self.amad[k], x, first + k)
        for j, (k, l) in enumerate(m.jc_pairs):
            z = m.jkl[j] * (coeff(c, 1 + 2 * Q + j, x)
                            + 1j * coeff(c, 1 + 2 * Q + m.n_jc + j, x))
            z = z.to(self.dtype)
            # z a_k^dag a_l + conj(z) a_k a_l^dag
            t1 = mul(self.a[k].T, mul(self.a[l], x, first + l), first + k)
            t2 = mul(self.a[k], mul(self.a[l].T, x, first + l), first + k)
            y = y + z * t1 + torch.conj(z) * t2
        return y

    def rhs(self, c, x):
        Q = self.Q
        if not self.lindblad:
            xt = x.reshape(x.shape[:-1] + self.dims)
            return (-1j * self._apply_H(c, xt, -Q, _lmul)).reshape(x.shape)
        xt = x.reshape(x.shape[:-2] + self.dims + self.dims)
        # -i (H rho - rho H)
        y = -1j * (self._apply_H(c, xt, -2 * Q, _lmul)
                   - self._apply_H(c, xt, -Q, _rmul))
        # dissipators (all diagonal except the decay jump a rho a^dag)
        for k in range(Q):
            g1 = self.model.gamma_decay[k]
            g2 = self.model.gamma_dephase[k]
            if g1 <= 0.0 and g2 <= 0.0:
                continue
            nr = self._along(self.levels[k], -2 * Q + k)
            nc = self._along(self.levels[k], -Q + k)
            if g1 > 0.0:
                y = y - (g1 / 2.0) * xt * (nr + nc).to(self.dtype)
                jump = _rmul(self.a[k].T, _lmul(self.a[k], xt, -2 * Q + k),
                             -Q + k)
                y = y + g1 * jump
            if g2 > 0.0:
                y = y + g2 * xt * (nr * nc - 0.5 * nr * nr
                                   - 0.5 * nc * nc).to(self.dtype)
        return y.reshape(x.shape)
