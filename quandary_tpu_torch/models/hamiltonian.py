"""Hamiltonian model: operator stacks for the time-dependent RHS.

The rotating-frame Hamiltonian (user_guide.md:62-81, complex form) is

    H(t) = Hd + sum_k [ p_k(t) (a_k + a_k^dag) + q_k(t) i (a_k - a_k^dag) ]
              + sum_{k<l} J_kl [ cos(eta_kl t) (a_k^dag a_l + a_k a_l^dag)
                               + sin(eta_kl t) i (a_k^dag a_l - a_k a_l^dag) ]

with eta_kl = w_k^rot - w_l^rot, i.e. the JC coupling is
J_kl (e^{i eta t} a_k^dag a_l + h.c.). Every term is a Hermitian operator with
a REAL scalar coefficient, so we represent H(t) as a stack of K constant
complex matrices O_j and per-time real coefficients c_j(t):

    H(t) = sum_j c_j(t) O_j,   c(t) = [1, p_1..p_Q, q_1..q_Q, cosJC.., sinJC..]

The coefficient rows for the whole time grid are assembled once per objective
evaluation (a few small matmuls through the control plan); per step the dense
engine contracts c_n with the stack (cheap) and applies H to the state batch
with one matmul. This replaces the reference's MatShell/sparse-AIJ design
(mastereq.cpp:192-655) and its matrix-free template kernels (1280-3240).

Open systems add the Lindblad dissipator in matrix form (NOT vectorized to
N^2 — density matrices stay (N, N) and the dissipator is applied with batched
matmuls; the open-system solvers are not ported yet):

    L(rho) = sum_j gamma_j ( L_j rho L_j^dag - 1/2 {L_j^dag L_j, rho} )
    L_{1k} = a_k / sqrt(T1_k),  L_{2k} = a_k^dag a_k / sqrt(T2_k)
(user_guide.md:47-59; gamma = 1/T as in mastereq.cpp:546-614).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.operators import coupling_pairs, embed, lowering, number


@dataclasses.dataclass(frozen=True)
class HamiltonianModel:
    """Static (host-side, numpy) description of the system dynamics.

    All frequencies in rad/ns. ``stack`` is the (K, N, N) complex operator
    stack; coefficient layout: [const, p_0..p_{Q-1}, q_0..q_{Q-1},
    cos(eta_0 t).., sin(eta_0 t)..] where only pairs with nonzero Jkl appear.
    """
    dims: Tuple[int, ...]             # nlevels per oscillator
    stack: np.ndarray                 # (K, N, N) complex128
    etas: np.ndarray                  # (n_jc,) rad/ns, rotation-freq differences
    n_osc: int
    # Lindblad collapse operators (may be empty -> closed system)
    collapse_ops: Tuple[np.ndarray, ...]      # each (N, N), scaled by sqrt(gamma)
    lindblad: bool

    @property
    def N(self) -> int:
        return int(np.prod(self.dims, dtype=np.int64))

    @property
    def K(self) -> int:
        return self.stack.shape[0]

    @property
    def n_jc(self) -> int:
        return len(self.etas)

    def jc_columns(self, ts) -> np.ndarray:
        """(nt, 2 n_jc) f64 columns [cos(eta t).., sin(eta t)..] of the JC
        phases on the host time grid ts."""
        phase = np.asarray(ts, dtype=np.float64)[:, None] \
            * np.asarray(self.etas, dtype=np.float64)[None, :]
        return np.concatenate([np.cos(phase), np.sin(phase)], axis=1)

    def coeff_rows(self, p, q, ts, jc=None):
        """Assemble the (..., nt, K) coefficient tensor from control tensors
        p, q of shape (..., nt, Q) and the host time grid ts (nt,) for the
        JC phases. The phases are computed in f64 on the host and cast to
        p's dtype and device, unless `jc` hands them over as a tensor
        (jc_columns of the same grid, already on the device); leading
        (candidate) axes broadcast."""
        cols = [torch.ones(p.shape[:-1] + (1,), dtype=p.dtype,
                           device=p.device), p, q]
        if self.n_jc > 0:
            col = torch.as_tensor(self.jc_columns(ts) if jc is None else jc,
                                  dtype=p.dtype, device=p.device)
            cols.append(col.expand(p.shape[:-1] + col.shape[-1:]))
        return torch.cat(cols, dim=-1)


def build_standard_model(
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
) -> HamiltonianModel:
    """Standard superconducting-qubit model (mastereq.cpp:285-501 semantics).

    Frequencies in GHz are converted to rad/ns (x 2*pi) exactly as in
    oscillator.cpp:15-21. decay/dephase times in ns; a time <= 0 disables the
    corresponding collapse operator for that oscillator while `lindblad`
    still selects the density-matrix solver (defs.hpp:27 LindbladType).
    """
    dims = tuple(int(n) for n in nlevels)
    Q = len(dims)
    N = int(np.prod(dims, dtype=np.int64))
    twopi = 2.0 * np.pi

    a_ops = [embed(lowering(dims[k]), k, dims) for k in range(Q)]
    n_ops = [embed(number(dims[k]), k, dims) for k in range(Q)]

    detune = twopi * (np.asarray(freq01_ghz, dtype=float) - np.asarray(rotfreq_ghz, dtype=float))
    xi = twopi * np.asarray(selfkerr_ghz, dtype=float)

    Hd = np.zeros((N, N), dtype=np.complex128)
    for k in range(Q):
        nk = n_ops[k]
        Hd += detune[k] * nk - xi[k] / 2.0 * (nk @ nk - nk)

    pairs = coupling_pairs(Q)
    ck = twopi * np.asarray(list(crosskerr_ghz) + [0.0] * len(pairs), dtype=float)[: len(pairs)]
    jj = twopi * np.asarray(list(jkl_ghz) + [0.0] * len(pairs), dtype=float)[: len(pairs)]
    for idkl, (k, l) in enumerate(pairs):
        if abs(ck[idkl]) > 1e-14:
            Hd -= ck[idkl] * (n_ops[k] @ n_ops[l])

    rot = twopi * np.asarray(rotfreq_ghz, dtype=float)
    ops = [Hd]
    for k in range(Q):                      # p_k coefficient
        ops.append((a_ops[k] + a_ops[k].T).astype(np.complex128))
    for k in range(Q):                      # q_k coefficient
        ops.append(1j * (a_ops[k] - a_ops[k].T))

    etas = []
    sym_ops = []
    asym_ops = []
    for idkl, (k, l) in enumerate(pairs):
        if abs(jj[idkl]) > 1e-14:
            akd_al = a_ops[k].T @ a_ops[l]
            ak_ald = a_ops[k] @ a_ops[l].T
            sym_ops.append(jj[idkl] * (akd_al + ak_ald).astype(np.complex128))
            asym_ops.append(jj[idkl] * 1j * (akd_al - ak_ald))
            etas.append(rot[k] - rot[l])
    ops.extend(sym_ops)
    ops.extend(asym_ops)

    collapse = []
    if lindblad:
        T1 = list(decay_time) + [0.0] * Q
        T2 = list(dephase_time) + [0.0] * Q
        for k in range(Q):
            if T1[k] > 1e-14:
                collapse.append((a_ops[k] / np.sqrt(T1[k])).astype(np.complex128))
            if T2[k] > 1e-14:
                collapse.append((n_ops[k] / np.sqrt(T2[k])).astype(np.complex128))

    return HamiltonianModel(
        dims=dims,
        stack=np.stack(ops, axis=0),
        etas=np.asarray(etas, dtype=float),
        n_osc=Q,
        collapse_ops=tuple(collapse),
        lindblad=lindblad,
    )


def build_file_model(
    *,
    nlevels: Sequence[int],
    Hsys_radns: np.ndarray,
    Hc_re: Sequence[Optional[np.ndarray]] = (),
    Hc_im: Sequence[Optional[np.ndarray]] = (),
    decay_time: Sequence[float] = (),
    dephase_time: Sequence[float] = (),
    lindblad: bool = False,
) -> HamiltonianModel:
    """User-specified Hamiltonian model (hamiltonianfilereader.cpp semantics;
    python side quandary.py:595-619): H(t) = Hsys + sum_k [p_k Hc_re_k
    + i q_k Hc_im_k]. Hsys in rad/ns, control operators unitless.
    """
    dims = tuple(int(n) for n in nlevels)
    Q = len(dims)
    N = int(np.prod(dims, dtype=np.int64))
    assert Hsys_radns.shape == (N, N)

    ops = [np.asarray(Hsys_radns, dtype=np.complex128)]
    for k in range(Q):
        M = Hc_re[k] if k < len(Hc_re) and Hc_re[k] is not None and np.size(Hc_re[k]) else np.zeros((N, N))
        ops.append(np.asarray(M, dtype=np.complex128))
    for k in range(Q):
        M = Hc_im[k] if k < len(Hc_im) and Hc_im[k] is not None and np.size(Hc_im[k]) else np.zeros((N, N))
        ops.append(1j * np.asarray(M, dtype=np.complex128))

    collapse = []
    if lindblad:
        a_ops = [embed(lowering(dims[k]), k, dims) for k in range(Q)]
        n_ops = [embed(number(dims[k]), k, dims) for k in range(Q)]
        T1 = list(decay_time) + [0.0] * Q
        T2 = list(dephase_time) + [0.0] * Q
        for k in range(Q):
            if T1[k] > 1e-14:
                collapse.append((a_ops[k] / np.sqrt(T1[k])).astype(np.complex128))
            if T2[k] > 1e-14:
                collapse.append((n_ops[k] / np.sqrt(T2[k])).astype(np.complex128))

    return HamiltonianModel(
        dims=dims,
        stack=np.stack(ops, axis=0),
        etas=np.zeros((0,)),
        n_osc=Q,
        collapse_ops=tuple(collapse),
        lindblad=lindblad,
    )
