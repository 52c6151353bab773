"""Grouped (matricized) RHS engine for large-N Schroedinger systems.

Counterpart of quandary_tpu/ops/grouped_rhs.py. The Q oscillators split
into a Left group (the first axes) and a Right group (the rest) of dims
m1 x m2 ~ sqrt(N); the state becomes an (m1, m2) matrix X and

    H x  <->  H_L(t) @ X + X @ H_R(t)^T + cross terms

where H_L, H_R carry every term acting within one group (detuning, Kerr,
within-group cross-Kerr and JC coupling, the controls of the group's
oscillators), contracted from (K, m, m) stacks with the (K,) coefficient
row. The cross-group cross-Kerr is an (m1, m2) elementwise mask, and each
cross-group JC pair a two-sided product A X B^T with group-embedded ladder
operators.

Everything runs in real (re, im) planes of shape (..., B, m1, m2), f32 or
f64, so every product is a real GEMM; the adjoint identities of
ops/grouped_adjoint.py rest on this formulation (in the real-plane inner
product M^T = -M for M = -iH). The stacks and the ladder operators are
built on the device from the single-mode factors with torch.kron (f64,
then cast), so nothing of size m^2 is built on the host. A stage's H_L,
H_R and cross-pair coefficients are assembled once (`assemble`) and
applied at every matvec of its solve (`apply_planes`): the coefficient
row is fixed across the solve, so this gives the same numbers as
contracting the stacks at every matvec.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.operators import coupling_pairs, embed, lowering, number
from .tensor_rhs import StructuredModel, bcast, gen_diag_structured


def _split_axes(dims) -> int:
    """Split index: the first `s` axes go Left, the rest Right, balancing
    the two groups' dimensions."""
    best, best_ratio = 1, float("inf")
    total = float(np.prod(dims))
    for s in range(1, len(dims)):
        m1 = float(np.prod(dims[:s]))
        ratio = max(m1 * m1 / total, total / (m1 * m1))
        if ratio < best_ratio:
            best, best_ratio = s, ratio
    return best


def embed_device(op: np.ndarray, axis: int, dims, device) -> torch.Tensor:
    """kron(I_before, op, I_after) in f64 on `device`, from the small
    (d, d) factor: the (m, m) result never exists on the host."""
    M = torch.as_tensor(np.asarray(op, np.float64), device=device)
    nb = int(np.prod(dims[:axis])) if axis > 0 else 1
    na = int(np.prod(dims[axis + 1:])) if axis + 1 < len(dims) else 1
    eye = lambda n: torch.eye(n, dtype=torch.float64, device=device)
    if nb > 1:
        M = torch.kron(eye(nb), M)
    if na > 1:
        M = torch.kron(M, eye(na))
    return M


def group_stack(model: StructuredModel, dims_g, offset: int, device):
    """(Sr, Si): the real and imaginary planes, f64 (K, m, m) on `device`,
    of the group-local operator stack with the global coefficient layout
    [1, p_0..p_{Q-1}, q.., cosJC.., sinJC..] (the reference's group_ops and
    its device twin, quandary_tpu/ops/grouped_rhs.py:83-117, :283-330)."""
    Q, K, Qg = model.n_osc, model.K, len(dims_g)
    m = int(np.prod(dims_g))
    Sr = torch.zeros((K, m, m), dtype=torch.float64, device=device)
    Si = torch.zeros_like(Sr)
    a_g = [embed_device(lowering(dims_g[k]), k, dims_g, device)
           for k in range(Qg)]
    n_g = [embed_device(number(dims_g[k]), k, dims_g, device)
           for k in range(Qg)]
    inside = lambda k: offset <= k < offset + Qg
    for k in range(Qg):
        gk, nk = offset + k, n_g[k]
        # constant slot: detuning + self-Kerr (+ within-group cross-Kerr)
        Sr[0] += model.detune[gk] * nk \
            - model.selfkerr[gk] / 2.0 * (nk @ nk - nk)
        Sr[1 + gk] += a_g[k] + a_g[k].T               # p: a + a^dag
        Si[1 + Q + gk] += a_g[k] - a_g[k].T           # q: i (a - a^dag)
    for idx, (k, l) in enumerate(coupling_pairs(Q)):
        if inside(k) and inside(l) and idx < len(model.crosskerr) \
                and abs(model.crosskerr[idx]) > 1e-14:
            Sr[0] -= model.crosskerr[idx] * (n_g[k - offset] @ n_g[l - offset])
    for j, (k, l) in enumerate(model.jc_pairs):
        if inside(k) and inside(l):
            akd_al = a_g[k - offset].T @ a_g[l - offset]
            ak_ald = a_g[k - offset] @ a_g[l - offset].T
            J = model.jkl[j]
            Sr[1 + 2 * Q + j] += J * (akd_al + ak_ald)
            Si[1 + 2 * Q + model.n_jc + j] += J * (akd_al - ak_ald)
    return Sr, Si


class Assembled(NamedTuple):
    """One stage's operators: H_L and H_R planes (..., m, m) and the
    cross-JC coefficients (zr, zi) per cross pair, each (...,)."""
    HLr: torch.Tensor
    HLi: torch.Tensor
    HRr: torch.Tensor
    HRi: torch.Tensor
    z: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


def _lm(M, V):
    """Left multiply (..., m1, m1) x (..., B, m1, m2)."""
    return (M if M.ndim == 2 else M.unsqueeze(-3)) @ V


def _rm(V, M):
    """Right multiply (..., B, m1, m2) x (..., m2, m2)."""
    return V @ (M if M.ndim == 2 else M.unsqueeze(-3))


class GroupedEngine:
    """rhs(c, x) with x (..., B, N) complex; Schroedinger only. The real
    core is apply_planes / apply_H_planes on (..., B, m1, m2) planes."""

    def __init__(self, model: StructuredModel, dtype, device):
        if model.lindblad:
            raise ValueError("GroupedEngine is Schroedinger-only "
                             "(GroupedLindbladEngine takes open systems)")
        self.model = model
        self.dtype = dtype
        self.device = torch.device(device)
        self.rdtype = torch.float64 if dtype == torch.complex128 \
            else torch.float32
        self.lindblad = False
        self.N = model.N
        dims = model.dims
        Q = len(dims)
        s = self.split = _split_axes(dims)
        dimsL, dimsR = dims[:s], dims[s:]
        self.m1, self.m2 = int(np.prod(dimsL)), int(np.prod(dimsR))
        self.K = model.K
        rd = self.rdtype
        self.SLr, self.SLi = (S.to(rd) for S in
                              group_stack(model, dimsL, 0, self.device))
        self.SRr, self.SRi = (S.to(rd) for S in
                              group_stack(model, dimsR, s, self.device))

        # cross-group cross-Kerr: the diagonal mask -sum xi_c nL_c (x) nR_c
        levelsL = [np.diag(embed(number(dimsL[k]), k, dimsL))
                   for k in range(len(dimsL))]
        levelsR = [np.diag(embed(number(dimsR[k]), k, dimsR))
                   for k in range(len(dimsR))]
        Dx = np.zeros((self.m1, self.m2))
        for idx, (k, l) in enumerate(coupling_pairs(Q)):
            if k < s <= l and idx < len(model.crosskerr) \
                    and abs(model.crosskerr[idx]) > 1e-14:
                Dx -= model.crosskerr[idx] * np.outer(levelsL[k],
                                                      levelsR[l - s])
        self.cross_diag = torch.as_tensor(Dx, device=self.device).to(rd) \
            if np.abs(Dx).max() > 0 else None

        # cross-group JC pairs: A = a_k^dag (Left), B = a_l (Right), real
        self.cross_idx, self.cross_J, As, Bs = [], [], [], []
        for j, (k, l) in enumerate(model.jc_pairs):
            if k < s <= l:
                As.append(embed_device(lowering(dims[k]), k, dimsL,
                                       self.device).T)
                Bs.append(embed_device(lowering(dims[l]), l - s, dimsR,
                                       self.device))
                self.cross_idx.append(j)
                self.cross_J.append(model.jkl[j])
        self.crossA = torch.stack(As).to(rd) if As else None
        self.crossB = torch.stack(Bs).to(rd) if Bs else None

    def gen_diag(self):
        """Elementwise generator diagonal -i h, flat (N,) numpy."""
        return gen_diag_structured(self.model, self.dtype)

    def assemble(self, c, drop_constant: bool = False) -> Assembled:
        """The stage's operators from the coefficient rows c (..., K).
        drop_constant zeroes slot 0 (V = M - D, make_V_apply)."""
        cr = c.to(self.rdtype)
        if drop_constant:
            cr = torch.cat([torch.zeros_like(cr[..., :1]), cr[..., 1:]], -1)
        con = lambda S: torch.tensordot(cr, S, dims=1)
        Q, n_jc = self.model.n_osc, self.model.n_jc
        z = tuple(((J * c[..., 1 + 2 * Q + j]).to(self.rdtype),
                   (J * c[..., 1 + 2 * Q + n_jc + j]).to(self.rdtype))
                  for j, J in zip(self.cross_idx, self.cross_J))
        return Assembled(con(self.SLr), con(self.SLi), con(self.SRr),
                         con(self.SRi), z)

    def apply_planes(self, A: Assembled, Xr, Xi,
                     include_cross_diag: bool = True):
        """H x in re/im planes: Xr, Xi (..., B, m1, m2) -> (Hx_r, Hx_i).
        include_cross_diag=False skips the cross-group cross-Kerr mask
        (the split stepper removes the whole drift diagonal)."""
        HRrT, HRiT = A.HRr.transpose(-1, -2), A.HRi.transpose(-1, -2)
        Yr = _lm(A.HLr, Xr) - _lm(A.HLi, Xi) + _rm(Xr, HRrT) - _rm(Xi, HRiT)
        Yi = _lm(A.HLr, Xi) + _lm(A.HLi, Xr) + _rm(Xi, HRrT) + _rm(Xr, HRiT)
        if self.cross_diag is not None and include_cross_diag:
            Yr = Yr + Xr * self.cross_diag
            Yi = Yi + Xi * self.cross_diag
        for i, (zr, zi) in enumerate(A.z):
            zr, zi = bcast(zr, Xr), bcast(zi, Xr)
            Am, Bm = self.crossA[i], self.crossB[i]
            # t1 = A X B^T with z, t2 = A^T X B with conj(z)
            t1r, t1i = _lm(Am, Xr) @ Bm.T, _lm(Am, Xi) @ Bm.T
            t2r, t2i = _lm(Am.T, Xr) @ Bm, _lm(Am.T, Xi) @ Bm
            Yr = Yr + zr * t1r - zi * t1i + zr * t2r + zi * t2i
            Yi = Yi + zr * t1i + zi * t1r + zr * t2i - zi * t2r
        return Yr, Yi

    def apply_H_planes(self, c, Xr, Xi, include_cross_diag: bool = True):
        """H x in re/im planes from the coefficient rows c (..., K)."""
        return self.apply_planes(self.assemble(c), Xr, Xi, include_cross_diag)

    # -- the complex interface of the plain step loop (ops/steppers.py) --
    def apply(self, A: Assembled, x):
        """-i H x of complex states x (..., B, N) for an assembled A."""
        X = x.reshape(x.shape[:-1] + (self.m1, self.m2))
        Hr, Hi = self.apply_planes(A, X.real.to(self.rdtype),
                                   X.imag.to(self.rdtype))
        # -i (Hr + i Hi) = Hi - i Hr
        return torch.complex(Hi, -Hr).to(self.dtype).reshape(x.shape)

    def rhs(self, c, x):
        return self.apply(self.assemble(c), x)


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def make_M_apply(engine: GroupedEngine):
    """(vr, vi, A) -> planes of M v, M = -i H, for an assembled A."""
    def M_apply(vr, vi, A):
        Hr, Hi = engine.apply_planes(A, vr, vi)
        return Hi, -Hr
    return M_apply


def make_jacobi_solver(engine: GroupedEngine, g: float, iters: int):
    """Truncated Jacobi-preconditioned Neumann solve of (I - g M) k = b in
    real planes: M = -iH, generator diagonal d = -i h, Minv = 1/(1 - i g h)
    elementwise, the off-diagonal correction iterated `iters` times. Its
    real-plane transpose is the same iteration at -g (M^T = -M, d^T = -d,
    Minv^T = conj(Minv)), the identity ops/grouped_adjoint.py rests on.
    Returns solve(br, bi, A) -> (kr, ki) for an assembled A."""
    rdt = np.float32 if engine.rdtype == torch.float32 else np.float64
    h = np.asarray(-engine.gen_diag().imag, dtype=rdt).reshape(
        engine.m1, engine.m2)                   # gen_diag = -i h
    den = 1.0 / (1.0 + (g * h) ** 2)
    put = lambda a: torch.as_tensor(np.asarray(a, dtype=rdt),
                                    device=engine.device)
    MR = put(den)                               # Re(1 / (1 + i g h))
    MI = put(-g * h * den)                      # Im
    hh = put(h)
    M_apply = make_M_apply(engine)

    def solve(br, bi, A):
        kr, ki = _cmul(MR, MI, br, bi)
        for _ in range(iters):
            mr, mi = M_apply(kr, ki, A)
            # subtract d k with d = -i h: d k = (h ki, -h kr)
            ur = br + g * (mr - hh * ki)
            ui = bi + g * (mi + hh * kr)
            kr, ki = _cmul(MR, MI, ur, ui)
        return kr, ki

    return solve


def device_rotation_planes(engine: GroupedEngine, s: float):
    """Real (m1, m2) planes (er, ei) of E = exp(-i s h), h the whole drift
    diagonal, built on the device from the model's constants in the
    engine's real dtype: the angle s h first, then cos and sin, as the
    reference builds them. |er + i ei| = 1 to an ulp, so applying E keeps
    the norm to elementwise rounding."""
    m = engine.model
    rdt, dev = engine.rdtype, engine.device
    dims = m.dims
    Q = len(dims)
    h = torch.zeros((1,) * Q, dtype=rdt, device=dev)
    grids = [torch.arange(d, dtype=rdt, device=dev).reshape(
        (1,) * k + (d,) + (1,) * (Q - k - 1)) for k, d in enumerate(dims)]
    for k in range(Q):
        nk = grids[k]
        h = h + float(m.detune[k]) * nk \
            - float(m.selfkerr[k]) / 2.0 * nk * (nk - 1.0)
    for idx, (k, l) in enumerate(coupling_pairs(Q)):
        if idx < len(m.crosskerr) and abs(m.crosskerr[idx]) > 1e-14:
            h = h - float(m.crosskerr[idx]) * grids[k] * grids[l]
    ang = float(s) * h.expand(tuple(dims)).reshape(engine.m1, engine.m2)
    return torch.cos(ang), -torch.sin(ang)


def make_V_apply(engine: GroupedEngine):
    """(vr, vi, A0) -> planes of V v, V = M - D the off-diagonal part of
    the generator, for A0 = engine.assemble(c, drop_constant=True): the
    drift diagonal lives in slot 0 and the cross-Kerr mask, so V is the
    stack contraction with slot 0 zeroed and the mask skipped."""
    def V_apply(vr, vi, A0):
        hr, hi = engine.apply_planes(A0, vr, vi, include_cross_diag=False)
        return hi, -hr
    return V_apply


def make_v_neumann_solver(engine: GroupedEngine, g: float, iters: int):
    """Truncated plain-Neumann solve of (I - g V) k = b in real planes, V
    the off-diagonal generator (make_V_apply); its transpose is the same
    solve at -g (V^T = -V). Returns solve(br, bi, A0)."""
    V_apply = make_V_apply(engine)

    def solve(br, bi, A0):
        kr, ki = br, bi
        for _ in range(iters):
            vr, vi = V_apply(kr, ki, A0)
            kr, ki = br + g * vr, bi + g * vi
        return kr, ki

    return solve


def make_real_split_step(engine: GroupedEngine, dt: float, iters: int,
                         planes: Optional[tuple] = None):
    """Diagonally-split IMR step in real planes:
    x -> E_{dt/2} . IMR_V(dt) . E_{dt/2} x, the stiff drift diagonal
    integrated exactly by the rotation E and only the off-diagonal V solved
    by plain Neumann. planes: device_rotation_planes(engine, dt/2), built
    here once if not given. Returns step(Xr, Xi, c)."""
    a = float(dt) / 2.0
    solve = make_v_neumann_solver(engine, a, iters)
    V_apply = make_V_apply(engine)
    er, ei = planes if planes is not None \
        else device_rotation_planes(engine, a)

    def step(Xr, Xi, c):
        A0 = engine.assemble(c, drop_constant=True)
        xr, xi = er * Xr - ei * Xi, er * Xi + ei * Xr
        br, bi = V_apply(xr, xi, A0)
        kr, ki = solve(br, bi, A0)
        yr, yi = xr + dt * kr, xi + dt * ki
        return er * yr - ei * yi, er * yi + ei * yr

    return step


def make_real_imr_step(engine: GroupedEngine, dt: float, iters: int):
    """Real-plane Jacobi-preconditioned IMR step:
    x' = x + dt k, (I - (dt/2) M) k = M x by make_jacobi_solver.
    Returns step(Xr, Xi, c)."""
    a = float(dt) / 2.0
    solve = make_jacobi_solver(engine, a, iters)
    M_apply = make_M_apply(engine)

    def step(Xr, Xi, c):
        A = engine.assemble(c)
        br, bi = M_apply(Xr, Xi, A)
        kr, ki = solve(br, bi, A)
        return Xr + dt * kr, Xi + dt * ki

    return step
