"""Hand-written solve-based discrete adjoint for the grouped large-N step.

Counterpart of quandary_tpu/ops/grouped_adjoint.py. Differentiating
through the unrolled stage solve (ops/reversible.py on the real steps)
costs about 7x the forward per step; this adjoint costs about 2x, in the
adjoint-solve form of the reference's evolveBWD (timestepper.cpp:631-694).

Forward step (Jacobi):  y = x + dt k,  k = P_a(M) (M x),  a = dt/2, M = -iH,
P_a the truncated Jacobi-Neumann polynomial of (I - aM)^{-1}.

* State cotangent, the exact transpose of the computed map: in the
  real-plane inner product M^T = -M, hence P_a(M)^T = P_{-a}(M) and
      xbar = ybar - dt M (P_{-a} ybar),
  one solve with the same iteration at -a and one M application.
* Control cotangent: with w = P_{-a} ybar and the midpoint x_mid = y - a k,
      d<ybar, y>/dc_k = dt Im<w, H_k x_mid>.
* Reconstruction: x = y - dt P_{-a}(M y); it shares one batched solve
  (2B states) with w.

split=True takes the diagonally-split step y = E (x2 + dt P_a(V)(V x2)),
x2 = E x (E the exact diagonal rotation, V the off-diagonal generator):
E^T = E^{-1} and P_a(V)^T = P_{-a}(V), so the same formulas hold in the
rotated frame, with slot 0's cotangent zero (V has no slot 0).

The states are real planes (..., B, m1, m2); the coefficient rows C
(ntime, ..., K) carry the same leading (candidate) axes.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .grouped_rhs import (Assembled, GroupedEngine, device_rotation_planes,
                          make_jacobi_solver, make_M_apply, make_V_apply,
                          make_v_neumann_solver)


def _dC_contractions(engine: GroupedEngine, wr, wi, xr, xi, dt):
    """dt Im<W, H_k X> for every coefficient slot k: (..., K), summed over
    the batch axis B. <W, V> = sum conj(W) V over B and the elements.
    Each stack family reduces to a pair of batch-summed GEMMs and an
    elementwise contraction with the stack:
      left:  Im tr(L_k P^T),  P = sum_b X_b W_b^H   (m1 x m1)
      right: Im sum R_k o Q,  Q = sum_b W_b^H X_b   (m2 x m2)
    plus one two-sided product per cross-JC pair. The cross-Kerr mask is
    not scaled by c[0], so it adds nothing to slot 0."""
    ein = torch.einsum
    # P = sum_b X W^H: Pr = Xr Wr^T + Xi Wi^T, Pi = Xi Wr^T - Xr Wi^T
    bT = lambda A, B: ein("...bim,...bjm->...ij", A, B)
    Pr = bT(xr, wr) + bT(xi, wi)
    Pi = bT(xi, wr) - bT(xr, wi)
    g = ein("kip,...pi->...k", engine.SLr, Pi) \
        + ein("kip,...pi->...k", engine.SLi, Pr)
    # Q = sum_b W^H X: Qr = Wr^T Xr + Wi^T Xi, Qi = Wr^T Xi - Wi^T Xr
    bH = lambda A, B: ein("...bim,...bin->...mn", A, B)
    Qr = bH(wr, xr) + bH(wi, xi)
    Qi = bH(wr, xi) - bH(wi, xr)
    g = g + ein("kmn,...mn->...k", engine.SRr, Qi) \
        + ein("kmn,...mn->...k", engine.SRi, Qr)
    # cross-group JC pairs: z (A X B^T) + conj(z) (A^T X B) with
    # z = J (c_p + i c_q): dH/dc_p = J (t1 + t2), dH/dc_q = i J (t1 - t2)
    Q, n_jc = engine.model.n_osc, engine.model.n_jc
    red = lambda t: t.sum(dim=(-3, -2, -1))
    cols = [g[..., k] for k in range(g.shape[-1])]
    for i, j in enumerate(engine.cross_idx):
        J = engine.cross_J[i]
        A, Bm = engine.crossA[i], engine.crossB[i]
        # <W, A X B^T> = sum conj(V1) X, V1 = A^T W B
        V1r, V1i = A.T @ wr @ Bm, A.T @ wi @ Bm
        # <W, A^T X B> = sum conj(V2) X, V2 = A W B^T
        V2r, V2i = A @ wr @ Bm.T, A @ wi @ Bm.T
        im1 = red(V1r * xi - V1i * xr)
        re1 = red(V1r * xr + V1i * xi)
        im2 = red(V2r * xi - V2i * xr)
        re2 = red(V2r * xr + V2i * xi)
        cols[1 + 2 * Q + j] = cols[1 + 2 * Q + j] + J * (im1 + im2)
        cols[1 + 2 * Q + n_jc + j] = cols[1 + 2 * Q + n_jc + j] \
            + J * (re1 - re2)
    return dt * torch.stack(cols, dim=-1)


def make_grouped_adjoint_propagate(engine: GroupedEngine, dt: float,
                                   iters: int,
                                   penalty_fn: Optional[Callable] = None,
                                   split: bool = False):
    """propagate((Xr, Xi), C, extras) -> (xTr, xTi, *pen_sums) with the
    solve-based backward above; the contract of
    ops/reversible.make_reversible_propagate on the grouped real-plane
    step: C (ntime, ..., K), x0 planes (..., B, m1, m2), extras a tuple of
    (ntime, ...) tensors, penalty_fn((xr, xi), extra) -> tuple of penalty
    tensors at a post-step state. C is differentiated; x0 and the extras
    are constants."""
    a = float(dt) / 2.0
    if split:
        step_solve = make_v_neumann_solver(engine, a, iters)
        adj_solve = make_v_neumann_solver(engine, -a, iters)
        op_apply = make_V_apply(engine)          # V = M - D
    else:
        step_solve = make_jacobi_solver(engine, a, iters)
        adj_solve = make_jacobi_solver(engine, -a, iters)
        op_apply = make_M_apply(engine)
    fns = dict(engine=engine, dt=float(dt), a=a, split=split,
               step_solve=step_solve, adj_solve=adj_solve,
               op_apply=op_apply, penalty_fn=penalty_fn)
    return lambda x0, C, extras=(): _GroupedAdjoint.apply(
        fns, x0[0], x0[1], C, tuple(extras))


def _rot(planes, sign, vr, vi):
    er, ei = planes
    ei = sign * ei
    return er * vr - ei * vi, er * vi + ei * vr


def _assemble(f, c) -> Assembled:
    return f["engine"].assemble(c, drop_constant=f["split"])


def _pens(f, x, extras, n):
    if f["penalty_fn"] is None:
        return ()
    return tuple(f["penalty_fn"](x, tuple(e[n] for e in extras)))


class _GroupedAdjoint(torch.autograd.Function):

    @staticmethod
    def forward(ctx, f, x0r, x0i, C, extras):
        planes = device_rotation_planes(f["engine"], f["a"]) \
            if f["split"] else None
        dt = f["dt"]
        xr, xi = x0r, x0i
        sums = None
        for n in range(C.shape[0]):
            A = _assemble(f, C[n])
            if planes is not None:
                xr, xi = _rot(planes, 1.0, xr, xi)
            br, bi = f["op_apply"](xr, xi, A)
            kr, ki = f["step_solve"](br, bi, A)
            xr, xi = xr + dt * kr, xi + dt * ki
            if planes is not None:
                xr, xi = _rot(planes, 1.0, xr, xi)
            p = _pens(f, (xr, xi), extras, n)
            sums = p if sums is None else tuple(s + q for s, q in zip(sums, p))
        ctx.f, ctx.extras, ctx.planes = f, extras, planes
        ctx.save_for_backward(C, xr, xi)
        return (xr, xi, *(sums or ()))

    @staticmethod
    def backward(ctx, yr_bar, yi_bar, *pen_bar):
        f, extras, planes = ctx.f, ctx.extras, ctx.planes
        C, yr, yi = ctx.saved_tensors
        dt, a = f["dt"], f["a"]
        br_ = torch.zeros_like(yr) if yr_bar is None else yr_bar
        bi_ = torch.zeros_like(yi) if yi_bar is None else yi_bar
        C_bar = torch.zeros_like(C)
        B = yr.shape[-3]
        for n in reversed(range(C.shape[0])):
            if f["penalty_fn"] is not None:
                with torch.enable_grad():
                    pr = yr.detach().requires_grad_(True)
                    pi = yi.detach().requires_grad_(True)
                    outs, grads = [], []
                    for t, g in zip(_pens(f, (pr, pi), extras, n), pen_bar):
                        if g is not None and t.requires_grad:
                            outs.append(t)
                            grads.append(g)
                    if outs:
                        gr, gi = torch.autograd.grad(outs, (pr, pi), grads,
                                                     allow_unused=True)
                        br_ = br_ if gr is None else br_ + gr
                        bi_ = bi_ if gi is None else bi_ + gi
            A = _assemble(f, C[n])
            if planes is not None:
                # undo the trailing rotation: state and cotangent move to
                # the rotated frame (E^T = E^{-1}, the rotation by -angle)
                yr, yi = _rot(planes, -1.0, yr, yi)
                br_, bi_ = _rot(planes, -1.0, br_, bi_)
            # one batched solve at -a of [Op y ; ybar]
            myr, myi = f["op_apply"](yr, yi, A)
            sr, si = f["adj_solve"](torch.cat([myr, br_], dim=-3),
                                    torch.cat([myi, bi_], dim=-3), A)
            kr, ki = sr[..., :B, :, :], si[..., :B, :, :]   # reconstruction
            wr, wi = sr[..., B:, :, :], si[..., B:, :, :]   # adjoint solve
            x_prev_r, x_prev_i = yr - dt * kr, yi - dt * ki
            # the exact transpose of the computed map: xbar = ybar - dt Op w
            mwr, mwi = f["op_apply"](wr, wi, A)
            xbar_r, xbar_i = br_ - dt * mwr, bi_ - dt * mwi
            # the inner step's midpoint (x + y)/2 = y - a k (rotated frame
            # when split; dV/dc = dM/dc on every control slot)
            dc = _dC_contractions(f["engine"], wr, wi, yr - a * kr,
                                  yi - a * ki, dt)
            if planes is not None:
                # the split step has no c[0] dependence (slot 0 is zeroed
                # in V, the rotations are model constants)
                dc = torch.cat([torch.zeros_like(dc[..., :1]), dc[..., 1:]],
                               dim=-1)
                x_prev_r, x_prev_i = _rot(planes, -1.0, x_prev_r, x_prev_i)
                xbar_r, xbar_i = _rot(planes, -1.0, xbar_r, xbar_i)
            C_bar[n] = dc.to(C.dtype)
            yr, yi, br_, bi_ = x_prev_r, x_prev_i, xbar_r, xbar_i
        return None, None, None, C_bar, None
