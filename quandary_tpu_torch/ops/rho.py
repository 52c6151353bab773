"""Density-matrix-form Lindblad propagation: the open system's state stays an
(N, N) matrix and the generator is applied as two-sided matrix products,

    T(rho) = M rho + rho M^dag + sum_l L_l rho L_l^dag,   M = -i H_eff(t),
    H_eff(t) = sum_k c_k(t) S_k

(the engine folds -i/2 sum L^dag L into stack slot 0, ops/rhs.py), never the
N^2-dimensional vectorized superoperator. The whole IMR time loop runs in one
kernel launch per direction.

Port of quandary_tpu/ops/pallas_rho.py::make_rho_propagate (its forward and
backward Pallas calls, with the step core of pallas_stream.py they inline)
to hand-written CUDA for Hopper, csrc/rho.cu. The contract is the JAX one
with ``real_io=True``:

    propagate(Sr, Si, (x0r, x0i), C) -> ((xTr, xTi), (hr, hi))

x0 (B, N, N), C (ntime, K) or (E, ntime, K) for E control candidates sharing
x0, hist (ntime, B, N, N) or (E, ntime, B, N, N); differentiable in x0 and C.
Stack and jump-operator cotangents are not computed: they are constants of
the optimization, as in the JAX kernel. The backward applies the exact real
transpose Tt(g) = M^dag g + g M + sum_l L_l^dag g L_l and reduces the H_eff
cotangent of every (cotangent, input) pair against the stacks into
coefficient cotangent rows.

What differs from the TPU kernel: the time loop inside the kernel, with one
thread-block cluster of G CTAs per (candidate, initial condition), each CTA
on a band of rows, in both directions; exact f32 FMA (the TPU default is a
3-pass bf16 emulation of f32 products), arrays of exactly (N, N) and
(ntime, K) (no 128-lane padding, no lane-group packing of initial
conditions), and E candidates in one launch.

Device dispatch: a CUDA tensor goes to the kernel pair (built with nvcc at
first use, bound with ctypes); a CPU tensor goes to ``rho_propagate_plain``,
the same recursion on (re, im) planes in plain torch with the hand-written
transpose as its backward, in any float dtype. There is no fallback from one
to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from . import cuda_build
from .streamk import _MODES, _stage_bwd, _stage_fwd, _zeros_if_none

# launches of each kernel since the counters were last set to 0
rho_fwd_launches = 0
rho_bwd_launches = 0
_COUNTERS = ("rho_fwd_launches", "rho_bwd_launches")

_SRC = os.path.join(cuda_build.CSRC_DIR, "rho.cu")
# the widest density matrix the kernels take: every CTA of a cluster holds M
# and the operand whole
MAX_N = 64
# the forward stores its stage iterates for the backward while they take no
# more than this (iters x the history); past it the backward replays them
KS_BUDGET_BYTES = int(1.5 * (1 << 30))


def launch_counts() -> dict:
    """The two launch counters by name."""
    return {k: globals()[k] for k in _COUNTERS}


def reset_launch_counts() -> None:
    for k in _COUNTERS:
        globals()[k] = 0


def add_launches(counts: dict, times: int = 1) -> None:
    """Add `times` x `counts` to the counters: the replay of a CUDA graph
    launches the kernels it captured without passing through the wrappers."""
    for k, v in counts.items():
        globals()[k] += times * v


def solver_planes(gen_diag, dt: float, linsolver: str) -> np.ndarray:
    """(nplanes, N, N) f64 entrywise planes of the stage solver in MATRIX
    layout, from the (N, N) generator diagonal d: jacobi
    (d_r, d_i, minv_r, minv_i) with Minv = 1/(1 - (dt/2) d); split
    (e_r, e_i, d_r, d_i) with E = exp((dt/2) d), d being subtracted inside T;
    neumann none (pallas_rho.py:101-120)."""
    if linsolver not in _MODES:
        raise NotImplementedError(
            f"rho kernel supports neumann/jacobi/split, got {linsolver!r}")
    if linsolver == "neumann":
        return np.zeros((0, 0, 0))
    if gen_diag is None:
        raise ValueError(f"rho {linsolver} solve requires gen_diag")
    d = np.asarray(gen_diag, dtype=np.complex128)
    if d.ndim != 2 or d.shape[0] != d.shape[1]:
        raise ValueError(f"gen_diag must be (N, N), got {d.shape}")
    if linsolver == "jacobi":
        m = 1.0 / (1.0 - 0.5 * dt * d)
        return np.stack([d.real, d.imag, m.real, m.imag])
    E = np.exp(0.5 * dt * d)
    return np.stack([E.real, E.imag, d.real, d.imag])


@dataclasses.dataclass
class RhoPlan:
    """Everything a launch needs besides x0 and the coefficients: the
    (K, N, N) stack planes, the jump planes L (4, J, N, N) =
    [L_r, L_i, Lh_r, Lh_i] with Lh = L^dag (None without jump operators),
    the entrywise solver planes (nplanes, N, N) and the step constants."""
    Sr: torch.Tensor
    Si: torch.Tensor
    L: Optional[torch.Tensor]
    planes: torch.Tensor
    dt: float
    iters: int
    linsolver: str

    @property
    def N(self) -> int:
        return self.Sr.shape[-1]

    @property
    def K(self) -> int:
        return self.Sr.shape[0]

    @property
    def njump(self) -> int:
        return 0 if self.L is None else self.L.shape[1]


# both kernels: one thread-block cluster of G CTAs per density matrix, each
# CTA on a band of about N / G rows (csrc/rho.cu)
_CLUSTERS = (1, 2, 4, 8, 16)
_SMS = 132              # streaming multiprocessors of an H100
_FWD_PLANES = 6         # (N, N) planes: M, and the operand F double-buffered
_BWD_PLANES = 10        # (N, N) planes: M, and F and U double-buffered
_PAIR_WORK = 24576      # least complex multiply-adds per CTA and T (or Tt)


def _cdiv(a, b):
    return -(-a // b)


def _band_tile(N, G):
    """Entries per thread and axis of a band of ceil(N / G) rows (either
    kernel): the smallest of 1, 2, 4 whose tiles take at most 512 threads
    (more warps hide more of each product's latency: at N = 64 and G = 8 one
    entry per thread ran the backward 1.56x faster than 2 x 2 tiles on an
    H100, scripts/rho_bwd_clusters.py)."""
    R = _cdiv(N, G)
    for ts in (1, 2):
        if _cdiv(R, ts) * _cdiv(N, ts) <= 512:
            return ts
    return 4


def _fwd_layout_bytes(N, G, K, jb, threads):
    """Shared memory the forward carves: two mbarriers (in 8 floats), M, the
    operand F (two buffers) and jb jump scratch bands of ceil(N / G)
    rows."""
    ld, R = N | 1, _cdiv(N, G)
    return 4 * (8 + _FWD_PLANES * N * ld + 2 * jb * R * ld)


def _bwd_layout_bytes(N, G, K, jb, threads):
    """Shared memory the backward carves: three mbarriers (8 floats), M, the
    operand F and the pair's input U (two buffers each), jb jump scratch
    bands of ceil(N / G) rows, the warps' C-bar partials and the cluster's
    (G x K)."""
    ld, R = N | 1, _cdiv(N, G)
    return 4 * (8 + _BWD_PLANES * N * ld + 2 * jb * R * ld
                + (threads // 32 + G) * K)


def _cluster_shape(name, layout_bytes, min_threads, E, B, N, K, J, G=None,
                   max_g=16):
    """(G, tile, threads, shared-memory bytes) of a launch of kernel `name`
    on E x B density matrices of size N with K stack slots and J jump
    operators, for the kernel's layout (`layout_bytes(N, G, K, jb,
    threads)`) and its least thread count.

    G, the CTAs per matrix, doubles from 1 (up to max_g) while E B G stays
    within the card's SMs, each CTA keeps two rows or more, and each CTA's
    share of a T (or Tt), (4 + 2 J) N^3 / G complex multiply-adds, stays at
    _PAIR_WORK or more: below it the exchange of the operand costs more than
    the products it spreads (on an H100 at 700 W both kernels ran fastest at
    the G this picks: open 2, N = 16 with J = 4, at G = 2, N = 27 with J = 6
    at G = 8; scripts/rho_bwd_clusters.py). It grows past that only where a
    CTA cannot hold the layout. The shared memory holds all J jump bands where
    it can (one barrier per T for all of them), else as many as fit. An
    explicit G is taken as it is (G in 1, 2, 4, 8, 16 and at most N).
    Raises NotImplementedError where nothing fits."""
    if G is None:
        G = 1
        while (2 * G <= max_g and 2 * G <= N // 2 and 2 * G * E * B <= _SMS
               and (4 + 2 * J) * N ** 3 >= 2 * G * _PAIR_WORK):
            G *= 2
        grow = True
    else:
        if G not in _CLUSTERS or G > N:
            raise ValueError(f"{name} cluster of {G} CTAs for N = {N}: G "
                             f"must be one of {_CLUSTERS} and at most N")
        grow = False
    while True:
        tile = _band_tile(N, G)
        tiles = _cdiv(_cdiv(N, G), tile) * _cdiv(N, tile)
        threads = 32 * _cdiv(max(tiles, min_threads), 32)
        base = layout_bytes(N, G, K, 0, threads)
        band = layout_bytes(N, G, 0, 1, 0) - layout_bytes(N, G, 0, 0, 0)
        jb = min(J, (cuda_build.MAX_SMEM - base) // band)
        if (base <= cuda_build.MAX_SMEM and (jb >= 1 or J == 0)
                and threads <= (256 if tile == 4 else 512)):
            return G, tile, threads, base + jb * band
        if not grow or 2 * G > min(N, max_g):
            raise NotImplementedError(
                f"{name}: a cluster of {G} CTAs cannot hold N = {N}, "
                f"K = {K}, J = {J} in {cuda_build.MAX_SMEM} bytes of shared "
                "memory each")
        G *= 2


def _fwd_shape(E, B, N, K, J, G=None, max_g=16):
    """_cluster_shape of a forward launch."""
    return _cluster_shape("rho_fwd", _fwd_layout_bytes, 1, E, B, N, K, J, G,
                          max_g)


def _bwd_shape(E, B, N, K, J, G=None, max_g=16):
    """_cluster_shape of a backward launch: its threads also cover the K
    stack slots of the C-bar reduction."""
    return _cluster_shape("rho_bwd", _bwd_layout_bytes, K, E, B, N, K, J, G,
                          max_g)


def launch_refusal(N: int, K: int):
    """Why the kernels cannot hold an (N, N) density matrix with K stack
    slots (a sentence naming the limit), or None when both take it at any
    number of matrices: the two shape functions at E B = 132 and one jump
    operator (J > 0 needs one jump band)."""
    if N > MAX_N:
        return (f"rho kernel: N = {N} exceeds one block (N <= {MAX_N}: every "
                "CTA of a cluster holds M and the operand whole); wider "
                "density matrices are not implemented")
    for shape in (_fwd_shape, _bwd_shape):
        try:
            shape(1, _SMS, N, K, 1)
        except NotImplementedError as err:
            return f"rho kernel: {err}"
    return None


def make_plan(Sr, Si, Ls, dt: float, iters: int, gen_diag=None,
              linsolver: str = "neumann") -> RhoPlan:
    """The launch plan for the (K, N, N) stack planes Sr, Si, on their device
    and in their dtype. Ls: the jump operators, complex (J, N, N) array-like
    or None; gen_diag: the (N, N) generator diagonal, for jacobi and split."""
    dt, iters = float(dt), int(iters)
    kw = dict(dtype=Sr.dtype, device=Sr.device)
    N = Sr.shape[-1]
    L = None
    if Ls is not None and len(Ls) > 0:
        Lc = np.stack([np.asarray(M, dtype=np.complex128) for M in Ls])
        Lh = np.conj(np.swapaxes(Lc, -1, -2))
        L = torch.as_tensor(np.stack([Lc.real, Lc.imag, Lh.real, Lh.imag]),
                            **kw).contiguous()
    planes = torch.as_tensor(solver_planes(gen_diag, dt, linsolver), **kw)
    if planes.numel() and planes.shape[-1] != N:
        raise ValueError(f"gen_diag must be ({N}, {N})")
    return RhoPlan(Sr=Sr.contiguous(), Si=Si.contiguous(), L=L,
                   planes=planes.contiguous(), dt=dt, iters=iters,
                   linsolver=linsolver)


# ----------------------------------------------------------------------
# plain torch version (CPU path and the kernels' oracle)
# ----------------------------------------------------------------------

def _cmm(ar, ai, br, bi):
    """Complex matrix product on plane pairs."""
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def _dagger(ar, ai):
    return ar.transpose(-1, -2), -ai.transpose(-1, -2)


def _solver_parts(plan):
    """(jac, split, dsub) plane tuples: what _stage_fwd/_stage_bwd take, and
    the diagonal that split subtracts inside the generator."""
    p = plan.planes
    if plan.linsolver == "jacobi":
        return tuple(p), None, None
    if plan.linsolver == "split":
        return None, (p[0], p[1]), (p[2], p[3])
    return None, None, None


def _gen_ops(plan, Mr, Mi, dsub):
    """T and its real transpose Tt on (E, B, N, N) plane pairs for this
    step's M planes (E, 1, N, N) (pallas_rho.py:255-308):
    T(v) = M v + v M^dag + sum_l (L_l v) L_l^dag - d v,
    Tt(u) = M^dag u + u M + sum_l (L_l^dag u) L_l - conj(d) u."""
    Mh = _dagger(Mr, Mi)
    L = plan.L

    def gen(A, Ah, adj):
        def f(vr, vi):
            lr, li = _cmm(A[0], A[1], vr, vi)
            rr, ri = _cmm(vr, vi, Ah[0], Ah[1])
            outr, outi = lr + rr, li + ri
            if L is not None:
                first, second = (L[2:], L[:2]) if adj else (L[:2], L[2:])
                tr, ti = _cmm(first[0], first[1], vr.unsqueeze(-3),
                              vi.unsqueeze(-3))
                jr, ji = _cmm(tr, ti, second[0], second[1])
                outr, outi = outr + jr.sum(-3), outi + ji.sum(-3)
            if dsub is not None:
                dr, di = dsub[0], (-dsub[1] if adj else dsub[1])
                outr = outr - (dr * vr - di * vi)
                outi = outi - (dr * vi + di * vr)
            return outr, outi
        return f

    return gen((Mr, Mi), Mh, False), gen(Mh, (Mr, Mi), True)


def _m_planes(plan, C):
    """(E, nt, 1, N, N) planes of M = -i sum_k c_k S_k: M_r = A_i,
    M_i = -A_r."""
    Ar = torch.tensordot(C, plan.Sr, dims=1)
    Ai = torch.tensordot(C, plan.Si, dims=1)
    return Ai.unsqueeze(2), -Ar.unsqueeze(2)


def plain_forward(plan, x0r, x0i, C):
    """Plain forward (autograd-differentiable): x0 (B, N, N), C (E, nt, K)
    -> hist pair (E, nt, B, N, N)."""
    jac, split, dsub = _solver_parts(plan)
    Mr, Mi = _m_planes(plan, C)
    E = C.shape[0]
    xr, xi = x0r.expand((E,) + x0r.shape), x0i.expand((E,) + x0i.shape)
    hr, hi = [], []
    for t in range(C.shape[1]):
        T, _ = _gen_ops(plan, Mr[:, t], Mi[:, t], dsub)
        xr, xi, _ = _stage_fwd(T, xr, xi, dt=plan.dt, iters=plan.iters,
                               jac=jac, split=split)
        hr.append(xr)
        hi.append(xi)
    return torch.stack(hr, dim=1), torch.stack(hi, dim=1)


def plain_backward(plan, x0r, x0i, C, hr, hi, gTr, gTi, jr, ji):
    """Hand-written transpose of plain_forward: the final-state and history
    cotangents -> (x0 cotangent (B, N, N) pair, coefficient cotangent
    (E, nt, K))."""
    jac, split, dsub = _solver_parts(plan)
    Mr, Mi = _m_planes(plan, C)
    E, nt = C.shape[:2]
    gr, gi = gTr, gTi
    x0e = (x0r.expand((E,) + x0r.shape), x0i.expand((E,) + x0i.shape))
    Cb = [None] * nt
    for t in range(nt - 1, -1, -1):
        gr, gi = gr + jr[:, t], gi + ji[:, t]
        xpr, xpi = x0e if t == 0 else (hr[:, t - 1], hi[:, t - 1])
        T, Tt = _gen_ops(plan, Mr[:, t], Mi[:, t], dsub)
        pairs = []
        gr, gi = _stage_bwd(T, Tt, xpr, xpi, gr, gi, pairs, dt=plan.dt,
                            iters=plan.iters, jac=jac, split=split)
        # H_eff cotangent W = sum over pairs and initial conditions of
        # c u^dag + c^dag u, as two block products over the stacked pairs
        cr, ci, ur, ui = (torch.cat(z, dim=1) for z in zip(*pairs))
        Wr, Wi = _cmm(cr, ci, *_dagger(ur, ui))
        Vr, Vi = _cmm(*_dagger(cr, ci), ur, ui)
        Wr, Wi = (Wr + Vr).sum(1), (Wi + Vi).sum(1)        # (E, N, N)
        # dA_i = Re W, dA_r = -Im W; C-bar_k = <dA_r, Sr_k> + <dA_i, Si_k>
        Cb[t] = torch.einsum("epq,kpq->ek", Wr, plan.Si) \
            - torch.einsum("epq,kpq->ek", Wi, plan.Sr)
    return gr.sum(0), gi.sum(0), torch.stack(Cb, dim=1)


class _PlainFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, x0r, x0i, C):
        hr, hi = plain_forward(plan, x0r, x0i, C)
        ctx.plan = plan
        ctx.save_for_backward(x0r, x0i, C, hr, hi)
        return hr[:, -1].clone(), hi[:, -1].clone(), hr, hi

    @staticmethod
    def backward(ctx, gxTr, gxTi, ghr, ghi):
        x0r, x0i, C, hr, hi = ctx.saved_tensors
        gr, gi, Cb = plain_backward(
            ctx.plan, x0r, x0i, C, hr, hi,
            _zeros_if_none(gxTr, hr[:, -1]), _zeros_if_none(gxTi, hi[:, -1]),
            _zeros_if_none(ghr, hr), _zeros_if_none(ghi, hi))
        return None, gr, gi, Cb


def rho_propagate_plain(plan, x0r, x0i, C):
    """Plain torch density-matrix propagation on any device and float dtype:
    x0 (B, N, N) pair, C (E, nt, K) -> (xTr, xTi, hr, hi) with xT
    (E, B, N, N) and hist (E, nt, B, N, N); the backward is the hand-written
    transpose."""
    return _PlainFn.apply(plan, x0r, x0i, C)


# ----------------------------------------------------------------------
# CUDA kernel pair
# ----------------------------------------------------------------------

def _bind(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    head = [i] * 9 + [f, f]
    # then tile, cluster, threads, shared-memory bytes and the stream
    for name, n_ptr in (("rho_fwd_launch", 13), ("rho_bwd_launch", 18)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [p] * n_ptr + head + [i] * 4 + [p], i
    for name in ("rho_fwd_max_clusters", "rho_bwd_max_clusters"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [i] * 4, i


def build_kernels(verbose: bool = False):
    """Compile csrc/rho.cu (cuda_build.build_library) and load it, once per
    process. Returns (library path, build seconds, compiler output)."""
    return cuda_build.build_library(_SRC, _bind, verbose)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_cuda(plan, *ts):
    why = launch_refusal(plan.N, plan.K)
    if why is not None:
        raise NotImplementedError(why)
    own = (plan.Sr, plan.Si, plan.planes) + (() if plan.L is None
                                             else (plan.L,))
    for t in own + ts:
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise NotImplementedError(
                "rho kernel runs float32 CUDA tensors only (complex128 is "
                f"not ported to the GPU); got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("rho kernel needs contiguous tensors")


def _dims(plan, E, nt, B, store):
    return (E, nt, B, plan.N, plan.K, plan.njump, plan.iters,
            _MODES[plan.linsolver], int(store), plan.dt, plan.dt / 2.0)


def _cluster_args(max_clusters, shape_fn, plan, E, nt, B, store, G):
    """A launcher's trailing arguments: dims, tile, cluster, threads,
    shared-memory bytes (shape_fn). Clusters of 16 CTAs are beyond the
    portable size: the rule takes them only where the card's occupancy
    query `max_clusters(tile, 16, threads, bytes)` schedules one, else it
    stops at 8. A G asked for is taken as it is."""
    shape = shape_fn(E, B, plan.N, plan.K, plan.njump, G)
    if G is None and shape[0] == 16 and max_clusters(
            shape[1], 16, shape[2], shape[3]) < 1:
        shape = shape_fn(E, B, plan.N, plan.K, plan.njump, max_g=8)
    G, tile, threads, smem = shape
    return _dims(plan, E, nt, B, store) + (tile, G, threads, smem)


def _fwd_args(lib, plan, E, nt, B, store, G=None):
    return _cluster_args(lib.rho_fwd_max_clusters, _fwd_shape, plan, E, nt,
                         B, store, G)


def _bwd_args(lib, plan, E, nt, B, store, G=None):
    return _cluster_args(lib.rho_bwd_max_clusters, _bwd_shape, plan, E, nt,
                         B, store, G)


def stores_iterates(plan, E, nt, B) -> bool:
    """Whether a forward of this size keeps its stage iterates for the
    backward (the gate on bytes of pallas_rho.py's store_iters)."""
    ks_bytes = 2 * E * B * nt * plan.iters * plan.N * plan.N * 4
    return plan.iters > 0 and ks_bytes <= KS_BUDGET_BYTES


def _kernel_fwd(plan, x0r, x0i, C, _cluster=None):
    """One rho_fwd launch; `_cluster` forces the CTAs per matrix (the card
    tests and the timing script compare them), else _fwd_shape picks G. A
    refused launch raises: no other G and no plain version stands in."""
    global rho_fwd_launches
    _check_cuda(plan, x0r, x0i, C)
    lib = cuda_build.library(_SRC, _bind)
    E, nt, _ = C.shape
    B, N, _ = x0r.shape
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=C.device)
    xTr, xTi = new(E, B, N, N), new(E, B, N, N)
    hr, hi = new(E, nt, B, N, N), new(E, nt, B, N, N)
    ksr = ksi = None
    store = stores_iterates(plan, E, nt, B)
    if store:
        ksr = new(E, B, nt, plan.iters, N, N)
        ksi = new(E, B, nt, plan.iters, N, N)
    err = lib.rho_fwd_launch(
        *map(_ptr, (plan.Sr, plan.Si, plan.L, C, x0r, x0i, plan.planes, xTr,
                    xTi, hr, hi, ksr, ksi)),
        *_fwd_args(lib, plan, E, nt, B, store, _cluster),
        torch.cuda.current_stream(C.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rho_fwd launch failed: CUDA error {err}")
    rho_fwd_launches += 1
    return xTr, xTi, hr, hi, ksr, ksi


def _kernel_bwd(plan, x0r, x0i, C, hr, hi, ksr, ksi, gTr, gTi, jr, ji,
                _cluster=None):
    """One rho_bwd launch; `_cluster` forces the CTAs per matrix (the card
    tests and the timing script compare them), else _bwd_shape picks G. A
    refused launch raises: no other G and no plain version stands in."""
    global rho_bwd_launches
    _check_cuda(plan, x0r, x0i, C, hr, hi, gTr, gTi, jr, ji)
    lib = cuda_build.library(_SRC, _bind)
    E, nt, K = C.shape
    B, N, _ = x0r.shape
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=C.device)
    store = ksr is not None
    if not store:       # the replay's scratch: one step's iterates per block
        ksr = new(E, B, max(plan.iters, 1), N, N)
        ksi = torch.empty_like(ksr)
    g0r, g0i = new(E, B, N, N), new(E, B, N, N)
    Cb = new(E, B, nt, K)
    err = lib.rho_bwd_launch(
        *map(_ptr, (plan.Sr, plan.Si, plan.L, C, x0r, x0i, hr, hi, jr, ji,
                    gTr, gTi, plan.planes, ksr, ksi, g0r, g0i, Cb)),
        *_bwd_args(lib, plan, E, nt, B, store, _cluster),
        torch.cuda.current_stream(C.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rho_bwd launch failed: CUDA error {err}")
    rho_bwd_launches += 1
    # x0 is shared by the candidates; the coefficients by the initial
    # conditions (pallas_rho.py:564)
    return g0r.sum(0), g0i.sum(0), Cb.sum(1)


class _KernelFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, x0r, x0i, C):
        x0r, x0i, C = x0r.contiguous(), x0i.contiguous(), C.contiguous()
        xTr, xTi, hr, hi, ksr, ksi = _kernel_fwd(plan, x0r, x0i, C)
        ctx.plan = plan
        ctx.has_ks = ksr is not None
        saved = (x0r, x0i, C, hr, hi) + ((ksr, ksi) if ctx.has_ks else ())
        ctx.save_for_backward(*saved)
        return xTr, xTi, hr, hi

    @staticmethod
    def backward(ctx, gxTr, gxTi, ghr, ghi):
        x0r, x0i, C, hr, hi = ctx.saved_tensors[:5]
        ksr, ksi = ctx.saved_tensors[5:] if ctx.has_ks else (None, None)
        gr, gi, Cb = _kernel_bwd(
            ctx.plan, x0r, x0i, C, hr, hi, ksr, ksi,
            _zeros_if_none(gxTr, hr[:, -1]), _zeros_if_none(gxTi, hi[:, -1]),
            _zeros_if_none(ghr, hr), _zeros_if_none(ghi, hi))
        return None, gr, gi, Cb


def rho_propagate_kernel(plan, x0r, x0i, C):
    """The CUDA kernel pair behind the same interface as rho_propagate_plain
    (float32 CUDA tensors only)."""
    return _KernelFn.apply(plan, x0r, x0i, C)


def rho_propagate(plan, x0r, x0i, C):
    """Device dispatch: the kernel pair for CUDA tensors, the plain version
    for CPU tensors."""
    if C.device.type == "cuda":
        return rho_propagate_kernel(plan, x0r, x0i, C)
    if C.device.type == "cpu":
        return rho_propagate_plain(plan, x0r, x0i, C)
    raise NotImplementedError(f"rho propagation has no path for {C.device}")


def make_rho_propagate(Ls, dt: float, iters: int = 10, gen_diag=None,
                       linsolver: str = "neumann"):
    """Build propagate(Sr, Si, (x0r, x0i), C) -> ((xTr, xTi), (hr, hi)).

    Sr, Si: (K, N, N) real/imaginary planes of the H_eff stack; Ls: the jump
    operators (J, N, N) complex, or None; C: (ntime, K) or (E, ntime, K)
    coefficient rows; x0 (B, N, N). linsolver 'jacobi' and 'split' need
    gen_diag, the (N, N) generator diagonal. The plan is built anew only
    when other stack tensors arrive."""
    held = []

    def propagate(Sr, Si, x0, C):
        if not held or held[0] is not Sr or held[1] is not Si:
            held[:] = [Sr, Si, make_plan(Sr, Si, Ls, dt, iters, gen_diag,
                                         linsolver)]
        plan = held[2]
        dt_ = plan.Sr.dtype
        Ce = (C if C.dim() == 3 else C[None]).to(dt_).contiguous()
        xTr, xTi, hr, hi = rho_propagate(plan, x0[0].to(dt_), x0[1].to(dt_),
                                         Ce)
        if C.dim() == 2:
            xTr, xTi, hr, hi = xTr[0], xTi[0], hr[0], hi[0]
        return (xTr, xTi), (hr, hi)

    return propagate
