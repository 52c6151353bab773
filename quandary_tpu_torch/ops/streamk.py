"""StreamK propagation: the whole IMR time loop in one kernel launch per
direction, with H(t) = sum_k c_k(t) S_k contracted in-kernel from the
operator stacks.

Port of quandary_tpu/ops/pallas_stream.py::make_streamk_propagate (its
forward and backward Pallas calls, and the step core _stage_fwd/_stage_bwd
they inline) to hand-written CUDA for Hopper, csrc/streamk.cu. The contract
is the JAX one with ``real_io=True``:

    propagate(Sr, Si, (x0r, x0i), C) -> ((xTr, xTi), (hr, hi))

differentiable in x0 and C. C is (ntime, K), or (E, ntime, K) for E control
candidates sharing x0 (one thread block each); hist is (ntime, B, N), or
(E, ntime, B, N). Stack cotangents are not computed: the stacks are
constants of the optimization, as in the JAX kernel.

Device dispatch: a CUDA tensor goes to the kernel pair (built with nvcc at
first use, bound with ctypes); a CPU tensor goes to ``streamk_propagate_plain``,
the same function in plain torch with the hand-written transpose as its
backward, in any float dtype. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np
import torch

# launches of each kernel since the counters were last set to 0
streamk_fwd_launches = 0
streamk_bwd_launches = 0

_MODES = {"neumann": 0, "jacobi": 1, "split": 2}
_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                    "streamk.cu")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "quandary_tpu_torch")
_MAX_SMEM = 227 * 1024
_LIB = None


def solver_rows(gen_diag, dt: float, linsolver: str) -> np.ndarray:
    """(nrows, N) f64 per-entry rows of the stage solver, computed on the
    host: jacobi (d_r, d_i, minv_r, minv_i) with Minv = 1/(1 - (dt/2) d);
    split (e_r, e_i) with E = exp((dt/2) d); neumann none
    (pallas_stream.py:141-159)."""
    if linsolver not in _MODES:
        raise NotImplementedError(
            f"streamK supports neumann/jacobi/split, got {linsolver!r}")
    if linsolver == "neumann":
        return np.zeros((0, 0))
    if gen_diag is None:
        raise ValueError(f"streamK {linsolver} requires gen_diag")
    d = np.asarray(gen_diag, dtype=np.complex128).reshape(-1)
    if linsolver == "jacobi":
        m = 1.0 / (1.0 - 0.5 * dt * d)
        return np.stack([d.real, d.imag, m.real, m.imag])
    E = np.exp(0.5 * dt * d)
    return np.stack([E.real, E.imag])


@dataclasses.dataclass
class StreamKPlan:
    """Everything a launch needs besides x0 and the coefficients: the
    extended (Ke, N, N) stacks (split appends the -diag(h) slot), the
    solver rows, and the step constants."""
    Sr: torch.Tensor
    Si: torch.Tensor
    rows: torch.Tensor
    dt: float
    iters: int
    linsolver: str
    store_iters: bool

    @property
    def Ke(self) -> int:
        return self.Sr.shape[0]


# ----------------------------------------------------------------------
# plain torch version (CPU path and the kernels' oracle)
# ----------------------------------------------------------------------

def _solver_parts(plan):
    """(jac, split) row tuples in the form _stage_fwd/_stage_bwd take."""
    r = plan.rows
    if plan.linsolver == "jacobi":
        return (r[0], r[1], r[2], r[3]), None
    if plan.linsolver == "split":
        return None, (r[0], r[1])
    return None, None


def _planes(plan, Ce):
    """(E, nt, N, N) real and imaginary H planes."""
    return (torch.tensordot(Ce, plan.Sr, dims=1),
            torch.tensordot(Ce, plan.Si, dims=1))


def _ops(Hr, Hi):
    """T(v) = -i H v and its real transpose on (..., B, N) plane pairs."""
    HrT, HiT = Hr.transpose(-1, -2), Hi.transpose(-1, -2)

    def T(vr, vi):
        ar = vr @ HrT - vi @ HiT
        ai = vr @ HiT + vi @ HrT
        return ai, -ar

    def Tt(ur, ui):
        return ur @ Hi - ui @ Hr, ur @ Hr + ui @ Hi

    return T, Tt


def _stage_fwd(T, xr, xi, *, dt, iters, jac, split):
    """One IMR step (pallas_stream.py:217-255). Returns the new state and
    the stage iterates k_0..k_{iters-1}."""
    a = dt / 2.0
    if split is not None:
        er, ei = split
        xr, xi = er * xr - ei * xi, er * xi + ei * xr
    br, bi = T(xr, xi)
    ks = []
    if jac is None:
        kr, ki = br, bi
        for _ in range(iters):
            ks.append((kr, ki))
            mr, mi = T(kr, ki)
            kr, ki = br + a * mr, bi + a * mi
    else:
        dr, di, mr_, mi_ = jac
        kr, ki = mr_ * br - mi_ * bi, mi_ * br + mr_ * bi
        for _ in range(iters):
            ks.append((kr, ki))
            tr, ti = T(kr, ki)
            ur = br + a * (tr - (dr * kr - di * ki))
            ui = bi + a * (ti - (dr * ki + di * kr))
            kr, ki = mr_ * ur - mi_ * ui, mi_ * ur + mr_ * ui
    xr = xr + dt * kr
    xi = xi + dt * ki
    if split is not None:
        xr, xi = er * xr - ei * xi, er * xi + ei * xr
    return xr, xi, ks


def _stage_bwd(T, Tt, xpr, xpi, gr, gi, pairs, *, dt, iters, jac, split):
    """Exact real transpose of one _stage_fwd step (pallas_stream.py
    :331-426), replaying the stage iterates from the pre-step state
    (xpr, xpi). (gr, gi) already holds this step's history cotangent.
    Appends every (cotangent at T's output, T's input) pair to `pairs` and
    returns the outgoing state cotangent."""
    if split is not None:
        er, ei = split
        gr, gi = er * gr + ei * gi, er * gi - ei * gr
        xpr, xpi = er * xpr - ei * xpi, er * xpi + ei * xpr
    a = dt / 2.0
    _, _, ks = _stage_fwd(T, xpr, xpi, dt=dt, iters=iters, jac=jac,
                          split=None)
    bbr, bbi = torch.zeros_like(gr), torch.zeros_like(gi)
    kbr, kbi = dt * gr, dt * gi
    if jac is not None:
        dr, di, mr_, mi_ = jac

        def Wt(ur, ui):     # transpose of W = multiply by conj(Minv)
            return mr_ * ur + mi_ * ui, mr_ * ui - mi_ * ur

    for j in range(iters, 0, -1):
        if jac is not None:
            kbr, kbi = Wt(kbr, kbi)
        bbr, bbi = bbr + kbr, bbi + kbi
        cr, ci = a * kbr, a * kbi
        pairs.append((cr, ci) + ks[j - 1])
        kbr, kbi = Tt(cr, ci)
        if jac is not None:   # minus the transpose of v -> d v
            kbr = kbr - (dr * cr + di * ci)
            kbi = kbi - (dr * ci - di * cr)
    if jac is not None:
        kbr, kbi = Wt(kbr, kbi)
    bbr, bbi = bbr + kbr, bbi + kbi
    pairs.append((bbr, bbi, xpr, xpi))
    tr, ti = Tt(bbr, bbi)
    outr, outi = gr + tr, gi + ti
    if split is not None:
        outr, outi = er * outr + ei * outi, er * outi - ei * outr
    return outr, outi


def plain_forward(plan, x0r, x0i, Ce):
    """Plain forward (autograd-differentiable): x0 (B, N), Ce (E, nt, Ke)
    -> hist pair (E, nt, B, N)."""
    jac, split = _solver_parts(plan)
    Hr, Hi = _planes(plan, Ce)
    E = Ce.shape[0]
    xr, xi = x0r.expand((E,) + x0r.shape), x0i.expand((E,) + x0i.shape)
    hr, hi = [], []
    for t in range(Ce.shape[1]):
        T, _ = _ops(Hr[:, t], Hi[:, t])
        xr, xi, _ = _stage_fwd(T, xr, xi, dt=plan.dt, iters=plan.iters,
                               jac=jac, split=split)
        hr.append(xr)
        hi.append(xi)
    return torch.stack(hr, dim=1), torch.stack(hi, dim=1)


def plain_backward(plan, x0r, x0i, Ce, hr, hi, gTr, gTi, jr, ji):
    """Hand-written transpose of plain_forward: the final-state and history
    cotangents -> (x0 cotangent (B, N) pair, coefficient cotangent
    (E, nt, Ke))."""
    jac, split = _solver_parts(plan)
    Hr, Hi = _planes(plan, Ce)
    E, nt = Ce.shape[:2]
    gr, gi = gTr, gTi
    x0e = (x0r.expand((E,) + x0r.shape), x0i.expand((E,) + x0i.shape))
    Hb = [None] * nt
    for t in range(nt - 1, -1, -1):
        gr, gi = gr + jr[:, t], gi + ji[:, t]
        xpr, xpi = x0e if t == 0 else (hr[:, t - 1], hi[:, t - 1])
        T, Tt = _ops(Hr[:, t], Hi[:, t])
        pairs = []
        gr, gi = _stage_bwd(T, Tt, xpr, xpi, gr, gi, pairs, dt=plan.dt,
                            iters=plan.iters, jac=jac, split=split)
        # sum_pairs of the H-plane outer products as one block product
        cr, ci, ur, ui = (torch.cat(z, dim=-2) for z in zip(*pairs))
        cr, ci = cr.transpose(-1, -2), ci.transpose(-1, -2)
        Hb[t] = (cr @ ui - ci @ ur, cr @ ur + ci @ ui)
    Hbr = torch.stack([h[0] for h in Hb], dim=1)
    Hbi = torch.stack([h[1] for h in Hb], dim=1)
    Cb = (torch.einsum("etpq,kpq->etk", Hbr, plan.Sr)
          + torch.einsum("etpq,kpq->etk", Hbi, plan.Si))
    return gr.sum(0), gi.sum(0), Cb


def _zeros_if_none(g, like):
    return torch.zeros_like(like) if g is None else g.contiguous()


class _PlainFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, x0r, x0i, Ce):
        hr, hi = plain_forward(plan, x0r, x0i, Ce)
        ctx.plan = plan
        ctx.save_for_backward(x0r, x0i, Ce, hr, hi)
        return hr[:, -1].clone(), hi[:, -1].clone(), hr, hi

    @staticmethod
    def backward(ctx, gxTr, gxTi, ghr, ghi):
        x0r, x0i, Ce, hr, hi = ctx.saved_tensors
        gr, gi, Cb = plain_backward(
            ctx.plan, x0r, x0i, Ce, hr, hi,
            _zeros_if_none(gxTr, hr[:, -1]), _zeros_if_none(gxTi, hi[:, -1]),
            _zeros_if_none(ghr, hr), _zeros_if_none(ghi, hi))
        return None, gr, gi, Cb


def streamk_propagate_plain(plan, x0r, x0i, Ce):
    """Plain torch streamK propagation on any device and float dtype:
    x0 (B, N) pair, Ce (E, nt, Ke) -> (xTr, xTi, hr, hi) with xT (E, B, N)
    and hist (E, nt, B, N); the backward is the hand-written transpose."""
    return _PlainFn.apply(plan, x0r, x0i, Ce)


# ----------------------------------------------------------------------
# CUDA kernel pair
# ----------------------------------------------------------------------

def build_kernels(verbose: bool = False):
    """Compile csrc/streamk.cu with nvcc into build/quandary_tpu_torch/ (keyed
    on a hash of the source) and load it. Returns (library path, build
    seconds, compiler output); seconds is 0 when the library was already
    built."""
    global _LIB
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(_BUILD_DIR, f"libstreamk_{digest}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(path):
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", tmp, _SRC]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
        os.replace(tmp, path)
    if _LIB is None or _LIB._name != path:
        lib = ctypes.CDLL(path)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.streamk_fwd_launch.argtypes = [p] * 12 + [i] * 8 + [f, f, i, i, p]
        lib.streamk_fwd_launch.restype = i
        lib.streamk_bwd_launch.argtypes = [p] * 17 + [i] * 8 + [f, f, i, i, p]
        lib.streamk_bwd_launch.restype = i
        _LIB = lib
    return path, seconds, log


def _launch_shape(plan, B, N, backward: bool):
    """(threads per block, dynamic shared-memory bytes) of one launch; raises
    NotImplementedError past what one block can hold."""
    BN, NN, Ke, it = B * N, N * N, plan.Ke, plan.iters
    if BN > 1024:
        raise NotImplementedError(
            f"streamK kernel: B*N = {BN} state entries exceed one block "
            "(1024 threads); multi-block candidates are not implemented")
    threads = max(32, -(-max(BN, min(NN, 1024)) // 32) * 32)
    floats = 2 * Ke * NN + 2 * N * (N + 1)
    if backward:
        floats += 2 * NN + 2 * BN + 2 * it * BN + 2 * (it + 1) * BN \
            + (threads // 32) * Ke
    else:
        floats += 2 * BN + 2 * (it + 1) * BN
    smem = 4 * floats
    if smem > _MAX_SMEM:
        raise NotImplementedError(
            f"streamK kernel: {smem} bytes of shared memory exceed the "
            f"{_MAX_SMEM} a block can use (N={N}, Ke={Ke}, B={B})")
    return threads, smem


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_cuda(plan, *ts):
    for t in (plan.Sr, plan.Si, plan.rows) + ts:
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise NotImplementedError(
                "streamK kernel runs float32 CUDA tensors only (complex128 "
                f"is not ported to the GPU); got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("streamK kernel needs contiguous tensors")


def _dims(plan, E, nt, B, N):
    return (E, nt, B, N, plan.Ke, plan.iters, _MODES[plan.linsolver],
            int(plan.store_iters), plan.dt, plan.dt / 2.0)


def _kernel_fwd(plan, x0r, x0i, Ce):
    global streamk_fwd_launches
    _check_cuda(plan, x0r, x0i, Ce)
    build_kernels()
    E, nt, _ = Ce.shape
    B, N = x0r.shape
    threads, smem = _launch_shape(plan, B, N, backward=False)
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=Ce.device)
    xTr, xTi = new(E, B, N), new(E, B, N)
    hr, hi = new(E, nt, B, N), new(E, nt, B, N)
    ksr = ksi = None
    if plan.store_iters and plan.iters > 0:
        ksr, ksi = new(E, nt, plan.iters, B, N), new(E, nt, plan.iters, B, N)
    err = _LIB.streamk_fwd_launch(
        *map(_ptr, (plan.Sr, plan.Si, Ce, x0r, x0i, plan.rows, xTr, xTi, hr,
                    hi, ksr, ksi)),
        *_dims(plan, E, nt, B, N), threads, smem,
        torch.cuda.current_stream(Ce.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"streamk_fwd launch failed: CUDA error {err}")
    streamk_fwd_launches += 1
    return xTr, xTi, hr, hi, ksr, ksi


def _kernel_bwd(plan, x0r, x0i, Ce, hr, hi, ksr, ksi, gTr, gTi, jr, ji):
    global streamk_bwd_launches
    _check_cuda(plan, x0r, x0i, Ce, hr, hi, gTr, gTi, jr, ji)
    E, nt, Ke = Ce.shape
    B, N = x0r.shape
    threads, smem = _launch_shape(plan, B, N, backward=True)
    g0r = torch.empty((E, B, N), dtype=torch.float32, device=Ce.device)
    g0i = torch.empty_like(g0r)
    Cb = torch.empty((E, nt, Ke), dtype=torch.float32, device=Ce.device)
    err = _LIB.streamk_bwd_launch(
        *map(_ptr, (plan.Sr, plan.Si, Ce, x0r, x0i, hr, hi, jr, ji, gTr, gTi,
                    plan.rows, ksr, ksi, g0r, g0i, Cb)),
        *_dims(plan, E, nt, B, N), threads, smem,
        torch.cuda.current_stream(Ce.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"streamk_bwd launch failed: CUDA error {err}")
    streamk_bwd_launches += 1
    return g0r.sum(0), g0i.sum(0), Cb


class _KernelFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, x0r, x0i, Ce):
        x0r, x0i, Ce = x0r.contiguous(), x0i.contiguous(), Ce.contiguous()
        xTr, xTi, hr, hi, ksr, ksi = _kernel_fwd(plan, x0r, x0i, Ce)
        ctx.plan = plan
        ctx.has_ks = ksr is not None
        saved = (x0r, x0i, Ce, hr, hi) + ((ksr, ksi) if ctx.has_ks else ())
        ctx.save_for_backward(*saved)
        return xTr, xTi, hr, hi

    @staticmethod
    def backward(ctx, gxTr, gxTi, ghr, ghi):
        x0r, x0i, Ce, hr, hi = ctx.saved_tensors[:5]
        ksr, ksi = ctx.saved_tensors[5:] if ctx.has_ks else (None, None)
        gr, gi, Cb = _kernel_bwd(
            ctx.plan, x0r, x0i, Ce, hr, hi, ksr, ksi,
            _zeros_if_none(gxTr, hr[:, -1]), _zeros_if_none(gxTi, hi[:, -1]),
            _zeros_if_none(ghr, hr), _zeros_if_none(ghi, hi))
        return None, gr, gi, Cb


def streamk_propagate_kernel(plan, x0r, x0i, Ce):
    """The CUDA kernel pair behind the same interface as
    streamk_propagate_plain (float32 CUDA tensors only)."""
    return _KernelFn.apply(plan, x0r, x0i, Ce)


def streamk_propagate(plan, x0r, x0i, Ce):
    """Device dispatch: the kernel pair for CUDA tensors, the plain version
    for CPU tensors."""
    if Ce.device.type == "cuda":
        return streamk_propagate_kernel(plan, x0r, x0i, Ce)
    if Ce.device.type == "cpu":
        return streamk_propagate_plain(plan, x0r, x0i, Ce)
    raise NotImplementedError(f"streamK has no path for {Ce.device}")


def make_plan(Sr, Si, dt: float, iters: int, gen_diag=None,
              linsolver: str = "neumann") -> StreamKPlan:
    """The launch plan for the (K, N, N) stack planes Sr, Si, on their
    device and in their dtype. Split appends the off-diagonal remainder's
    slot -diag(h), h = i * gen_diag the H diagonal, whose coefficient is 1
    (extend_coeffs). With iters <= 4 the forward stores its stage iterates
    for the backward; past that the backward replays them (the JAX
    kernel's rule)."""
    dt, iters = float(dt), int(iters)
    kw = dict(dtype=Sr.dtype, device=Sr.device)
    rows = torch.as_tensor(solver_rows(gen_diag, dt, linsolver), **kw)
    if linsolver == "split":
        h = 1j * np.asarray(gen_diag, dtype=np.complex128).reshape(-1)
        Sr = torch.cat([Sr, -torch.diag(torch.as_tensor(h.real, **kw))[None]])
        Si = torch.cat([Si, -torch.diag(torch.as_tensor(h.imag, **kw))[None]])
    return StreamKPlan(Sr=Sr.contiguous(), Si=Si.contiguous(),
                       rows=rows.contiguous(), dt=dt, iters=iters,
                       linsolver=linsolver, store_iters=iters <= 4)


def extend_coeffs(plan, C):
    """(E, ntime, K) coefficients -> the plan's (E, ntime, Ke) rows."""
    C = C.to(plan.Sr.dtype)
    if plan.linsolver == "split":
        C = torch.cat([C, C.new_ones(C.shape[:-1] + (1,))], dim=-1)
    return C.contiguous()


def make_streamk_propagate(dt: float, iters: int = 10, gen_diag=None,
                           linsolver: str = "neumann"):
    """Build propagate(Sr, Si, (x0r, x0i), C) -> ((xTr, xTi), (hr, hi)).

    Sr, Si: (K, N, N) real/imaginary operator stack; C: (ntime, K) or
    (E, ntime, K) coefficient rows. linsolver 'jacobi' and 'split' need
    gen_diag, the (N,) generator diagonal."""

    def propagate(Sr, Si, x0, C):
        plan = make_plan(Sr, Si, dt, iters, gen_diag, linsolver)
        Ce = extend_coeffs(plan, C if C.dim() == 3 else C[None])
        dt_ = plan.Sr.dtype
        xTr, xTi, hr, hi = streamk_propagate(plan, x0[0].to(dt_),
                                             x0[1].to(dt_), Ce)
        if C.dim() == 2:
            xTr, xTi, hr, hi = xTr[0], xTi[0], hr[0], hi[0]
        return (xTr, xTi), (hr, hi)

    return propagate
