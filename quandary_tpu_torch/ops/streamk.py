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
constants of the optimization, as in the JAX kernel, and the result is not
connected to Sr, Si in the autograd graph. The stream route
(ops/stream.py::make_stream_propagate) differentiates the stacks.

make_streamk_packed_propagate is the port of the packed TPU kernel
(pallas_stream.py:1059) in its argument layout, Cg (ntime, G, K) in and hist
(ntime, G, B, N) out. With ``per_block_stacks`` every candidate carries its
own operator stack, Sr/Si (G, K, N, N), and its own solver rows from
gen_diag (G, N): one launch propagates G realizations of the system. The
same CUDA kernels run it, reading each block's stack and rows at a
per-candidate stride; the plan then holds (G, Ke, N, N) stacks.

Device dispatch: a CUDA tensor goes to the kernel pair (built with nvcc at
first use, bound with ctypes); a CPU tensor goes to ``streamk_propagate_plain``,
the same function in plain torch with the hand-written transpose as its
backward, in any float dtype. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import numpy as np
import torch

from . import cuda_build

# launches of each kernel since the counters were last set to 0
streamk_fwd_launches = 0
streamk_bwd_launches = 0
streamk_packed_fwd_launches = 0
streamk_packed_bwd_launches = 0
_COUNTERS = ("streamk_fwd_launches", "streamk_bwd_launches",
             "streamk_packed_fwd_launches", "streamk_packed_bwd_launches")

_MODES = {"neumann": 0, "jacobi": 1, "split": 2}
_SRC = os.path.join(cuda_build.CSRC_DIR, "streamk.cu")
_MAX_SMEM = cuda_build.MAX_SMEM
_LIBS = cuda_build.LIBS     # the loaded libraries, one table for all sources


def launch_counts() -> dict:
    """The four launch counters by name."""
    return {k: globals()[k] for k in _COUNTERS}


def reset_launch_counts() -> None:
    for k in _COUNTERS:
        globals()[k] = 0


def add_launches(counts: dict, times: int = 1) -> None:
    """Add `times` x `counts` to the counters: the replay of a CUDA graph
    launches the kernels it captured without passing through the wrappers."""
    for k, v in counts.items():
        globals()[k] += times * v


def solver_rows(gen_diag, dt: float, linsolver: str) -> np.ndarray:
    """(nrows, N) f64 per-entry rows of the stage solver ((G, nrows, N) for
    a (G, N) gen_diag, one system per candidate), computed on the host:
    jacobi (d_r, d_i, minv_r, minv_i) with Minv = 1/(1 - (dt/2) d);
    split (e_r, e_i) with E = exp((dt/2) d); neumann none
    (pallas_stream.py:141-159)."""
    if linsolver not in _MODES:
        raise NotImplementedError(
            f"streamK supports neumann/jacobi/split, got {linsolver!r}")
    if linsolver == "neumann":
        return np.zeros((0, 0))
    if gen_diag is None:
        raise ValueError(f"streamK {linsolver} requires gen_diag")
    d = np.asarray(gen_diag, dtype=np.complex128)
    if d.ndim == 2:     # one diagonal per candidate: (G, nrows, N)
        return np.stack([solver_rows(dg, dt, linsolver) for dg in d])
    d = d.reshape(-1)
    if linsolver == "jacobi":
        m = 1.0 / (1.0 - 0.5 * dt * d)
        return np.stack([d.real, d.imag, m.real, m.imag])
    E = np.exp(0.5 * dt * d)
    return np.stack([E.real, E.imag])


@dataclasses.dataclass
class StreamKPlan:
    """Everything a launch needs besides x0 and the coefficients: the
    extended (Ke, N, N) stacks (split appends the -diag(h) slot), the
    solver rows (nrows, N), and the step constants. With one system per
    candidate the stacks are (G, Ke, N, N) and the rows (G, nrows, N)."""
    Sr: torch.Tensor
    Si: torch.Tensor
    rows: torch.Tensor
    dt: float
    iters: int
    linsolver: str
    store_iters: bool

    @property
    def Ke(self) -> int:
        return self.Sr.shape[-3]

    @property
    def per_block(self) -> bool:
        return self.Sr.dim() == 4


# ----------------------------------------------------------------------
# plain torch version (CPU path and the kernels' oracle)
# ----------------------------------------------------------------------

def _solver_parts(plan):
    """(jac, split) row tuples in the form _stage_fwd/_stage_bwd take."""
    if plan.linsolver == "neumann":
        return None, None
    # (N,) rows, or (G, 1, N) against the (G, B, N) states
    r = plan.rows.unsqueeze(-2).unbind(-3) if plan.per_block \
        else plan.rows.unbind(0)
    if plan.linsolver == "jacobi":
        return tuple(r), None
    return None, tuple(r)


def _planes(plan, Ce):
    """(E, nt, N, N) real and imaginary H planes."""
    if plan.per_block:
        _check_group(plan, Ce)
        return (torch.einsum("etk,ekpq->etpq", Ce, plan.Sr),
                torch.einsum("etk,ekpq->etpq", Ce, plan.Si))
    return (torch.tensordot(Ce, plan.Sr, dims=1),
            torch.tensordot(Ce, plan.Si, dims=1))


def _check_group(plan, Ce):
    if Ce.shape[0] != plan.Sr.shape[0]:
        raise ValueError(
            f"{Ce.shape[0]} coefficient candidates for a plan of "
            f"{plan.Sr.shape[0]} per-candidate stacks")


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


def plane_forward(Hr, Hi, x0r, x0i, *, dt, iters, jac, split):
    """Plain forward on given H planes (autograd-differentiable): planes
    (E, nt, N, N), x0 (B, N) -> hist pair (E, nt, B, N). jac / split are
    the solver rows of _stage_fwd."""
    E = Hr.shape[0]
    xr, xi = x0r.expand((E,) + x0r.shape), x0i.expand((E,) + x0i.shape)
    hr, hi = [], []
    for t in range(Hr.shape[1]):
        T, _ = _ops(Hr[:, t], Hi[:, t])
        xr, xi, _ = _stage_fwd(T, xr, xi, dt=dt, iters=iters, jac=jac,
                               split=split)
        hr.append(xr)
        hi.append(xi)
    return torch.stack(hr, dim=1), torch.stack(hi, dim=1)


def plane_backward(Hr, Hi, x0r, x0i, hr, hi, gTr, gTi, jr, ji, *, dt,
                   iters, jac, split):
    """Hand-written transpose of plane_forward: the final-state and history
    cotangents -> (x0 cotangent per candidate (E, B, N) pair, H-plane
    cotangent (E, nt, N, N) pair). The step's plane cotangent is
    Hb[p, q] = sum over its (cotangent c, input u) pairs of c[b, p] u[b, q]
    in complex form (pallas_stream.py:481-486)."""
    E, nt = Hr.shape[:2]
    gr, gi = gTr, gTi
    x0e = (x0r.expand((E,) + x0r.shape), x0i.expand((E,) + x0i.shape))
    Hb = [None] * nt
    for t in range(nt - 1, -1, -1):
        gr, gi = gr + jr[:, t], gi + ji[:, t]
        xpr, xpi = x0e if t == 0 else (hr[:, t - 1], hi[:, t - 1])
        T, Tt = _ops(Hr[:, t], Hi[:, t])
        pairs = []
        gr, gi = _stage_bwd(T, Tt, xpr, xpi, gr, gi, pairs, dt=dt,
                            iters=iters, jac=jac, split=split)
        # sum_pairs of the H-plane outer products as one block product
        cr, ci, ur, ui = (torch.cat(z, dim=-2) for z in zip(*pairs))
        cr, ci = cr.transpose(-1, -2), ci.transpose(-1, -2)
        Hb[t] = (cr @ ui - ci @ ur, cr @ ur + ci @ ui)
    Hbr = torch.stack([h[0] for h in Hb], dim=1)
    Hbi = torch.stack([h[1] for h in Hb], dim=1)
    return gr, gi, Hbr, Hbi


def plain_forward(plan, x0r, x0i, Ce):
    """Plain forward (autograd-differentiable): x0 (B, N), Ce (E, nt, Ke)
    -> hist pair (E, nt, B, N)."""
    jac, split = _solver_parts(plan)
    return plane_forward(*_planes(plan, Ce), x0r, x0i, dt=plan.dt,
                         iters=plan.iters, jac=jac, split=split)


def plain_backward(plan, x0r, x0i, Ce, hr, hi, gTr, gTi, jr, ji):
    """Hand-written transpose of plain_forward: the final-state and history
    cotangents -> (x0 cotangent (B, N) pair, coefficient cotangent
    (E, nt, Ke))."""
    jac, split = _solver_parts(plan)
    gr, gi, Hbr, Hbi = plane_backward(
        *_planes(plan, Ce), x0r, x0i, hr, hi, gTr, gTi, jr, ji, dt=plan.dt,
        iters=plan.iters, jac=jac, split=split)
    sub = "etpq,ekpq->etk" if plan.per_block else "etpq,kpq->etk"
    Cb = torch.einsum(sub, Hbr, plan.Sr) + torch.einsum(sub, Hbi, plan.Si)
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

def _bind(lib):
    p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    fwd = [p] * 12 + [i] * 8 + [f, f, i, i, p]
    bwd = [p] * 17 + [i] * 8 + [f, f, i, i, p]
    for name, args in (("streamk_fwd_launch", fwd),
                       ("streamk_bwd_launch", bwd),
                       ("streamk_packed_fwd_launch", fwd + [ll, ll]),
                       ("streamk_packed_bwd_launch", bwd + [ll, ll])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, i


def build_kernels(verbose: bool = False):
    """Compile csrc/streamk.cu (cuda_build.build_library) and load it, once
    per process. Returns (library path, build seconds, compiler output)."""
    return cuda_build.build_library(_SRC, _bind, verbose)


def size_refusal(B, N, Ke, iters):
    """Why one thread block cannot hold a candidate of B states of dimension
    N with Ke stack slots and `iters` stage iterations (a sentence naming
    the limit), or None when both kernels take it. Needs no stack. The
    backward's inline layout is the larger of the two kernels' least
    layouts."""
    BN = B * N
    if BN > 1024:
        return (f"streamK kernel: B*N = {BN} state entries exceed one block "
                "(1024 threads); multi-block candidates are not implemented")
    smem = _bwd_smem_bytes(Ke, iters, B, N, split=False)
    if smem > _MAX_SMEM:
        return (f"streamK kernel: {smem} bytes of shared memory exceed the "
                f"{_MAX_SMEM} a block can use (N={N}, Ke={Ke}, B={B}, "
                f"iters={iters})")
    return None


def launch_refusal(plan, B, N):
    """size_refusal of a plan's stack slots and iterations."""
    return size_refusal(B, N, plan.Ke, plan.iters)


def _threads(B, N):
    return max(32, -(-max(B * N, min(N * N, 1024)) // 32) * 32)


def _fwd_smem_bytes(Ke, B, N, split: bool):
    """csrc/streamk.cu fwd_floats, in bytes: the stacks, per slot (two with
    helper warps, one inline) the H planes and a coefficient row, and the
    two (B, N) slots of the matvec inputs."""
    BN, NN, slots = B * N, N * N, 2 if split else 1
    return 4 * (2 * Ke * NN + slots * (2 * N * (N + 1) + Ke) + 4 * BN)


def _bwd_smem_bytes(Ke, it, B, N, split: bool):
    """csrc/streamk.cu bwd_floats, in bytes: the stacks, per slot (two with
    helper warps, one inline) the H planes and the step's pairs, Hb, and
    per slot a coefficient row."""
    BN, NN, slots = B * N, N * N, 2 if split else 1
    return 4 * (2 * Ke * NN + slots * (2 * N * (N + 1) + (4 * it + 4) * BN
                                       + Ke) + 2 * NN)


def _role_shape(B, N, smem_bytes):
    """(threads, shared-memory bytes, helpers) of a launch: the state warps
    (one thread per state entry) and one helper thread for two entries of H
    (and of Hb), with two slots of each ring, where that fits one block;
    else the inline layout on _threads(B, N) (helpers 0). smem_bytes(split)
    is the kernel's layout."""
    S = -(-B * N // 32) * 32
    helpers = min(1024 - S, 32 * -(-N * N // 64))
    smem = smem_bytes(True)
    if helpers >= 32 and smem <= _MAX_SMEM:
        return S + helpers, smem, helpers
    return _threads(B, N), smem_bytes(False), 0


def _fwd_shape(Ke, it, B, N):
    """_role_shape of a forward launch (its layout does not depend on the
    iterations `it`: the stage iterates take turns in two slots)."""
    return _role_shape(B, N, lambda split: _fwd_smem_bytes(Ke, B, N, split))


def _bwd_shape(Ke, it, B, N):
    """_role_shape of a backward launch."""
    return _role_shape(B, N,
                       lambda split: _bwd_smem_bytes(Ke, it, B, N, split))


def _launch_shape(plan, B, N, backward: bool):
    """(threads per block, dynamic shared-memory bytes) of one launch; raises
    NotImplementedError past what one block can hold (the backward's inline
    layout needs more than the forward's, so both refuse together)."""
    why = launch_refusal(plan, B, N)
    if why is not None:
        raise NotImplementedError(why)
    shape = _bwd_shape if backward else _fwd_shape
    return shape(plan.Ke, plan.iters, B, N)[:2]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_cuda(plan, Ce, *ts):
    if plan.per_block:
        _check_group(plan, Ce)
    for t in (plan.Sr, plan.Si, plan.rows, Ce) + ts:
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise NotImplementedError(
                "streamK kernel runs float32 CUDA tensors only (complex128 "
                f"is not ported to the GPU); got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("streamK kernel needs contiguous tensors")


def _dims(plan, E, nt, B, N):
    return (E, nt, B, N, plan.Ke, plan.iters, _MODES[plan.linsolver],
            int(plan.store_iters), plan.dt, plan.dt / 2.0)


def _strides(plan):
    """The packed launchers' trailing arguments: floats between two
    candidates' stacks and solver rows."""
    return (plan.Sr.stride(0), plan.rows.stride(0)) if plan.per_block else ()


def _lib():
    return cuda_build.library(_SRC, _bind)


def _kernel_fwd(plan, x0r, x0i, Ce):
    global streamk_fwd_launches, streamk_packed_fwd_launches
    _check_cuda(plan, Ce, x0r, x0i)
    lib = _lib()
    launch = lib.streamk_packed_fwd_launch if plan.per_block \
        else lib.streamk_fwd_launch
    E, nt, _ = Ce.shape
    B, N = x0r.shape
    threads, smem = _launch_shape(plan, B, N, backward=False)
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=Ce.device)
    xTr, xTi = new(E, B, N), new(E, B, N)
    hr, hi = new(E, nt, B, N), new(E, nt, B, N)
    ksr = ksi = None
    if plan.store_iters and plan.iters > 0:
        ksr, ksi = new(E, nt, plan.iters, B, N), new(E, nt, plan.iters, B, N)
    err = launch(
        *map(_ptr, (plan.Sr, plan.Si, Ce, x0r, x0i, plan.rows, xTr, xTi, hr,
                    hi, ksr, ksi)),
        *_dims(plan, E, nt, B, N), threads, smem,
        torch.cuda.current_stream(Ce.device).cuda_stream, *_strides(plan))
    if err != 0:
        raise RuntimeError(f"streamk_fwd launch failed: CUDA error {err}")
    if plan.per_block:
        streamk_packed_fwd_launches += 1
    else:
        streamk_fwd_launches += 1
    return xTr, xTi, hr, hi, ksr, ksi


def _kernel_bwd(plan, x0r, x0i, Ce, hr, hi, ksr, ksi, gTr, gTi, jr, ji):
    global streamk_bwd_launches, streamk_packed_bwd_launches
    _check_cuda(plan, Ce, x0r, x0i, hr, hi, gTr, gTi, jr, ji)
    lib = _lib()
    launch = lib.streamk_packed_bwd_launch if plan.per_block \
        else lib.streamk_bwd_launch
    E, nt, Ke = Ce.shape
    B, N = x0r.shape
    threads, smem = _launch_shape(plan, B, N, backward=True)
    g0r = torch.empty((E, B, N), dtype=torch.float32, device=Ce.device)
    g0i = torch.empty_like(g0r)
    Cb = torch.empty((E, nt, Ke), dtype=torch.float32, device=Ce.device)
    err = launch(
        *map(_ptr, (plan.Sr, plan.Si, Ce, x0r, x0i, hr, hi, jr, ji, gTr, gTi,
                    plan.rows, ksr, ksi, g0r, g0i, Cb)),
        *_dims(plan, E, nt, B, N), threads, smem,
        torch.cuda.current_stream(Ce.device).cuda_stream, *_strides(plan))
    if err != 0:
        raise RuntimeError(f"streamk_bwd launch failed: CUDA error {err}")
    if plan.per_block:
        streamk_packed_bwd_launches += 1
    else:
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
    device and in their dtype; (G, K, N, N) planes with a (G, N) gen_diag
    plan one system per candidate. Split appends the off-diagonal
    remainder's slot -diag(h), h = i * gen_diag the H diagonal (each
    candidate's own), whose coefficient is 1 (extend_coeffs). With
    iters <= 4 the forward stores its stage iterates for the backward; past
    that the backward replays them (the JAX kernel's rule)."""
    dt, iters = float(dt), int(iters)
    kw = dict(dtype=Sr.dtype, device=Sr.device)
    if gen_diag is not None:
        gen_diag = np.asarray(gen_diag, dtype=np.complex128)
        want = (Sr.shape[0], Sr.shape[-1]) if Sr.dim() == 4 \
            else (Sr.shape[-1],)
        if Sr.dim() == 3:
            gen_diag = gen_diag.reshape(-1)
        if gen_diag.shape != want:
            raise ValueError(f"gen_diag must have shape {want} for stacks "
                             f"{tuple(Sr.shape)}, got {gen_diag.shape}")
    rows = torch.as_tensor(solver_rows(gen_diag, dt, linsolver), **kw)
    if linsolver == "split":
        h = 1j * gen_diag
        slot = lambda a: -torch.diag_embed(torch.as_tensor(a, **kw))
        Sr = torch.cat([Sr, slot(h.real).unsqueeze(-3)], dim=-3)
        Si = torch.cat([Si, slot(h.imag).unsqueeze(-3)], dim=-3)
    return StreamKPlan(Sr=Sr.contiguous(), Si=Si.contiguous(),
                       rows=rows.contiguous(), dt=dt, iters=iters,
                       linsolver=linsolver, store_iters=iters <= 4)


def lindblad_prime_stack(stack, Ls):
    """(K, N^2, N^2) pseudo-Hamiltonian stack H' such that the streamK
    kernels, which integrate dv/dt = -i H'(c) v, propagate the VECTORIZED
    Lindblad equation: with the column-major vec(rho) generator
    L(c) = -i A + i conj(B) + jump, set H' = i L, i.e. per slot
    H'_j = I (x) O_j - conj(O_j) (x) I and slot 0 += i * sum_l conj(L_l)
    (x) L_l. H' is NOT Hermitian (dissipation); the kernels never assume
    Hermiticity (the backward applies the exact real transpose)."""
    stack = np.asarray(stack)
    K, N, _ = stack.shape
    eye = np.eye(N)
    Hp = np.stack([np.kron(eye, O) - np.kron(np.conj(O), eye)
                   for O in stack]).astype(np.complex128)
    if Ls is not None:
        Hp[0] += 1j * sum(np.kron(np.conj(np.asarray(L)), np.asarray(L))
                          for L in Ls)
    return Hp.astype(stack.dtype)


def extend_coeffs(plan, C):
    """(E, ntime, K) coefficients -> the plan's (E, ntime, Ke) rows."""
    C = C.to(plan.Sr.dtype)
    if plan.linsolver == "split":
        C = torch.cat([C, C.new_ones(C.shape[:-1] + (1,))], dim=-1)
    return C.contiguous()


def _plan_once(dt, iters, gen_diag, linsolver):
    """plan_for(Sr, Si): make_plan, built anew only when other stack tensors
    arrive, so a propagate called in a loop does its host work (the solver
    rows and their copy to the device) once."""
    held = []

    def plan_for(Sr, Si):
        if not held or held[0] is not Sr or held[1] is not Si:
            held[:] = [Sr, Si, make_plan(Sr, Si, dt, iters, gen_diag,
                                         linsolver)]
        return held[2]

    return plan_for


def make_streamk_propagate(dt: float, iters: int = 10, gen_diag=None,
                           linsolver: str = "neumann"):
    """Build propagate(Sr, Si, (x0r, x0i), C) -> ((xTr, xTi), (hr, hi)).

    Sr, Si: (K, N, N) real/imaginary operator stack; C: (ntime, K) or
    (E, ntime, K) coefficient rows. linsolver 'jacobi' and 'split' need
    gen_diag, the (N,) generator diagonal."""
    plan_for = _plan_once(dt, iters, gen_diag, linsolver)

    def propagate(Sr, Si, x0, C):
        plan = plan_for(Sr, Si)
        Ce = extend_coeffs(plan, C if C.dim() == 3 else C[None])
        dt_ = plan.Sr.dtype
        xTr, xTi, hr, hi = streamk_propagate(plan, x0[0].to(dt_),
                                             x0[1].to(dt_), Ce)
        if C.dim() == 2:
            xTr, xTi, hr, hi = xTr[0], xTi[0], hr[0], hi[0]
        return (xTr, xTi), (hr, hi)

    return propagate


def make_streamk_packed_propagate(dt: float, iters: int = 10, gen_diag=None,
                                  linsolver: str = "neumann", group=None,
                                  per_block_stacks: bool = False):
    """Build propagate(Sr, Si, (x0r, x0i), Cg) -> ((xTr, xTi), (hr, hi)) in
    the layout of the packed TPU kernel: Cg (ntime, G, K), one coefficient
    row per candidate, x0 (B, N) shared by the group, xT (G, B, N), hist
    (ntime, G, B, N) (a view of the kernels' (G, ntime, B, N)).

    per_block_stacks: Sr, Si are (G, K, N, N) and gen_diag (G, N), one
    system realization per candidate. Otherwise Sr, Si are (K, N, N) and
    the G candidates share them. `group`, when given, must equal G."""
    plan_for = _plan_once(dt, iters, gen_diag, linsolver)

    def propagate(Sr, Si, x0, Cg):
        if Sr.dim() != (4 if per_block_stacks else 3):
            raise ValueError(
                f"stacks of shape {tuple(Sr.shape)} with "
                f"per_block_stacks={per_block_stacks}")
        G = Cg.shape[1]
        if group is not None and int(group) != G:
            raise ValueError(f"group={group} != {G} coefficient candidates")
        plan = plan_for(Sr, Si)
        Ce = extend_coeffs(plan, Cg.transpose(0, 1))
        dt_ = plan.Sr.dtype
        xTr, xTi, hr, hi = streamk_propagate(plan, x0[0].to(dt_),
                                             x0[1].to(dt_), Ce)
        return (xTr, xTi), (hr.transpose(0, 1), hi.transpose(0, 1))

    return propagate
