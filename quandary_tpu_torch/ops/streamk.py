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

Two CUDA kernel pairs compute the contract. csrc/streamk.cu holds a
candidate in one thread block (``size_refusal``: B*N <= 1024 state entries
and the stacks in shared memory, N <= 52 at the flagship's Ke).
csrc/streamk_mid.cu runs a plan past that (launched by ops/streamk_mid.py):
a thread-block cluster of G CTAs per (candidate, chunk of basis states),
each CTA on a band of the state entries (``_mid_shape`` plans the launch,
``fwd_schedule`` and ``bwd_schedule`` each direction's schedule,
``mid_refusal`` says what it does not take). Both pairs run shared-stack
and per-block plans, closed systems and open ones on the superop route
(dimension N^2). ``route_refusal`` admits what either pair takes and
refuses only on device memory.

Device dispatch: a CUDA tensor goes to a kernel pair (built with nvcc at
first use, bound with ctypes): the one-block pair wherever size_refusal
admits the plan, else the mid pair. A CPU tensor goes to
``streamk_propagate_plain``, the same function in plain torch with the
hand-written transpose as its backward, in any float dtype. There is no
fallback from one to another.
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
    """The four launch counters by name (the mid pair's are in
    ops/streamk_mid.py)."""
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
                "(1024 threads); the mid pair (ops/streamk_mid.py) takes "
                "plans past it")
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


def stack_strides(plan):
    """Floats between two candidates' stacks and solver rows: a per-block
    plan's, or (0, 0) for a shared stack (and rows with no entries)."""
    if not plan.per_block:
        return 0, 0
    return plan.Sr.stride(0), plan.rows.stride(0) if plan.rows.numel() else 0


def _strides(plan):
    """The packed launchers' trailing arguments."""
    return stack_strides(plan) if plan.per_block else ()


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


# ----------------------------------------------------------------------
# mid-size kernel pair (csrc/streamk_mid.cu, launched by ops/streamk_mid.py):
# a cluster per (candidate, chunk of basis states), a band of state entries
# per CTA. Its planner and gates; the one-block pair's above.
# ----------------------------------------------------------------------

MID_CLUSTERS = (1, 2, 4, 8, 16)     # CTAs per cluster the kernels take
MID_CHUNKS = (8, 4, 2, 1)           # basis states per cluster (instances)
MID_MIN_ROWS = 16                   # the planner's least band when it widens
MID_SMS = 132                       # SMs of an H100 SXM
MID_KG = 8                          # csrc/streamk_mid.cu's C-bar group
# what a sweep's own device tensors may take (the card has 80 GB)
DEVICE_BUDGET_BYTES = 60 << 30


def _mid_band_floats(N, R, backward, replay):
    """csrc/streamk_mid.cu mid_band_floats: a CTA's bands of H."""
    row, col = 2 * R * N, 2 * R * (N + 1)
    return col + (row if replay else 0) if backward else row


def _mid_floats(bc, N, R, it, backward, replay, hsmem):
    """csrc/streamk_mid.cu mid_fwd_floats / mid_bwd_floats: a CTA's shared
    memory in floats, with the bands of H (hsmem) or without."""
    bands = _mid_band_floats(N, R, backward, replay) if hsmem else 0
    if not backward:
        return 4 * bc * N + 6 * bc * R + 4 * R + bands
    return (2 * (it + 1) * bc * N + (4 * bc * N if replay else 0)
            + 2 * (it + 1) * bc * R + (10 if replay else 6) * bc * R + 4 * R
            + 16 * MID_KG + bands)


def cluster_shape(E, B, N, floats, max_slots=1, slots=None):
    """The cluster plan of both mid pairs (this module's and ops/stream.py's;
    csrc/mid_cluster.cuh): (G, Bc, slots, threads, shared-memory bytes) of
    one launch of E candidates of B states of dimension N, or None where
    nothing fits a CTA. floats(G, bc, slots) gives a CTA's shared memory in
    floats with `slots` band slots of H in it (0: the bands in device
    memory, the 'global' layout). Bands of R = ceil(N / G) entries cover N
    (the last ragged, none empty) and chunks of Bc states cover B (the last
    ragged). The bands go to shared memory at the least G, and for it the
    most Bc, where one slot fits; the cluster then widens (more SMs on each
    stage) while the launch's CTAs fill at most the card's SMs and a band
    keeps MID_MIN_ROWS rows, and takes the most slots up to max_slots that
    fit at that G. Where no G fits one slot: no slot, at the widest G.
    `slots` forces a count (0: at the G the planner would give the bands in
    shared memory, where there is one), or gives None where it does not
    fit. Threads: a warp per band row, 4 to 16 warps (at most 512)."""
    bc_max = min(MID_CHUNKS[0], 1 << max(B - 1, 0).bit_length())
    chunks = [c for c in MID_CHUNKS if c <= bc_max]
    gs = [G for G in MID_CLUSTERS if (G - 1) * -(-N // G) < N]
    fits = lambda G, bc, n: 4 * floats(G, bc, n) <= _MAX_SMEM
    pick = next(((G, bc) for G in gs for bc in chunks if fits(G, bc, 1)),
                None)
    if pick is None:
        if slots:
            return None
        G, slots = gs[-1], 0
    else:
        G, bc = pick
        ctas = E * -(-B // bc)
        while (2 * G in gs and ctas * 2 * G <= MID_SMS
               and -(-N // (2 * G)) >= MID_MIN_ROWS and fits(2 * G, bc, 1)):
            G *= 2
        if slots is None:
            slots = max(n for n in range(1, max_slots + 1) if fits(G, bc, n))
        elif slots and not fits(G, bc, slots):
            return None
    if slots == 0:
        bc = next((c for c in chunks if fits(G, c, 0)), None)
        if bc is None:
            return None
    threads = 32 * max(4, min(16, -(-N // G)))
    return G, bc, slots, threads, 4 * floats(G, bc, slots)


def _mid_shape(E, B, N, Ke, iters, store, backward=False):
    """(G, Bc, threads, shared-memory bytes, layout) of one mid launch
    (cluster_shape), or None where no layout fits a CTA. Layout 'smem': the
    bands of H in shared memory; 'global': no G fits them, so they go to
    device-memory scratch at the widest G."""
    replay = backward and not store and iters > 0
    shape = cluster_shape(E, B, N, lambda G, bc, slots: _mid_floats(
        bc, N, -(-N // G), iters, backward, replay, slots > 0))
    if shape is None:
        return None
    G, bc, slots, threads, smem = shape
    return G, bc, threads, smem, "smem" if slots else "global"


# The backward's 'helpers' schedule (csrc/streamk_mid.cu
# streamk_mid_bwd_helpers): each step's column pass (Hb, C-bar, the next
# bands of H) off the chain, cut in tiles of the whole matrix that helper
# clusters (and the chain's own CTAs where no helper is there) claim.
MID_TILE = (32, 64)                 # a pass tile: rows x columns
MID_MAX_HELPERS = 8                 # helper clusters per chain cluster
MID_SCHEDULES = ("helpers", "chain")


def _split_ldr(N):
    """Row stride of the helpers schedule's rings: N rounded up to 4."""
    return -(-N // 4) * 4


def _tile_floats(bc, it, pairs=True):
    """csrc/streamk_mid.cu tile_floats: a pass tile's scratch, with room for
    the step's it + 1 pairs (the backward's) or for none (the forward's)."""
    P, Q = MID_TILE
    return (2 * Q * (P + 1) + 16 * MID_KG
            + ((it + 1) * bc * 2 * (P + Q) if pairs else 0))


def _split_floats(bc, N, R, it, replay, stored, hsmem):
    """csrc/streamk_mid.cu mid_split_floats: the helpers schedule's shared
    memory in floats, with the step's bands of H in it (hsmem) or not."""
    head = (8 + 2 * (it + 1) * bc * N + (4 * bc * N if replay else 0)
            + (10 if replay else 6) * bc * R + 4 * R
            + 2 * (4 + 2 * (it if stored else 0)) * bc * R)
    band = 2 * R * _split_ldr(N) * (2 if replay else 1) if hsmem else 0
    return -(-head // 4) * 4 + max(band, _tile_floats(bc, it))


def split_tiles(N):
    """(tiles of a pass, tiles across a row) of the helpers schedule."""
    P, Q = MID_TILE
    tq = -(-N // Q)
    return -(-N // P) * tq, tq


def _split_ring_floats(bc, N, it, replay):
    """csrc/streamk_mid.cu split_ring_floats: a group's two slots of H
    (transposed, and row-major with replay) and two of the step's pairs."""
    ldr = _split_ldr(N)
    return (2 * (2 if replay else 1) * 2 * N * ldr
            + 2 * (it + 1) * 4 * bc * N)


def _mid_bwd_shape(E, B, N, Ke, iters, store, schedule):
    """(G, Bc, threads, shared-memory bytes, layout) of the backward on a
    schedule, or None where no layout fits a CTA: 'chain' is _mid_shape's;
    'helpers' plans G and Bc by cluster_shape on the larger of its stored
    and replayed layouts, so that both iterate modes take one G and Bc (and
    C-bar, summed per chunk of Bc states, keeps its bits between them), and
    the layout by the mode's own: 'smem' where each step's bands of H fit
    shared memory beside the rest (copied in), else 'global' (read from the
    ring)."""
    if schedule == "chain":
        return _mid_shape(E, B, N, Ke, iters, store, True)
    floats = lambda G, bc, replay, stored, bands: _split_floats(
        bc, N, -(-N // G), iters, replay, stored, bands)
    shape = cluster_shape(E, B, N, lambda G, bc, slots: max(
        floats(G, bc, iters > 0, False, slots > 0),
        floats(G, bc, False, iters > 0, slots > 0)))
    if shape is None:
        return None
    G, bc, _, threads, _ = shape
    replay, stored = not store and iters > 0, store and iters > 0
    hsmem = 4 * floats(G, bc, replay, stored, True) <= _MAX_SMEM
    return (G, bc, threads, 4 * floats(G, bc, replay, stored, hsmem),
            "smem" if hsmem else "global")


def history_bytes(E, B, N, iters, nt, store):
    """Device bytes of a sweep's history (E, nt, B, N) pair, its cotangent
    and, where the forward stores them, the stage iterates."""
    hist = 2 * E * nt * B * N * 4
    return 2 * hist + (iters * hist if store and iters > 0 else 0)


def _fwd_scratch_bytes(E, B, N, Ke, iters, nt, store, schedule):
    """Device bytes of the mid forward's own scratch on a schedule: 'chain'
    its bands in the global layout; 'helpers' the groups' rings of H and
    counters."""
    shape = _mid_fwd_shape(E, B, N, Ke, iters, store, schedule)
    if shape is None:
        return 0
    G, bc, _, _, layout = shape
    groups = E * -(-B // bc)
    if schedule == "helpers":
        return 4 * (1 + groups * (_fwd_ring_floats(N) + 3 * nt))
    if layout == "global":
        return 4 * groups * G * _mid_band_floats(N, -(-N // G), False, False)
    return 0


def _scratch_bytes(E, B, N, Ke, iters, nt, store, schedule, fwd="chain"):
    """Device bytes of the mid pair's own scratch, the larger direction's:
    the forward's on its schedule `fwd` (_fwd_scratch_bytes); the
    backward's on its `schedule`: 'chain' the C-bar partial rows per CTA
    and its bands in the global layout, 'helpers' the groups' rings,
    counters and the tiles' C-bar rows."""
    extra = _fwd_scratch_bytes(E, B, N, Ke, iters, nt, store, fwd)
    shape = _mid_bwd_shape(E, B, N, Ke, iters, store, schedule)
    if shape is None:
        return extra
    G, bc, _, _, layout = shape
    groups = E * -(-B // bc)
    replay = not store and iters > 0
    if schedule == "helpers":
        more = 4 * (1 + groups * (_split_ring_floats(bc, N, iters, replay)
                                  + 3 * nt + 4
                                  + split_tiles(N)[0] * nt * Ke))
    else:
        more = groups * G * nt * Ke * 4
        if layout == "global":
            more += 4 * groups * G * _mid_band_floats(N, -(-N // G), True,
                                                      replay)
    return max(extra, more)


def _sweep_total(E, B, N, Ke, iters, nt, store, mid, per_block, schedule,
                 fwd="chain"):
    total = history_bytes(E, B, N, iters, nt, store)
    if per_block:
        total += 2 * E * Ke * N * N * 4
    if mid:
        total += _scratch_bytes(E, B, N, Ke, iters, nt, store, schedule, fwd)
    return total


def helpers_fit(E, B, N, Ke, iters, nt, store, per_block=False):
    """Whether the 'helpers' schedule can run: its layout fits a CTA, its
    chain clusters take at most half the card's SMs (MID_SMS), so that
    helpers have SMs to run on, and its rings keep the sweep within
    DEVICE_BUDGET_BYTES."""
    shape = _mid_bwd_shape(E, B, N, Ke, iters, store, "helpers")
    return (shape is not None
            and 2 * E * -(-B // shape[1]) * shape[0] <= MID_SMS
            and _sweep_total(E, B, N, Ke, iters, nt, store, True, per_block,
                             "helpers") <= DEVICE_BUDGET_BYTES)


def helpers_smem(E, B, N, Ke, iters):
    """Shared-memory bytes of the helpers schedule's launch in the larger
    of its two iterate modes (one G and Bc for both): the card's count of
    clusters at this size decides the schedule for both modes alike."""
    return max(_mid_bwd_shape(E, B, N, Ke, iters, store, "helpers")[3]
               for store in (True, False))


def bwd_schedule(E, B, N, Ke, iters, nt, store, per_block=False,
                 forced=None, holds=None):
    """The mid backward's schedule (_pick_schedule on helpers_fit and
    _mid_bwd_shape; `holds` counted at helpers_smem): 'helpers' where it
    fits and the card holds a helper cluster per chain cluster beside
    them, else 'chain' (the card is full: each cluster runs its pass in
    its chain). Stored and replayed iterates of one size take one
    schedule."""
    return _pick_schedule(
        "bwd", lambda s: _mid_bwd_shape(E, B, N, Ke, iters, store, s),
        lambda: helpers_fit(E, B, N, Ke, iters, nt, store, per_block),
        E, B, N, forced, holds)


def _pick_schedule(direction, shape, fits, E, B, N, forced, holds):
    """A mid direction's schedule: `forced` as it is where its layout
    (`shape(schedule)`) fits (the card tests and scripts compare them), one
    that does not raising ValueError; else 'helpers' where `fits()` and the
    card holds at least one helper cluster per chain cluster beside them
    (`holds`: clusters of the helpers launch's shape the card holds at
    once; None reads no card), else 'chain'."""
    if forced is not None:
        if forced not in MID_SCHEDULES or shape(forced) is None:
            raise ValueError(f"streamk_mid_{direction}: schedule {forced!r} "
                             f"does not fit (N = {N}, B = {B}, E = {E})")
        return forced
    if not fits():
        return "chain"
    if holds is not None:
        G, bc = shape("helpers")[:2]
        groups = E * -(-B // bc)
        if helper_clusters(groups, groups * G, holds) < 1:
            return "chain"
    return "helpers"


def helper_clusters(clusters, ctas, holds):
    """Helper clusters per chain cluster of the 'helpers' schedule: as many
    as the SMs the launch's `clusters` chain clusters (`ctas` CTAs) leave
    idle, at most MID_MAX_HELPERS, and no more than the card holds beside
    them (`holds` clusters of the launch shape at once); 0 where none fits
    (the chain's CTAs then run every tile themselves)."""
    h = min(MID_MAX_HELPERS, MID_SMS // ctas - 1)
    return max(0, min(h, holds // clusters - 1))


# The forward's 'helpers' schedule (csrc/streamk_mid.cu
# streamk_mid_fwd_helpers): each step's contraction of H(t) off the chain,
# cut in the backward's pass tiles of the whole matrix, which helper
# clusters (and the chain's own CTAs, for any tile no helper took) contract
# into a ring of MID_FWD_SLOTS steps of H in device memory, ahead of the
# chain. It wins wherever a helper cluster per chain cluster fits, down to
# N = 64, and loses where none does (PERF.md section 6), which is the rule
# fwd_schedule applies.
MID_FWD_SLOTS = 3


def _fwd_ring_floats(N):
    """csrc/streamk_mid.cu fwd_ring_floats: a group's ring of H, its slots
    row-major (re, then im) at row stride _split_ldr(N)."""
    return MID_FWD_SLOTS * 2 * N * _split_ldr(N)


def _fwd_split_floats(bc, N, R, hsmem):
    """csrc/streamk_mid.cu mid_fwd_split_floats: the forward helpers
    schedule's shared memory in floats, with the step's row band of H in it
    (hsmem) or not."""
    head = 8 + 4 * bc * N + 6 * bc * R + 4 * R
    band = 2 * R * _split_ldr(N) if hsmem else 0
    return -(-head // 4) * 4 + max(band, _tile_floats(bc, 0, pairs=False))


def _mid_fwd_shape(E, B, N, Ke, iters, store, schedule):
    """(G, Bc, threads, shared-memory bytes, layout) of the forward on a
    schedule, or None where no layout fits a CTA: 'chain' is _mid_shape's;
    'helpers' plans by cluster_shape on its own layout: 'smem' where the
    step's row band fits shared memory beside the rest (copied in from the
    ring), else 'global' (read from the ring). The forward's bits do not
    depend on G or Bc (every product runs over the whole operand)."""
    if schedule == "chain":
        return _mid_shape(E, B, N, Ke, iters, store)
    shape = cluster_shape(E, B, N, lambda G, bc, slots: _fwd_split_floats(
        bc, N, -(-N // G), slots > 0))
    if shape is None:
        return None
    G, bc, slots, threads, smem = shape
    return G, bc, threads, smem, "smem" if slots else "global"


def fwd_helpers_fit(E, B, N, Ke, iters, nt, store, per_block=False):
    """Whether the forward's 'helpers' schedule can run: its layout fits a
    CTA, its chain clusters take at most half the card's SMs (MID_SMS), so
    that helpers have SMs to run on, and its rings keep the sweep within
    DEVICE_BUDGET_BYTES."""
    shape = _mid_fwd_shape(E, B, N, Ke, iters, store, "helpers")
    return (shape is not None
            and 2 * E * -(-B // shape[1]) * shape[0] <= MID_SMS
            and _sweep_total(E, B, N, Ke, iters, nt, store, True, per_block,
                             "chain", "helpers") <= DEVICE_BUDGET_BYTES)


def fwd_schedule(E, B, N, Ke, iters, nt, store, per_block=False,
                 forced=None, holds=None):
    """The mid forward's schedule (_pick_schedule on fwd_helpers_fit and
    _mid_fwd_shape): 'helpers' where it fits and the card holds a helper
    cluster per chain cluster beside them, else 'chain' (each cluster
    contracts its row band in its chain)."""
    return _pick_schedule(
        "fwd", lambda s: _mid_fwd_shape(E, B, N, Ke, iters, store, s),
        lambda: fwd_helpers_fit(E, B, N, Ke, iters, nt, store, per_block),
        E, B, N, forced, holds)


def sweep_bytes(E, B, N, Ke, iters, nt, store, mid, per_block=False):
    """Device bytes of one sweep's own tensors: the history and its
    cotangent, the stored stage iterates, with per_block the E candidates'
    own (Ke, N, N) stack pairs and, on the mid pair, its scratch on each
    direction's schedule: the most of 'chain' (the C-bar partial rows and
    bands) and, where helpers_fit / fwd_helpers_fit, 'helpers' (their
    rings), which the card's count of clusters chooses between at
    launch."""
    bwd, fwd = ("chain",), ("chain",)
    if mid and helpers_fit(E, B, N, Ke, iters, nt, store, per_block):
        bwd += ("helpers",)
    if mid and fwd_helpers_fit(E, B, N, Ke, iters, nt, store, per_block):
        fwd += ("helpers",)
    return max(_sweep_total(E, B, N, Ke, iters, nt, store, mid, per_block,
                            b, f) for b in bwd for f in fwd)


def mid_refusal(E, B, N, Ke, iters, nt, store, per_block=False):
    """Why the mid pair does not take E candidates of B states of dimension
    N (a sentence naming the limit), or None: no layout of a direction fits
    a CTA's shared memory, or the sweep's tensors pass
    DEVICE_BUDGET_BYTES. per_block: one stack per candidate (a packed plan
    of per-sample stacks), whose stacks count against the budget."""
    for backward in (False, True):
        if _mid_shape(E, B, N, Ke, iters, store, backward) is None:
            which = "backward" if backward else "forward"
            return (f"streamK mid kernels: the {which}'s operand and stage "
                    f"buffers at N = {N} and "
                    f"iters = {iters} exceed the {_MAX_SMEM} bytes of "
                    "shared memory a CTA can use")
    need = sweep_bytes(E, B, N, Ke, iters, nt, store, mid=True,
                       per_block=per_block)
    if need > DEVICE_BUDGET_BYTES:
        what = ", scratch and per-candidate stacks" if per_block \
            else " and scratch"
        return (f"streamK mid kernels: a sweep's history, cotangents, stored "
                f"iterates{what} take {need} bytes of device memory, "
                f"past DEVICE_BUDGET_BYTES = {DEVICE_BUDGET_BYTES} (E = {E}, "
                f"ntime = {nt}, B = {B}, N = {N})")
    return None


def route_refusal(B, N, Ke, iters, nt, E=1, store=None, per_block=False):
    """Why neither kernel pair takes a plan (a sentence naming the bytes),
    or None: the one-block pair where size_refusal admits it, else the mid
    pair; both refuse only on device memory (the history, its cotangent,
    the stored iterates and, with per_block, the E candidates' own stacks,
    against DEVICE_BUDGET_BYTES). store: whether the forward stores its
    stage iterates (the plan's store_iters; default iters <= 4). The same
    gate holds closed systems, open ones on the superop route (N the
    dimension N^2) and packed plans of per-sample stacks (E the samples)."""
    store = iters <= 4 if store is None else bool(store)
    if size_refusal(B, N, Ke, iters) is not None:
        return mid_refusal(E, B, N, Ke, iters, nt, store, per_block)
    need = sweep_bytes(E, B, N, Ke, iters, nt, store, mid=False,
                       per_block=per_block)
    if need > DEVICE_BUDGET_BYTES:
        return (f"streamK kernel: a sweep's history, cotangents and stored "
                f"iterates take {need} bytes of device memory, past "
                f"DEVICE_BUDGET_BYTES = {DEVICE_BUDGET_BYTES}")
    return None


def _pair(mid):
    """(forward, backward) launch wrappers of one kernel pair: the one-block
    pair's, or the mid pair's (ops/streamk_mid.py, which imports this
    module)."""
    if not mid:
        return _kernel_fwd, _kernel_bwd
    from . import streamk_mid
    return streamk_mid._kernel_fwd, streamk_mid._kernel_bwd


class _KernelFn(torch.autograd.Function):
    """One kernel pair's launches as a differentiable function: the
    one-block pair, or with `mid` the mid pair."""

    @staticmethod
    def forward(ctx, plan, mid, x0r, x0i, Ce):
        x0r, x0i, Ce = x0r.contiguous(), x0i.contiguous(), Ce.contiguous()
        fwd = _pair(mid)[0]
        xTr, xTi, hr, hi, ksr, ksi = fwd(plan, x0r, x0i, Ce)
        ctx.plan, ctx.mid = plan, mid
        ctx.has_ks = ksr is not None
        saved = (x0r, x0i, Ce, hr, hi) + ((ksr, ksi) if ctx.has_ks else ())
        ctx.save_for_backward(*saved)
        return xTr, xTi, hr, hi

    @staticmethod
    def backward(ctx, gxTr, gxTi, ghr, ghi):
        x0r, x0i, Ce, hr, hi = ctx.saved_tensors[:5]
        ksr, ksi = ctx.saved_tensors[5:] if ctx.has_ks else (None, None)
        bwd = _pair(ctx.mid)[1]
        gr, gi, Cb = bwd(
            ctx.plan, x0r, x0i, Ce, hr, hi, ksr, ksi,
            _zeros_if_none(gxTr, hr[:, -1]), _zeros_if_none(gxTi, hi[:, -1]),
            _zeros_if_none(ghr, hr), _zeros_if_none(ghi, hi))
        return None, None, gr, gi, Cb


def uses_mid(plan, B, N) -> bool:
    """Whether a launch of the plan at B states of dimension N goes to the
    mid pair: one block does not hold it (a shared stack or one stack per
    candidate alike)."""
    return launch_refusal(plan, B, N) is not None


def streamk_propagate_kernel(plan, x0r, x0i, Ce):
    """The CUDA kernel pairs behind the same interface as
    streamk_propagate_plain (float32 CUDA tensors only): the one-block pair
    wherever size_refusal admits the plan, else the mid pair."""
    return _KernelFn.apply(plan, uses_mid(plan, *x0r.shape), x0r, x0i, Ce)


def streamk_propagate(plan, x0r, x0i, Ce):
    """Device dispatch: the kernel pair for CUDA tensors, the plain version
    for CPU tensors."""
    if Ce.device.type == "cuda":
        return streamk_propagate_kernel(plan, x0r, x0i, Ce)
    if Ce.device.type == "cpu":
        return streamk_propagate_plain(plan, x0r, x0i, Ce)
    raise NotImplementedError(f"streamK has no path for {Ce.device}")


def make_plan(Sr, Si, dt: float, iters: int, gen_diag=None,
              linsolver: str = "neumann", store_iters=None) -> StreamKPlan:
    """The launch plan for the (K, N, N) stack planes Sr, Si, on their
    device and in their dtype; (G, K, N, N) planes with a (G, N) gen_diag
    plan one system per candidate. Split appends the off-diagonal
    remainder's slot -diag(h), h = i * gen_diag the H diagonal (each
    candidate's own), whose coefficient is 1 (extend_coeffs). With
    iters <= 4 the forward stores its stage iterates for the backward; past
    that the backward replays them (the JAX kernel's rule); store_iters
    False asks for the replay at any iters (the JAX Problem's gate on
    bytes, problem.py::store_iters_ok)."""
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
                       linsolver=linsolver,
                       store_iters=iters <= 4 and store_iters is not False)


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
