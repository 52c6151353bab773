"""Streamed-plane propagation: the per-step Hamiltonian planes
H(t) = sum_k c_k(t) S_k are built outside the kernel (``planes``, one
einsum), the whole IMR time loop runs in one kernel launch per direction,
and the backward emits the per-step plane cotangent Hb(t). The coefficient
and operator-stack cotangents follow from Hb by the einsum's own backward:

    Cb[t, k] = <Hb_r(t), Sr_k> + <Hb_i(t), Si_k>,  Sb_k = sum_t C[t, k] Hb(t)

(pallas_stream.py:716-724). This is the route that differentiates the
Hamiltonian itself (calibration); the streamK route (ops/streamk.py)
contracts the planes in-kernel and has no stack cotangents.

Port of quandary_tpu/ops/pallas_stream.py::make_stream_propagate (B3) to
hand-written CUDA for Hopper, csrc/stream.cu. The contract is

    propagate(Sr, Si, (x0r, x0i), C) -> ((xTr, xTi), (hr, hi))

differentiable in Sr, Si, x0 and C. C is (ntime, K) or (E, ntime, K) for E
control candidates sharing x0 (one thread block each); Sr, Si are (K, N, N),
or (E, K, N, N) with one system per candidate. For split the planes carry
the off-diagonal remainder: ``planes`` subtracts diag(h), h = i * gen_diag,
a constant of the plan without a cotangent (pallas_stream.py:515-523).

The same kernel pair also serves the chunked cross-check path
(ops/adjoint.py, B5: plain Neumann, replayed stage iterates) and the
forward-only dense propagation (ops/dense.py, B6: no history); the plan's
``kind`` names the member, and each has its own entry point and launch
counters.

Device dispatch: CUDA tensors go to the kernels (built with nvcc at first
use, bound with ctypes; exact f32), CPU tensors to ``stream_propagate_plain``,
the same function in plain torch with the hand-written transpose as its
backward, in any float dtype. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from . import cuda_build, streamk
from .streamk import _ptr, _zeros_if_none

# launches of each kernel since the counters were last set to 0
stream_fwd_launches = 0
stream_bwd_launches = 0
chunk_fwd_launches = 0
chunk_bwd_launches = 0
dense_fwd_launches = 0
_COUNTERS = ("stream_fwd_launches", "stream_bwd_launches",
             "chunk_fwd_launches", "chunk_bwd_launches", "dense_fwd_launches")

KINDS = ("stream", "chunk", "dense")
_SRC = os.path.join(cuda_build.CSRC_DIR, "stream.cu")
_MAX_SMEM = cuda_build.MAX_SMEM
# A gradient sweep holds six (E, ntime, N, N) f32 plane arrays at once: the
# planes, their cotangents and the einsum's intermediates (the gate of the
# JAX package's 'stream' mode, problem.py:464)
PLANE_BUDGET_BYTES = 8 << 30


def launch_counts() -> dict:
    """The five launch counters by name."""
    return {k: globals()[k] for k in _COUNTERS}


def reset_launch_counts() -> None:
    for k in _COUNTERS:
        globals()[k] = 0


def add_launches(counts: dict, times: int = 1) -> None:
    """Add `times` x `counts` to the counters: the replay of a CUDA graph
    launches the kernels it captured without passing through the wrappers."""
    for k, v in counts.items():
        globals()[k] += times * v


@dataclasses.dataclass
class StreamPlan:
    """What a launch needs besides the planes and x0: the (nrows, N) solver
    rows (streamk.solver_rows), for split the (2, N) real and imaginary
    H diagonal that ``planes`` subtracts, the step constants, and the kernel
    pair's member: 'stream' (B3), 'chunk' (B5) or 'dense' (B6)."""
    rows: torch.Tensor
    hdiag: Optional[torch.Tensor]
    dt: float
    iters: int
    linsolver: str
    store_iters: bool
    kind: str = "stream"


def make_plan(Sr, dt: float, iters: int, gen_diag=None,
              linsolver: str = "neumann", kind: str = "stream") -> StreamPlan:
    """The plan on the device and in the dtype of the stack planes Sr
    ((K, N, N) or (E, K, N, N); only those are read). jacobi and split need
    gen_diag, the (N,) generator diagonal. The forward of 'stream' stores
    its stage iterates for iters <= 4 and the backward replays them past
    that; 'chunk' always replays; 'chunk' and 'dense' run plain Neumann
    only (pallas_adjoint.py:64-164, pallas_kernels.py:46-73)."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if kind != "stream" and linsolver != "neumann":
        raise NotImplementedError(
            f"the {kind!r} kernels run plain Neumann only, got {linsolver!r}")
    dt, iters = float(dt), int(iters)
    kw = dict(dtype=Sr.dtype, device=Sr.device)
    N = Sr.shape[-1]
    if gen_diag is not None:
        gen_diag = np.asarray(gen_diag, dtype=np.complex128).reshape(-1)
        if gen_diag.shape != (N,):
            raise ValueError(f"gen_diag must have shape ({N},), got "
                             f"{gen_diag.shape}")
    rows = torch.as_tensor(streamk.solver_rows(gen_diag, dt, linsolver), **kw)
    hdiag = None
    if linsolver == "split":
        h = 1j * gen_diag
        hdiag = torch.as_tensor(np.stack([h.real, h.imag]), **kw)
    return StreamPlan(rows=rows.contiguous(), hdiag=hdiag, dt=dt, iters=iters,
                      linsolver=linsolver,
                      store_iters=kind == "stream" and iters <= 4, kind=kind)


def planes(plan, Sr, Si, Ce):
    """(E, nt, N, N) real and imaginary H planes of the coefficient rows
    Ce (E, nt, K) on the stacks (K, N, N) or (E, K, N, N); split subtracts
    diag(h). Outside any kernel in the reference too (pallas_stream.py
    :569-576), so a library product; differentiable in Ce, Sr and Si."""
    if Sr.dim() == 4:
        if Sr.shape[0] != Ce.shape[0]:
            raise ValueError(f"{Ce.shape[0]} coefficient candidates for "
                             f"{Sr.shape[0]} per-candidate stacks")
        sub = "etk,ekpq->etpq"
    else:
        sub = "etk,kpq->etpq"
    Hr, Hi = torch.einsum(sub, Ce, Sr), torch.einsum(sub, Ce, Si)
    if plan.hdiag is not None:
        Hr = Hr - torch.diag_embed(plan.hdiag[0])
        Hi = Hi - torch.diag_embed(plan.hdiag[1])
    return Hr, Hi


# ----------------------------------------------------------------------
# plain torch version (CPU path and the kernels' oracle)
# ----------------------------------------------------------------------

def _solver_parts(plan):
    """(jac, split) row tuples in the form streamk._stage_fwd takes."""
    if plan.linsolver == "neumann":
        return None, None
    r = tuple(plan.rows.unbind(0))
    return (r, None) if plan.linsolver == "jacobi" else (None, r)


def plain_forward(plan, Hr, Hi, x0r, x0i):
    """Plain forward: planes (E, nt, N, N), x0 (B, N) -> hist pair
    (E, nt, B, N)."""
    jac, split = _solver_parts(plan)
    return streamk.plane_forward(Hr, Hi, x0r, x0i, dt=plan.dt,
                                 iters=plan.iters, jac=jac, split=split)


def plain_backward(plan, Hr, Hi, x0r, x0i, hr, hi, gTr, gTi, jr, ji):
    """Hand-written transpose of plain_forward -> (x0 cotangent (B, N) pair,
    plane cotangent (E, nt, N, N) pair)."""
    jac, split = _solver_parts(plan)
    gr, gi, Hbr, Hbi = streamk.plane_backward(
        Hr, Hi, x0r, x0i, hr, hi, gTr, gTi, jr, ji, dt=plan.dt,
        iters=plan.iters, jac=jac, split=split)
    return gr.sum(0), gi.sum(0), Hbr, Hbi


class _PlainFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, Hr, Hi, x0r, x0i):
        hr, hi = plain_forward(plan, Hr, Hi, x0r, x0i)
        ctx.plan = plan
        ctx.save_for_backward(Hr, Hi, x0r, x0i, hr, hi)
        return hr[:, -1].clone(), hi[:, -1].clone(), hr, hi

    @staticmethod
    def backward(ctx, gxTr, gxTi, ghr, ghi):
        Hr, Hi, x0r, x0i, hr, hi = ctx.saved_tensors
        gr, gi, Hbr, Hbi = plain_backward(
            ctx.plan, Hr, Hi, x0r, x0i, hr, hi,
            _zeros_if_none(gxTr, hr[:, -1]), _zeros_if_none(gxTi, hi[:, -1]),
            _zeros_if_none(ghr, hr), _zeros_if_none(ghi, hi))
        return None, Hbr, Hbi, gr, gi


def stream_propagate_plain(plan, Hr, Hi, x0r, x0i):
    """Plain torch streamed-plane propagation on any device and float dtype:
    planes (E, nt, N, N) pair, x0 (B, N) pair -> (xTr, xTi, hr, hi) with xT
    (E, B, N) and hist (E, nt, B, N); the backward, the hand-written
    transpose, returns the plane and x0 cotangents."""
    return _PlainFn.apply(plan, Hr, Hi, x0r, x0i)


# ----------------------------------------------------------------------
# CUDA kernel pair
# ----------------------------------------------------------------------

def _bind(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd = [p] * 11 + [i] * 7 + [f, f, i, i, p]
    bwd = [p] * 17 + [i] * 7 + [f, f, i, i, p]
    for name, args in (("stream_fwd_launch", fwd), ("stream_bwd_launch", bwd),
                       ("chunk_fwd_launch", fwd), ("chunk_bwd_launch", bwd),
                       ("dense_fwd_launch", fwd)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, i


def build_kernels(verbose: bool = False):
    """Compile csrc/stream.cu (cuda_build.build_library) and load it, once
    per process. Returns (library path, build seconds, compiler output)."""
    return cuda_build.build_library(_SRC, _bind, verbose)


def _fwd_smem_bytes(B, N, split: bool):
    """csrc/stream.cu fwd_floats, in bytes: per slot (two with helper warps,
    one inline) the H planes, and the two (B, N) slots of the matvec
    inputs (the stage iterates take turns in them, so no iters)."""
    BN, slots = B * N, 2 if split else 1
    return 4 * (slots * 2 * N * (N + 1) + 4 * BN)


def _bwd_smem_bytes(it, B, N, split: bool):
    """csrc/stream.cu bwd_floats, in bytes: per slot (two with helper warps,
    one inline) the H planes and the step's (cotangent, input) pairs."""
    BN, slots = B * N, 2 if split else 1
    return 4 * slots * (2 * N * (N + 1) + (4 * it + 4) * BN)


def _fwd_shape(B, N):
    """(threads, shared-memory bytes, helpers) of a forward launch:
    streamk._role_shape, state warps plus helper warps that copy H one or
    two steps ahead where that fits one block, else the inline layout
    (helpers 0)."""
    return streamk._role_shape(B, N,
                               lambda split: _fwd_smem_bytes(B, N, split))


def _bwd_shape(it, B, N):
    """(threads, shared-memory bytes, helpers) of a backward launch:
    streamk._role_shape, state warps plus helper warps that copy H a step
    ahead and reduce Hb a step behind where that fits one block, else the
    inline layout (helpers 0)."""
    return streamk._role_shape(B, N,
                               lambda split: _bwd_smem_bytes(it, B, N, split))


def size_refusal(B, N, iters, nt=0, E=1):
    """Why the kernels cannot take E candidates of B states of dimension N
    over nt steps with `iters` stage iterations (a sentence naming the
    limit), or None: one thread block holds a candidate's B*N state entries
    and its shared memory, and the gradient sweep's plane arrays stay under
    PLANE_BUDGET_BYTES."""
    BN = B * N
    if BN > 1024:
        return (f"stream kernel: B*N = {BN} state entries exceed one block "
                "(1024 threads); multi-block candidates are not implemented")
    smem = _bwd_smem_bytes(iters, B, N, split=False)    # the inline layout
    if smem > _MAX_SMEM:
        return (f"stream kernel: {smem} bytes of shared memory exceed the "
                f"{_MAX_SMEM} a block can use (N={N}, B={B}, iters={iters})")
    nbytes = 6 * 4 * E * nt * N * N
    if nbytes > PLANE_BUDGET_BYTES:
        return (f"stream kernel: the gradient's plane arrays take {nbytes} "
                f"bytes (6 x E={E} x ntime={nt} x N^2={N * N} f32), past "
                f"the {PLANE_BUDGET_BYTES} of PLANE_BUDGET_BYTES")
    return None


def launch_refusal(plan, B, N, nt=0, E=1):
    """size_refusal of a plan's stage iterations."""
    return size_refusal(B, N, plan.iters, nt, E)


def _launch_shape(plan, E, nt, B, N, backward: bool):
    """(threads per block, dynamic shared-memory bytes) of one launch;
    raises NotImplementedError past what one block can hold (the backward's
    inline layout needs more than the forward's, so both refuse together)."""
    why = launch_refusal(plan, B, N, nt, E)
    if why is not None:
        raise NotImplementedError(why)
    if backward:
        return _bwd_shape(plan.iters, B, N)[:2]
    return _fwd_shape(B, N)[:2]


def _check_cuda(*ts):
    for t in ts:
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise NotImplementedError(
                "stream kernel runs float32 CUDA tensors only (complex128 "
                f"is not ported to the GPU); got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("stream kernel needs contiguous tensors")


def _dims(plan, E, nt, B, N):
    return (E, nt, B, N, plan.iters, streamk._MODES[plan.linsolver],
            int(plan.store_iters), plan.dt, plan.dt / 2.0)


def _lib():
    return cuda_build.library(_SRC, _bind)


def _count(name):
    globals()[name] += 1


def _kernel_fwd(plan, Hr, Hi, x0r, x0i):
    """One forward launch of the plan's member: (xTr, xTi, hr, hi, ksr, ksi);
    the history is None for 'dense', the stage iterates unless stored."""
    _check_cuda(plan.rows, Hr, Hi, x0r, x0i)
    E, nt, N = Hr.shape[0], Hr.shape[1], Hr.shape[-1]
    B = x0r.shape[0]
    threads, smem = _launch_shape(plan, E, nt, B, N, backward=False)
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=Hr.device)
    xTr, xTi = new(E, B, N), new(E, B, N)
    hr = hi = ksr = ksi = None
    if plan.kind != "dense":
        hr, hi = new(E, nt, B, N), new(E, nt, B, N)
    if plan.store_iters and plan.iters > 0:
        ksr, ksi = new(E, nt, plan.iters, B, N), new(E, nt, plan.iters, B, N)
    err = getattr(_lib(), f"{plan.kind}_fwd_launch")(
        *map(_ptr, (Hr, Hi, x0r, x0i, plan.rows, xTr, xTi, hr, hi, ksr,
                    ksi)),
        *_dims(plan, E, nt, B, N), threads, smem,
        torch.cuda.current_stream(Hr.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{plan.kind}_fwd launch failed: CUDA error {err}")
    _count(f"{plan.kind}_fwd_launches")
    return xTr, xTi, hr, hi, ksr, ksi


def _kernel_bwd(plan, Hr, Hi, x0r, x0i, hr, hi, ksr, ksi, gTr, gTi, jr, ji):
    """One backward launch: (x0 cotangent (B, N) pair, plane cotangent
    (E, nt, N, N) pair)."""
    _check_cuda(plan.rows, Hr, Hi, x0r, x0i, hr, hi, gTr, gTi, jr, ji)
    E, nt, N = Hr.shape[0], Hr.shape[1], Hr.shape[-1]
    B = x0r.shape[0]
    threads, smem = _launch_shape(plan, E, nt, B, N, backward=True)
    g0r = torch.empty((E, B, N), dtype=torch.float32, device=Hr.device)
    g0i = torch.empty_like(g0r)
    Hbr, Hbi = torch.empty_like(Hr), torch.empty_like(Hi)
    err = getattr(_lib(), f"{plan.kind}_bwd_launch")(
        *map(_ptr, (Hr, Hi, x0r, x0i, hr, hi, jr, ji, gTr, gTi, plan.rows,
                    ksr, ksi, g0r, g0i, Hbr, Hbi)),
        *_dims(plan, E, nt, B, N), threads, smem,
        torch.cuda.current_stream(Hr.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{plan.kind}_bwd launch failed: CUDA error {err}")
    _count(f"{plan.kind}_bwd_launches")
    return g0r.sum(0), g0i.sum(0), Hbr, Hbi


class _KernelFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, Hr, Hi, x0r, x0i):
        Hr, Hi = Hr.contiguous(), Hi.contiguous()
        x0r, x0i = x0r.contiguous(), x0i.contiguous()
        xTr, xTi, hr, hi, ksr, ksi = _kernel_fwd(plan, Hr, Hi, x0r, x0i)
        ctx.plan = plan
        ctx.has_ks = ksr is not None
        saved = (Hr, Hi, x0r, x0i, hr, hi) + ((ksr, ksi) if ctx.has_ks
                                              else ())
        ctx.save_for_backward(*saved)
        return xTr, xTi, hr, hi

    @staticmethod
    def backward(ctx, gxTr, gxTi, ghr, ghi):
        Hr, Hi, x0r, x0i, hr, hi = ctx.saved_tensors[:6]
        ksr, ksi = ctx.saved_tensors[6:] if ctx.has_ks else (None, None)
        gr, gi, Hbr, Hbi = _kernel_bwd(
            ctx.plan, Hr, Hi, x0r, x0i, hr, hi, ksr, ksi,
            _zeros_if_none(gxTr, hr[:, -1]), _zeros_if_none(gxTi, hi[:, -1]),
            _zeros_if_none(ghr, hr), _zeros_if_none(ghi, hi))
        return None, Hbr, Hbi, gr, gi


def stream_propagate_kernel(plan, Hr, Hi, x0r, x0i):
    """The CUDA kernel pair of the plan's member behind the same interface
    as stream_propagate_plain (float32 CUDA tensors only)."""
    if plan.kind == "dense":
        raise ValueError("the dense propagation is forward only: "
                         "ops/dense.py")
    return _KernelFn.apply(plan, Hr, Hi, x0r, x0i)


def stream_propagate(plan, Hr, Hi, x0r, x0i):
    """Device dispatch: the kernel pair for CUDA tensors, the plain version
    for CPU tensors."""
    if Hr.device.type == "cuda":
        return stream_propagate_kernel(plan, Hr, Hi, x0r, x0i)
    if Hr.device.type == "cpu":
        return stream_propagate_plain(plan, Hr, Hi, x0r, x0i)
    raise NotImplementedError(f"stream has no path for {Hr.device}")


def propagate_fn(dt: float, iters: int, gen_diag, linsolver: str, kind: str):
    """propagate(Sr, Si, (x0r, x0i), C) -> ((xTr, xTi), (hr, hi)) on the
    kernel pair's member `kind`, with one plan per dtype and device."""
    plans = {}

    def propagate(Sr, Si, x0, C):
        key = (Sr.dtype, Sr.device)
        if key not in plans:
            plans[key] = make_plan(Sr, dt, iters, gen_diag, linsolver, kind)
        plan = plans[key]
        Ce = (C if C.dim() == 3 else C[None]).to(Sr.dtype)
        Hr, Hi = planes(plan, Sr, Si, Ce)
        xTr, xTi, hr, hi = stream_propagate(plan, Hr, Hi, x0[0].to(Sr.dtype),
                                            x0[1].to(Sr.dtype))
        if C.dim() == 2:
            xTr, xTi, hr, hi = xTr[0], xTi[0], hr[0], hi[0]
        return (xTr, xTi), (hr, hi)

    return propagate


def make_stream_propagate(dt: float, iters: int = 10, gen_diag=None,
                          linsolver: str = "neumann"):
    """Build propagate(Sr, Si, (x0r, x0i), C) -> ((xTr, xTi), (hr, hi)),
    differentiable in Sr, Si, x0 and C.

    Sr, Si: (K, N, N) real/imaginary operator stack, or (E, K, N, N); C:
    (ntime, K) or (E, ntime, K) coefficient rows. linsolver 'jacobi' and
    'split' need gen_diag, the (N,) generator diagonal."""
    return propagate_fn(dt, iters, gen_diag, linsolver, "stream")
