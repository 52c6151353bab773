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
hand-written CUDA for Hopper: csrc/stream.cu (one thread block per
candidate) and, past what one block holds, csrc/stream_mid.cu (a
thread-block cluster per candidate and chunk of basis states, launched by
ops/stream_mid.py; ``_mid_shape`` plans it, ``mid_refusal`` says what it
does not take, ``route_refusal`` what neither pair takes). The contract is

    propagate(Sr, Si, (x0r, x0i), C) -> ((xTr, xTi), (hr, hi))

differentiable in Sr, Si, x0 and C. C is (ntime, K) or (E, ntime, K) for E
control candidates sharing x0; Sr, Si are (K, N, N),
or (E, K, N, N) with one system per candidate. For split the planes carry
the off-diagonal remainder: ``planes`` subtracts diag(h), h = i * gen_diag,
a constant of the plan without a cotangent (pallas_stream.py:515-523).

The same kernel pairs also serve the chunked cross-check path
(ops/adjoint.py, B5: plain Neumann, replayed stage iterates) and the
forward-only dense propagation (ops/dense.py, B6: no history); the plan's
``kind`` names the member, and each has its own entry points and launch
counters (the mid pair's in ops/stream_mid.py).

Device dispatch: CUDA tensors go to the kernels (built with nvcc at first
use, bound with ctypes; exact f32): the one-block pair where it holds a
candidate, else the mid pair (``uses_mid``); CPU tensors to
``stream_propagate_plain``,
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
              linsolver: str = "neumann", kind: str = "stream",
              store_iters=None) -> StreamPlan:
    """The plan on the device and in the dtype of the stack planes Sr
    ((K, N, N) or (E, K, N, N); only those are read). jacobi and split need
    gen_diag, the (N,) generator diagonal. The forward of 'stream' stores
    its stage iterates for iters <= 4 and the backward replays them past
    that; store_iters False asks for the replay at any iters (the JAX
    Problem's gate on bytes, problem.py::store_iters_ok, as
    streamk.make_plan takes it); 'chunk' always replays; 'chunk' and
    'dense' run plain Neumann only (pallas_adjoint.py:64-164,
    pallas_kernels.py:46-73)."""
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
    store = kind == "stream" and iters <= 4 and store_iters is not False
    return StreamPlan(rows=rows.contiguous(), hdiag=hdiag, dt=dt, iters=iters,
                      linsolver=linsolver, store_iters=store, kind=kind)


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


def _block_refusal(B, N, iters):
    """Why one thread block cannot hold a candidate of B states of
    dimension N with `iters` stage iterations (a sentence), or None."""
    BN = B * N
    if BN > 1024:
        return (f"stream kernel: B*N = {BN} state entries exceed one block "
                "(1024 threads); the mid pair (ops/stream_mid.py) takes "
                "plans past it")
    smem = _bwd_smem_bytes(iters, B, N, split=False)    # the inline layout
    if smem > _MAX_SMEM:
        return (f"stream kernel: {smem} bytes of shared memory exceed the "
                f"{_MAX_SMEM} a block can use (N={N}, B={B}, iters={iters}); "
                "the mid pair (ops/stream_mid.py) takes plans past it")
    return None


def size_refusal(B, N, iters, nt=0, E=1):
    """Why the one-block kernels cannot take E candidates of B states of
    dimension N over nt steps with `iters` stage iterations (a sentence
    naming the limit), or None: one thread block holds a candidate's B*N
    state entries and its shared memory, and the gradient sweep's plane
    arrays stay under PLANE_BUDGET_BYTES."""
    why = _block_refusal(B, N, iters)
    if why is not None:
        return why
    nbytes = 6 * 4 * E * nt * N * N
    if nbytes > PLANE_BUDGET_BYTES:
        return (f"stream kernel: the gradient's plane arrays take {nbytes} "
                f"bytes (6 x E={E} x ntime={nt} x N^2={N * N} f32), past "
                f"the {PLANE_BUDGET_BYTES} of PLANE_BUDGET_BYTES")
    return None


def launch_refusal(plan, B, N, nt=0, E=1):
    """route_refusal of a plan's member, stage iterations and stored
    iterates: why neither kernel pair takes it, or None."""
    return route_refusal(B, N, plan.iters, nt, E, plan.store_iters,
                         plan.kind)


def _launch_shape(plan, E, nt, B, N, backward: bool):
    """(threads per block, dynamic shared-memory bytes) of one launch of the
    one-block pair; raises NotImplementedError past what one block can hold
    (the backward's inline layout needs more than the forward's, so both
    refuse together)."""
    why = size_refusal(B, N, plan.iters, nt, E)
    if why is not None:
        raise NotImplementedError(why)
    if backward:
        return _bwd_shape(plan.iters, B, N)[:2]
    return _fwd_shape(B, N)[:2]


# ----------------------------------------------------------------------
# mid-size kernel pair (csrc/stream_mid.cu, launched by ops/stream_mid.py):
# a cluster per (candidate, chunk of basis states), a band of state entries
# per CTA. Its planner and gates; the one-block pair's above. The cluster
# sizes, basis states per cluster, least band and SMs are the mid streamK
# pair's (streamk.MID_*).
# ----------------------------------------------------------------------

# band slots in shared memory of each layout ('global': the row band read
# from the plane array, the column band transposed into device scratch)
MID_SLOTS = {"smem2": 2, "smem1": 1, "global": 0}
_LAYOUTS = {v: k for k, v in MID_SLOTS.items()}
# what the mid backward's partial plane cotangents may take in device memory
# (mid_tracks)
MID_PARTIAL_BYTES = 4 << 30
# the widest state the reference's 'chunk' mode takes
# (quandary_tpu/problem.py:465-466)
CHUNK_MAX_DIM = 1024


def _pad4(n):
    return -(-n // 4) * 4


def _mid_band_floats(N, R, backward, replay):
    """csrc/stream_mid.cu sm_band_floats: one slot of a CTA's bands of H."""
    row, col = _pad4(R * N), _pad4(R * (N + 1))
    return 2 * col + (2 * row if replay else 0) if backward else 2 * row


def _mid_floats(bc, N, R, it, backward, replay, slots):
    """csrc/stream_mid.cu sm_fwd_floats / sm_bwd_floats: a CTA's shared
    memory in floats with `slots` band slots (the forward's with no band row
    past them, _mid_fwd_band)."""
    if not backward:
        return _mid_fwd_floats(bc, N, R, *_mid_fwd_band(R, slots, 0))
    bands = slots * _mid_band_floats(N, R, backward, replay)
    return (bands + 2 * (it + 1) * bc * N + (4 * bc * N if replay else 0)
            + 2 * (it + 1) * bc * R + (10 if replay else 6) * bc * R + 4 * R)


# The mid forward's mbarriers (csrc/stream_mid.cu SM_FWD_HEAD): two of the
# operand exchange and one a warp's band copies, in the first floats of its
# shared memory
MID_FWD_HEAD = 40


def _mid_fwd_floats(bc, N, R, ahead, inplace):
    """csrc/stream_mid.cu sm_fwd_floats: the forward's shared memory in
    floats, `ahead` band rows in two slots and `inplace` in one (re and im,
    N each), two operand buffers of bc x N (re, im) pairs, the bands of x,
    b and k and the solver rows."""
    return (MID_FWD_HEAD + (2 * ahead + inplace) * 2 * N + 4 * bc * N
            + 6 * bc * R + 4 * R)


def _mid_fwd_band(R, slots, rows):
    """(ahead, inplace) band rows of the forward (csrc/stream_mid.cu
    sm_dims): 'smem2' (2 slots) every row a step ahead; 'smem1' `rows` a
    step ahead in a partial second slot and the others refilled in place;
    'global' (none) `rows` resident, refilled in place, the rest read from
    L2."""
    return (R, 0) if slots == 2 else (rows, R - rows) if slots else (0, rows)


def mid_fwd_rows(E, B, N, G, bc, layout):
    """The forward's band rows past its whole slots (the C entry points'
    band_rows): 'smem1' as many rows of a second slot as fit beside the
    first (below R), 'global' as many resident rows as fit (up to R) where
    the launch's CTAs fit the card's SMs once, else none (the rows would
    take the room of a second CTA on an SM); 'smem2' none."""
    if layout == "smem2":
        return 0
    R, slots = -(-N // G), MID_SLOTS[layout]
    room = streamk._MAX_SMEM // 4 - _mid_floats(bc, N, R, 0, False, False,
                                                 slots)
    fit = max(0, room // (2 * N))
    if layout == "smem1":
        return min(R - 1, fit)
    return min(R, fit) if E * -(-B // bc) * G <= streamk.MID_SMS else 0


def _mid_fwd_shape(E, B, N, iters, store, layout=None, rows=None):
    """(G, Bc, threads, shared-memory bytes, layout, band rows) of one mid
    forward launch, or None where it does not fit: _mid_shape's, with the
    band rows mid_fwd_rows gives (`rows` forces a count; None where it does
    not fit the layout)."""
    shape = _mid_shape(E, B, N, iters, store, False, layout, rows=rows)
    if shape is None:
        return None
    G, bc, threads, smem, layout = shape
    if rows is None:
        rows = mid_fwd_rows(E, B, N, G, bc, layout)
    return G, bc, threads, smem, layout, rows


def mid_fwd_tx(N, G, rank, nb):
    """Bytes the other CTAs of a forward cluster push into CTA `rank` per
    exchange (its arrival's expect_tx): every other band's rows of the
    chunk's nb states, 8 bytes an entry (re, im)."""
    R = -(-N // G)
    return 8 * (N - min(R, N - rank * R)) * nb


def mid_fwd_push_pairs(G, nb):
    """The (state, CTA) pairs each lane of a warp pushes for one band row
    in csrc/stream_mid.cu stream_mid_fwd's push_row, in order: lane l the
    CTA l mod G (its own by a local store) for the states l // G,
    l // G + 32 / G, ... below nb."""
    per = 32 // G
    return [[(b0 + lane // G, lane % G) for b0 in range(0, nb, per)
             if b0 + lane // G < nb] for lane in range(32)]


def mid_fwd_exchanges(nt, iters):
    """The forward's stages in order as csrc/stream_mid.cu stream_mid_fwd
    runs them: (step, stage, exchange read, exchange written or None).
    Exchange 0 is x0; exchange e lies in operand buffer e & 1 and completes
    phase e >> 1 of that buffer's mbarrier (parity (e >> 1) & 1)."""
    out, e = [], 0
    for t in range(nt):
        for j in range(iters + 1):
            w = e + 1 if j < iters or t + 1 < nt else None
            out.append((t, j, e, w))
            e = w if w is not None else e
    return out


def _mid_shape(E, B, N, iters, store, backward=False, layout=None,
               rows=None):
    """(G, Bc, threads, shared-memory bytes, layout) of one mid launch
    (streamk.cluster_shape, up to two band slots), or None where no layout
    fits a CTA: 'smem2' where two slots fit (the next step's band streamed
    in during the step), else 'smem1'; 'global' where no G fits one slot.
    `layout` forces one ('global' at the G the planner would give the bands
    in shared memory, where there is one), or gives None where it does not
    fit. The forward's bytes hold its band rows past the slots
    (mid_fwd_rows; `rows` forces a count, None where it does not fit)."""
    replay = backward and not store and iters > 0
    shape = streamk.cluster_shape(
        E, B, N, lambda G, bc, slots: _mid_floats(
            bc, N, -(-N // G), iters, backward, replay, slots),
        max_slots=2, slots=None if layout is None else MID_SLOTS[layout])
    if shape is None:
        return None
    G, bc, slots, threads, smem = shape
    layout = _LAYOUTS[slots]
    if not backward:
        R = -(-N // G)
        if rows is None:
            rows = mid_fwd_rows(E, B, N, G, bc, layout)
        elif rows < 0 or rows > (R - 1 if slots == 1 else 0 if slots == 2
                                 else R):
            return None
        smem = 4 * _mid_fwd_floats(bc, N, R, *_mid_fwd_band(R, slots, rows))
        if smem > streamk._MAX_SMEM:
            return None
    return G, bc, threads, smem, layout


def mid_tracks(E, B, N, nt, G, bc):
    """Clusters per candidate of a mid backward launch. The cluster of
    track l runs the chunks of Bc states l, l + tracks, ... in turn into one
    partial plane cotangent (E, nt, N, N pair each); one track writes the
    output itself. As many tracks as chunks, but no more than fill the
    card's SMs once (the launch's CTAs at most streamk.MID_SMS; more would
    only run in waves) nor than keep the partials within
    MID_PARTIAL_BYTES."""
    chunks = -(-B // bc)
    fill = streamk.MID_SMS // (E * G)
    room = MID_PARTIAL_BYTES // (2 * E * nt * N * N * 4) if nt else chunks
    return max(1, min(chunks, fill, room))


# The mid backward's 'helpers' schedule (csrc/stream_mid.cu
# stream_mid_bwd_helpers): the chain clusters run only each step's operand
# loads and its transposed chain; a replay cluster per chain cluster
# (replayed iterates) fills a ring of MID_HELP_W steps of stage iterates
# ahead of it, and helper clusters, with the chain's own CTAs for any tile
# left, run each step's pass in tiles of the whole matrix: H(t) copied
# transposed into a two-slot ring in device memory, from which the chain
# reads its column band, and Hb of the step two back from a two-slot ring
# of the chain's (cotangent, input) pairs. It takes the chain schedule's G,
# Bc and tracks, so Hb keeps its bits between the schedules.
MID_SCHEDULES = ("helpers", "chain")
MID_HELP_TILE = (32, 64)            # a pass tile: rows x columns
MID_HELP_W = 4                      # steps of the iterate ring


def _help_ldr(N):
    """Row stride of the H^T ring: N rounded up to 4."""
    return -(-N // 4) * 4


def _help_tile_floats(bc, it):
    """csrc/stream_mid.cu help_tile_floats: a pass tile's scratch."""
    P, Q = MID_HELP_TILE
    return 2 * Q * (P + 1) + (it + 1) * 2 * bc * (P + Q)


def _help_floats(bc, N, R, it, replay, stored, hsmem, rslots):
    """csrc/stream_mid.cu help_floats: a CTA's shared memory in floats on
    the helpers schedule, the chain's column band in it (hsmem) or not, the
    replay's row band in `rslots` slots."""
    head = (4 * bc * N + (10 if replay else 6) * bc * R + 4 * R
            + 2 * (4 + 2 * (it if stored else 0)) * bc * R)
    tile = _help_tile_floats(bc, it)
    chain = _pad4(head) + max(2 * R * _help_ldr(N) if hsmem else 0, tile)
    rep = (_pad4(4 * bc * N + 4 * bc * R + 4 * R)
           + rslots * _mid_band_floats(N, R, False, False)) if replay else 0
    return 8 + max(chain, rep, tile)


def _mid_help_shape(E, B, N, iters, store, layout=None):
    """(G, Bc, threads, shared-memory bytes, layout, replay slots) of the
    backward's helpers schedule, or None where it does not fit a CTA: the
    chain schedule's G, Bc and threads (_mid_shape); layout 'smem' where
    the chain's column band fits shared memory beside the rest (copied in
    from the ring), else 'global' (read from the ring in L2); the replay's
    row band in the most slots of shared memory (2, 1) that fit, else 0
    (read from the planes). `layout` 'global' forces both into L2."""
    shape = _mid_shape(E, B, N, iters, store, True)
    if shape is None:
        return None
    G, bc, threads = shape[:3]
    R = -(-N // G)
    replay, stored = not store and iters > 0, store and iters > 0
    fits = lambda h, rs: 4 * _help_floats(bc, N, R, iters, replay, stored,
                                          h, rs) <= _MAX_SMEM
    hsmem = layout != "global" and fits(True, 0)
    rslots = next((n for n in (2, 1) if replay and layout != "global"
                   and fits(hsmem, n)), 0)
    if not fits(hsmem, rslots):
        return None
    return (G, bc, threads,
            4 * _help_floats(bc, N, R, iters, replay, stored, hsmem, rslots),
            "smem" if hsmem else "global", rslots)


def _help_ring_floats(bc, N, it, replay):
    """csrc/stream_mid.cu help_ring_floats: a group's two slots of H^T, two
    of the step's pairs and, with replay, MID_HELP_W of stage iterates."""
    return (4 * N * _help_ldr(N) + 2 * (it + 1) * 4 * bc * N
            + (MID_HELP_W * it * 2 * bc * N if replay else 0))


def _help_flag_ints(S):
    """csrc/stream_mid.cu help_flag_ints: a group's counters for a sequence
    of S steps."""
    return 1 + 2 * MID_HELP_W + 3 * (S + 2)


def _help_groups(E, B, N, iters, nt, store):
    """(groups, steps of the longest track's sequence) of the helpers
    schedule: one group per (candidate, track)."""
    G, bc = _mid_shape(E, B, N, iters, store, True)[:2]
    tracks = mid_tracks(E, B, N, nt, G, bc)
    return E * tracks, -(-(-(-B // bc)) // tracks) * nt


def _mid_bwd_scratch(E, B, N, iters, nt, store, schedule):
    """Device bytes of the mid backward's own scratch on a schedule: the
    tracks' partial plane cotangents (more than one track); 'chain' its
    column bands in the global layout, 'helpers' the groups' rings and
    counters."""
    shape = _mid_shape(E, B, N, iters, store, True)
    if shape is None:
        return 0
    G, bc, _, _, layout = shape
    tracks = mid_tracks(E, B, N, nt, G, bc)
    more = 2 * E * tracks * nt * N * N * 4 if tracks > 1 else 0
    if schedule == "helpers":
        groups, S = _help_groups(E, B, N, iters, nt, store)
        more += 4 * (groups * _help_ring_floats(bc, N, iters,
                                                not store and iters > 0)
                     + 1 + groups * _help_flag_ints(S))
    elif layout == "global":
        more += 4 * E * tracks * G * 2 * _pad4(-(-N // G) * (N + 1))
    return more


def mid_helpers_fit(E, B, N, iters, nt, store, kind="stream"):
    """Whether the backward's helpers schedule can run: its layout fits a
    CTA, the chain clusters (E x tracks of G CTAs) leave the card's SMs
    (streamk.MID_SMS) room for at least one more cluster each (a replay or
    a helper), and its rings keep the sweep within
    streamk.DEVICE_BUDGET_BYTES."""
    shape = _mid_help_shape(E, B, N, iters, store)
    if shape is None:
        return False
    groups = _help_groups(E, B, N, iters, nt, store)[0]
    return (2 * groups * shape[0] <= streamk.MID_SMS
            and mid_sweep_bytes(E, B, N, iters, nt, store, kind, "helpers")
            <= streamk.DEVICE_BUDGET_BYTES)


def mid_helper_clusters(groups, G, holds, replay):
    """Helper clusters per group of the helpers schedule: as many as the SMs
    the `groups` chain clusters of G CTAs and their replay clusters (with
    `replay`) leave idle, at most streamk.MID_MAX_HELPERS, and no more than
    the card holds beside them (`holds` clusters of the launch's shape at
    once); -1 where no second cluster fits beside each chain cluster."""
    cap = min(streamk.MID_SMS // (groups * G), holds // groups)
    if cap < 2:
        return -1
    return min(streamk.MID_MAX_HELPERS, cap - 1 - int(replay))


def mid_bwd_schedule(E, B, N, iters, nt, store, kind="stream", forced=None,
                     holds=None):
    """The mid backward's schedule: `forced` as it is where it fits (the
    card tests and scripts compare them; one that does not, or 'helpers'
    where its rings would take the sweep past
    streamk.DEVICE_BUDGET_BYTES, raising ValueError); else 'helpers' where
    mid_helpers_fit and the card holds a replay or helper cluster per chain
    cluster beside them (`holds`: clusters of the helpers launch's shape
    the card holds at once; None reads no card), else 'chain' (the card is
    full: each cluster runs its replay and pass in its chain). A size rule:
    stored and replayed iterates of one size take one schedule where the
    card holds them."""
    if forced is not None:
        ok = forced in MID_SCHEDULES and _mid_shape(
            E, B, N, iters, store, True) is not None
        if forced == "helpers":
            ok = ok and _mid_help_shape(E, B, N, iters, store) is not None \
                and mid_sweep_bytes(E, B, N, iters, nt, store, kind,
                                    "helpers") <= streamk.DEVICE_BUDGET_BYTES
        if not ok:
            raise ValueError(f"{kind}_mid_bwd: schedule {forced!r} does not "
                             f"fit (N = {N}, B = {B}, E = {E}, ntime = {nt})")
        return forced
    if not mid_helpers_fit(E, B, N, iters, nt, store, kind):
        return "chain"
    if holds is not None:
        groups = _help_groups(E, B, N, iters, nt, store)[0]
        G = _mid_shape(E, B, N, iters, store, True)[0]
        if mid_helper_clusters(groups, G, holds,
                               not store and iters > 0) < 0:
            return "chain"
    return "helpers"


def _mid_directions(kind):
    return (False,) if kind == "dense" else (False, True)


def mid_sweep_bytes(E, B, N, iters, nt, store, kind="stream",
                    schedule=None):
    """Device bytes of one sweep's own tensors on the mid pair besides the
    planes and their cotangent: the history and its cotangent, the stored
    stage iterates and the backward's scratch on `schedule`
    (_mid_bwd_scratch; default: the one mid_bwd_schedule picks without
    reading the card)."""
    if kind == "dense":
        return 0
    total = streamk.history_bytes(E, B, N, iters, nt, store)
    if schedule is None:
        schedule = mid_bwd_schedule(E, B, N, iters, nt, store, kind)
    return total + _mid_bwd_scratch(E, B, N, iters, nt, store, schedule)


def mid_refusal(E, B, N, iters, nt, store, kind="stream"):
    """Why the mid pair does not take E candidates of B states of dimension
    N over nt steps (a sentence naming the limit), or None: 'chunk' past
    the reference's dim <= 1024; the gradient's six plane arrays past
    PLANE_BUDGET_BYTES ('stream': on P = roundup(N, 128), the JAX package's
    gate, quandary_tpu/problem.py:461-464; 'chunk' and 'dense': on N, the
    port's); no layout of a direction in a CTA's shared memory; or the
    sweep's other tensors past streamk.DEVICE_BUDGET_BYTES."""
    if kind == "chunk" and N > CHUNK_MAX_DIM:
        return (f"stream mid kernels: fused_mode='chunk' takes dim <= "
                f"{CHUNK_MAX_DIM} (quandary_tpu/problem.py:465-466), got "
                f"{N}")
    P = -(-N // 128) * 128 if kind == "stream" else N
    nbytes = 6 * 4 * E * nt * P * P
    if nbytes > PLANE_BUDGET_BYTES:
        return (f"stream mid kernels: the gradient's plane arrays take "
                f"{nbytes} bytes (6 x E={E} x ntime={nt} x {P}^2 f32"
                + (", P = roundup(N, 128) as quandary_tpu/problem.py:464"
                   if kind == "stream" else "")
                + f"), past the {PLANE_BUDGET_BYTES} of PLANE_BUDGET_BYTES")
    for backward in _mid_directions(kind):
        if _mid_shape(E, B, N, iters, store, backward) is None:
            which = "backward" if backward else "forward"
            return (f"stream mid kernels: the {which}'s operand and stage "
                    f"buffers at N = {N} and iters = {iters} exceed the "
                    f"{_MAX_SMEM} bytes of shared memory a CTA can use")
    need = mid_sweep_bytes(E, B, N, iters, nt, store, kind)
    if need > streamk.DEVICE_BUDGET_BYTES:
        return (f"stream mid kernels: a sweep's history, cotangents, stored "
                f"iterates, partial plane cotangents, scratch and rings take "
                f"{need} bytes of device memory, past DEVICE_BUDGET_BYTES = "
                f"{streamk.DEVICE_BUDGET_BYTES} (E = {E}, ntime = {nt}, "
                f"B = {B}, N = {N})")
    return None


def route_refusal(B, N, iters, nt=0, E=1, store=None, kind="stream"):
    """Why neither kernel pair takes a plan of the member `kind` (a sentence
    naming the limit), or None: the one-block pair where one block holds a
    candidate (size_refusal), else the mid pair (mid_refusal). store:
    whether the forward stores its stage iterates (the plan's store_iters;
    default: 'stream' at iters <= 4)."""
    store = (kind == "stream" and iters <= 4) if store is None \
        else bool(store)
    if _block_refusal(B, N, iters) is None:
        return size_refusal(B, N, iters, nt, E)
    return mid_refusal(E, B, N, iters, nt, store, kind)


def uses_mid(plan, B, N) -> bool:
    """Whether a launch of the plan at B states of dimension N goes to the
    mid pair: one that one block does not hold."""
    return _block_refusal(B, N, plan.iters) is not None


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


def _block_fwd(plan, Hr, Hi, x0r, x0i):
    """One forward launch of the one-block pair's member: (xTr, xTi, hr, hi,
    ksr, ksi); the history is None for 'dense', the stage iterates unless
    stored."""
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


def _block_bwd(plan, Hr, Hi, x0r, x0i, hr, hi, ksr, ksi, gTr, gTi, jr, ji):
    """One backward launch of the one-block pair: (x0 cotangent (B, N) pair,
    plane cotangent (E, nt, N, N) pair)."""
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


def _kernel_fwd(plan, Hr, Hi, x0r, x0i):
    """One forward launch of the plan's member on the pair that takes it
    (uses_mid): (xTr, xTi, hr, hi, ksr, ksi)."""
    if uses_mid(plan, *x0r.shape):
        from . import stream_mid
        return stream_mid._kernel_fwd(plan, Hr, Hi, x0r, x0i)
    return _block_fwd(plan, Hr, Hi, x0r, x0i)


def _kernel_bwd(plan, Hr, Hi, x0r, x0i, hr, hi, ksr, ksi, gTr, gTi, jr, ji):
    """One backward launch on the pair that takes the plan (uses_mid): (x0
    cotangent (B, N) pair, plane cotangent (E, nt, N, N) pair)."""
    if uses_mid(plan, *x0r.shape):
        from . import stream_mid
        return stream_mid._kernel_bwd(plan, Hr, Hi, x0r, x0i, hr, hi, ksr,
                                      ksi, gTr, gTi, jr, ji)
    return _block_bwd(plan, Hr, Hi, x0r, x0i, hr, hi, ksr, ksi, gTr, gTi, jr,
                      ji)


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
    """The CUDA kernel pairs of the plan's member behind the same interface
    as stream_propagate_plain (float32 CUDA tensors only): the one-block
    pair where one block holds a candidate, else the mid pair."""
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
