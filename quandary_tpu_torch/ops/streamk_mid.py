"""Launches of the mid-size streamK kernel pair, csrc/streamk_mid.cu: the
streamK contract of ops/streamk.py (port of quandary_tpu/ops/pallas_stream.py
::make_streamk_propagate, its forward and backward Pallas calls, and of
make_streamk_packed_propagate with per_block_stacks) for candidates that one
thread block of csrc/streamk.cu cannot hold: closed systems, open ones on
the superop route (dimension N^2), and plans with one stack and solver rows
per candidate (per-sample stacks, read at a stride by each cluster). A
launch runs a thread-block cluster of G CTAs per (candidate, chunk of Bc
basis states), each CTA on a band of the state entries.

This module holds the pair's ctypes binding, its launch counters (a
shared-stack and a per-block pair of them, as ops/streamk.py counts its
one-block and packed launches apart) and its two launch wrappers. Each
direction has two schedules (``streamk.fwd_schedule``,
``streamk.bwd_schedule``): 'helpers', where each step's contraction of H
(the forward's row contraction; the backward's column pass) runs beside the
chain on helper clusters the launch adds (as many as the card holds beside
the chain clusters), and 'chain', where it runs in each cluster's chain.
The planner (``streamk._mid_fwd_shape``, ``streamk._mid_bwd_shape``), the
gates (``streamk.mid_refusal``,
``streamk.route_refusal``) and the dispatch
(``streamk.streamk_propagate_kernel`` sends a plan here wherever
``streamk.size_refusal`` refuses it) are in ops/streamk.py, with the plain
torch version the pair is held against. A wrapper launches the
kernel or raises: nothing falls back to the one-block pair or to the plain
version.
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import cuda_build, streamk

# launches of each kernel since the counters were last set to 0: with one
# shared stack, and with a stack per candidate (packed, per-sample stacks)
streamk_mid_fwd_launches = 0
streamk_mid_bwd_launches = 0
streamk_mid_packed_fwd_launches = 0
streamk_mid_packed_bwd_launches = 0
_COUNTERS = ("streamk_mid_fwd_launches", "streamk_mid_bwd_launches",
             "streamk_mid_packed_fwd_launches",
             "streamk_mid_packed_bwd_launches")

_SRC = os.path.join(cuda_build.CSRC_DIR, "streamk_mid.cu")
# the shape of the last launch of each direction, as the wrapper ran it
# (cluster size G, states per cluster Bc, threads, shared-memory bytes,
# layout 'smem' or 'global', band rows R, clusters, CTAs; the schedule,
# 'helpers' or 'chain', and its helper clusters per chain cluster)
mid_layouts = {}
_HOLDS = {}     # launch shape -> clusters of it the card holds at once


def launch_counts() -> dict:
    """The four launch counters by name."""
    return {k: globals()[k] for k in _COUNTERS}


def reset_launch_counts() -> None:
    for k in _COUNTERS:
        globals()[k] = 0


def add_launches(counts: dict, times: int = 1) -> None:
    """Add `times` x `counts` to the counters (a CUDA graph's replay)."""
    for k, v in counts.items():
        globals()[k] += times * v


def _bind(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    tail = [i] * 8 + [f, f] + [i] * 5 + [p, ll, ll]
    lib.streamk_mid_fwd_launch.argtypes = [p] * 13 + tail + [i, p, p]
    lib.streamk_mid_bwd_launch.argtypes = [p] * 18 + tail + [i, p, p]
    lib.streamk_mid_max_clusters.argtypes = [i] * 5
    for name in ("streamk_mid_fwd_launch", "streamk_mid_bwd_launch",
                 "streamk_mid_max_clusters"):
        getattr(lib, name).restype = i


def build_kernels(verbose: bool = False):
    """Compile csrc/streamk_mid.cu (cuda_build.build_library) and load it,
    once per process. Returns (library path, build seconds, compiler
    output)."""
    return cuda_build.build_library(_SRC, _bind, verbose)


def _lib():
    return cuda_build.library(_SRC, _bind)


def _launch_shape(lib, plan, E, B, N, nt, backward, schedule="chain"):
    """The launch shape of a direction on its schedule
    (streamk._mid_fwd_shape, streamk._mid_bwd_shape) and how many of its
    clusters the card holds at once; raises NotImplementedError where the
    mid pair refuses the plan, and RuntimeError where the card cannot hold
    one cluster of the shape (cudaOccupancyMaxActiveClusters, asked once
    per shape)."""
    store = plan.store_iters and plan.iters > 0
    why = streamk.mid_refusal(E, B, N, plan.Ke, plan.iters, nt, store,
                              per_block=plan.per_block)
    if why is not None:
        raise NotImplementedError(why)
    shape = (streamk._mid_bwd_shape if backward else streamk._mid_fwd_shape)(
        E, B, N, plan.Ke, plan.iters, store, schedule)
    G, bc, threads, smem, _ = shape
    kernel = {(False, "chain"): 0, (True, "chain"): 1, (True, "helpers"): 2,
              (False, "helpers"): 3}[backward, schedule]
    n = _holds(lib, kernel, bc, G, threads, smem)
    if n < 1:
        raise RuntimeError(
            f"streamk_mid_{'bwd' if backward else 'fwd'}: the card holds "
            f"no cluster of {G} CTAs of {threads} threads and {smem} bytes "
            "of shared memory")
    return shape, n


def _holds(lib, kernel, bc, G, threads, smem):
    """Clusters of a launch shape the card holds at once
    (streamk_mid_max_clusters: kernel 0 the forward's chain schedule, 1 the
    backward's, 2 the backward's helpers schedule, 3 the forward's), asked
    once per shape."""
    key = (kernel, bc, G, threads, smem)
    if key not in _HOLDS:
        _HOLDS[key] = lib.streamk_mid_max_clusters(kernel, bc, G, threads,
                                                   smem)
    return _HOLDS[key]


def _log(key, E, B, N, shape, **more):
    G, bc, threads, smem, layout = shape
    clusters = E * -(-B // bc)
    mid_layouts[key] = dict(G=G, Bc=bc, threads=threads, smem=smem,
                            layout=layout, R=-(-N // G), clusters=clusters,
                            ctas=clusters * G, **more)


def _scratch(shape, E, B, N, backward, replay, device):
    """The global layout's bands of H, one slice per CTA; None in the smem
    layout."""
    G, bc, _, _, layout = shape
    if layout != "global":
        return None
    ctas = E * -(-B // bc) * G
    return torch.empty(
        ctas * streamk._mid_band_floats(N, -(-N // G), backward, replay),
        dtype=torch.float32, device=device)


def _kernel_fwd(plan, x0r, x0i, Ce, _schedule=None, _helpers=None):
    """One streamk_mid_fwd launch: (xTr, xTi, hr, hi, ksr, ksi), on the
    schedule streamk.fwd_schedule picks (`_schedule` forces one; `_helpers`
    the helper clusters per chain cluster of 'helpers', which do not change
    its bits). Either schedule gives the same bits. A per-block plan gives
    each candidate's clusters its own stack and rows."""
    global streamk_mid_fwd_launches, streamk_mid_packed_fwd_launches
    streamk._check_cuda(plan, Ce, x0r, x0i)
    lib = _lib()
    E, nt, Ke = Ce.shape
    B, N = x0r.shape
    store = plan.store_iters and plan.iters > 0
    holds = None        # the card's clusters of the helpers launch
    if _schedule is None and streamk.fwd_helpers_fit(
            E, B, N, Ke, plan.iters, nt, store, plan.per_block):
        G, bc, threads, smem = streamk._mid_fwd_shape(
            E, B, N, Ke, plan.iters, store, "helpers")[:4]
        holds = _holds(lib, 3, bc, G, threads, smem)
    schedule = streamk.fwd_schedule(E, B, N, Ke, plan.iters, nt, store,
                                    plan.per_block, _schedule, holds)
    shape, holds = _launch_shape(lib, plan, E, B, N, nt, False, schedule)
    G, bc, threads, smem, layout = shape
    dev = Ce.device
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    xTr, xTi = new(E, B, N), new(E, B, N)
    hr, hi = new(E, nt, B, N), new(E, nt, B, N)
    ksr = ksi = None
    if store:
        ksr, ksi = new(E, nt, plan.iters, B, N), new(E, nt, plan.iters, B, N)
    scratch = ring = flags = None
    if schedule == "helpers":
        groups = E * -(-B // bc)
        helpers = streamk.helper_clusters(groups, groups * G, holds) \
            if _helpers is None else _helpers
        ring = new(groups * streamk._fwd_ring_floats(N))
        flags = torch.zeros(1 + groups * 3 * nt, dtype=torch.int32,
                            device=dev)
    else:
        helpers = -1
        scratch = _scratch(shape, E, B, N, False, False, dev)
    err = lib.streamk_mid_fwd_launch(
        *map(streamk._ptr, (plan.Sr, plan.Si, Ce, x0r, x0i, plan.rows, xTr,
                            xTi, hr, hi, ksr, ksi, scratch)),
        *streamk._dims(plan, E, nt, B, N), G, bc, threads, smem,
        int(layout == "global"), torch.cuda.current_stream(dev).cuda_stream,
        *streamk.stack_strides(plan), helpers, streamk._ptr(ring),
        streamk._ptr(flags))
    if err != 0:
        raise RuntimeError(f"streamk_mid_fwd launch failed: CUDA error {err}")
    if plan.per_block:
        streamk_mid_packed_fwd_launches += 1
    else:
        streamk_mid_fwd_launches += 1
    _log("fwd", E, B, N, shape, schedule=schedule, helpers=max(helpers, 0))
    return xTr, xTi, hr, hi, ksr, ksi


def _kernel_bwd(plan, x0r, x0i, Ce, hr, hi, ksr, ksi, gTr, gTi, jr, ji,
                _schedule=None, _helpers=None):
    """One streamk_mid_bwd launch: (x0 cotangent pair summed over the
    candidates, Cb (E, nt, Ke)), on the schedule streamk.bwd_schedule picks
    (`_schedule` forces one; `_helpers` the helper clusters per chain
    cluster of 'helpers', which do not change its bits). The C-bar partial
    rows (the chain schedule's one per CTA, the helpers schedule's one per
    tile of the whole matrix) are summed over the chunks and rows in a
    fixed order, one per candidate (a per-block plan's stacks get no
    cotangent, as on the one-block pair)."""
    global streamk_mid_bwd_launches, streamk_mid_packed_bwd_launches
    streamk._check_cuda(plan, Ce, x0r, x0i, hr, hi, gTr, gTi, jr, ji)
    lib = _lib()
    E, nt, Ke = Ce.shape
    B, N = x0r.shape
    store = ksr is not None
    if store != (plan.store_iters and plan.iters > 0):
        raise ValueError("stored stage iterates do not match the plan")
    holds = None        # the card's clusters of the helpers launch
    if _schedule is None and streamk.helpers_fit(
            E, B, N, Ke, plan.iters, nt, store, plan.per_block):
        G, bc, threads = streamk._mid_bwd_shape(E, B, N, Ke, plan.iters,
                                                store, "helpers")[:3]
        holds = _holds(lib, 2, bc, G, threads,
                       streamk.helpers_smem(E, B, N, Ke, plan.iters))
    schedule = streamk.bwd_schedule(E, B, N, Ke, plan.iters, nt, store,
                                    plan.per_block, _schedule, holds)
    shape, holds = _launch_shape(lib, plan, E, B, N, nt, True, schedule)
    G, bc, threads, smem, layout = shape
    dev = Ce.device
    replay = not store and plan.iters > 0
    groups = E * -(-B // bc)
    g0r = torch.empty((E, B, N), dtype=torch.float32, device=dev)
    g0i = torch.empty_like(g0r)
    scratch = ring = flags = None
    if schedule == "helpers":
        helpers = streamk.helper_clusters(groups, groups * G, holds) \
            if _helpers is None else _helpers
        ntiles = streamk.split_tiles(N)[0]
        Cbp = torch.empty((E, -(-B // bc) * ntiles, nt, Ke),
                          dtype=torch.float32, device=dev)
        ring = torch.empty(groups * streamk._split_ring_floats(
            bc, N, plan.iters, replay), dtype=torch.float32, device=dev)
        flags = torch.zeros(1 + groups * (3 * nt + 4), dtype=torch.int32,
                            device=dev)
    else:
        helpers = -1
        Cbp = torch.empty((E, -(-B // bc) * G, nt, Ke), dtype=torch.float32,
                          device=dev)
        scratch = _scratch(shape, E, B, N, True, replay, dev)
    err = lib.streamk_mid_bwd_launch(
        *map(streamk._ptr, (plan.Sr, plan.Si, Ce, x0r, x0i, hr, hi, jr, ji,
                            gTr, gTi, plan.rows, ksr, ksi, g0r, g0i, Cbp,
                            scratch)),
        *streamk._dims(plan, E, nt, B, N), G, bc, threads, smem,
        int(layout == "global"),
        torch.cuda.current_stream(dev).cuda_stream,
        *streamk.stack_strides(plan), helpers, streamk._ptr(ring),
        streamk._ptr(flags))
    if err != 0:
        raise RuntimeError(f"streamk_mid_bwd launch failed: CUDA error {err}")
    if plan.per_block:
        streamk_mid_packed_bwd_launches += 1
    else:
        streamk_mid_bwd_launches += 1
    _log("bwd", E, B, N, shape, schedule=schedule, helpers=max(helpers, 0))
    return g0r.sum(0), g0i.sum(0), Cbp.sum(1)
