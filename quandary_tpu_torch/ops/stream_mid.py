"""Launches of the mid-size streamed-plane kernel pair, csrc/stream_mid.cu:
the contract of ops/stream.py (ports of quandary_tpu/ops/pallas_stream.py::
make_stream_propagate, ops/pallas_adjoint.py::make_pallas_propagate and
ops/pallas_kernels.py::pallas_propagate_dense) for candidates that one
thread block of csrc/stream.cu cannot hold. A forward launch runs a
thread-block cluster of G CTAs per (candidate, chunk of Bc basis states), a
backward one per (candidate, track of chunks run in turn), each CTA on a
band of the state entries, reading its bands of the planes H(t) from device
memory.

This module holds the pair's ctypes binding, its five launch counters (one
per member and direction, kept out of ``stream.launch_counts()``) and its
two launch wrappers. The planner (``stream._mid_shape``), the gates
(``stream.mid_refusal``, ``stream.route_refusal``) and the dispatch
(``stream._kernel_fwd`` / ``_kernel_bwd`` send a plan here wherever
``stream.uses_mid``) are in ops/stream.py, with the plain torch version the
pair is held against. A wrapper launches the kernel or raises: nothing falls
back to the one-block pair or to the plain version.
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import cuda_build, stream, streamk

# launches of each kernel since the counters were last set to 0
stream_mid_fwd_launches = 0
stream_mid_bwd_launches = 0
chunk_mid_fwd_launches = 0
chunk_mid_bwd_launches = 0
dense_mid_fwd_launches = 0
_COUNTERS = ("stream_mid_fwd_launches", "stream_mid_bwd_launches",
             "chunk_mid_fwd_launches", "chunk_mid_bwd_launches",
             "dense_mid_fwd_launches")

_SRC = os.path.join(cuda_build.CSRC_DIR, "stream_mid.cu")
# the shape of the last launch of each direction, as the wrapper ran it
# (member, cluster size G, states per cluster Bc, threads, shared-memory
# bytes, layout, band rows R, clusters, CTAs; the backward's tracks, its
# schedule and the replay and helper clusters per chain cluster)
mid_layouts = {}
_SCHEDULED = set()      # launch shapes whose clusters the card holds
_HOLDS = {}             # clusters of a launch shape the card holds at once


def launch_counts() -> dict:
    """The five launch counters by name."""
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
    dims = [i] * 7 + [f, f] + [i] * 5
    helpers = [i, i, i, p, p]       # helpers, hsmem, rslots, ring, flags
    for name, npt, more, tail in (("stream_mid_fwd_launch", 11, [i], []),
                                  ("chunk_mid_fwd_launch", 11, [i], []),
                                  ("dense_mid_fwd_launch", 11, [i], []),
                                  ("stream_mid_bwd_launch", 18, [i], helpers),
                                  ("chunk_mid_bwd_launch", 18, [i], helpers)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [p] * npt + dims + more + [p] + tail, i
    lib.stream_mid_max_clusters.argtypes = [i] * 5
    lib.stream_mid_max_clusters.restype = i


def build_kernels(verbose: bool = False):
    """Compile csrc/stream_mid.cu (cuda_build.build_library) and load it,
    once per process. Returns (library path, build seconds, compiler
    output)."""
    return cuda_build.build_library(_SRC, _bind, verbose)


def _lib():
    return cuda_build.library(_SRC, _bind)


def _launch_shape(lib, plan, E, B, N, nt, backward, layout=None,
                  rows=None):
    """stream._mid_shape of a launch (the forward's: stream._mid_fwd_shape,
    with its band rows); raises NotImplementedError where the mid pair
    refuses the plan (or the forced `layout` or forward band `rows` do not
    fit), and RuntimeError where the card cannot hold one cluster of the
    shape (cudaOccupancyMaxActiveClusters, asked once per shape)."""
    store = plan.store_iters and plan.iters > 0
    why = stream.mid_refusal(E, B, N, plan.iters, nt, store, plan.kind)
    if why is not None:
        raise NotImplementedError(why)
    shape = (stream._mid_shape(E, B, N, plan.iters, store, True, layout)
             if backward else
             stream._mid_fwd_shape(E, B, N, plan.iters, store, layout, rows))
    if shape is None:
        raise NotImplementedError(
            f"stream mid kernels: layout {layout!r} (band rows {rows}) does "
            f"not fit a CTA at N = {N}, B = {B}, iters = {plan.iters}")
    G, bc, threads, smem = shape[:4]
    kind = 2 if backward else int(plan.kind == "dense")
    key = (kind, bc, G, threads, smem)
    if key not in _SCHEDULED:
        if lib.stream_mid_max_clusters(kind, bc, G, threads, smem) < 1:
            raise RuntimeError(
                f"{plan.kind}_mid_{'bwd' if backward else 'fwd'}: the card "
                f"holds no cluster of {G} CTAs of {threads} threads and "
                f"{smem} bytes of shared memory")
        _SCHEDULED.add(key)
    return shape


def _log(key, plan, E, B, N, shape, tracks=None, **more):
    G, bc, threads, smem, layout = shape[:5]
    clusters = E * (tracks or -(-B // bc))
    mid_layouts[key] = dict(kind=plan.kind, G=G, Bc=bc, threads=threads,
                            smem=smem, layout=layout, R=-(-N // G),
                            clusters=clusters, ctas=clusters * G, **more)
    if key == "fwd":
        mid_layouts[key]["rows"] = shape[5]
    if tracks:
        mid_layouts[key]["tracks"] = tracks


def _kernel_fwd(plan, Hr, Hi, x0r, x0i, _layout=None, _rows=None):
    """One forward launch of the plan's member: (xTr, xTi, hr, hi, ksr, ksi);
    the history is None for 'dense', the stage iterates unless stored.
    `_layout` forces the bands' layout ('smem2', 'smem1', 'global'; the
    planner's by default), `_rows` its band rows past the whole slots
    (stream.mid_fwd_rows; 0 in 'global': the whole band from L2). Every
    layout and count gives the same bits."""
    stream._check_cuda(plan.rows, Hr, Hi, x0r, x0i)
    lib = _lib()
    E, nt, N = Hr.shape[0], Hr.shape[1], Hr.shape[-1]
    B = x0r.shape[0]
    shape = _launch_shape(lib, plan, E, B, N, nt, False, _layout, _rows)
    G, bc, threads, smem, layout, rows = shape
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=Hr.device)
    xTr, xTi = new(E, B, N), new(E, B, N)
    hr = hi = ksr = ksi = None
    if plan.kind != "dense":
        hr, hi = new(E, nt, B, N), new(E, nt, B, N)
    if plan.store_iters and plan.iters > 0:
        ksr, ksi = new(E, nt, plan.iters, B, N), new(E, nt, plan.iters, B, N)
    err = getattr(lib, f"{plan.kind}_mid_fwd_launch")(
        *map(streamk._ptr, (Hr, Hi, x0r, x0i, plan.rows, xTr, xTi, hr, hi,
                            ksr, ksi)),
        *stream._dims(plan, E, nt, B, N), G, bc, threads, smem,
        stream.MID_SLOTS[layout], rows,
        torch.cuda.current_stream(Hr.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{plan.kind}_mid_fwd launch failed: CUDA error "
                           f"{err}")
    globals()[f"{plan.kind}_mid_fwd_launches"] += 1
    _log("fwd", plan, E, B, N, shape)
    return xTr, xTi, hr, hi, ksr, ksi


def _holds(lib, kind, bc, G, threads, smem):
    """Clusters of a launch shape the card holds at once
    (stream_mid_max_clusters), asked once per shape."""
    key = (kind, bc, G, threads, smem)
    if key not in _HOLDS:
        _HOLDS[key] = lib.stream_mid_max_clusters(kind, bc, G, threads, smem)
    return _HOLDS[key]


def _kernel_bwd(plan, Hr, Hi, x0r, x0i, hr, hi, ksr, ksi, gTr, gTi, jr, ji,
                _layout=None, _tracks=None, _schedule=None, _helpers=None,
                _handoff=False):
    """One backward launch: (x0 cotangent (B, N) pair summed over the
    candidates, plane cotangent (E, nt, N, N) pair), on the schedule
    stream.mid_bwd_schedule picks from the card's count of clusters
    (`_schedule` forces one; a forced `_layout`, the chain's band layout,
    or `_tracks` implies 'chain' unless `_schedule` says otherwise).
    'helpers': `_helpers` forces the helper clusters per chain cluster
    (any count gives the same bits), `_handoff` has every replay cluster
    hand its steps from stream.MID_HELP_W on over to its chain, as where the
    card holds too few clusters (the same bits). Each track
    (stream.mid_tracks; `_tracks` forces a count) writes its own partial
    plane cotangent, summed here in a fixed order where there is more than
    one."""
    stream._check_cuda(plan.rows, Hr, Hi, x0r, x0i, hr, hi, gTr, gTi, jr, ji)
    if plan.kind == "dense":
        raise ValueError("the dense propagation is forward only")
    store = ksr is not None
    if store != (plan.store_iters and plan.iters > 0):
        raise ValueError("stored stage iterates do not match the plan")
    lib = _lib()
    E, nt, N = Hr.shape[0], Hr.shape[1], Hr.shape[-1]
    B = x0r.shape[0]
    iters = plan.iters
    if _schedule is None and (_layout is not None or _tracks is not None):
        _schedule = "chain"
    shape = _launch_shape(lib, plan, E, B, N, nt, True,
                          _layout if _schedule == "chain" else None)
    G, bc = shape[:2]
    replay = not store and iters > 0
    holds = None
    if _schedule is None and stream.mid_helpers_fit(E, B, N, iters, nt,
                                                    store, plan.kind):
        hs = stream._mid_help_shape(E, B, N, iters, store)
        holds = _holds(lib, 3, hs[1], hs[0], hs[2], hs[3])
    schedule = stream.mid_bwd_schedule(E, B, N, iters, nt, store, plan.kind,
                                       _schedule, holds)
    dev = Hr.device
    tracks = _tracks or stream.mid_tracks(E, B, N, nt, G, bc)
    if not 1 <= tracks <= -(-B // bc):
        raise ValueError(f"stream mid backward: {tracks} tracks for "
                         f"{-(-B // bc)} chunks of states")
    g0r = torch.empty((E, B, N), dtype=torch.float32, device=dev)
    g0i = torch.empty_like(g0r)
    Hbr = torch.empty((E, tracks, nt, N, N), dtype=torch.float32, device=dev)
    Hbi = torch.empty_like(Hbr)
    scratch = ring = flags = None
    if schedule == "helpers":
        shape = stream._mid_help_shape(
            E, B, N, iters, store, "global" if _layout == "global" else None)
        G, bc, threads, smem, layout, rslots = shape
        groups = E * tracks
        if _helpers is None:
            if holds is None:
                holds = _holds(lib, 3, bc, G, threads, smem)
            _helpers = stream.mid_helper_clusters(groups, G, holds, replay)
        helpers = max(0, _helpers)
        S = -(-(-(-B // bc)) // tracks) * nt
        ring = torch.empty(groups * stream._help_ring_floats(bc, N, iters,
                                                             replay),
                           dtype=torch.float32, device=dev)
        fi = stream._help_flag_ints(S)
        flags = torch.zeros(1 + groups * fi, dtype=torch.int32, device=dev)
        if _handoff:        # every group's replay hands over at MID_HELP_W
            flags[1::fi] = stream.MID_HELP_W + 1
        tail = (helpers, int(layout == "smem"), rslots)
        more = dict(schedule=schedule, helpers=helpers, replays=int(replay),
                    rslots=rslots)
    else:
        G, bc, threads, smem, layout = shape
        if layout == "global":
            R = -(-N // G)
            scratch = torch.empty(
                E * tracks * G * 2 * stream._pad4(R * (N + 1)),
                dtype=torch.float32, device=dev)
        tail = (-1, 0, 0)
        more = dict(schedule=schedule, helpers=0, replays=0)
    err = getattr(lib, f"{plan.kind}_mid_bwd_launch")(
        *map(streamk._ptr, (Hr, Hi, x0r, x0i, hr, hi, jr, ji, gTr, gTi,
                            plan.rows, ksr, ksi, g0r, g0i, Hbr, Hbi,
                            scratch)),
        *stream._dims(plan, E, nt, B, N), G, bc, threads, smem,
        stream.MID_SLOTS.get(layout, 0), tracks,
        torch.cuda.current_stream(dev).cuda_stream, *tail,
        streamk._ptr(ring), streamk._ptr(flags))
    if err != 0:
        raise RuntimeError(f"{plan.kind}_mid_bwd launch failed: CUDA error "
                           f"{err}")
    globals()[f"{plan.kind}_mid_bwd_launches"] += 1
    _log("bwd", plan, E, B, N, (G, bc, threads, smem, layout), tracks,
         **more)
    if tracks == 1:
        return g0r.sum(0), g0i.sum(0), Hbr[:, 0], Hbi[:, 0]
    return g0r.sum(0), g0i.sum(0), Hbr.sum(1), Hbi.sum(1)
