"""Launches of the mid-size density-matrix kernel pair, csrc/rho_mid.cu: the
contract of ops/rho.py (port of quandary_tpu/ops/pallas_rho.py::
make_rho_propagate, its forward and backward Pallas calls) for open systems
of 64 < N <= 128, which one CTA of csrc/rho.cu cannot hold (it keeps M and
the operand whole: six (N, N) planes forward, ten backward). A launch runs
a thread-block cluster of G CTAs per (candidate, density matrix), each CTA
on a band of rows; the operand stays whole in every CTA (one buffer), M(t)
goes band by band into a per-cluster scratch in device memory, served by L2.

Where the backward replays its stage iterates it runs on one of two
schedules (``bwd_schedule``): 'split', two clusters per matrix, a replay
that fills a ring of ``ring_slots`` steps' iterates in device memory ahead
of an adjoint that runs only the transposed chain, where the card holds
all 2 E B clusters at once; else 'chain', one cluster per matrix that
replays each step before its pairs. With stored iterates it reads them
('store').

This module holds the pair's launch planner (``_fwd_shape``, ``_bwd_shape``:
G, tile, threads, shared memory; the backward's schedule, ring and flags;
scratch floats per cluster), its ctypes binding, its launch counters and its
two launch wrappers. ``ops/rho.py`` sends every plan with N > 64, or one its
own planner refuses, here (``rho.uses_mid``), and keeps the gate
(``rho.launch_refusal``) and the plain torch version the pair is held
against. A wrapper launches the kernel or raises: nothing falls back to
csrc/rho.cu or to the plain version.
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import cuda_build, rho

# launches of each kernel since the counters were last set to 0
rho_mid_fwd_launches = 0
rho_mid_bwd_launches = 0
_COUNTERS = ("rho_mid_fwd_launches", "rho_mid_bwd_launches")

_SRC = os.path.join(cuda_build.CSRC_DIR, "rho_mid.cu")
# the widest density matrix the pair takes: the TPU kernel's range (one
# 128-lane tile; quandary_tpu/problem.py:517 packs no wider matrix)
MAX_N = 128
# the forward stores its stage iterates for at most this many iterations
# (pallas_rho.py:130-133), and within rho.KS_BUDGET_BYTES
MAX_STORED_ITERS = 8
# device-memory scratch per density matrix, in units of N^2 floats: the
# forward's M^T pair for two step parities; the backward's M pair, M^T pair
# (its own replay) and pre-step state pair (split frame) for two step
# parities, and the replay role's M^T pair for two
_FWD_SCRATCH, _BWD_SCRATCH = 4, 16
# the 'split' schedule's ring: steps of iterates per matrix between the
# replay and the adjoint (a replay step is shorter than an adjoint step: on
# an H100 at N = 125 the split backward takes what the one reading stored
# iterates takes, within 1%; two slots keep the replay ahead and a third
# absorbs jitter), down to two where all rings together would pass half
# the H100's 50 MB L2
RING_SLOTS = 3
RING_L2_BYTES = 25 << 20
# the shape of the last launch of each direction, as the wrapper ran it
# (G, tile, threads, shared-memory bytes, clusters, CTAs; the backward's
# schedule and ring slots)
mid_layouts = {}
_SCHEDULED = {}         # launch shape -> clusters of it the card holds


def launch_counts() -> dict:
    """The two launch counters by name."""
    return {k: globals()[k] for k in _COUNTERS}


def reset_launch_counts() -> None:
    for k in _COUNTERS:
        globals()[k] = 0


def add_launches(counts: dict, times: int = 1) -> None:
    """Add `times` x `counts` to the counters (a CUDA graph's replay)."""
    for k, v in counts.items():
        globals()[k] += times * v


def _fwd_layout_bytes(N, G, K, jb, threads):
    """Shared memory the forward carves: one mbarrier (in 8 floats), the
    operand (one buffer of (re, im) planes of row stride N | 1) and jb jump
    scratch bands of ceil(N / G) rows."""
    ld, R = N | 1, -(-N // G)
    return 4 * (8 + 2 * N * ld + 2 * jb * R * ld)


def _bwd_layout_bytes(N, G, K, jb, threads):
    """Shared memory the backward carves: two mbarriers and the role's
    header (8 floats), the operand (one buffer), jb jump scratch bands, the
    pair input's row band (ceil(N / G) x (N | 1)) and column band
    (N x ceil(N / G)), each (re, im), the warps' C-bar partials and the
    cluster's (G x K)."""
    ld, R = N | 1, -(-N // G)
    return 4 * (8 + 2 * N * ld + 2 * jb * R * ld + 2 * R * (ld + N)
                + (threads // 32 + G) * K)


def _fwd_shape(E, B, N, K, J, G=None, max_g=16):
    """(G, tile, threads, shared-memory bytes) of a forward launch: rho.py's
    rule (rho._cluster_shape) on this pair's layout."""
    return rho._cluster_shape("rho_mid_fwd", _fwd_layout_bytes, 1, E, B, N,
                              K, J, G, max_g)


def _bwd_shape(E, B, N, K, J, G=None, max_g=16):
    """_fwd_shape of a backward launch: its threads also cover the K stack
    slots of the C-bar reduction."""
    return rho._cluster_shape("rho_mid_bwd", _bwd_layout_bytes, K, E, B, N,
                              K, J, G, max_g)


def shape_refusal(N: int, K: int):
    """Why the pair cannot hold an (N, N) density matrix with K stack slots
    (a sentence), or None: both shapes at E B = 132 and one jump operator."""
    for shape in (_fwd_shape, _bwd_shape):
        try:
            shape(1, rho._SMS, N, K, 1)
        except NotImplementedError as err:
            return f"rho kernel: {err}"
    return None


def ring_slots(EB: int, N: int, iters: int) -> int:
    """Steps of stage iterates per matrix in the 'split' schedule's ring:
    RING_SLOTS, or two where E B rings of RING_SLOTS would pass
    RING_L2_BYTES."""
    slot = 2 * iters * N * N * 4
    return RING_SLOTS if EB * RING_SLOTS * slot <= RING_L2_BYTES else 2


def flag_words(EB: int, W: int) -> int:
    """The backward's int32 flags: the ticket counter, a claim word per
    matrix, and a full and an empty count per (matrix, ring slot)."""
    return 1 + EB + 2 * EB * W


def bwd_scratch_floats(EB: int, N: int, iters: int, store: bool, W: int):
    """(device scratch floats, ring floats per plane) of a backward launch:
    _BWD_SCRATCH N^2 per matrix; the ring (E B, W, iters, N, N) of each
    plane where the iterates are replayed, none where they are stored."""
    ring = 0 if store else EB * W * max(iters, 1) * N * N
    return EB * _BWD_SCRATCH * N * N, ring


def bwd_schedule(store: bool, iters: int, EB: int, holds: int,
                 forced=None) -> str:
    """The backward's schedule: 'store' where it reads stored iterates (or
    has none, iters = 0); else 'split' where the card holds the 2 E B
    clusters of both roles at once (`holds` clusters of the launch shape),
    'chain' where it does not: there a replay cluster would wait for SMs
    another matrix's adjoint could use. `forced` ('split' or 'chain') is
    taken as it is where the iterates are replayed (the card tests and
    scripts/rho_mid_parent.py compare them); a schedule that does not fit
    the iterates raises ValueError."""
    if store or iters == 0:
        if forced not in (None, "store"):
            raise ValueError(f"rho_mid_bwd: schedule {forced!r} needs "
                             "replayed iterates")
        return "store"
    if forced is not None:
        if forced not in ("split", "chain"):
            raise ValueError(f"rho_mid_bwd: schedule {forced!r} is none of "
                             "'split', 'chain' for replayed iterates")
        return forced
    return "split" if 2 * EB <= holds else "chain"


def stores_iterates(plan, E, nt, B) -> bool:
    """Whether a forward keeps its stage iterates for the backward: the TPU
    kernel's default (iters <= 8, pallas_rho.py:130-133) and the JAX
    Problem's gate on bytes (rho.stores_iterates)."""
    return plan.iters <= MAX_STORED_ITERS and rho.stores_iterates(
        plan, E, nt, B)


def transposed_stacks(Sr, Si):
    """The (2, K, N, N) planes [Sr^T, Si^T] the backward reduces the u c^dag
    part of the H_eff cotangent against."""
    return torch.stack([Sr.transpose(-1, -2),
                        Si.transpose(-1, -2)]).contiguous()


def _bind(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rho_mid_fwd_launch.argtypes = [p] * 14 + [i] * 9 + [f, f] \
        + [i] * 4 + [p]
    lib.rho_mid_bwd_launch.argtypes = [p] * 21 + [i] * 9 + [f, f] \
        + [i] * 6 + [p]
    for name in ("rho_mid_fwd_launch", "rho_mid_bwd_launch"):
        getattr(lib, name).restype = i
    for name in ("rho_mid_fwd_max_clusters", "rho_mid_bwd_max_clusters"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [i] * 4, i


def build_kernels(verbose: bool = False):
    """Compile csrc/rho_mid.cu (cuda_build.build_library) and load it, once
    per process. Returns (library path, build seconds, compiler output)."""
    return cuda_build.build_library(_SRC, _bind, verbose)


def _lib():
    return cuda_build.library(_SRC, _bind)


def holds(lib, backward, shape) -> int:
    """How many clusters of a launch shape (G, tile, threads, shared-memory
    bytes) the card holds at once, asked of it once per shape."""
    key = (backward,) + tuple(shape)
    if key not in _SCHEDULED:
        fn = lib.rho_mid_bwd_max_clusters if backward \
            else lib.rho_mid_fwd_max_clusters
        _SCHEDULED[key] = fn(shape[1], shape[0], *shape[2:])
    return _SCHEDULED[key]


def launch_shape(lib, backward, plan, E, B, G=None):
    """(G, tile, threads, shared-memory bytes) of a launch. Clusters of 16
    CTAs are beyond the portable size: the rule takes them only where the
    card's occupancy query schedules one, else it stops at 8. A G asked for
    is taken as it is; a shape the card cannot schedule raises."""
    shape_fn = _bwd_shape if backward else _fwd_shape
    shape = shape_fn(E, B, plan.N, plan.K, plan.njump, G)
    if G is None and shape[0] == 16 and not holds(lib, backward, shape):
        shape = shape_fn(E, B, plan.N, plan.K, plan.njump, max_g=8)
    if not holds(lib, backward, shape):
        raise RuntimeError(
            f"rho_mid_{'bwd' if backward else 'fwd'}: the card holds no "
            f"cluster of {shape[0]} CTAs of {shape[2]} threads and "
            f"{shape[3]} bytes of shared memory")
    return shape


def _log(key, E, B, shape, schedule=None, ring=None):
    G, tile, threads, smem = shape
    clusters = E * B * (2 if schedule == "split" else 1)
    mid_layouts[key] = dict(G=G, tile=tile, threads=threads, smem=smem,
                            clusters=clusters, ctas=clusters * G,
                            schedule=schedule, ring=ring)


def _kernel_fwd(plan, x0r, x0i, C, _cluster=None):
    """One rho_mid_fwd launch: (xTr, xTi, hr, hi, ksr, ksi). `_cluster`
    forces the CTAs per matrix (the card tests compare them)."""
    global rho_mid_fwd_launches
    rho._check_cuda(plan, x0r, x0i, C)
    lib = _lib()
    E, nt, _ = C.shape
    B, N, _ = x0r.shape
    shape = launch_shape(lib, False, plan, E, B, _cluster)
    G, tile, threads, smem = shape
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=C.device)
    xTr, xTi = new(E, B, N, N), new(E, B, N, N)
    hr, hi = new(E, nt, B, N, N), new(E, nt, B, N, N)
    ksr = ksi = None
    store = stores_iterates(plan, E, nt, B)
    if store:
        ksr = new(E, B, nt, plan.iters, N, N)
        ksi = new(E, B, nt, plan.iters, N, N)
    scr = new(E * B * _FWD_SCRATCH * N * N)
    err = lib.rho_mid_fwd_launch(
        *map(rho._ptr, (plan.Sr, plan.Si, plan.L, C, x0r, x0i, plan.planes,
                        xTr, xTi, hr, hi, ksr, ksi, scr)),
        *rho._dims(plan, E, nt, B, store), tile, G, threads, smem,
        torch.cuda.current_stream(C.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rho_mid_fwd launch failed: CUDA error {err}")
    rho_mid_fwd_launches += 1
    _log("fwd", E, B, shape)
    return xTr, xTi, hr, hi, ksr, ksi


def _kernel_bwd(plan, x0r, x0i, C, hr, hi, ksr, ksi, gTr, gTi, jr, ji,
                _cluster=None, _schedule=None):
    """One rho_mid_bwd launch: (x0 cotangent pair summed over the
    candidates, Cb (E, nt, K) summed over the density matrices). The
    stage iterates are replayed where `ksr` is None, on the schedule
    bwd_schedule picks for the card (`_schedule` forces one)."""
    global rho_mid_bwd_launches
    rho._check_cuda(plan, x0r, x0i, C, hr, hi, gTr, gTi, jr, ji)
    lib = _lib()
    E, nt, K = C.shape
    B, N, _ = x0r.shape
    shape = launch_shape(lib, True, plan, E, B, _cluster)
    G, tile, threads, smem = shape
    store = ksr is not None
    schedule = bwd_schedule(store, plan.iters, E * B,
                            holds(lib, True, shape), _schedule)
    W = ring_slots(E * B, N, plan.iters) if schedule == "split" else 1
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=C.device)
    scr_floats, ring_floats = bwd_scratch_floats(E * B, N, plan.iters, store,
                                                 W)
    if not store:       # the ring of replayed iterates
        ksr, ksi = new(ring_floats), new(ring_floats)
    St = plan.St if plan.St is not None else transposed_stacks(plan.Sr,
                                                               plan.Si)
    g0r, g0i = new(E, B, N, N), new(E, B, N, N)
    Cb = new(E, B, nt, K)
    scr = new(scr_floats)
    flags = torch.zeros(flag_words(E * B, W), dtype=torch.int32,
                        device=C.device)
    err = lib.rho_mid_bwd_launch(
        *map(rho._ptr, (plan.Sr, plan.Si, St, plan.L, C, x0r, x0i, hr, hi,
                        jr, ji, gTr, gTi, plan.planes, ksr, ksi, g0r, g0i, Cb,
                        scr, flags)),
        *rho._dims(plan, E, nt, B, store), tile, G, threads, smem,
        int(schedule == "split"), W,
        torch.cuda.current_stream(C.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rho_mid_bwd launch failed: CUDA error {err}")
    rho_mid_bwd_launches += 1
    _log("bwd", E, B, shape, schedule, W)
    # x0 is shared by the candidates; the coefficients by the matrices
    return g0r.sum(0), g0i.sum(0), Cb.sum(1)
