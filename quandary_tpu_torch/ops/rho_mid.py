"""Launches of the mid-size density-matrix kernel pair, csrc/rho_mid_fwd.cu
(the forward) and csrc/rho_mid.cu (the backward): the contract of ops/rho.py
(port of quandary_tpu/ops/pallas_rho.py::make_rho_propagate, its forward and
backward Pallas calls) for open systems of 64 < N <= 128, which one CTA of
csrc/rho.cu cannot hold (it keeps M and the operand whole: six (N, N)
planes forward, ten backward). A launch runs a thread-block cluster of G
CTAs per (candidate, density matrix), each CTA on a band of rows; the
operand stays whole in every CTA (one buffer), M(t) goes band by band into
a per-cluster scratch in device memory, served by L2. The forward keeps
its band factors in shared memory (``fwd_layout`` plans them) and reads
the whole ones (M^T, the packed L^dag planes, ``packed_jumps``) from L2,
16 bytes a lane.

Where the backward replays its stage iterates it runs on one of two
schedules (``bwd_schedule``): 'split', two clusters per matrix, a replay
that fills a ring of ``ring_slots`` steps' iterates in device memory ahead
of an adjoint that runs only the transposed chain, where the card holds
all 2 E B clusters at once; else 'chain', one cluster per matrix that
replays each step before its pairs. With stored iterates it reads them
('store').

This module holds the pair's launch planner (``_fwd_shape`` and
``fwd_layout``, ``_bwd_shape``: G, tile, threads, shared memory; the
forward's jump bands; the backward's schedule, ring and flags; scratch
floats per cluster), its ctypes bindings, its launch counters and its two
launch wrappers. ``ops/rho.py`` sends every plan with N > 64, or one its
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
_FWD_SRC = os.path.join(cuda_build.CSRC_DIR, "rho_mid_fwd.cu")
# the widest density matrix the pair takes: the TPU kernel's range (one
# 128-lane tile; quandary_tpu/problem.py:517 packs no wider matrix)
MAX_N = 128
# the forward stores its stage iterates for at most this many iterations
# (pallas_rho.py:130-133), and within rho.KS_BUDGET_BYTES
MAX_STORED_ITERS = 8
# device-memory scratch per density matrix of the backward, in units of
# N^2 floats: its M pair, M^T pair (its own replay) and pre-step state pair
# (split frame) for two step parities, and the replay role's M^T pair for
# two (the forward's: fwd_scratch_floats)
_BWD_SCRATCH = 16
# the forward's instances (1, 2, 4 rows a thread) and the threads each runs
# at most, one CTA an SM: 256 (255 registers a thread), 512 at 4 rows (128
# registers; csrc/rho_mid_fwd.cu's fwd_max_threads)
FWD_TILES = (1, 2, 4)
FWD_MAX_THREADS = {1: 256, 2: 256, 4: 512}
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


def fwd_ldc(N):
    """The forward's row stride of a whole (N, N) factor in complex
    entries: N rounded up to even, so that every row starts on 16 bytes."""
    return N + (N & 1)


def fwd_band(N, G, rank):
    """Rows [r0, r1) of the forward's CTA `rank`: whole pairs of rows, P =
    ceil(N / 2) of them split as rank P / G, so that every band starts on
    an even row (the jump bands' 16-byte loads); the last ends at N."""
    P = -(-N // 2)
    return 2 * (rank * P // G), min(N, 2 * ((rank + 1) * P // G))


def fwd_rows(N, G):
    """The longest of the forward's bands: 2 ceil(ceil(N / 2) / G) rows."""
    P = -(-N // 2)
    return 2 * -(-P // G)


def fwd_tile(N, G):
    """Rows a thread takes of the forward's band of fwd_rows rows (two
    adjacent columns each): the smallest of FWD_TILES whose tiles take at
    most its FWD_MAX_THREADS threads (more warps hide more latency), or
    None."""
    R, nct = fwd_rows(N, G), -(-N // 2)
    for tile in FWD_TILES:
        if -(-R // tile) * nct <= FWD_MAX_THREADS[tile]:
            return tile
    return None


def fwd_smem_bytes(N, G, J, tile, jb, lres):
    """Shared memory csrc/rho_mid_fwd.cu carves (its fwd_smem): the
    operand's mbarrier (in 16 bytes), the operand F (N x ldc complex) and
    four kinds of transposed band (N x Rp complex, Rp the band's rows
    padded to whole tiles): the operand's, M's, jb jump first factors and,
    where resident (lres), the J jump bands."""
    ldc, R = fwd_ldc(N), fwd_rows(N, G)
    Rp = -(-R // tile) * tile
    return 16 + 8 * N * ldc + 8 * N * Rp * (2 + jb + (J if lres else 0))


def fwd_layout(N, G, J):
    """The forward's layout on clusters of G CTAs, or None where it does
    not fit: dict(tile, threads, jb, lres, smem). The jump bands stay
    resident where they fit beside one jump first factor; the jump first
    factors (jb, at most J) take the rest."""
    tile = fwd_tile(N, G)
    if tile is None:
        return None
    R, nct = fwd_rows(N, G), -(-N // 2)
    threads = 32 * -(-(-(-R // tile) * nct) // 32)
    MAX = cuda_build.MAX_SMEM
    jb0 = int(J > 0)
    if fwd_smem_bytes(N, G, J, tile, jb0, False) > MAX:
        return None
    lres = J > 0 and fwd_smem_bytes(N, G, J, tile, jb0, True) <= MAX
    jb = jb0
    if J > 0:
        band = (fwd_smem_bytes(N, G, J, tile, 2, False)
                - fwd_smem_bytes(N, G, J, tile, 1, False))
        jb = min(J, 1 + (MAX - fwd_smem_bytes(N, G, J, tile, 1, lres))
                 // band)
    return dict(tile=tile, threads=threads, jb=jb, lres=int(lres),
                smem=fwd_smem_bytes(N, G, J, tile, jb, lres))


def fwd_scratch_floats(EB, N):
    """The forward's device scratch: per cluster M^T (N x ldc complex) for
    two step parities."""
    return EB * 4 * N * fwd_ldc(N)


def packed_jumps(L):
    """The (J, N, ldc, 2) packing of the jump planes L^dag (planes 2 and 3
    of rho's (4, J, N, N) L) that the forward reads from device memory as
    the whole factor of (L_l v) L_l^dag and, conjugated, as its jump bands
    where they are not resident: (re, im) interleaved, rows padded with
    zeros to ldc entries, so that every row starts on 16 bytes (its loads
    take 16 bytes a lane)."""
    J, N = L.shape[1], L.shape[-1]
    out = L.new_zeros(J, N, fwd_ldc(N), 2)
    out[:, :, :N, 0] = L[2]
    out[:, :, :N, 1] = L[3]
    return out


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
    rule for G (rho._cluster_shape), growing G where fwd_layout does not
    fit; an explicit G is taken as it is. Raises NotImplementedError where
    nothing fits."""
    if G is None:
        G = 1
        while (2 * G <= max_g and 2 * G <= N // 2
               and 2 * G * E * B <= rho._SMS
               and (4 + 2 * J) * N ** 3 >= 2 * G * rho._PAIR_WORK):
            G *= 2
        grow = True
    else:
        if G not in rho._CLUSTERS or G > N:
            raise ValueError(f"rho_mid_fwd cluster of {G} CTAs for N = {N}: "
                             f"G must be one of {rho._CLUSTERS} and at most "
                             "N")
        grow = False
    while True:
        lay = fwd_layout(N, G, J)
        if lay is not None:
            return G, lay["tile"], lay["threads"], lay["smem"]
        if not grow or 2 * G > min(N, max_g):
            raise NotImplementedError(
                f"rho_mid_fwd: a cluster of {G} CTAs cannot hold N = {N}, "
                f"K = {K}, J = {J} in {cuda_build.MAX_SMEM} bytes of shared "
                "memory each")
        G *= 2


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
    lib.rho_mid_bwd_launch.argtypes = [p] * 21 + [i] * 9 + [f, f] \
        + [i] * 6 + [p]
    lib.rho_mid_bwd_launch.restype = i
    lib.rho_mid_bwd_max_clusters.argtypes = [i] * 4
    lib.rho_mid_bwd_max_clusters.restype = i


def _bind_fwd(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rho_mid_fwd_launch.argtypes = [p] * 15 + [i] * 9 + [f, f] \
        + [i] * 6 + [p]
    lib.rho_mid_fwd_launch.restype = i
    lib.rho_mid_fwd_max_clusters.argtypes = [i] * 4
    lib.rho_mid_fwd_max_clusters.restype = i


def _build_fwd(verbose=False):
    return cuda_build.build_library(_FWD_SRC, _bind_fwd, verbose)


def _build_bwd(verbose=False):
    return cuda_build.build_library(_SRC, _bind, verbose)


def build_kernels(verbose: bool = False):
    """Compile csrc/rho_mid_fwd.cu and csrc/rho_mid.cu, one nvcc each and
    both at once (cuda_build.build_parallel), and load them, once per
    process. Returns (both library paths, the longer build's seconds, both
    compilers' output)."""
    built = cuda_build.build_parallel([_build_fwd, _build_bwd], verbose)
    return (", ".join(b[0] for b in built), max(b[1] for b in built),
            "".join(b[2] for b in built))


def _lib():
    """The backward's library (csrc/rho_mid.cu), built at first use."""
    return cuda_build.library(_SRC, _bind)


def _fwd_lib():
    """The forward's library (csrc/rho_mid_fwd.cu), built at first use."""
    return cuda_build.library(_FWD_SRC, _bind_fwd)


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


def _log(key, E, B, shape, schedule=None, ring=None, **more):
    G, tile, threads, smem = shape
    clusters = E * B * (2 if schedule == "split" else 1)
    mid_layouts[key] = dict(G=G, tile=tile, threads=threads, smem=smem,
                            clusters=clusters, ctas=clusters * G,
                            schedule=schedule, ring=ring, **more)


def _kernel_fwd(plan, x0r, x0i, C, _cluster=None, _layout=None):
    """One rho_mid_fwd launch: (xTr, xTi, hr, hi, ksr, ksi). `_cluster`
    forces the CTAs per matrix, `_layout` (some of tile, jb, lres)
    fwd_layout's (the card tests hold the bits to them,
    scripts/rho_mid_fwd_split.py times them)."""
    global rho_mid_fwd_launches
    rho._check_cuda(plan, x0r, x0i, C)
    lib = _fwd_lib()
    E, nt, _ = C.shape
    B, N, _ = x0r.shape
    shape = launch_shape(lib, False, plan, E, B, _cluster)
    G, tile, threads, smem = shape
    lay = fwd_layout(N, G, plan.njump)
    if _layout is not None:
        lay = dict(lay, **_layout)
        tile = lay["tile"]
        nrt, nct = -(-fwd_rows(N, G) // tile), -(-N // 2)
        threads = 32 * -(-(nrt * nct) // 32)
        smem = fwd_smem_bytes(N, G, plan.njump, tile, lay["jb"], lay["lres"])
        if smem > cuda_build.MAX_SMEM or threads > FWD_MAX_THREADS[tile]:
            raise ValueError(f"rho_mid_fwd: layout {lay} takes {smem} bytes "
                             f"of shared memory and {threads} threads")
        shape = G, tile, threads, smem
    Lp = None
    if plan.L is not None:
        Lp = plan.Lp if plan.Lp is not None else packed_jumps(plan.L)
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=C.device)
    xTr, xTi = new(E, B, N, N), new(E, B, N, N)
    hr, hi = new(E, nt, B, N, N), new(E, nt, B, N, N)
    ksr = ksi = None
    store = stores_iterates(plan, E, nt, B)
    if store:
        ksr = new(E, B, nt, plan.iters, N, N)
        ksi = new(E, B, nt, plan.iters, N, N)
    scr = new(fwd_scratch_floats(E * B, N))
    err = lib.rho_mid_fwd_launch(
        *map(rho._ptr, (plan.Sr, plan.Si, plan.L, Lp, C, x0r, x0i,
                        plan.planes, xTr, xTi, hr, hi, ksr, ksi, scr)),
        *rho._dims(plan, E, nt, B, store), tile, G, threads, smem,
        lay["jb"], lay["lres"],
        torch.cuda.current_stream(C.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rho_mid_fwd launch failed: CUDA error {err}")
    rho_mid_fwd_launches += 1
    _log("fwd", E, B, shape, jb=lay["jb"], lres=lay["lres"])
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
