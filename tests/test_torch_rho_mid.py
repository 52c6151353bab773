"""Open systems of 64 < N <= 128 on the density-matrix route of
quandary_tpu_torch (csrc/rho_mid.cu, the rest of the range of
quandary_tpu/ops/pallas_rho.py::make_rho_propagate) on the CPU.

The kernels run only on the card (tests/test_torch_cuda.py -k rho_mid and
chip_smoke.py phase 26 hold them against the plain version there). Here:

1. the planner (`rho_mid._fwd_shape` and `fwd_layout`, `_bwd_shape`):
   every shape of the range fits 227 KB of shared memory at G in 1..16 and
   at most 1024 threads, and holds the layout csrc/rho_mid_fwd.cu and
   csrc/rho_mid.cu carve; a model of the forward's thread-to-entry map
   (every entry of every band owned once, every load within its buffer);
   the packed jump planes it reads; the backward's
   schedules ('store', 'split', 'chain'), its ring of replayed iterates,
   its flags and scratch, and a step-level model of the 'split'
   schedule's tickets and hand-off: no cluster waits on one that has not
   started, on a card that holds 1 to 8 clusters at once;
2. the gate: `rho.launch_refusal` admits N <= 128 and refuses past it with
   a sentence naming quandary_tpu/problem.py:517, where the JAX Problem
   raises; the qudits125-shaped Problem takes the rho route wherever the
   JAX gate does;
3. dispatch: past N = 64 a launch goes to the mid pair, and a CUDA tensor
   never takes the plain version; the store-iterates rule;
4. the slice: a qudits125-shaped system (three 5-level qudits, N = 125,
   six collapse operators, '3states', jacobi with 6 iterations, 3 steps)
   through rho_propagate_plain against make_rho_propagate(interpret=True)
   at 'highest' (exact f32 products), within tests/test_torch_rho.py's
   bounds (2e-4 states, 5e-4 cotangents, of max); and through the port's
   Problem against the JAX Problem with pallas=True (its rho kernel in
   interpret mode) in f32, and in f64 against the JAX scan (1e-10 /
   1e-9 of max).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread per test process, so that test processes running side by side
# do not fight over the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from quandary_tpu.ops import pallas_rho  # noqa: E402
from quandary_tpu.problem import Problem as JProblem  # noqa: E402
from quandary_tpu_torch.ops import cuda_build, rho, rho_mid  # noqa: E402
from quandary_tpu_torch.problem import Problem as TProblem  # noqa: E402
from quandary_tpu_torch.problem import _jax_size_gate  # noqa: E402
from test_torch_model import port_setup  # noqa: E402

QUDITS125 = dict(nlevels=[5, 5, 5], freq01=[4.80595, 4.8601, 4.9],
                 selfkerr=[0.2198, 0.2252, 0.22], jkl=[0.005, 0.0, 0.004],
                 decay=[80.0, 90.0, 85.0], dephase=[40.0, 45.0, 42.0])


def qudits_setup(cfg=QUDITS125, ntime=3, dtype=jnp.complex64, pallas=True,
                 nsplines=4):
    """scripts/perf/rho_bench.py:25-65's open system with the levels of
    `cfg` (qudits125: rho_bench's 3 qutrits with two more levels each),
    built with the JAX package's builders and cut to `ntime` steps of
    0.1 ns: T1/T2 collapse on every oscillator, '3states', a random pure
    target state (seed 42), Jtrace, gamma_tik 1e-4, 6 stage iterations."""
    from quandary_tpu.models.hamiltonian import build_standard_model
    from quandary_tpu.problem import Setup
    from quandary_tpu.utils.splines import ControlSegment, OscillatorControl
    nlevels = cfg["nlevels"]
    N = int(np.prod(nlevels))
    model = build_standard_model(
        nlevels=nlevels, freq01_ghz=cfg["freq01"],
        rotfreq_ghz=cfg["freq01"], selfkerr_ghz=cfg["selfkerr"],
        jkl_ghz=cfg["jkl"], crosskerr_ghz=[], decay_time=cfg["decay"],
        dephase_time=cfg["dephase"], lindblad=True)
    dt = 0.1
    oscs = tuple(OscillatorControl(
        segments=(ControlSegment("spline", nsplines=nsplines, tstart=0.0,
                                 tstop=ntime * dt),), carrier_freqs=(0.0,))
        for _ in nlevels)
    rng = np.random.default_rng(42)
    tgt = rng.normal(size=N) + 1j * rng.normal(size=N)
    tgt = tgt / np.linalg.norm(tgt)
    return Setup(
        model=model, nessential=tuple(nlevels), ntime=ntime, dt=dt,
        oscillators=oscs,
        ground_freqs_radns=tuple(2 * np.pi * f for f in cfg["freq01"]),
        initcond_type="3states", target_type="state",
        target_state_full=np.outer(tgt, tgt.conj()), objective_type="Jtrace",
        gamma_tik=1e-4, dtype=dtype, linsolve_iters=6, pallas=pallas,
        time_parallel=False)


# ---- 1. the planner ----

@pytest.mark.parametrize("EB", [1, 3, 16, 24, 132])
@pytest.mark.parametrize("K", [7, 11])
@pytest.mark.parametrize("J", [0, 1, 4, 6])
@pytest.mark.parametrize("N", [65, 72, 96, 125, 128])
def test_mid_shapes_fit(N, J, K, EB):
    """Both directions' shapes: G in 1..16 (at most N), whole warps over the
    band's tiles (the backward's over the K slots too) within the tile's
    bound and 1024 threads, at most 227 KB of shared memory. The backward's
    holds at least the layout csrc/rho_mid.cu carves with one jump band
    (all J where they fit, with the pair input's row and column bands),
    and one less jump band would not fill what was asked; the forward's is
    what fwd_layout plans (_fwd_layout_holds). The backward's ring of
    replayed iterates ('split': 3 steps a matrix, 2 where E B rings of 3
    pass half of L2), its flags and its scratch."""
    G, tile, threads, smem = rho_mid._fwd_shape(1, EB, N, K, J)
    _fwd_layout_holds(N, G, J, tile, threads, smem)
    G, tile, threads, smem = rho_mid._bwd_shape(1, EB, N, K, J)
    assert G in (1, 2, 4, 8, 16) and G <= N
    R, ld = -(-N // G), N | 1
    tiles = -(-R // tile) * -(-N // tile)
    assert threads % 32 == 0 and threads >= tiles
    assert threads <= (256 if tile == 4 else 512) <= 1024
    assert threads >= K
    fixed = 8 + 2 * N * ld + (threads // 32 + G) * K + 2 * R * (ld + N)
    band = 2 * R * ld
    assert smem <= cuda_build.MAX_SMEM == 227 * 1024
    assert (smem // 4 - fixed) % band == 0
    jb = (smem // 4 - fixed) // band
    assert jb == min(J, (cuda_build.MAX_SMEM // 4 - fixed) // band)
    assert (jb >= 1) == (J > 0)
    # the directions share G; few matrices spread over 16 CTAs each
    assert rho_mid._fwd_shape(1, EB, N, K, J)[0] \
        == rho_mid._bwd_shape(1, EB, N, K, J)[0]
    if EB <= 3:
        assert rho_mid._fwd_shape(1, EB, N, K, J)[0] == 16
    iters = 6
    W = rho_mid.ring_slots(EB, N, iters)
    slot = 2 * iters * N * N * 4
    assert W == (3 if EB * 3 * slot <= rho_mid.RING_L2_BYTES else 2)
    assert rho_mid.ring_slots(EB, N, iters) * EB * slot \
        <= max(rho_mid.RING_L2_BYTES, 2 * EB * slot)
    assert rho_mid.flag_words(EB, W) == 1 + EB + 2 * EB * W
    scr, ring = rho_mid.bwd_scratch_floats(EB, N, iters, False, W)
    assert scr == EB * 16 * N * N and ring == EB * W * iters * N * N
    assert rho_mid.bwd_scratch_floats(EB, N, iters, True, W)[1] == 0
    # the 'chain' schedule's ring is one step, as the single-role scratch
    assert rho_mid.bwd_scratch_floats(EB, N, iters, False, 1)[1] \
        == EB * iters * N * N


def _fwd_layout_holds(N, G, J, tile, threads, smem):
    """The forward's launch shape against what csrc/rho_mid_fwd.cu carves
    and checks: G in 1..16 (at most N); whole warps over the band's tiles of
    `tile` rows x 2 columns within FWD_MAX_THREADS[tile], the smallest tile
    that fits them; the carve in order (the operand's mbarrier, F, vB, MB,
    jb jump first factors, the resident jump bands) within `smem` <= 227
    KB, F on 16 bytes (the bulk copies and 16-byte loads), the bands on 16
    bytes where a thread loads two rows at once; 1 <= jb <= J (0 without
    jump operators) and one more jump band would not fit or is not needed;
    the jump bands resident where they fit; every exchange copy a multiple
    of 16 bytes and within an mbarrier's transaction count."""
    lay = rho_mid.fwd_layout(N, G, J)
    assert (lay["tile"], lay["threads"], lay["smem"]) == (tile, threads, smem)
    assert G in (1, 2, 4, 8, 16) and G <= N
    R, nct = rho_mid.fwd_rows(N, G), -(-N // 2)
    nrt = -(-R // tile)
    Rp, ldc = nrt * tile, rho_mid.fwd_ldc(N)
    assert ldc % 2 == 0 and N <= ldc <= N + 1
    assert threads % 32 == 0 and nrt * nct <= threads < nrt * nct + 32
    assert tile in rho_mid.FWD_TILES
    assert threads <= rho_mid.FWD_MAX_THREADS[tile] <= 512
    assert tile == 1 or (-(-R // (tile // 2)) * nct
                         > rho_mid.FWD_MAX_THREADS[tile // 2])
    jb, lres = lay["jb"], lay["lres"]
    assert (1 <= jb <= J) if J > 0 else jb == lres == 0
    # the carve, in bytes
    band = 8 * N * Rp
    sizes = [16, 8 * N * ldc, band, band, jb * band, J * band if lres else 0]
    offs = np.cumsum([0] + sizes)
    assert offs[-1] == smem <= cuda_build.MAX_SMEM == 227 * 1024
    assert offs[1] % 16 == 0 and offs[2] % 16 == 0
    if tile > 1:
        assert all(o % 16 == 0 for o in offs[2:6]) and Rp % 2 == 0
    if J > 0 and jb < J:
        assert smem + band > cuda_build.MAX_SMEM
    if J > 0 and not lres:
        assert smem - jb * band + (1 + J) * band > cuda_build.MAX_SMEM
    # the exchange: a band of rows to each other CTA; the operand's
    # mbarrier counts (N - R) rows of ldc complex at most
    assert (8 * ldc) % 16 == 0 and 8 * N * ldc < 1 << 20


@pytest.mark.parametrize("EB", [1, 3, 24, 132])
@pytest.mark.parametrize("J", range(7))
def test_fwd_layout_every_n(J, EB):
    """The forward's planner over every N of the range, 65 to 128, for K up
    to 11: a shape for every one (the rule's G, and each G of 4, 8, 16 asked
    for that the layout holds), each holding what the kernel carves."""
    for N in range(65, 129):
        for K in (1, 7, 11):
            G, tile, threads, smem = rho_mid._fwd_shape(1, EB, N, K, J)
            _fwd_layout_holds(N, G, J, tile, threads, smem)
            if EB <= 3:
                assert G == 16 and tile in (1, 2)
        for G in (4, 8, 16):
            if rho_mid.fwd_layout(N, G, J) is not None:
                _fwd_layout_holds(N, G, J, *rho_mid._fwd_shape(
                    1, EB, N, 7, J, G=G)[1:])
            else:
                with pytest.raises(NotImplementedError):
                    rho_mid._fwd_shape(1, EB, N, 7, J, G=G)


def _fwd_rows(tile, i):
    """The band rows of row tile i (csrc/rho_mid_fwd.cu's Cta::row less
    r0): `tile` adjacent rows from i tile."""
    return [i * tile + a for a in range(tile)]


def _fwd_entries(N, G, tile, threads, rank):
    """csrc/rho_mid_fwd.cu's thread-to-entry map on CTA `rank`: thread t <
    nrt nct takes row tile t % nrt and column tile t / nrt, rows
    _fwd_rows, columns 2 tc + b (b < 2), the others the last such thread's;
    an entry exists where its row is in the CTA's band and its column below
    N. Returns (the existing entries by thread, the band rows and columns
    each thread loads)."""
    r0, r1 = rho_mid.fwd_band(N, G, rank)
    R, nct = rho_mid.fwd_rows(N, G), -(-N // 2)
    nrt = -(-R // tile)
    owned, loads = {}, {}
    for t in range(threads):
        active = t < nrt * nct
        t0 = t if active else nrt * nct - 1
        rows, c0 = _fwd_rows(tile, t0 % nrt), 2 * (t0 // nrt)
        owned[t] = [(r0 + rl, c0 + b) for rl in rows for b in range(2)
                    if active and rl < r1 - r0 and c0 + b < N]
        loads[t] = (rows, c0, c0 + 2)
    return owned, loads


@pytest.mark.parametrize("EB", [1, 3, 24, 132])
def test_fwd_thread_map_owns_every_entry_once(EB):
    """For every (N, G, tile) the planner picks, N = 65 to 128 (and the G
    of 4, 8, 16 a caller may ask for): every entry of every CTA's band is
    owned by exactly one thread of that CTA and no thread owns an entry
    outside it; each thread's loads stay in the padded band (rows < Rp) and
    in a row of the whole factors (16-byte pairs of columns below ldc); its
    rows come in pairs that start on an even row (16-byte loads of a band
    factor); its jump band rows read from device memory (conj(Lp), clamped
    to ldc - 2) are 16-byte pairs within a row of Lp, and its existing rows
    read their own entries."""
    for N in range(65, 129):
        shapes = {rho_mid._fwd_shape(1, EB, N, 7, 4)}
        shapes |= {rho_mid._fwd_shape(1, EB, N, 7, 4, G=G) for G in (4, 8, 16)
                   if rho_mid.fwd_layout(N, G, 4) is not None}
        for G, tile, threads, _ in shapes:
            R = rho_mid.fwd_rows(N, G)
            Rp = -(-R // tile) * tile
            ldc = rho_mid.fwd_ldc(N)
            for rank in range(G):
                r0, r1 = rho_mid.fwd_band(N, G, rank)
                owned, loads = _fwd_entries(N, G, tile, threads, rank)
                got = sorted(e for es in owned.values() for e in es)
                band = [(r, c) for r in range(r0, r1) for c in range(N)]
                assert got == band
                for rows, c_lo, c_hi in loads.values():
                    assert len(rows) == tile
                    assert all(0 <= rl < Rp for rl in rows)
                    assert c_lo % 2 == 0 and 0 <= c_lo < c_hi
                    assert c_hi <= ldc
                    if tile == 1:
                        continue
                    for a in range(0, tile, 2):
                        assert rows[a] % 2 == 0 and rows[a + 1] == rows[a] + 1
                        xa = min(r0 + rows[a], ldc - 2)
                        assert xa % 2 == 0 and 0 <= xa and xa + 2 <= ldc
                        for row in (r0 + rows[a], r0 + rows[a] + 1):
                            if row < r1:
                                assert row in (xa, xa + 1)


@pytest.mark.parametrize("G", [1, 2, 4, 8, 16])
def test_fwd_bands(G):
    """The forward's bands of rows, N = 65 to 128: G bands in order that
    cover 0 .. N - 1 once, each starting on an even row (so the jump bands'
    16-byte pairs of rows are aligned) and none longer than fwd_rows, which
    the longest reaches (the last, ceil(ceil(N / 2) / G) pairs, one row
    short of it where N is odd); every band but the last is whole pairs."""
    for N in range(65, 129):
        bands = [rho_mid.fwd_band(N, G, q) for q in range(G)]
        assert bands[0][0] == 0 and bands[-1][1] == N
        assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
        assert all(r0 % 2 == 0 and r0 < r1 for r0, r1 in bands)
        assert all((r1 - r0) % 2 == 0 for r0, r1 in bands[:-1])
        assert max(r1 - r0 for r0, r1 in bands) \
            <= rho_mid.fwd_rows(N, G) <= max(r1 - r0 for r0, r1 in bands) + 1


def test_packed_jumps():
    """The packed jump planes: Lp[l, j, c] = L_l^dag(j, c) as (re, im),
    rows padded with zeros to an even count of entries; conj(Lp[l, j, r])
    is L_l(r, j), the jump band the forward reads where it is not
    resident; make_plan packs them past N = 64 only."""
    rng = np.random.default_rng(3)
    for N in (65, 96, 125):
        Ls = [rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N))
              for _ in range(2)]
        t = torch.zeros(3, N, N)
        plan = rho.make_plan(t, t, Ls, 0.1, 6)
        Lp = plan.Lp
        assert Lp.shape == (2, N, rho_mid.fwd_ldc(N), 2)
        assert torch.equal(Lp, rho_mid.packed_jumps(plan.L))
        assert torch.equal(Lp[:, :, :N, 0], plan.L[2])
        assert torch.equal(Lp[:, :, :N, 1], plan.L[3])
        assert not Lp[:, :, N:].any()
        assert torch.equal(Lp[:, :, :N, 0].transpose(-1, -2), plan.L[0])
        assert torch.equal(-Lp[:, :, :N, 1].transpose(-1, -2), plan.L[1])
    t = torch.zeros(3, 64, 64)
    assert rho.make_plan(t, t, [np.eye(64)], 0.1, 6).Lp is None
    assert rho.make_plan(torch.zeros(3, 96, 96), torch.zeros(3, 96, 96),
                         None, 0.1, 6).Lp is None


def test_fwd_wrapper_launch_arguments(monkeypatch):
    """The forward wrapper's launch through a stand-in for its library:
    the C signature's 33 arguments (15 pointers: the packed jump planes
    after L, the scratch of 2 N ldc complex per matrix last), the shape
    and fwd_layout's (jb, lres), one launch counted, the layout logged."""
    class Lib:
        def __init__(self):
            self.calls = []

        def rho_mid_fwd_max_clusters(self, tile, G, threads, smem):
            return 8

        def rho_mid_fwd_launch(self, *args):
            self.calls.append(args)
            return 0

    made = []
    real_empty = torch.empty
    monkeypatch.setattr(rho, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch, "empty", lambda *s, **k: made.append(
        s if len(s) != 1 or isinstance(s[0], int) else tuple(s[0]))
        or real_empty(*s, **k))
    N, K, B, nt = 125, 3, 3, 4
    t = torch.zeros(K, N, N)
    plan = rho.make_plan(t, t, [np.eye(N)] * 6, 0.1, 4)
    lib = Lib()
    monkeypatch.setattr(rho_mid, "_fwd_lib", lambda: lib)
    rho_mid._SCHEDULED.clear()
    before = rho_mid.rho_mid_fwd_launches
    x0, C = torch.zeros(B, N, N), torch.zeros(1, nt, K)
    xTr, xTi, hr, hi, ksr, ksi = rho_mid._kernel_fwd(plan, x0, x0, C)
    assert rho_mid.rho_mid_fwd_launches == before + 1
    (args,) = lib.calls
    assert len(args) == 33
    assert args[3] == plan.Lp.data_ptr()
    assert args[15:22] == (1, nt, B, N, K, 6, 4)
    G, tile, threads, smem = rho_mid._fwd_shape(1, B, N, K, 6)
    lay = rho_mid.fwd_layout(N, G, 6)
    assert args[26:32] == (tile, G, threads, smem, lay["jb"], lay["lres"])
    assert (rho_mid.fwd_scratch_floats(B, N),) in made
    assert rho_mid.fwd_scratch_floats(B, N) == B * 4 * N * 126
    assert rho_mid.mid_layouts["fwd"] == dict(
        G=G, tile=tile, threads=threads, smem=smem, clusters=B, ctas=B * G,
        schedule=None, ring=None, jb=lay["jb"], lres=lay["lres"])
    assert xTr.shape == (1, B, N, N) and hr.shape == (1, nt, B, N, N)
    rho_mid._SCHEDULED.clear()


def test_bwd_schedule_rule():
    """Replayed iterates take 'split' where the card holds both roles'
    2 E B clusters at once, else 'chain'; stored ones (or none, iters = 0)
    'store'; a schedule asked for is taken where it fits the iterates and
    raises where it does not."""
    sched = rho_mid.bwd_schedule
    assert sched(False, 6, 3, 8) == "split"
    assert sched(False, 6, 4, 8) == "split"
    assert sched(False, 6, 5, 8) == "chain"
    assert sched(False, 6, 24, 8) == "chain"
    assert sched(False, 6, 24, 33, "split") == "split"
    assert sched(False, 6, 1, 8, "chain") == "chain"
    assert sched(True, 6, 3, 8) == sched(False, 0, 3, 8) == "store"
    assert sched(True, 6, 3, 8, "store") == "store"
    for store, iters, forced in ((True, 6, "split"), (False, 0, "chain"),
                                 (False, 6, "store"), (False, 6, "ring")):
        with pytest.raises(ValueError, match="schedule"):
            sched(store, iters, 3, 8, forced)


def _split_model(EB, holds, nt, W, costs=(2, 3, 5)):
    """A step-level model of csrc/rho_mid.cu's 'split' schedule on a card
    that holds `holds` clusters at once. Clusters start as slots free and
    take tickets in the order they start: ticket 2m replays matrix m, 2m + 1
    is its adjoint. The replay fills ring slot s % W with step s; at step
    W, if no adjoint has claimed the matrix, it hands the rest of the steps
    to the adjoint (the claim word) and ends, else it waits for the adjoint
    to empty step s - W before it writes step s. The adjoint claims its
    matrix when it starts, waits for each step the replay fills and
    replays in its own chain from the step handed over. Each tick, every
    running cluster that does not wait does one tick of its step (costs:
    a replay step, an adjoint step, an adjoint step with its own replay).
    Returns (finished, waits, handed): waits lists (waiter ticket,
    waited-on ticket, whether that one had started), handed the matrices
    whose replay handed over."""
    n = 2 * EB
    started, done = [False] * n, [False] * n
    step, left, first = [0] * n, [0] * n, [nt] * n
    claim, produced, emptied = [0] * EB, [0] * EB, [0] * EB
    waits, handed, next_ticket = [], [], 0
    for _ in range(100 * n * nt * sum(costs)):
        while next_ticket < n and sum(started[i] and not done[i]
                                      for i in range(n)) < holds:
            t, m = next_ticket, next_ticket // 2
            started[t] = True
            if t % 2:               # the adjoint claims its matrix
                if claim[m]:
                    first[t] = claim[m] - 1
                claim[m] = -1
            next_ticket += 1
        if all(done):
            return True, waits, handed
        moved = False
        for t in range(n):
            if not started[t] or done[t]:
                continue
            m, s = t // 2, step[t]
            if t % 2 == 0:          # replay
                if left[t] == 0:
                    if s == nt:
                        done[t], moved = True, True
                        continue
                    if s == W and claim[m] == 0:
                        claim[m] = s + 1
                        handed.append(m)
                        done[t], moved = True, True
                        continue
                    if s >= W and emptied[m] < s - W + 1:
                        waits.append((t, t + 1, started[t + 1]))
                        continue
                    left[t] = costs[0]
                left[t] -= 1
                moved = True
                if left[t] == 0:
                    produced[m], step[t] = s + 1, s + 1
            else:                   # adjoint
                if left[t] == 0:
                    if s == nt:
                        done[t], moved = True, True
                        continue
                    own = s >= first[t]
                    if not own and produced[m] < s + 1:
                        waits.append((t, t - 1, started[t - 1]))
                        continue
                    left[t] = costs[2] if own else costs[1]
                left[t] -= 1
                moved = True
                if left[t] == 0:
                    if s < first[t]:
                        emptied[m] = s + 1
                    step[t] = s + 1
        if not moved:
            return False, waits, handed
    return False, waits, handed


@pytest.mark.parametrize("holds", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("EB", [1, 2, 3, 5, 8, 13, 24])
def test_split_tickets_wait_only_on_started_clusters(EB, holds):
    """The 'split' schedule's ticket order and hand-off, on a card that
    holds 1 to 8 clusters at once, E B from 1 to 24: every run finishes,
    no cluster waits on one that has not started (an adjoint only on its
    replay, whose ticket comes first; a replay only on an adjoint that has
    claimed the matrix), and where the card holds all 2 E B clusters no
    replay hands over."""
    for nt, W in ((12, 3), (7, 2), (2, 3)):
        finished, waits, handed = _split_model(EB, holds, nt, W)
        assert finished
        assert all(started for _, _, started in waits)
        assert all(waiter // 2 == on // 2 for waiter, on, _ in waits)
        if holds >= 2 * EB or nt <= W:
            assert handed == []
    # a card that holds one cluster: each replay hands over after W steps
    finished, _, handed = _split_model(EB, 1, 12, 3)
    assert finished and handed == list(range(EB))


def test_mid_shapes_of_the_configurations():
    """qudits125 (K = 11, J = 6) and qudits128 (K = 7, J = 4), 3 density
    matrices: clusters of 16 CTAs of 256 threads (2 x 2 tiles of bands of
    8 rows); the backward's every jump band in shared memory; the
    forward's jump bands resident and five (qudits125) or all four jump
    first factors at once; at E B = 24 4 rows a thread on 512 threads of
    clusters of 4, the jump bands read from L2; a G asked for is taken."""
    assert rho_mid._fwd_shape(1, 3, 125, 11, 6) == (16, 2, 256, 230016)
    assert rho_mid.fwd_layout(125, 16, 6) == dict(
        tile=2, threads=256, jb=5, lres=1, smem=230016)
    assert rho_mid._bwd_shape(1, 3, 125, 11, 6) == (16, 2, 256, 190088)
    assert rho_mid._fwd_shape(1, 3, 128, 7, 4)[:3] == (16, 2, 256)
    assert rho_mid.fwd_layout(128, 16, 4)["jb"] == 4
    assert rho_mid._fwd_shape(8, 3, 125, 11, 6)[:3] == (4, 4, 512)
    assert rho_mid.fwd_layout(125, 4, 6)["lres"] == 0
    for G in (4, 8, 16):
        assert rho_mid._fwd_shape(1, 3, 128, 7, 4, G=G)[0] == G
        assert rho_mid._bwd_shape(1, 3, 128, 11, 6, G=G)[0] == G
    with pytest.raises(NotImplementedError):
        rho_mid._fwd_shape(1, 3, 128, 7, 4, G=1)


def test_sixteen_only_where_the_card_holds_them():
    """Clusters of 16 CTAs are beyond the portable size: the card's
    occupancy query is asked once per shape, 8 is taken where it holds
    none of 16, and a shape it cannot hold raises."""
    class Lib:
        def __init__(self, holds):
            self.holds, self.asked = holds, []

        def rho_mid_fwd_max_clusters(self, tile, G, threads, smem):
            self.asked.append((tile, G, threads, smem))
            return int(G in self.holds)

    t = torch.zeros(7, 128, 128)
    plan = rho.make_plan(t, t, [np.eye(128)] * 4, 0.1, 6)
    rho_mid._SCHEDULED.clear()
    yes = Lib((8, 16))
    assert rho_mid.launch_shape(yes, False, plan, 1, 3)[0] == 16
    assert rho_mid.launch_shape(yes, False, plan, 1, 3)[0] == 16
    assert len(yes.asked) == 1
    rho_mid._SCHEDULED.clear()
    no16 = Lib((8,))
    assert rho_mid.launch_shape(no16, False, plan, 1, 3) \
        == rho_mid._fwd_shape(1, 3, 128, 7, 4, max_g=8)
    with pytest.raises(RuntimeError, match="holds no cluster of 16"):
        rho_mid.launch_shape(no16, False, plan, 1, 3, G=16)
    rho_mid._SCHEDULED.clear()


# ---- 2. the gate and the route ----

def test_launch_refusal_range():
    for N in (1, 16, 64, 65, 96, 125, 128):
        for K in (7, 11):
            assert rho.launch_refusal(N, K) is None
    for N in (129, 256):
        why = rho.launch_refusal(N, 7)
        assert f"N = {N}" in why and "quandary_tpu/problem.py:517" in why


def test_jax_problem_refuses_past_one_tile():
    """The reference behaviour the refusal names: the JAX Problem's
    lane-group choice has no candidate past N = 128."""
    cfg = dict(QUDITS125, nlevels=[16, 9], freq01=[4.80595, 4.8601],
               selfkerr=[0.2198, 0.2252], jkl=[0.005], decay=[80.0, 90.0],
               dephase=[40.0, 45.0])
    with pytest.raises(StopIteration):
        JProblem(qudits_setup(cfg, ntime=2))


@pytest.mark.parametrize("nlevels", [[5, 5, 5], [8, 16], [9, 8], [4, 4, 4]])
def test_route_is_jax(nlevels):
    """The port's rho route where the JAX Problem (pallas=True) takes its
    rho form: fused=True on the CPU (the plain version) takes 'rho', and
    the gate fused='auto' applies on CUDA admits it; N <= 128 is
    launchable."""
    cfg = dict(QUDITS125, nlevels=nlevels, freq01=[4.8, 4.9, 5.0][
        :len(nlevels)], selfkerr=[0.22] * len(nlevels),
        jkl=[0.005, 0.0, 0.004][:len(nlevels) * (len(nlevels) - 1) // 2],
        decay=[80.0] * len(nlevels), dephase=[40.0] * len(nlevels))
    sj = qudits_setup(cfg, ntime=2)
    pj = JProblem(sj)
    pt = TProblem(port_setup(sj), device="cpu")
    auto = TProblem(port_setup(sj, fused="auto"), device="cpu")
    assert pj.use_pallas and pj.pallas_form == "rho"
    assert pt.fused_form == "rho" and pt.fused_ok
    assert auto._fused_gate_refusal(True) is None
    assert _jax_size_gate(auto, auto.setup)
    assert rho.launch_refusal(pt.N, pt.model.K) is None
    assert rho.uses_mid(pt.N, pt.model.K, 1, 1, pt.ninit) == (pt.N > 64)


# ---- 3. dispatch and the store-iterates rule ----

class _Fake:
    """A tensor's shape and device, as the dispatch reads them."""

    def __init__(self, *shape, kind="cuda"):
        self.shape, self.device = shape, torch.device(kind)


def test_dispatch_goes_to_the_mid_pair(monkeypatch):
    """Past N = 64 both directions launch the mid pair; up to it csrc/rho.cu
    (whose wrappers would then check the tensors); a CUDA tensor never
    takes the plain version, and the mid wrappers refuse CPU tensors."""
    calls = []
    monkeypatch.setattr(rho_mid, "_kernel_fwd",
                        lambda *a, **k: calls.append("mid_fwd"))
    monkeypatch.setattr(rho_mid, "_kernel_bwd",
                        lambda *a, **k: calls.append("mid_bwd"))
    for name in ("plain_forward", "plain_backward", "rho_propagate_plain"):
        monkeypatch.setattr(rho, name, lambda *a: calls.append("plain"))
    t = torch.zeros(11, 125, 125)
    plan = rho.make_plan(t, t, [np.eye(125)] * 6, 0.1, 6,
                         np.zeros((125, 125)), "jacobi")
    x0, C = _Fake(3, 125, 125), _Fake(1, 5, 11)
    rho._kernel_fwd(plan, x0, x0, C)
    rho._kernel_bwd(plan, x0, x0, C, *[None] * 8)
    assert calls == ["mid_fwd", "mid_bwd"]
    monkeypatch.undo()
    zero = torch.zeros(3, 125, 125)
    with pytest.raises(NotImplementedError, match="CUDA"):
        rho_mid._kernel_fwd(plan, zero, zero, torch.zeros(1, 5, 11))
    with pytest.raises(NotImplementedError, match="CUDA"):
        rho_mid._kernel_bwd(plan, zero, zero, torch.zeros(1, 5, 11),
                            *[torch.zeros(1)] * 8)
    assert not rho.uses_mid(64, 7, 4, 1, 3)
    assert rho.uses_mid(65, 7, 4, 1, 3)


def test_bwd_wrapper_launch_arguments(monkeypatch):
    """The backward wrapper's launch through a stand-in for the library:
    the C signature's 39 arguments (21 pointers: the ring of replayed
    iterates or the stored ones, the scratch and the flags last), the
    schedule bwd_schedule picks from the card's count ('split' with its
    ring of 3 steps where it holds 2 E B clusters, else 'chain' with one),
    one launch counted, and the shape logged with its clusters."""
    class Lib:
        def __init__(self, holds):
            self.holds, self.calls = holds, []

        def rho_mid_bwd_max_clusters(self, tile, G, threads, smem):
            return self.holds

        def rho_mid_bwd_launch(self, *args):
            self.calls.append(args)
            return 0

    monkeypatch.setattr(rho, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    N, K, B, nt = 72, 3, 3, 4
    t = torch.zeros(K, N, N)
    plan = rho.make_plan(t, t, [np.eye(N)] * 2, 0.1, 4)
    x0, C = torch.zeros(B, N, N), torch.zeros(1, nt, K)
    h = torch.zeros(1, nt, B, N, N)
    gT = torch.zeros(1, B, N, N)
    for holds, store, want, W in ((6, False, "split", 3),
                                  (5, False, "chain", 1),
                                  (6, True, "store", 1)):
        lib = Lib(holds)
        monkeypatch.setattr(rho_mid, "_lib", lambda: lib)
        rho_mid._SCHEDULED.clear()
        ks = torch.zeros(1, B, nt, 4, N, N) if store else None
        before = rho_mid.rho_mid_bwd_launches
        g0r, g0i, Cb = rho_mid._kernel_bwd(plan, x0, x0, C, h, h, ks, ks,
                                           gT, gT, h, h)
        assert rho_mid.rho_mid_bwd_launches == before + 1
        (args,) = lib.calls
        assert len(args) == 39
        assert all(isinstance(a, int) for a in args[:21] if a is not None)
        assert args[21:28] == (1, nt, B, N, K, 2, 4)
        assert args[29] == int(store)
        assert args[-3:-1] == (int(want == "split"), W)
        G = args[33]
        assert rho_mid.mid_layouts["bwd"] == dict(
            G=G, tile=args[32], threads=args[34], smem=args[35],
            clusters=(2 if want == "split" else 1) * B,
            ctas=(2 if want == "split" else 1) * B * G, schedule=want,
            ring=W)
        assert g0r.shape == (B, N, N) and Cb.shape == (1, nt, K)
    rho_mid._SCHEDULED.clear()


def test_store_iterates_rule():
    """The mid pair stores the stage iterates by the TPU kernel's rule
    (iters <= 8, pallas_rho.py:130-133) within the byte gate: qudits125 at
    full depth (2.25 GB of iterates) replays them, its cut to 40 steps
    stores them."""
    t = torch.zeros(11, 125, 125)
    for iters, store in ((6, True), (8, True), (9, False)):
        plan = rho.make_plan(t, t, None, 0.1, iters)
        assert rho_mid.stores_iterates(plan, 1, 40, 3) == store
    plan = rho.make_plan(t, t, None, 0.1, 6)
    assert not rho_mid.stores_iterates(plan, 1, 1000, 3)
    assert plan.St is not None and plan.St.shape == (2, 11, 125, 125)
    assert torch.equal(plan.St[1], t.transpose(-1, -2))
    assert rho.make_plan(t[:, :64, :64], t[:, :64, :64], None, 0.1, 6).St \
        is None


def test_counters_stay_out_of_rho():
    assert set(rho.launch_counts()) == {"rho_fwd_launches",
                                        "rho_bwd_launches"}
    rho_mid.reset_launch_counts()
    rho_mid.add_launches({"rho_mid_fwd_launches": 2}, 3)
    assert rho_mid.launch_counts() == dict(rho_mid_fwd_launches=6,
                                           rho_mid_bwd_launches=0)
    rho_mid.reset_launch_counts()


# ---- 4. the slice against the JAX package ----

@pytest.fixture
def highest(monkeypatch):
    """The JAX rho kernel's products in exact f32 (its shipping default is
    a 3-pass bf16 emulation)."""
    monkeypatch.setattr(pallas_rho, "_PRECISION_MODE", "highest")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_plain_matches_pallas_interpret_at_n125(highest):
    """qudits125's stacks, jump operators and generator diagonal, jacobi-6,
    3 steps, its 3 initial matrices: rho_propagate_plain (f32) against the
    TPU kernel in interpret mode, xT and hist to 2e-4 of max, C-bar and
    x0-bar to 5e-4 of max (tests/test_torch_rho.py's bounds)."""
    pt = TProblem(port_setup(qudits_setup()), device="cpu")
    assert pt.N == 125 and pt.model.K == 11 and pt.linsolver == "jacobi"
    stack = pt.engine.stack_np.astype(np.complex64)
    Ls = [L.astype(np.complex64) for L in pt.engine.Ls_np]
    assert len(Ls) == 6
    dt, nt = pt.setup.dt, pt.setup.ntime
    rng = np.random.default_rng(3)
    C = (rng.normal(size=(nt, 11)) * 0.05).astype(np.float32)
    x0r, x0i = pt._x0r.numpy(), pt._x0i.numpy()
    wT = rng.normal(size=(3, 125, 125)).astype(np.float32)
    wh = rng.normal(size=(nt, 3, 125, 125)).astype(np.float32)

    prop = pallas_rho.make_rho_propagate(
        stack, Ls, dt, 6, gen_diag=pt.gen_diag, linsolver="jacobi",
        interpret=True, real_io=True)
    Sr, Si = (jnp.asarray(p) for p in pallas_rho._planes(stack, 128))

    def jloss(Cj, xr, xi):
        (tr, ti), (hr, hi) = prop(Sr, Si, (xr, xi), Cj)
        return jnp.sum(wT * tr) + jnp.sum(wT * ti * ti) \
            + jnp.sum(wh * hr * hi), (tr, hr)

    (_, (tj, hj)), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(C), jnp.asarray(x0r), jnp.asarray(x0i))

    plan = rho.make_plan(pt._Sr, pt._Si, pt.engine.Ls_np, dt, 6, pt.gen_diag,
                         "jacobi")
    Cg = torch.tensor(C)[None].requires_grad_()
    xr = torch.tensor(x0r).requires_grad_()
    xi = torch.tensor(x0i).requires_grad_()
    tr, ti, hr, hi = rho.rho_propagate_plain(plan, xr, xi, Cg)
    (torch.sum(torch.tensor(wT) * tr) + torch.sum(torch.tensor(wT) * ti * ti)
     + torch.sum(torch.tensor(wh) * hr * hi)).backward()
    assert _rel(tr[0].detach(), tj) < 2e-4
    assert _rel(hr[0].detach(), hj) < 2e-4
    for a, b in zip((Cg.grad[0], xr.grad, xi.grad), gj):
        assert _rel(a, b) < 5e-4


def test_problem_matches_jax_pallas_at_n125(highest):
    """The slice as a whole in f32: J and the gradient of the port's
    Problem (rho route, the plain version on the CPU) against the JAX
    Problem with pallas=True (its rho kernel in interpret mode, exact f32
    products), both at qudits125 cut to 3 steps."""
    sj = qudits_setup()
    pj = JProblem(sj)
    pt = TProblem(port_setup(sj), device="cpu")
    assert pj.pallas_form == "rho" and pt.fused_form == "rho"
    x = np.random.default_rng(1234).uniform(-1, 1, sj.nparams) * 0.005
    (Jj, _), gj = pj.build_value_and_grad()(jnp.asarray(x), jnp.asarray(x))
    (Jt, _), gt = pt.build_value_and_grad()(x, x)
    assert abs(float(Jt) - float(Jj)) <= 2e-6 * abs(float(Jj))
    assert _rel(gt.double().numpy(), gj) <= 5e-5


def test_problem_f64_matches_jax_scan_at_n125():
    """The same in f64: the port's rho route (the plain version in f64 on
    the CPU) against the JAX Problem's scan (pallas=False), J to 1e-10 and
    the gradient to 1e-9 of max."""
    sj = qudits_setup(dtype=jnp.complex128, pallas=False)
    pj = JProblem(sj)
    pt = TProblem(port_setup(sj, fused=True), device="cpu")
    assert not pj.use_pallas and pt.fused_form == "rho"
    x = np.random.default_rng(1234).uniform(-1, 1, sj.nparams) * 0.005
    (Jj, _), gj = pj.build_value_and_grad()(jnp.asarray(x), jnp.asarray(x))
    (Jt, _), gt = pt.build_value_and_grad()(x, x)
    assert abs(float(Jt) - float(Jj)) <= 1e-10 * abs(float(Jj))
    assert _rel(gt.numpy(), gj) <= 1e-9
