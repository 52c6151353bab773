"""Closed systems past one thread block: the streamK route of
quandary_tpu_torch at mid size (csrc/streamk_mid.cu, the rest of the range
of quandary_tpu/ops/pallas_stream.py::make_streamk_propagate) on the CPU.

The kernels run only on the card (tests/test_torch_cuda.py and
chip_smoke.py phase 25 hold them against the plain version there). Here:

1. the slice as a whole: a closed N = 64 split-3 problem with 8 basis
   states (three qubits with two guard levels each, the SWAP02 gate, 12
   steps, complex64) through the port's Problem (fused, 'streamk', the plain
   version on the CPU) against the JAX Problem with pallas=True (its streamK
   kernel in interpret mode, exact-f32 'highest' products): J to rtol 2e-6
   (measured 0), the gradient to 2e-6 x max (measured 2.8e-7), and the
   history through each package's streamK propagate to 2e-6 x max (both
   f32, different summation orders);
2. the planner `_mid_shape`: bands cover N and chunks cover B exactly,
   G in {1, 2, 4, 8, 16}, at most 512 threads and 227 KB of shared memory,
   at least the layout the CUDA source carves;
3. the gate: `route_refusal` admits every closed shape the JAX package's
   size gate admits on 'streamk' but for device-memory refusals, which name
   their bytes; Problem gives such systems fused_ok;
4. dispatch: what size_refusal admits still goes to the one-block pair;
5. when the forward stores its stage iterates: the JAX Problem's gate on
   bytes (a literal copy of quandary_tpu/problem.py:1333-1343);
6. the backward's schedules: the 'helpers' launch shape covers and fits
   wherever the planner plans, its tiles cover the matrix once, the rule
   that picks it, its helper count, its rings counted in sweep_bytes, and
   the gate still admitting everything it admitted before them;
7. the forward's schedules the same way: the 'helpers' launch shape, the
   rule that picks it at phase 25 and 28 sizes (and keeps 'chain' where no
   helper cluster fits), forced schedules, its helper count and its ring
   counted in sweep_bytes and route_refusal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from quandary_tpu.ops import pallas_stream  # noqa: E402
from quandary_tpu.ops.pallas_adjoint import plane_args  # noqa: E402
from quandary_tpu.problem import Problem as JProblem  # noqa: E402
from quandary_tpu_torch.ops import streamk  # noqa: E402
from quandary_tpu_torch.problem import Problem as TProblem  # noqa: E402
from quandary_tpu_torch.problem import (_jax_size_gate,  # noqa: E402
                                        store_iters_ok)
from test_torch_model import port_setup  # noqa: E402

FREQ01 = [4.8, 5.0, 5.2]


def _swap02():
    V = np.zeros((8, 8), dtype=complex)
    for i in range(8):
        b = [(i >> 2) & 1, (i >> 1) & 1, i & 1]
        V[(b[2] << 2) | (b[1] << 1) | b[0], i] = 1.0
    return V


def swap02_setup(ntime=12, T=6.0, **kw):
    """The SWAP02 of tests/test_api.py:95-125 with two guard levels per
    qubit (N = 64, 8 basis states, K = 7), built with the JAX package's
    builders, cut to T = 6 ns and 12 steps; split stage solve, 3
    iterations, complex64, pallas=True."""
    from quandary_tpu.models import gates
    from quandary_tpu.models.hamiltonian import build_standard_model
    from quandary_tpu.problem import Setup
    from quandary_tpu.utils.splines import ControlSegment, OscillatorControl
    Ne, nlevels = [2, 2, 2], [4, 4, 4]
    model = build_standard_model(
        nlevels=nlevels, freq01_ghz=FREQ01, rotfreq_ghz=FREQ01,
        selfkerr_ghz=[0.22, 0.23, 0.24], jkl_ghz=[0.01, 0.004, 0.01],
        crosskerr_ghz=[])
    oscs = tuple(OscillatorControl(
        segments=(ControlSegment("spline", nsplines=8, tstart=0.0,
                                 tstop=T),),
        carrier_freqs=(0.0,)) for _ in range(3))
    V = gates.assemble_gate(_swap02(), nlevels, Ne, [0.0] * 3, T)
    args = dict(
        model=model, nessential=tuple(Ne), ntime=ntime, dt=T / ntime,
        oscillators=oscs,
        ground_freqs_radns=tuple(2 * np.pi * f for f in FREQ01),
        initcond_type="basis", target_type="gate", target_gate_full=V,
        objective_type="Jtrace", gamma_tik=1e-4, gamma_penalty=0.1,
        gamma_penalty_energy=0.1, dtype=jnp.complex64, linsolve_iters=3,
        linsolver="split", pallas=True)
    args.update(kw)
    return Setup(**args)


@pytest.fixture
def highest(monkeypatch):
    """The JAX streamK kernel's products in exact f32 (its shipping default
    is a 3-pass bf16 emulation)."""
    monkeypatch.setattr(pallas_stream, "_PRECISION_MODE", "highest")


def test_swap02_n64_matches_jax_pallas(highest):
    sj = swap02_setup()
    pj = JProblem(sj)
    pt = TProblem(port_setup(sj), device="cpu")
    assert pj.use_pallas and pt.use_fused and pt.fused_form == "streamk"
    assert pt.N == 64 and pt.ninit == 8 and pt.linsolver == "split"
    # one block refuses it (360992 bytes of shared memory); the route
    # admits it
    assert streamk.size_refusal(8, 64, 8, 3) is not None
    assert pt.fused_ok and pt.fused_refusal is None
    assert streamk.uses_mid(pt._plan, 8, 64)
    x = np.random.default_rng(1234).uniform(-1, 1, sj.nparams) * 0.02
    (Jj, _), gj = pj.build_value_and_grad()(jnp.asarray(x), jnp.asarray(x))
    (Jt, _), gt = pt.build_value_and_grad()(x, x)
    Jj, gj = float(Jj), np.asarray(gj, np.float64)
    Jt, gt = float(Jt), gt.double().numpy()
    assert abs(Jt - Jj) <= 2e-6 * abs(Jj)
    assert np.abs(gt - gj).max() <= 2e-6 * np.abs(gj).max()

    # the history: each package's streamK propagate on the problem's stack,
    # solver rows and coefficient rows
    C = pt.coeff_rows_mid(torch.as_tensor(x, dtype=torch.float32))[:, 0, :]
    stack = pt.engine.stack_np.astype(np.complex64)
    prop = pallas_stream.make_streamk_propagate(
        stack, sj.dt, 3, gen_diag=pt.gen_diag, linsolver="split",
        interpret=True, real_io=True)
    Sr, Si = map(jnp.asarray, plane_args(stack))
    x0 = (jnp.asarray(pt._x0r.numpy()), jnp.asarray(pt._x0i.numpy()))
    _, (hjr, hji) = prop(Sr, Si, x0, jnp.asarray(C.numpy()))
    tprop = streamk.make_streamk_propagate(sj.dt, 3, gen_diag=pt.gen_diag,
                                           linsolver="split")
    _, (htr, hti) = tprop(pt._Sr, pt._Si, (pt._x0r, pt._x0i), C)
    for a, b in ((htr, hjr), (hti, hji)):
        b = np.asarray(b)
        assert a.shape == b.shape == (12, 8, 64)
        assert np.abs(a.numpy() - b).max() <= 2e-6 * np.abs(b).max()


# (E, B, N, Ke, iters): shapes one block refuses (N = 64 at B = 8,
# midsize_bench's N = 256 (B = 1, 256), 512 and 1024, B*N past 1024 at
# N = 40), ragged bands and chunks (N = 53, 97, 1000; B = 3, 5, 13),
# several candidates, more slots than a C-bar group, and the front end's
# default 20 stage iterations
PLAN_SHAPES = [(1, 8, 64, 8, 3), (4, 8, 64, 8, 3), (1, 1, 256, 6, 4),
               (1, 256, 256, 6, 4), (1, 1, 512, 6, 4), (1, 1, 1024, 6, 4),
               (1, 40, 40, 7, 3), (1, 1, 53, 8, 3), (2, 3, 97, 9, 20),
               (1, 5, 1000, 6, 4), (3, 13, 130, 18, 8), (1, 1024, 1024, 6, 4),
               (128, 4, 64, 8, 3)]


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("store", [True, False])
@pytest.mark.parametrize("E,B,N,Ke,iters", PLAN_SHAPES)
def test_mid_shape_covers_and_fits(E, B, N, Ke, iters, store, backward):
    shape = streamk._mid_shape(E, B, N, Ke, iters, store, backward)
    assert shape is not None
    G, bc, threads, smem, layout = shape
    R = -(-N // G)
    assert G in (1, 2, 4, 8, 16) and (G - 1) * R < N <= G * R
    nch = -(-B // bc)
    assert bc in (1, 2, 4, 8) and (nch - 1) * bc < B <= nch * bc
    assert bc <= max(1, 1 << (B - 1).bit_length())
    assert threads % 32 == 0 and 128 <= threads <= 512
    replay = backward and not store and iters > 0
    assert layout in ("smem", "global")
    floats = streamk._mid_floats(bc, N, R, iters, backward, replay,
                                 layout == "smem")
    assert 4 * floats <= smem <= 227 * 1024
    if layout == "global":      # no cluster holds the bands
        assert G == 16 and 4 * streamk._mid_floats(
            1, N, R, iters, backward, replay, True) > 227 * 1024


def test_mid_shape_layouts():
    """The layouts phase 25 of chip_smoke.py drives: bands in shared memory
    at N = 64, 256 and 512 (stored iterates), in device-memory scratch at
    N = 1024 and for the N = 512 replay, whose row and column bands of
    32 x 512 do not fit beside each other."""
    s = lambda *a, **k: streamk._mid_shape(*a, **k)
    assert s(1, 8, 64, 8, 3, True)[::4] == (4, "smem")
    assert s(1, 1, 256, 6, 4, True)[::4] == (16, "smem")
    assert s(1, 256, 256, 6, 4, False, True)[:2] == (8, 4)
    assert s(1, 1, 512, 6, 4, True, True)[4] == "smem"
    assert s(1, 1, 512, 6, 4, False, True)[4] == "global"
    assert s(1, 1, 1024, 6, 4, True)[4] == "global"
    assert s(1, 1, 1024, 6, 4, True, True)[4] == "global"


def _jax_admits(N, Ke):
    P = -(-N // 128) * 128
    return 2 * Ke * P * P * 4 <= 80 << 20


GATE_GRID = [(N, B, Ke, it) for N in (16, 53, 64, 100, 256, 512, 768, 1024)
             for B in (1, 4, 8, N) for Ke in (6, 8, 10, 17)
             for it in (3, 4, 8, 20)]


@pytest.mark.parametrize("nt", [1000, 20000])
def test_route_admits_what_jax_admits(nt):
    """Wherever the JAX gate admits a closed shape on 'streamk', the route
    takes it, or refuses on device memory naming the bytes past the
    budget; the mid pair takes whatever one block refuses."""
    refused = 0
    for N, B, Ke, it in GATE_GRID:
        if not _jax_admits(N, Ke):
            continue
        why = streamk.route_refusal(B, N, Ke, it, nt)
        if why is not None:
            refused += 1
            assert "bytes of device memory" in why, why
            need = int(why.split(" take ")[1].split(" bytes")[0])
            assert need > streamk.DEVICE_BUDGET_BYTES
            assert need == streamk.sweep_bytes(
                1, B, N, Ke, it, nt, it <= 4,
                streamk.size_refusal(B, N, Ke, it) is not None)
        if streamk.size_refusal(B, N, Ke, it) is not None:
            for backward in (False, True):
                assert streamk._mid_shape(1, B, N, Ke, it, it <= 4,
                                          backward) is not None
    # 1000 steps fit every shape (B = N = 1024 stores 50 GB); 20000 do not
    assert (refused == 0) == (nt == 1000)


@pytest.mark.parametrize("N,ninit", [(64, "basis"), (256, "pure")])
def test_problem_admits_closed_mid_size(N, ninit):
    """A closed Problem past one thread block on the 'streamk' route:
    fused_ok wherever the JAX size gate admits it."""
    if N == 64:
        sj = swap02_setup(ntime=1000, T=100.0)
    else:
        sj = _midsize_setup(N, ninit)
    pt = TProblem(port_setup(sj), device="cpu")
    assert _jax_size_gate(pt, pt.setup)
    assert pt.fused_form == "streamk" and pt.fused_ok, pt.fused_refusal
    assert streamk.uses_mid(pt._plan, pt.ninit, pt.N)


def _midsize_setup(N, initcond, ntime=1000):
    """scripts/perf/midsize_bench.py's closed system (two qudits, N = 256,
    512 or 1024, ntime 1000), split with 4 iterations, pure (state 0 to a
    random state) or basis (all N states to a random unitary)."""
    from quandary_tpu.models.hamiltonian import build_standard_model
    from quandary_tpu.problem import Setup
    from quandary_tpu.utils.splines import ControlSegment, OscillatorControl
    nlevels = {256: [16, 16], 512: [16, 32], 1024: [32, 32]}[N]
    freq01 = [4.80595, 4.8601]
    model = build_standard_model(
        nlevels=nlevels, freq01_ghz=freq01, rotfreq_ghz=freq01,
        selfkerr_ghz=[0.2198, 0.2252], jkl_ghz=[0.005], crosskerr_ghz=[])
    T = 100.0
    oscs = tuple(OscillatorControl(
        segments=(ControlSegment("spline", nsplines=30, tstart=0.0,
                                 tstop=T),),
        carrier_freqs=(0.0,)) for _ in range(2))
    rng = np.random.default_rng(42)
    if initcond == "basis":
        A = rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N))
        tgt = dict(target_type="gate", target_gate_full=np.linalg.qr(A)[0])
    else:
        v = rng.normal(size=N) + 1j * rng.normal(size=N)
        tgt = dict(target_type="state",
                   target_state_full=v / np.linalg.norm(v))
    return Setup(model=model, nessential=tuple(nlevels), ntime=ntime,
                 dt=T / ntime, oscillators=oscs,
                 ground_freqs_radns=tuple(2 * np.pi * f for f in freq01),
                 initcond_type=initcond, objective_type="Jtrace",
                 gamma_tik=1e-4, dtype=jnp.complex64, linsolve_iters=4,
                 linsolver="split", pallas=True, **tgt)


# the one-block shapes of tests/test_torch_streamk.py and the flagship's
ONE_BLOCK = [(4, 16, 8, 3), (4, 16, 8, 8), (16, 16, 5, 8), (64, 16, 8, 3),
             (32, 32, 8, 3), (256, 4, 5, 8), (4, 52, 8, 3), (3, 27, 7, 6),
             (2, 40, 12, 4), (8, 8, 40, 3), (4, 53, 8, 3), (1, 53, 8, 3),
             (8, 64, 8, 3), (40, 40, 7, 3)]


@pytest.mark.parametrize("B,N,Ke,iters", ONE_BLOCK)
def test_dispatch_keeps_one_block(B, N, Ke, iters):
    """uses_mid is exactly size_refusal's refusal, for a shared stack and
    for a per-candidate (packed) plan alike: the packed plan goes to the
    mid pair only where one block refuses it."""
    z = torch.zeros(Ke, N, N)
    plan = streamk.make_plan(z, z, 0.01, iters)
    one = streamk.size_refusal(B, N, Ke, iters) is None
    assert streamk.uses_mid(plan, B, N) == (not one)
    packed = dataclasses.replace(plan, Sr=z[None], Si=z[None])
    assert streamk.uses_mid(packed, B, N) == (not one)


def _jax_store_iters_ok(ntime, iters, ninit, dim_flat):
    """quandary_tpu/problem.py:1333-1343 (Problem._store_iters_ok), as
    written there, and make_streamk_propagate's iters <= 4."""
    Bp = max(8, -(-ninit // 8) * 8)
    Ppad = -(-dim_flat // 128) * 128
    ks_bytes = 2 * ntime * iters * Bp * Ppad * 4
    return ks_bytes <= 1.5 * (1 << 30) and iters <= 4


@pytest.mark.parametrize("ntime", [12, 1000, 1221, 20000])
@pytest.mark.parametrize("iters", [0, 3, 4, 8])
def test_store_iters_rule_is_jax(ntime, iters):
    for ninit in (1, 4, 8, 16, 100, 256, 1024):
        for dim in (16, 64, 200, 256, 512, 1024):
            assert store_iters_ok(ntime, iters, ninit, dim) == \
                _jax_store_iters_ok(ntime, iters, ninit, dim)


def test_problem_store_iters():
    """The flagship stores its iterates (30 MB); midsize_bench's basis run
    at N = 256 replays them (2.1 GB past 1.5 GiB); the plan follows."""
    from test_torch_model import flagship_setup
    pf = TProblem(port_setup(flagship_setup("jax", ntime=1221, T=200.0)),
                  device="cpu")
    assert pf._plan.store_iters and not streamk.uses_mid(pf._plan, 4, 16)
    pb = TProblem(port_setup(_midsize_setup(256, "basis")), device="cpu")
    assert pb.ninit == 256 and not pb._plan.store_iters and pb.fused_ok
    assert not store_iters_ok(1000, 4, 256, 256)


# ---- the backward's schedules (streamk.bwd_schedule): 'helpers' runs each
# step's column pass in tiles of the whole matrix beside the chain, 'chain'
# in it ----

@pytest.mark.parametrize("store", [True, False])
@pytest.mark.parametrize("E,B,N,Ke,iters", PLAN_SHAPES)
def test_bwd_shape_covers_and_fits(E, B, N, Ke, iters, store):
    """The helpers schedule has a launch shape at every planned size: bands
    and chunks cover N and B, its shared memory holds the layout the CUDA
    source carves (mid_split_floats) within 227 KB, 'global' only where no
    cluster holds the bands; a pass's tiles cover the matrix once. The
    chain schedule's shape is the parent planner's (_mid_shape)."""
    assert streamk._mid_bwd_shape(E, B, N, Ke, iters, store, "chain") \
        == streamk._mid_shape(E, B, N, Ke, iters, store, True)
    shape = streamk._mid_bwd_shape(E, B, N, Ke, iters, store, "helpers")
    assert shape is not None
    G, bc, threads, smem, layout = shape
    R = -(-N // G)
    assert G in (1, 2, 4, 8, 16) and (G - 1) * R < N <= G * R
    nch = -(-B // bc)
    assert bc in (1, 2, 4, 8) and (nch - 1) * bc < B <= nch * bc
    assert threads % 32 == 0 and 128 <= threads <= 512
    replay, stored = not store and iters > 0, store and iters > 0
    floats = streamk._split_floats(bc, N, R, iters, replay, stored,
                                   layout == "smem")
    assert 4 * floats <= smem <= 227 * 1024
    assert floats >= 8 + streamk._tile_floats(bc, iters)
    if layout == "global":
        assert G == 16 and 4 * streamk._split_floats(
            1, N, R, iters, replay, stored, True) > 227 * 1024
    tiles, tq = streamk.split_tiles(N)
    P, Q = streamk.MID_TILE
    covered = np.zeros((tiles // tq * P, tq * Q), dtype=int)
    for t in range(tiles):
        p0, q0 = t // tq * P, t % tq * Q
        covered[p0:p0 + P, q0:q0 + Q] += 1
    assert (covered == 1).all() and covered.shape[0] - P < N <= \
        covered.shape[0] and covered.shape[1] - Q < N <= covered.shape[1]


def test_bwd_schedule_picks():
    """'helpers' wherever its chain clusters take at most half the SMs
    (phase 25's B = 1 sizes, SWAP02 at E = 1 and 4, superop N = 27 replayed),
    'chain' where the card is full (N = 256 basis: 256 or 512 CTAs, 128
    candidates); stored and replayed iterates of one size take one
    schedule; a forced schedule is taken, an unknown one raises."""
    pick = lambda *a: streamk.bwd_schedule(*a[:5], 1000, a[5])
    for store in (True, False):
        for N in (256, 512, 1024):
            assert pick(1, 1, N, 8, 4, store) == "helpers"
        assert pick(1, 8, 64, 14, 3, store) == "helpers"
        assert pick(4, 8, 64, 14, 3, store) == "helpers"
        assert pick(1, 256, 256, 8, 4, store) == "chain"
        assert pick(128, 4, 64, 8, 3, store) == "chain"
    assert pick(1, 3, 729, 11, 6, False) == "helpers"
    assert streamk.bwd_schedule(1, 1, 256, 8, 4, 1000, True,
                                forced="chain") == "chain"
    # where the card holds no helper cluster beside the chain clusters
    # (the device driver's 8 SWAP02 candidates at neumann-20: 16 clusters
    # of 4 CTAs) the chain schedule; the count is taken at the larger
    # iterate mode's shared memory, so both modes agree; 16 candidates
    # take 128 CTAs: 'chain'
    for store in (True, False):
        assert streamk.bwd_schedule(1, 1, 256, 8, 4, 1000, store,
                                    holds=8) == "helpers"
        assert streamk.bwd_schedule(1, 1, 256, 8, 4, 1000, store,
                                    holds=1) == "chain"
        assert streamk.bwd_schedule(8, 8, 64, 14, 20, 2489, store,
                                    holds=16) == "chain"
        assert streamk.bwd_schedule(8, 8, 64, 14, 20, 2489, store,
                                    holds=32) == "helpers"
        assert streamk.bwd_schedule(16, 8, 64, 14, 20, 2489, store) \
            == "chain"
    assert streamk.helpers_smem(1, 1, 512, 8, 4) == max(
        streamk._mid_bwd_shape(1, 1, 512, 8, 4, s, "helpers")[3]
        for s in (True, False))
    with pytest.raises(ValueError, match="schedule"):
        streamk.bwd_schedule(1, 1, 256, 8, 4, 1000, True, forced="warps")


@pytest.mark.parametrize("clusters,ctas,holds,want", [
    (1, 16, 7, 6), (1, 16, 100, 7), (1, 4, 100, 8), (2, 32, 8, 3),
    (4, 64, 8, 1), (4, 64, 4, 0), (1, 16, 1, 0)])
def test_helper_clusters(clusters, ctas, holds, want):
    """Helper clusters per chain cluster: the idle SMs' worth, at most
    MID_MAX_HELPERS, within what the card holds beside the chain clusters
    (0: the chain's CTAs run every tile)."""
    assert streamk.helper_clusters(clusters, ctas, holds) == want


def _parent_sweep_bytes(E, B, N, Ke, iters, nt, store, mid, per_block=False):
    """ops/streamk.py::sweep_bytes before the helpers schedule (every
    backward on the chain schedule): what the gate admitted then."""
    total = streamk.history_bytes(E, B, N, iters, nt, store)
    if per_block:
        total += 2 * E * Ke * N * N * 4
    if mid:
        extra = 0
        for backward in (False, True):
            shape = streamk._mid_shape(E, B, N, Ke, iters, store, backward)
            if shape is None:
                continue
            G, bc, _, _, layout = shape
            ctas = E * -(-B // bc) * G
            replay = backward and not store and iters > 0
            more = (ctas * nt * Ke * 4) if backward else 0
            if layout == "global":
                more += 4 * ctas * streamk._mid_band_floats(
                    N, -(-N // G), backward, replay)
            extra = max(extra, more)
        total += extra
    return total


@pytest.mark.parametrize("nt", [1000, 20000, 60000])
def test_gate_admits_what_parent_admitted(nt):
    """Every shape the gate admitted before the helpers schedule it admits
    now (the planner takes 'chain' where the rings would pass the budget),
    at E = 1 and 4, per-block stacks too."""
    checked = 0
    for N, B, Ke, it in GATE_GRID:
        for E in (1, 4):
            for per_block in (False, True):
                store = it <= 4
                mid = streamk.size_refusal(B, N, Ke, it) is not None
                if not mid:
                    continue
                if _parent_sweep_bytes(E, B, N, Ke, it, nt, store, True,
                                       per_block) \
                        > streamk.DEVICE_BUDGET_BYTES:
                    continue
                checked += 1
                assert streamk.mid_refusal(E, B, N, Ke, it, nt, store,
                                           per_block) is None
                assert streamk.route_refusal(B, N, Ke, it, nt, E, store,
                                             per_block) is None
    assert checked > 100


@pytest.mark.parametrize("E,B,N,Ke,iters,store", [
    (1, 1, 256, 8, 4, True), (1, 1, 1024, 8, 4, False),
    (4, 8, 64, 14, 3, True), (1, 3, 729, 11, 6, False)])
def test_sweep_bytes_counts_rings(E, B, N, Ke, iters, store):
    """On the helpers schedule a sweep counts its groups' rings (two slots
    of H, with replay row-major too, and of the step's pairs), counters and
    the tiles' C-bar rows against DEVICE_BUDGET_BYTES."""
    nt = 1000
    assert streamk.bwd_schedule(E, B, N, Ke, iters, nt, store) == "helpers"
    G, bc = streamk._mid_bwd_shape(E, B, N, Ke, iters, store, "helpers")[:2]
    groups = E * -(-B // bc)
    replay = not store and iters > 0
    rings = 4 * groups * (streamk._split_ring_floats(bc, N, iters, replay)
                          + 3 * nt + 4
                          + streamk.split_tiles(N)[0] * nt * Ke) + 4
    ldr = -(-N // 4) * 4
    assert streamk._split_ring_floats(bc, N, iters, replay) == \
        2 * (2 if replay else 1) * 2 * N * ldr + 2 * (iters + 1) * 4 * bc * N
    got = streamk.sweep_bytes(E, B, N, Ke, iters, nt, store, True)
    base = streamk.sweep_bytes(E, B, N, Ke, iters, nt, store, False)
    assert got - base >= rings
    assert got - base == max(streamk._scratch_bytes(
        E, B, N, Ke, iters, nt, store, s) for s in ("helpers", "chain"))


# ---- the forward's schedules (streamk.fwd_schedule): 'helpers' contracts
# each step's H in the backward's pass tiles on helper clusters ahead of
# the chain, 'chain' in each cluster's chain ----

@pytest.mark.parametrize("E,B,N,Ke,iters", PLAN_SHAPES)
def test_fwd_shape_covers_and_fits(E, B, N, Ke, iters):
    """The forward's helpers schedule has a launch shape at every planned
    size: bands and chunks cover N and B, its shared memory holds the
    layout the CUDA source carves (mid_fwd_split_floats: a header, the
    chain's buffers, then the band or a tile's scratch) within 227 KB,
    'global' only where no cluster holds the band. The chain schedule's
    shape is the parent planner's (_mid_shape)."""
    for store in (True, False):
        assert streamk._mid_fwd_shape(E, B, N, Ke, iters, store, "chain") \
            == streamk._mid_shape(E, B, N, Ke, iters, store)
    shape = streamk._mid_fwd_shape(E, B, N, Ke, iters, True, "helpers")
    assert shape is not None
    G, bc, threads, smem, layout = shape
    R = -(-N // G)
    assert G in (1, 2, 4, 8, 16) and (G - 1) * R < N <= G * R
    nch = -(-B // bc)
    assert bc in (1, 2, 4, 8) and (nch - 1) * bc < B <= nch * bc
    assert threads % 32 == 0 and 128 <= threads <= 512
    floats = streamk._fwd_split_floats(bc, N, R, layout == "smem")
    head = 8 + streamk._mid_floats(bc, N, R, iters, False, False, False)
    assert floats >= head + streamk._tile_floats(bc, 0, pairs=False)
    if layout == "smem":
        assert floats >= head + 2 * R * streamk._split_ldr(N)
    assert 4 * floats <= smem <= 227 * 1024
    if layout == "global":
        assert G == 16 and 4 * streamk._fwd_split_floats(
            1, N, R, True) > 227 * 1024


def test_fwd_schedule_picks():
    """'helpers' at phase 25's B = 1 sizes (N = 256, 512, 1024), SWAP02 (N
    = 64, B = 8) and its packed S = 2, and phase 28's superop runs (open 2
    at dim 256, B = 16; N = 27 at dim 729, B = 3, replayed), stored and
    replayed alike; 'chain' where the card is full (N = 256 basis: 128
    CTAs take more than half the SMs) and where it holds no helper cluster
    per chain cluster beside them (the three open qubits' packed dim 64:
    16 clusters of 4 CTAs); a forced schedule is taken where it fits, an
    unknown one or one that does not fit raises."""
    pick = lambda E, B, N, Ke, it, store, per_block=False, holds=None: \
        streamk.fwd_schedule(E, B, N, Ke, it, 1000, store, per_block,
                             holds=holds)
    for store in (True, False):
        for N in (256, 512, 1024):
            assert pick(1, 1, N, 6, 4, store) == "helpers"
            assert pick(1, 1, N, 6, 4, store, holds=8) == "helpers"
            assert pick(1, 1, N, 6, 4, store, holds=1) == "chain"
        assert pick(1, 256, 256, 6, 4, store) == "chain"
        assert pick(1, 8, 64, 8, 3, store, holds=32) == "helpers"
        assert pick(2, 8, 64, 8, 3, store, True, holds=32) == "helpers"
        assert pick(2, 64, 64, 5, 3, store, True, holds=30) == "chain"
        assert pick(2, 64, 64, 5, 3, store, True, holds=33) == "helpers"
        assert pick(1, 16, 256, 9, 8, store) == "helpers"
    assert pick(1, 3, 729, 11, 6, False) == "helpers"
    assert streamk.fwd_schedule(1, 1, 1024, 6, 4, 1000, True,
                                forced="chain") == "chain"
    assert streamk.fwd_schedule(1, 8, 64, 8, 3, 1000, True,
                                forced="helpers") == "helpers"
    with pytest.raises(ValueError, match="schedule"):
        streamk.fwd_schedule(1, 1, 256, 6, 4, 1000, True, forced="warps")


def test_fwd_forced_schedule_that_does_not_fit_raises(monkeypatch):
    """Where a CTA's shared memory holds the chain's buffers but not a pass
    tile's scratch, the helpers schedule has no shape: forcing it raises,
    and the planner keeps 'chain'."""
    monkeypatch.setattr(streamk, "_MAX_SMEM", 17000)
    assert streamk._mid_fwd_shape(1, 8, 64, 8, 3, True, "chain") is not None
    assert streamk._mid_fwd_shape(1, 8, 64, 8, 3, True, "helpers") is None
    with pytest.raises(ValueError, match="'helpers' does not fit"):
        streamk.fwd_schedule(1, 8, 64, 8, 3, 40, True, forced="helpers")
    assert streamk.fwd_schedule(1, 1, 256, 6, 4, 40, True) == "chain"


@pytest.mark.parametrize("E,B,N,Ke,iters,holds,want", [
    (1, 1, 1024, 6, 4, 100, 7), (1, 1, 1024, 6, 4, 4, 3),
    (1, 1, 256, 6, 4, 8, 7), (1, 3, 729, 11, 6, 8, 7),
    (1, 16, 256, 9, 8, 8, 3), (1, 16, 256, 9, 8, 2, 0)])
def test_fwd_helper_counts(E, B, N, Ke, iters, holds, want):
    """The forward's helper clusters per chain cluster at phase 25 and 28
    sizes: the idle SMs' worth (one group of 16 CTAs: 7; open 2's two
    groups of 16: 3) within what the card holds beside the chain
    clusters."""
    G, bc = streamk._mid_fwd_shape(E, B, N, Ke, iters, False, "helpers")[:2]
    groups = E * -(-B // bc)
    assert streamk.helper_clusters(groups, groups * G, holds) == want


def test_sweep_bytes_counts_fwd_ring(monkeypatch):
    """The forward's helpers schedule counts its groups' rings
    (MID_FWD_SLOTS steps of H, re and im at row stride N rounded up to 4)
    and counters against DEVICE_BUDGET_BYTES: at N = 1024 and 10 steps the
    ring is the sweep's largest scratch; with the budget below the sweep
    with the ring the planner keeps 'chain' and the gate still admits the
    sweep, and below the chain's sweep route_refusal names the limit."""
    E, B, N, Ke, iters, nt, store = 1, 1, 1024, 6, 4, 10, True
    ring = 4 * (1 + streamk.MID_FWD_SLOTS * 2 * N * N + 3 * nt)
    assert streamk._fwd_scratch_bytes(E, B, N, Ke, iters, nt, store,
                                      "helpers") == ring
    got = streamk.sweep_bytes(E, B, N, Ke, iters, nt, store, True)
    base = streamk.sweep_bytes(E, B, N, Ke, iters, nt, store, False)
    assert got - base == ring
    assert streamk.fwd_schedule(E, B, N, Ke, iters, nt, store) == "helpers"
    monkeypatch.setattr(streamk, "DEVICE_BUDGET_BYTES", got - 1)
    assert streamk.fwd_schedule(E, B, N, Ke, iters, nt, store) == "chain"
    assert streamk.route_refusal(B, N, Ke, iters, nt, E, store) is None
    assert streamk.sweep_bytes(E, B, N, Ke, iters, nt, store, True) < got
    least = streamk._sweep_total(E, B, N, Ke, iters, nt, store, True, False,
                                 "chain", "chain")
    monkeypatch.setattr(streamk, "DEVICE_BUDGET_BYTES", least - 1)
    why = streamk.route_refusal(B, N, Ke, iters, nt, E, store)
    assert why is not None and "DEVICE_BUDGET_BYTES" in why
