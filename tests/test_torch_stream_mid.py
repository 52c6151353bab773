"""The streamed-plane routes past one thread block ('stream', 'chunk' and
dense on csrc/stream_mid.cu, the rest of the range of
quandary_tpu/ops/pallas_stream.py::make_stream_propagate,
ops/pallas_adjoint.py::make_pallas_propagate and
ops/pallas_kernels.py::pallas_propagate_dense) on the CPU, with the repairs
that came with them.

The kernels run only on the card (tests/test_torch_cuda.py and
chip_smoke.py phase 27 hold them against the plain version there). Here:

1. the planner `stream._mid_shape`: bands cover N and chunks cover B
   exactly, G in {1, 2, 4, 8, 16}, at most 512 threads and 227 KB of
   shared memory, at least the layout the CUDA source carves;
2. the gate: `stream.route_refusal` admits on 'stream' exactly what the
   JAX package's 'stream' gate admits (six (ntime, P, P) f32 plane arrays
   within 8 GiB, P = roundup(N, 128); quandary_tpu/problem.py:461-464) at
   ntime 1000, 1221 and 4884, and on 'chunk' exactly what dim <= 1024
   (:465-466) and the port's plane budget admit;
3. dispatch: plans one block refuses go to the mid pair, the others stay on
   csrc/stream.cu (the wrappers replaced by recorders);
4. the slice as a whole: Problem(fused_mode='stream') past one block, a
   closed N = 168 system with 4 basis states and the guarded open CNOT
   (superop, dim 256, 4 matrices), against the JAX Problem with
   pallas=True, pallas_mode='stream' (its stream kernel in interpret mode,
   exact f32 'highest'): J and the gradient within 2e-6 x max (measured J
   exact, the gradients 3.3e-7 and 7.0e-8 x max); make_stream_propagate's
   stack cotangents (the calibration's) at N = 170 against the JAX kernel;
5. the 'stream' plan stores its stage iterates by the JAX Problem's rule
   (quandary_tpu/problem.py:1179, the gate at :1333-1343);
6. the default Setup (fused='auto', as the reference's pallas='auto',
   quandary_tpu/problem.py:207) takes the plain loop on the CPU;
7. the device driver's default `graph`: a CUDA graph of the chunk on a
   kernel route, the plain route eager (its graph fault, ROADMAP C1, has
   card tests in tests/test_torch_cuda.py).
"""

import dataclasses
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from quandary_tpu.ops import pallas_stream  # noqa: E402
from quandary_tpu.problem import Problem as JProblem  # noqa: E402
from quandary_tpu_torch.ops import stream, stream_mid  # noqa: E402
from quandary_tpu_torch.problem import Problem as TProblem  # noqa: E402
from quandary_tpu_torch.problem import store_iters_ok  # noqa: E402
from test_torch_lindblad import guarded_setup  # noqa: E402
from test_torch_model import port_setup  # noqa: E402
from test_torch_streamk_mid import _jax_store_iters_ok  # noqa: E402

FREQ01 = [4.80595, 4.8601]


@pytest.fixture
def highest(monkeypatch):
    """The JAX stream kernel's products in exact f32 (its shipping default
    is a 3-pass bf16 emulation)."""
    monkeypatch.setattr(pallas_stream, "_PRECISION_MODE", "highest")


# (E, B, N, iters): shapes one block refuses (B*N past 1024, or the inline
# layout past 227 KB), ragged bands and chunks, several candidates, the
# reference's ranges ('stream' N <= 512 at 1000 steps, 'chunk' dim 1024),
# superop dims (256 = the guarded open CNOT) and the front end's default
# 20 stage iterations
PLAN_SHAPES = [(1, 1, 166, 4), (1, 4, 155, 3), (1, 4, 138, 8),
               (1, 16, 65, 3), (2, 4, 200, 4), (1, 1, 256, 4),
               (1, 16, 256, 4), (1, 256, 256, 4), (1, 1, 512, 4),
               (1, 1, 1024, 8), (3, 13, 301, 6), (1, 16, 256, 8),
               (8, 4, 256, 8), (1, 5, 1000, 20), (128, 4, 170, 3)]


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("store", [True, False])
@pytest.mark.parametrize("E,B,N,iters", PLAN_SHAPES)
def test_mid_shape_covers_and_fits(E, B, N, iters, store, backward):
    """Every member plans alike ('chunk' replays, dense runs the forward
    alone)."""
    shape = stream._mid_shape(E, B, N, iters, store, backward)
    assert shape is not None
    G, bc, threads, smem, layout = shape
    R = -(-N // G)
    assert G in (1, 2, 4, 8, 16) and (G - 1) * R < N <= G * R
    nch = -(-B // bc)
    assert bc in (1, 2, 4, 8) and (nch - 1) * bc < B <= nch * bc
    assert bc <= max(1, 1 << (B - 1).bit_length())
    assert threads % 32 == 0 and 128 <= threads <= 512
    replay = backward and not store and iters > 0
    slots = stream.MID_SLOTS[layout]
    floats = stream._mid_floats(bc, N, R, iters, backward, replay, slots)
    assert 4 * floats <= smem <= 232448
    if layout == "global":      # no cluster holds one slot of the bands
        assert 4 * stream._mid_floats(1, N, -(-N // 16), iters, backward,
                                      replay, 1) > 232448
    if layout == "smem1":       # two slots would not fit
        assert 4 * stream._mid_floats(bc, N, R, iters, backward, replay,
                                      2) > 232448


def test_mid_shape_layouts():
    """The layouts phase 27 of chip_smoke.py and the card tests drive: two
    band slots at N = 256, one at N = 512 (stored iterates), the backward's
    replay at N = 512 and everything at N = 1024 in the global layout; a
    forced layout at the planner's G, or None where it does not fit."""
    s = stream._mid_shape
    assert s(1, 1, 256, 4, True)[::4] == (16, "smem2")
    assert s(1, 1, 256, 4, False, True)[::4] == (16, "smem2")
    assert s(1, 1, 512, 4, True)[::4] == (16, "smem1")
    assert s(1, 1, 512, 4, True, True)[4] == "smem1"
    assert s(1, 1, 512, 4, False, True)[4] == "global"
    assert s(1, 1, 1024, 8, False)[4] == "global"
    assert s(1, 1, 1024, 8, False, True)[4] == "global"
    assert s(1, 1, 512, 4, True, False, "global")[::4] == (16, "global")
    assert s(1, 1, 512, 4, True, False, "smem2") is None
    assert s(1, 16, 256, 4, True)[:2] == (16, 8)


CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "quandary_tpu_torch", "csrc", "stream_mid.cu")


def _c_function_body(name):
    """The return expression of the inline function `name` of
    csrc/stream_mid.cu, as Python (casts dropped)."""
    with open(CSRC) as f:
        text = f.read()
    body = text[text.index(f"inline size_t {name}("):]
    expr = body[body.index("return ") + 7:body.index(";", body.index(
        "return "))]
    return " ".join(re.sub(r"\(size_t\)", "", expr).split())


@pytest.mark.parametrize("E,B,N,iters", PLAN_SHAPES)
def test_mid_fwd_floats_are_the_kernels(E, B, N, iters):
    """stream._mid_fwd_floats is csrc/stream_mid.cu's sm_fwd_floats (its
    expression evaluated, SM_FWD_HEAD read from the source) and the sum of
    the regions stream_mid_fwd carves: the mbarriers (2 + one a warp, 8
    bytes each), ahead + inplace band rows and ahead more (re N, im N
    each), two operand buffers of Bc x N (re, im) pairs, the bands of x, b,
    k and the solver rows; the band rows 16-byte aligned where N % 4 == 0,
    the operand's pairs 8-byte aligned."""
    with open(CSRC) as f:
        head = int(re.search(r"constexpr int SM_FWD_HEAD = (\d+);",
                             f.read()).group(1))
    assert stream.MID_FWD_HEAD == head
    assert 4 * head >= 8 * (2 + 16)
    expr = _c_function_body("sm_fwd_floats")
    G, bc, threads = stream._mid_shape(E, B, N, iters, True)[:3]
    R = -(-N // G)
    for slots in (2, 1, 0):
        for rows in {0, R // 2, R - 1, R}:
            ahead, inplace = stream._mid_fwd_band(R, slots, rows)
            want = eval(expr, dict(SM_FWD_HEAD=head, BC=bc, N=N, R=R,
                                   ahead=ahead, inplace=inplace))
            assert stream._mid_fwd_floats(bc, N, R, ahead, inplace) == want
            band = head + (ahead + inplace) * 2 * N + ahead * 2 * N
            assert want == band + 2 * bc * N * 2 + 6 * bc * R + 4 * R
            if N % 4 == 0:
                assert all((head + k * N) % 4 == 0
                           for k in range(2 * (2 * ahead + inplace)))
            assert band % 2 == 0


@pytest.mark.parametrize("backward", [False])
@pytest.mark.parametrize("E,B,N,iters", PLAN_SHAPES + [(8, 1, 1024, 8),
                                                       (16, 1, 1024, 8)])
def test_mid_fwd_band_rows_per_layout(E, B, N, iters, backward):
    """The forward's band rows past its whole slots (stream.mid_fwd_rows,
    the C entry points' band_rows): 'smem2' none; 'smem1' the most rows of
    a partial second slot that fit beside the first (below R); 'global' the
    most resident rows that fit (up to R) where the launch's CTAs fit the
    card's SMs once, else none. The planner's bytes hold them, forcing a
    count that does not fit gives None, and every count is 0 to R."""
    fwd = stream._mid_fwd_shape(E, B, N, iters, True)
    G, bc, threads, smem, layout, rows = fwd
    R = -(-N // G)
    fl = lambda r: 4 * stream._mid_fwd_floats(
        bc, N, R, *stream._mid_fwd_band(R, stream.MID_SLOTS[layout], r))
    assert smem == fl(rows) <= 232448
    assert stream._mid_shape(E, B, N, iters, True) == fwd[:5]
    if layout == "smem2":
        assert rows == 0
    elif layout == "smem1":
        assert 0 <= rows < R and (rows == R - 1 or fl(rows + 1) > 232448)
    elif E * -(-B // bc) * G > 132:
        assert rows == 0
    else:
        assert 0 <= rows <= R and (rows == R or fl(rows + 1) > 232448)
    too_many = R if layout == "smem1" else R + 1 if layout == "global" else 1
    assert stream._mid_fwd_shape(E, B, N, iters, True, layout,
                                 too_many) is None
    assert stream._mid_fwd_shape(E, B, N, iters, True, layout, 0)[5] == 0


def test_mid_fwd_band_rows_at_the_cases():
    """The rows of the slice's cases: N = 512 (smem1) 22 of 32 a step
    ahead, N = 1024 (global) 26 of 64 resident, also at E = 8 (128 CTAs),
    none at E = 16 (256 CTAs); N = 256 two whole slots."""
    f = stream._mid_fwd_shape
    assert f(1, 1, 512, 4, True)[4:] == ("smem1", 22)
    assert f(1, 1, 1024, 8, False)[4:] == ("global", 26)
    assert f(8, 1, 1024, 8, False)[4:] == ("global", 26)
    assert f(16, 1, 1024, 8, False)[4:] == ("global", 0)
    assert f(1, 1, 256, 4, True)[4:] == ("smem2", 0)
    assert f(1, 16, 256, 8, False)[:2] == (16, 8)


@pytest.mark.parametrize("N,G", [(256, 16), (200, 16), (130, 8), (1024, 16),
                                 (22, 8), (13, 4), (65, 2), (7, 1)])
@pytest.mark.parametrize("bc", [1, 2, 4, 8])
def test_mid_fwd_expected_bytes(N, G, bc):
    """The bytes each CTA's arrival expects per exchange
    (stream.mid_fwd_tx) are the bytes the other CTAs push into it: every
    row of every other band (the last band ragged) for each of the chunk's
    nb states (a partial chunk: nb < Bc), 8 bytes a (re, im) pair; and a
    warp's lanes (stream.mid_fwd_push_pairs) push each (state, CTA) pair of
    a row exactly once."""
    R = -(-N // G)
    if (G - 1) * R >= N:
        pytest.skip("not a launch shape (an empty band)")
    nr = [min(R, N - q * R) for q in range(G)]
    assert sum(nr) == N and min(nr) > 0
    for nb in range(1, bc + 1):
        pairs = stream.mid_fwd_push_pairs(G, nb)
        flat = [p for lane in pairs for p in lane]
        assert sorted(flat) == [(b, q) for b in range(nb) for q in range(G)]
        for rank in range(G):
            landed = sum(8 * nr[src] for src in range(G) if src != rank
                         for b, q in flat if q == rank)
            assert stream.mid_fwd_tx(N, G, rank, nb) == landed
            assert landed < 1 << 20


def _ring_model(G, W, nt, iters, rng, buffers=2, rowless=0):
    """A model of csrc/stream_mid.cu stream_mid_fwd's exchange ring: G CTAs
    of W warps (the last `rowless` of each own no band row: they read no
    operand and push nothing, but arrive), the stages of
    stream.mid_fwd_exchanges, events in a random order: a warp waits for
    the exchange its stage reads (the parity wait on that buffer's
    mbarrier), reads the buffer, pushes its rows' entries of the next
    exchange (each push landing later, in any order) and arrives. Raises
    AssertionError where a push lands in a buffer some warp of its CTA has
    not finished reading, lands on an mbarrier whose previous phase is
    open, or a parity wait would answer wrongly; returns the events run."""
    stages = stream.mid_fwd_exchanges(nt, iters)
    n_ex = 1 + sum(w is not None for *_, w in stages)
    owners = [w for w in range(W) if w < W - rowless]
    done_read = [[-1] * W for _ in range(G)]      # last exchange read
    phase = [[0] * buffers for _ in range(G)]     # phases completed
    landed = [[0] * n_ex for _ in range(G)]       # pushes landed
    arrived = [[0] * n_ex for _ in range(G)]      # warps arrived
    pos = [[-1] * W for _ in range(G)]            # -1: prologue
    state = [["push"] * W for _ in range(G)]
    pending = []                                  # (exchange, CTA)

    def complete(c, e):
        b, k = e % buffers, e // buffers
        while (phase[c][b] == k and arrived[c][e] == W
               and landed[c][e] == G * len(owners)):
            phase[c][b] += 1

    def push(c, w, e):
        if w in owners:
            pending.extend((e, y) for y in range(G))
        arrived[c][e] += 1
        complete(c, e)

    events = 0
    while True:
        moves = [("land", i) for i in range(len(pending))]
        for c in range(G):
            for w in range(W):
                if pos[c][w] < len(stages):
                    moves.append(("warp", (c, w)))
        if not moves:
            break
        kind, arg = moves[rng.integers(len(moves))]
        events += 1
        if kind == "land":
            e, y = pending.pop(arg)
            assert all(done_read[y][w] >= e - buffers for w in owners), \
                "a push landed in a buffer still being read"
            assert phase[y][e % buffers] == e // buffers, \
                "a push landed on an open earlier phase"
            landed[y][e] += 1
            complete(y, e)
            continue
        c, w = arg
        p = pos[c][w]
        if p < 0:                       # x0 into exchange 0
            push(c, w, 0)
            pos[c][w] = 0
            state[c][w] = "wait"
            continue
        t, j, e, wr = stages[p]
        if state[c][w] == "wait":
            b = e % buffers
            ready = phase[c][b] > e // buffers
            parity = phase[c][b] % 2 != (e // buffers) % 2
            assert phase[c][b] - e // buffers in (0, 1) and parity == ready
            if ready:
                state[c][w] = "read"
        elif state[c][w] == "read":
            if w in owners:
                done_read[c][w] = e
            if wr is not None:
                push(c, w, wr)
            pos[c][w] += 1
            state[c][w] = "wait"
    assert all(p == len(stages) for row in pos for p in row), "deadlock"
    assert not pending
    return events


@pytest.mark.parametrize("iters", [0, 1, 2, 3, 4, 7])
@pytest.mark.parametrize("G,W,rowless", [(2, 1, 0), (3, 2, 0), (4, 3, 1)])
def test_mid_fwd_exchange_ring_model(G, W, rowless, iters):
    """The forward's exchange sequence (stream.mid_fwd_exchanges: exchange
    0 is x0, each stage's k_j and each step's next x one exchange after
    the other, 1 + iters a step, odd and even) on two buffers with their
    mbarriers' parity: over random orders of several steps no push lands
    in a buffer before every warp of its CTA has read it, nor on an
    mbarrier before the buffer's previous phase completed, every parity
    wait answers right, and every warp runs to the end. One buffer (the
    kernel without its ring) fails the model."""
    rng = np.random.default_rng(iters + 10 * G)
    stages = stream.mid_fwd_exchanges(4, iters)
    assert len(stages) == 4 * (iters + 1)
    assert [r for _, _, r, _ in stages] == list(range(len(stages)))
    assert stages[-1][3] is None and all(
        w == r + 1 for _, _, r, w in stages[:-1])
    for _ in range(20):
        _ring_model(G, W, 4, iters, rng, rowless=rowless)
    if G > 1:
        with pytest.raises(AssertionError):
            for _ in range(50):
                _ring_model(G, W, 4, iters, rng, buffers=1,
                            rowless=rowless)


def _jax_stream_admits(N, nt):
    """quandary_tpu/problem.py:461-464 as written there."""
    P = -(-N // 128) * 128
    return 6 * nt * P * P * 4 <= 8 * (1 << 30)


GATE_N = (16, 64, 100, 128, 154, 155, 165, 166, 200, 256, 257, 300, 384,
          400, 512, 513, 598, 599, 640, 1024, 1025)


@pytest.mark.parametrize("nt", [1000, 1221, 4884])
@pytest.mark.parametrize("B", [1, 4])
def test_route_admits_what_jax_admits(nt, B):
    """'stream' (iters 3 and 4, stored or replayed): the route refuses
    exactly where the JAX gate refuses, naming the plane bytes. 'chunk'
    (neumann-8): exactly where dim > 1024 or the port's plane budget
    (6 x ntime x N^2 f32 within 8 GiB) refuses. Past one block the mid pair
    takes the plan."""
    for N in GATE_N:
        for iters in (3, 4):
            why = stream.route_refusal(B, N, iters, nt)
            assert (why is None) == _jax_stream_admits(N, nt), (N, why)
            if why is not None:
                assert "plane arrays" in why
            assert (stream.route_refusal(B, N, iters, nt, store=False)
                    is None) == (why is None)
        chunk_ok = N <= 1024 and 6 * 4 * nt * N * N <= 8 << 30
        why = stream.route_refusal(B, N, 8, nt, kind="chunk")
        assert (why is None) == chunk_ok, (N, why)
        if why is not None and N > 1024:
            assert "problem.py:465-466" in why
        dense = stream.route_refusal(B, N, 8, nt, kind="dense")
        assert (dense is None) == (6 * 4 * nt * N * N <= 8 << 30)
        for kind in ("stream", "chunk"):
            if stream._block_refusal(B, N, 8) is not None and \
                    stream.route_refusal(B, N, 8, nt, kind=kind) is None:
                assert stream._mid_shape(1, B, N, 8, False, True) is not None


def test_route_keeps_one_block_and_names_limits():
    """One block keeps what it took (the first refused N: 166 at B = 1 with
    4 iterations, 155 at B = 4 with 3, 138 with chunk's 8, 65 at B = 16);
    past it the mid pair; the device budget and E scale the refusals."""
    for B, N, iters in ((1, 166, 4), (4, 155, 3), (4, 138, 8), (16, 65, 3)):
        assert stream.size_refusal(B, N - 1, iters) is None
        assert stream._block_refusal(B, N, iters) is not None
        assert stream.route_refusal(B, N, iters, 1000) is None
    # the E = 128 flagship sweep stays on one block, under the budget
    assert stream.route_refusal(4, 16, 3, 1221, E=128) is None
    assert "PLANE_BUDGET_BYTES" in stream.route_refusal(4, 256, 4, 1000,
                                                        E=8)
    # N = 256 basis at 1000 steps: the backward's tracks keep the partial
    # plane cotangents within MID_PARTIAL_BYTES, so E = 4 fits as the JAX
    # gate's planes do; E = 8 passes the plane budget
    assert stream.route_refusal(256, 256, 4, 1000, store=False) is None
    assert stream.mid_refusal(4, 256, 256, 4, 1000, False) is None
    assert "PLANE_BUDGET_BYTES" in stream.mid_refusal(8, 256, 256, 4, 1000,
                                                      False)


@pytest.mark.parametrize("nt", [64, 1000, 4884])
@pytest.mark.parametrize("E,B,N,iters", PLAN_SHAPES)
def test_mid_tracks_bound_the_partials(E, B, N, iters, nt):
    """The backward's tracks: 1 to the number of chunks of states, more than
    one only while the launch's CTAs fill at most the card's SMs and the
    partial plane cotangents stay within MID_PARTIAL_BYTES; and
    mid_sweep_bytes counts them (besides the history, its cotangent and the
    stored iterates) on the chain schedule, and on the planner's."""
    from quandary_tpu_torch.ops import streamk
    for store in (True, False):
        G, bc, _, _, layout = stream._mid_shape(E, B, N, iters, store, True)
        chunks = -(-B // bc)
        tracks = stream.mid_tracks(E, B, N, nt, G, bc)
        assert 1 <= tracks <= chunks
        partial = 2 * E * tracks * nt * N * N * 4
        if tracks > 1:
            assert E * tracks * G <= streamk.MID_SMS
            assert partial <= stream.MID_PARTIAL_BYTES
        elif chunks > 1:        # one more track would break a limit
            assert (E * 2 * G > streamk.MID_SMS
                    or 2 * partial > stream.MID_PARTIAL_BYTES)
        hist = streamk.history_bytes(E, B, N, iters, nt, store)
        scratch = (4 * E * tracks * G * 2 * stream._pad4(-(-N // G) * (N + 1))
                   if layout == "global" else 0)
        assert stream.mid_sweep_bytes(E, B, N, iters, nt, store,
                                      schedule="chain") == \
            hist + (partial if tracks > 1 else 0) + scratch
        assert stream.mid_sweep_bytes(E, B, N, iters, nt, store) == \
            stream.mid_sweep_bytes(E, B, N, iters, nt, store, schedule=(
                stream.mid_bwd_schedule(E, B, N, iters, nt, store)))


# (E, B, N, iters, ntime, store, kind) of scripts/stream_mid_parent.py's
# cases: stream256, stream512, chunk256, stream512r, chunk1024, open2
SCHEDULE_CASES = {
    "stream256": (1, 1, 256, 4, 1000, True, "stream"),
    "stream512": (1, 1, 512, 4, 1000, True, "stream"),
    "chunk256": (1, 1, 256, 8, 1000, False, "chunk"),
    "stream512r": (1, 1, 512, 8, 1000, False, "stream"),
    "chunk1024": (1, 1, 1024, 8, 300, False, "chunk"),
    "open2": (1, 16, 256, 8, 1221, False, "stream"),
}


@pytest.mark.parametrize("name", list(SCHEDULE_CASES))
def test_mid_bwd_schedule_picks(name):
    """The backward's schedule by size: 'helpers' where the chain clusters
    leave the card's SMs room for a replay or helper cluster each (B = 1:
    16 of 132 SMs), 'chain' at open configuration 2 on superop (6 tracks of
    16 CTAs, 96 SMs); the card's count of clusters can only take 'helpers'
    away (a card that holds no second cluster per chain cluster), and a
    replayed case needs room for its replay cluster."""
    E, B, N, iters, nt, store, kind = SCHEDULE_CASES[name]
    want = "chain" if name == "open2" else "helpers"
    assert stream.mid_bwd_schedule(E, B, N, iters, nt, store, kind) == want
    assert stream.mid_bwd_schedule(E, B, N, iters, nt, store, kind,
                                   holds=8) == want
    assert stream.mid_bwd_schedule(E, B, N, iters, nt, store, kind,
                                   holds=1) == "chain"
    replay = not store and iters > 0
    if want == "helpers":
        groups = stream._help_groups(E, B, N, iters, nt, store)[0]
        G = stream._mid_help_shape(E, B, N, iters, store)[0]
        assert groups == 1 and G == 16
        assert stream.mid_helper_clusters(groups, G, 7, replay) == \
            6 - int(replay)
        assert stream.mid_helper_clusters(groups, G, 100, replay) == \
            7 - int(replay)
        assert stream.mid_helper_clusters(groups, G, 2, replay) == \
            1 - int(replay)
        assert stream.mid_helper_clusters(groups, G, 1, replay) == -1
        assert stream.mid_bwd_schedule(E, B, N, iters, nt, store, kind,
                                       holds=2) == "helpers"


def test_mid_bwd_schedule_forced(monkeypatch):
    """A forced schedule is taken as it is where it fits; an unknown one,
    or 'helpers' where its rings would take the sweep past
    DEVICE_BUDGET_BYTES, raises (the chain still fits there, and the
    planner takes it)."""
    from quandary_tpu_torch.ops import streamk
    E, B, N, iters, nt, store, kind = SCHEDULE_CASES["stream512r"]
    for s in stream.MID_SCHEDULES:
        assert stream.mid_bwd_schedule(E, B, N, iters, nt, store, kind,
                                       s) == s
    assert stream.mid_bwd_schedule(1, 16, 256, 8, 1221, False, "stream",
                                   "helpers") == "helpers"
    with pytest.raises(ValueError, match="schedule 'split'"):
        stream.mid_bwd_schedule(E, B, N, iters, nt, store, kind, "split")
    chain = stream.mid_sweep_bytes(E, B, N, iters, nt, store, kind, "chain")
    helpers = stream.mid_sweep_bytes(E, B, N, iters, nt, store, kind,
                                     "helpers")
    assert helpers > chain
    monkeypatch.setattr(streamk, "DEVICE_BUDGET_BYTES", helpers - 1)
    with pytest.raises(ValueError, match="schedule 'helpers' does not fit"):
        stream.mid_bwd_schedule(E, B, N, iters, nt, store, kind, "helpers")
    assert stream.mid_bwd_schedule(E, B, N, iters, nt, store, kind) == \
        "chain"
    assert stream.mid_refusal(E, B, N, iters, nt, store, kind) is None
    monkeypatch.setattr(streamk, "DEVICE_BUDGET_BYTES", chain - 1)
    assert "rings take" in stream.mid_refusal(E, B, N, iters, nt, store,
                                              kind)


@pytest.mark.parametrize("name", list(SCHEDULE_CASES))
def test_mid_sweep_bytes_count_the_rings(name):
    """On 'helpers' a sweep's bytes hold each group's rings (H^T and the
    pairs, two slots each; with replay MID_HELP_W steps of iterates) and
    counters instead of the chain's column-band scratch; mid_refusal
    counts the planner's."""
    E, B, N, iters, nt, store, kind = SCHEDULE_CASES[name]
    G, bc, _, _, layout = stream._mid_shape(E, B, N, iters, store, True)
    tracks = stream.mid_tracks(E, B, N, nt, G, bc)
    groups, S = E * tracks, -(-(-(-B // bc)) // tracks) * nt
    replay = not store and iters > 0
    ldr = -(-N // 4) * 4
    ring = (2 * 2 * N * ldr + 2 * (iters + 1) * 4 * bc * N
            + (4 * iters * 2 * bc * N if replay else 0))
    flags = 1 + groups * (1 + 2 * 4 + 3 * (S + 2))
    scratch = 2 * G * stream._pad4(-(-N // G) * (N + 1)) \
        if layout == "global" else 0
    d = (stream.mid_sweep_bytes(E, B, N, iters, nt, store, kind, "helpers")
         - stream.mid_sweep_bytes(E, B, N, iters, nt, store, kind, "chain"))
    assert d == 4 * (groups * ring + flags) - 4 * E * tracks * scratch
    planner = stream.mid_bwd_schedule(E, B, N, iters, nt, store, kind)
    assert stream.mid_sweep_bytes(E, B, N, iters, nt, store, kind) == \
        stream.mid_sweep_bytes(E, B, N, iters, nt, store, kind, planner)


@pytest.mark.parametrize("store", [True, False])
@pytest.mark.parametrize("E,B,N,iters", PLAN_SHAPES)
def test_mid_help_shape_covers_and_fits(E, B, N, iters, store):
    """The helpers schedule's launch shape: the chain schedule's G, Bc and
    threads (Hb keeps its bits between them); at least the shared memory
    csrc/stream_mid.cu's help_floats carves (the chain's column band in it
    for 'smem', the replay's row band in `rslots` slots) and at most 227
    KB; 'global' only where the band does not fit, and the replay's row
    band in the most slots that fit."""
    shape = stream._mid_help_shape(E, B, N, iters, store)
    assert shape is not None
    G, bc, threads, smem, layout, rslots = shape
    assert (G, bc, threads) == stream._mid_shape(E, B, N, iters, store,
                                                 True)[:3]
    R = -(-N // G)
    replay, stored = not store and iters > 0, store and iters > 0
    fl = lambda h, rs: stream._help_floats(bc, N, R, iters, replay, stored,
                                           h, rs)
    hsmem = layout == "smem"
    assert 4 * fl(hsmem, rslots) == smem <= 232448
    assert hsmem or 4 * fl(True, 0) > 232448
    assert rslots == 0 if not replay else (
        rslots == 2 or 4 * fl(hsmem, rslots + 1) > 232448)
    # the chain's layout: header, exchange buffers, bands, rows, operand
    # slots, then the band or a tile; the replay's and a tile's within it
    head = (4 * bc * N + (10 if replay else 6) * bc * R + 4 * R
            + 2 * (4 + 2 * (iters if stored else 0)) * bc * R)
    tile = 2 * 64 * 33 + (iters + 1) * 2 * bc * (32 + 64)
    assert fl(hsmem, rslots) >= 8 + stream._pad4(head) + max(
        2 * R * -(-N // 4) * 4 if hsmem else 0, tile)
    assert stream._mid_help_shape(E, B, N, iters, store, "global")[4] == \
        "global"


class _Fake:
    """A CUDA tensor's shape and device without a card."""

    def __init__(self, *shape, kind="cuda"):
        self.shape, self.device = shape, torch.device(kind)


@pytest.mark.parametrize("B,N,iters,mid", [
    (4, 16, 3, False), (4, 154, 3, False), (1, 165, 4, False),
    (64, 16, 3, False), (4, 155, 3, True), (1, 166, 4, True),
    (16, 65, 3, True), (1, 512, 4, True), (4, 138, 8, True)])
def test_dispatch_goes_to_the_mid_pair(monkeypatch, B, N, iters, mid):
    """Both directions of every member go to the mid pair exactly where one
    block refuses the plan, else to csrc/stream.cu; a CUDA tensor never
    takes the plain version, and the mid wrappers refuse CPU tensors."""
    calls = []
    for name in ("_kernel_fwd", "_kernel_bwd"):
        monkeypatch.setattr(stream_mid, name,
                            lambda *a, n=name, **k: calls.append("mid" + n))
    for name in ("_block_fwd", "_block_bwd"):
        monkeypatch.setattr(stream, name,
                            lambda *a, n=name, **k: calls.append(n))
    for name in ("plain_forward", "plain_backward",
                 "stream_propagate_plain"):
        monkeypatch.setattr(stream, name, lambda *a: calls.append("plain"))
    z = torch.zeros(3, N, N)
    for kind in ("stream", "chunk", "dense"):
        plan = stream.make_plan(z, 0.01, iters, kind=kind)
        assert stream.uses_mid(plan, B, N) == mid
        H, x0 = _Fake(1, 5, N, N), _Fake(B, N)
        stream._kernel_fwd(plan, H, H, x0, x0)
        stream._kernel_bwd(plan, H, H, x0, x0, *[None] * 8)
    want = ["mid_kernel_fwd", "mid_kernel_bwd"] if mid \
        else ["_block_fwd", "_block_bwd"]
    assert calls == want * 3
    monkeypatch.undo()
    plan = stream.make_plan(z, 0.01, iters)
    zero = torch.zeros(B, N)
    with pytest.raises(NotImplementedError, match="CUDA"):
        stream_mid._kernel_fwd(plan, z[None], z[None], zero, zero)
    with pytest.raises(NotImplementedError, match="CUDA"):
        stream_mid._kernel_bwd(plan, z[None], z[None], zero, zero,
                               *[torch.zeros(1)] * 8)


def _closed_setup(nlevels=(12, 14), ntime=10, T=2.0):
    """Two qudits of 12 and 14 levels with 2 essential each (N = 168, the
    4 basis states of a CNOT; one block refuses B = 4 at N >= 155), split
    with 3 iterations, complex64, built with the JAX package's builders,
    pallas=True on 'stream'."""
    from quandary_tpu.models import gates
    from quandary_tpu.models.hamiltonian import build_standard_model
    from quandary_tpu.problem import Setup
    from quandary_tpu.utils.splines import ControlSegment, OscillatorControl
    nlevels, Ne = list(nlevels), [2, 2]
    model = build_standard_model(
        nlevels=nlevels, freq01_ghz=FREQ01, rotfreq_ghz=FREQ01,
        selfkerr_ghz=[0.2198, 0.2252], jkl_ghz=[0.005], crosskerr_ghz=[])
    oscs = tuple(OscillatorControl(
        segments=(ControlSegment("spline", nsplines=6, tstart=0.0,
                                 tstop=T),), carrier_freqs=(0.0,))
        for _ in range(2))
    V = gates.assemble_gate(gates.cnot(), nlevels, Ne, [0.0, 0.0], T)
    return Setup(
        model=model, nessential=tuple(Ne), ntime=ntime, dt=T / ntime,
        oscillators=oscs,
        ground_freqs_radns=tuple(2 * np.pi * f for f in FREQ01),
        initcond_type="basis", target_type="gate", target_gate_full=V,
        objective_type="Jtrace", gamma_tik=1e-4, gamma_penalty=0.1,
        dtype=jnp.complex64, linsolve_iters=3, linsolver="split",
        pallas=True, pallas_mode="stream")


def _open_setup():
    """The guarded open CNOT (N = 16, 4 diagonal density matrices, jacobi
    by the stiffness guard) on 'stream', cut to 8 steps: the superop form
    at dim 256, whose B x dim = 1024 entries one block's shared memory
    refuses."""
    return dataclasses.replace(guarded_setup(), ntime=8, dtype=jnp.complex64,
                               pallas=True, pallas_mode="stream")


@pytest.mark.parametrize("make_setup,form", [(_closed_setup, "stream"),
                                             (_open_setup, "superop")],
                         ids=["closed-n168", "open-superop-dim256"])
def test_problem_past_one_block_matches_jax_pallas(highest, make_setup,
                                                   form):
    sj = make_setup()
    pj = JProblem(sj)
    pt = TProblem(port_setup(sj), device="cpu")
    assert pj.use_pallas and pt.fused_form == form and pt.fused_ok
    dim = pt._Sr.shape[-1]
    assert stream.uses_mid(pt._plan, pt.ninit, dim)
    x = np.random.default_rng(1234).uniform(-1, 1, sj.nparams) * 0.02
    (Jj, _), gj = pj.build_value_and_grad()(jnp.asarray(x), jnp.asarray(x))
    (Jt, _), gt = pt.build_value_and_grad()(x, x)
    Jj, gj = float(Jj), np.asarray(gj, np.float64)
    Jt, gt = float(Jt), gt.double().numpy()
    assert abs(Jt - Jj) <= 2e-6 * abs(Jj)
    assert np.abs(gt - gj).max() <= 2e-6 * np.abs(gj).max()


def test_stack_cotangents_past_one_block_match_pallas_stream(highest):
    """make_stream_propagate (the calibration's route) at N = 170, B = 4
    (past one block): states and the stack, coefficient and x0 cotangents
    against the JAX stream kernel in interpret mode, to 2e-6 x max, as
    tests/test_torch_stream.py holds them below the limit."""
    from test_torch_stream import _assert_close, _case, _jax_run, _torch_run
    c = _case(5, k=3, n=170, b=4, nt=6)
    assert stream._block_refusal(4, 170, 3) is not None
    ref = _jax_run(c, pallas_stream.make_stream_propagate(
        c["stack"], 0.002, 3, gen_diag=c["gen_diag"], linsolver="split",
        interpret=True))
    got = _torch_run(c, stream.make_stream_propagate(
        0.002, 3, gen_diag=c["gen_diag"], linsolver="split"))
    _assert_close(got, ref, 2e-6)


@pytest.mark.parametrize("ntime", [12, 1000, 1221, 4884])
@pytest.mark.parametrize("iters", [0, 3, 4, 8])
def test_store_iters_rule_is_jax(ntime, iters):
    """The 'stream' plan stores its stage iterates exactly where the JAX
    Problem passes store_iters=True to make_stream_propagate
    (quandary_tpu/problem.py:1179, _store_iters_ok :1333-1343, with the
    kernel's iters <= 4); 'chunk' and dense never store."""
    z = torch.zeros(1, 4, 4)
    for ninit in (1, 4, 8, 16, 100, 256, 1024):
        for dim in (16, 64, 200, 256, 512, 1024):
            ok = store_iters_ok(ntime, iters, ninit, dim)
            assert ok == _jax_store_iters_ok(ntime, iters, ninit, dim)
            for kind in ("stream", "chunk", "dense"):
                plan = stream.make_plan(z, 0.1, iters, kind=kind,
                                        store_iters=ok)
                assert plan.store_iters == (ok and kind == "stream")


def test_problem_stream_store_iters():
    """midsize_bench's basis run at N = 256 on 'stream' replays its stage
    iterates (2.1 GB past 1.5 GiB), its pure run stores them; both are past
    one block and admitted."""
    from test_torch_streamk_mid import _midsize_setup
    for init, stored in (("basis", False), ("pure", True)):
        sj = dataclasses.replace(_midsize_setup(256, init),
                                 pallas_mode="stream")
        pt = TProblem(port_setup(sj), device="cpu")
        assert pt.fused_form == "stream" and pt.fused_ok, pt.fused_refusal
        assert pt._plan.store_iters == stored
        assert stream.uses_mid(pt._plan, pt.ninit, 256)


def test_problem_ensemble_refusal():
    """midsize_bench's basis run at N = 256 on 'stream' (1000 steps): the
    route takes up to 5 candidates in one launch; at the device driver's 8
    line-search trial steps the plane arrays pass PLANE_BUDGET_BYTES, and
    build_device_optimizer raises on CUDA before any iteration, naming it."""
    from types import SimpleNamespace
    from quandary_tpu_torch.optim import device_driver as dd
    from test_torch_streamk_mid import _midsize_setup
    sj = dataclasses.replace(_midsize_setup(256, "basis"),
                             pallas_mode="stream")
    pt = TProblem(port_setup(sj), device="cpu")
    assert pt.fused_ok and pt.setup.ntime == 1000
    for E in (1, 4, 5):
        assert pt.ensemble_refusal(E) is None
    for E in (6, 8):
        assert "PLANE_BUDGET_BYTES" in pt.ensemble_refusal(E)
    fake = SimpleNamespace(rdtype=torch.float32, device=torch.device("cuda"),
                           use_fused=True, ensemble_refusal=pt.ensemble_refusal)
    with pytest.raises(NotImplementedError, match="ls_lengths = 8 .*"
                       "PLANE_BUDGET_BYTES"):
        dd.build_device_optimizer(fake, [0.0], [1.0], graph=False)


def test_default_setup_takes_the_plain_loop():
    """Setup(model=..., oscillators=..., nessential, ntime, dt) with every
    other field at its default (complex128, fused='auto',
    time_parallel='auto') builds on the CPU off the fused route, on the
    time-parallel scan at this size, as the reference's default Setup
    (pallas='auto', quandary_tpu/problem.py:207) takes its scans off a
    TPU."""
    from quandary_tpu_torch.models.hamiltonian import build_standard_model
    from quandary_tpu_torch.problem import Setup
    from quandary_tpu_torch.utils.splines import (ControlSegment,
                                                  OscillatorControl)
    model = build_standard_model(
        nlevels=[3], freq01_ghz=[4.1], rotfreq_ghz=[4.1],
        selfkerr_ghz=[0.22], crosskerr_ghz=[], jkl_ghz=[])
    osc = OscillatorControl(segments=(ControlSegment(
        "spline", nsplines=5, tstart=0.0, tstop=1.0),), carrier_freqs=(0.0,))
    setup = Setup(model=model, nessential=(2,), ntime=10, dt=0.1,
                  oscillators=(osc,))
    assert setup.fused == "auto" and setup.dtype == torch.complex128
    p = TProblem(setup, device="cpu")
    assert not p.use_fused and p.fused_form is None
    assert "complex128" in p.fused_refusal
    assert setup.time_parallel == "auto" and p.time_parallel


def test_default_graph_rule():
    """CUDA problems on a kernel route capture the chunk as a CUDA graph;
    the plain route runs its chunks eagerly (its captured chunk faults at a
    replay, ROADMAP C1), whatever its size; CPU problems never capture."""
    from types import SimpleNamespace
    from quandary_tpu_torch.optim import device_driver as dd

    def fake(device, fused):
        return SimpleNamespace(device=torch.device(device), use_fused=fused)
    assert dd.default_graph(fake("cuda", True))
    assert not dd.default_graph(fake("cuda", False))
    assert not dd.default_graph(fake("cpu", True))
    assert not dd.default_graph(fake("cpu", False))
