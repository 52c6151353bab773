"""quandary_tpu_torch.optim.device_driver against
quandary_tpu.optim.device_driver in f64 on the two workloads of
tests/test_device_driver.py: the small guarded CNOT (N = 6, ntime = 12) and
the one-qubit state flip that converges inside a chunk.

Both loops are the same algorithm on the same numbers, so their history
rows agree to 1e-8 relative for as long as they accept the same step
lengths (asserted for at least the first 5 iterations); after a differing
pick only the final objective is compared, within 5%. Row count, stop
reason, the stop inside a chunk, `maxiter`, and the layout of the durable
files are held equal. On the CPU the port's chunk runs eagerly; the CUDA
graph of the chunk is exercised on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import dataclasses
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quandary_tpu.optim.device_driver import (  # noqa: E402
    run_optimization_device as jrun)
from quandary_tpu_torch.optim.device_driver import (  # noqa: E402
    build_device_optimizer, run_optimization_device)
from quandary_tpu_torch.problem import Problem as TProblem  # noqa: E402
from test_torch_model import port_setup  # noqa: E402

TIGHT = dict(gatol=1e-14, grtol=1e-30, inftol=1e-12, fatol=1e-14,
             verbose=False)
COLUMNS = ("objective", "gnorm", "step", "fidelity", "cost", "tikhonov",
           "penalty", "penalty_dpdm", "penalty_energy", "penalty_variation")


def _cnot(**port_kw):
    from __graft_entry__ import _build_problem
    pj, sj = _build_problem(ntime=12, T=2.0, dtype=jnp.complex128)
    pt = TProblem(port_setup(sj, **port_kw), device="cpu")
    x0 = np.random.default_rng(42).normal(size=sj.nparams) * 0.02
    return pj, pt, x0, np.full(sj.nparams, -1.0), np.full(sj.nparams, 1.0)


def _flip():
    from quandary_tpu.models.hamiltonian import build_standard_model
    from quandary_tpu.problem import Problem, Setup
    from quandary_tpu.utils.splines import ControlSegment, OscillatorControl

    T, ntime = 80.0, 160
    model = build_standard_model(
        nlevels=[2], freq01_ghz=[4.10595], rotfreq_ghz=[4.10595],
        selfkerr_ghz=[0.2198], jkl_ghz=[], crosskerr_ghz=[])
    oscs = (OscillatorControl(
        segments=(ControlSegment("spline", nsplines=10, tstart=0.0,
                                 tstop=T),),
        carrier_freqs=(0.0,)),)
    sj = Setup(
        model=model, nessential=(2,), ntime=ntime, dt=T / ntime,
        oscillators=oscs, ground_freqs_radns=(2 * np.pi * 4.10595,),
        initcond_type="pure", pure_levels=(0,),
        target_type="pure", pure_target_levels=(1,),
        objective_type="Jtrace", gamma_tik=1e-6,
        dtype=jnp.complex128, linsolve_iters=10)
    x0 = np.random.default_rng(5).normal(size=sj.nparams) * 0.01
    return (Problem(sj), TProblem(port_setup(sj), device="cpu"), x0,
            np.full(sj.nparams, -0.06), np.full(sj.nparams, 0.06))


def _assert_histories(rt, rj, min_agree=5):
    """Rows equal to 1e-8 while the accepted steps agree; the final
    objective within 5% after a differing pick."""
    assert len(rt.history) == len(rj.history)
    assert rt.niter == rj.niter and rt.reason == rj.reason
    agree = 0
    for ht, hj in zip(rt.history, rj.history):
        assert ht.iter == hj.iter
        if ht.step != hj.step:
            break
        for c in COLUMNS:
            np.testing.assert_allclose(
                getattr(ht, c), getattr(hj, c), rtol=1e-8, atol=1e-13,
                err_msg=f"iteration {ht.iter}, column {c}")
        agree += 1
    assert agree > min(min_agree, len(rj.history) - 1), agree
    assert abs(rt.objective - rj.objective) <= 0.05 * abs(rj.objective)
    return agree


@pytest.fixture(scope="module")
def jax_cnot_25():
    pj, _, x0, lb, ub = _cnot()
    return jrun(pj, x0, lb, ub, maxiter=25, chunk=8, **TIGHT)


@pytest.mark.parametrize("fused", [True, False])
def test_history_matches_jax_device_driver(jax_cnot_25, fused):
    """fused: the speculative line search (value and gradient at all 8
    trial points from one ensemble call); not fused: objective-only probes
    and one value_and_grad, the JAX path of this f64 problem."""
    _, pt, x0, lb, ub = _cnot(fused=fused)
    rt = run_optimization_device(pt, x0, lb, ub, maxiter=25, chunk=8,
                                 **TIGHT)
    assert rt.niter == 25 and rt.history[-1].iter == 25
    _assert_histories(rt, jax_cnot_25)
    assert rt.history[-1].objective < rt.history[0].objective
    assert np.all(rt.params >= lb - 1e-12) and np.all(rt.params <= ub + 1e-12)
    # the memo on the problem: a second run reuses the built optimizer
    (cached,) = pt._device_opt_cache.values()
    rt2 = run_optimization_device(pt, x0, lb, ub, maxiter=25, chunk=8,
                                  **TIGHT)
    assert list(pt._device_opt_cache.values()) == [cached]
    assert [h.objective for h in rt2.history] \
        == [h.objective for h in rt.history]


def test_stops_inside_chunk_like_jax():
    """A reachable infidelity tolerance stops both loops at the same
    iteration, mid-chunk: no trailing rows, the same reason."""
    pj, pt, x0, lb, ub = _flip()
    kw = dict(maxiter=100, chunk=16, inftol=1e-3, gatol=1e-14, grtol=1e-30,
              fatol=1e-14, verbose=False)
    rj = jrun(pj, x0, lb, ub, **kw)
    rt = run_optimization_device(pt, x0, lb, ub, **kw)
    assert rt.reason == "converged: small infidelity"
    assert rt.infidelity <= 1e-3 and rt.niter < 100
    assert rt.history[-1].iter == rt.niter and rt.niter % 16 != 0
    _assert_histories(rt, rj)


def _layout(path):
    """A data file as its header and the shape of every line: each number
    replaced by its sign, width and exponent form."""
    with open(path) as f:
        lines = f.read().split("\n")
    shape = lambda ln: re.sub(
        r"-?\d+\.?\d*(e[+-]\d+)?",
        lambda m: f"<{len(m.group(0).lstrip('-'))}{'e' if m.group(1) else ''}>",
        ln)
    head = [ln for ln in lines if ln.startswith("#")]
    return head, [shape(ln) for ln in lines if not ln.startswith("#")]


def test_maxiter_and_durable_output_like_jax(tmp_path):
    """maxiter = 7 with chunk = 5 lands exactly on 7 in both packages; the
    files of `datadir` have the same header, columns and number formats,
    and the numbers agree."""
    pj, pt, x0, lb, ub = _cnot()
    dj, dt_ = str(tmp_path / "jax"), str(tmp_path / "torch")
    rj = jrun(pj, x0, lb, ub, maxiter=7, chunk=5, datadir=dj, **TIGHT)
    rt = run_optimization_device(pt, x0, lb, ub, maxiter=7, chunk=5,
                                 datadir=dt_, **TIGHT)
    assert rt.niter == 7 and rt.history[-1].iter == 7
    assert _assert_histories(rt, rj) == 8
    # the returned params are the it = 7 iterate
    J, _ = pt.build_objective()(rt.params, x0)
    np.testing.assert_allclose(float(J), rt.history[-1].objective,
                               rtol=1e-9, atol=1e-12)
    assert sorted(os.listdir(dt_)) == sorted(os.listdir(dj)) == [
        "control0.dat", "control1.dat", "optim_history.dat", "params.dat"]
    for name in os.listdir(dj):
        ht, lt = _layout(os.path.join(dt_, name))
        hj, lj = _layout(os.path.join(dj, name))
        assert ht == hj and len(lt) == len(lj), name
        same = sum(a == b for a, b in zip(lt, lj))
        # a sign flip of a value at rounding level (1e-17 against -1e-17)
        # may move one character; nothing else may differ
        assert same >= len(lj) - 2, (name, same, len(lj))
        np.testing.assert_allclose(
            np.loadtxt(os.path.join(dt_, name)),
            np.loadtxt(os.path.join(dj, name)), rtol=1e-7, atol=1e-12,
            err_msg=name)
    np.testing.assert_allclose(np.loadtxt(os.path.join(dt_, "params.dat")),
                               rt.params, rtol=0, atol=1e-13)


def test_window_shift_recovers():
    """At ls_lengths = 1 every backtrack needs the adaptive window to shift
    below its only trial and retry: the run reaches maxiter with real
    progress instead of stopping on a rejected row."""
    _, pt, x0, lb, ub = _cnot()
    res = run_optimization_device(pt, x0, lb, ub, chunk=8, ls_lengths=1,
                                  maxiter=40, **TIGHT)
    assert res.niter == 40 and "line search failed" not in res.reason
    assert res.history[-1].objective < res.history[0].objective
    assert res.history[-1].gnorm < 0.05 * res.history[0].gnorm
    assert any(h.step == 0.0 for h in res.history[1:])
    assert np.all(res.params >= lb - 1e-12) and np.all(res.params <= ub + 1e-12)


def test_converged_start_never_enters_the_loop():
    _, pt, x0, lb, ub = _cnot()
    res = run_optimization_device(pt, x0, lb, ub, maxiter=5, inftol=1.0,
                                  verbose=False)
    assert res.niter == 0 and len(res.history) == 1
    assert res.reason == "converged: small infidelity"


def test_state_stays_on_the_device_and_graph_needs_cuda():
    """init and chunk take and return tensors only; on the CPU the chunk is
    eager, and asking for the CUDA graph there raises."""
    _, pt, x0, lb, ub = _cnot()
    init, chunk = build_device_optimizer(pt, lb, ub, chunk=3, maxiter=4)
    st = init(x0, x0)
    assert all(isinstance(v, torch.Tensor) for v in st.values())
    st, rows, done = chunk(st)
    assert rows.shape == (3, 11) and rows.dtype == torch.float64
    assert not bool(done) and rows[:, 0].tolist() == [1.0, 1.0, 1.0]
    st, rows, done = chunk(st)
    assert bool(done) and rows[:, 0].tolist() == [1.0, 0.0, 0.0]
    assert int(st["it"]) == 4
    with pytest.raises(ValueError, match="CUDA"):
        build_device_optimizer(pt, lb, ub, graph=True)


@pytest.mark.parametrize("chunk,per_iteration,want", [
    (10, 313_600, [4, 4, 2]), (10, 63_200, [10]), (8, 325_000, [4, 4]),
    (3, 5_000_000, [1, 1, 1]), (1, 313_600, [1])])
def test_graph_segments_stay_under_half_the_node_limit(chunk, per_iteration,
                                                       want):
    """A captured plain-route chunk is split into graphs of consecutive
    iterations under GRAPH_NODE_LIMIT / 2 nodes each (ROADMAP C1): the
    chunk of 10 iterations at 1000 steps (313,600 nodes each) into 4, 4
    and 2; an iteration past the limit alone still gets its own graph."""
    from quandary_tpu_torch.optim.device_driver import (GRAPH_NODE_LIMIT,
                                                        graph_segments)
    got = graph_segments(chunk, per_iteration)
    assert got == want and sum(got) == chunk
    if per_iteration <= GRAPH_NODE_LIMIT // 2:
        assert max(got) * per_iteration <= GRAPH_NODE_LIMIT // 2


def test_problem_without_a_device_raises_without_cuda():
    """The port's entry points run on the card unless the caller asks for
    the CPU: no quiet CPU default."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from quandary_tpu_torch.optim.robust import sample_standard_models
    _, pt, *_ = _cnot()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TProblem(pt.setup)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample_standard_models(
            dict(nlevels=[2], freq01_ghz=[4.1], rotfreq_ghz=[4.1],
                 selfkerr_ghz=[0.2]), [{}],
            {f.name: getattr(pt.setup, f.name)
             for f in dataclasses.fields(pt.setup) if f.name != "model"})
