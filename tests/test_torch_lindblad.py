"""Open (Lindblad) systems through quandary_tpu_torch against quandary_tpu.

The workloads are the guarded open CNOT of tests/test_pallas_rho.py
(_open_problem: N = 16, nt = 48, diagonal initial conditions, leakage
penalty, T1/T2 collapse) and the unguarded open CNOT of
scripts/perf/lindblad_pallas_bench.py:29-63 at a short horizon (N = 4,
16 basis density matrices). The port is built on the CPU from the arrays of
the JAX Setup, so both packages see the same problem.

1. host arrays bit-equal: the folded stack, the jump operators, the (N, N)
   generator diagonal, x0 for every density-matrix initial condition, the
   V rho0 V^dag targets, the pseudo-Hamiltonian stack of the superop route;
2. rhs and one step of each solver against the JAX engine in f64 (1e-12);
3. the objective in f64 against the JAX scan (J and every aux term 1e-10,
   gradient 1e-9 of max) on the rho route, the superop route and the plain
   complex loop; the f32 rho route against JAX pallas_rho='rho' in
   interpret mode under that test's 5e-5 / 5e-4; the f32 superop route
   against JAX pallas_mode='streamk' in interpret mode (2e-4 / 1e-3, the
   bounds of tests/test_torch_problem.py for the same kernels);
4. the host and the device driver, three iterations each, against the JAX
   drivers in f64;
5. the route gate, the refusals, the density-matrix sanity check.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the matrices are tiny: one thread per test process, so that test
# processes running side by side do not fight over the cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from quandary_tpu.problem import Problem as JProblem  # noqa: E402
from quandary_tpu_torch.problem import Problem as TProblem  # noqa: E402
from test_pallas_rho import _open_problem  # noqa: E402
from test_torch_model import _bit_equal, port_setup  # noqa: E402

AUX_RTOL = 1e-10


def guarded_setup(**kw):
    """The JAX Setup of tests/test_pallas_rho.py::_open_problem."""
    return dataclasses.replace(_open_problem(pallas=False).setup, **kw)


def unguarded_setup(T=4.0, ntime=24, **kw):
    """scripts/perf/lindblad_pallas_bench.py:29-63 with guards=False, cut
    to a short horizon for the CPU."""
    from quandary_tpu.models import gates
    from quandary_tpu.models.hamiltonian import build_standard_model
    from quandary_tpu.problem import Setup
    from quandary_tpu.utils.splines import ControlSegment, OscillatorControl
    Ne = [2, 2]
    freq01 = [4.80595, 4.8601]
    model = build_standard_model(
        nlevels=Ne, freq01_ghz=freq01, rotfreq_ghz=freq01,
        selfkerr_ghz=[0.2198, 0.2252], jkl_ghz=[0.005], crosskerr_ghz=[],
        decay_time=[80.0, 90.0], dephase_time=[40.0, 45.0], lindblad=True)
    oscs = tuple(
        OscillatorControl(
            segments=(ControlSegment("spline", nsplines=30, tstart=0.0,
                                     tstop=T),),
            carrier_freqs=(0.0, 2 * np.pi * (freq01[1 - k] - freq01[k])),
        ) for k in range(2))
    V = gates.assemble_gate(gates.cnot(), Ne, Ne, [0.0, 0.0], T)
    base = dict(
        model=model, nessential=tuple(Ne), ntime=ntime, dt=T / ntime,
        oscillators=oscs,
        ground_freqs_radns=tuple(2 * np.pi * f for f in freq01),
        initcond_type="basis", target_type="gate", target_gate_full=V,
        objective_type="Jtrace", gamma_tik=1e-4, gamma_penalty=0.1,
        gamma_penalty_energy=0.1, dtype=jnp.complex64, linsolve_iters=8,
        pallas=False, time_parallel=False)
    base.update(kw)
    return Setup(**base)


def _params(n, seed=3, scale=0.01):
    return np.random.default_rng(seed).uniform(-1, 1, n) * scale


def _vg(problem, x, as_jax):
    x = jnp.asarray(x) if as_jax else x
    (J, aux), g = problem.build_value_and_grad()(x, x)
    return float(J), {k: float(v) for k, v in aux.items()}, \
        np.asarray(g, dtype=np.float64)


def _assert_vg(got, want, rtol_J, rtol_g, aux_rtol=None):
    (Jt, auxt, gt), (Jj, auxj, gj) = got, want
    assert abs(Jt - Jj) <= rtol_J * max(1.0, abs(Jj))
    assert np.abs(gt - gj).max() <= rtol_g * np.abs(gj).max()
    if aux_rtol is not None:
        assert set(auxt) == set(auxj)
        for k in auxj:
            np.testing.assert_allclose(auxt[k], auxj[k], rtol=aux_rtol,
                                       atol=1e-14, err_msg=k)


# ----------------------------------------------------------------------
# 1. host arrays
# ----------------------------------------------------------------------

@pytest.mark.parametrize("initcond", ["basis", "diagonal", "3states"])
@pytest.mark.parametrize("dtype", [jnp.complex64, jnp.complex128])
def test_open_host_arrays_bit_equal(initcond, dtype):
    from quandary_tpu.ops.pallas_stream import lindblad_prime_stack as jprime
    from quandary_tpu_torch.ops.streamk import lindblad_prime_stack
    sj = guarded_setup(initcond_type=initcond, dtype=dtype)
    pj, pt = JProblem(sj), TProblem(port_setup(sj), device="cpu")
    assert pt.lindblad and pt.ninit == pj.ninit == {
        "basis": 16, "diagonal": 4, "3states": 3}[initcond]
    _bit_equal(pj.engine.stack, pt.engine.stack_np)
    _bit_equal(pj.engine.Ls, pt.engine.Ls_np)
    assert pt.gen_diag.shape == (16, 16)
    _bit_equal(pj.gen_diag, pt.gen_diag)
    _bit_equal(pj.x0, pt.x0)
    _bit_equal(pj.target, pt.target)
    _bit_equal(pj.purity, pt.purity)
    _bit_equal(pj.weights, pt.weights)
    _bit_equal(pj.guard_mask, pt.guard_mask)
    assert pj.linsolver == pt.linsolver == "jacobi"
    if initcond == "diagonal":
        _bit_equal(jprime(np.asarray(pj.engine.stack), pj.engine.Ls),
                   lindblad_prime_stack(pt.engine.stack_np, pt.engine.Ls_np))


def test_pure_state_target_becomes_a_projector():
    """target_type='state' with a vector: |t><t| per initial condition."""
    rng = np.random.default_rng(42)
    t = rng.normal(size=16) + 1j * rng.normal(size=16)
    t = t / np.linalg.norm(t)
    sj = guarded_setup(initcond_type="3states", target_type="state",
                       target_state_full=t, target_gate_full=None)
    pj, pt = JProblem(sj), TProblem(port_setup(sj), device="cpu")
    assert pt.target.shape == (3, 16, 16)
    _bit_equal(pj.target, pt.target)


# ----------------------------------------------------------------------
# 2. rhs and one step
# ----------------------------------------------------------------------

def test_rhs_and_population_match_jax_f64():
    from quandary_tpu.ops import rhs as jrhs
    from quandary_tpu.ops import solvers as jsolvers
    from quandary_tpu_torch.ops import rhs as trhs
    from quandary_tpu_torch.ops import solvers as tsolvers
    sj = guarded_setup(dtype=jnp.complex128)
    pj, pt = JProblem(sj), TProblem(port_setup(sj), device="cpu")
    rng = np.random.default_rng(0)
    c = rng.normal(size=(sj.model.K,))
    x = rng.normal(size=(3, 16, 16)) + 1j * rng.normal(size=(3, 16, 16))
    want = np.asarray(pj.engine.rhs(jnp.asarray(c), jnp.asarray(x)))
    got = pt.engine.rhs(torch.as_tensor(c), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # a batch of coefficient rows against a batch of state batches
    cs = rng.normal(size=(2, sj.model.K))
    got2 = pt.engine.rhs(torch.as_tensor(cs),
                         torch.as_tensor(np.stack([x, 2 * x]))).numpy()
    want1 = np.asarray(pj.engine.rhs(jnp.asarray(cs[1]), jnp.asarray(2 * x)))
    np.testing.assert_allclose(got2[1], want1, rtol=0, atol=1e-12)
    for lind in (True, False):
        y = x if lind else x[:, 0]
        np.testing.assert_allclose(
            trhs.state_population(torch.as_tensor(y), lind).numpy(),
            np.asarray(jrhs.state_population(jnp.asarray(y), lind)),
            rtol=1e-14, atol=0)
        np.testing.assert_allclose(
            tsolvers.population_full(torch.as_tensor(y), lind).numpy(),
            np.asarray(jsolvers.population_full(jnp.asarray(y), lind)),
            rtol=1e-14, atol=0)


@pytest.mark.parametrize("solver", ["neumann", "jacobi", "split"])
def test_one_step_matches_jax_f64(solver):
    from quandary_tpu.ops.steppers import make_step_fn as jstep
    from quandary_tpu_torch.ops.steppers import make_step_fn as tstep
    sj = guarded_setup(dtype=jnp.complex128)
    pj, pt = JProblem(sj), TProblem(port_setup(sj), device="cpu")
    rng = np.random.default_rng(1)
    c = rng.normal(size=(1, sj.model.K)) * 0.1
    c[0, 0] = 1.0
    x = (rng.normal(size=(2, 16, 16)) + 1j * rng.normal(size=(2, 16, 16)))
    sjx = jstep(pj.engine.rhs, sj.dt, "IMR", 4, solver, gen_diag=pj.gen_diag)
    stx = tstep(pt.engine.rhs, sj.dt, "IMR", 4, solver, gen_diag=pt.gen_diag)
    want = np.asarray(sjx(jnp.asarray(x), jnp.asarray(c)))
    got = stx(torch.as_tensor(x), torch.as_tensor(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


# ----------------------------------------------------------------------
# 3. the objective
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_guarded_f64():
    sj = guarded_setup(dtype=jnp.complex128)
    x = _params(sj.nparams)
    return sj, x, _vg(JProblem(sj), x, True)


@pytest.mark.parametrize("port_kw,form", [
    (dict(fused_rho="rho"), "rho"), (dict(fused_rho="auto"), "rho"),
    (dict(fused_rho="superop"), "superop"), (dict(fused=False), None)])
def test_guarded_f64_matches_jax_scan(jax_guarded_f64, port_kw, form):
    sj, x, want = jax_guarded_f64
    pt = TProblem(port_setup(sj, **port_kw), device="cpu")
    assert pt.fused_form == form and pt.linsolver == "jacobi"
    got = _vg(pt, x, False)
    _assert_vg(got, want, 1e-10, 1e-9, AUX_RTOL)
    assert want[1]["obj_penal"] > 0     # the leakage penalty is in play


def test_guarded_f32_rho_route_matches_jax_pallas_rho():
    pj = _open_problem(pallas=True, pallas_rho="rho")
    assert pj.use_pallas and pj.pallas_form == "rho"
    pt = TProblem(port_setup(pj.setup), device="cpu")
    assert pt.fused_form == "rho" and pt.rdtype == torch.float32
    x = _params(pj.setup.nparams).astype(np.float32)
    got, want = _vg(pt, x, False), _vg(pj, x, True)
    _assert_vg(got, want, 5e-5, 5e-4)
    assert abs(got[1]["fidelity"] - want[1]["fidelity"]) < 5e-5


@pytest.mark.parametrize("objective,target", [
    ("Jfrobenius", "pure"), ("Jmeasure", "pure"), ("Jfrobenius", "gate"),
    ("Jtrace", "pure")])
def test_objective_kinds_f64_both_routes(objective, target):
    """The other objective functions on density matrices, with the
    weighted-J window on: both routes of the port against the JAX scan."""
    kw = dict(dtype=jnp.complex128, objective_type=objective,
              penalty_param=2.0, ntime=12, dt=8.0 / 12)
    if target == "pure":
        kw.update(target_type="pure", pure_target_levels=(1, 0),
                  target_gate_full=None)
    sj = guarded_setup(**kw)
    x = _params(sj.nparams, seed=5)
    want = _vg(JProblem(sj), x, True)
    for route in ("rho", "superop"):
        pt = TProblem(port_setup(sj, fused_rho=route), device="cpu")
        _assert_vg(_vg(pt, x, False), want, 1e-10, 1e-9, AUX_RTOL)


@pytest.fixture(scope="module")
def unguarded():
    sj = unguarded_setup(dtype=jnp.complex128)
    x = _params(sj.nparams, seed=1234, scale=0.005)
    return sj, x, _vg(JProblem(sj), x, True)


@pytest.mark.parametrize("route", ["auto", "rho"])
def test_unguarded_f64_matches_jax_scan(unguarded, route):
    sj, x, want = unguarded
    pt = TProblem(port_setup(sj, fused_rho=route), device="cpu")
    assert pt.fused_form == ("superop" if route == "auto" else "rho")
    assert pt.ninit == 16 and pt.N == 4
    _assert_vg(_vg(pt, x, False), want, 1e-10, 1e-9, AUX_RTOL)


def test_unguarded_f32_superop_matches_jax_streamk_interpret(unguarded):
    _, x, _ = unguarded
    sj = unguarded_setup(pallas=True, pallas_mode="streamk")
    pj = JProblem(sj)
    assert pj.use_pallas and pj.pallas_form == "superop"
    pt = TProblem(port_setup(sj), device="cpu")
    assert pt.fused_form == "superop" and pt._x0r.shape == (16, 16)
    x = x.astype(np.float32)
    _assert_vg(_vg(pt, x, False), _vg(pj, x, True), 2e-4, 1e-3)


def test_open_ensemble_equals_single_candidates():
    sj = guarded_setup(dtype=jnp.complex128, ntime=12, dt=8.0 / 12)
    Ps = np.stack([_params(sj.nparams, seed=s) for s in (1, 2, 3)])
    for route in ("rho", "superop"):
        pt = TProblem(port_setup(sj, fused_rho=route), device="cpu")
        (J, aux), g = pt.build_ensemble_value_and_grad()(Ps, Ps[0])
        assert J.shape == (3,) and g.shape == Ps.shape
        (J1, aux1), g1 = pt.build_value_and_grad()(Ps[1], Ps[0])
        np.testing.assert_allclose(float(J[1]), float(J1), rtol=1e-13)
        np.testing.assert_allclose(g[1].numpy(), g1.numpy(), rtol=0,
                                   atol=1e-13 * float(g1.abs().max()))
        np.testing.assert_allclose(float(aux["fidelity"][1]),
                                   float(aux1["fidelity"]), rtol=1e-13)
        Jo, _ = pt.build_objective()(Ps[1], Ps[0])
        np.testing.assert_allclose(float(Jo), float(J1), rtol=1e-13)
        acc = pt.build_ensemble_sweeps()(Ps[None, :2], Ps[0])
        np.testing.assert_allclose(
            float(acc), float(J[:2].sum() + g[:2].sum()), rtol=1e-12)


# ----------------------------------------------------------------------
# 4. the optimizers
# ----------------------------------------------------------------------

def _driver_problem():
    sj = guarded_setup(dtype=jnp.complex128, ntime=16, dt=0.5)
    n = sj.nparams
    return sj, _params(n, seed=9, scale=0.02), np.full(n, -0.5), \
        np.full(n, 0.5)


def test_host_driver_open_problem_matches_jax():
    from quandary_tpu.optim.driver import run_optimization as jrun
    from quandary_tpu_torch.optim.driver import run_optimization
    sj, x0, lb, ub = _driver_problem()
    rj = jrun(JProblem(sj), x0, lb, ub, maxiter=3, verbose=False)
    rt = run_optimization(TProblem(port_setup(sj), device="cpu"), x0, lb, ub,
                          maxiter=3, verbose=False)
    fj, ft = [h.objective for h in rj.history], \
        [h.objective for h in rt.history]
    assert len(ft) == len(fj) == 4 and ft[-1] < ft[0]
    np.testing.assert_allclose(ft, fj, rtol=1e-8)
    np.testing.assert_allclose([h.fidelity for h in rt.history],
                               [h.fidelity for h in rj.history], rtol=1e-8)


@pytest.mark.parametrize("route", ["rho", "superop"])
def test_device_driver_open_problem_matches_jax(route):
    from quandary_tpu.optim.device_driver import (
        run_optimization_device as jrun)
    from quandary_tpu_torch.optim.device_driver import run_optimization_device
    sj, x0, lb, ub = _driver_problem()
    kw = dict(maxiter=3, chunk=2, gatol=1e-14, grtol=1e-30, inftol=1e-12,
              fatol=1e-14, verbose=False)
    rj = jrun(JProblem(sj), x0, lb, ub, **kw)
    pt = TProblem(port_setup(sj, fused_rho=route), device="cpu")
    rt = run_optimization_device(pt, x0, lb, ub, **kw)
    assert rt.niter == rj.niter == 3 and len(rt.history) == len(rj.history)
    assert rt.history[-1].objective < rt.history[0].objective
    for ht, hj in zip(rt.history, rj.history):
        assert ht.step == hj.step
        for c in ("objective", "fidelity", "gnorm", "penalty"):
            np.testing.assert_allclose(getattr(ht, c), getattr(hj, c),
                                       rtol=1e-8, atol=1e-13, err_msg=c)


def test_population_optimizer_runs_open_problem():
    """batched_lbfgsb through packed_batch_fns on an open problem: the best
    objective of every start is its trace's running minimum and falls."""
    from quandary_tpu_torch.optim.batched_lbfgs import batched_lbfgsb
    sj, x0, lb, ub = _driver_problem()
    pt = TProblem(port_setup(sj), device="cpu")
    x0s = torch.as_tensor(np.stack([x0, -x0]))
    xb, fb, tr = batched_lbfgsb(None, None, x0s, lb, ub, iters=3,
                                **pt.packed_batch_fns(np.zeros_like(x0)))
    tr = tr.numpy()
    assert tr.shape == (4, 2) and np.all(np.isfinite(tr))
    np.testing.assert_allclose(fb.numpy(), tr.min(axis=0), rtol=1e-12)
    assert np.all(fb.numpy() < tr[0])


# ----------------------------------------------------------------------
# 5. the gate, the refusals, the sanity check
# ----------------------------------------------------------------------

def test_route_gate_and_refusals():
    from quandary_tpu_torch.models.hamiltonian import build_standard_model
    from quandary_tpu_torch.optim import robust
    s4 = port_setup(unguarded_setup())
    s16 = port_setup(guarded_setup())
    p4, p16 = TProblem(s4, device="cpu"), TProblem(s16, device="cpu")
    assert p4.fused_form == "superop" and p4.fused_ok
    assert p16.fused_form == "rho" and p16.fused_ok
    forced = TProblem(dataclasses.replace(s16, fused_rho="superop"),
                      device="cpu")
    assert forced.fused_form == "superop" and not forced.fused_ok
    assert "shared memory" in forced.fused_refusal
    off = TProblem(dataclasses.replace(s16, fused=False), device="cpu")
    assert off.fused_form is None and not off.fused_ok
    with pytest.raises(ValueError, match="fused_rho"):
        TProblem(dataclasses.replace(s16, fused_rho="matrix"), device="cpu")
    # past one thread block of the rho kernels: N = 81
    big = build_standard_model(
        nlevels=[9, 9], freq01_ghz=[4.8, 4.9], rotfreq_ghz=[4.8, 4.9],
        selfkerr_ghz=[0.2, 0.2], jkl_ghz=[0.005], decay_time=[80.0, 90.0],
        lindblad=True)
    p81 = TProblem(dataclasses.replace(
        s16, model=big, nessential=(9, 9), initcond_type="3states",
        target_type="none", target_gate_full=None), device="cpu")
    assert p81.fused_form == "rho" and not p81.fused_ok
    assert "N = 81" in p81.fused_refusal
    with pytest.raises(NotImplementedError, match="open"):
        robust.build_packed_robust_objective([p16, p16])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TProblem(s16)


def test_open_problem_runs_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "from quandary_tpu_torch.models.hamiltonian import "
        "build_standard_model\n"
        "from quandary_tpu_torch.problem import Problem, Setup\n"
        "from quandary_tpu_torch.utils.splines import ControlSegment, "
        "OscillatorControl\n"
        "m = build_standard_model(nlevels=[3], freq01_ghz=[4.1], "
        "rotfreq_ghz=[4.1], selfkerr_ghz=[0.22], decay_time=[100.0], "
        "dephase_time=[50.0], lindblad=True)\n"
        "o = (OscillatorControl(segments=(ControlSegment('spline', "
        "nsplines=5, tstart=0.0, tstop=3.0),), carrier_freqs=(0.0,)),)\n"
        "for route in ('auto', 'rho'):\n"
        "    s = Setup(model=m, nessential=(2,), ntime=6, dt=0.5, "
        "oscillators=o, initcond_type='basis', target_type='pure', "
        "pure_target_levels=(1,), gamma_penalty=0.1, fused_rho=route)\n"
        "    p = Problem(s, device='cpu')\n"
        "    x = np.full(s.nparams, 0.01)\n"
        "    (J, aux), g = p.build_value_and_grad()(x, x)\n"
        "    print(p.fused_form, float(J), float(g.abs().max()))\n"
        "assert 'quandary_tpu' not in sys.modules\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    rows = [ln.split() for ln in out.stdout.strip().splitlines()]
    assert [r[0] for r in rows] == ["superop", "rho"]
    np.testing.assert_allclose(float(rows[0][1]), float(rows[1][1]),
                               rtol=1e-12)


def test_check_density_trajectory_matches_jax():
    from quandary_tpu.utils import sanity as jsanity
    from quandary_tpu_torch.ops import rho, solvers
    from quandary_tpu_torch.utils import sanity as tsanity
    sj = guarded_setup(dtype=jnp.complex128, ntime=12, dt=8.0 / 12)
    pt = TProblem(port_setup(sj), device="cpu")
    x = torch.as_tensor(_params(sj.nparams))
    C = pt.coeff_rows_mid(x)[None, :, 0, :]
    with torch.no_grad():
        _, _, hr, hi = rho.rho_propagate(pt._plan, pt._x0r, pt._x0i, C)
    hist = (hr[0] + 1j * hi[0]).numpy()
    # the truncated stage solve (4 iterations) keeps the trace to ~1e-6
    got, want = tsanity.check_density_trajectory(hist, tol=1e-4), \
        jsanity.check_density_trajectory(hist, tol=1e-4)
    assert got == want and got["ok"] and got["hermiticity"] < 1e-12
    assert not tsanity.check_density_trajectory(hist, tol=1e-12)["ok"]
    bad = hist.copy()
    bad[3, 1, 0, 1] += 1e-3
    got, want = tsanity.check_density_trajectory(bad, tol=1e-4), \
        jsanity.check_density_trajectory(bad, tol=1e-4)
    assert got == want and not got["ok"]
    # the populations of the final states sum to the trace
    pop = solvers.population_full(torch.as_tensor(hist[-1]), True)
    np.testing.assert_allclose(pop.sum(-1).numpy(), 1.0, atol=1e-10)
