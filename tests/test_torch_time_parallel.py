"""quandary_tpu_torch's time-parallel scan (ops/propagator.py and its path
through Problem) against quandary_tpu's, in f64 on the CPU:

1. tests/test_time_parallel.py's three cases (closed with penalty_param 0
   and 0.5, open with T1/T2), every penalty on: the port's scan against the
   JAX scan (J and every aux term to 1e-12 abs, the gradient to 1e-10 x
   max, the trajectory to 1e-12) and against the port's own sequential
   loop (the reference test's bounds: 1e-10; rtol 1e-7 / atol 1e-12;
   1e-10);
2. the matrix-form Jacobi recursion (tests/test_jacobi_solver.py:111): J
   within 1e-9 of the sequential Jacobi loop, and to 1e-12 of the JAX scan;
3. prefix_propagators against jax.lax.associative_scan on random stacks,
   lindblad_superop_builder against the JAX builder with jump operators;
4. an ensemble gradient (E = 3) against three single calls;
5. Problem.time_parallel against the JAX Problem's decision (pallas off)
   on config_template.cfg, the split flagship, an open N = 6 system and a
   closed dim past 64 with few initial states.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from quandary_tpu.problem import Problem as JProblem  # noqa: E402
from quandary_tpu_torch.ops import propagator  # noqa: E402
from quandary_tpu_torch.problem import Problem as TProblem  # noqa: E402
from test_time_parallel import _setup as tp_setup  # noqa: E402
from test_torch_model import port_setup  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(sj, **kw):
    return TProblem(port_setup(sj, fused="auto", **kw), device="cpu")


@pytest.mark.parametrize("lindblad,penalty_param", [
    (False, 0.0), (False, 0.5), (True, 0.0),
])
def test_scan_matches_jax_and_sequential(lindblad, penalty_param):
    sj = dataclasses.replace(tp_setup(lindblad, penalty_param=penalty_param),
                             time_parallel=True)
    pj = JProblem(sj)
    pt, ps = _port(sj), _port(sj, time_parallel=False)
    assert pj.time_parallel and pt.time_parallel and not ps.time_parallel
    assert pt.adjoint_route == "stored" and pt._reversible is None

    x = np.random.default_rng(11).normal(size=sj.nparams) * 0.01
    (Jj, aj), gj = jax.value_and_grad(pj.objective, has_aux=True)(
        jnp.asarray(x), jnp.asarray(x))
    gj = np.asarray(gj)
    (Jt, at), gt = pt.build_value_and_grad()(x, x)
    (Js, as_), gs = ps.build_value_and_grad()(x, x)
    assert abs(float(Jt) - float(Jj)) < 1e-12
    for k in aj:
        assert abs(float(at[k]) - float(aj[k])) < 1e-12, k
        assert abs(float(at[k]) - float(as_[k])) < 1e-10, k
    assert abs(float(Jt) - float(Js)) < 1e-10
    assert np.abs(gt.numpy() - gj).max() <= 1e-10 * np.abs(gj).max()
    np.testing.assert_allclose(gt.numpy(), gs.numpy(), rtol=1e-7, atol=1e-12)

    tj = np.asarray(pj.propagate_trajectory(jnp.asarray(x)))
    tt = pt.build_propagate_trajectory()(x).numpy()
    ts = ps.build_propagate_trajectory()(x).numpy()
    assert tt.shape == tj.shape == ts.shape
    assert np.abs(tt - tj).max() < 1e-12
    assert np.abs(tt - ts).max() < 1e-10
    assert np.abs(pt.build_propagate_final()(x).numpy() - tj[-1]).max() \
        < 1e-12


def test_jacobi_scan_matches_sequential():
    """The matrix Jacobi recursion against the sequential Jacobi loop on
    the flagship of bench.py at 60 steps (tests/test_jacobi_solver.py:111),
    with the stiffness guard's jacobi on both."""
    from bench import build_problem
    _, s0 = build_problem(pallas=False)
    sj = dataclasses.replace(s0, ntime=60, dtype=jnp.complex128,
                             time_parallel=True)
    pj = JProblem(sj)
    pt, ps = _port(sj), _port(sj, time_parallel=False)
    assert pt.time_parallel and not ps.time_parallel
    assert pt.linsolver == ps.linsolver == pj.linsolver == "jacobi"
    x = np.random.default_rng(7).uniform(-1, 1, sj.nparams) * 0.01
    Jj, _ = pj.objective(jnp.asarray(x), jnp.asarray(x))
    Jt, _ = pt.build_objective()(x, x)
    Js, _ = ps.build_objective()(x, x)
    assert abs(float(Jt) - float(Js)) < 1e-9, (float(Jt), float(Js))
    assert abs(float(Jt) - float(Jj)) < 1e-12


@pytest.mark.parametrize("T", [1, 2, 3, 7, 8, 100])
def test_prefix_propagators_match_associative_scan(T):
    from quandary_tpu.ops.propagator import prefix_propagators as jprefix
    rng = np.random.default_rng(T)
    S = rng.normal(size=(T, 5, 5)) + 1j * rng.normal(size=(T, 5, 5))
    want = np.asarray(jprefix(jnp.asarray(S)))
    got = propagator.prefix_propagators(torch.as_tensor(S)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
    # a leading candidate axis scans each candidate's stack alone
    S2 = S[::-1].copy()
    both = propagator.prefix_propagators(torch.as_tensor(np.stack([S, S2])))
    want2 = np.asarray(jprefix(jnp.asarray(S2)))
    assert np.abs(both[0].numpy() - want).max() <= 1e-13 * np.abs(want).max()
    assert np.abs(both[1].numpy() - want2).max() \
        <= 1e-13 * np.abs(want2).max()


def test_lindblad_superop_builder_matches_jax():
    from quandary_tpu.ops.propagator import lindblad_superop_builder as jb
    rng = np.random.default_rng(3)
    K, N = 4, 3
    stack = rng.normal(size=(K, N, N)) + 1j * rng.normal(size=(K, N, N))
    Ls = rng.normal(size=(2, N, N)) + 1j * rng.normal(size=(2, N, N))
    C = rng.normal(size=(5, K))
    for L in (Ls, None):
        want = np.asarray(jb(jnp.asarray(stack), L)(jnp.asarray(C)))
        got = propagator.lindblad_superop_builder(
            torch.as_tensor(stack),
            None if L is None else torch.as_tensor(L))(torch.as_tensor(C))
        assert got.shape == (5, N * N, N * N)
        assert np.abs(got.numpy() - want).max() <= 1e-14 * np.abs(want).max()


def test_ensemble_gradient_matches_single_calls():
    sj = tp_setup(False, penalty_param=0.5)
    pt = _port(sj)
    assert pt.time_parallel
    Ps = np.random.default_rng(5).normal(size=(3, sj.nparams)) * 0.01
    ref = Ps[0]
    (J, aux), g = pt.build_ensemble_value_and_grad()(Ps, ref)
    assert J.shape == (3,) and g.shape == (3, sj.nparams)
    vg = pt.build_value_and_grad()
    for e in range(3):
        (Je, auxe), ge = vg(Ps[e], ref)
        assert abs(float(J[e]) - float(Je)) <= 1e-14
        assert abs(float(aux["fidelity"][e]) - float(auxe["fidelity"])) \
            <= 1e-14
        assert (g[e] - ge).abs().max() <= 1e-12 * ge.abs().max()


def _config_template_setups(tmp_path):
    from quandary_tpu.io.configfile import Config as JConfig
    from quandary_tpu.io.configfile import setup_from_config as jsetup
    from quandary_tpu_torch.io.configfile import Config as TConfig
    from quandary_tpu_torch.io.configfile import setup_from_config as tsetup
    path = os.path.join(ROOT, "config_template.cfg")
    return (jsetup(JConfig.read(path), str(tmp_path))[0],
            tsetup(TConfig.read(path), str(tmp_path))[0])


def _wide_closed():
    """tests/test_time_parallel.py's closed system with 7 guard levels per
    qubit: N = 81 past 64, and 4 basis states (4 x 4 < 81)."""
    s = tp_setup(False)
    from quandary_tpu.models.hamiltonian import build_standard_model
    model = build_standard_model(
        nlevels=[9, 9], freq01_ghz=[4.8, 5.1], rotfreq_ghz=[4.79, 5.09],
        selfkerr_ghz=[0.22, 0.25], crosskerr_ghz=[0.01], jkl_ghz=[0.005])
    from quandary_tpu.models import gates
    V = gates.assemble_gate(gates.cnot(), [9, 9], [2, 2], [0.0, 0.0],
                            s.total_time)
    return dataclasses.replace(s, model=model, target_gate_full=V)


@pytest.mark.parametrize("case,want", [
    ("config_template", True), ("flagship_split", False),
    ("open6", True), ("closed81", False),
])
def test_decision_matches_jax(tmp_path, case, want):
    """'auto' decides as the JAX Problem decides with pallas off."""
    if case == "config_template":
        sj, st = _config_template_setups(tmp_path)
        assert st.dtype == torch.complex128 and st.fused == "auto"
        pt = TProblem(st, device="cpu")
        assert (pt.N, pt.ninit, pt.setup.ntime, pt.linsolver) == \
            (4, 4, 1000, "neumann")
    else:
        if case == "flagship_split":
            from test_torch_model import flagship_setup
            sj = flagship_setup("jax", dtype=jnp.complex128, pallas=False)
        elif case == "open6":
            sj = tp_setup(True)
        else:
            sj = _wide_closed()
        pt = _port(sj)
    pj = JProblem(dataclasses.replace(sj, pallas=False))
    assert pj.time_parallel == pt.time_parallel == want
    if case == "open6":
        assert pt.N == 6 and pt.lindblad
    if case == "closed81":
        assert pt.N == 81 and pt.ninit == 4
        # True takes it wherever it is feasible; False never
        assert _port(dataclasses.replace(sj, time_parallel=True)).time_parallel
        assert not _port(sj, time_parallel=True,
                         time_parallel_budget=100).time_parallel
