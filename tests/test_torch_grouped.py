"""The grouped (matricized) engine of closed StructuredModels
(ops/grouped_rhs.py) and its adjoints (ops/grouped_adjoint.py, and
ops/reversible.py over the real-plane step) through quandary_tpu_torch
against quandary_tpu, at small sizes.

1. at nlevels [3, 4, 2, 3] (m1 x m2 = 12 x 6): the stacks, the cross-JC
   ladders and the cross-Kerr mask built on the device against the JAX
   engine's host build (bit-equal); apply_H_planes with a leading candidate
   axis, the complex rhs, the real Jacobi-IMR and split steps, the rotation
   planes and the control-cotangent contractions against JAX in f64
   (1e-12 of max);
2. Problem J (1e-10 relative) and gradient (1e-9 of max) in f64 against
   the JAX Problem's 'auto' (its hand-written adjoint) with the leakage
   and weighted-J penalties on: the stiff problem, which the guard turns to
   'split' as JAX does, under 'auto', 'reversible', 'reversible-ad' and
   'remat'; the unstiff one under 'jacobi' with 'auto' and
   'reversible-ad', and under 'neumann' (the same Jacobi real step on the
   grouped route, as JAX); in f32
   against JAX complex64, J within 5e-8 relative and the gradient within
   1e-6 of max (measured 8.5e-9 / 8.4e-8);
3. an E = 2 ensemble against its per-candidate gradients (1e-12).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from quandary_tpu.ops import grouped_rhs as jgr  # noqa: E402
from quandary_tpu.ops import tensor_rhs as jtr  # noqa: E402
from quandary_tpu.problem import Problem as JProblem  # noqa: E402
from quandary_tpu_torch.ops import grouped_rhs as tgr  # noqa: E402
from quandary_tpu_torch.ops import tensor_rhs as ttr  # noqa: E402
from test_torch_structured import (assert_vg, jax_vg, model_kw,  # noqa: E402
                                   params, port_problem, structured_setup)

NLEVELS = [3, 4, 2, 3]


@pytest.fixture(scope="module")
def engines():
    kw = model_kw(NLEVELS, False)
    ej = jgr.GroupedEngine(jtr.build_structured_model(**kw), jnp.complex128)
    et = tgr.GroupedEngine(ttr.build_structured_model(**kw),
                           torch.complex128, "cpu")
    return ej, et


def _close(got, want, rtol=1e-12):
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert np.abs(g - w).max() <= rtol * np.abs(w).max()


def test_device_stacks_match_host_build(engines):
    ej, et = engines
    assert (et.split, et.m1, et.m2, et.K) == (ej.split, ej.m1, ej.m2, ej.K)
    assert et.cross_idx == ej.cross_idx and et.cross_J == ej.cross_J
    for got, want in ((et.SLr, ej.stackL.real), (et.SLi, ej.stackL.imag),
                      (et.SRr, ej.stackR.real), (et.SRi, ej.stackR.imag),
                      (et.crossA, ej.crossA.real), (et.crossB, ej.crossB.real),
                      (et.cross_diag, ej.cross_diag)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(et.gen_diag(), ej.gen_diag())


def test_apply_H_planes_and_rhs(engines):
    ej, et = engines
    rng = np.random.default_rng(0)
    C = rng.normal(size=(2, et.K))
    Xr, Xi = rng.normal(size=(2, 2, et.m1, et.m2, 2)).transpose(4, 0, 1, 2, 3)
    got = et.apply_H_planes(torch.as_tensor(C), torch.as_tensor(Xr),
                            torch.as_tensor(Xi))
    for e in range(2):       # a leading candidate axis with its own rows
        want = ej.apply_H_planes(jnp.asarray(C[e]), jnp.asarray(Xr[e]),
                                 jnp.asarray(Xi[e]))
        _close([got[0][e], got[1][e]], want)
    x = Xr[0].reshape(2, -1) + 1j * Xi[0].reshape(2, -1)
    _close([et.rhs(torch.as_tensor(C[0]), torch.as_tensor(x))],
           [ej.rhs(jnp.asarray(C[0]), jnp.asarray(x))])


@pytest.mark.parametrize("step", ["make_real_imr_step",
                                  "make_real_split_step"])
def test_real_steps(engines, step):
    ej, et = engines
    rng = np.random.default_rng(1)
    c = rng.normal(size=et.K)
    Xr, Xi = rng.normal(size=(2, 2, et.m1, et.m2))
    for dt in (0.05, -0.05):
        want = getattr(jgr, step)(ej, dt, 6)(jnp.asarray(Xr), jnp.asarray(Xi),
                                             jnp.asarray(c))
        got = getattr(tgr, step)(et, dt, 6)(torch.as_tensor(Xr),
                                            torch.as_tensor(Xi),
                                            torch.as_tensor(c))
        _close(got, want)
    _close(tgr.device_rotation_planes(et, 0.025),
           jgr.device_rotation_planes(ej, 0.025))


def test_dC_contractions(engines):
    from quandary_tpu.ops.grouped_adjoint import _dC_contractions as jdc
    from quandary_tpu_torch.ops.grouped_adjoint import _dC_contractions as tdc
    ej, et = engines
    rng = np.random.default_rng(2)
    w = rng.normal(size=(4, 3, et.m1, et.m2))
    want = jdc(ej, *(jnp.asarray(a) for a in w), 0.1, None)
    got = tdc(et, *(torch.as_tensor(a) for a in w), 0.1)
    _close([got], [want])


# (linsolver, T, the Problem's linsolver, port adjoints held to JAX 'auto')
CASES = [
    ("neumann", 5.0, "split", ("auto", "reversible", "reversible-ad",
                               "remat")),
    ("jacobi", 1.0, "jacobi", ("auto", "reversible-ad")),
]


@pytest.mark.parametrize("linsolver,T,solver,adjoints", CASES)
def test_problem_matches_jax(linsolver, T, solver, adjoints):
    """The stiff problem (dt/2 max|H_diag| past the guard's bound at 8
    iterations) goes to 'split' in both packages. The unstiff one keeps
    'jacobi', and with 'neumann' runs the same Jacobi real-plane step
    on the grouped route, as JAX does."""
    sj = structured_setup([2, 3, 2, 2], [2, 2, 2, 2], False, T=T,
                          engine="grouped", linsolver=linsolver)
    assert JProblem(sj).linsolver == solver
    x = params(sj.nparams)
    Jj, gj = jax_vg(sj, x)
    routes = {"auto": "grouped", "reversible": "grouped",
              "reversible-ad": "grouped-ad", "remat": "stored"}
    for adj in adjoints:
        pt = port_problem(dataclasses.replace(sj, adjoint=adj))
        assert type(pt.engine).__name__ == "GroupedEngine"
        assert pt.linsolver == solver and pt.adjoint_route == routes[adj]
        assert_vg(pt, x, Jj, gj, 1e-10, 1e-9)
    if solver == "jacobi":
        pn = port_problem(dataclasses.replace(sj, linsolver="neumann"))
        assert pn.linsolver == "neumann" and pn.adjoint_route == "grouped"
        assert_vg(pn, x, Jj, gj, 1e-14, 1e-13)


def test_problem_f32_matches_jax():
    sj = structured_setup([2, 3, 2, 2], [2, 2, 2, 2], False, T=5.0,
                          engine="grouped", dtype=jnp.complex64)
    x = params(sj.nparams)
    Jj, gj = jax_vg(sj, x)
    pt = port_problem(sj)
    assert pt.linsolver == "split" and pt.rdtype == torch.float32
    assert_vg(pt, x, Jj, gj, 5e-8, 1e-6)


def test_ensemble_matches_per_candidate():
    sj = structured_setup([2, 3, 2, 2], [2, 2, 2, 2], False, T=5.0,
                          engine="grouped")
    pt = port_problem(sj)
    Ps = np.random.default_rng(5).normal(size=(2, sj.nparams)) * 0.03
    ref = np.zeros(sj.nparams)
    (J, _), g = pt.build_ensemble_value_and_grad()(Ps, ref)
    for e in range(2):
        (Je, _), ge = pt.build_value_and_grad()(Ps[e], ref)
        np.testing.assert_allclose(float(J[e]), float(Je), rtol=1e-12)
        assert (g[e] - ge).abs().max() <= 1e-12 * ge.abs().max()


def test_grouped_engine_is_closed_only():
    m = ttr.build_structured_model(**model_kw([2, 2], True))
    with pytest.raises(ValueError, match="Schroedinger-only"):
        tgr.GroupedEngine(m, torch.complex128, "cpu")
