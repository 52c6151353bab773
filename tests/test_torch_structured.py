"""The structured engines of a StructuredModel (ops/tensor_rhs.py,
ops/grouped_lindblad.py) and the reversible adjoint (ops/reversible.py)
through quandary_tpu_torch against quandary_tpu, at small sizes.

1. build_structured_model: the same fields in the same order;
2. TensorEngine rhs (1e-12 of max) and gen_diag (bit-equal), closed and
   open, at nlevels [3, 2, 4], with and without a leading candidate axis;
   GroupedLindbladEngine rhs at [3, 3] and [2, 2, 2] (1e-12 of max);
3. Problem J (1e-10 relative) and gradient (1e-9 of max) in f64 for the
   tensor engine, closed under 'auto' (the reversible adjoint),
   'reversible-ad' and 'remat', and open (tensor and grouped Lindblad),
   with the leakage and weighted-J penalties on; in f32 against the JAX
   Problem in complex64: J within 5e-8 relative and the gradient within
   1e-6 of max (measured 6e-10 / 1.2e-7 closed, 1e-8 / 1.2e-7 open);
4. setup_from_arrays with a `structured` dict builds the same problem in
   both packages; the front end past N = 1024 (tests/test_torch_frontend_io
   and tests/test_torch_cli hold the config files and refusals).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from quandary_tpu.ops import tensor_rhs as jtr  # noqa: E402
from quandary_tpu.problem import Problem as JProblem  # noqa: E402
from quandary_tpu.problem import Setup as JSetup  # noqa: E402
from quandary_tpu.utils.splines import (ControlSegment,  # noqa: E402
                                        OscillatorControl)
from quandary_tpu_torch.ops import tensor_rhs as ttr  # noqa: E402
from quandary_tpu_torch.problem import Problem as TProblem  # noqa: E402
from test_torch_model import port_setup  # noqa: E402


def model_kw(nlevels, lindblad, jkl=0.01):
    Q = len(nlevels)
    npair = Q * (Q - 1) // 2
    return dict(nlevels=nlevels,
                freq01_ghz=[4.1 + 0.1 * k for k in range(Q)],
                rotfreq_ghz=[4.05 + 0.1 * k for k in range(Q)],
                selfkerr_ghz=[0.2] * Q, crosskerr_ghz=[0.003] * npair,
                jkl_ghz=[jkl] * npair,
                decay_time=[30.0 + 5 * k for k in range(Q)] if lindblad
                else (),
                dephase_time=[20.0 + 3 * k for k in range(Q)] if lindblad
                else (), lindblad=lindblad)


def structured_setup(nlevels, nessential, lindblad, dtype=jnp.complex128,
                     ntime=10, T=1.0, iters=8, **kw):
    """A JAX Setup on a StructuredModel (the 4-oscillator construction of
    __graft_entry__._build_grouped_problem, any nlevels), with the leakage
    and weighted-J penalties on: basis state 0, a pure target."""
    Q = len(nlevels)
    freqs = [4.1 + 0.1 * k for k in range(Q)]
    model = jtr.build_structured_model(
        nlevels=nlevels, freq01_ghz=freqs, rotfreq_ghz=freqs,
        selfkerr_ghz=[0.2] * Q, crosskerr_ghz=[0.001] * (Q * (Q - 1) // 2),
        jkl_ghz=[0.001] * (Q * (Q - 1) // 2),
        decay_time=[30.0] * Q if lindblad else (),
        dephase_time=[20.0] * Q if lindblad else (), lindblad=lindblad)
    oscs = tuple(OscillatorControl(
        segments=(ControlSegment("spline", nsplines=5, tstart=0.0, tstop=T),),
        carrier_freqs=(0.0, -0.2 * 2 * np.pi)) for _ in range(Q))
    return JSetup(model=model, nessential=tuple(nessential), ntime=ntime,
                  dt=T / ntime, oscillators=oscs,
                  ground_freqs_radns=tuple(2 * np.pi * f for f in freqs),
                  initcond_type="basis", initcond_ids=(0,),
                  target_type="pure", pure_target_levels=(0,) * Q,
                  objective_type="Jtrace", gamma_tik=1e-4, dtype=dtype,
                  linsolve_iters=iters, gamma_penalty=0.05,
                  penalty_param=0.1, **kw)


def params(n, seed=3):
    return np.random.default_rng(seed).normal(size=n) * 0.03


def jax_vg(sj, x):
    (J, _), g = JProblem(sj).build_value_and_grad()(jnp.asarray(x),
                                                    jnp.asarray(x))
    return float(J), np.asarray(g, np.float64)


def port_problem(sj, **over):
    return TProblem(port_setup(sj, fused="auto", engine=sj.engine,
                               adjoint=sj.adjoint, **over), device="cpu")


def assert_vg(pt, x, Jj, gj, rtol_J, rtol_g):
    (J, _), g = pt.build_value_and_grad()(x, x)
    g = g.double().numpy()
    assert abs(float(J) - Jj) <= rtol_J * abs(Jj)
    assert np.abs(g - gj).max() <= rtol_g * np.abs(gj).max()


def test_build_structured_model_fields():
    for lind in (False, True):
        kw = model_kw([3, 2, 4], lind)
        mj = jtr.build_structured_model(**kw)
        mt = ttr.build_structured_model(**kw)
        assert [f.name for f in dataclasses.fields(mj)] == \
            [f.name for f in dataclasses.fields(mt)]
        assert dataclasses.asdict(mj) == dataclasses.asdict(mt)
        assert (mt.N, mt.K, mt.n_jc) == (mj.N, mj.K, mj.n_jc)
        ts = np.linspace(0.0, 3.0, 7)
        p = np.random.default_rng(1).normal(size=(7, 3))
        q = np.random.default_rng(2).normal(size=(7, 3))
        Cj = np.asarray(mj.coeff_rows(jnp.asarray(p), jnp.asarray(q), ts))
        Ct = mt.coeff_rows(torch.as_tensor(p), torch.as_tensor(q), ts)
        np.testing.assert_array_equal(Ct.numpy(), Cj)


@pytest.mark.parametrize("lindblad", [False, True])
def test_tensor_engine_rhs_and_gen_diag(lindblad):
    kw = model_kw([3, 2, 4], lindblad)
    ej = jtr.TensorEngine(jtr.build_structured_model(**kw), jnp.complex128)
    et = ttr.TensorEngine(ttr.build_structured_model(**kw), torch.complex128,
                          "cpu")
    np.testing.assert_array_equal(et.gen_diag(), ej.gen_diag())
    rng = np.random.default_rng(0)
    N, K = et.N, et.model.K
    shape = (2, 3) + ((N, N) if lindblad else (N,))
    x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    C = rng.normal(size=(2, K))
    got = et.rhs(torch.as_tensor(C), torch.as_tensor(x)).numpy()
    for e in range(2):       # a leading candidate axis with its own rows
        want = np.asarray(ej.rhs(jnp.asarray(C[e]), jnp.asarray(x[e])))
        assert np.abs(got[e] - want).max() <= 1e-12 * np.abs(want).max()
    one = et.rhs(torch.as_tensor(C[0]), torch.as_tensor(x[0])).numpy()
    np.testing.assert_allclose(one, got[0], rtol=0, atol=1e-13)


@pytest.mark.parametrize("nlevels", [[3, 3], [2, 2, 2]])
def test_grouped_lindblad_rhs(nlevels):
    from quandary_tpu.ops.grouped_lindblad import GroupedLindbladEngine as J
    from quandary_tpu_torch.ops.grouped_lindblad import \
        GroupedLindbladEngine as T
    kw = model_kw(nlevels, True)
    ej = J(jtr.build_structured_model(**kw), jnp.complex128)
    et = T(ttr.build_structured_model(**kw), torch.complex128, "cpu")
    assert (et.m1, et.m2, et.split) == (ej.m1, ej.m2, ej.split)
    np.testing.assert_array_equal(et.gen_diag(), ej.gen_diag())
    rng = np.random.default_rng(4)
    N = et.N
    x = rng.normal(size=(2, N, N)) + 1j * rng.normal(size=(2, N, N))
    c = rng.normal(size=et.K)
    want = np.asarray(ej.rhs(jnp.asarray(c), jnp.asarray(x)))
    got = et.rhs(torch.as_tensor(c), torch.as_tensor(x)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


# (nlevels, nessential, lindblad, engine, port adjoints held to the JAX
# Problem's 'auto', dtype)
CASES = [
    ([3, 2, 4], [2, 2, 2], False, "tensor",
     ("auto", "reversible-ad", "remat"), jnp.complex128),
    ([3, 3], [2, 2], True, "tensor", ("auto",), jnp.complex128),
    ([3, 3], [2, 2], True, "grouped", ("auto", "reversible"), jnp.complex128),
    ([2, 2, 2], [2, 2, 1], True, "grouped", ("auto",), jnp.complex128),
    ([3, 2, 4], [2, 2, 2], False, "tensor", ("auto",), jnp.complex64),
    ([3, 3], [2, 2], True, "grouped", ("auto",), jnp.complex64),
]


@pytest.mark.parametrize("nlevels,ness,lind,engine,adjoints,dtype", CASES)
def test_problem_matches_jax(nlevels, ness, lind, engine, adjoints, dtype):
    sj = structured_setup(nlevels, ness, lind, dtype=dtype, engine=engine)
    x = params(sj.nparams)
    Jj, gj = jax_vg(sj, x)
    f64 = dtype == jnp.complex128
    routes = {"auto": "stored" if lind else "reversible",
              "reversible": "stored" if lind else "reversible",
              "reversible-ad": "reversible", "remat": "stored"}
    for adj in adjoints:
        pt = port_problem(dataclasses.replace(sj, adjoint=adj))
        want = {("tensor", False): "TensorEngine",
                ("tensor", True): "TensorEngine",
                ("grouped", True): "GroupedLindbladEngine"}[engine, lind]
        assert type(pt.engine).__name__ == want
        assert pt.adjoint_route == routes[adj] and not pt.use_fused
        assert pt.linsolver == JProblem(sj).linsolver
        assert_vg(pt, x, Jj, gj, 1e-10 if f64 else 5e-8,
                  1e-9 if f64 else 1e-6)


def test_setup_from_arrays_structured():
    """The structured dict carries the model across: same fields, same
    engine choice under 'auto', the same objective."""
    from quandary_tpu_torch.convert import setup_from_arrays
    sj = structured_setup([3, 2, 4], [2, 2, 2], False)
    d = dict(structured=dataclasses.asdict(sj.model), dtype="complex128",
             nessential=sj.nessential, ntime=sj.ntime, dt=sj.dt,
             oscillators=[dict(segments=[dataclasses.asdict(s)
                                         for s in o.segments],
                               carrier_freqs=list(o.carrier_freqs))
                          for o in sj.oscillators],
             ground_freqs_radns=sj.ground_freqs_radns,
             initcond_type="basis", initcond_ids=(0,), target_type="pure",
             pure_target_levels=(0, 0, 0), gamma_tik=1e-4,
             linsolve_iters=8, gamma_penalty=0.05, penalty_param=0.1)
    st = setup_from_arrays(d)
    assert isinstance(st.model, ttr.StructuredModel)
    assert dataclasses.asdict(st.model) == dataclasses.asdict(sj.model)
    pt, pj = TProblem(st, device="cpu"), JProblem(sj)
    assert type(pt.engine).__name__ == type(pj.engine).__name__
    x = params(sj.nparams, seed=8)
    Jj, gj = jax_vg(sj, x)
    assert_vg(pt, x, Jj, gj, 1e-10, 1e-9)


def test_structured_refuses_fused_and_names_why():
    """The kernels take the dense stack: fused=True raises, 'auto' runs the
    plain loop and says why."""
    sj = structured_setup([3, 2, 4], [2, 2, 2], False, dtype=jnp.complex64)
    with pytest.raises(NotImplementedError, match="TensorEngine"):
        TProblem(port_setup(sj, fused=True), device="cpu")
    pt = port_problem(sj)
    assert not pt.use_fused and "dense operator stack" in pt.fused_refusal
