"""quandary_tpu_torch host model layer against quandary_tpu: the numpy
arrays both packages build for the same configuration are bit-equal.

Also home of the parity helpers the other tests/test_torch_*.py files
import: the CNOT flagship builder of bench.py:59-93 (T and ntime cut for
the CPU) and the conversion of a JAX Setup to the port's plain-data form."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

FREQ01 = [4.80595, 4.8601]
SELFKERR = [0.2198, 0.2252]


def flagship_setup(pkg, T=4.0, ntime=24, **setup_kw):
    """The bench.py:59-93 CNOT flagship built with `pkg`'s own builders
    ('jax' -> quandary_tpu, 'torch' -> quandary_tpu_torch): 2 transmons with
    2 essential + 2 guard levels (N = 16), 4 basis states, Jtrace with
    leakage, energy, dpdm and Tikhonov terms, 3 carriers per oscillator."""
    if pkg == "jax":
        from quandary_tpu.models import gates
        from quandary_tpu.models.hamiltonian import build_standard_model
        from quandary_tpu.problem import Setup
        from quandary_tpu.utils.splines import ControlSegment, OscillatorControl
        dtype = jnp.complex64
    else:
        from quandary_tpu_torch.models import gates
        from quandary_tpu_torch.models.hamiltonian import build_standard_model
        from quandary_tpu_torch.problem import Setup
        from quandary_tpu_torch.utils.splines import (ControlSegment,
                                                      OscillatorControl)
        dtype = torch.complex64
    Ne, Ng = [2, 2], [2, 2]
    nlevels = [e + g for e, g in zip(Ne, Ng)]
    model = build_standard_model(
        nlevels=nlevels, freq01_ghz=FREQ01, rotfreq_ghz=FREQ01,
        selfkerr_ghz=SELFKERR, jkl_ghz=[0.005], crosskerr_ghz=[])
    oscs = tuple(
        OscillatorControl(
            segments=(ControlSegment("spline", nsplines=30, tstart=0.0,
                                     tstop=T),),
            carrier_freqs=(0.0, 2 * np.pi * (FREQ01[1 - k] - FREQ01[k]),
                           -2 * np.pi * SELFKERR[k]))
        for k in range(2))
    V = gates.assemble_gate(gates.cnot(), nlevels, Ne, [0.0, 0.0], T)
    kw = dict(
        model=model, nessential=tuple(Ne), ntime=ntime, dt=T / ntime,
        oscillators=oscs,
        ground_freqs_radns=tuple(2 * np.pi * f for f in FREQ01),
        initcond_type="basis", target_type="gate", target_gate_full=V,
        objective_type="Jtrace", gamma_tik=1e-4, gamma_penalty=0.1,
        gamma_penalty_energy=0.1, gamma_penalty_dpdm=0.01,
        dtype=dtype, linsolve_iters=3, linsolver="split")
    if pkg != "jax":
        kw["fused"] = True      # the fused route (its plain version on the CPU)
    kw.update(setup_kw)
    return Setup(**kw)


def qudit_setup(pkg, **setup_kw):
    """A guarded single qudit (3 levels, 2 essential) with a pure target."""
    if pkg == "jax":
        from quandary_tpu.models.hamiltonian import build_standard_model
        from quandary_tpu.problem import Setup
        from quandary_tpu.utils.splines import ControlSegment, OscillatorControl
        dtype = jnp.complex128
    else:
        from quandary_tpu_torch.models.hamiltonian import build_standard_model
        from quandary_tpu_torch.problem import Setup
        from quandary_tpu_torch.utils.splines import (ControlSegment,
                                                      OscillatorControl)
        dtype = torch.complex128
    T = 3.0
    model = build_standard_model(
        nlevels=[3], freq01_ghz=[4.1], rotfreq_ghz=[4.1],
        selfkerr_ghz=[0.22], crosskerr_ghz=[], jkl_ghz=[])
    oscs = (OscillatorControl(
        segments=(ControlSegment("spline", nsplines=5, tstart=0.0, tstop=T),),
        carrier_freqs=(0.0, -2 * np.pi * 0.22)),)
    kw = dict(model=model, nessential=(2,), ntime=10, dt=T / 10,
              oscillators=oscs, ground_freqs_radns=(4.1 * 2 * np.pi,),
              initcond_type="basis", target_type="pure",
              pure_target_levels=(1,), objective_type="Jtrace",
              gamma_tik=1e-4, gamma_penalty=0.1, dtype=dtype,
              linsolve_iters=6, linsolver="neumann")
    if pkg != "jax":
        kw["fused"] = True      # the fused route (its plain version on the CPU)
    kw.update(setup_kw)
    return Setup(**kw)


def arrays_from_jax_setup(setup):
    """The plain-data dict of a quandary_tpu Setup that
    quandary_tpu_torch.convert.setup_from_arrays takes. Fields that only
    schedule the JAX package's work (pallas, engine, adjoint, ...) are
    dropped; the route gate of open systems, pallas_rho, and the kernel
    family, pallas_mode, carry across under the port's names fused_rho and
    fused_mode, and the time-parallel scan's time_parallel and
    time_parallel_budget under their own."""
    from quandary_tpu_torch.problem import Setup as TorchSetup
    port_fields = {f.name for f in dataclasses.fields(TorchSetup)}
    d = {}
    for f in dataclasses.fields(setup):
        v = getattr(setup, f.name)
        if f.name == "model" and not hasattr(v, "stack"):
            d["structured"] = dataclasses.asdict(v)   # a StructuredModel
        elif f.name == "model":
            d.update(stack=np.asarray(v.stack), etas=np.asarray(v.etas),
                     dims=tuple(v.dims), n_osc=v.n_osc,
                     collapse_ops=tuple(v.collapse_ops), lindblad=v.lindblad)
        elif f.name == "oscillators":
            d["oscillators"] = [
                dict(segments=[dataclasses.asdict(s) for s in o.segments],
                     carrier_freqs=list(o.carrier_freqs),
                     enforce_bc=o.enforce_bc) for o in v]
        elif f.name == "dtype":
            d["dtype"] = np.dtype(v).name
        elif f.name == "pallas_rho":    # the open-system route gate
            d["fused_rho"] = v
        elif f.name == "pallas_mode":   # the fused kernel family
            d["fused_mode"] = v
        elif f.name in ("adjoint", "engine"):
            continue    # the JAX package's own schedule; the port: 'auto'
        elif f.name in port_fields:
            d[f.name] = v
    return d


def port_setup(jax_setup, **overrides):
    """The port's Setup of a JAX Setup, on the fused route (fused=True: the
    parity tests hold the fused route's plain version on the CPU against
    the JAX package) unless `overrides` say otherwise."""
    from quandary_tpu_torch.convert import setup_from_arrays
    return dataclasses.replace(
        setup_from_arrays(arrays_from_jax_setup(jax_setup)),
        **{"fused": True, **overrides})


def _bit_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("builder", [flagship_setup, qudit_setup])
def test_host_arrays_bit_equal(builder):
    """Model stack, etas, the generator diagonal, x0, the target, the
    control plans and the bounds: identical bits in both packages."""
    from quandary_tpu.ops.rhs import DenseEngine as JEngine
    from quandary_tpu.optim.driver import build_bounds as jbounds
    from quandary_tpu.problem import Problem as JProblem
    from quandary_tpu_torch.ops.rhs import DenseEngine as TEngine
    from quandary_tpu_torch.optim.driver import build_bounds as tbounds
    from quandary_tpu_torch.problem import Problem as TProblem

    sj, st = builder("jax"), builder("torch")
    _bit_equal(sj.model.stack, st.model.stack)
    _bit_equal(sj.model.etas, st.model.etas)
    assert sj.model.dims == st.model.dims
    for name in ("target_gate_full",):
        if getattr(sj, name) is not None:
            _bit_equal(getattr(sj, name), getattr(st, name))
    je = JEngine(sj.model, dtype=sj.dtype)
    te = TEngine(st.model, st.dtype, "cpu")
    _bit_equal(je.gen_diag(), te.gen_diag())

    pj, pt = JProblem(sj), TProblem(st, device="cpu")
    _bit_equal(pj.x0, pt.x0)
    if pj.target is not None:
        _bit_equal(pj.target, pt.target)
    assert pj.pure_target_id == pt.pure_target_id
    _bit_equal(pj.weights, pt.weights)
    _bit_equal(pj.purity, pt.purity)
    _bit_equal(pj.guard_mask, pt.guard_mask)
    assert pj.linsolver == pt.linsolver
    for plan in ("plan_mid", "plan_stop"):
        a, b = getattr(pj, plan), getattr(pt, plan)
        _bit_equal(a.ts, b.ts)
        _bit_equal(a.param_offsets, b.param_offsets)
        for k in range(len(a.basis)):
            _bit_equal(a.cos_t[k], b.cos_t[k])
            _bit_equal(a.sin_t[k], b.sin_t[k])
            for s in range(len(a.basis[k])):
                _bit_equal(a.basis[k][s], b.basis[k][s])
    bounds = [[0.045]] * len(sj.oscillators)
    for x, y in zip(jbounds(sj.oscillators, bounds),
                    tbounds(st.oscillators, bounds)):
        _bit_equal(x, y)


def test_convert_roundtrips_jax_setup():
    """setup_from_arrays on the dict of a JAX Setup rebuilds the same
    problem: stack, oscillators, gate and scalars."""
    sj = flagship_setup("jax")
    st = port_setup(sj)
    _bit_equal(sj.model.stack, st.model.stack)
    assert st.oscillators == flagship_setup("torch").oscillators
    assert st.dtype == torch.complex64 and st.nparams == sj.nparams
    for name in ("ntime", "dt", "linsolver", "linsolve_iters", "gamma_tik",
                 "gamma_penalty", "gamma_penalty_dpdm",
                 "gamma_penalty_energy", "nessential"):
        assert getattr(st, name) == getattr(sj, name), name


def test_coeff_rows_match_f64():
    """Controls -> coefficient rows (K = 7 with the JC cos/sin columns),
    single and batched, against the JAX package in f64."""
    from quandary_tpu.problem import Problem as JProblem
    from quandary_tpu_torch.problem import Problem as TProblem

    sj = flagship_setup("jax", dtype=jnp.complex128)
    pj, pt = JProblem(sj), TProblem(port_setup(sj), device="cpu")
    assert pt.model.K == 7
    rng = np.random.default_rng(3)
    Ps = rng.normal(size=(2, sj.nparams)) * 0.02
    for params in Ps:
        cj = np.asarray(pj.coeff_rows_mid(jnp.asarray(params)))
        ct = pt.coeff_rows_mid(torch.as_tensor(params)).numpy()
        np.testing.assert_allclose(ct, cj, rtol=1e-13, atol=1e-15)
    cb = pt.coeff_rows_mid(torch.as_tensor(Ps)).numpy()
    np.testing.assert_allclose(
        cb[1], np.asarray(pj.coeff_rows_mid(jnp.asarray(Ps[1]))),
        rtol=1e-13, atol=1e-15)
