"""quandary_tpu_torch.optim.robust against quandary_tpu.optim.robust on the
workloads of tests/test_robust.py: a qubit (or guarded qutrit) flipped
under one pulse by an ensemble of detuned system realizations.

1. f64: the robust gradient is the weighted sum of the per-sample
   gradients (1e-12), and J, aux and gradient equal the JAX package's.
2. f32: build_packed_robust_objective (all samples in one packed streamK
   propagation with per-candidate stacks) against the JAX packed objective
   with its kernel in interpret mode at exact-f32 'highest' precision: J
   to rtol 5e-6, every aux column, the gradient to 5e-6 x max; and against
   the port's own per-sample objective.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from quandary_tpu.ops import pallas_stream  # noqa: E402
from quandary_tpu.optim import robust as jrobust  # noqa: E402
from quandary_tpu_torch.optim import robust as trobust  # noqa: E402
from quandary_tpu_torch.problem import Problem as TProblem  # noqa: E402
from test_torch_model import port_setup  # noqa: E402


def _common(pkg, T=60.0, ntime=300, **kw):
    if pkg == "jax":
        from quandary_tpu.utils.splines import ControlSegment, OscillatorControl
    else:
        from quandary_tpu_torch.utils.splines import (ControlSegment,
                                                      OscillatorControl)
    osc = OscillatorControl(
        segments=(ControlSegment("spline", nsplines=10, tstart=0.0, tstop=T),),
        carrier_freqs=(0.0,))
    common = dict(
        nessential=(2,), ntime=ntime, dt=T / ntime, oscillators=(osc,),
        ground_freqs_radns=(1.0,),
        initcond_type="pure", pure_levels=(0,),
        target_type="pure", pure_target_levels=(1,),
        objective_type="Jtrace", gamma_tik=1e-6)
    common.update(kw)
    return common


def _base(nlevels):
    return dict(nlevels=[nlevels], freq01_ghz=[4.1], rotfreq_ghz=[4.1],
                selfkerr_ghz=[0.2])


def _detuned(deltas):
    return [{"freq01_ghz": [4.1 + d]} for d in deltas]


def _assert_aux(at, aj, rtol, atol):
    assert set(at) == set(aj)
    for k in aj:
        np.testing.assert_allclose(at[k].detach().numpy(), np.asarray(aj[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


def test_robust_gradient_is_weighted_sum_and_matches_jax():
    deltas, w = [0.0, 0.002], [0.6, 0.4]
    pj = jrobust.sample_standard_models(_base(2), _detuned(deltas),
                                        _common("jax"))
    pt = trobust.sample_standard_models(
        _base(2), _detuned(deltas), _common("torch", dtype=torch.complex128),
        device="cpu")
    x = np.random.default_rng(0).normal(size=pt[0].setup.nparams) * 0.02
    (J, aux), g = trobust.build_robust_value_and_grad(pt, w)(x, x)
    total, gsum = 0.0, np.zeros(x.shape)
    for p, ws in zip(pt, w):
        (Js, _), gs = p.build_value_and_grad()(x, x)
        total += ws * float(Js)
        gsum += ws * gs.numpy()
    assert abs(float(J) - total) < 1e-12
    np.testing.assert_allclose(g.numpy(), gsum, rtol=1e-12, atol=1e-15)
    assert aux["fidelity_per_sample"].shape == (2,)

    (Jj, auxj), gj = jax.value_and_grad(
        jrobust.build_robust_objective(pj, w), has_aux=True)(
            jnp.asarray(x), jnp.asarray(x))
    np.testing.assert_allclose(float(J), float(Jj), rtol=1e-10)
    assert np.abs(g.numpy() - np.asarray(gj)).max() \
        <= 1e-9 * np.abs(np.asarray(gj)).max()
    _assert_aux(aux, auxj, 1e-9, 1e-14)


def _packed_problems():
    """The setup of test_packed_robust_matches_per_sample: a guarded
    qutrit, three detunings, leakage and energy penalties, complex64."""
    common = _common("jax", pallas=True, pallas_mode="streamk",
                     dtype=jnp.complex64, gamma_penalty=0.05,
                     gamma_penalty_energy=0.02)
    pj = jrobust.sample_standard_models(
        _base(3), _detuned((0.0, 0.002, -0.003)), common)
    assert all(p.use_pallas for p in pj)
    # the port's problems from the JAX setups' arrays, one convert call each
    pt = [TProblem(port_setup(p.setup), device="cpu") for p in pj]
    return pj, pt


def test_packed_robust_matches_jax_packed(monkeypatch):
    monkeypatch.setattr(pallas_stream, "_PRECISION_MODE", "highest")
    pj, pt = _packed_problems()
    w = [0.5, 0.3, 0.2]
    x = (np.random.default_rng(0).normal(size=pt[0].setup.nparams)
         * 0.02).astype(np.float32)
    ref = np.zeros_like(x)
    (Jj, aj), gj = jax.jit(jax.value_and_grad(
        jrobust.build_packed_robust_objective(pj, w), has_aux=True))(
            jnp.asarray(x), jnp.asarray(ref))
    xt = torch.tensor(x, requires_grad=True)
    Jt, at = trobust.build_packed_robust_objective(pt, w)(
        xt, torch.tensor(ref))
    (gt,) = torch.autograd.grad(Jt, xt)
    assert Jt.dtype == torch.float32
    np.testing.assert_allclose(float(Jt.detach()), float(Jj), rtol=5e-6)
    gj = np.asarray(gj)
    assert np.abs(gt.numpy() - gj).max() <= 5e-6 * np.abs(gj).max()
    _assert_aux(at, aj, 1e-5, 1e-8)

    # and the port's own per-sample objective: same launches' math, S times
    (J0, a0), g0 = trobust.build_robust_value_and_grad(pt, w)(x, ref)
    np.testing.assert_allclose(float(Jt.detach()), float(J0), rtol=5e-6)
    assert float((gt - g0).abs().max()) <= 5e-6 * float(g0.abs().max())
    for k in a0:
        torch.testing.assert_close(at[k].detach(), a0[k], rtol=1e-5,
                                   atol=1e-8)


def test_packed_robust_validation():
    """The packed objective refuses samples that differ in discretization,
    initial conditions or path, as the JAX one does."""
    _, pt = _packed_problems()
    s0 = pt[0].setup
    bad = [
        dataclasses.replace(s0, ntime=s0.ntime // 2),
        dataclasses.replace(s0, linsolve_iters=s0.linsolve_iters + 1),
        dataclasses.replace(s0, pure_levels=(1,)),
        dataclasses.replace(s0, fused=False),
    ]
    for s in bad:
        with pytest.raises(ValueError):
            trobust.build_packed_robust_objective(
                [pt[0], TProblem(s, device="cpu")])


@pytest.mark.parametrize("mode", ["stream", "chunk"])
def test_packed_robust_refuses_streamed_plane_modes(mode):
    """The packed route is streamK's only: a sample on the streamed-plane
    kernels (fused_mode 'stream' or 'chunk') is refused by name, not run
    on the streamK kernels."""
    _, pt = _packed_problems()
    s = dataclasses.replace(pt[0].setup, fused_mode=mode, linsolver="neumann")
    with pytest.raises(NotImplementedError, match=f"fused_mode='{mode}'"):
        trobust.build_packed_robust_objective(
            [pt[0], TProblem(s, device="cpu")])
