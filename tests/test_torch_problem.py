"""The CNOT flagship objective and gradient (bench.py:59-93, cut to T = 4 ns
and ntime = 24) through quandary_tpu_torch against quandary_tpu.

1. f64: the port (streamK path in plain torch, and the plain complex time
   loop) against JAX Problem(pallas=False, complex128), split stepper with
   3 iterations — the same algebra (steppers.py:184-191,
   pallas_stream.py:217-255), so J to rtol 1e-10 and the gradient to
   1e-9 x max.
2. f32: the port against JAX Problem(pallas=True) with the streamK kernel
   in interpret mode at its shipping 'high' precision: J to rtol 2e-4, the
   gradient to 1e-3 x max (test_problem_parity_at_default_high_precision).
3. The ensemble value_and_grad at E = 3 against JAX's, with the bounds of 2.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from quandary_tpu.problem import Problem as JProblem  # noqa: E402
from quandary_tpu_torch.problem import Problem as TProblem  # noqa: E402
from test_torch_model import flagship_setup, port_setup  # noqa: E402


def _params(n, E=None, seed=1234):
    rng = np.random.default_rng(seed)
    shape = (n,) if E is None else (E, n)
    return rng.uniform(-1, 1, shape) * 0.02


def _assert_vg(Jt, gt, Jj, gj, rtol_J, rtol_g):
    Jt, gt = np.asarray(Jt, np.float64), np.asarray(gt, np.float64)
    Jj, gj = np.asarray(Jj, np.float64), np.asarray(gj, np.float64)
    np.testing.assert_allclose(Jt, Jj, rtol=rtol_J, atol=0)
    assert np.abs(gt - gj).max() <= rtol_g * np.abs(gj).max()


@pytest.mark.parametrize("fused", [True, False])
def test_flagship_f64_matches_jax_scan(fused):
    sj = flagship_setup("jax", dtype=jnp.complex128, pallas=False)
    pj = JProblem(sj)
    assert not pj.use_pallas and pj.linsolver == "split"
    pt = TProblem(port_setup(sj, fused=fused), device="cpu")
    assert pt.use_fused == fused and pt.linsolver == "split"
    x = _params(sj.nparams)
    (Jj, auxj), gj = pj.build_value_and_grad()(jnp.asarray(x), jnp.asarray(x))
    (Jt, auxt), gt = pt.build_value_and_grad()(x, x)
    assert gt.dtype == torch.float64 and gt.shape == (sj.nparams,)
    _assert_vg(Jt, gt, Jj, gj, 1e-10, 1e-9)
    for k in auxj:
        np.testing.assert_allclose(float(auxt[k]), float(auxj[k]),
                                   rtol=1e-10, atol=1e-14, err_msg=k)


def test_flagship_f32_matches_jax_pallas_streamk():
    sj = flagship_setup("jax", pallas=True)
    pj = JProblem(sj)
    assert pj.use_pallas and pj.real_glue
    pt = TProblem(port_setup(sj), device="cpu")
    assert pt.use_fused and pt.rdtype == torch.float32
    x = _params(sj.nparams)
    (Jj, _), gj = pj.build_value_and_grad()(jnp.asarray(x), jnp.asarray(x))
    (Jt, _), gt = pt.build_value_and_grad()(x, x)
    assert gt.dtype == torch.float32
    _assert_vg(Jt, gt, Jj, gj, 2e-4, 1e-3)


def test_flagship_ensemble_matches_jax():
    sj = flagship_setup("jax", pallas=True)
    pj = JProblem(sj)
    pt = TProblem(port_setup(sj), device="cpu")
    Ps = _params(sj.nparams, E=3, seed=7)
    ref = np.zeros(sj.nparams)
    (Jj, auxj), gj = pj.build_ensemble_value_and_grad()(jnp.asarray(Ps),
                                                         jnp.asarray(ref))
    (Jt, auxt), gt = pt.build_ensemble_value_and_grad()(Ps, ref)
    assert Jt.shape == (3,) and gt.shape == (3, sj.nparams)
    _assert_vg(Jt, gt, Jj, gj, 2e-4, 1e-3)
    np.testing.assert_allclose(auxt["fidelity"].numpy(),
                               np.asarray(auxj["fidelity"]), rtol=2e-4)
    # each candidate's row is its own single value_and_grad
    vg = pt.build_value_and_grad()
    (J1, _), g1 = vg(Ps[1], ref)
    np.testing.assert_allclose(float(J1), float(Jt[1]), rtol=1e-5)
    assert float((g1 - gt[1]).abs().max()) <= 1e-4 * float(g1.abs().max())


def test_plain_time_loop_matches_jax_solvers():
    """ops/solvers.propagate and propagate_trajectory against the JAX scans
    on the flagship step function (f64)."""
    from quandary_tpu.ops import solvers as jsolvers
    from quandary_tpu_torch.ops import solvers as tsolvers

    sj = flagship_setup("jax", dtype=jnp.complex128, pallas=False, ntime=8)
    pj, pt = JProblem(sj), TProblem(port_setup(sj), device="cpu")
    x = _params(sj.nparams)
    Cj = pj.coeff_rows_mid(jnp.asarray(x))
    Ct = pt.coeff_rows_mid(torch.as_tensor(x))
    xTj, _ = jsolvers.propagate(pj.step_fn, jnp.asarray(pj.x0), Cj)
    xTt = tsolvers.propagate(pt.step_fn, torch.as_tensor(pt.x0), Ct)
    np.testing.assert_allclose(xTt.numpy(), np.asarray(xTj), atol=1e-12)
    trj = jsolvers.propagate_trajectory(pj.step_fn, jnp.asarray(pj.x0), Cj)
    trt = tsolvers.propagate_trajectory(pt.step_fn, torch.as_tensor(pt.x0),
                                        Ct)
    np.testing.assert_allclose(trt.numpy(), np.asarray(trj), atol=1e-12)


@pytest.mark.parametrize("change,device", [
    (dict(dtype=torch.complex128), "cuda"),
    # a forced fused route refuses by name where the scan could run
    (dict(time_parallel=True, fused_mode="chunk", linsolver="jacobi"),
     "cpu"),
    (dict(timestepper="IMR4"), "cpu"),
    (dict(linsolver="gmres"), "cpu"),
])
def test_out_of_slice_raises(change, device):
    """Configurations the forced fused route (fused=True, which
    flagship_setup names) or the port does not take are refused by name,
    never run on another path."""
    st = dataclasses.replace(flagship_setup("torch"), **change)
    with pytest.raises(NotImplementedError):
        TProblem(st, device=device)

