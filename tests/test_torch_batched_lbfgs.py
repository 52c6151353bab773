"""quandary_tpu_torch.optim.batched_lbfgs against
quandary_tpu.optim.batched_lbfgs in f64 on the multi-start state transfer
of tests/test_batched_lbfgs.py (one qubit flipped by a 12-spline pulse,
Jfrobenius), with the time grid cut to 100 steps.

The JAX side vmaps its scalar objective; the port evaluates the population
through Problem.packed_batch_fns (ensemble launches of the streamK path).
Same algorithm on the same numbers: f_trace to 1e-8 relative, the same
ladder and rejection counts. The absolute floor of 1e-12 is for the converged
tail: Jfrobenius forms values of 1e-8 as a difference of O(1) terms, so the
objective itself carries 1e-16 / 1e-8 = 1e-8 relative rounding there."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from quandary_tpu.optim.batched_lbfgs import batched_lbfgsb as jbatched  # noqa: E402
from quandary_tpu_torch.optim.batched_lbfgs import batched_lbfgsb  # noqa: E402
from quandary_tpu_torch.problem import Problem as TProblem  # noqa: E402
from test_torch_model import port_setup  # noqa: E402

E = 6


def _state_transfer():
    from quandary_tpu.models.hamiltonian import build_standard_model
    from quandary_tpu.optim.driver import build_bounds
    from quandary_tpu.problem import Problem, Setup
    from quandary_tpu.utils.splines import ControlSegment, OscillatorControl

    freq01 = [4.10595]
    model = build_standard_model(
        nlevels=[2], freq01_ghz=freq01, rotfreq_ghz=freq01,
        selfkerr_ghz=[0.2198])
    T, ntime = 80.0, 100
    osc = OscillatorControl(
        segments=(ControlSegment("spline", nsplines=12, tstart=0.0, tstop=T),),
        carrier_freqs=(0.0,))
    sj = Setup(
        model=model, nessential=(2,), ntime=ntime, dt=T / ntime,
        oscillators=(osc,), ground_freqs_radns=(2 * np.pi * freq01[0],),
        initcond_type="pure", pure_levels=(0,),
        target_type="pure", pure_target_levels=(1,),
        objective_type="Jfrobenius", gamma_tik=1e-8)
    lb, ub = build_bounds(sj.oscillators, [[0.5]])
    x0s = np.random.default_rng(0).uniform(-1, 1, (E, sj.nparams)) * 0.01
    return Problem(sj), TProblem(port_setup(sj), device="cpu"), x0s, lb, ub


@pytest.fixture(scope="module")
def case():
    return _state_transfer()


@pytest.mark.parametrize("speculative,ITERS", [(True, 30), (False, 6)])
def test_f_trace_matches_jax(case, speculative, ITERS):
    pj, pt, x0s, lb, ub = case
    ref = jnp.zeros(pj.setup.nparams)

    def objective(x):
        J, _ = pj.objective(x, ref)
        return J

    xj, fj, trj, sj = jax.jit(lambda xs: jbatched(
        objective, jax.grad(objective), xs, lb, ub, iters=ITERS, history=6,
        speculative=speculative, return_stats=True))(jnp.asarray(x0s))
    xt, ft, trt, stt = batched_lbfgsb(
        None, None, torch.as_tensor(x0s), lb, ub, iters=ITERS, history=6,
        speculative=speculative, return_stats=True,
        **pt.packed_batch_fns(np.zeros(pt.setup.nparams)))
    assert trt.shape == (ITERS + 1, E) and trt.dtype == torch.float64
    np.testing.assert_allclose(trt.numpy(), np.asarray(trj), rtol=1e-8,
                               atol=1e-12)
    assert int(stt["ladder_iters"]) == int(sj["ladder_iters"]) \
        == (3 if speculative else ITERS)
    assert int(stt["rejected"]) == int(sj["rejected"])
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6,
                               atol=1e-10)
    # every candidate improved, the best-so-far never rises, bounds hold
    tr = trt.numpy()
    assert np.all(ft.numpy() <= tr[0] + 1e-12)
    assert np.all(np.diff(np.minimum.accumulate(tr.min(axis=1))) <= 1e-15)
    assert np.all(xt.numpy() >= lb - 1e-12) and np.all(xt.numpy() <= ub + 1e-12)


def test_hooks_derived_from_a_plain_objective():
    """Without batch hooks the population's value and gradient come from
    torch.func on the scalar objective: on a bounded convex quadratic the
    run equals the one with the analytic batch hooks."""
    rng = np.random.default_rng(1)
    A = torch.as_tensor(rng.normal(size=(5, 5)))
    H = A @ A.T + 0.5 * torch.eye(5, dtype=torch.float64)
    b = torch.as_tensor(rng.normal(size=5))
    lb, ub = -0.3 * np.ones(5), 0.3 * np.ones(5)
    x0s = torch.as_tensor(rng.uniform(-0.3, 0.3, (4, 5)))

    def objective(x):
        return 0.5 * x @ H @ x - b @ x

    obj_b = lambda xs: 0.5 * torch.einsum("ei,ij,ej->e", xs, H, xs) - xs @ b
    grad_b = lambda xs: xs @ H - b
    xs, fs, tr = batched_lbfgsb(objective, None, x0s, lb, ub, iters=25)
    xh, fh, trh = batched_lbfgsb(None, None, x0s, lb, ub, iters=25,
                                 objective_batch=obj_b, grad_batch=grad_b)
    assert tr.shape == (26, 4)
    torch.testing.assert_close(tr, trh, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(xs, xh, rtol=1e-6, atol=1e-9)
    assert bool((fs < tr[0]).all())
    assert bool((xs >= -0.3).all()) and bool((xs <= 0.3).all())


def test_packed_batch_fns_are_the_ensemble_entry_points(case):
    """The hook triple: objective_batch is the forward alone (no graph
    kept), vg_batch equals build_ensemble_value_and_grad, grad_batch is
    its gradient; all three on every path of the problem (fused, and off
    it on the sequential loop and, where 'auto' takes it, the
    time-parallel scan)."""
    import dataclasses
    _, pt, x0s, _, _ = case
    ref = np.zeros(pt.setup.nparams)
    (J, _), g = pt.build_ensemble_value_and_grad()(x0s, ref)
    plain = [TProblem(dataclasses.replace(pt.setup, fused=False, **kw),
                      device="cpu")
             for kw in ({}, dict(time_parallel=False))]
    assert not plain[1].time_parallel
    for p in (pt, *plain):
        kw = p.packed_batch_fns(ref)
        assert set(kw) == {"objective_batch", "grad_batch", "vg_batch"}
        xs = torch.as_tensor(x0s)
        f = kw["objective_batch"](xs)
        assert not f.requires_grad
        f2, g2 = kw["vg_batch"](xs)
        for a, b in ((f, J), (f2, J), (g2, g), (kw["grad_batch"](xs), g)):
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-14)
    # the pipelined sweeps: reps x (sum J + sum g)
    acc = pt.build_ensemble_sweeps()(np.stack([x0s, x0s]), ref)
    torch.testing.assert_close(acc, 2 * (J.sum() + g.sum()), rtol=1e-12,
                               atol=0)
    with pytest.raises(ValueError, match="hooks"):
        batched_lbfgsb(None, None, torch.as_tensor(x0s), ref - 1, ref + 1,
                       grad_batch=kw["grad_batch"])
