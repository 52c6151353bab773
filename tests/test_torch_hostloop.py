"""quandary_tpu_torch's HostLoopRunner (ops/hostloop.py) on
tests/test_hostloop.py's problem (two transmons, 3 x 2 levels, 30 steps,
Jfrobenius to a pure target, the sequential loop) in f64 on the CPU: the
forward against the port's propagate_final (1e-12) and the stored states
against its trajectory; the gradient against autograd through
propagate_final (rtol 1e-8) and against the JAX runner's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from quandary_tpu.ops.hostloop import HostLoopRunner as JRunner  # noqa: E402
from quandary_tpu_torch.ops.hostloop import HostLoopRunner  # noqa: E402
from quandary_tpu_torch.problem import Problem  # noqa: E402
from test_hostloop import _prob  # noqa: E402
from test_torch_model import port_setup  # noqa: E402


def _problems():
    pj, sj = _prob()
    pt = Problem(port_setup(sj, fused="auto"), device="cpu")
    assert not pj.time_parallel and not pt.time_parallel
    return pj, pt, sj


def test_forward_matches_propagate_final():
    _, pt, sj = _problems()
    x = np.random.default_rng(0).normal(size=sj.nparams) * 0.02
    seen = []
    xT, stored = HostLoopRunner(pt).forward(
        x, store_states=True, callback=lambda n, s: seen.append(n))
    assert seen == list(range(sj.ntime + 1))
    assert len(stored) == sj.ntime + 1 and stored[0].device.type == "cpu"
    want = pt.build_propagate_final()(x)
    assert (xT - want).abs().max() < 1e-12
    traj = pt.build_propagate_trajectory()(x)
    assert (torch.stack(stored) - traj).abs().max() < 1e-12
    xT2, none = HostLoopRunner(pt).forward(x)
    assert none is None and (xT2 - xT).abs().max() == 0


def test_gradient_matches_autograd_and_jax():
    pj, pt, sj = _problems()
    x = np.random.default_rng(1).normal(size=sj.nparams) * 0.02

    def loss_t(xT, p):
        re, _ = pt._eval_J_parts_real(xT.real, xT.imag)
        return torch.sum(pt._weights * re) + 1e-4 * torch.sum(p * p)

    def loss_j(xT, p):
        re, _ = pj.eval_J_parts(xT)
        return jnp.sum(jnp.asarray(pj.weights) * re) + 1e-4 * jnp.sum(p * p)

    J, g = HostLoopRunner(pt).gradient(x, loss_t)
    p = torch.as_tensor(x).requires_grad_(True)
    L = loss_t(pt.propagate_final(p), p)
    (g_ad,) = torch.autograd.grad(L, p)
    assert abs(J - float(L.detach())) < 1e-12
    np.testing.assert_allclose(g.numpy(), g_ad.numpy(), rtol=1e-8,
                               atol=1e-13)
    Jj, gj = JRunner(pj).gradient(jnp.asarray(x), loss_j)
    assert abs(J - Jj) < 1e-12
    np.testing.assert_allclose(g.numpy(), gj, rtol=1e-8, atol=1e-13)
