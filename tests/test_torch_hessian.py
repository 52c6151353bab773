"""quandary_tpu_torch's Hessian tools (optim/hessian.py) on
tests/test_hessian_sanity.py's problem (one qubit, 12 steps, Jfrobenius to
a pure target), in f64 on the CPU: the AD Hessian against the JAX
package's (1e-9 x max) on the time-parallel scan, which 'auto' takes here
as in the reference, and on the sequential loop with the stored adjoint
(the stage solve's double backward); symmetry to 1e-9; the FD Hessian
against AD (1e-5 x max); ascending eigenvalues; NotImplementedError by name
on the fused route and the reversible adjoint, which have no double
backward."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from quandary_tpu.optim import hessian as jhessian  # noqa: E402
from quandary_tpu_torch.optim.hessian import (fd_hessian, hessian,  # noqa: E402
                                              hessian_eigen)
from quandary_tpu_torch.problem import Problem  # noqa: E402
from test_hessian_sanity import _small_problem  # noqa: E402
from test_torch_model import port_setup  # noqa: E402


@pytest.fixture(scope="module")
def reference():
    pj, sj = _small_problem()
    x = np.random.default_rng(0).normal(size=sj.nparams) * 0.02
    assert pj.time_parallel
    return sj, x, jhessian.hessian(pj, x)


@pytest.mark.parametrize("time_parallel", ["auto", False])
def test_hessian_matches_jax(reference, time_parallel):
    sj, x, Hj = reference
    p = Problem(port_setup(sj, fused="auto", time_parallel=time_parallel),
                device="cpu")
    assert p.time_parallel == (time_parallel == "auto")
    assert p.adjoint_route == "stored"
    H = hessian(p, x)
    assert H.shape == (sj.nparams, sj.nparams) and H.dtype == np.float64
    assert np.abs(H - Hj).max() <= 1e-9 * np.abs(Hj).max()
    assert np.abs(H - H.T).max() < 1e-9
    if time_parallel == "auto":
        Hfd = fd_hessian(p, x, eps=1e-5)
        assert np.abs(H - Hfd).max() < 1e-5 * max(1.0, np.abs(H).max())
        w, V = hessian_eigen(p, x)
        assert w.shape == (sj.nparams,) and V.shape == H.shape
        assert np.all(np.diff(w) >= 0)


@pytest.mark.parametrize("change,match", [
    (dict(fused=True, dtype=torch.complex64), "fused route"),
    (dict(fused=False, time_parallel=False, adjoint="reversible"),
     "'reversible' adjoint"),
])
def test_hessian_refuses_without_double_backward(reference, change, match):
    """Routes whose autograd.Functions have a first backward only raise by
    name and do not switch routes; fd_hessian runs there."""
    sj, x, Hj = reference
    p = Problem(port_setup(sj, **change), device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        hessian(p, x)
    if change["fused"]:
        # complex64 (the fused route's plain version here): eps 1e-2, where
        # f32 rounding over eps stays small (5.2e-4 x max measured)
        Hfd = fd_hessian(p, x, eps=1e-2)
        assert np.abs(Hfd - Hj).max() < 2.5e-3 * np.abs(Hj).max()
