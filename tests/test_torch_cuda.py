"""quandary_tpu_torch on a CUDA device: the streamK kernel pair against its
plain torch version, and the problem's value_and_grad on the card against
the CPU. Every test here is marked `cuda` and skips without a device (the
kernels have no CPU mode). This file imports no JAX, so it also runs where
only torch is installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from quandary_tpu_torch.ops import streamk  # noqa: E402

K, N, B, NT, DT = 4, 12, 3, 9, 0.01


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the streamK kernels have no CPU "
                    "mode")
    return lambda a: torch.tensor(np.asarray(a), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("solver,iters", [("split", 3), ("jacobi", 4),
                                          ("jacobi", 6), ("neumann", 8),
                                          ("neumann", 0)])
def test_kernel_matches_plain_on_card(cuda, solver, iters):
    """Kernel pair against the plain version on the card at E = 3: states
    to 1e-5 of max, coefficient and x0 cotangents to 1e-4 of max."""
    rng = np.random.default_rng(6)
    stack = (rng.normal(size=(K, N, N))
             + 1j * rng.normal(size=(K, N, N))).astype(np.complex64)
    gen_diag = -1j * np.diag(stack[0]).astype(np.complex128)
    plan = streamk.make_plan(cuda(stack.real), cuda(stack.imag), DT, iters,
                             gen_diag, solver)
    C = streamk.extend_coeffs(plan, cuda(
        (rng.normal(size=(3, NT, K)) * 0.3).astype(np.float32)))
    x0 = rng.normal(size=(2, B, N)).astype(np.float32)
    w = cuda(rng.normal(size=(3, NT, B, N)).astype(np.float32))

    def run(fn):
        Cg = C.clone().requires_grad_()
        x0r, x0i = cuda(x0[0]).requires_grad_(), cuda(x0[1]).requires_grad_()
        xTr, _, hr, hi = fn(plan, x0r, x0i, Cg)
        (torch.sum(w * hr * hi) + torch.sum(xTr * xTr)).backward()
        torch.cuda.synchronize()
        return hr.detach(), Cg.grad, x0r.grad, x0i.grad

    kern = run(streamk.streamk_propagate_kernel)
    plain = run(streamk.streamk_propagate_plain)
    for a, b, tol in zip(kern, plain, (1e-5, 1e-4, 1e-4, 1e-4)):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.cuda
def test_problem_on_card_matches_cpu(cuda):
    """A small guarded two-transmon problem: value_and_grad on the card
    (kernels) against the same problem on the CPU (plain), both f32."""
    from quandary_tpu_torch.models import gates
    from quandary_tpu_torch.models.hamiltonian import build_standard_model
    from quandary_tpu_torch.problem import Problem, Setup
    from quandary_tpu_torch.utils.splines import (ControlSegment,
                                                  OscillatorControl)

    freq = [4.80595, 4.8601]
    T = 4.0
    model = build_standard_model(
        nlevels=[3, 3], freq01_ghz=freq, rotfreq_ghz=freq,
        selfkerr_ghz=[0.2198, 0.2252], jkl_ghz=[0.005])
    oscs = tuple(OscillatorControl(
        segments=(ControlSegment("spline", nsplines=6, tstart=0.0,
                                 tstop=T),),
        carrier_freqs=(0.0, 2 * np.pi * (freq[1 - k] - freq[k])))
        for k in range(2))
    setup = Setup(
        model=model, nessential=(2, 2), ntime=30, dt=T / 30,
        oscillators=oscs, initcond_type="basis", target_type="gate",
        target_gate_full=gates.assemble_gate(gates.cnot(), [3, 3], [2, 2],
                                             [0.0, 0.0], T),
        gamma_penalty=0.1, gamma_penalty_energy=0.1, gamma_penalty_dpdm=0.01,
        dtype=torch.complex64, linsolve_iters=3, linsolver="split")
    x = np.random.default_rng(3).uniform(-1, 1, setup.nparams) * 0.05
    before = streamk.streamk_fwd_launches, streamk.streamk_bwd_launches
    (Jc, _), gc = Problem(setup, device="cuda").build_value_and_grad()(x, x)
    assert streamk.streamk_fwd_launches == before[0] + 1
    assert streamk.streamk_bwd_launches == before[1] + 1
    (Jh, _), gh = Problem(setup).build_value_and_grad()(x, x)
    assert abs(float(Jc) - float(Jh)) <= 1e-5 * abs(float(Jh))
    assert float((gc.cpu() - gh).abs().max()) <= 1e-4 * float(gh.abs().max())
    with pytest.raises(NotImplementedError):
        Problem(dataclasses.replace(setup, dtype=torch.complex128),
                device="cuda")
