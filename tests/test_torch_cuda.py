"""quandary_tpu_torch on a CUDA device: the streamK kernel pair against its
plain torch version (shared and per-candidate stacks), each direction over
its branches (helper warps at N = 16 and where states span warps, the
inline layout at B*N = 1024, and for the backward at the largest N) and
its determinism, the
problem's value_and_grad and the packed robust objective on the card
against the CPU, and the device optimizer's CUDA-graph chunk against its
eager chunk;
the density-matrix kernels; the streamed-plane kernels (stream, chunk,
dense) against their plain version, stream_fwd and stream_bwd over their
branches (helper warps at N = 16 and where states span warps, the inline
layout at B*N = 1024, and for the forward at N = 154), their determinism
and stored against replayed iterates, on
the problem's routes, in the device optimizer and in the Kerr calibration.
Every test here is marked `cuda` and skips without a device (the
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
@pytest.mark.parametrize("solver,iters", [("split", 3), ("jacobi", 6),
                                          ("neumann", 4)])
def test_packed_kernel_matches_plain_on_card(cuda, solver, iters):
    """Per-candidate stacks and solver rows (G = 3 systems in one launch)
    against the plain version on the card; only the packed counters move.
    Bounds as test_kernel_matches_plain_on_card."""
    G = 3
    rng = np.random.default_rng(8)
    stack = (rng.normal(size=(G, K, N, N))
             + 1j * rng.normal(size=(G, K, N, N))).astype(np.complex64)
    gen_diag = np.stack([-1j * np.diag(s[0]) for s in stack]).astype(
        np.complex128)
    plan = streamk.make_plan(cuda(stack.real), cuda(stack.imag), DT, iters,
                             gen_diag, solver)
    assert plan.per_block
    C = streamk.extend_coeffs(plan, cuda(
        (rng.normal(size=(G, NT, K)) * 0.3).astype(np.float32)))
    x0 = rng.normal(size=(2, B, N)).astype(np.float32)
    w = cuda(rng.normal(size=(G, NT, B, N)).astype(np.float32))

    def run(fn):
        Cg = C.clone().requires_grad_()
        x0r, x0i = cuda(x0[0]).requires_grad_(), cuda(x0[1]).requires_grad_()
        xTr, _, hr, hi = fn(plan, x0r, x0i, Cg)
        (torch.sum(w * hr * hi) + torch.sum(xTr * xTr)).backward()
        torch.cuda.synchronize()
        return hr.detach(), Cg.grad, x0r.grad, x0i.grad

    before = streamk.launch_counts()
    kern = run(streamk.streamk_propagate_kernel)
    after = streamk.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "streamk_fwd_launches": 0, "streamk_bwd_launches": 0,
        "streamk_packed_fwd_launches": 1, "streamk_packed_bwd_launches": 1}
    plain = run(streamk.streamk_propagate_plain)
    for a, b, tol in zip(kern, plain, (1e-5, 1e-4, 1e-4, 1e-4)):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def _launch_case(cuda, solver, iters, B, n, k, E, per_block, seed):
    """A random streamK launch on the card: (rng, plan, C, x0r, x0i), with
    per-candidate stacks and solver rows when per_block."""
    rng = np.random.default_rng(seed)
    shape = (E, k, n, n) if per_block else (k, n, n)
    stack = (rng.normal(size=shape)
             + 1j * rng.normal(size=shape)).astype(np.complex64)
    diag = lambda s: -1j * np.diag(s[0]).astype(np.complex128)
    gen_diag = np.stack([diag(s) for s in stack]) if per_block \
        else diag(stack)
    plan = streamk.make_plan(cuda(stack.real), cuda(stack.imag), DT, iters,
                             gen_diag, solver)
    C = streamk.extend_coeffs(plan, cuda(
        (rng.normal(size=(E, NT, k)) * 0.3).astype(np.float32)))
    x0r, x0i = (cuda(a) for a in rng.normal(size=(2, B, n)).astype(
        np.float32))
    return rng, plan, C, x0r, x0i


def _bwd_case(cuda, solver, iters, B, n, k, E, per_block=False, seed=11):
    """One streamk_bwd launch (per-candidate stacks with per_block) on the
    history of the kernel forward, and plain_backward on the same inputs:
    (kernel (g0r, g0i, Cb), plain (g0r, g0i, Cb), the launch's helper
    threads)."""
    rng, plan, C, x0r, x0i = _launch_case(cuda, solver, iters, B, n, k, E,
                                          per_block, seed)
    _, _, hr, hi, ksr, ksi = streamk._kernel_fwd(plan, x0r, x0i, C)
    w = lambda *s: cuda(rng.normal(size=s).astype(np.float32))
    gT, jh = (w(E, B, n), w(E, B, n)), (w(E, NT, B, n), w(E, NT, B, n))
    kern = streamk._kernel_bwd(plan, x0r, x0i, C, hr, hi, ksr, ksi, *gT,
                               *jh)
    plain = streamk.plain_backward(plan, x0r, x0i, C, hr, hi, *gT, *jh)
    torch.cuda.synchronize()
    return kern, plain, streamk._bwd_shape(plan.Ke, iters, B, n)[2]


def _assert_bwd_close(kern, plain):
    """x0 and coefficient cotangents to 1e-4 of max, as
    test_kernel_matches_plain_on_card."""
    for a, b in zip(kern, plain):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 3, 128])
@pytest.mark.parametrize("solver,iters", [("split", 3), ("jacobi", 8),
                                          ("neumann", 8)])
def test_streamk_bwd_matches_plain_on_card(cuda, solver, iters, E):
    """The backward with helper warps at the flagship's widths (N = 16,
    B = 4, K = 7; a state's entries in one warp): split-3 with stored
    iterates, jacobi-8 and neumann-8 replayed, E = 1, 3 and 128."""
    kern, plain, helpers = _bwd_case(cuda, solver, iters, 4, 16, 7, E)
    assert helpers > 0
    _assert_bwd_close(kern, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # per-candidate stacks, all distinct
    dict(solver="split", iters=3, B=4, n=16, k=7, E=3, per_block=True),
    dict(solver="jacobi", iters=8, B=4, n=16, k=7, E=5, per_block=True),
    # open configuration 1's B N = 256, replayed
    dict(solver="jacobi", iters=8, B=16, n=16, k=5, E=1),
    # states spanning warps (named-barrier stages)
    dict(solver="jacobi", iters=6, B=3, n=12, k=4, E=3),
    # the largest N admitted at the flagship's B, Ke and iters, and
    # B N = 1024: the inline branch
    dict(solver="split", iters=3, B=4, n=52, k=7, E=2),
    dict(solver="split", iters=3, B=64, n=16, k=7, E=1),
    # Ke = 40 stack slots, more than the 32 helper threads at N = 8
    dict(solver="split", iters=3, B=8, n=8, k=39, E=2),
], ids=["packed-split3", "packed-jacobi8", "open1", "rows-span-warps",
        "inline-N52", "inline-BN1024", "Ke40-over-helpers"])
def test_streamk_bwd_shapes_on_card(cuda, case):
    """The backward against plain_backward over its branches: helper warps
    where they fit, the inline layout where they do not."""
    kern, plain, helpers = _bwd_case(cuda, **case)
    assert (helpers == 0) == (case["n"] == 52 or case["B"] == 64)
    if case["k"] == 39:
        assert 0 < helpers < 40
    _assert_bwd_close(kern, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("n,B", [(16, 4), (52, 4)])
def test_streamk_bwd_is_deterministic_on_card(cuda, n, B):
    """Two launches on the same inputs give the same bits of g0 and Cb
    (no atomics; the helpers' and the inline reduction order is fixed)."""
    a, _, _ = _bwd_case(cuda, "split", 3, B, n, 7, 8, seed=3)
    b, _, _ = _bwd_case(cuda, "split", 3, B, n, 7, 8, seed=3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _fwd_case(cuda, solver, iters, B, n, k, E, per_block=False, seed=11):
    """One streamk_fwd launch (per-candidate stacks with per_block) and
    the plain forward on the same inputs: (kernel (xTr, xTi, hr, hi, ksr,
    ksi), plain ones (the stage iterates of _stage_fwd from the plain
    history, or None when the plan replays them), the launch's helper
    threads)."""
    _, plan, C, x0r, x0i = _launch_case(cuda, solver, iters, B, n, k, E,
                                        per_block, seed)
    kern = streamk._kernel_fwd(plan, x0r, x0i, C)
    hr, hi = streamk.plain_forward(plan, x0r, x0i, C)
    ksr = ksi = None
    if kern[4] is not None:
        jac, split = streamk._solver_parts(plan)
        Hr, Hi = streamk._planes(plan, C)
        ks = []
        for t in range(NT):
            xr, xi = (x0r.expand(E, B, n), x0i.expand(E, B, n)) if t == 0 \
                else (hr[:, t - 1], hi[:, t - 1])
            T, _ = streamk._ops(Hr[:, t], Hi[:, t])
            if split is not None:   # _stage_fwd's rotation before the stages
                er, ei = split
                xr, xi = er * xr - ei * xi, er * xi + ei * xr
            ks.append(streamk._stage_fwd(T, xr, xi, dt=plan.dt, iters=iters,
                                         jac=jac, split=None)[2])
        ksr = torch.stack([torch.stack([k[0] for k in s], 1) for s in ks], 1)
        ksi = torch.stack([torch.stack([k[1] for k in s], 1) for s in ks], 1)
    torch.cuda.synchronize()
    plain = (hr[:, -1], hi[:, -1], hr, hi, ksr, ksi)
    return kern, plain, streamk._fwd_shape(plan.Ke, iters, B, n)[2]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # per-candidate stacks, all distinct
    dict(solver="split", iters=3, B=4, n=16, k=7, E=3, per_block=True),
    dict(solver="jacobi", iters=8, B=4, n=16, k=7, E=5, per_block=True),
    # open configuration 1's B N = 256, replayed
    dict(solver="jacobi", iters=8, B=16, n=16, k=5, E=1),
    # states spanning warps (named-barrier stages)
    dict(solver="jacobi", iters=6, B=3, n=12, k=4, E=3),
    # the largest N admitted at the flagship's B, Ke and iters (helpers:
    # the forward's two-slot layout fits), and B N = 1024: the inline
    # branch
    dict(solver="split", iters=3, B=4, n=52, k=7, E=2),
    dict(solver="split", iters=3, B=64, n=16, k=7, E=1),
    # Ke = 40 stack slots, more than the 32 helper threads at N = 8
    dict(solver="split", iters=3, B=8, n=8, k=39, E=2),
], ids=["packed-split3", "packed-jacobi8", "open1", "rows-span-warps",
        "N52", "inline-BN1024", "Ke40-over-helpers"])
def test_streamk_fwd_shapes_on_card(cuda, case):
    """The forward against the plain version over its branches: final
    state, history and stored iterates to 1e-5 of max (the state bound of
    test_kernel_matches_plain_on_card); helper warps where they fit, the
    inline layout where they do not."""
    kern, plain, helpers = _fwd_case(cuda, **case)
    assert (helpers == 0) == (case["B"] == 64)
    if case["k"] == 39:
        assert 0 < helpers < 40
    assert (kern[4] is None) == (plain[4] is None) == (case["iters"] > 4)
    for a, b in zip(kern, plain):
        if b is None:
            continue
        assert a.shape == b.shape
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,B", [(16, 4), (52, 4), (16, 64)])
def test_streamk_fwd_is_deterministic_on_card(cuda, n, B):
    """Two launches on the same inputs give the same bits of xT, the
    history and the stored iterates (helpers at N = 16 and 52, the inline
    branch at B N = 1024)."""
    a, _, _ = _fwd_case(cuda, "split", 3, B, n, 7, 8, seed=3)
    b, _, _ = _fwd_case(cuda, "split", 3, B, n, 7, 8, seed=3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _qutrit_samples(device, **setup_kw):
    from quandary_tpu_torch.optim.robust import sample_standard_models
    from quandary_tpu_torch.utils.splines import (ControlSegment,
                                                  OscillatorControl)
    T, ntime = 60.0, 300
    osc = OscillatorControl(
        segments=(ControlSegment("spline", nsplines=10, tstart=0.0, tstop=T),),
        carrier_freqs=(0.0,))
    common = dict(
        nessential=(2,), ntime=ntime, dt=T / ntime, oscillators=(osc,),
        ground_freqs_radns=(1.0,), initcond_type="pure", pure_levels=(0,),
        target_type="pure", pure_target_levels=(1,), objective_type="Jtrace",
        gamma_tik=1e-6, dtype=torch.complex64, gamma_penalty=0.05,
        gamma_penalty_energy=0.02, **setup_kw)
    return sample_standard_models(
        dict(nlevels=[3], freq01_ghz=[4.1], rotfreq_ghz=[4.1],
             selfkerr_ghz=[0.2]),
        [{"freq01_ghz": [4.1 + d]} for d in (0.0, 0.002, -0.003)], common,
        device=device)


@pytest.mark.cuda
def test_packed_robust_on_card_matches_cpu(cuda):
    """build_packed_robust_objective on the card: one launch of each packed
    kernel per gradient; J, aux and gradient against the per-sample
    objective on the card and the packed one on the CPU (f32, 1e-5 / 1e-4
    of max)."""
    from quandary_tpu_torch.optim import robust
    w = [0.5, 0.3, 0.2]
    pc, ph = _qutrit_samples(None), _qutrit_samples("cpu")
    assert pc[0].device.type == "cuda"
    x = (np.random.default_rng(0).normal(size=pc[0].setup.nparams)
         * 0.02).astype(np.float32)

    def vg(objective, device):
        xt = torch.tensor(x, device=device, requires_grad=True)
        J, aux = objective(xt, torch.zeros_like(xt))
        (g,) = torch.autograd.grad(J, xt)
        return J.detach().cpu(), g.cpu(), aux

    before = streamk.launch_counts()
    Jc, gc, auxc = vg(robust.build_packed_robust_objective(pc, w), "cuda")
    after = streamk.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "streamk_fwd_launches": 0, "streamk_bwd_launches": 0,
        "streamk_packed_fwd_launches": 1, "streamk_packed_bwd_launches": 1}
    for objective, device in (
            (robust.build_robust_objective(pc, w), "cuda"),
            (robust.build_packed_robust_objective(ph, w), "cpu")):
        J, g, aux = vg(objective, device)
        assert abs(float(Jc) - float(J)) <= 1e-5 * abs(float(J))
        assert float((gc - g).abs().max()) <= 1e-4 * float(g.abs().max())
        for k in aux:
            torch.testing.assert_close(auxc[k].detach().cpu(),
                                       aux[k].detach().cpu(), rtol=1e-4,
                                       atol=1e-6)


@pytest.mark.cuda
def test_device_optimizer_graph_matches_eager(cuda):
    """The CUDA-graph chunk replays the eager chunk: the same history to
    f32 rounding for as long as the picks agree, J falls, the launch
    counters advance by the captured launches per replay, and a second run
    reuses the captured graph."""
    from quandary_tpu_torch.optim.device_driver import run_optimization_device
    prob = _qutrit_samples(None)[0]
    n = prob.setup.nparams
    x0 = np.random.default_rng(5).normal(size=n) * 0.01
    lb, ub = np.full(n, -0.06), np.full(n, 0.06)
    kw = dict(maxiter=12, chunk=4, gatol=1e-14, grtol=1e-30, inftol=1e-12,
              fatol=1e-14, verbose=False)
    re = run_optimization_device(prob, x0, lb, ub, graph=False, **kw)
    before = streamk.launch_counts()
    rg = run_optimization_device(prob, x0, lb, ub, graph=True, **kw)
    after = streamk.launch_counts()
    assert rg.niter == re.niter == 12
    assert rg.history[-1].objective < rg.history[0].objective
    for he, hg in zip(re.history[:4], rg.history[:4]):
        assert he.step == hg.step
        assert abs(he.objective - hg.objective) <= 1e-5 * abs(he.objective)
    assert abs(rg.objective - re.objective) <= 0.05 * abs(re.objective)
    # init (1 + 1), the warm-up chunk (4 + 4) and 3 replays of 4 iterations
    assert after["streamk_fwd_launches"] - before["streamk_fwd_launches"] \
        == 1 + 4 + 12
    assert after["streamk_bwd_launches"] - before["streamk_bwd_launches"] \
        == 1 + 4 + 12
    mid = streamk.launch_counts()
    run_optimization_device(prob, x0, lb, ub, graph=True, **kw)
    assert streamk.launch_counts()["streamk_fwd_launches"] \
        - mid["streamk_fwd_launches"] == 1 + 12


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
    (Jc, _), gc = Problem(setup).build_value_and_grad()(x, x)
    assert streamk.streamk_fwd_launches == before[0] + 1
    assert streamk.streamk_bwd_launches == before[1] + 1
    (Jh, _), gh = Problem(setup, device="cpu").build_value_and_grad()(x, x)
    assert abs(float(Jc) - float(Jh)) <= 1e-5 * abs(float(Jh))
    assert float((gc.cpu() - gh).abs().max()) <= 1e-4 * float(gh.abs().max())
    with pytest.raises(NotImplementedError):
        Problem(dataclasses.replace(setup, dtype=torch.complex128),
                device="cuda")


def _random_open_system(rng, n, k, njump):
    """Folded H_eff stack (k, n, n), jump operators (None when njump is 0)
    and the (n, n) generator diagonal of a random open system."""
    def herm():
        A = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
        return (A + A.conj().T) / 2 / np.sqrt(n)

    stack = np.stack([herm() for _ in range(k)])
    Ls = [0.3 / np.sqrt(n) * (rng.normal(size=(n, n))
                              + 1j * rng.normal(size=(n, n)))
          for _ in range(njump)]
    if Ls:
        stack[0] = stack[0] - 0.5j * sum(L.conj().T @ L for L in Ls)
    h = np.diagonal(stack[0])
    gd = -1j * (h[:, None] - np.conj(h)[None, :])
    for L in Ls:
        dl = np.diagonal(L)
        gd = gd + dl[:, None] * np.conj(dl)[None, :]
    return stack, Ls or None, gd


# at G = 1 N = 16 runs one entry per thread, N = 32 and 33 2 x 2 tiles and
# N = 64 4 x 4 tiles; the shape rule picks G > 1 for some of them
@pytest.mark.cuda
@pytest.mark.parametrize("n,njump,E", [(16, 4, 1), (16, 0, 3), (27, 6, 2),
                                       (32, 2, 1), (33, 2, 1), (64, 4, 2)])
@pytest.mark.parametrize("solver,iters", [("neumann", 3), ("jacobi", 6),
                                          ("split", 3), ("neumann", 0)])
def test_rho_kernel_matches_plain_on_card(cuda, solver, iters, n, njump, E):
    """The density-matrix kernel pair against its plain version on the card,
    with stored and with replayed stage iterates: states to 1e-5 of max,
    coefficient and x0 cotangents to 1e-4 of max; one launch each."""
    from quandary_tpu_torch.ops import rho
    rng = np.random.default_rng(n + njump)
    stack, Ls, gd = _random_open_system(rng, n, 3, njump)
    f32 = lambda a: cuda(np.asarray(a, dtype=np.float32))
    plan = rho.make_plan(f32(stack.real), f32(stack.imag), Ls, 0.05, iters,
                         gd, solver)
    C = f32(rng.normal(size=(E, NT, 3)) * 0.5)
    x0 = rng.normal(size=(2, B, n, n)) / np.sqrt(n)
    wh = f32(rng.normal(size=(E, NT, B, n, n)))
    wT = f32(rng.normal(size=(E, B, n, n)))

    def run(fn):
        Cg = C.clone().requires_grad_()
        x0r, x0i = f32(x0[0]).requires_grad_(), f32(x0[1]).requires_grad_()
        xTr, xTi, hr, hi = fn(plan, x0r, x0i, Cg)
        (torch.sum(wT * xTr) + torch.sum(wT * xTi * xTi)
         + torch.sum(wh * hr * hi)).backward()
        torch.cuda.synchronize()
        return xTr.detach(), hr.detach(), hi.detach(), Cg.grad, x0r.grad, \
            x0i.grad

    plain = run(rho.rho_propagate_plain)
    for budget in (rho.KS_BUDGET_BYTES, 0):     # stored, then replayed
        saved, rho.KS_BUDGET_BYTES = rho.KS_BUDGET_BYTES, budget
        before = rho.launch_counts()
        try:
            kern = run(rho.rho_propagate_kernel)
        finally:
            rho.KS_BUDGET_BYTES = saved
        after = rho.launch_counts()
        assert {k: after[k] - before[k] for k in after} == {
            "rho_fwd_launches": 1, "rho_bwd_launches": 1}
        for a, b, tol in zip(kern, plain, (1e-5, 1e-5, 1e-5, 1e-4, 1e-4,
                                           1e-4)):
            assert bool(torch.isfinite(a).all())
            assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def _rho_inputs(cuda, n, njump, solver, iters, E, seed):
    """A random open system's plan (K = 3, dt 0.05), its coefficients
    (E, NT, 3), initial matrices (B, n, n) and the generator that made them,
    for the next draws."""
    from quandary_tpu_torch.ops import rho
    rng = np.random.default_rng(seed + n)
    stack, Ls, gd = _random_open_system(rng, n, 3, njump)
    f32 = lambda a: cuda(np.asarray(a, dtype=np.float32))
    plan = rho.make_plan(f32(stack.real), f32(stack.imag), Ls, 0.05, iters,
                         gd, solver)
    C = f32(rng.normal(size=(E, NT, 3)) * 0.5)
    x0 = rng.normal(size=(2, B, n, n)) / np.sqrt(n)
    return plan, f32(x0[0]), f32(x0[1]), C, rng


def _rho_bwd_case(cuda, n, njump, solver, iters, store, E=1, seed=5):
    """One rho_fwd launch (stage iterates stored or replayed) and what
    rho_bwd needs beside it: (plan, arguments of _kernel_bwd, the plain
    backward's (g0r, g0i, Cb) on the same inputs)."""
    from quandary_tpu_torch.ops import rho
    plan, x0r, x0i, C, rng = _rho_inputs(cuda, n, njump, solver, iters, E,
                                         seed)
    f32 = lambda a: cuda(np.asarray(a, dtype=np.float32))
    saved, rho.KS_BUDGET_BYTES = rho.KS_BUDGET_BYTES, (1 << 62) if store \
        else 0
    try:
        _, _, hr, hi, ksr, ksi = rho._kernel_fwd(plan, x0r, x0i, C)
    finally:
        rho.KS_BUDGET_BYTES = saved
    assert (ksr is not None) == store
    gT = f32(rng.normal(size=(E, B, n, n)))
    jh = f32(rng.normal(size=(E, NT, B, n, n)))
    args = (plan, x0r, x0i, C, hr, hi, ksr, ksi, gT, gT, jh, jh)
    plain = rho.plain_backward(plan, x0r, x0i, C, hr, hi, gT, gT, jh, jh)
    return args, plain


# N = 33 and 64 run two and four tiles of the band per thread at some G;
# N = 27 has bands of 3 and 4 rows at G = 8
@pytest.mark.cuda
@pytest.mark.parametrize("n,njump", [(16, 4), (27, 6), (33, 2), (64, 4)])
@pytest.mark.parametrize("solver,iters", [("jacobi", 6), ("split", 3)])
def test_rho_bwd_cluster_sizes_on_card(cuda, n, njump, solver, iters):
    """rho_bwd on clusters of 1, 2, 4 and 8 CTAs per density matrix, with
    stored and with replayed stage iterates: g0 equal to the bit across G
    (every entry is the same chain of fmaf), Cb within 1e-6 of max (its
    cross-CTA sum changes order with G), both against the plain backward
    to 1e-4 of max; one rho_bwd launch each."""
    from quandary_tpu_torch.ops import rho
    for store in (True, False):
        args, plain = _rho_bwd_case(cuda, n, njump, solver, iters, store)
        got = {}
        for G in (1, 2, 4, 8):
            before = rho.rho_bwd_launches
            got[G] = rho._kernel_bwd(*args, _cluster=G)
            torch.cuda.synchronize()
            assert rho.rho_bwd_launches - before == 1
        for G, (g0r, g0i, Cb) in got.items():
            assert torch.equal(g0r, got[1][0]) and torch.equal(g0i, got[1][1])
            assert float((Cb - got[1][2]).abs().max()) \
                <= 1e-6 * float(got[1][2].abs().max())
            for a, b in zip((g0r, g0i, Cb), plain):
                assert bool(torch.isfinite(a).all())
                assert float((a - b).abs().max()) \
                    <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,njump,E", [(16, 4, 2), (27, 6, 1), (64, 4, 1)])
def test_rho_bwd_is_deterministic_on_card(cuda, n, njump, E):
    """Two rho_bwd launches at the cluster size the shape rule picks give
    the same bits of g0 and Cb (no atomics; rank 0 sums the CTAs' partials
    in a fixed order)."""
    from quandary_tpu_torch.ops import rho
    args, _ = _rho_bwd_case(cuda, n, njump, "jacobi", 6, False, E=E)
    G = rho._bwd_shape(E, B, n, 3, njump)[0]
    assert G > 1
    a = rho._kernel_bwd(*args)
    b = rho._kernel_bwd(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# N = 27 has bands of 3 and 4 rows at G = 8; N = 33 and 64 run two and
# four tiles of the band per thread at G = 1
@pytest.mark.cuda
@pytest.mark.parametrize("n,njump", [(16, 4), (27, 6), (33, 2), (64, 4)])
@pytest.mark.parametrize("solver,iters", [("jacobi", 6), ("split", 3)])
def test_rho_fwd_cluster_sizes_on_card(cuda, n, njump, solver, iters):
    """rho_fwd on clusters of 1, 2, 4 and 8 CTAs per density matrix, stage
    iterates stored: xT, hist and the stored iterates equal to the bit
    across G (every entry is the same chain of fmaf, every entrywise
    product rounded as written), and the history within chip_smoke.py
    phase 12's bound of plain_forward (TOL_RHO_STATE_ABS, 1e-6 abs for
    entries of at most 1, relative above); one rho_fwd launch each."""
    from quandary_tpu_torch.ops import rho
    plan, x0r, x0i, C, _ = _rho_inputs(cuda, n, njump, solver, iters, 1, 9)
    plain = rho.plain_forward(plan, x0r, x0i, C)
    got = {}
    for G in (1, 2, 4, 8):
        before = rho.rho_fwd_launches
        got[G] = rho._kernel_fwd(plan, x0r, x0i, C, _cluster=G)
        torch.cuda.synchronize()
        assert rho.rho_fwd_launches - before == 1
    for G, out in got.items():
        assert out[4] is not None and out[4].shape == (1, B, NT, iters, n, n)
        for a, b in zip(out, got[1]):
            assert torch.equal(a, b)
        assert torch.equal(out[0], out[2][:, -1])
        for a, b in zip(out[2:4], plain):
            assert bool(torch.isfinite(a).all())
            assert float((a - b).abs().max()) \
                <= 1e-6 * max(1.0, float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("n,njump,E", [(16, 4, 2), (27, 6, 1), (64, 4, 1)])
def test_rho_fwd_is_deterministic_on_card(cuda, n, njump, E):
    """Two rho_fwd launches at the cluster size the shape rule picks give
    the same bits of xT, hist and the stored iterates."""
    from quandary_tpu_torch.ops import rho
    plan, x0r, x0i, C, _ = _rho_inputs(cuda, n, njump, "jacobi", 6, E, 9)
    assert rho._fwd_shape(E, B, n, 3, njump)[0] > 1
    a = rho._kernel_fwd(plan, x0r, x0i, C)
    b = rho._kernel_fwd(plan, x0r, x0i, C)
    assert a[4] is not None
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("n,njump,solver,iters", [
    (16, 4, "jacobi", 6), (27, 6, "split", 3), (33, 2, "neumann", 3),
    (64, 4, "jacobi", 6)])
def test_rho_store_and_replay_agree_in_bits_on_card(cuda, n, njump, solver,
                                                    iters):
    """At the cluster size the shape rule picks, rho_bwd from the forward's
    stored stage iterates and from its own replay of them gives the same
    bits of g0 and Cb: the forward and the replay run one stage chain
    (csrc/rho.cu stage_chain)."""
    from quandary_tpu_torch.ops import rho
    args, _ = _rho_bwd_case(cuda, n, njump, solver, iters, True)
    assert args[6] is not None
    stored = rho._kernel_bwd(*args)
    replayed = rho._kernel_bwd(*args[:6], None, None, *args[8:])
    for x, y in zip(stored, replayed):
        assert torch.equal(x, y)


def _open_cnot(guards, fused_rho="auto", ntime=48, T=8.0):
    from quandary_tpu_torch.models import gates
    from quandary_tpu_torch.models.hamiltonian import build_standard_model
    from quandary_tpu_torch.problem import Setup
    from quandary_tpu_torch.utils.splines import (ControlSegment,
                                                  OscillatorControl)
    Ne, Ng = [2, 2], ([2, 2] if guards else [0, 0])
    nlevels = [e + g for e, g in zip(Ne, Ng)]
    freq = [4.80595, 4.8601]
    model = build_standard_model(
        nlevels=nlevels, freq01_ghz=freq, rotfreq_ghz=freq,
        selfkerr_ghz=[0.2198, 0.2252], jkl_ghz=[0.005], crosskerr_ghz=[],
        decay_time=[80.0, 90.0], dephase_time=[40.0, 45.0], lindblad=True)
    oscs = tuple(OscillatorControl(
        segments=(ControlSegment("spline", nsplines=10, tstart=0.0,
                                 tstop=T),),
        carrier_freqs=(0.0,)) for _ in range(2))
    return Setup(
        model=model, nessential=tuple(Ne), ntime=ntime, dt=T / ntime,
        oscillators=oscs, initcond_type="diagonal", target_type="gate",
        target_gate_full=gates.assemble_gate(gates.cnot(), nlevels, Ne,
                                             [0.0, 0.0], T),
        objective_type="Jtrace", gamma_tik=1e-4, gamma_penalty=0.1,
        gamma_penalty_energy=0.1, dtype=torch.complex64, linsolve_iters=4,
        fused_rho=fused_rho)


@pytest.mark.cuda
@pytest.mark.parametrize("guards,fused_rho,form", [
    (True, "auto", "rho"), (False, "auto", "superop"), (False, "rho", "rho")])
def test_open_problem_on_card_matches_cpu(cuda, guards, fused_rho, form):
    """An open two-transmon CNOT on the card against the same problem on
    the CPU (plain), both f32: J to 1e-5, gradient to 1e-4 of max; E = 3
    candidates through one launch per direction; a dimension past one
    thread block of the forced route raises."""
    from quandary_tpu_torch.ops import rho
    from quandary_tpu_torch.problem import Problem
    setup = _open_cnot(guards, fused_rho)
    pc, ph = Problem(setup), Problem(setup, device="cpu")
    assert pc.fused_form == ph.fused_form == form and pc.fused_ok
    Ps = np.random.default_rng(3).uniform(-1, 1, (3, setup.nparams)) * 0.05
    before = {**streamk.launch_counts(), **rho.launch_counts()}
    (Jc, auxc), gc = pc.build_ensemble_value_and_grad()(Ps, Ps[0])
    after = {**streamk.launch_counts(), **rho.launch_counts()}
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    name = "rho" if form == "rho" else "streamk"
    assert moved == {f"{name}_fwd_launches": 1, f"{name}_bwd_launches": 1}
    (Jh, auxh), gh = ph.build_ensemble_value_and_grad()(Ps, Ps[0])
    assert float((Jc.cpu() - Jh).abs().max()) <= 1e-5 * float(Jh.abs().max())
    assert float((gc.cpu() - gh).abs().max()) <= 1e-4 * float(gh.abs().max())
    torch.testing.assert_close(auxc["fidelity"].cpu(), auxh["fidelity"],
                               rtol=1e-4, atol=1e-6)
    if guards:
        with pytest.raises(NotImplementedError, match="shared memory"):
            Problem(dataclasses.replace(setup, fused_rho="superop"))


def _stream_case(cuda, rng, E, n=N):
    stack = (rng.normal(size=(K, n, n))
             + 1j * rng.normal(size=(K, n, n))).astype(np.complex64)
    gen_diag = -1j * np.diag(stack[0]).astype(np.complex128)
    C = cuda((rng.normal(size=(E, NT, K)) * 0.3).astype(np.float32))
    x0 = rng.normal(size=(2, B, n)).astype(np.float32)
    w = cuda(rng.normal(size=(E, NT, B, n)).astype(np.float32))
    return stack, gen_diag, C, x0, w


@pytest.mark.cuda
@pytest.mark.parametrize("solver,iters", [("split", 3), ("jacobi", 4),
                                          ("jacobi", 6), ("neumann", 8),
                                          ("neumann", 0)])
def test_stream_kernel_matches_plain_on_card(cuda, solver, iters):
    """stream_fwd / stream_bwd against the plain version on the card at
    E = 3 through make_stream_propagate's pieces, non-Hermitian stacks:
    states to 1e-5 of max, the coefficient, x0 and stack cotangents to 1e-4
    of max; one launch each."""
    from quandary_tpu_torch.ops import stream
    rng = np.random.default_rng(11)
    stack, gen_diag, C, x0, w = _stream_case(cuda, rng, 3)
    plan = stream.make_plan(cuda(stack.real), DT, iters, gen_diag, solver)
    assert plan.store_iters == (iters <= 4)

    def run(fn):
        Sr, Si = cuda(stack.real).requires_grad_(), \
            cuda(stack.imag).requires_grad_()
        Cg = C.clone().requires_grad_()
        x0r, x0i = cuda(x0[0]).requires_grad_(), cuda(x0[1]).requires_grad_()
        Hr, Hi = stream.planes(plan, Sr, Si, Cg)
        xTr, _, hr, hi = fn(plan, Hr, Hi, x0r, x0i)
        (torch.sum(w * hr * hi) + torch.sum(xTr * xTr)).backward()
        torch.cuda.synchronize()
        return hr.detach(), Cg.grad, x0r.grad, x0i.grad, Sr.grad, Si.grad

    before = stream.launch_counts()
    kern = run(stream.stream_propagate_kernel)
    after = stream.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {"stream_fwd_launches": 1, "stream_bwd_launches": 1}
    plain = run(stream.stream_propagate_plain)
    for a, b, tol in zip(kern, plain, (1e-5,) + (1e-4,) * 5):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def _stream_bwd_case(cuda, solver, iters, B, n, k, E, kind="stream",
                     store=None, seed=11):
    """One stream_bwd (chunk_bwd for kind 'chunk') launch on the history of
    the kernel forward, non-Hermitian stacks, and plain_backward on the same
    inputs: (kernel (g0r, g0i, Hbr, Hbi), plain, the launch's helper
    threads). store overrides the plan's choice of stored iterates."""
    from quandary_tpu_torch.ops import stream
    rng = np.random.default_rng(seed)
    stack = (rng.normal(size=(k, n, n))
             + 1j * rng.normal(size=(k, n, n))).astype(np.complex64)
    gen_diag = -1j * np.diag(stack[0]).astype(np.complex128)
    plan = stream.make_plan(cuda(stack.real), DT, iters, gen_diag, solver,
                            kind=kind)
    if store is not None:
        plan = dataclasses.replace(plan, store_iters=store)
    C = cuda((rng.normal(size=(E, NT, k)) * 0.3).astype(np.float32))
    Hr, Hi = (h.contiguous() for h in stream.planes(
        plan, cuda(stack.real), cuda(stack.imag), C))
    x0r, x0i = (cuda(a) for a in rng.normal(size=(2, B, n)).astype(
        np.float32))
    _, _, hr, hi, ksr, ksi = stream._kernel_fwd(plan, Hr, Hi, x0r, x0i)
    w = lambda *s: cuda(rng.normal(size=s).astype(np.float32))
    gT, jh = (w(E, B, n), w(E, B, n)), (w(E, NT, B, n), w(E, NT, B, n))
    before = stream.launch_counts()[f"{kind}_bwd_launches"]
    kern = stream._kernel_bwd(plan, Hr, Hi, x0r, x0i, hr, hi, ksr, ksi, *gT,
                              *jh)
    assert stream.launch_counts()[f"{kind}_bwd_launches"] == before + 1
    plain = stream.plain_backward(plan, Hr, Hi, x0r, x0i, hr, hi, *gT, *jh)
    torch.cuda.synchronize()
    return kern, plain, stream._bwd_shape(iters, B, n)[2]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # stream_bwd<16>: the flagship's widths, stored and replayed iterates
    dict(solver="split", iters=3, B=4, n=16, k=7, E=3),
    dict(solver="jacobi", iters=6, B=4, n=16, k=7, E=3),
    # states spanning warps (named-barrier stages), and N = 8 at B = 8
    dict(solver="jacobi", iters=4, B=3, n=27, k=4, E=2),
    dict(solver="split", iters=3, B=8, n=8, k=5, E=2),
    # chunk_bwd_launch: plain Neumann, replayed
    dict(solver="neumann", iters=8, B=4, n=16, k=7, E=2, kind="chunk"),
    # B N = 1024: the inline branch
    dict(solver="split", iters=3, B=64, n=16, k=5, E=2),
], ids=["nc16-split3-stored", "nc16-jacobi6-replayed", "N27-rows-span-warps",
        "N8-B8", "chunk-neumann8", "inline-BN1024"])
def test_stream_bwd_shapes_on_card(cuda, case):
    """stream_bwd against plain_backward over its branches, to the bounds
    of test_stream_kernel_matches_plain_on_card (1e-4 of max): helper warps
    where they fit, the inline layout where they do not."""
    kern, plain, helpers = _stream_bwd_case(cuda, **case)
    assert (helpers == 0) == (case["B"] == 64)
    for a, b in zip(kern, plain):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,B", [(16, 4), (27, 3), (16, 64)])
def test_stream_bwd_is_deterministic_on_card(cuda, n, B):
    """Two launches on the same inputs give the same bits of g0 and Hb
    (each entry of Hb is written once, no atomics), in both layouts."""
    a, _, _ = _stream_bwd_case(cuda, "split", 3, B, n, 5, 4, seed=3)
    b, _, _ = _stream_bwd_case(cuda, "split", 3, B, n, 5, 4, seed=3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _stream_fwd_case(cuda, solver, iters, B, n, E, kind="stream", nt=NT,
                     k=5, seed=11):
    """One forward launch of the plan's member (stream_fwd_launch,
    chunk_fwd_launch or dense_fwd_launch) on non-Hermitian stacks of norm
    about 1, and the plain forward on the same planes: (kernel (xTr, xTi,
    hr, hi, ksr, ksi), plain ones (the stage iterates of _stage_fwd from
    the plain history where the kernel stores them), the launch's helper
    threads)."""
    from quandary_tpu_torch.ops import stream
    rng = np.random.default_rng(seed)
    stack = ((rng.normal(size=(k, n, n)) + 1j * rng.normal(size=(k, n, n)))
             / np.sqrt(n)).astype(np.complex64)
    gen_diag = -1j * np.diag(stack[0]).astype(np.complex128)
    plan = stream.make_plan(cuda(stack.real), DT, iters, gen_diag, solver,
                            kind=kind)
    C = cuda((rng.normal(size=(E, nt, k)) * 0.3).astype(np.float32))
    Hr, Hi = (h.contiguous() for h in stream.planes(
        plan, cuda(stack.real), cuda(stack.imag), C))
    x0r, x0i = (cuda(a) for a in rng.normal(size=(2, B, n)).astype(
        np.float32))
    before = stream.launch_counts()[f"{kind}_fwd_launches"]
    kern = stream._kernel_fwd(plan, Hr, Hi, x0r, x0i)
    assert stream.launch_counts()[f"{kind}_fwd_launches"] == before + 1
    hr, hi = stream.plain_forward(plan, Hr, Hi, x0r, x0i)
    ksr = ksi = None
    if kern[4] is not None:
        jac, split = stream._solver_parts(plan)
        ks = []
        for t in range(nt):
            xr, xi = (x0r.expand(E, B, n), x0i.expand(E, B, n)) if t == 0 \
                else (hr[:, t - 1], hi[:, t - 1])
            T, _ = streamk._ops(Hr[:, t], Hi[:, t])
            ks.append(streamk._stage_fwd(T, xr, xi, dt=plan.dt, iters=iters,
                                         jac=jac, split=split)[2])
        ksr = torch.stack([torch.stack([k[0] for k in s], 1) for s in ks], 1)
        ksi = torch.stack([torch.stack([k[1] for k in s], 1) for s in ks], 1)
    torch.cuda.synchronize()
    plain = (hr[:, -1], hi[:, -1]) + ((None, None) if kind == "dense"
                                      else (hr, hi)) + (ksr, ksi)
    return kern, plain, stream._fwd_shape(B, n)[2]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # stream_fwd<., 16>: the flagship's widths, stored and replayed
    dict(solver="split", iters=3, B=4, n=16, E=1),
    dict(solver="split", iters=3, B=4, n=16, E=3),
    dict(solver="jacobi", iters=8, B=4, n=16, E=1),
    dict(solver="jacobi", iters=8, B=4, n=16, E=3),
    # states spanning warps (named-barrier stages), N = 8 at B = 8, and
    # the largest N whose two H slots fit at B = 4, on 1024 threads
    dict(solver="split", iters=3, B=3, n=27, E=2),
    dict(solver="split", iters=3, B=8, n=8, E=2),
    dict(solver="split", iters=3, B=4, n=52, E=1),
    # the inline branch: B N = 1024, and N = 154 (two slots past 227 KB)
    dict(solver="split", iters=3, B=64, n=16, E=2),
    dict(solver="split", iters=3, B=4, n=154, E=1, nt=200),
    # chunk_fwd_launch and dense_fwd_launch: plain Neumann, nothing stored
    dict(solver="neumann", iters=8, B=4, n=16, E=1, kind="chunk"),
    dict(solver="neumann", iters=8, B=4, n=16, E=1, kind="dense"),
], ids=["nc16-split3-E1", "nc16-split3-E3", "nc16-jacobi8-E1",
        "nc16-jacobi8-E3", "N27-rows-span-warps", "N8-B8", "N52",
        "inline-BN1024", "inline-N154", "chunk-neumann8", "dense-neumann8"])
def test_stream_fwd_shapes_on_card(cuda, case):
    """stream_fwd against the plain forward over its branches: xT, the
    history and the stored iterates to 1e-5 of max (the state bound of
    test_stream_kernel_matches_plain_on_card); helper warps where the two
    H slots fit, the inline layout where they do not."""
    kern, plain, helpers = _stream_fwd_case(cuda, **case)
    assert (helpers == 0) == (case["B"] == 64 or case["n"] == 154)
    stored = case.get("kind", "stream") == "stream" and case["iters"] <= 4
    assert (kern[4] is None) == (plain[4] is None) == (not stored)
    assert (kern[2] is None) == (case.get("kind") == "dense")
    for a, b in zip(kern, plain):
        if b is None:
            continue
        assert a.shape == b.shape
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,B", [(16, 4), (52, 4), (16, 64)])
def test_stream_fwd_is_deterministic_on_card(cuda, n, B):
    """Two launches on the same inputs give the same bits of xT, the
    history and the stored iterates (helpers at N = 16 and 52, the inline
    branch at B N = 1024)."""
    a, _, _ = _stream_fwd_case(cuda, "split", 3, B, n, 4, seed=3)
    b, _, _ = _stream_fwd_case(cuda, "split", 3, B, n, 4, seed=3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("n,B", [(16, 4), (27, 3)])
@pytest.mark.parametrize("solver,iters", [("split", 3), ("jacobi", 4)])
def test_stream_store_and_replay_agree_in_bits_on_card(cuda, solver, iters,
                                                       n, B):
    """stream_bwd from the forward's stored stage iterates and from its own
    replay of them gives the same bits of g0 and Hb: the replay runs
    fwd_chain_step's order of terms (chain_step's ONE_CHAIN)."""
    stored, _, _ = _stream_bwd_case(cuda, solver, iters, B, n, 5, 2,
                                    store=True)
    replayed, _, _ = _stream_bwd_case(cuda, solver, iters, B, n, 5, 2,
                                      store=False)
    for x, y in zip(stored, replayed):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_chunk_and_dense_kernels_match_plain_on_card(cuda):
    """make_pallas_propagate (chunk kernels) and pallas_propagate_dense on
    the card against the same on the CPU: states to 1e-5 of max,
    cotangents to 1e-4 of max; the dense xT is the chunk forward's."""
    from quandary_tpu_torch.ops import adjoint, dense, stream
    rng = np.random.default_rng(12)
    stack, _, C, x0, w = _stream_case(cuda, rng, 1)
    C, w = C[0], w[0]
    prop = adjoint.make_pallas_propagate(DT, 8)
    out = {}
    for dev in ("cuda", "cpu"):
        t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
        Sr, Si = (t(p).requires_grad_() for p in adjoint.plane_args(stack))
        Cg = C.to(dev).clone().requires_grad_()
        x0r, x0i = t(x0[0]).requires_grad_(), t(x0[1]).requires_grad_()
        before = stream.launch_counts()
        (xTr, xTi), (hr, hi) = prop(Sr, Si, (x0r, x0i), Cg)
        (torch.sum(w.to(dev) * hr * hi) + torch.sum(xTr * xTr)).backward()
        xd = dense.pallas_propagate_dense(stack, C.cpu().numpy(),
                                          t(x0[0] + 1j * x0[1]), DT, 8)
        after = stream.launch_counts()
        moved = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        assert moved == ({"chunk_fwd_launches": 1, "chunk_bwd_launches": 1,
                          "dense_fwd_launches": 1} if dev == "cuda" else {})
        assert torch.equal(xd, torch.complex(xTr, xTi).detach())
        out[dev] = [a.detach().cpu() for a in (hr, Cg.grad, x0r.grad,
                                               Sr.grad, Si.grad)]
    for a, b, tol in zip(out["cuda"], out["cpu"], (1e-5,) + (1e-4,) * 4):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["stream", "chunk"])
def test_stream_problem_on_card_matches_cpu(cuda, mode):
    """A qutrit problem (plain Neumann, so both modes take it) on the
    stream / chunk route: E = 3 candidates on the card in one launch per
    direction against the CPU, J to 1e-5 and the gradient to 1e-4 of max."""
    from quandary_tpu_torch.ops import stream
    pc = _qutrit_samples(None, fused_mode=mode)[0]
    ph = _qutrit_samples("cpu", fused_mode=mode)[0]
    assert pc.fused_form == mode and pc.linsolver == "neumann"
    Ps = np.random.default_rng(3).normal(size=(3, pc.setup.nparams)) * 0.02
    before = {**streamk.launch_counts(), **stream.launch_counts()}
    (Jc, _), gc = pc.build_ensemble_value_and_grad()(Ps, Ps[0])
    after = {**streamk.launch_counts(), **stream.launch_counts()}
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {f"{mode}_fwd_launches": 1, f"{mode}_bwd_launches": 1}
    (Jh, _), gh = ph.build_ensemble_value_and_grad()(Ps, Ps[0])
    assert float((Jc.cpu() - Jh).abs().max()) <= 1e-5 * float(Jh.abs().max())
    assert float((gc.cpu() - gh).abs().max()) <= 1e-4 * float(gh.abs().max())


@pytest.mark.cuda
def test_device_optimizer_stream_matches_streamk(cuda):
    """run_optimization_device on fused_mode='stream' (CUDA graph) gives the
    streamK route's J history to f32 rounding while the picks agree, and the
    stream counters advance by the captured launches per replay."""
    from quandary_tpu_torch.ops import stream
    from quandary_tpu_torch.optim.device_driver import run_optimization_device
    pk = _qutrit_samples(None)[0]
    ps = _qutrit_samples(None, fused_mode="stream")[0]
    n = pk.setup.nparams
    x0 = np.random.default_rng(5).normal(size=n) * 0.01
    lb, ub = np.full(n, -0.06), np.full(n, 0.06)
    kw = dict(maxiter=12, chunk=4, gatol=1e-14, grtol=1e-30, inftol=1e-12,
              fatol=1e-14, verbose=False)
    rk = run_optimization_device(pk, x0, lb, ub, **kw)
    before = {**streamk.launch_counts(), **stream.launch_counts()}
    rs = run_optimization_device(ps, x0, lb, ub, **kw)
    after = {**streamk.launch_counts(), **stream.launch_counts()}
    assert rs.niter == rk.niter == 12
    for hk, hs in zip(rk.history[:4], rs.history[:4]):
        assert hk.step == hs.step
        assert abs(hk.objective - hs.objective) <= 1e-5 * abs(hk.objective)
    assert abs(rs.objective - rk.objective) <= 0.05 * abs(rk.objective)
    # init (1 + 1), the warm-up chunk (4 + 4) and 3 replays of 4 iterations
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {"stream_fwd_launches": 1 + 4 + 12,
            "stream_bwd_launches": 1 + 4 + 12}


@pytest.mark.cuda
def test_kerr_calibration_on_card(cuda):
    """The example's Kerr recovery on the card, rel err < 1e-4, one launch
    of each stream kernel per gradient."""
    from quandary_tpu_torch import calibration
    from quandary_tpu_torch.ops import stream
    before = stream.launch_counts()
    xi, err, iterations = calibration.KerrCalibration().run()
    after = stream.launch_counts()
    assert err < 1e-4, (xi, err)
    # the data trajectory (one forward) and one sweep per gradient
    assert after["stream_bwd_launches"] - before["stream_bwd_launches"] \
        == iterations + 1
    assert after["stream_fwd_launches"] - before["stream_fwd_launches"] \
        == iterations + 2
