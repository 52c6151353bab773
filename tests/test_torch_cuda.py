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
the problem's routes, in the device optimizer and in the Kerr calibration;
the mid-size streamK pair (csrc/streamk_mid.cu, closed systems past one
thread block) against the plain version, its determinism and its launch
counters, alone and under Problem; the mid-size density-matrix pair
(csrc/rho_mid.cu, open systems of 64 < N <= 128) the same, with its bits
across cluster sizes and between stored and replayed iterates; the mid
streamK pair on per-candidate stacks and on open superop plans past one
block, and the open packed robust objective on both pairs; a
trajectory's CUDA-graph capture while an orphaned graph is collected; the
device optimizer's plain-route chunk as segmented CUDA graphs; the
time-parallel scan against the sequential loop, and the device optimizer
on it; the flagship on a one-rank NCCL mesh against its unsharded bits.
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
        gamma_penalty_energy=0.02, fused=True)
    common.update(setup_kw)
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


def _plain_route_problem():
    """config_template.cfg's problem on the card, as
    scripts/plain_route_graph.py builds it: the plain route (complex128,
    N = 4, 4 initial states, 1000 steps of 20 stage iterations) on the
    sequential loop (time_parallel=False: 'auto' takes the scan here), with
    its bounds and initial parameters."""
    import os
    from quandary_tpu_torch.io.configfile import Config, setup_from_config
    from quandary_tpu_torch.optim.driver import build_bounds
    from quandary_tpu_torch.problem import Problem
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    setup, spec = setup_from_config(
        Config.read(os.path.join(root, "config_template.cfg")), root)
    prob = Problem(dataclasses.replace(setup, time_parallel=False))
    assert prob.fused_form is None and prob.device.type == "cuda"
    assert not prob.time_parallel
    return prob, spec.params0, build_bounds(setup.oscillators,
                                            spec.control_bounds)


@pytest.mark.cuda
def test_device_optimizer_plain_route_default_graph_on_card(cuda):
    """run_optimization_device with its default `graph` on the plain route,
    three chunks of 10 iterations: the default runs the chunks eagerly
    (default_graph is False off the kernel routes, ROADMAP C1), the J
    history stays finite and falls, and no kernel launches."""
    from quandary_tpu_torch.ops import stream
    from quandary_tpu_torch.optim.device_driver import (default_graph,
                                                        run_optimization_device)
    prob, x0, (lb, ub) = _plain_route_problem()
    assert not default_graph(prob)
    before = {**streamk.launch_counts(), **stream.launch_counts()}
    res = run_optimization_device(prob, x0, lb, ub, chunk=10, maxiter=30,
                                  gatol=0.0, grtol=0.0, fatol=0.0,
                                  inftol=0.0, verbose=False)
    torch.cuda.synchronize()
    (_, chunk_fn), = prob._device_opt_cache.values()
    assert chunk_fn.__name__ == "chunk_eager"
    assert res.niter == 30
    objs = [h.objective for h in res.history]
    assert np.all(np.isfinite(objs)) and objs[-1] < objs[0]
    assert {**streamk.launch_counts(), **stream.launch_counts()} == before


@pytest.mark.cuda
def test_device_optimizer_plain_route_graph_replays_on_card(cuda):
    """graph=True on the plain route (ROADMAP C1): scripts/plain_route_graph
    .py captures a chunk of 10 iterations at 1000 steps, about 3.1M graph
    nodes, as graphs of consecutive iterations under half
    device_driver.GRAPH_NODE_LIMIT, and calls it three times, in a process
    of its own (one graph of the whole chunk faulted at its second replay
    and ended the CUDA context). The script ends with code 0, the rows of
    every call equal the eager chunks' in bits, and the chunk took more
    than one graph."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run(
        [sys.executable, os.path.join(root, "scripts", "plain_route_graph.py"),
         "--chunks", "10"], capture_output=True, text=True, timeout=600,
        cwd=root)
    assert run.returncode == 0, run.stderr[-2000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])["chunk10"]
    assert out["rows_equal"] and len(out["segments"]) > 1
    assert sum(out["segments"]) == 10
    from quandary_tpu_torch.optim.device_driver import GRAPH_NODE_LIMIT
    assert max(out["segments"]) * out["nodes_per_iteration"] \
        <= GRAPH_NODE_LIMIT // 2


@pytest.mark.cuda
def test_time_parallel_matches_sequential_on_card(cuda):
    """The time-parallel scan on the card: config_template.cfg's problem
    (complex128, N = 4, 4 states, 1000 steps), which 'auto' sends to the
    scan, against the same problem on the sequential loop on the card, with
    tests/test_time_parallel.py's bounds (J and every aux term 1e-10, the
    gradient rtol 1e-7 / atol 1e-12, the trajectory 1e-10) and no kernel
    launched; then one chunk of two device-driver iterations with
    graph=True on the scan: the cost falls, still no kernel."""
    import os
    from quandary_tpu_torch.io.configfile import Config, setup_from_config
    from quandary_tpu_torch.ops import stream
    from quandary_tpu_torch.optim.device_driver import run_optimization_device
    from quandary_tpu_torch.optim.driver import build_bounds
    from quandary_tpu_torch.problem import Problem
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    setup, spec = setup_from_config(
        Config.read(os.path.join(root, "config_template.cfg")), root)
    pt = Problem(setup)
    ps = Problem(dataclasses.replace(setup, time_parallel=False))
    assert pt.device.type == "cuda" and pt.time_parallel
    assert not ps.time_parallel and pt.fused_form is None
    x = spec.params0
    before = {**streamk.launch_counts(), **stream.launch_counts()}
    (Jt, at), gt = pt.build_value_and_grad()(x, x)
    (Js, as_), gs = ps.build_value_and_grad()(x, x)
    assert abs(float(Jt) - float(Js)) < 1e-10
    for k in at:
        assert abs(float(at[k]) - float(as_[k])) < 1e-10, k
    np.testing.assert_allclose(gt.cpu().numpy(), gs.cpu().numpy(),
                               rtol=1e-7, atol=1e-12)
    tt = pt.build_propagate_trajectory()(x)
    ts = ps.build_propagate_trajectory()(x)
    assert tt.shape == ts.shape and float((tt - ts).abs().max()) < 1e-10
    lb, ub = build_bounds(setup.oscillators, spec.control_bounds)
    res = run_optimization_device(pt, x, lb, ub, chunk=2, maxiter=2,
                                  graph=True, gatol=0.0, grtol=0.0,
                                  fatol=0.0, inftol=0.0, verbose=False)
    torch.cuda.synchronize()
    objs = [h.objective for h in res.history]
    assert res.niter == 2 and np.all(np.isfinite(objs))
    assert objs[-1] < objs[0]
    assert {**streamk.launch_counts(), **stream.launch_counts()} == before


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
        dtype=torch.complex64, linsolve_iters=3, linsolver="split",
        fused=True)
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
        fused_rho=fused_rho, fused=True)


@pytest.mark.cuda
@pytest.mark.parametrize("guards,fused_rho,form", [
    (True, "auto", "rho"), (False, "auto", "superop"), (False, "rho", "rho")])
def test_open_problem_on_card_matches_cpu(cuda, guards, fused_rho, form):
    """An open two-transmon CNOT on the card against the same problem on
    the CPU (plain), both f32: J to 1e-5, gradient to 1e-4 of max; E = 3
    candidates through one launch per direction; with guards, superop
    forced past one thread block runs on the mid streamK pair (1 + 1
    launches) and agrees with the rho route to the same bounds."""
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
        # superop forced past one block: the mid streamK pair takes dim 256
        from quandary_tpu_torch.ops import streamk_mid
        psup = Problem(dataclasses.replace(setup, fused_rho="superop"))
        assert psup.fused_form == "superop" and psup.fused_ok
        assert streamk.uses_mid(psup._plan, psup.ninit, psup._Sr.shape[-1])
        before = streamk_mid.launch_counts()
        (Js, _), gs = psup.build_ensemble_value_and_grad()(Ps, Ps[0])
        after = streamk_mid.launch_counts()
        assert {k: after[k] - before[k] for k in after
                if after[k] != before[k]} == {
            "streamk_mid_fwd_launches": 1, "streamk_mid_bwd_launches": 1}
        assert float((Js - Jc).abs().max()) <= 1e-5 * float(Jc.abs().max())
        assert float((gs - gc).abs().max()) <= 1e-4 * float(gc.abs().max())


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


# ---- the front end on the card (chip_smoke.py phases 22-24) ----

FE_FREQ01 = [4.80595, 4.8601]
FE_CNOT = np.eye(4)
FE_CNOT[2:, 2:] = [[0, 1], [1, 0]]


def _fe_launches(mods):
    out = {}
    for m in mods:
        out.update(m.launch_counts())
    return out


def _pair(module, name):
    """(fwd, bwd) launch counts of one kernel pair."""
    c = module.launch_counts()
    return c[f"{name}_fwd_launches"], c[f"{name}_bwd_launches"]


@pytest.mark.cuda
def test_front_end_single_precision_closed_on_card(cuda, tmp_path):
    """Quandary(precision='single') on the CNOT (a short horizon): simulate
    is one streamk_fwd launch; the device driver's optimization one launch
    of each direction per sweep (the initial sweep, the warm-up chunk and
    every replayed chunk of 10 iterations); the f32 run within 1e-4 of the
    f64 one on the CPU."""
    import math
    from quandary_tpu_torch import Quandary
    favg = sum(FE_FREQ01) / 2
    kw = dict(freq01=FE_FREQ01, Jkl=[0.005], rotfreq=[favg, favg], T=20.0,
              targetgate=FE_CNOT, rand_seed=1234)
    q = Quandary(precision="single", optimizer="device", maxiter=5, **kw)
    assert q._problem(q._build_setup()).fused_form == "streamk"
    streamk.reset_launch_counts()
    r32 = q.simulate(datadir=str(tmp_path / "sim"))
    assert _pair(streamk, "streamk") == (1, 0)
    r64 = Quandary(device="cpu", **kw).simulate(datadir=str(tmp_path / "s64"))
    assert abs(r32[3] - r64[3]) <= 1e-4
    streamk.reset_launch_counts()
    q.optimize(datadir=str(tmp_path / "opt"))
    niter = len(q.optim_hist["Iters"]) - 1
    sweeps = 1 + 10 * (1 + math.ceil(niter / 10))
    assert _pair(streamk, "streamk") == (sweeps, sweeps)


@pytest.mark.cuda
def test_front_end_single_precision_open_on_card(cuda, tmp_path):
    """The guarded open CNOT (N = 9, 16 density matrices) takes the rho
    route: simulate is one rho_fwd launch, each device-driver sweep one
    launch per direction, and the populations keep unit trace."""
    import math
    from quandary_tpu_torch import Quandary
    from quandary_tpu_torch.ops import rho
    favg = sum(FE_FREQ01) / 2
    q = Quandary(Ne=[2, 2], Ng=[1, 1], freq01=FE_FREQ01,
                 rotfreq=[favg, favg], selfkerr=[0.2198, 0.2252],
                 Jkl=[0.005], T=5.0, targetgate=FE_CNOT, rand_seed=1234,
                 T1=[56.0, 56.0], T2=[28.0, 28.0], precision="single",
                 optimizer="device", maxiter=2)
    assert q._problem(q._build_setup()).fused_form == "rho"
    rho.reset_launch_counts()
    r = q.simulate(datadir=str(tmp_path / "sim"))
    assert _pair(rho, "rho") == (1, 0)
    for per in r[5]:
        for pop in per:
            assert np.abs(np.asarray(pop).sum(axis=0) - 1.0).max() <= 1e-4
    rho.reset_launch_counts()
    q.optimize(datadir=str(tmp_path / "opt"))
    niter = len(q.optim_hist["Iters"]) - 1
    sweeps = 1 + 10 * (1 + math.ceil(niter / 10))
    assert _pair(rho, "rho") == (sweeps, sweeps)


@pytest.mark.cuda
def test_trajectory_graph_capture_outlives_a_collected_graph(cuda):
    """A CUDA graph that only a reference cycle keeps alive (as a Problem
    keeps the device optimizer it caches, with its graph) becomes garbage
    while propagate_trajectory captures its CUDA graph, and the collector
    runs at nearly every allocation: the capture must not tear that graph
    down (cudaErrorStreamCaptureInvalidated; in a whole-file run of this
    file it broke test_front_end_single_precision_open_on_card). The
    trajectory equals the eager loop's to the bit."""
    import gc
    from quandary_tpu_torch.ops import solvers
    g = torch.cuda.CUDAGraph()
    y = torch.zeros(8, device="cuda")
    with torch.cuda.graph(g):
        y.add_(1.0)
    g.replay()
    graphs = [g]
    del g
    rng = np.random.default_rng(3)
    A = cuda(rng.normal(size=(N, N)).astype(np.float32) / N)

    def step(x, c):
        if torch.cuda.is_current_stream_capturing() and graphs:
            # the graph's last reference, in a cycle that is garbage at once
            holder = {"graph": graphs.pop()}
            holder["self"] = holder
        return (x @ A) * c[0] + c[1]

    nt = solvers.GRAPH_STEPS + 6
    x0 = cuda(rng.normal(size=(B, N)).astype(np.float32))
    C = cuda(rng.uniform(0.5, 1.0, size=(nt, 2)).astype(np.float32))
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        with torch.no_grad():
            traj = solvers.propagate_trajectory(step, x0, C)
    finally:
        gc.set_threshold(*threshold)
    assert not graphs
    xs = [x0]
    with torch.no_grad():
        for n in range(nt):
            xs.append(step(xs[-1], C[n]))
    assert torch.equal(traj, torch.stack(xs))


@pytest.mark.cuda
def test_front_end_double_precision_plain_on_card(cuda, tmp_path):
    """precision='double' (and every config file) runs off the kernels on
    the card (at this size the time-parallel scan, as on the CPU): no
    route, no kernel launch, the CPU's numbers to 1e-10; forcing the fused
    route in complex128 still raises."""
    from quandary_tpu_torch import Quandary
    from quandary_tpu_torch.ops import rho, stream
    from quandary_tpu_torch.problem import Problem
    favg = sum(FE_FREQ01) / 2
    kw = dict(freq01=FE_FREQ01, Jkl=[0.005], rotfreq=[favg, favg], T=10.0,
              targetgate=FE_CNOT, rand_seed=1234)
    q = Quandary(**kw)
    setup = q._build_setup()
    assert q._problem(setup).fused_form is None
    mods = (streamk, rho, stream)
    before = _fe_launches(mods)
    rc = q.simulate(datadir=str(tmp_path / "card"))
    assert _fe_launches(mods) == before
    rh = Quandary(device="cpu", **kw).simulate(datadir=str(tmp_path / "cpu"))
    assert abs(rc[3] - rh[3]) <= 1e-10
    for a, b in zip(rc[5][0], rh[5][0]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
    with pytest.raises(NotImplementedError, match="complex128"):
        Problem(dataclasses.replace(setup, fused=True))
    # the device driver on the plain route: eager chunks, no kernel
    q.optimizer, q.maxiter = "device", 2
    q.optimize(datadir=str(tmp_path / "opt"))
    assert _fe_launches(mods) == before
    assert len(q.optim_hist["Iters"]) == 3


def _mid_case(cuda, N, B, E, k, iters, solver, store, seed):
    """A random closed streamK launch past one thread block: (plan, C, x0r,
    x0i, w) with a stack of O(1) spectral scale and a stiff diagonal."""
    rng = np.random.default_rng(seed)
    stack = (rng.normal(size=(k, N, N)) + 1j * rng.normal(size=(k, N, N))) \
        / np.sqrt(N)
    stack[0] += np.diag(rng.normal(size=N) * 5.0)
    stack = stack.astype(np.complex64)
    gen_diag = -1j * np.diag(stack[0]).astype(np.complex128)
    plan = streamk.make_plan(cuda(stack.real), cuda(stack.imag), 0.02, iters,
                             gen_diag, solver, store_iters=store)
    C = streamk.extend_coeffs(plan, cuda(
        (rng.normal(size=(E, NT, k)) * 0.5).astype(np.float32)))
    x0r, x0i = (cuda(a) for a in rng.normal(size=(2, B, N)).astype(
        np.float32))
    w = cuda(rng.normal(size=(E, NT, B, N)).astype(np.float32))
    return plan, C, x0r, x0i, w


def _mid_run(fn, plan, C, x0r, x0i, w):
    Cg = C.clone().requires_grad_()
    xr, xi = x0r.clone().requires_grad_(), x0i.clone().requires_grad_()
    xTr, _, hr, hi = fn(plan, xr, xi, Cg)
    (torch.sum(w * hr * hi) + torch.sum(xTr * xTr)).backward()
    torch.cuda.synchronize()
    return hr.detach(), Cg.grad, xr.grad, xi.grad


@pytest.mark.cuda
@pytest.mark.parametrize("N,B,E,solver,iters,store", [
    (64, 8, 1, "split", 3, True), (64, 8, 4, "split", 3, False),
    (64, 3, 2, "jacobi", 4, True), (64, 5, 1, "neumann", 6, False),
    (256, 1, 1, "split", 4, True), (256, 1, 1, "split", 4, False),
    (256, 16, 2, "jacobi", 3, False)])
def test_mid_kernel_matches_plain_on_card(cuda, N, B, E, solver, iters,
                                          store):
    """The mid pair against the plain version on the card, bounds as
    test_kernel_matches_plain_on_card; one launch of each mid kernel and
    none of the one-block pair; a second run gives the same bits."""
    plan, C, x0r, x0i, w = _mid_case(cuda, N, B, E, 5, iters, solver, store,
                                     seed=N + B)
    from quandary_tpu_torch.ops import streamk_mid
    assert plan.store_iters == store and streamk.uses_mid(plan, B, N)
    before = {**streamk.launch_counts(), **streamk_mid.launch_counts()}
    kern = _mid_run(streamk.streamk_propagate_kernel, plan, C, x0r, x0i, w)
    after = {**streamk.launch_counts(), **streamk_mid.launch_counts()}
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved == {"streamk_mid_fwd_launches": 1,
                     "streamk_mid_bwd_launches": 1}
    again = _mid_run(streamk.streamk_propagate_kernel, plan, C, x0r, x0i, w)
    assert all(torch.equal(a, b) for a, b in zip(kern, again))
    plain = _mid_run(streamk.streamk_propagate_plain, plan, C, x0r, x0i, w)
    for a, b, tol in zip(kern, plain, (1e-5, 1e-4, 1e-4, 1e-4)):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def _swap02_mid_setup():
    """Three qubits with two guard levels (N = 64, 8 basis states, split-3,
    40 steps, fused=True)."""
    from quandary_tpu_torch.models import gates
    from quandary_tpu_torch.models.hamiltonian import build_standard_model
    from quandary_tpu_torch.problem import Setup
    from quandary_tpu_torch.utils.splines import (ControlSegment,
                                                  OscillatorControl)
    freq, T, nt = [4.8, 5.0, 5.2], 6.0, 40
    nlevels, Ne = [4, 4, 4], [2, 2, 2]
    model = build_standard_model(
        nlevels=nlevels, freq01_ghz=freq, rotfreq_ghz=freq,
        selfkerr_ghz=[0.22, 0.23, 0.24], jkl_ghz=[0.01, 0.004, 0.01],
        crosskerr_ghz=[])
    oscs = tuple(OscillatorControl(
        segments=(ControlSegment("spline", nsplines=8, tstart=0.0,
                                 tstop=T),), carrier_freqs=(0.0,))
        for _ in range(3))
    setup = Setup(
        model=model, nessential=tuple(Ne), ntime=nt, dt=T / nt,
        oscillators=oscs, ground_freqs_radns=tuple(2 * np.pi * f
                                                   for f in freq),
        initcond_type="basis", target_type="gate",
        target_gate_full=gates.assemble_gate(
            gates.swap_0q(3), nlevels, Ne, [0.0] * 3, T),
        objective_type="Jtrace", gamma_tik=1e-4, gamma_penalty=0.1,
        dtype=torch.complex64, linsolve_iters=3, linsolver="split",
        fused=True)
    return setup


@pytest.mark.cuda
def test_mid_problem_on_card_matches_cpu(cuda):
    """Three qubits with two guard levels (N = 64, 8 basis states, split-3):
    value_and_grad on the card through the mid pair (1 + 1 launches)
    against the same problem on the CPU (plain), both f32: J to 1e-5,
    gradient to 1e-4 of max."""
    from quandary_tpu_torch.ops import streamk_mid
    from quandary_tpu_torch.problem import Problem
    setup = _swap02_mid_setup()
    pc, ph = Problem(setup), Problem(setup, device="cpu")
    assert pc.fused_form == "streamk" and pc.fused_ok
    x = np.random.default_rng(2).uniform(-1, 1, setup.nparams) * 0.02
    before = {**streamk.launch_counts(), **streamk_mid.launch_counts()}
    (Jc, _), gc = pc.build_value_and_grad()(x, x)
    after = {**streamk.launch_counts(), **streamk_mid.launch_counts()}
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved == {"streamk_mid_fwd_launches": 1,
                     "streamk_mid_bwd_launches": 1}
    (Jh, _), gh = ph.build_value_and_grad()(x, x)
    assert abs(float(Jc) - float(Jh)) <= 1e-5 * abs(float(Jh))
    assert float((gc.cpu() - gh).abs().max()) <= 1e-4 * float(gh.abs().max())


# the mid backward's schedules (streamk.bwd_schedule): cases (N, B, E,
# solver, iters) where both fit, the 'helpers' layout in shared memory (N =
# 64, 256, 202: N % 4 != 0, one entry at a time) and read from its ring (N
# = 1024)
MID_SCHEDULE_CASES = [(64, 8, 1, "split", 3), (256, 1, 1, "split", 4),
                      (202, 3, 2, "jacobi", 4), (1024, 1, 1, "neumann", 2)]


def _mid_sched_bwd(plan, C, x0r, x0i, w, schedule, helpers=None):
    """One forward and one backward of the mid pair, the backward on a
    forced schedule (and helper count): (g0r, g0i, Cb) and its shape."""
    from quandary_tpu_torch.ops import streamk_mid
    fwd = streamk_mid._kernel_fwd(plan, x0r, x0i, C)
    hr = fwd[2]
    gT = w[:, -1].contiguous()
    out = streamk_mid._kernel_bwd(plan, x0r, x0i, C, *fwd[2:], gT, gT, w,
                                  w * hr, _schedule=schedule,
                                  _helpers=helpers)
    torch.cuda.synchronize()
    return out, dict(streamk_mid.mid_layouts["bwd"])


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["helpers", "chain"])
@pytest.mark.parametrize("case", MID_SCHEDULE_CASES)
def test_mid_bwd_schedule_matches_plain_on_card(cuda, monkeypatch, case,
                                                schedule):
    """Each backward schedule against the plain version on the card (bounds
    as test_mid_kernel_matches_plain_on_card), stored and replayed
    iterates; one launch of each mid kernel; a second run gives the same
    bits."""
    from quandary_tpu_torch.ops import streamk_mid
    N, B, E, solver, iters = case
    own = streamk_mid._kernel_bwd
    monkeypatch.setattr(streamk_mid, "_kernel_bwd", lambda *a: own(
        *a, _schedule=schedule))
    for store in (True, False):
        plan, C, x0r, x0i, w = _mid_case(cuda, N, B, E, 5, iters, solver,
                                         store, seed=N + B + 1)
        before = {**streamk.launch_counts(), **streamk_mid.launch_counts()}
        kern = _mid_run(streamk.streamk_propagate_kernel, plan, C, x0r, x0i,
                        w)
        after = {**streamk.launch_counts(), **streamk_mid.launch_counts()}
        moved = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        assert moved == {"streamk_mid_fwd_launches": 1,
                         "streamk_mid_bwd_launches": 1}
        assert streamk_mid.mid_layouts["bwd"]["schedule"] == schedule
        again = _mid_run(streamk.streamk_propagate_kernel, plan, C, x0r, x0i,
                         w)
        assert all(torch.equal(a, b) for a, b in zip(kern, again))
        plain = _mid_run(streamk.streamk_propagate_plain, plan, C, x0r, x0i,
                         w)
        for a, b, tol in zip(kern, plain, (1e-5, 1e-4, 1e-4, 1e-4)):
            assert bool(torch.isfinite(a).all())
            assert float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", MID_SCHEDULE_CASES)
def test_mid_bwd_schedules_same_g0_on_card(cuda, case):
    """The two schedules give g0 in the same bits (the chain's arithmetic
    and order are one), C-bar within 2e-5 of its largest entry (summed in
    other orders); the helpers schedule gives the same bits with no helper
    cluster (the chain's CTAs run every tile) and on a repeat."""
    N, B, E, solver, iters = case
    plan, C, x0r, x0i, w = _mid_case(cuda, N, B, E, 5, iters, solver, True,
                                     seed=N + B + 2)
    (g0r, g0i, Cb), shape = _mid_sched_bwd(plan, C, x0r, x0i, w, "helpers")
    assert shape["schedule"] == "helpers" and shape["helpers"] >= 1
    (c0r, c0i, Cc), _ = _mid_sched_bwd(plan, C, x0r, x0i, w, "chain")
    assert torch.equal(g0r, c0r) and torch.equal(g0i, c0i)
    assert float((Cb - Cc).abs().max()) <= 2e-5 * float(Cc.abs().max())
    for helpers in (0, None):
        got, shape = _mid_sched_bwd(plan, C, x0r, x0i, w, "helpers", helpers)
        assert all(torch.equal(a, b) for a, b in zip(got, (g0r, g0i, Cb)))
    assert shape["helpers"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["helpers", "chain"])
@pytest.mark.parametrize("case", [(64, 8, 1, "split", 3),
                                  (256, 1, 1, "split", 4),
                                  (1024, 1, 1, "jacobi", 3)])
def test_mid_bwd_stored_equals_replayed_on_card(cuda, case, schedule):
    """g0 and C-bar in the same bits whether the forward stored its stage
    iterates or the backward replays them, on each schedule (both take one
    launch shape at these sizes)."""
    N, B, E, solver, iters = case
    outs, shapes = [], []
    for store in (True, False):
        plan, C, x0r, x0i, w = _mid_case(cuda, N, B, E, 5, iters, solver,
                                         store, seed=N + 3)
        out, shape = _mid_sched_bwd(plan, C, x0r, x0i, w, schedule)
        outs.append(out)
        shapes.append((shape["G"], shape["Bc"]))
    assert shapes[0] == shapes[1]
    assert all(torch.equal(a, b) for a, b in zip(*outs))


# the mid forward's schedules (streamk.fwd_schedule): the same cases, the
# 'helpers' band copied into shared memory (N = 64, 256, 202: N % 4 != 0,
# the stacks read one entry at a time) and read from its ring in L2 (N =
# 1024); per-sample stacks (each group contracting its own stack)
MID_FWD_CASES = MID_SCHEDULE_CASES + [(200, 4, 2, "split", 3, True)]


def _mid_fwd_case(cuda, case, store, seed):
    N, B, E, solver, iters = case[:5]
    if len(case) > 5:
        return _mid_packed_case(cuda, N, B, E, 5, iters, solver, store, seed)
    return _mid_case(cuda, N, B, E, 5, iters, solver, store, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("case", MID_FWD_CASES)
def test_mid_fwd_helpers_same_bits_on_card(cuda, case):
    """The forward's 'helpers' schedule, with 0 helper clusters (the chain's
    CTAs contract every tile), 1 and the planner's count, gives xT, the
    history and the stored iterates in the bits of 'chain' (one fmaf chain
    per entry of H in k order, the same stage products), stored and
    replayed; the backward's g0 and C-bar from either forward's outputs
    are equal in bits; one launch of the forward each."""
    from quandary_tpu_torch.ops import streamk_mid
    for store in (True, False):
        plan, C, x0r, x0i, w = _mid_fwd_case(cuda, case, store,
                                             seed=case[0] + case[1] + 5)
        ref = streamk_mid._kernel_fwd(plan, x0r, x0i, C, _schedule="chain")
        assert streamk_mid.mid_layouts["fwd"]["schedule"] == "chain"
        for helpers in (0, 1, None):
            before = streamk_mid.launch_counts()
            got = streamk_mid._kernel_fwd(plan, x0r, x0i, C,
                                          _schedule="helpers",
                                          _helpers=helpers)
            torch.cuda.synchronize()
            after = streamk_mid.launch_counts()
            assert sum(after.values()) - sum(before.values()) == 1
            shape = streamk_mid.mid_layouts["fwd"]
            assert shape["schedule"] == "helpers"
            assert shape["helpers"] == (helpers if helpers is not None
                                        else shape["helpers"])
            assert all((a is None and b is None) or torch.equal(a, b)
                       for a, b in zip(got, ref))
        assert shape["helpers"] >= 1
        gT = w[:, -1].contiguous()
        bwd = [streamk_mid._kernel_bwd(plan, x0r, x0i, C, *f[2:], gT, gT, w,
                                       w * f[2]) for f in (ref, got)]
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*bwd))


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["helpers", "chain"])
@pytest.mark.parametrize("case", MID_FWD_CASES)
def test_mid_fwd_schedule_matches_plain_on_card(cuda, monkeypatch, case,
                                                schedule):
    """Each forward schedule under the autograd function against the plain
    version on the card (bounds as test_mid_kernel_matches_plain_on_card);
    one launch of each mid kernel; a second run gives the same bits."""
    from quandary_tpu_torch.ops import streamk_mid
    own = streamk_mid._kernel_fwd
    monkeypatch.setattr(streamk_mid, "_kernel_fwd", lambda *a: own(
        *a, _schedule=schedule))
    plan, C, x0r, x0i, w = _mid_fwd_case(cuda, case, True,
                                         seed=case[0] + case[1] + 6)
    before = {**streamk.launch_counts(), **streamk_mid.launch_counts()}
    kern = _mid_run(streamk.streamk_propagate_kernel, plan, C, x0r, x0i, w)
    after = {**streamk.launch_counts(), **streamk_mid.launch_counts()}
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert sorted(moved.values()) == [1, 1] and len(moved) == 2
    assert streamk_mid.mid_layouts["fwd"]["schedule"] == schedule
    again = _mid_run(streamk.streamk_propagate_kernel, plan, C, x0r, x0i, w)
    assert all(torch.equal(a, b) for a, b in zip(kern, again))
    plain = _mid_run(streamk.streamk_propagate_plain, plan, C, x0r, x0i, w)
    for a, b, tol in zip(kern, plain, (1e-5, 1e-4, 1e-4, 1e-4)):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.cuda
def test_auto_runs_plain_loop_where_the_budget_refuses_on_card(
        cuda, monkeypatch):
    """ROADMAP C2: with streamk.DEVICE_BUDGET_BYTES patched below the N = 64
    problem's sweep, fused='auto' on the card takes the plain loop (no
    kernel launch; fused_refusal names the limit) and agrees with the same
    problem's plain loop on the CPU (J to 1e-5, gradient to 1e-4 of max);
    fused=True raises with the route's message."""
    from quandary_tpu_torch.ops import streamk_mid
    from quandary_tpu_torch.problem import Problem
    # on the sequential loop: 'auto' takes the time-parallel scan at N = 64
    setup = dataclasses.replace(_swap02_mid_setup(), fused="auto",
                                time_parallel=False)
    monkeypatch.setattr(streamk, "DEVICE_BUDGET_BYTES", 1 << 16)
    pa = Problem(setup)
    assert pa.device.type == "cuda" and not pa.use_fused
    assert not pa.time_parallel
    assert pa.fused_form is None and not pa.fused_ok
    assert "DEVICE_BUDGET_BYTES" in pa.fused_refusal
    assert pa.fused_refusal.startswith("fused='auto': ")
    x = np.random.default_rng(2).uniform(-1, 1, setup.nparams) * 0.02
    before = {**streamk.launch_counts(), **streamk_mid.launch_counts()}
    (Ja, _), ga = pa.build_value_and_grad()(x, x)
    torch.cuda.synchronize()
    assert {**streamk.launch_counts(), **streamk_mid.launch_counts()} \
        == before
    ph = Problem(setup, device="cpu")
    assert ph.fused_form is None
    (Jh, _), gh = ph.build_value_and_grad()(x, x)
    assert abs(float(Ja) - float(Jh)) <= 1e-5 * abs(float(Jh))
    assert float((ga.cpu() - gh).abs().max()) <= 1e-4 * float(gh.abs().max())
    with pytest.raises(NotImplementedError, match="DEVICE_BUDGET_BYTES"):
        Problem(dataclasses.replace(setup, fused=True))


# ---- the mid-size streamed-plane pair (csrc/stream_mid.cu) ----

def _stream_mid_counts():
    from quandary_tpu_torch.ops import stream, stream_mid
    return {**streamk.launch_counts(), **stream.launch_counts(),
            **stream_mid.launch_counts()}


def _stream_mid_case(cuda, kind, solver, iters, B, n, E, nt=NT, k=5,
                     store=None, seed=7):
    """A random launch of the streamed-plane member `kind` past one thread
    block on non-Hermitian stacks of norm about 1: (plan, planes pair, x0
    pair, final-state cotangent pair, history cotangent pair)."""
    from quandary_tpu_torch.ops import stream
    rng = np.random.default_rng(seed)
    stack = ((rng.normal(size=(k, n, n)) + 1j * rng.normal(size=(k, n, n)))
             / np.sqrt(n)).astype(np.complex64)
    gen_diag = -1j * np.diag(stack[0]).astype(np.complex128)
    plan = stream.make_plan(cuda(stack.real), DT, iters, gen_diag, solver,
                            kind=kind, store_iters=store)
    C = cuda((rng.normal(size=(E, nt, k)) * 0.3).astype(np.float32))
    H = tuple(h.contiguous() for h in stream.planes(
        plan, cuda(stack.real), cuda(stack.imag), C))
    x0 = tuple(cuda(a) for a in rng.normal(size=(2, B, n)).astype(
        np.float32))
    w = lambda *s: cuda(rng.normal(size=s).astype(np.float32))
    return plan, H, x0, (w(E, B, n), w(E, B, n)), (w(E, nt, B, n),
                                                   w(E, nt, B, n))


def _stream_mid_run(plan, H, x0, gT, jh, layout=None):
    """One launch of each direction of the mid pair (the forward alone for
    dense): (forward outputs, backward outputs or ())."""
    from quandary_tpu_torch.ops import stream_mid
    fwd = stream_mid._kernel_fwd(plan, *H, *x0, _layout=layout)
    bwd = () if plan.kind == "dense" else stream_mid._kernel_bwd(
        plan, *H, *x0, *fwd[2:], *gT, *jh, _layout=layout)
    torch.cuda.synchronize()
    return fwd, bwd


@pytest.mark.cuda
@pytest.mark.parametrize("case,layouts", [
    (dict(kind="stream", solver="split", iters=4, B=1, n=256, E=1),
     ("smem2", "smem2")),
    (dict(kind="stream", solver="split", iters=4, B=1, n=256, E=2,
          store=False), ("smem2", "smem2")),
    (dict(kind="stream", solver="jacobi", iters=4, B=4, n=200, E=1),
     ("smem2", "smem2")),
    (dict(kind="stream", solver="neumann", iters=6, B=16, n=130, E=1),
     ("smem2", "smem2")),
    (dict(kind="stream", solver="split", iters=3, B=1, n=512, E=1),
     ("smem1", "smem1")),
    (dict(kind="stream", solver="split", iters=3, B=1, n=512, E=1,
          store=False), ("smem1", "global")),
    (dict(kind="stream", solver="jacobi", iters=3, B=1, n=512, E=1),
     ("global", "global", "forced")),
    (dict(kind="chunk", solver="neumann", iters=8, B=1, n=300, E=1),
     ("smem2", "smem2")),
    (dict(kind="chunk", solver="neumann", iters=8, B=3, n=1024, E=1, nt=4),
     ("global", "global")),
    (dict(kind="dense", solver="neumann", iters=8, B=1, n=1024, E=1, nt=4),
     ("global",)),
], ids=["stream-split4-N256-stored", "stream-split4-N256-E2-replayed",
        "stream-jacobi4-N200-B4", "stream-neumann6-N130-B16-chunks",
        "stream-split3-N512-stored", "stream-split3-N512-replayed",
        "stream-jacobi3-N512-forced-global", "chunk-N300", "chunk-N1024-B3",
        "dense-N1024"])
def test_stream_mid_matches_plain_on_card(cuda, case, layouts):
    """Each mid entry point against the plain version on the card at the
    layouts the planner gives its shape (or forced 'global'; the backward
    on the planner's schedule and on 'chain' at its layout): xT and the
    history to 1e-5 of max, x0-bar and the plane cotangents to 1e-4 of max;
    one launch of the member's mid kernels and none of the one-block
    pair."""
    from quandary_tpu_torch.ops import stream, stream_mid
    plan, H, x0, gT, jh = _stream_mid_case(cuda, **case)
    assert stream.uses_mid(plan, case["B"], case["n"])
    before = _stream_mid_counts()
    fwd, bwd = _stream_mid_run(plan, H, x0, gT, jh,
                               "global" if "forced" in layouts else None)
    kind = case["kind"]
    want = {f"{kind}_mid_fwd_launches": 1}
    if kind != "dense":
        want[f"{kind}_mid_bwd_launches"] = 1
    assert _moved(before, _stream_mid_counts()) == want
    assert stream_mid.mid_layouts["fwd"]["layout"] == layouts[0]
    hr, hi = stream.plain_forward(plan, *H, *x0)
    ref_f = (hr[:, -1], hi[:, -1]) + (() if kind == "dense" else (hr, hi))
    for a, b in zip(fwd, ref_f):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    if kind == "dense":
        return
    ref_b = stream.plain_backward(plan, *H, *x0, hr, hi, *gT, *jh)
    # the planner's backward schedule above, and 'chain' at its layout
    chain = stream_mid._kernel_bwd(
        plan, *H, *x0, *fwd[2:], *gT, *jh, _schedule="chain",
        _layout="global" if "forced" in layouts else None)
    assert stream_mid.mid_layouts["bwd"]["layout"] == layouts[1]
    for out in (bwd, chain):
        for a, b in zip(out, ref_b):
            assert bool(torch.isfinite(a).all())
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("solver,iters,B,n,layout", [
    ("split", 3, 4, 200, None), ("jacobi", 4, 16, 256, None),
    ("split", 4, 1, 512, "global")])
def test_stream_mid_same_bits_on_card(cuda, solver, iters, B, n, layout):
    """Two launches on the same inputs give the same bits (one writer per
    entry of Hb, each track's chunks in turn, the tracks' partials summed
    in a fixed order), and the
    backward from stored stage iterates the bits of its own replay (the
    forward's chain on the same row band)."""
    runs = {}
    for store in (True, True, False):
        plan, H, x0, gT, jh = _stream_mid_case(cuda, "stream", solver,
                                               iters, B, n, 2, store=store,
                                               seed=5)
        assert plan.store_iters == store
        runs.setdefault(store, []).append(
            _stream_mid_run(plan, H, x0, gT, jh, layout))
    (f1, b1), (f2, b2) = runs[True]
    f3, b3 = runs[False][0]
    for x, y in zip(f1 + b1, f2 + b2):
        assert (x is None and y is None) or torch.equal(x, y)
    for x, y in zip(f1[:4] + b1, f3[:4] + b3):
        assert torch.equal(x, y)


# the backward's schedules (stream.mid_bwd_schedule): stored and replayed,
# 'stream' and 'chunk', the column band in shared memory and (N = 1024, or
# forced) in L2, N % 4 != 0 (the planes read one entry at a time), chunks of
# states on tracks (E = 2, B = 16), the replay's row band in two slots, one
# and L2
STREAM_MID_SCHEDULE_CASES = [
    dict(kind="stream", solver="split", iters=4, B=1, n=256, E=1),
    dict(kind="stream", solver="split", iters=4, B=1, n=256, E=1,
         store=False),
    dict(kind="stream", solver="jacobi", iters=3, B=1, n=512, E=1,
         store=False),
    dict(kind="stream", solver="neumann", iters=6, B=16, n=130, E=2),
    dict(kind="stream", solver="jacobi", iters=4, B=4, n=200, E=1,
         store=False, layout="global"),
    dict(kind="chunk", solver="neumann", iters=8, B=1, n=300, E=1),
    dict(kind="chunk", solver="neumann", iters=8, B=3, n=1024, E=1, nt=6),
]
STREAM_MID_SCHEDULE_IDS = ["split4-N256-stored", "split4-N256-replayed",
                           "jacobi3-N512-replayed", "neumann6-N130-B16-E2",
                           "jacobi4-N200-B4-global", "chunk-N300",
                           "chunk-N1024-B3"]


def _stream_mid_bwd(plan, H, x0, fwd, gT, jh, **kw):
    """One backward launch of the mid pair on forced arguments: (outputs,
    its logged shape, launches moved)."""
    from quandary_tpu_torch.ops import stream_mid
    before = _stream_mid_counts()
    out = stream_mid._kernel_bwd(plan, *H, *x0, *fwd[2:], *gT, *jh, **kw)
    torch.cuda.synchronize()
    return (out, dict(stream_mid.mid_layouts["bwd"]),
            _moved(before, _stream_mid_counts()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", STREAM_MID_SCHEDULE_CASES,
                         ids=STREAM_MID_SCHEDULE_IDS)
def test_stream_mid_bwd_helpers_same_bits_on_card(cuda, case):
    """The backward's 'helpers' schedule (the replay, the pass and the
    column band's transposition on clusters of their own) gives g0 and Hb
    in the bits of 'chain' (the same products in the same order, each
    entry of Hb one fmaf chain in pair then state order) with 0 helper
    clusters (the chain's CTAs run every tile), 1 and the planner's count,
    one launch each, on the planner's tracks and on one track (the chunks
    of states in turn, the first writing Hb, the others adding to it), and
    matches the plain backward to 1e-4 of max."""
    from quandary_tpu_torch.ops import stream, stream_mid
    case = dict(case)
    layout = case.pop("layout", None)
    plan, H, x0, gT, jh = _stream_mid_case(cuda, **case, seed=11)
    fwd = stream_mid._kernel_fwd(plan, *H, *x0)
    key = f"{plan.kind}_mid_bwd_launches"
    for tracks in (None, 1):
        ref, shape, moved = _stream_mid_bwd(plan, H, x0, fwd, gT, jh,
                                            _schedule="chain",
                                            _tracks=tracks)
        assert shape["schedule"] == "chain"
        for helpers in (0, 1, None):
            got, shape, moved = _stream_mid_bwd(
                plan, H, x0, fwd, gT, jh, _schedule="helpers",
                _helpers=helpers, _layout=layout, _tracks=tracks)
            assert moved == {key: 1}
            assert shape["schedule"] == "helpers"
            assert shape["layout"] == ("global" if layout
                                       or case["n"] == 1024 else "smem")
            assert shape["replays"] == int(not plan.store_iters)
            if helpers is not None:
                assert shape["helpers"] == helpers
            assert all(torch.equal(a, b) for a, b in zip(got, ref))
        if case["E"] == case["B"] == 1:     # the card's SMs mostly idle
            assert shape["helpers"] >= 1
    hr, hi = stream.plain_forward(plan, *H, *x0)
    plain = stream.plain_backward(plan, *H, *x0, hr, hi, *gT, *jh)
    for a, b in zip(got, plain):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in STREAM_MID_SCHEDULE_CASES
                                  if c.get("store") is False
                                  or c["kind"] == "chunk"],
                         ids=[i for i, c in zip(STREAM_MID_SCHEDULE_IDS,
                                                STREAM_MID_SCHEDULE_CASES)
                              if c.get("store") is False
                              or c["kind"] == "chunk"])
def test_stream_mid_bwd_replay_handoff_on_card(cuda, case):
    """The replay ring's hand-over: where a replay cluster finds its chain
    not started at step MID_HELP_W (forced here), it ends and the chain
    replays the remaining steps in its own chain: the same bits as 'chain'
    and as the ring, with and without helper clusters, and with the chunks
    of states run in turn on one track (the first writing Hb, the others
    adding to it)."""
    from quandary_tpu_torch.ops import stream, stream_mid
    case = dict(case)
    layout = case.pop("layout", None)
    plan, H, x0, gT, jh = _stream_mid_case(cuda, **case, seed=12)
    assert H[0].shape[1] > stream.MID_HELP_W
    fwd = stream_mid._kernel_fwd(plan, *H, *x0)
    for tracks in (None, 1):
        ref = _stream_mid_bwd(plan, H, x0, fwd, gT, jh, _schedule="chain",
                              _tracks=tracks)[0]
        for helpers in (0, None):
            got, shape, _ = _stream_mid_bwd(
                plan, H, x0, fwd, gT, jh, _schedule="helpers",
                _helpers=helpers, _layout=layout, _tracks=tracks,
                _handoff=True)
            assert shape["schedule"] == "helpers" and shape["replays"] == 1
            assert all(torch.equal(a, b) for a, b in zip(got, ref))


# the forward's band layouts (stream._mid_fwd_shape): two slots (N = 256,
# 130 with N % 4 != 0: rows by cp.async), one and a partial second slot
# (N = 512), resident rows and L2 (N = 1024, 'chunk' and dense), chunks of
# states (B = 16, Bc 8; B = 3, a partial chunk), ragged last bands (N = 200,
# 300)
STREAM_MID_FWD_CASES = [
    dict(kind="stream", solver="split", iters=4, B=1, n=256, E=1),
    dict(kind="stream", solver="jacobi", iters=3, B=1, n=512, E=1),
    dict(kind="stream", solver="neumann", iters=4, B=16, n=130, E=1),
    dict(kind="stream", solver="split", iters=3, B=3, n=200, E=2),
    dict(kind="chunk", solver="neumann", iters=8, B=1, n=300, E=1),
    dict(kind="chunk", solver="neumann", iters=8, B=3, n=1024, E=1, nt=4),
    dict(kind="dense", solver="neumann", iters=8, B=1, n=1024, E=1, nt=4),
]
STREAM_MID_FWD_IDS = ["split4-N256", "jacobi3-N512", "neumann4-N130-B16",
                      "split3-N200-B3-E2", "chunk-N300", "chunk-N1024-B3",
                      "dense-N1024"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", STREAM_MID_FWD_CASES,
                         ids=STREAM_MID_FWD_IDS)
def test_stream_mid_fwd_layouts_same_bits_on_card(cuda, case):
    """The forward in every band layout that fits the shape at the
    planner's G, with 0, R / 4, R / 2, the planner's, R - 1 and R band rows
    past the whole slots where they fit: xT, the history and the stored
    iterates in the bits of the planner's launch (the same products in the
    same order whatever slot or array a row lies in), and the planner's
    within 1e-5 x max of plain."""
    from quandary_tpu_torch.ops import stream, stream_mid
    plan, H, x0, _, _ = _stream_mid_case(cuda, **case, seed=17)
    ref = stream_mid._kernel_fwd(plan, *H, *x0)
    torch.cuda.synchronize()
    G = stream_mid.mid_layouts["fwd"]["G"]
    hr, hi = stream.plain_forward(plan, *H, *x0)
    want = (hr[:, -1], hi[:, -1]) + (() if plan.kind == "dense" else (hr, hi))
    for a, b in zip(ref, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    R, seen = -(-case["n"] // G), []
    for layout in stream.MID_SLOTS:
        for rows in (0, R // 4, R // 2, None, R - 1, R):
            try:
                out = stream_mid._kernel_fwd(plan, *H, *x0, _layout=layout,
                                             _rows=rows)
            except NotImplementedError:
                continue
            torch.cuda.synchronize()
            shape = stream_mid.mid_layouts["fwd"]
            assert shape["G"] == G and shape["layout"] == layout
            seen.append((layout, shape["rows"]))
            for a, b in zip(out, ref):
                assert (a is None and b is None) or torch.equal(a, b)
    assert len(seen) >= 3, seen


@pytest.mark.cuda
@pytest.mark.parametrize("case", STREAM_MID_FWD_CASES[:4],
                         ids=STREAM_MID_FWD_IDS[:4])
@pytest.mark.parametrize("schedule", ["helpers", "chain"])
def test_stream_mid_fwd_stored_equal_replayed_on_card(cuda, case, schedule):
    """The forward's stored stage iterates are the ones each backward
    schedule replays: the backward from them gives g0 and Hb in the bits of
    the backward that replays them, on 'helpers' and on 'chain', and the
    two forwards the same xT and history."""
    from quandary_tpu_torch.ops import stream_mid
    out = {}
    for store in (True, False):
        plan, H, x0, gT, jh = _stream_mid_case(cuda, **case, store=store,
                                               seed=19)
        assert plan.store_iters == store
        fwd = stream_mid._kernel_fwd(plan, *H, *x0)
        bwd = stream_mid._kernel_bwd(plan, *H, *x0, *fwd[2:], *gT, *jh,
                                     _schedule=schedule)
        torch.cuda.synchronize()
        out[store] = (fwd[:4], bwd)
    for a, b in zip(out[True][0] + out[True][1],
                    out[False][0] + out[False][1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_stream_mid_fwd_full_card_on_card(cuda):
    """E = 8 at N = 256 (8 clusters of 16 CTAs: 128 of the 132 SMs): each
    candidate's xT, history and stored iterates in the bits of its launch
    alone (clusters never wait on each other), and within 1e-5 x max of
    plain."""
    from quandary_tpu_torch.ops import stream, stream_mid
    plan, H, x0, _, _ = _stream_mid_case(cuda, "stream", "split", 4, 1, 256,
                                         8, seed=23)
    full = stream_mid._kernel_fwd(plan, *H, *x0)
    torch.cuda.synchronize()
    assert stream_mid.mid_layouts["fwd"]["ctas"] == 128
    hr, hi = stream.plain_forward(plan, *H, *x0)
    for a, b in zip(full, (hr[:, -1], hi[:, -1], hr, hi)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    for e in (0, 5, 7):
        one = stream_mid._kernel_fwd(
            plan, *(h[e:e + 1].contiguous() for h in H), *x0)
        for a, b in zip(full, one):
            assert torch.equal(a[e:e + 1], b)


@pytest.mark.cuda
def test_stream_mid_bwd_planner_on_card(cuda):
    """The planner's backward schedule from the card's count of clusters:
    'helpers' with a replay cluster and helper clusters at B = 1 (N = 256,
    replayed; the card's SMs mostly idle), 'chain' at B = 256 (the card
    full); the launch gives the bits of the other schedule forced."""
    from quandary_tpu_torch.ops import stream_mid
    for B, want in ((1, "helpers"), (256, "chain")):
        plan, H, x0, gT, jh = _stream_mid_case(cuda, "stream", "split", 4, B,
                                               256, 1, store=False, seed=13)
        fwd = stream_mid._kernel_fwd(plan, *H, *x0)
        got, shape, _ = _stream_mid_bwd(plan, H, x0, fwd, gT, jh)
        assert shape["schedule"] == want
        if want == "helpers":
            assert shape["replays"] == 1 and shape["helpers"] >= 1
        other = _stream_mid_bwd(plan, H, x0, fwd, gT, jh, _schedule={
            "helpers": "chain", "chain": "helpers"}[want])[0]
        assert all(torch.equal(a, b) for a, b in zip(got, other))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["stream", "chunk"])
def test_stream_mid_problem_on_card_matches_cpu(cuda, mode):
    """Two 16-level qudits (N = 256, pure state, 20 steps) on the 'stream'
    (split-4) and 'chunk' (plain Neumann) routes past one block:
    value_and_grad on the card through the mid pair (1 + 1 launches, no
    other kernel) against the same problem on the CPU (plain), both f32:
    J to 1e-5, gradient to 1e-4 of max."""
    from quandary_tpu_torch.problem import Problem
    setup = _qudits256_setup(mode)
    pc, ph = Problem(setup), Problem(setup, device="cpu")
    assert pc.fused_form == mode and pc.fused_ok
    x = np.random.default_rng(2).uniform(-1, 1, setup.nparams) * 0.02
    before = _stream_mid_counts()
    (Jc, _), gc = pc.build_value_and_grad()(x, x)
    assert _moved(before, _stream_mid_counts()) == {
        f"{mode}_mid_fwd_launches": 1, f"{mode}_mid_bwd_launches": 1}
    (Jh, _), gh = ph.build_value_and_grad()(x, x)
    assert abs(float(Jc) - float(Jh)) <= 1e-5 * abs(float(Jh))
    assert float((gc.cpu() - gh).abs().max()) <= 1e-4 * float(gh.abs().max())


def _qudits256_setup(mode, ntime=20):
    """Two 16-level qudits (N = 256, scripts/perf/midsize_bench.py's physics)
    from the ground state to a random state, cut to `ntime` steps: split-4
    on 'stream' over 2 ns; plain Neumann-8 on 'chunk' over 0.02 ns, where
    dt/2 |d|max = 0.15 (|d|max = 293.6 rad/ns) keeps the series accurate."""
    from quandary_tpu_torch.models.hamiltonian import build_standard_model
    from quandary_tpu_torch.problem import Setup
    from quandary_tpu_torch.utils.splines import (ControlSegment,
                                                  OscillatorControl)
    nlevels, freq = [16, 16], [4.80595, 4.8601]
    T = 2.0 if mode == "stream" else 0.02
    model = build_standard_model(
        nlevels=nlevels, freq01_ghz=freq, rotfreq_ghz=freq,
        selfkerr_ghz=[0.2198, 0.2252], jkl_ghz=[0.005], crosskerr_ghz=[])
    oscs = tuple(OscillatorControl(
        segments=(ControlSegment("spline", nsplines=6, tstart=0.0,
                                 tstop=T),), carrier_freqs=(0.0,))
        for _ in range(2))
    v = np.random.default_rng(42).normal(size=(2, 256))
    v = v[0] + 1j * v[1]
    return Setup(model=model, nessential=tuple(nlevels), ntime=ntime,
                 dt=T / ntime, oscillators=oscs,
                 ground_freqs_radns=tuple(2 * np.pi * f for f in freq),
                 initcond_type="pure", target_type="state",
                 target_state_full=v / np.linalg.norm(v),
                 objective_type="Jtrace", gamma_tik=1e-4,
                 dtype=torch.complex64, fused=True, fused_mode=mode,
                 linsolve_iters=4 if mode == "stream" else 8,
                 linsolver="split" if mode == "stream" else "neumann")


# ---- the mid-size density-matrix pair (csrc/rho_mid.cu, 64 < N <= 128) ----

def _rho_mid_counts():
    from quandary_tpu_torch.ops import rho, rho_mid
    return {**rho.launch_counts(), **rho_mid.launch_counts()}


def _moved(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


# N = 65 runs bands of 4 and 5 rows on 16 CTAs, N = 96 of 6, N = 125 of 7
# and 8, N = 128 of 8; all 2 x 2 tiles
@pytest.mark.cuda
@pytest.mark.parametrize("n,njump", [(65, 4), (96, 4), (125, 6), (128, 2)])
@pytest.mark.parametrize("solver,iters", [("neumann", 3), ("jacobi", 4),
                                          ("split", 3)])
def test_rho_mid_kernel_matches_plain_on_card(cuda, solver, iters, n, njump):
    """The mid pair against the plain version on the card, stored and
    replayed stage iterates, bounds as test_rho_kernel_matches_plain_on_card;
    one launch of each mid kernel and none of csrc/rho.cu's. The replayed
    backward on both of its schedules ('split': the replay on clusters of
    its own, 'chain': in the adjoint's chain) against the plain backward on
    random cotangents, the two equal to the bit (the stored iterates' bits
    too)."""
    from quandary_tpu_torch.ops import rho, rho_mid
    rng = np.random.default_rng(n + njump)
    stack, Ls, gd = _random_open_system(rng, n, 3, njump)
    f32 = lambda a: cuda(np.asarray(a, dtype=np.float32))
    plan = rho.make_plan(f32(stack.real), f32(stack.imag), Ls, 0.05, iters,
                         gd, solver)
    assert rho.uses_mid(n, 3, njump, 1, B) and plan.St is not None
    C = f32(rng.normal(size=(1, NT, 3)) * 0.5)
    x0 = rng.normal(size=(2, B, n, n)) / np.sqrt(n)
    wh = f32(rng.normal(size=(1, NT, B, n, n)))
    wT = f32(rng.normal(size=(1, B, n, n)))

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
        before = _rho_mid_counts()
        try:
            assert rho_mid.stores_iterates(plan, 1, NT, B) == (budget > 0)
            kern = run(rho.rho_propagate_kernel)
        finally:
            rho.KS_BUDGET_BYTES = saved
        assert _moved(before, _rho_mid_counts()) == {
            "rho_mid_fwd_launches": 1, "rho_mid_bwd_launches": 1}
        for a, b, tol in zip(kern, plain, (1e-5, 1e-5, 1e-5, 1e-4, 1e-4,
                                           1e-4)):
            assert bool(torch.isfinite(a).all())
            assert float((a - b).abs().max()) <= tol * float(b.abs().max())
    got = {}
    for store in (True, False):
        args, plain_b = _rho_bwd_case(cuda, n, njump, solver, iters, store,
                                      seed=n)
        for sched in (("store",) if store else ("split", "chain")):
            before = _rho_mid_counts()
            got[sched] = rho_mid._kernel_bwd(*args, _schedule=sched)
            torch.cuda.synchronize()
            assert _moved(before, _rho_mid_counts()) == {
                "rho_mid_bwd_launches": 1}
            assert rho_mid.mid_layouts["bwd"]["schedule"] == sched
            for a, b in zip(got[sched], plain_b):
                assert bool(torch.isfinite(a).all())
                assert float((a - b).abs().max()) \
                    <= 1e-4 * float(b.abs().max())
    for sched in ("split", "chain"):
        for a, b in zip(got[sched], got["store"]):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,njump,solver,iters", [
    (72, 6, "jacobi", 6), (125, 6, "split", 3), (128, 4, "jacobi", 6)])
def test_rho_mid_same_bits_across_clusters_on_card(cuda, n, njump, solver,
                                                   iters):
    """The mid pair on clusters of 4, 8 and 16 CTAs per density matrix:
    xT, hist, the stored iterates and g0 equal to the bit across G and on
    a repeat, Cb within 1e-6 of max across G (its cross-CTA sum changes
    order with G) and equal on a repeat; the forward's also across its
    layouts at G = 16 (one jump first factor at a time, the jump bands
    read from L2, 4 rows a thread); stored
    and replayed iterates give the same bits of g0 and Cb; both directions
    within test_rho_fwd_cluster_sizes_on_card's bounds of the plain
    version."""
    from quandary_tpu_torch.ops import rho, rho_mid
    plan, x0r, x0i, C, rng = _rho_inputs(cuda, n, njump, solver, iters, 1, 9)
    f32 = lambda a: cuda(np.asarray(a, dtype=np.float32))
    gT = f32(rng.normal(size=(1, B, n, n)))
    jh = f32(rng.normal(size=(1, NT, B, n, n)))
    plain_f = rho.plain_forward(plan, x0r, x0i, C)
    fwd, bwd = {}, {}
    for G in (4, 8, 16):
        before = rho_mid.rho_mid_fwd_launches
        fwd[G] = rho._kernel_fwd(plan, x0r, x0i, C, _cluster=G)
        assert rho_mid.rho_mid_fwd_launches - before == 1
        assert rho_mid.mid_layouts["fwd"]["G"] == G
        out = fwd[G]
        bwd[G] = rho._kernel_bwd(plan, x0r, x0i, C, *out[2:], gT, gT, jh, jh,
                                 _cluster=G)
        torch.cuda.synchronize()
        assert out[4] is not None and out[4].shape == (1, B, NT, iters, n, n)
        for a, b in zip(out, fwd[4]):
            assert torch.equal(a, b)
        assert torch.equal(bwd[G][0], bwd[4][0])
        assert torch.equal(bwd[G][1], bwd[4][1])
        assert float((bwd[G][2] - bwd[4][2]).abs().max()) \
            <= 1e-6 * float(bwd[4][2].abs().max())
    again = rho._kernel_fwd(plan, x0r, x0i, C)
    for a, b in zip(again, fwd[rho_mid.mid_layouts["fwd"]["G"]]):
        assert torch.equal(a, b)
    for lay in (dict(jb=1), dict(lres=0), dict(tile=4)):
        out = rho_mid._kernel_fwd(plan, x0r, x0i, C, _cluster=16,
                                  _layout=lay)
        assert all(rho_mid.mid_layouts["fwd"][k] == v for k, v in lay.items())
        for a, b in zip(out, fwd[4]):
            assert torch.equal(a, b)
    hr, hi, ksr, ksi = again[2:]
    stored = rho._kernel_bwd(plan, x0r, x0i, C, hr, hi, ksr, ksi, gT, gT, jh,
                             jh)
    replayed = rho._kernel_bwd(plan, x0r, x0i, C, hr, hi, None, None, gT, gT,
                               jh, jh)
    repeat = rho._kernel_bwd(plan, x0r, x0i, C, hr, hi, None, None, gT, gT,
                             jh, jh)
    for x, y, z in zip(stored, replayed, repeat):
        assert torch.equal(x, y) and torch.equal(y, z)
    # both schedules of the replay at G = 8 and 16: the stored iterates' bits
    for G in (8, 16):
        st = rho._kernel_bwd(plan, x0r, x0i, C, hr, hi, ksr, ksi, gT, gT, jh,
                             jh, _cluster=G)
        for sched in ("split", "chain"):
            rp = rho_mid._kernel_bwd(plan, x0r, x0i, C, hr, hi, None, None,
                                     gT, gT, jh, jh, _cluster=G,
                                     _schedule=sched)
            assert rho_mid.mid_layouts["bwd"]["G"] == G
            for x, y in zip(st, rp):
                assert torch.equal(x, y)
    for a, b in zip(fwd[16][2:4], plain_f):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-6 * max(1.0, float(
            b.abs().max()))
    plain_b = rho.plain_backward(plan, x0r, x0i, C, hr, hi, gT, gT, jh, jh)
    for a, b in zip(stored, plain_b):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
def test_rho_mid_fwd_wide_on_card(cuda):
    """The forward at E B = 24 (8 candidates, 3 matrices, N = 125, six
    jump operators): the planner's clusters of 4 CTAs, 4 rows a thread,
    the jump bands read from L2; xT and hist against the plain version
    within test_rho_mid_kernel_matches_plain_on_card's bounds (1e-5 of
    max), xT the history's last step to the bit, one launch."""
    from quandary_tpu_torch.ops import rho, rho_mid
    plan, x0r, x0i, C, _ = _rho_inputs(cuda, 125, 6, "jacobi", 6, 8, 11)
    assert C.shape[0] * B == 24
    before = rho_mid.rho_mid_fwd_launches
    got = rho._kernel_fwd(plan, x0r, x0i, C)
    torch.cuda.synchronize()
    assert rho_mid.rho_mid_fwd_launches - before == 1
    lay = rho_mid.mid_layouts["fwd"]
    assert (lay["G"], lay["tile"], lay["lres"]) == (4, 4, 0)
    plain = rho.plain_forward(plan, x0r, x0i, C)
    for a, b in zip(got[2:4], plain):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert torch.equal(got[0], got[2][:, -1]) and torch.equal(got[1],
                                                             got[3][:, -1])


@pytest.mark.cuda
def test_rho_mid_split_past_what_the_card_holds_on_card(cuda):
    """The 'split' schedule at E B = 24 (8 candidates, 3 matrices) on
    clusters of 16 CTAs: its 48 clusters do not all fit the card at once,
    so clusters start as others end and a replay whose adjoint has not
    started hands its steps over. It finishes (a hand-off wait that outlasts
    20 s traps: the launch fails instead of holding the card), within a
    minute here, and matches the plain backward to 1e-4 of max and the
    'chain' schedule to the bit."""
    import time
    from quandary_tpu_torch.ops import rho_mid
    args, plain = _rho_bwd_case(cuda, 125, 6, "jacobi", 6, False, E=8)
    plan, E, B = args[0], args[3].shape[0], args[1].shape[0]
    assert E * B == 24
    lib = rho_mid._lib()
    shape = rho_mid.launch_shape(lib, True, plan, E, B, 16)
    assert rho_mid.holds(lib, True, shape) < 2 * E * B
    t0 = time.perf_counter()
    split = rho_mid._kernel_bwd(*args, _cluster=16, _schedule="split")
    torch.cuda.synchronize()
    assert time.perf_counter() - t0 < 60.0
    assert rho_mid.mid_layouts["bwd"]["clusters"] == 48
    assert rho_mid.mid_layouts["bwd"]["ring"] == 2
    chain = rho_mid._kernel_bwd(*args, _cluster=16, _schedule="chain")
    for a, b, c in zip(split, chain, plain):
        assert torch.equal(a, b)
        assert bool(torch.isfinite(a).all())
        assert float((a - c).abs().max()) <= 1e-4 * float(c.abs().max())


def _open_mid_setup(nlevels=(9, 8), ntime=20, fused=True):
    """Two qudits with T1/T2 collapse (N = 72), '3states' initial
    conditions, a random pure target state and jacobi with 6 iterations:
    rho_bench's N = 64 system with one more level, cut to `ntime` steps."""
    from quandary_tpu_torch.models.hamiltonian import build_standard_model
    from quandary_tpu_torch.problem import Setup
    from quandary_tpu_torch.utils.splines import (ControlSegment,
                                                  OscillatorControl)
    freq = [4.80595, 4.8601]
    model = build_standard_model(
        nlevels=list(nlevels), freq01_ghz=freq, rotfreq_ghz=freq,
        selfkerr_ghz=[0.2198, 0.2252], jkl_ghz=[0.005], crosskerr_ghz=[],
        decay_time=[80.0, 90.0], dephase_time=[40.0, 45.0], lindblad=True)
    dt = 0.1
    oscs = tuple(OscillatorControl(
        segments=(ControlSegment("spline", nsplines=6, tstart=0.0,
                                 tstop=ntime * dt),), carrier_freqs=(0.0,))
        for _ in nlevels)
    N = int(np.prod(nlevels))
    rng = np.random.default_rng(42)
    tgt = rng.normal(size=N) + 1j * rng.normal(size=N)
    tgt = tgt / np.linalg.norm(tgt)
    return Setup(
        model=model, nessential=tuple(nlevels), ntime=ntime, dt=dt,
        oscillators=oscs, ground_freqs_radns=tuple(2 * np.pi * f
                                                   for f in freq),
        initcond_type="3states", target_type="state",
        target_state_full=np.outer(tgt, tgt.conj()), objective_type="Jtrace",
        gamma_tik=1e-4, dtype=torch.complex64, linsolve_iters=6,
        fused=fused)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, "auto"])
def test_rho_mid_problem_on_card_matches_cpu(cuda, fused):
    """An open N = 72 problem on the rho route: one launch of each mid
    kernel per value_and_grad sweep and none of csrc/rho.cu's, J to 1e-5
    and the gradient to 1e-4 of max of the same problem on the CPU
    (plain, f32)."""
    from quandary_tpu_torch.problem import Problem
    setup = _open_mid_setup(fused=fused)
    pc, ph = Problem(setup), Problem(setup, device="cpu")
    assert pc.fused_form == "rho" and pc.fused_ok and pc.N == 72
    x = np.random.default_rng(2).uniform(-1, 1, setup.nparams) * 0.02
    before = _rho_mid_counts()
    (Jc, _), gc = pc.build_value_and_grad()(x, x)
    assert _moved(before, _rho_mid_counts()) == {
        "rho_mid_fwd_launches": 1, "rho_mid_bwd_launches": 1}
    (Jh, _), gh = ph.build_value_and_grad()(x, x)
    assert abs(float(Jc) - float(Jh)) <= 1e-5 * abs(float(Jh))
    assert float((gc.cpu() - gh).abs().max()) <= 1e-4 * float(gh.abs().max())


# ---- per-sample stacks and the open superop route past one block ----

MIDP = ("streamk_mid_packed_fwd_launches", "streamk_mid_packed_bwd_launches")


def _mid_packed_case(cuda, N, B, S, k, iters, solver, store, seed):
    """A random packed launch past one thread block: S candidates, each
    with its own non-Hermitian (k, N, N) stack (O(1) spectral scale, a
    stiff diagonal) and solver rows; (plan, C, x0r, x0i, w)."""
    rng = np.random.default_rng(seed)
    stack = (rng.normal(size=(S, k, N, N))
             + 1j * rng.normal(size=(S, k, N, N))) / np.sqrt(N)
    for s in range(S):
        stack[s, 0] += np.diag(rng.normal(size=N) * 5.0)
    stack = stack.astype(np.complex64)
    gen_diag = -1j * np.stack([np.diag(a[0]) for a in stack]).astype(
        np.complex128)
    plan = streamk.make_plan(cuda(stack.real), cuda(stack.imag), 0.02, iters,
                             gen_diag, solver, store_iters=store)
    C = streamk.extend_coeffs(plan, cuda(
        (rng.normal(size=(S, NT, k)) * 0.5).astype(np.float32)))
    x0r, x0i = (cuda(a) for a in rng.normal(size=(2, B, N)).astype(
        np.float32))
    w = cuda(rng.normal(size=(S, NT, B, N)).astype(np.float32))
    return plan, C, x0r, x0i, w


@pytest.mark.cuda
@pytest.mark.parametrize("N,B,S,solver,iters", [
    (64, 8, 2, "split", 3), (64, 3, 3, "jacobi", 4),
    (200, 4, 2, "neumann", 4), (200, 1, 3, "split", 3)])
def test_mid_per_block_matches_plain_on_card(cuda, N, B, S, solver, iters):
    """The mid pair on per-candidate stacks (a packed plan past one block)
    against the plain version, bounds as test_mid_kernel_matches_plain_on_
    card; one launch of each packed mid kernel and none of another; the
    same bits on a repeat and between stored and replayed iterates."""
    from quandary_tpu_torch.ops import streamk_mid
    runs = {}
    for store in (True, False):
        plan, C, x0r, x0i, w = _mid_packed_case(cuda, N, B, S, 5, iters,
                                                solver, store, seed=N + B + S)
        assert plan.per_block and plan.store_iters == store
        assert streamk.uses_mid(plan, B, N)
        before = {**streamk.launch_counts(), **streamk_mid.launch_counts()}
        kern = _mid_run(streamk.streamk_propagate_kernel, plan, C, x0r, x0i,
                        w)
        after = {**streamk.launch_counts(), **streamk_mid.launch_counts()}
        assert {k: after[k] - before[k] for k in after
                if after[k] != before[k]} == {MIDP[0]: 1, MIDP[1]: 1}
        again = _mid_run(streamk.streamk_propagate_kernel, plan, C, x0r, x0i,
                         w)
        assert all(torch.equal(a, b) for a, b in zip(kern, again))
        runs[store] = kern
    assert all(torch.equal(a, b) for a, b in zip(runs[True], runs[False]))
    plain = _mid_run(streamk.streamk_propagate_plain, plan, C, x0r, x0i, w)
    for a, b, tol in zip(runs[True], plain, (1e-5, 1e-4, 1e-4, 1e-4)):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.cuda
def test_superop_streamk_past_one_block_matches_stream_on_card(cuda):
    """The guarded open CNOT (dim 256, 4 density matrices) forced onto
    superop: on 'streamk' the mid pair runs it (1 + 1 launches), and J and
    the gradient of E = 2 candidates agree with superop on 'stream'
    (csrc/stream_mid.cu) to 1e-6 / 1e-5 of max."""
    from quandary_tpu_torch.ops import streamk_mid
    from quandary_tpu_torch.problem import Problem
    setup = _open_cnot(True, "superop")
    pk = Problem(setup)
    ps = Problem(dataclasses.replace(setup, fused_mode="stream"))
    assert pk.fused_form == ps.fused_form == "superop"
    assert pk.fused_ok and pk.fused_refusal is None
    Ps = np.random.default_rng(4).uniform(-1, 1, (2, setup.nparams)) * 0.05
    before = streamk_mid.launch_counts()
    (Jk, _), gk = pk.build_ensemble_value_and_grad()(Ps, Ps[0])
    after = streamk_mid.launch_counts()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {"streamk_mid_fwd_launches": 1,
                                          "streamk_mid_bwd_launches": 1}
    (Js, _), gs = ps.build_ensemble_value_and_grad()(Ps, Ps[0])
    assert float((Jk - Js).abs().max()) <= 1e-6 * float(Js.abs().max())
    assert float((gk - gs).abs().max()) <= 1e-5 * float(gs.abs().max())


def _open_samples(device, nlevels, deltas, ntime=20, T=2.0):
    """Open detuned realizations (T1, T2 on every qudit, all basis density
    matrices of two essential levels per qudit), complex64, fused=True."""
    from quandary_tpu_torch.optim.robust import sample_standard_models
    from quandary_tpu_torch.utils.splines import (ControlSegment,
                                                  OscillatorControl)
    n = len(nlevels)
    freq = [4.1 + 0.2 * q for q in range(n)]
    oscs = tuple(OscillatorControl(
        segments=(ControlSegment("spline", nsplines=8, tstart=0.0,
                                 tstop=T),), carrier_freqs=(0.0,))
        for _ in range(n))
    common = dict(
        nessential=(2,) * n, ntime=ntime, dt=T / ntime, oscillators=oscs,
        ground_freqs_radns=tuple(2 * np.pi * f for f in freq),
        initcond_type="basis", target_type="pure",
        pure_target_levels=(1,) + (0,) * (n - 1), objective_type="Jtrace",
        gamma_tik=1e-6, dtype=torch.complex64, gamma_penalty=0.05,
        gamma_penalty_energy=0.02, fused=True)
    base = dict(nlevels=list(nlevels), freq01_ghz=freq, rotfreq_ghz=freq,
                selfkerr_ghz=[0.2] * n, jkl_ghz=[0.005] * (n * (n - 1) // 2),
                decay_time=[40.0] * n, dephase_time=[20.0] * n, lindblad=True)
    return sample_standard_models(
        base, [{"freq01_ghz": [f + d for f in freq]} for d in deltas], common,
        device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("nlevels,deltas,mid", [
    ((3,), (0.0, 0.002, -0.003), False), ((2, 2, 2), (0.0, 0.002), True)])
def test_open_packed_robust_on_card_matches_cpu(cuda, nlevels, deltas, mid):
    """build_packed_robust_objective on open samples on the card: a qutrit
    (dim 9, 4 density matrices) on one block, three qubits (dim 64, 64
    density matrices) on the mid pair; one launch of each packed kernel
    per gradient; J, aux and gradient against the per-sample objective on
    the card and the packed one on the CPU (f32, 1e-5 / 1e-4 of max)."""
    from quandary_tpu_torch.ops import streamk_mid
    from quandary_tpu_torch.optim import robust
    w = np.linspace(1.0, 2.0, len(deltas))
    pc = _open_samples(None, nlevels, deltas)
    ph = _open_samples("cpu", nlevels, deltas)
    x = (np.random.default_rng(1).normal(size=pc[0].setup.nparams)
         * 0.05).astype(np.float32)

    def vg(objective, device):
        xt = torch.tensor(x, device=device, requires_grad=True)
        J, aux = objective(xt, torch.zeros_like(xt))
        (g,) = torch.autograd.grad(J, xt)
        return J.detach().cpu(), g.cpu(), aux

    counts = lambda: {**streamk.launch_counts(),
                      **streamk_mid.launch_counts()}
    before = counts()
    Jc, gc, auxc = vg(robust.build_packed_robust_objective(pc, w), "cuda")
    after = counts()
    want = MIDP if mid else ("streamk_packed_fwd_launches",
                             "streamk_packed_bwd_launches")
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {want[0]: 1, want[1]: 1}
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


def _grouped_setup(dtype, nlevels=(8, 8, 8, 8), ntime=6, T=0.3):
    """A closed standard model on the grouped engine (the construction of
    scripts/perf/nlevels_32_32_32_32.cfg at 8 levels: four transmons,
    crosskerr and Jkl on every pair, |1000> to |0000>, stiff enough that
    the guard picks 'split')."""
    from quandary_tpu_torch.ops.tensor_rhs import build_structured_model
    from quandary_tpu_torch.problem import Setup
    from quandary_tpu_torch.utils.splines import (ControlSegment,
                                                  OscillatorControl)
    f = [4.1, 4.2, 4.3, 4.4]
    model = build_structured_model(
        nlevels=list(nlevels), freq01_ghz=f, rotfreq_ghz=f,
        selfkerr_ghz=[0.2] * 4, crosskerr_ghz=[0.001] * 6,
        jkl_ghz=[0.001] * 6)
    oscs = tuple(OscillatorControl(
        segments=(ControlSegment("spline", nsplines=5, tstart=0.0,
                                 tstop=T),),
        carrier_freqs=(0.0, -0.2 * 2 * np.pi)) for _ in range(4))
    return Setup(model=model, nessential=tuple(nlevels), ntime=ntime,
                 dt=T / ntime, oscillators=oscs,
                 ground_freqs_radns=tuple(2 * np.pi * x for x in f),
                 initcond_type="pure", pure_levels=(1, 0, 0, 0),
                 target_type="pure", pure_target_levels=(0, 0, 0, 0),
                 dtype=dtype, linsolve_iters=20, engine="grouped")


@pytest.mark.cuda
def test_float32_products_are_full_f32_on_card(cuda):
    """The structured engines' products run in full f32, as the reference
    pins jax_default_matmul_precision='highest': no TF32. A product of
    random 1024 x 1024 matrices stays within 1e-5 of max of its f64 value
    (a TF32 product errs by about 5e-4 relative)."""
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=(1024, 1024)) for _ in range(2))
    got = (cuda(a).float() @ cuda(b).float()).double().cpu().numpy()
    want = a @ b
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.cuda
def test_grouped_f32_matches_f64_on_card(cuda):
    """The grouped engine at nlevels [8, 8, 8, 8] (m1 x m2 = 64 x 64) on the
    card: the hand-written adjoint's J and gradient in complex64 against
    complex128, J within 1e-5 relative and the gradient within 1e-3 of
    max, and the complex64 'reversible-ad' gradient against the
    hand-written one within 1e-4 of max."""
    from quandary_tpu_torch.problem import Problem
    out = {}
    for dtype, adj in ((torch.complex64, "auto"),
                       (torch.complex128, "auto"),
                       (torch.complex64, "reversible-ad")):
        p = Problem(dataclasses.replace(_grouped_setup(dtype), adjoint=adj))
        assert type(p.engine).__name__ == "GroupedEngine"
        assert p.linsolver == "split" and not p.use_fused
        x = np.random.default_rng(1).uniform(-1, 1, p.setup.nparams) * 0.01
        x = x.astype(np.float32).astype(np.float64)
        (J, _), g = p.build_value_and_grad()(x, x)
        out[dtype, adj] = (float(J), g.double().cpu())
    (J32, g32), (J64, g64), (Jad, gad) = out.values()
    assert abs(J32 - J64) <= 1e-5 * abs(J64)
    assert (g32 - g64).abs().max() <= 1e-3 * g64.abs().max()
    assert (g32 - gad).abs().max() <= 1e-4 * gad.abs().max()


def _flagship_setup():
    """The CNOT flagship of bench.py:59-93 at full width (N = 16, B = 4,
    1221 steps, split-3, complex64) on the fused route."""
    from quandary_tpu_torch.models import gates
    from quandary_tpu_torch.models.hamiltonian import build_standard_model
    from quandary_tpu_torch.problem import Setup
    from quandary_tpu_torch.utils.splines import (ControlSegment,
                                                  OscillatorControl)
    freq, kerr, T, ntime = [4.80595, 4.8601], [0.2198, 0.2252], 200.0, 1221
    model = build_standard_model(
        nlevels=[4, 4], freq01_ghz=freq, rotfreq_ghz=freq, selfkerr_ghz=kerr,
        jkl_ghz=[0.005], crosskerr_ghz=[])
    oscs = tuple(OscillatorControl(
        segments=(ControlSegment("spline", nsplines=30, tstart=0.0,
                                 tstop=T),),
        carrier_freqs=(0.0, 2 * np.pi * (freq[1 - k] - freq[k]),
                       -2 * np.pi * kerr[k])) for k in range(2))
    return Setup(
        model=model, nessential=(2, 2), ntime=ntime, dt=T / ntime,
        oscillators=oscs, ground_freqs_radns=tuple(2 * np.pi * f for f in freq),
        initcond_type="basis", target_type="gate",
        target_gate_full=gates.assemble_gate(gates.cnot(), [4, 4], [2, 2],
                                             [0.0, 0.0], T),
        gamma_tik=1e-4, gamma_penalty=0.1, gamma_penalty_energy=0.1,
        gamma_penalty_dpdm=0.01, dtype=torch.complex64, linsolve_iters=3,
        linsolver="split", fused=True)


@pytest.mark.cuda
def test_one_rank_nccl_mesh_is_the_unsharded_flagship_on_card(cuda):
    """parallel/mesh.py on a one-rank NCCL group: the flagship's 'init'
    axis, its ensemble at E = 128 and two sweeps on make_mesh(1, 1) are the
    unsharded runs' bits (a collective over one rank sums one share), with
    one launch of each streamK kernel per sweep."""
    import socket

    import torch.distributed as dist

    from quandary_tpu_torch.parallel import mesh, multihost
    from quandary_tpu_torch.problem import Problem

    setup = _flagship_setup()
    prob = Problem(setup)
    n = setup.nparams
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, n) * 0.005
    Ps = rng.uniform(-1, 1, (128, n)) * 0.005
    Pr = np.stack([Ps, Ps[::-1]])
    (J0, aux0), g0 = prob.build_value_and_grad()(x, x)
    (Je0, _), ge0 = prob.build_ensemble_value_and_grad()(Ps, x)
    sw0 = prob.build_ensemble_sweeps()(Pr, x)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    device = multihost.initialize(f"localhost:{port}", 1, 0)
    try:
        assert device.type == "cuda" and dist.get_backend() == "nccl"
        m = mesh.make_mesh(1, 1)
        assert m.device_type == "cuda"
        ps = mesh.shard_problem(Problem(setup), m)
        assert ps.fused_form == "streamk" and ps.ninit == 4
        runs = (lambda: ps.build_value_and_grad()(x, x),
                lambda: prob.build_ensemble_value_and_grad(mesh=m)(Ps, x),
                lambda: prob.build_ensemble_sweeps(mesh=m)(Pr, x))
        out = []
        for run, per in zip(runs, (1, 1, 2)):
            before = streamk.launch_counts()
            out.append(run())
            torch.cuda.synchronize()
            after = streamk.launch_counts()
            assert {k: after[k] - before[k] for k in after} == {
                "streamk_fwd_launches": per, "streamk_bwd_launches": per,
                "streamk_packed_fwd_launches": 0,
                "streamk_packed_bwd_launches": 0}
    finally:
        dist.destroy_process_group()
    ((J1, aux1), g1), ((Je1, _), ge1), sw1 = out
    assert torch.equal(J1, J0) and torch.equal(g1, g0)
    assert all(torch.equal(aux1[k], aux0[k]) for k in aux0)
    assert torch.equal(Je1, Je0) and torch.equal(ge1, ge0)
    assert torch.equal(sw1, sw0)
