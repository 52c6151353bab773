"""quandary_tpu_torch.ops.streamk against the TPU kernel it ports,
quandary_tpu.ops.pallas_stream.make_streamk_propagate, run in Pallas
interpret mode on the CPU.

The port's plain torch version (the CPU path and the CUDA kernels' oracle)
must give the same final state, history and gradients (coefficients and
x0) of a weighted loss, for every stage solver, with stored (iters <= 4)
and replayed stage iterates. Bounds: 2e-6 x max|ref| against the exact-f32
kernels ('highest', the bound of test_streamk_matches_stream_all_solvers),
1e-3 x max|ref| against the shipping 3-pass bf16 default ('high', the
gradient bound of test_problem_parity_at_default_high_precision)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from quandary_tpu.ops import pallas_stream  # noqa: E402
from quandary_tpu.ops.pallas_adjoint import plane_args  # noqa: E402
from quandary_tpu_torch.ops import streamk  # noqa: E402

K, N, B, NT, DT = 4, 12, 3, 9, 0.01
SOLVERS = ("neumann", "jacobi", "split")


def _case(seed=0):
    rng = np.random.default_rng(seed)
    stack = (rng.normal(size=(K, N, N))
             + 1j * rng.normal(size=(K, N, N))).astype(np.complex64)
    return dict(
        stack=stack,
        gen_diag=(-1j * np.diag(stack[0])).astype(np.complex128),
        x0r=rng.normal(size=(B, N)).astype(np.float32),
        x0i=rng.normal(size=(B, N)).astype(np.float32),
        C=(rng.normal(size=(NT, K)) * 0.3).astype(np.float32),
        wTr=rng.normal(size=(B, N)).astype(np.float32),
        wTi=rng.normal(size=(B, N)).astype(np.float32),
        whr=rng.uniform(0.1, 1.0, (NT, B, N)).astype(np.float32),
        whi=rng.normal(size=(NT, B, N)).astype(np.float32),
    )


def _loss(xp, c, xT, hist):
    (xTr, xTi), (hr, hi) = xT, hist
    return (xp.sum(c["wTr"] * xTr) + xp.sum(c["wTi"] * xTi)
            + xp.sum(c["whr"] * hr * hr) + 0.5 * xp.sum(c["whi"] * hi))


def _jax_run(c, solver, iters):
    prop = pallas_stream.make_streamk_propagate(
        c["stack"], DT, iters, gen_diag=c["gen_diag"], linsolver=solver,
        interpret=True, real_io=True)
    Sr, Si = map(jnp.asarray, plane_args(c["stack"]))

    def f(C, x0r, x0i):
        xT, hist = prop(Sr, Si, (x0r, x0i), C)
        return _loss(jnp, c, xT, hist), (xT, hist)

    (_, (xT, hist)), grads = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(c["C"]), jnp.asarray(c["x0r"]), jnp.asarray(c["x0i"]))
    return [np.asarray(a) for a in (*xT, *hist, *grads)]


def _torch_run(c, solver, iters, dtype=torch.float32):
    prop = streamk.make_streamk_propagate(DT, iters, gen_diag=c["gen_diag"],
                                          linsolver=solver)
    t = lambda a: torch.tensor(a, dtype=dtype)
    C, x0r, x0i = (t(c[k]).requires_grad_() for k in ("C", "x0r", "x0i"))
    xT, hist = prop(t(c["stack"].real), t(c["stack"].imag), (x0r, x0i), C)
    _loss(torch, {k: t(v) for k, v in c.items() if k[0] == "w"},
          xT, hist).backward()
    return [a.detach().numpy() for a in (*xT, *hist, C.grad, x0r.grad,
                                         x0i.grad)]


NAMES = ("xTr", "xTi", "hist_r", "hist_i", "dC", "dx0r", "dx0i")


@pytest.mark.parametrize("precision,bound", [("highest", 2e-6),
                                             ("high", 1e-3)])
@pytest.mark.parametrize("iters", [3, 6])
@pytest.mark.parametrize("solver", SOLVERS)
def test_plain_matches_pallas_streamk(solver, iters, precision, bound,
                                      monkeypatch):
    """iters 3 stores the stage iterates in the JAX kernel, 6 replays
    them; the port's plain version always replays (same values)."""
    monkeypatch.setattr(pallas_stream, "_PRECISION_MODE", precision)
    c = _case()
    ref = _jax_run(c, solver, iters)
    got = _torch_run(c, solver, iters)
    for name, a, b in zip(NAMES, got, ref):
        assert a.shape == b.shape, name
        err = np.abs(a - b).max()
        assert err <= bound * np.abs(b).max(), (name, err, np.abs(b).max())


@pytest.mark.parametrize("iters", [0, 3, 6])
@pytest.mark.parametrize("solver", SOLVERS)
def test_plain_backward_is_autograd_transpose(solver, iters):
    """The hand-written backward of streamk_propagate_plain equals torch
    autograd through plain_forward, in f64 to 1e-10, with E = 2 candidates
    on the leading axis of the coefficients."""
    c = _case(1)
    rng = np.random.default_rng(2)
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    plan = streamk.make_plan(t(c["stack"].real), t(c["stack"].imag), DT,
                             iters, c["gen_diag"], solver)
    C = streamk.extend_coeffs(plan, t(rng.normal(size=(2, NT, K)) * 0.3))
    wh = t(rng.normal(size=(2, NT, B, N)))
    wT = t(rng.normal(size=(2, B, N)))

    def plain_autograd(plan, x0r, x0i, Ce):
        hr, hi = streamk.plain_forward(plan, x0r, x0i, Ce)
        return hr[:, -1], hi[:, -1], hr, hi

    def grads(run):
        Cg = C.clone().requires_grad_()
        x0r, x0i = t(c["x0r"]).requires_grad_(), t(c["x0i"]).requires_grad_()
        xTr, xTi, hr, hi = run(plan, x0r, x0i, Cg)
        L = torch.sum(wT * xTr) + torch.sum(wT * xTi * xTi) \
            + torch.sum(wh * hr * hi)
        L.backward()
        return L.detach(), Cg.grad, x0r.grad, x0i.grad

    for a, b in zip(grads(streamk.streamk_propagate_plain),
                    grads(plain_autograd)):
        scale = max(float(b.abs().max()), 1e-300)
        assert float((a - b).abs().max()) <= 1e-10 * scale


def test_candidate_axis_matches_single_runs():
    """C (E, ntime, K) runs every candidate as its own propagation."""
    c = _case(4)
    rng = np.random.default_rng(5)
    prop = streamk.make_streamk_propagate(DT, 3, gen_diag=c["gen_diag"],
                                          linsolver="split")
    Sr = torch.tensor(c["stack"].real)
    Si = torch.tensor(c["stack"].imag)
    x0 = (torch.tensor(c["x0r"]), torch.tensor(c["x0i"]))
    C = torch.tensor(rng.normal(size=(3, NT, K)) * 0.3, dtype=torch.float32)
    (xTr, _), (hr, _) = prop(Sr, Si, x0, C)
    assert xTr.shape == (3, B, N) and hr.shape == (3, NT, B, N)
    for e in range(3):
        (xTr1, _), (hr1, _) = prop(Sr, Si, x0, C[e])
        assert hr1.shape == (NT, B, N)
        torch.testing.assert_close(hr[e], hr1, rtol=0, atol=1e-6)
        torch.testing.assert_close(xTr[e], xTr1, rtol=0, atol=1e-6)


# (B, N, Ke, iters): the flagship (split-3, Ke = K + 1 = 8), its jacobi-8
# request, open configuration 1 on the superop route (B = 16 basis density
# matrices of dimension 16, 8 iterations), B*N = 1024, the largest N the
# backward admitted at the flagship's B, Ke and iters (52; 53 with B = 1),
# the first refused, shapes whose states span warps (N = 12, 27, 48), and
# more stack slots than helper threads (N = 8: 32 helpers, Ke = 40)
SHAPES = [(4, 16, 8, 3), (4, 16, 8, 8), (16, 16, 5, 8), (16, 16, 9, 8),
          (64, 16, 8, 3), (32, 32, 8, 3), (256, 4, 5, 8), (4, 52, 8, 3),
          (1, 53, 8, 3), (4, 53, 8, 3), (3, 12, 4, 6), (3, 27, 7, 6),
          (4, 48, 8, 8), (2, 40, 12, 4), (8, 8, 40, 3)]


def _admitted_before(B, N, Ke, it):
    """The size gate of the one-role backward kernel (every thread did
    every role in turn, with a (warps, Ke) reduction scratch), kept as a
    literal: the redesign must admit at least these shapes."""
    BN, NN = B * N, N * N
    threads = max(32, -(-max(BN, min(NN, 1024)) // 32) * 32)
    floats = 2 * Ke * NN + 2 * N * (N + 1) + 2 * NN + 2 * BN + 2 * it * BN \
        + 2 * (it + 1) * BN + (threads // 32) * Ke
    return BN <= 1024 and 4 * floats <= 227 * 1024


@pytest.mark.parametrize("B,N,Ke,iters", SHAPES)
def test_size_refusal_admits_what_it_admitted(B, N, Ke, iters):
    """size_refusal admits every shape the previous backward admitted, and
    a refusal names its limit."""
    why = streamk.size_refusal(B, N, Ke, iters)
    if _admitted_before(B, N, Ke, iters):
        assert why is None, why
    else:
        assert why is not None and ("shared memory" in why or "1024" in why)


@pytest.mark.parametrize("B,N,Ke,iters", SHAPES)
def test_backward_launch_shape(B, N, Ke, iters):
    """The backward's launch: whole warps, a thread for every state entry,
    at most 1024 threads and 227 KB of shared memory, at least the layout
    csrc/streamk.cu carves for the roles it is given. Helper warps (two
    ring slots) at the flagship and open configuration 1; the inline
    layout on the forward's threads where the helpers' slots do not fit."""
    if streamk.size_refusal(B, N, Ke, iters) is not None:
        return
    threads, smem, helpers = streamk._bwd_shape(Ke, iters, B, N)
    S = -(-B * N // 32) * 32
    assert threads % 32 == 0 and B * N <= threads <= 1024
    assert 0 < smem <= 227 * 1024
    assert smem >= streamk._bwd_smem_bytes(Ke, iters, B, N, helpers > 0)
    if helpers:
        assert threads == S + helpers and helpers % 32 == 0
    else:
        assert threads == streamk._threads(B, N)
        assert smem < streamk._bwd_smem_bytes(Ke, iters, B, N, split=True)
    if (B, N) in ((4, 16), (16, 16)):
        assert helpers >= 32
    if (B, N, Ke, iters) in ((4, 52, 8, 3), (64, 16, 8, 3)):
        assert helpers == 0
    z = torch.zeros(Ke, N, N)
    plan = streamk.make_plan(z, z, DT, iters)
    assert streamk._launch_shape(plan, B, N, backward=True) == (threads,
                                                                 smem)


@pytest.mark.parametrize("B,N,Ke,iters", SHAPES)
def test_forward_launch_shape(B, N, Ke, iters):
    """The forward's launch: whole warps, a thread for every state entry,
    at most 1024 threads and 227 KB of shared memory, at least the layout
    csrc/streamk.cu carves for the roles it is given. Helper warps (two H
    slots) at the flagship and open configuration 1, and at N = 52, where
    the forward's two-slot layout fits; the inline layout at B*N = 1024 and
    wherever the two-slot layout does not fit."""
    if streamk.size_refusal(B, N, Ke, iters) is not None:
        return
    threads, smem, helpers = streamk._fwd_shape(Ke, iters, B, N)
    S = -(-B * N // 32) * 32
    split_smem = streamk._fwd_smem_bytes(Ke, B, N, split=True)
    assert threads % 32 == 0 and B * N <= threads <= 1024
    assert 0 < smem <= 227 * 1024
    assert smem >= streamk._fwd_smem_bytes(Ke, B, N, helpers > 0)
    if helpers:
        assert threads == S + helpers and helpers % 32 == 0
    else:
        assert threads == streamk._threads(B, N)
        assert smem < split_smem
        assert S > 1024 - 32 or split_smem > 227 * 1024
    if (B, N) in ((4, 16), (16, 16)) or (B, N, Ke, iters) == (4, 52, 8, 3):
        assert helpers >= 32
    if (B, N, Ke, iters) == (64, 16, 8, 3):
        assert helpers == 0
    z = torch.zeros(Ke, N, N)
    plan = streamk.make_plan(z, z, DT, iters)
    assert streamk._launch_shape(plan, B, N, backward=False) == (threads,
                                                                  smem)
