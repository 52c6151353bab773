"""The streamed-plane family of quandary_tpu_torch (ops/stream.py, B3;
ops/adjoint.py, B5; ops/dense.py, B6: the plain torch versions that the
CUDA kernels of csrc/stream.cu are held against on the card) against the
TPU kernels they port, run in Pallas interpret mode on the CPU, at the size
of tests/test_pallas_stream.py (K = 3-4, N = 8-12, B = 2-3, nt = 7-9).

1. make_stream_propagate against pallas_stream.make_stream_propagate at
   'highest' (exact f32; monkeypatched as in test_torch_streamk.py), every
   stage solver, stored (iters 3) and replayed (iters 6) stage iterates,
   NON-Hermitian stacks (a wrong orientation of H or of the plane cotangent
   is invisible on a Hermitian one): xT, hist and the four cotangents x0-bar,
   C-bar, Sr-bar, Si-bar to 2e-6 x max; the same for make_pallas_propagate
   (B5) and pallas_propagate_dense (B6), whose TPU kernels run f32 HIGHEST.
2. The stack cotangents against central finite differences in f64 (1e-6
   relative), the hand-written backward against autograd through the plain
   forward (f64, 1e-10), E candidates against E single runs (shared and
   per-candidate stacks).
3. Problem(fused_mode='stream' | 'chunk') against the JAX Problem with
   pallas_mode='stream' | 'chunk' in interpret mode (f32 at 'highest') and,
   in f64, against the JAX scan (J 1e-10, gradient 1e-9 of max), closed and
   open (superop route); the route gate's refusals.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the matrices are tiny: one thread per test process, so that test
# processes running side by side do not fight over the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from quandary_tpu.ops import pallas_adjoint, pallas_kernels  # noqa: E402
from quandary_tpu.ops import pallas_stream  # noqa: E402
from quandary_tpu.problem import Problem as JProblem  # noqa: E402
from quandary_tpu_torch.ops import (adjoint, dense, stream,  # noqa: E402
                                    streamk)
from quandary_tpu_torch.problem import Problem as TProblem  # noqa: E402
from test_torch_lindblad import unguarded_setup  # noqa: E402
from test_torch_model import (flagship_setup, port_setup,  # noqa: E402
                              qudit_setup)

K, N, B, NT, DT = 4, 12, 3, 9, 0.01
SOLVERS = ("neumann", "jacobi", "split")
NAMES = ("xTr", "xTi", "hist_r", "hist_i", "dSr", "dSi", "dC", "dx0r",
         "dx0i")


def _case(seed=0, k=K, n=N, b=B, nt=NT):
    rng = np.random.default_rng(seed)
    stack = (rng.normal(size=(k, n, n))
             + 1j * rng.normal(size=(k, n, n))).astype(np.complex64)
    return dict(
        stack=stack,
        gen_diag=(-1j * np.diag(stack[0])).astype(np.complex128),
        x0r=rng.normal(size=(b, n)).astype(np.float32),
        x0i=rng.normal(size=(b, n)).astype(np.float32),
        C=(rng.normal(size=(nt, k)) * 0.3).astype(np.float32),
        wTr=rng.normal(size=(b, n)).astype(np.float32),
        wTi=rng.normal(size=(b, n)).astype(np.float32),
        whr=rng.uniform(0.1, 1.0, (nt, b, n)).astype(np.float32),
        whi=rng.normal(size=(nt, b, n)).astype(np.float32),
    )


def _loss(xp, c, xT, hist):
    (xTr, xTi), (hr, hi) = xT, hist
    return (xp.sum(c["wTr"] * xTr) + xp.sum(c["wTi"] * xTi)
            + xp.sum(c["whr"] * hr * hr) + 0.5 * xp.sum(c["whi"] * hi))


def _jax_run(c, prop):
    """Values and cotangents of the JAX propagation `prop` (complex x0 in,
    complex (xT, hist) out, padded (K, P, P) planes); the padding is cut."""
    n = c["stack"].shape[-1]
    Sr, Si = map(jnp.asarray, pallas_adjoint.plane_args(c["stack"]))

    def f(Sr, Si, C, x0r, x0i):
        xT, hist = prop(Sr, Si, x0r + 1j * x0i, C)
        out = ((jnp.real(xT), jnp.imag(xT)), (jnp.real(hist), jnp.imag(hist)))
        return _loss(jnp, c, *out), out

    (_, (xT, hist)), grads = jax.value_and_grad(
        f, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            Sr, Si, jnp.asarray(c["C"]), jnp.asarray(c["x0r"]),
            jnp.asarray(c["x0i"]))
    gSr, gSi = (g[:, :n, :n] for g in grads[:2])
    return [np.asarray(a) for a in (*xT, *hist, gSr, gSi, *grads[2:])]


def _torch_run(c, prop, dtype=torch.float32):
    t = lambda a: torch.tensor(a, dtype=dtype)
    Sr, Si = (t(p).requires_grad_() for p in adjoint.plane_args(c["stack"]))
    C, x0r, x0i = (t(c[k]).requires_grad_() for k in ("C", "x0r", "x0i"))
    xT, hist = prop(Sr, Si, (x0r, x0i), C)
    _loss(torch, {k: t(v) for k, v in c.items() if k[0] == "w"},
          xT, hist).backward()
    return [a.detach().numpy() for a in (*xT, *hist, Sr.grad, Si.grad,
                                         C.grad, x0r.grad, x0i.grad)]


def _assert_close(got, ref, bound):
    for name, a, b in zip(NAMES, got, ref):
        assert a.shape == b.shape, name
        err = np.abs(a - b).max()
        assert err <= bound * np.abs(b).max(), (name, err, np.abs(b).max())


@pytest.mark.parametrize("iters", [3, 6])
@pytest.mark.parametrize("solver", SOLVERS)
def test_plain_matches_pallas_stream(solver, iters, monkeypatch):
    """iters 3 stores the stage iterates in both kernels, 6 replays them;
    the port's plain version always replays (same values)."""
    monkeypatch.setattr(pallas_stream, "_PRECISION_MODE", "highest")
    c = _case()
    ref = _jax_run(c, pallas_stream.make_stream_propagate(
        c["stack"], DT, iters, gen_diag=c["gen_diag"], linsolver=solver,
        interpret=True))
    got = _torch_run(c, stream.make_stream_propagate(
        DT, iters, gen_diag=c["gen_diag"], linsolver=solver))
    _assert_close(got, ref, 2e-6)


def test_plain_matches_pallas_adjoint():
    """The chunk path: 19 steps span two TPU chunks of 16 steps and the
    padded remainder; the port runs the whole loop in one launch."""
    c = _case(1, k=3, n=8, b=2, nt=19)
    ref = _jax_run(c, pallas_adjoint.make_pallas_propagate(
        c["stack"], 0.02, 8, interpret=True))
    got = _torch_run(c, adjoint.make_pallas_propagate(0.02, 8))
    _assert_close(got, ref, 2e-6)


def test_dense_matches_pallas_dense():
    c = _case(2)
    x0 = c["x0r"] + 1j * c["x0i"]
    ref = np.asarray(pallas_kernels.pallas_propagate_dense(
        c["stack"], c["C"], jnp.asarray(x0), DT, iters=10, interpret=True))
    got = dense.pallas_propagate_dense(c["stack"], c["C"], torch.tensor(x0),
                                       DT, iters=10)
    assert got.dtype == torch.complex64 and got.shape == (B, N)
    assert np.abs(got.numpy() - ref).max() <= 2e-6 * np.abs(ref).max()
    # the dense forward is the chunk forward without the history
    (xTr, xTi), _ = adjoint.make_pallas_propagate(DT, 10)(
        *map(torch.tensor, adjoint.plane_args(c["stack"])),
        (torch.tensor(c["x0r"]), torch.tensor(c["x0i"])), torch.tensor(c["C"]))
    assert torch.equal(torch.complex(xTr, xTi), got)


@pytest.mark.parametrize("solver", SOLVERS)
def test_stack_cotangents_match_finite_differences(solver):
    """Sr-bar and Si-bar of make_stream_propagate against central finite
    differences of the f64 loss (test_pallas_stream.py::
    test_stack_cotangents_fd, tightened to 1e-6 relative in f64)."""
    c = _case(3, k=3, n=8, b=2, nt=7)
    prop = stream.make_stream_propagate(0.03, 5, gen_diag=c["gen_diag"],
                                        linsolver=solver)
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    w = {k: t(v) for k, v in c.items() if k[0] == "w"}
    x0 = (t(c["x0r"]), t(c["x0i"]))

    def f(Sr, Si):
        return _loss(torch, w, *prop(Sr, Si, x0, t(c["C"])))

    Sr = t(c["stack"].real).requires_grad_()
    Si = t(c["stack"].imag).requires_grad_()
    gSr, gSi = torch.autograd.grad(f(Sr, Si), (Sr, Si))
    rng = np.random.default_rng(4)
    eps = 1e-6
    for which, g in ((0, gSr), (1, gSi)):
        for _ in range(4):
            idx = tuple(int(rng.integers(s)) for s in g.shape)
            planes = [Sr.detach().clone(), Si.detach().clone()]
            planes[which][idx] += eps
            up = float(f(*planes))
            planes[which][idx] -= 2 * eps
            fd = (up - float(f(*planes))) / (2 * eps)
            assert abs(float(g[idx]) - fd) <= 1e-6 * max(1.0, abs(fd)), \
                (solver, which, idx, float(g[idx]), fd)


@pytest.mark.parametrize("iters", [0, 3, 6])
@pytest.mark.parametrize("solver", SOLVERS)
def test_plain_backward_is_autograd_transpose(solver, iters):
    """The hand-written backward of stream_propagate_plain (plane and x0
    cotangents) equals torch autograd through plain_forward, f64, E = 2."""
    c = _case(5, k=3, n=8, b=2, nt=7)
    rng = np.random.default_rng(6)
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    plan = stream.make_plan(t(c["stack"].real), DT, iters, c["gen_diag"],
                            solver)
    Ce = t(rng.normal(size=(2, 7, 3)) * 0.3)
    H = stream.planes(plan, t(c["stack"].real), t(c["stack"].imag), Ce)
    wh, wT = t(rng.normal(size=(2, 7, 2, 8))), t(rng.normal(size=(2, 2, 8)))

    def plain_autograd(plan, Hr, Hi, x0r, x0i):
        hr, hi = stream.plain_forward(plan, Hr, Hi, x0r, x0i)
        return hr[:, -1], hi[:, -1], hr, hi

    def grads(run):
        Hr, Hi = (h.clone().requires_grad_() for h in H)
        x0r, x0i = t(c["x0r"]).requires_grad_(), t(c["x0i"]).requires_grad_()
        xTr, xTi, hr, hi = run(plan, Hr, Hi, x0r, x0i)
        L = torch.sum(wT * xTr) + torch.sum(wT * xTi * xTi) \
            + torch.sum(wh * hr * hi)
        L.backward()
        return L.detach(), Hr.grad, Hi.grad, x0r.grad, x0i.grad

    for a, b in zip(grads(stream.stream_propagate_plain),
                    grads(plain_autograd)):
        assert float((a - b).abs().max()) <= 1e-10 * float(b.abs().max())


@pytest.mark.parametrize("per_candidate_stacks", [False, True])
def test_candidate_axis_matches_single_runs(per_candidate_stacks):
    """C (E, ntime, K) runs every candidate as its own propagation, also
    with one operator stack per candidate: states and stack cotangents."""
    c = _case(7, k=3, n=8, b=2, nt=7)
    rng = np.random.default_rng(8)
    E = 3
    prop = stream.make_stream_propagate(DT, 3, gen_diag=c["gen_diag"],
                                        linsolver="split")
    S = c["stack"] if not per_candidate_stacks else np.stack(
        [c["stack"] * (1 + 0.1 * e) for e in range(E)])
    x0 = (torch.tensor(c["x0r"]), torch.tensor(c["x0i"]))
    C = torch.tensor(rng.normal(size=(E, 7, 3)) * 0.3, dtype=torch.float32)

    def run(Snp, C):
        Sr = torch.tensor(Snp.real).requires_grad_()
        Si = torch.tensor(Snp.imag).requires_grad_()
        (xTr, xTi), (hr, hi) = prop(Sr, Si, x0, C)
        (torch.sum(hr * hr) + torch.sum(xTi)).backward()
        return xTr.detach(), hr.detach(), Sr.grad, Si.grad

    xTr, hr, gSr, gSi = run(S, C)
    assert xTr.shape == (E, 2, 8) and hr.shape == (E, 7, 2, 8)
    for e in range(E):
        one = run(S[e] if per_candidate_stacks else S, C[e])
        assert one[1].shape == (7, 2, 8)
        torch.testing.assert_close(hr[e], one[1], rtol=0, atol=1e-6)
        torch.testing.assert_close(xTr[e], one[0], rtol=0, atol=1e-6)
        if per_candidate_stacks:
            torch.testing.assert_close(gSr[e], one[2], rtol=0, atol=1e-5)
            torch.testing.assert_close(gSi[e], one[3], rtol=0, atol=1e-5)


# ----------------------------------------------------------------------
# Problem(fused_mode=...) against the JAX Problem
# ----------------------------------------------------------------------

def _params(n, seed=1234):
    return np.random.default_rng(seed).uniform(-1, 1, n) * 0.02


def _vg(problem, x, jax_problem=False):
    if jax_problem:
        (J, _), g = problem.build_value_and_grad()(jnp.asarray(x),
                                                   jnp.asarray(x))
        return float(J), np.asarray(g, np.float64)
    (J, _), g = problem.build_value_and_grad()(x, x)
    return float(J), g.numpy().astype(np.float64)


def _chunk_setup(pkg, **kw):
    """A guarded qudit with plain Neumann (dt small enough that the
    stiffness guard keeps it)."""
    return qudit_setup(pkg, ntime=30, dt=0.1, **kw)


CASES = {   # (the JAX Setup of the case, fused_mode)
    "flagship_stream": (lambda **kw: flagship_setup("jax", **kw), "stream"),
    "qudit_chunk": (lambda **kw: _chunk_setup("jax", **kw), "chunk"),
    "open_stream": (lambda **kw: unguarded_setup(ntime=12, T=2.0, **kw),
                    "stream"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_problem_f32_matches_jax_pallas(case, monkeypatch):
    """The port's Problem on the stream / chunk route against the JAX
    Problem(pallas=True, pallas_mode=...) in interpret mode, f32, both at
    full f32 precision: J to 2e-6, the gradient to 2e-5 of max."""
    monkeypatch.setattr(pallas_stream, "_PRECISION_MODE", "highest")
    make_setup, mode = CASES[case]
    sj = make_setup(dtype=jnp.complex64, pallas=True, pallas_mode=mode)
    pj = JProblem(sj)
    assert pj.use_pallas
    pt = TProblem(port_setup(sj), device="cpu")
    assert pt.setup.fused_mode == mode and pt.fused_ok
    assert pt.fused_form == ("superop" if pt.lindblad else mode)
    x = _params(sj.nparams)
    Jj, gj = _vg(pj, x, jax_problem=True)
    Jt, gt = _vg(pt, x)
    assert abs(Jt - Jj) <= 2e-6 * abs(Jj)
    assert np.abs(gt - gj).max() <= 2e-5 * np.abs(gj).max()


@pytest.mark.parametrize("case", list(CASES))
def test_problem_f64_matches_jax_scan(case):
    """In f64 the stream and chunk routes are the scan's algebra: J to
    1e-10, the gradient to 1e-9 of max of the JAX scan."""
    make_setup, mode = CASES[case]
    sj = make_setup(dtype=jnp.complex128, pallas=False)
    pt = TProblem(port_setup(sj, fused_mode=mode), device="cpu")
    assert pt.use_fused and pt.setup.fused_mode == mode
    x = _params(sj.nparams)
    Jj, gj = _vg(JProblem(sj), x, jax_problem=True)
    Jt, gt = _vg(pt, x)
    assert abs(Jt - Jj) <= 1e-10 * abs(Jj)
    assert np.abs(gt - gj).max() <= 1e-9 * np.abs(gj).max()


def test_route_gate_refusals():
    """'chunk' takes closed plain-Neumann problems only: the flagship's
    split, a neumann request the stiffness guard turns into jacobi, and an
    open system are refused by name; the rho route is streamK-only."""
    st = flagship_setup("torch")
    with pytest.raises(NotImplementedError, match="linsolver='split'"):
        TProblem(dataclasses.replace(st, fused_mode="chunk"), device="cpu")
    stiff = dataclasses.replace(st, fused_mode="chunk", linsolver="neumann",
                                linsolve_iters=8)
    with pytest.raises(NotImplementedError, match="linsolver='jacobi'"):
        TProblem(stiff, device="cpu")
    so = port_setup(unguarded_setup())
    with pytest.raises(NotImplementedError, match="open"):
        TProblem(dataclasses.replace(so, fused_mode="chunk"), device="cpu")
    with pytest.raises(NotImplementedError, match="streamK kernels only"):
        TProblem(dataclasses.replace(so, fused_mode="stream",
                                     fused_rho="rho"), device="cpu")
    with pytest.raises(ValueError, match="fused_mode"):
        TProblem(dataclasses.replace(st, fused_mode="planes"), device="cpu")
    # one block per candidate, and the plane arrays of a gradient sweep
    # under the budget (the flagship's E = 128 sweep takes 0.96 GB)
    assert stream.size_refusal(4, 16, 3, nt=1221, E=128) is None
    assert "PLANE_BUDGET_BYTES" in stream.size_refusal(4, 16, 3, nt=1221,
                                                       E=2048)
    assert "1024 threads" in stream.size_refusal(5, 256, 3)
    with pytest.raises(NotImplementedError):
        stream.make_plan(torch.zeros(1, 2, 2), 0.1, 3, np.ones(2),
                         "jacobi", kind="chunk")


# (B, N, iters): the flagship (split-3), neumann-8 and jacobi-8 at its
# width, open configuration 1 on 'stream', the qutrits' N = 27, states
# spanning warps, N = 8 at B = 8, the largest N at B = 4 and B = 1 and one
# past each, B N = 1024 and one state past it
LAUNCH_SHAPES = [(4, 16, 3), (4, 16, 8), (16, 16, 8), (3, 27, 4),
                 (4, 27, 3), (3, 12, 6), (8, 8, 3), (4, 16, 0),
                 (4, 154, 3), (4, 155, 3), (1, 166, 3), (1, 167, 3),
                 (64, 16, 3), (65, 16, 3), (32, 32, 4)]


def _admitted_before(B, N, iters):
    """What size_refusal admitted before the backward had helper warps: one
    block of at most 1024 threads for the B N state entries, and the
    one-slot layout of the H planes, the pre-state, iters stored and
    iters + 1 cotangent slots and iters + 1 matvec slots within 227 KB."""
    BN = B * N
    floats = 2 * N * (N + 1) + 2 * BN + 2 * (iters + 1) * BN + 2 * iters * BN
    return BN <= 1024 and 4 * floats <= 227 * 1024


@pytest.mark.parametrize("B,N,iters", LAUNCH_SHAPES)
def test_size_refusal_admits_what_it_admitted(B, N, iters):
    """The split-role backward keeps the size range: size_refusal admits
    exactly the shapes of _admitted_before (whose bytes are the inline
    branch's layout), and a refusal names its limit."""
    why = stream.size_refusal(B, N, iters)
    if _admitted_before(B, N, iters):
        assert why is None, why
    else:
        assert why is not None and ("shared memory" in why or "1024" in why)


@pytest.mark.parametrize("B,N,iters", LAUNCH_SHAPES)
def test_backward_launch_shape(B, N, iters):
    """The backward's launch (csrc/stream.cu): whole warps, a thread for
    every state entry, at most 1024 threads and 227 KB of shared memory.
    Helper warps (at least one) after the state warps with two ring slots
    where they fit, the inline layout (one slot, _admitted_before's
    bytes) where they do not; the C launcher's rule (helper_threads) reads
    the same layout from the shape; a refused shape raises."""
    z = torch.zeros(2, N, N)
    plan = stream.make_plan(z, DT, iters)
    if stream.size_refusal(B, N, iters) is not None:
        with pytest.raises(NotImplementedError):
            stream._launch_shape(plan, 1, 1, B, N, backward=True)
        return
    threads, smem, helpers = stream._bwd_shape(iters, B, N)
    S = -(-B * N // 32) * 32
    two_slots = stream._bwd_smem_bytes(iters, B, N, split=True)
    assert threads % 32 == 0 and B * N <= threads <= 1024
    assert 0 < smem <= 227 * 1024
    if helpers:
        assert threads == S + helpers and helpers % 32 == 0 and helpers >= 32
        assert smem == two_slots
    else:
        assert threads == streamk._threads(B, N)
        assert smem == stream._bwd_smem_bytes(iters, B, N, split=False)
        assert S > 1024 - 32 or two_slots > 227 * 1024
    c_helpers = threads - S if threads > S and smem >= two_slots else 0
    assert c_helpers == helpers
    if (B, N) in ((4, 16), (16, 16), (3, 27), (8, 8)):
        assert helpers >= 32
    if (B, N) in ((4, 154), (64, 16), (1, 166)):
        assert helpers == 0
    assert stream._launch_shape(plan, 1, 1, B, N, backward=True) == (
        threads, smem)


@pytest.mark.parametrize("B,N,iters", LAUNCH_SHAPES)
def test_forward_launch_shape(B, N, iters):
    """The forward's launch (csrc/stream.cu): whole warps, a thread for
    every state entry, at most 1024 threads and 227 KB of shared memory.
    Helper warps (at least one) after the state warps with two H slots
    where they fit, the inline layout (one slot) on streamk._threads where
    they do not; the layout does not depend on iters; the C launcher's rule
    (helper_threads over fwd_floats) reads the same layout from the shape;
    a refused shape raises."""
    z = torch.zeros(2, N, N)
    plan = stream.make_plan(z, DT, iters)
    if stream.size_refusal(B, N, iters) is not None:
        with pytest.raises(NotImplementedError):
            stream._launch_shape(plan, 1, 1, B, N, backward=False)
        return
    threads, smem, helpers = stream._fwd_shape(B, N)
    S = -(-B * N // 32) * 32
    two_slots = 4 * (2 * 2 * N * (N + 1) + 4 * B * N)
    one_slot = 4 * (2 * N * (N + 1) + 4 * B * N)
    assert stream._fwd_smem_bytes(B, N, split=True) == two_slots
    assert stream._fwd_smem_bytes(B, N, split=False) == one_slot
    assert threads % 32 == 0 and B * N <= threads <= 1024
    assert 0 < smem <= 227 * 1024
    if helpers:
        assert threads == S + helpers and helpers % 32 == 0 and helpers >= 32
        assert smem == two_slots
    else:
        assert threads == streamk._threads(B, N)
        assert smem == one_slot
        assert S > 1024 - 32 or two_slots > 227 * 1024
    c_helpers = threads - S if threads > S and smem >= two_slots else 0
    assert c_helpers == helpers
    if (B, N) in ((4, 16), (16, 16), (3, 27), (8, 8)):
        assert helpers >= 32
    if (B, N) in ((4, 154), (64, 16), (1, 166)):
        assert helpers == 0
    # size_refusal bounds the backward's inline layout, which holds the
    # forward's
    assert one_slot <= stream._bwd_smem_bytes(iters, B, N, split=False)
    assert stream._launch_shape(plan, 1, 1, B, N, backward=False) == (
        threads, smem)
