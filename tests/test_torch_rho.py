"""quandary_tpu_torch.ops.rho (the plain torch version of the density-matrix
propagation, which the CUDA kernels of csrc/rho.cu are held against on the
card) against quandary_tpu.ops.pallas_rho and the f64 scan of the same IMR
discretization, at the size of tests/test_pallas_rho.py (N = 5, K = 3,
B = 2, nt = 7, J = 2 jump operators, 3 iterations).

1. f32: rho_propagate_plain against make_rho_propagate(interpret=True):
   xT and hist to 2e-4 of max, C-bar and x0-bar to 5e-4 of max, the bounds
   of tests/test_pallas_rho.py (the TPU kernel emulates f32 products in
   three bf16 passes).
2. f64: against the f64 scan through make_step_fn on the matrix-form RHS,
   states to 1e-10, and the hand-written backward against torch.autograd
   through the port's complex time loop to 1e-9 of max.
3. The contract: no stack cotangent, E candidates equal E single runs, no
   jump operators, the refusal past N = 64, the solver planes, and the
   launch shapes of both kernels (a cluster of CTAs per density matrix).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the matrices are tiny: one thread per test process, so that test
# processes running side by side do not fight over the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from quandary_tpu.ops.pallas_rho import _planes  # noqa: E402
from quandary_tpu.ops.pallas_rho import make_rho_propagate as jmake  # noqa: E402
from quandary_tpu.ops.steppers import make_step_fn as jstep  # noqa: E402
from quandary_tpu_torch.ops import rho  # noqa: E402
from quandary_tpu_torch.ops.steppers import make_step_fn  # noqa: E402

SOLVERS = ["neumann", "jacobi", "split"]
N, K, B, NT, DT, ITERS = 5, 3, 2, 7, 0.01, 3


def _system(seed=0, J=2, E=None):
    """The random open system of tests/test_pallas_rho.py::_setup_kernel in
    f64: folded H_eff stack, jump operators, (N, N) generator diagonal,
    coefficient rows, initial matrices, and a target and history weights
    for a scalar loss."""
    rng = np.random.default_rng(seed)

    def herm(n):
        A = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
        return (A + A.conj().T) / 2

    stack = np.stack([herm(N) for _ in range(K)]).astype(np.complex128)
    Ls = [0.3 * (rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N)))
          for _ in range(J)]
    if Ls:
        stack[0] = stack[0] - 0.5j * sum(L.conj().T @ L for L in Ls)
    h = np.diagonal(stack[0])
    gd = -1j * (h[:, None] - np.conj(h)[None, :])
    for L in Ls:
        dl = np.diagonal(L)
        gd = gd + dl[:, None] * np.conj(dl)[None, :]
    C = rng.normal(size=(NT, K) if E is None else (E, NT, K)) * 0.5
    C[..., 0] = 1.0
    x0 = rng.normal(size=(B, N, N)) + 1j * rng.normal(size=(B, N, N))
    tgt = rng.normal(size=(B, N, N)) + 1j * rng.normal(size=(B, N, N))
    w = rng.normal(size=NT)
    return stack, Ls, gd, C, x0, tgt, w


def _rhs_jax(stack, Ls, dtype):
    stackj = jnp.asarray(stack.astype(dtype))
    Lj = jnp.asarray(np.stack(Ls).astype(dtype)) if Ls else None

    def rhs(c, x):
        A = jnp.tensordot(c.astype(dtype), stackj, axes=1)
        out = -1j * (jnp.einsum("ij,bjk->bik", A, x)
                     - jnp.einsum("bij,jk->bik", x, A.conj().T))
        if Lj is not None:
            out = out + jnp.einsum("cij,bjl,ckl->bik", Lj, x, Lj.conj())
        return out
    return rhs


def _scan(step):
    def traj(Cj, x0j):
        def body(x, c):
            xn = step(x, c[None, :])
            return xn, xn
        return jax.lax.scan(body, x0j, Cj)
    return traj


def _loss_jax(xT, hist, tgt, w):
    return (jnp.sum(jnp.real(jnp.conj(jnp.asarray(tgt)) * xT))
            + jnp.sum(jnp.asarray(w)[:, None, None, None] * jnp.real(hist)))


def _plain_run(stack, Ls, gd, solver, C, x0, tgt, w, dtype):
    """(xT, hist, C-bar, x0-bar) of the port's plain version under the loss
    of _loss_jax, as complex / real numpy arrays."""
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    plan = rho.make_plan(t(stack.real), t(stack.imag), Ls or None, DT, ITERS,
                         gd, solver)
    Cg = t(C).requires_grad_()
    x0r, x0i = t(x0.real).requires_grad_(), t(x0.imag).requires_grad_()
    Ce = Cg if Cg.dim() == 3 else Cg[None]
    xTr, xTi, hr, hi = rho.rho_propagate(plan, x0r, x0i, Ce)
    loss = torch.sum(t(tgt.real) * xTr + t(tgt.imag) * xTi) \
        + torch.sum(t(w)[:, None, None, None] * hr)
    loss.backward()
    cx = lambda r, i: (r.detach().numpy() + 1j * i.detach().numpy())
    # JAX's cotangent of a complex input is the conjugate gradient
    return (cx(xTr, xTi), cx(hr, hi), Cg.grad.numpy(),
            x0r.grad.numpy() - 1j * x0i.grad.numpy())


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("solver", SOLVERS)
def test_plain_f32_matches_pallas_interpret(solver):
    stack, Ls, gd, C, x0, tgt, w = _system()
    stackc = stack.astype(np.complex64)
    Lsc = [L.astype(np.complex64) for L in Ls]
    C32, x032 = C.astype(np.float32), x0.astype(np.complex64)
    prop = jmake(stackc, Lsc, DT, ITERS, gen_diag=gd, linsolver=solver,
                 interpret=True)
    Sr, Si = (jnp.asarray(p) for p in _planes(stackc, 128))

    def kernel(Cj, x0j):
        return prop(Sr, Si, x0j, Cj)

    xTj, hj = kernel(jnp.asarray(C32), jnp.asarray(x032))
    gCj, gxj = jax.grad(lambda c, x: _loss_jax(*kernel(c, x), tgt, w),
                        argnums=(0, 1))(jnp.asarray(C32), jnp.asarray(x032))
    xT, hist, gC, gx = _plain_run(stackc, Lsc, gd, solver, C32, x032, tgt, w,
                                  torch.float32)
    assert xT.dtype == np.complex64
    assert _rel(xT[0], xTj) < 2e-4 and _rel(hist[0], hj) < 2e-4
    assert _rel(gC, gCj) < 5e-4 and _rel(gx, gxj) < 5e-4


@pytest.mark.parametrize("njump", [2, 0])
@pytest.mark.parametrize("solver", SOLVERS)
def test_plain_f64_matches_jax_scan(solver, njump):
    stack, Ls, gd, C, x0, tgt, w = _system(seed=1, J=njump)
    step = jstep(_rhs_jax(stack, Ls, jnp.complex128), DT, "IMR", ITERS,
                 solver, gen_diag=gd)
    traj = _scan(step)
    xTj, hj = traj(jnp.asarray(C), jnp.asarray(x0))
    gCj, gxj = jax.grad(lambda c, x: _loss_jax(*traj(c, x), tgt, w),
                        argnums=(0, 1))(jnp.asarray(C), jnp.asarray(x0))
    xT, hist, gC, gx = _plain_run(stack, Ls, gd, solver, C, x0, tgt, w,
                                  torch.float64)
    assert _rel(xT[0], xTj) < 1e-10 and _rel(hist[0], hj) < 1e-10
    assert _rel(gC, gCj) < 1e-9 and _rel(gx, gxj) < 1e-9


@pytest.mark.parametrize("solver", SOLVERS)
def test_handwritten_backward_matches_autograd(solver):
    """rho_propagate_plain's transpose against torch.autograd through the
    port's complex time loop (make_step_fn on the matrix-form rhs), f64."""
    stack, Ls, gd, C, x0, tgt, w = _system(seed=2)
    sc, Lc = torch.tensor(stack), torch.tensor(np.stack(Ls))

    def rhs(c, x):
        A = torch.tensordot(c.to(torch.complex128), sc, dims=1)
        out = -1j * (A @ x - x @ A.conj().T)
        return out + torch.sum(
            Lc @ x.unsqueeze(-3) @ Lc.conj().transpose(-1, -2), dim=-3)

    step = make_step_fn(rhs, DT, "IMR", ITERS, solver, gen_diag=gd)
    Cg = torch.tensor(C).requires_grad_()
    xr = torch.tensor(x0.real).requires_grad_()
    xi = torch.tensor(x0.imag).requires_grad_()
    x, hist = torch.complex(xr, xi), []
    for n in range(NT):
        x = step(x, Cg[n][None, :])
        hist.append(x)
    hist = torch.stack(hist)
    loss = torch.sum((torch.tensor(tgt).conj() * x).real) \
        + torch.sum(torch.tensor(w)[:, None, None, None] * hist.real)
    loss.backward()
    xT, h, gC, gx = _plain_run(stack, Ls, gd, solver, C, x0, tgt, w,
                               torch.float64)
    assert _rel(xT[0], x.detach().numpy()) < 1e-12
    assert _rel(h[0], hist.detach().numpy()) < 1e-12
    assert _rel(gC, Cg.grad.numpy()) < 1e-9
    assert _rel(gx, xr.grad.numpy() - 1j * xi.grad.numpy()) < 1e-9


def test_candidates_equal_single_runs_and_stacks_get_no_cotangent():
    stack, Ls, gd, C, x0, tgt, w = _system(seed=3, E=3)
    many = _plain_run(stack, Ls, gd, "jacobi", C, x0, tgt, w, torch.float64)
    gx = 0
    for e in range(3):
        one = _plain_run(stack, Ls, gd, "jacobi", C[e], x0, tgt, w,
                         torch.float64)
        for a, b in zip(many[:2], one[:2]):
            np.testing.assert_allclose(a[e], b[0], rtol=0, atol=1e-13)
        np.testing.assert_allclose(many[2][e], one[2], rtol=0, atol=1e-13)
        gx = gx + one[3]
    # x0 is shared: its cotangent sums over the candidates
    np.testing.assert_allclose(many[3], gx, rtol=0, atol=1e-12)

    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
    Sr, Si = t(stack.real).requires_grad_(), t(stack.imag).requires_grad_()
    prop = rho.make_rho_propagate(Ls, DT, ITERS, gd, "jacobi")
    Cg = t(C[0]).requires_grad_()
    (xTr, xTi), (hr, hi) = prop(Sr, Si, (t(x0.real), t(x0.imag)), Cg)
    assert xTr.shape == (B, N, N) and hr.shape == (NT, B, N, N)
    torch.sum(xTr * xTi + hr[2]).backward()
    assert Sr.grad is None and Si.grad is None and Cg.grad is not None


def test_solver_planes_and_launch_refusal():
    _, _, gd, *_ = _system()
    assert rho.solver_planes(gd, DT, "neumann").size == 0
    jac = rho.solver_planes(gd, DT, "jacobi")
    spl = rho.solver_planes(gd, DT, "split")
    assert jac.shape == spl.shape == (4, N, N)
    np.testing.assert_array_equal(jac[0] + 1j * jac[1], gd)
    np.testing.assert_allclose(jac[2] + 1j * jac[3],
                               1 / (1 - 0.5 * DT * gd), rtol=1e-15)
    np.testing.assert_allclose(spl[0] + 1j * spl[1], np.exp(0.5 * DT * gd),
                               rtol=1e-15)
    np.testing.assert_array_equal(spl[2] + 1j * spl[3], gd)
    with pytest.raises(ValueError, match="gen_diag"):
        rho.solver_planes(None, DT, "split")
    with pytest.raises(NotImplementedError):
        rho.solver_planes(gd, DT, "gmres")
    # one CTA holds N <= 64; the tile is the entries per thread and axis
    # (of the forward's band at G = 1, where 132 matrices fill the card)
    assert [rho._fwd_shape(1, 132, n, 7, 4)[1] for n in (16, 27, 32, 33, 64)] \
        == [1, 2, 2, 2, 4]
    assert rho.launch_refusal(64, 7) is None
    assert "N = 65" in rho.launch_refusal(65, 7)
    # the gate on bytes of the stored stage iterates
    t = torch.zeros(3, 64, 64)
    plan = rho.make_plan(t, t, None, DT, 6)
    assert rho.stores_iterates(plan, 1, 1000, 3)
    assert not rho.stores_iterates(plan, 8, 1000, 3)
    assert rho.launch_counts() == dict(rho_fwd_launches=0, rho_bwd_launches=0)


@pytest.mark.parametrize("EB,J", [(1, 4), (3, 6), (16, 0), (128, 4),
                                  (264, 6)])
@pytest.mark.parametrize("n", [4, 16, 27, 32, 33, 64])
def test_rho_bwd_launch_shape(n, EB, J):
    """The backward's launch shape (a cluster of G CTAs per density matrix,
    each on a band of rows) against the layout csrc/rho.cu carves: every
    CTA owns a row, whole warps cover the band's tiles and the stack slots,
    the shared memory holds the mbarriers, M, the operand and the pair's
    input (two buffers each), the C-bar partials and at least one jump band
    (all J where G >= 4), and one matrix per SM keeps G = 1."""
    k = 7
    G, tile, threads, smem = rho._bwd_shape(1, EB, n, k, J)
    assert G in (1, 2, 4, 8, 16)
    assert min((q + 1) * n // G - q * n // G for q in range(G)) >= 1
    R, ld = -(-n // G), n | 1
    tiles = -(-R // tile) * -(-n // tile)
    assert threads % 32 == 0 and max(tiles, k) <= threads
    assert threads <= (256 if tile == 4 else 512) <= 1024
    layout = lambda jb: 4 * (8 + 10 * n * ld + 2 * jb * R * ld
                             + (threads // 32 + G) * k)
    assert layout(min(J, 1)) <= smem <= 227 * 1024
    if G >= 4:
        assert smem >= layout(J)
    if EB >= 132:
        assert G == 1
    if n in (27, 64) and EB <= 3:
        assert G > 1
    # a forced G is taken as it is, within 1..16 and at most N
    assert rho._bwd_shape(1, EB, n, k, J, G=2)[0] == 2
    with pytest.raises(ValueError):
        rho._bwd_shape(1, EB, n, k, J, G=3)
    # the range of the kernels is unchanged
    assert rho.launch_refusal(64, k) is None
    assert "N = 65" in rho.launch_refusal(65, k)


def test_rho_bwd_takes_sixteen_only_where_the_card_holds_them():
    """Clusters of 16 CTAs are beyond the portable size: the rule asks the
    library's occupancy query, and takes 8 where the card holds none of
    16; a G asked for is never changed."""
    class Lib:
        def __init__(self, n):
            self.n, self.asked = n, []

        def rho_bwd_max_clusters(self, *shape):
            self.asked.append(shape)
            return self.n

    t = torch.zeros(7, 64, 64)
    plan = rho.make_plan(t, t, [np.eye(64)] * 4, DT, 6)
    # trailing arguments: tile, G, threads, shared-memory bytes
    yes, no = Lib(1), Lib(0)
    assert rho._bwd_args(yes, plan, 1, 10, 3, True)[-3] == 16
    assert yes.asked == [rho._bwd_shape(1, 3, 64, 7, 4)[1:2] + (16,)
                         + rho._bwd_shape(1, 3, 64, 7, 4)[2:]]
    assert rho._bwd_args(no, plan, 1, 10, 3, True)[-4:] \
        == rho._bwd_shape(1, 3, 64, 7, 4, max_g=8)[1:2] + (8,) \
        + rho._bwd_shape(1, 3, 64, 7, 4, max_g=8)[2:]
    assert rho._bwd_args(Lib(0), plan, 1, 10, 3, True, 16)[-3] == 16
    # N = 16 with 16 matrices stays far below 16 CTAs: no query
    small = Lib(0)
    s16 = torch.zeros(7, 16, 16)
    rho._bwd_args(small, rho.make_plan(s16, s16, None, DT, 8), 1, 10, 16,
                  True)
    assert small.asked == []


@pytest.mark.parametrize("EB,J", [(1, 4), (3, 6), (16, 0), (128, 4),
                                  (264, 6)])
@pytest.mark.parametrize("n", [4, 16, 27, 32, 33, 64])
def test_rho_fwd_launch_shape(n, EB, J):
    """The forward's launch shape (a cluster of G CTAs per density matrix,
    each on a band of rows) against the layout csrc/rho.cu carves: every
    CTA owns a row, whole warps cover the band's tiles, the shared memory
    holds the mbarriers, M, the operand's two buffers and at least one jump
    band (all J where G >= 4), one matrix per SM keeps G = 1, and the rule
    picks the backward's G."""
    k = 7
    G, tile, threads, smem = rho._fwd_shape(1, EB, n, k, J)
    assert G in (1, 2, 4, 8, 16)
    assert G == rho._bwd_shape(1, EB, n, k, J)[0]
    assert min((q + 1) * n // G - q * n // G for q in range(G)) >= 1
    R, ld = -(-n // G), n | 1
    tiles = -(-R // tile) * -(-n // tile)
    assert threads % 32 == 0 and tiles <= threads < tiles + 32
    assert threads <= (256 if tile == 4 else 512) <= 1024
    layout = lambda jb: 4 * (8 + 6 * n * ld + 2 * jb * R * ld)
    assert layout(min(J, 1)) <= smem <= rho.cuda_build.MAX_SMEM
    assert (smem - layout(0)) % (8 * R * ld) == 0
    if G >= 4:
        assert smem >= layout(J)
    if EB >= 132:
        assert G == 1
    if n in (27, 64) and EB <= 3:
        assert G > 1
    # a forced G is taken as it is, within 1..16 and at most N
    assert rho._fwd_shape(1, EB, n, k, J, G=2)[0] == 2
    with pytest.raises(ValueError):
        rho._fwd_shape(1, EB, n, k, J, G=3)
    # the range of the kernels is unchanged
    assert rho.launch_refusal(n, k) is None
    assert "N = 65" in rho.launch_refusal(65, k)


def test_rho_fwd_takes_sixteen_only_where_the_card_holds_them():
    """The forward's clusters of 16 CTAs go through the same occupancy
    query as the backward's (rho_fwd_max_clusters), and 8 is taken where
    the card holds none of 16; a G asked for is never changed."""
    class Lib:
        def __init__(self, n):
            self.n, self.asked = n, []

        def rho_fwd_max_clusters(self, *shape):
            self.asked.append(shape)
            return self.n

    t = torch.zeros(7, 64, 64)
    plan = rho.make_plan(t, t, [np.eye(64)] * 4, DT, 6)
    # trailing arguments: tile, G, threads, shared-memory bytes
    yes, no = Lib(1), Lib(0)
    assert rho._fwd_args(yes, plan, 1, 10, 3, True)[-3] == 16
    assert yes.asked == [rho._fwd_shape(1, 3, 64, 7, 4)[1:2] + (16,)
                         + rho._fwd_shape(1, 3, 64, 7, 4)[2:]]
    assert rho._fwd_args(no, plan, 1, 10, 3, True)[-4:] \
        == rho._fwd_shape(1, 3, 64, 7, 4, max_g=8)[1:2] + (8,) \
        + rho._fwd_shape(1, 3, 64, 7, 4, max_g=8)[2:]
    assert rho._fwd_args(Lib(0), plan, 1, 10, 3, True, 16)[-3] == 16
    # N = 16 with 16 matrices stays far below 16 CTAs: no query
    small = Lib(0)
    s16 = torch.zeros(7, 16, 16)
    assert rho._fwd_args(small, rho.make_plan(s16, s16, None, DT, 8), 1, 10,
                         16, True)[-3] == 1
    assert small.asked == []


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """The dispatch sends a CUDA tensor to the kernels and a CPU tensor to
    the plain version; no other device has a path."""
    calls = []
    monkeypatch.setattr(rho, "rho_propagate_kernel",
                        lambda *a: calls.append("kernel"))
    monkeypatch.setattr(rho, "rho_propagate_plain",
                        lambda *a: calls.append("plain"))

    class On:
        def __init__(self, kind):
            self.device = torch.device(kind)

    rho.rho_propagate(None, None, None, On("cuda"))
    rho.rho_propagate(None, None, None, On("cpu"))
    assert calls == ["kernel", "plain"]
    with pytest.raises(NotImplementedError):
        rho.rho_propagate(None, None, None, On("meta"))
