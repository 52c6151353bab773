"""quandary_tpu_torch.ops.streamk.make_streamk_packed_propagate with
per_block_stacks against the TPU kernel it ports,
quandary_tpu.ops.pallas_stream.make_streamk_packed_propagate, run in Pallas
interpret mode on the CPU: G candidates, each with its own operator stack
and its own solver rows, one shared x0.

The port's plain torch version (the CPU path and the CUDA kernels' oracle)
must give the same final states, histories and gradients (coefficients and
x0) of a weighted loss for every stage solver. Bounds as in
test_torch_streamk.py: 2e-6 x max|ref| against the exact-f32 kernels
('highest'), 1e-3 x max|ref| against the shipping 3-pass bf16 default
('high'). Against G single runs of the port's own B1 path the packed
version is exact to 1e-6."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from quandary_tpu.ops import pallas_stream  # noqa: E402
from quandary_tpu_torch.ops import streamk  # noqa: E402

G, K, N, B, NT, DT = 3, 4, 12, 3, 9, 0.01
SOLVERS = ("neumann", "jacobi", "split")
NAMES = ("xTr", "xTi", "hist_r", "hist_i", "dCg", "dx0r", "dx0i")


def _case(seed=0):
    rng = np.random.default_rng(seed)
    stack = (rng.normal(size=(G, K, N, N))
             + 1j * rng.normal(size=(G, K, N, N))).astype(np.complex64)
    f32 = lambda a: a.astype(np.float32)
    return dict(
        stack=stack,
        gen_diag=np.stack([-1j * np.diag(s[0]) for s in stack]).astype(
            np.complex128),
        x0r=f32(rng.normal(size=(B, N))), x0i=f32(rng.normal(size=(B, N))),
        Cg=f32(rng.normal(size=(NT, G, K)) * 0.3),
        wTr=f32(rng.normal(size=(G, B, N))),
        wTi=f32(rng.normal(size=(G, B, N))),
        whr=f32(rng.uniform(0.1, 1.0, (NT, G, B, N))),
        whi=f32(rng.normal(size=(NT, G, B, N))),
    )


def _loss(xp, c, xT, hist):
    (xTr, xTi), (hr, hi) = xT, hist
    return (xp.sum(c["wTr"] * xTr) + xp.sum(c["wTi"] * xTi)
            + xp.sum(c["whr"] * hr * hr) + 0.5 * xp.sum(c["whi"] * hi))


def _jax_run(c, solver, iters):
    prop = pallas_stream.make_streamk_packed_propagate(
        c["stack"], DT, iters, gen_diag=c["gen_diag"], linsolver=solver,
        interpret=True, per_block_stacks=True, real_io=True)
    Sr, Si = jnp.asarray(c["stack"].real), jnp.asarray(c["stack"].imag)

    def f(Cg, x0r, x0i):
        xT, hist = prop(Sr, Si, (x0r, x0i), Cg)
        return _loss(jnp, c, xT, hist), (xT, hist)

    (_, (xT, hist)), grads = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(c["Cg"]), jnp.asarray(c["x0r"]),
            jnp.asarray(c["x0i"]))
    return [np.asarray(a) for a in (*xT, *hist, *grads)]


def _torch_run(c, solver, iters, dtype=torch.float32):
    prop = streamk.make_streamk_packed_propagate(
        DT, iters, gen_diag=c["gen_diag"], linsolver=solver, group=G,
        per_block_stacks=True)
    t = lambda a: torch.tensor(a, dtype=dtype)
    Cg, x0r, x0i = (t(c[k]).requires_grad_() for k in ("Cg", "x0r", "x0i"))
    xT, hist = prop(t(c["stack"].real), t(c["stack"].imag), (x0r, x0i), Cg)
    _loss(torch, {k: t(v) for k, v in c.items() if k[0] == "w"},
          xT, hist).backward()
    return [a.detach().numpy() for a in (*xT, *hist, Cg.grad, x0r.grad,
                                         x0i.grad)]


@pytest.mark.parametrize("solver,iters,precision,bound", [
    ("neumann", 3, "highest", 2e-6), ("jacobi", 3, "highest", 2e-6),
    ("jacobi", 6, "highest", 2e-6), ("split", 3, "highest", 2e-6),
    ("split", 6, "highest", 2e-6), ("neumann", 3, "high", 1e-3),
    ("jacobi", 6, "high", 1e-3), ("split", 3, "high", 1e-3)])
def test_plain_packed_matches_pallas_per_block_stacks(solver, iters,
                                                      precision, bound,
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


@pytest.mark.parametrize("solver", SOLVERS)
def test_packed_matches_single_runs(solver):
    """Candidate g of the packed run is the port's single-candidate run on
    stack g with gen_diag g: states, coefficient gradient, and the x0
    gradient as the sum over the candidates (x0 is shared)."""
    c = _case(3)
    got = _torch_run(c, solver, 3)
    gx0 = [np.zeros((B, N), np.float32), np.zeros((B, N), np.float32)]
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    for g in range(G):
        prop = streamk.make_streamk_propagate(
            DT, 3, gen_diag=c["gen_diag"][g], linsolver=solver)
        C, x0r, x0i = (t(a).requires_grad_()
                       for a in (c["Cg"][:, g], c["x0r"], c["x0i"]))
        xT, hist = prop(t(c["stack"][g].real), t(c["stack"][g].imag),
                        (x0r, x0i), C)
        cg = {k: t(v[g] if k[1] == "T" else v[:, g])
              for k, v in c.items() if k[0] == "w"}
        _loss(torch, cg, xT, hist).backward()
        single = [a.detach().numpy() for a in (*xT, *hist, C.grad)]
        packed = [got[0][g], got[1][g], got[2][:, g], got[3][:, g],
                  got[4][:, g]]
        for name, a, b in zip(NAMES, packed, single):
            assert np.abs(a - b).max() <= 1e-6 * max(np.abs(b).max(), 1.0), \
                (name, g)
        gx0[0] += x0r.grad.numpy()
        gx0[1] += x0i.grad.numpy()
    for a, b in zip(got[5:], gx0):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def test_packed_shared_stack_is_the_candidate_axis():
    """Without per_block_stacks the packed layout is the B1 candidate axis
    transposed: Cg (ntime, G, K) in, hist (ntime, G, B, N) out."""
    c = _case(5)
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    Sr, Si = t(c["stack"][0].real), t(c["stack"][0].imag)
    x0 = (t(c["x0r"]), t(c["x0i"]))
    packed = streamk.make_streamk_packed_propagate(
        DT, 3, gen_diag=c["gen_diag"][0], linsolver="split")
    plain = streamk.make_streamk_propagate(
        DT, 3, gen_diag=c["gen_diag"][0], linsolver="split")
    (xTr, _), (hr, _) = packed(Sr, Si, x0, t(c["Cg"]))
    (xTr1, _), (hr1, _) = plain(Sr, Si, x0, t(c["Cg"]).transpose(0, 1))
    assert hr.shape == (NT, G, B, N) and xTr.shape == (G, B, N)
    torch.testing.assert_close(hr, hr1.transpose(0, 1), rtol=0, atol=0)
    torch.testing.assert_close(xTr, xTr1, rtol=0, atol=0)


def test_packed_plan_validation():
    """A per-block plan refuses a gen_diag of another shape, a coefficient
    batch of another group size, and stacks of the wrong rank."""
    c = _case(6)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    Sr, Si = t(c["stack"].real), t(c["stack"].imag)
    with pytest.raises(ValueError, match="gen_diag"):
        streamk.make_plan(Sr, Si, DT, 3, c["gen_diag"][0], "split")
    plan = streamk.make_plan(Sr, Si, DT, 3, c["gen_diag"], "split")
    assert plan.per_block and plan.Ke == K + 1
    assert plan.Sr.shape == (G, K + 1, N, N) and plan.rows.shape == (G, 2, N)
    Ce = streamk.extend_coeffs(plan, t(c["Cg"]).transpose(0, 1)[:2])
    with pytest.raises(ValueError, match="candidates"):
        streamk.streamk_propagate(plan, t(c["x0r"]), t(c["x0i"]), Ce)
    prop = streamk.make_streamk_packed_propagate(
        DT, 3, gen_diag=c["gen_diag"], linsolver="split", group=G + 1,
        per_block_stacks=True)
    with pytest.raises(ValueError, match="group"):
        prop(Sr, Si, (t(c["x0r"]), t(c["x0i"])), t(c["Cg"]))
    with pytest.raises(ValueError, match="per_block_stacks"):
        streamk.make_streamk_packed_propagate(DT, 3, per_block_stacks=True)(
            Sr[0], Si[0], (t(c["x0r"]), t(c["x0i"])), t(c["Cg"]))


def test_launch_refusal_names_the_limit():
    """The admission gate of the kernels: past B*N = 1024 state entries or
    227 KB of shared memory a sentence names the limit, and _launch_shape
    raises it; inside both limits it is None."""
    z = lambda *s: torch.zeros(s)
    small = streamk.make_plan(z(K, N, N), z(K, N, N), DT, 3)
    assert streamk.launch_refusal(small, B, N) is None
    threads, smem = streamk._launch_shape(small, B, N, backward=True)
    assert threads % 32 == 0 and threads >= B * N and 0 < smem < 48 * 1024
    assert "1024" in streamk.launch_refusal(small, 100, N)
    with pytest.raises(NotImplementedError, match="B\\*N = 1200"):
        streamk._launch_shape(small, 100, N, backward=False)
    big = streamk.make_plan(z(8, 64, 64), z(8, 64, 64), DT, 3)
    assert "shared memory" in streamk.launch_refusal(big, 4, 64)


def test_build_kernels_loads_once_per_process(monkeypatch, tmp_path):
    """build_kernels reads and hashes the source once: the second call
    returns the loaded library without opening a file."""
    src = tmp_path / "k.cu"
    src.write_text("// no kernel")
    lib = tmp_path / "lib.so"
    monkeypatch.setattr(streamk, "_SRC", str(src))
    monkeypatch.setitem(streamk._LIBS, str(src), (object(), str(lib)))
    src.unlink()
    assert streamk.build_kernels() == (str(lib), 0.0, "")
