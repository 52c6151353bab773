"""quandary_tpu_torch.optim.driver against quandary_tpu.optim.driver on the
small f64 CNOT flagship (history, durable files, resume, the truncation
warning), and the port's independence from JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_model import flagship_setup, port_setup  # noqa: E402


def test_lbfgsb_history_matches_jax():
    """Three L-BFGS-B iterations (strong Wolfe line search, box bounds):
    the objective history agrees to rtol 1e-8."""
    from quandary_tpu.optim.driver import build_bounds as jbounds
    from quandary_tpu.optim.driver import run_optimization as jrun
    from quandary_tpu.problem import Problem as JProblem
    from quandary_tpu_torch.optim.driver import build_bounds, run_optimization
    from quandary_tpu_torch.problem import Problem as TProblem

    sj = flagship_setup("jax", dtype=jnp.complex128, pallas=False)
    st = port_setup(sj)
    lb, ub = build_bounds(st.oscillators, [[0.045]] * 2)
    jlb, jub = jbounds(sj.oscillators, [[0.045]] * 2)
    x0 = np.random.default_rng(1234).uniform(-1, 1, sj.nparams) * 0.005
    rj = jrun(JProblem(sj), x0, jlb, jub, maxiter=3, verbose=False)
    rt = run_optimization(TProblem(st, device="cpu"), x0, lb, ub, maxiter=3,
                          verbose=False)
    fj = [h.objective for h in rj.history]
    ft = [h.objective for h in rt.history]
    assert len(ft) == len(fj) == 4
    np.testing.assert_allclose(ft, fj, rtol=1e-8)
    assert ft[-1] < ft[0]
    np.testing.assert_allclose([h.fidelity for h in rt.history],
                               [h.fidelity for h in rj.history], rtol=1e-8)
    np.testing.assert_allclose(rt.params, rj.params, rtol=1e-6, atol=1e-12)


def _both(maxiter_kw):
    from quandary_tpu.optim.driver import build_bounds as jbounds
    from quandary_tpu.optim.driver import run_optimization as jrun
    from quandary_tpu.problem import Problem as JProblem
    from quandary_tpu_torch.optim.driver import run_optimization
    from quandary_tpu_torch.problem import Problem as TProblem

    sj = flagship_setup("jax", dtype=jnp.complex128, pallas=False)
    lb, ub = jbounds(sj.oscillators, [[0.045]] * 2)
    x0 = np.random.default_rng(1234).uniform(-1, 1, sj.nparams) * 0.005
    pj, pt = JProblem(sj), TProblem(port_setup(sj), device="cpu")
    return (lambda **kw: jrun(pj, x0, lb, ub, verbose=False, **maxiter_kw,
                              **kw),
            lambda **kw: run_optimization(pt, x0, lb, ub, verbose=False,
                                          **maxiter_kw, **kw))


def test_datadir_files_match_jax(tmp_path):
    """With datadir the host driver streams optim_history.dat on the
    monitor stride (the final row always lands), rewrites params.dat and
    control<k>.dat, and checkpoints the L-BFGS state: the same files with
    the same numbers as the JAX driver's."""
    jrun, trun = _both(dict(maxiter=3, monitor_freq=2))
    dj, dt_ = str(tmp_path / "jax"), str(tmp_path / "torch")
    rj, rt = jrun(datadir=dj), trun(datadir=dt_)
    assert sorted(os.listdir(dt_)) == sorted(os.listdir(dj)) == [
        "control0.dat", "control1.dat", "optim_history.dat",
        "optim_state.npz", "params.dat"]
    for name in ("control0.dat", "control1.dat", "optim_history.dat",
                 "params.dat"):
        with open(os.path.join(dj, name)) as f, \
                open(os.path.join(dt_, name)) as g:
            hj = [ln for ln in f if ln.startswith("#")]
            ht = [ln for ln in g if ln.startswith("#")]
        assert ht == hj, name
        a = np.loadtxt(os.path.join(dt_, name))
        b = np.loadtxt(os.path.join(dj, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-12, err_msg=name)
    h = np.loadtxt(os.path.join(dt_, "optim_history.dat"))
    assert h[:, 0].tolist() == [0, 2, 3]        # stride 2, and the last row
    np.testing.assert_allclose(np.loadtxt(os.path.join(dt_, "params.dat")),
                               rt.params, rtol=0, atol=1e-13)
    with np.load(os.path.join(dt_, "optim_state.npz")) as zt, \
            np.load(os.path.join(dj, "optim_state.npz")) as zj:
        assert int(zt["it"]) == int(zj["it"]) == 2
        np.testing.assert_allclose(zt["x"], zj["x"], rtol=1e-6, atol=1e-12)
        assert zt["s"].shape == zj["s"].shape


def test_resume_continues_the_numbering(tmp_path):
    """resume=True restarts from optim_state.npz: the iteration numbers go
    on, optim_history.dat is appended, and the objective keeps falling."""
    _, trun = _both(dict(maxiter=2))
    d = str(tmp_path / "run")
    r1 = trun(datadir=d)
    r2 = trun(datadir=d, resume=True)
    assert [h.iter for h in r2.history] == [2, 3, 4]
    assert r2.history[-1].objective < r1.history[-1].objective
    h = np.loadtxt(os.path.join(d, "optim_history.dat"))
    assert h[:, 0].tolist() == [0, 1, 2, 3, 4]
    assert np.all(np.diff(h[:, 1]) < 0)


def test_truncation_estimate_and_warning_match_jax():
    """utils.sanity.stage_truncation_estimate against the JAX package's at
    a quiet and at a loud pulse; the host driver warns at the loud one."""
    from quandary_tpu.problem import Problem as JProblem
    from quandary_tpu.utils import sanity as jsanity
    from quandary_tpu_torch.optim.driver import warn_if_truncated
    from quandary_tpu_torch.problem import Problem as TProblem
    from quandary_tpu_torch.utils import sanity as tsanity

    sj = flagship_setup("jax", dtype=jnp.complex128, pallas=False)
    pj, pt = JProblem(sj), TProblem(port_setup(sj), device="cpu")
    rng = np.random.default_rng(3)
    for scale, ok in ((0.005, True), (3.0, False)):
        x = rng.uniform(-1, 1, sj.nparams) * scale
        ej = jsanity.stage_truncation_estimate(pj, jnp.asarray(x))
        et = tsanity.stage_truncation_estimate(pt, x)
        assert et["supported"] and et["ok"] == ej["ok"] == ok
        assert et["solver"] == ej["solver"] == "split"
        for k in ("u", "per_step_error", "horizon_error"):
            np.testing.assert_allclose(et[k], ej[k], rtol=1e-12)
    with pytest.warns(UserWarning, match="under-resolved"):
        warn_if_truncated(pt, x)
    V = np.asarray(sj.target_gate_full)
    assert tsanity.is_unitary(V) and not tsanity.is_unitary(2 * V)
    traj = np.stack([pt.x0, pt.x0 * np.exp(0.3j), pt.x0 * 1.001])
    assert tsanity.check_state_trajectory(traj[:2])["ok"]
    assert not tsanity.check_state_trajectory(traj)["ok"]


def test_package_imports_without_jax():
    """Every module of the port imports with jax blocked."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import pkgutil, importlib, quandary_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "quandary_tpu_torch.__path__, 'quandary_tpu_torch.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "assert 'quandary_tpu' not in sys.modules\n"
        "assert {'quandary_tpu_torch.ops.stream', 'quandary_tpu_torch.ops."
        "adjoint', 'quandary_tpu_torch.ops.dense', 'quandary_tpu_torch."
        "calibration', 'quandary_tpu_torch.ops.tensor_rhs', "
        "'quandary_tpu_torch.ops.grouped_rhs', 'quandary_tpu_torch.ops."
        "grouped_lindblad', 'quandary_tpu_torch.ops.reversible', "
        "'quandary_tpu_torch.ops.grouped_adjoint', 'quandary_tpu_torch."
        "ops.propagator', 'quandary_tpu_torch.ops.hostloop', "
        "'quandary_tpu_torch.optim.hessian', 'quandary_tpu_torch.parallel."
        "mesh', 'quandary_tpu_torch.parallel.multihost', "
        "'quandary_tpu_torch.profiling', 'quandary_tpu_torch.utils.cache', "
        "'quandary_tpu_torch.plots'} <= set(names)\n"
        "print(len(names))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25
