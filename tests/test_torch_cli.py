"""quandary_tpu_torch's config-file CLI against quandary_tpu's.

1. cli.run of config_template.cfg for the four runtypes (simulation,
   gradient, optimization, evalcontrols) in both packages, file by file:
   config_log.dat byte-equal, every other file to 1e-10 relative (each
   against its largest entry), the optimization's files to 1e-8. The
   template's time grid is cut from 1000 steps of 0.1 ns to 200 of 0.5 ns
   and the optimization to 2 iterations, for the CPU;
2. `python -m quandary_tpu_torch --device cpu` in a subprocess that never
   imports JAX;
3. without `device`, Quandary(...) and cli.run raise RuntimeError naming
   device="cpu" where there is no CUDA device;
4. the route gate (Setup.fused): 'auto' takes the plain loop off CUDA and
   admits exactly the JAX package's pallas gate on CUDA; a forced fused
   route refuses what it does not take, by name.
"""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_api import _assert_files  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(tmp_path, runtype, **keys):
    with open(os.path.join(ROOT, "config_template.cfg")) as f:
        text = f.read()
    keys = dict(dict(runtype=runtype, ntime="200", dt="0.5",
                     optim_maxiter="2"), **keys)
    for k, v in keys.items():
        text, n = re.subn(rf"^{k}\s*=.*$", f"{k} = {v}", text, flags=re.M)
        assert n == 1, k
    tmp_path.mkdir(parents=True, exist_ok=True)
    p = tmp_path / "config.cfg"
    p.write_text(text)
    return str(p)


@pytest.mark.parametrize("runtype", ["simulation", "gradient",
                                     "optimization", "evalcontrols"])
def test_cli_run_matches_jax(tmp_path, runtype):
    from quandary_tpu.cli import run as jrun
    from quandary_tpu_torch.cli import run as trun
    rj = jrun(_config(tmp_path / "jax", runtype))
    rt = trun(_config(tmp_path / "torch", runtype), device="cpu")
    assert rt["runtype"] == rj["runtype"] == runtype
    assert rt["problem"].fused_form is None
    for name in ("config_log.dat",):
        with open(os.path.join(rt["datadir"], name), "rb") as a, \
                open(os.path.join(rj["datadir"], name), "rb") as b:
            assert a.read() == b.read()
    rtol = 1e-8 if runtype == "optimization" else 1e-10
    _assert_files(rt["datadir"], rj["datadir"], rtol)
    for key in ("objective", "fidelity", "infidelity"):
        if key in rj:
            assert abs(rt[key] - rj[key]) <= rtol * max(abs(rj[key]), 1.0)
    if runtype == "gradient":
        g = np.asarray(rj["gradient"])
        np.testing.assert_allclose(rt["gradient"], g, rtol=0,
                                   atol=1e-10 * np.abs(g).max())


def test_module_runs_without_jax(tmp_path):
    """`python -m quandary_tpu_torch config.cfg --device cpu`, executed as
    the interpreter executes `-m`, with JAX unimportable."""
    cfg = _config(tmp_path, "simulation")
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.argv = ['quandary_tpu_torch', {cfg!r}, '--device', 'cpu',"
        " '--quiet']\n"
        "try:\n"
        "    runpy.run_module('quandary_tpu_torch', run_name='__main__',"
        " alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "assert sys.modules.get('jax') is None\n"
        "assert not any(m.startswith(('jax.', 'quandary_tpu.'))"
        " for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")
    out = tmp_path / "data_out"
    assert (out / "optim_history.dat").exists()
    assert (out / "population1.iinit0003.dat").exists()


def test_main_arguments(tmp_path, capsys):
    from quandary_tpu_torch.cli import main
    assert main([]) == 1
    assert main([_config(tmp_path, "evalcontrols"), "--device"]) == 1
    assert main([_config(tmp_path, "evalcontrols"), "--quiet", "--device",
                 "cpu"]) == 0
    assert (tmp_path / "data_out" / "control1.dat").exists()


def test_no_device_without_cuda_raises(tmp_path, monkeypatch):
    from quandary_tpu_torch import Quandary
    from quandary_tpu_torch.cli import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Quandary(Ne=[2], freq01=[4.1], T=5.0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        run(_config(tmp_path, "evalcontrols"))
    q = Quandary(Ne=[2], freq01=[4.1], T=5.0, device="cpu")
    assert q.device == "cpu"


def _flagship(**kw):
    from test_torch_model import flagship_setup
    return dataclasses.replace(flagship_setup("torch"), **kw)


@pytest.mark.parametrize("change,cuda_route", [
    (dict(), "streamk"),
    (dict(fused_mode="stream"), "stream"),
    (dict(dtype=torch.complex128), None),
    (dict(timestepper="IMR4"), None),
    (dict(linsolver="gmres"), None),
    (dict(fused_mode="chunk"), None),          # split: chunk takes neumann
])
def test_fused_auto_gate(change, cuda_route):
    """fused='auto': the plain loop on the CPU; on CUDA the fused route
    exactly where the JAX package's pallas gate admits the problem (the
    gate itself is evaluated here as it would be on the card)."""
    from quandary_tpu_torch.problem import Problem
    p = Problem(_flagship(fused="auto", **change), device="cpu")
    assert not p.use_fused and p.fused_form is None
    assert (p._fused_gate_refusal(True) is None) == (cuda_route is not None)


def test_fused_auto_gate_matches_jax():
    """The size half of the gate: the JAX package's budgets decide, for
    closed and open systems, with the JAX Problem's own verdict on the
    same Setup (pallas=True asks its gate without a TPU)."""
    import jax.numpy as jnp
    from quandary_tpu.problem import Problem as JProblem
    from quandary_tpu_torch.problem import Problem, _jax_size_gate
    from test_torch_lindblad import guarded_setup
    from test_torch_model import flagship_setup, port_setup
    for sj in (flagship_setup("jax"), guarded_setup(dtype=jnp.complex64)):
        pj = JProblem(dataclasses.replace(sj, pallas=True))
        pt = Problem(port_setup(sj, fused="auto"), device="cpu")
        assert _jax_size_gate(pt, pt.setup) == pj.use_pallas


@pytest.mark.parametrize("change,match", [
    (dict(timestepper="IMR8"), "timestepper"),
    (dict(linsolver="gmres"), "gmres"),
    (dict(engine="grouped"), None),
    (dict(time_parallel=True, linsolver="jacobi"), None),
    (dict(adjoint="reversible"), None),
])
def test_forced_fused_and_unported_refused(change, match):
    """What the forced fused route or the port does not take raises by
    name (match); the engine, time-parallel and adjoint settings run (match
    None): a HamiltonianModel keeps the dense engine under any engine, as
    in the JAX package, the fused route owns propagation under
    time_parallel=True, and on the plain route the time-parallel scan and
    the reversible adjoint give the J and gradient of the sequential loop
    with the stored adjoint."""
    from quandary_tpu_torch.problem import Problem
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            Problem(_flagship(**change), device="cpu")
        return
    p = Problem(_flagship(**change), device="cpu")
    assert type(p.engine).__name__ == "DenseEngine" and p.use_fused
    assert not p.time_parallel
    # in f64, without dpdm, which keeps the stored states (as in the JAX
    # package), against the same problem on the sequential loop
    same = {k: v for k, v in change.items()
            if k not in ("adjoint", "time_parallel")}
    plain = [Problem(_flagship(fused=False, gamma_penalty_dpdm=0.0,
                               dtype=torch.complex128, **kw), device="cpu")
             for kw in (change, dict(same, time_parallel=False))]
    route = "reversible" if "adjoint" in change else "stored"
    assert [q.adjoint_route for q in plain] == [route, "stored"]
    assert [q.time_parallel for q in plain] == ["time_parallel" in change,
                                                False]
    x = np.random.default_rng(0).uniform(-1, 1, p.setup.nparams) * 0.02
    (J0, _), g0 = plain[0].build_value_and_grad()(x, x)
    (J1, _), g1 = plain[1].build_value_and_grad()(x, x)
    np.testing.assert_allclose(float(J0), float(J1), rtol=1e-12)
    assert (g0 - g1).abs().max() <= 1e-9 * g1.abs().max()


def test_plain_route_problem_surface():
    """propagate_trajectory / _final, eval_J_per_state and initids on the
    plain route's sequential loop (time_parallel=False; 'auto' takes the
    scan at this size, tests/test_torch_time_parallel.py) against the JAX
    Problem in f64."""
    import jax.numpy as jnp
    from quandary_tpu.problem import Problem as JProblem
    from quandary_tpu_torch.problem import Problem
    from test_torch_model import port_setup, qudit_setup
    sj = qudit_setup("jax")
    pj = JProblem(sj)
    pt = Problem(port_setup(sj, fused="auto", time_parallel=False),
                 device="cpu")
    assert not pt.time_parallel
    x = np.random.default_rng(1).normal(size=sj.nparams) * 0.05
    tj = np.asarray(pj.build_propagate_trajectory()(jnp.asarray(x)))
    tt = pt.build_propagate_trajectory()(x).numpy()
    np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(pt.build_propagate_final()(x).numpy(), tj[-1],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        pt.eval_J_per_state(torch.as_tensor(tt)).numpy(),
        np.asarray(pj.eval_J_per_state(jnp.asarray(tj))), rtol=0, atol=1e-12)
    assert list(pt.initids) == list(pj.initids)
