"""quandary_tpu_torch.Quandary against quandary_tpu.Quandary on the CPU.

The `Quandary(...)` cases of tests/test_api.py, each built in both packages
from one kwargs dict (the port's with device="cpu") and run through the same
entry point into its own output directory. In f64 the returned 6-tuple,
uT, and every file both write agree to 1e-10 relative (each file against
its largest entry); after an optimization, whose line searches take the
same steps, to 1e-8, as the device driver's histories in
tests/test_torch_device_driver.py. Horizons (T) and iteration counts are
cut so that each case runs in seconds on the CPU: the port's plain time
loop there is a Python loop of small tensor operations.

One precision="single" simulation of the guarded CNOT is held against the
JAX package at complex64: both run f32 arithmetic in their own order, so
the bound is 2e-5 (infidelity, energies, populations; measured below 2e-6).
"""

import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from quandary_tpu import Quandary as JQuandary  # noqa: E402
from quandary_tpu_torch import Quandary as TQuandary  # noqa: E402

FREQ01 = [4.80595, 4.8601]
CNOT = np.eye(4)
CNOT[2:, 2:] = [[0, 1], [1, 0]]
TOL_F32 = 2e-5


def _both(tmp_path, kw, method="simulate", **call):
    jq, tq = JQuandary(**kw), TQuandary(device="cpu", **kw)
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    rj = getattr(jq, method)(datadir=dj, **call)
    rt = getattr(tq, method)(datadir=dt, **call)
    return jq, tq, rj, rt, dj, dt


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _assert_tuples(rt, rj, rtol):
    t, pt, qt, infid, energy, pop = rt
    _close(t, rj[0], rtol)
    for a, b in zip(pt + qt, rj[1] + rj[2]):
        _close(a, b, rtol)
    assert abs(infid - rj[3]) <= rtol * max(abs(rj[3]), 1.0)
    for ea, eb in zip(energy + pop, rj[4] + rj[5]):
        assert len(ea) == len(eb)
        for a, b in zip(ea, eb):
            _close(a, b, rtol)


def _assert_files(dt, dj, rtol):
    names = sorted(n for n in os.listdir(dj) if n != "timing.dat")
    assert sorted(n for n in os.listdir(dt) if n != "timing.dat") == names
    for name in names:
        a, b = os.path.join(dt, name), os.path.join(dj, name)
        if name.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files)
            for k in zb.files:
                _close(za[k], zb[k], rtol)
            continue
        with open(a) as fa, open(b) as fb:
            if fa.read() == fb.read():
                continue
        _close(np.loadtxt(a), np.loadtxt(b), rtol)


def _assert_run(jq, tq, rj, rt, dj, dt, rtol=1e-10):
    _assert_tuples(rt, rj, rtol)
    _assert_files(dt, dj, rtol)
    _close(tq.uT, jq.uT, rtol)
    if len(jq.popt):
        _close(tq.popt, jq.popt, rtol)
    for k, v in jq.optim_hist.items():
        _close(tq.optim_hist[k], v, rtol)


def test_state_to_state(tmp_path):
    kw = dict(Ne=[2], Ng=[1], freq01=[4.10595], selfkerr=[0.2198],
              maxctrl_MHz=4.0, initialcondition=[1.0, 0.0],
              targetstate=[1.0 / np.sqrt(2), 1.0 / np.sqrt(2)], T=12.0,
              tol_infidelity=1e-5, rand_seed=4321, maxiter=3)
    out = _both(tmp_path, kw, "optimize")
    assert len(out[0].optim_hist["Iters"]) >= 3
    _assert_run(*out, rtol=1e-8)


def test_simulate_unitary(tmp_path):
    kw = dict(Ne=[2, 2], freq01=[4.8, 4.9], rotfreq=[4.8, 4.9],
              selfkerr=[0.0, 0.0], Jkl=[0.0], T=10.0,
              randomize_init_ctrl=False, initctrl_MHz=0.0,
              costfunction="Jfrobenius", optim_target="pure, 0, 0")
    out = _both(tmp_path, kw)
    _assert_run(*out)
    np.testing.assert_allclose(out[1].uT, np.eye(4), atol=1e-8)


def test_evalcontrols():
    kw = dict(Ne=[2], freq01=[4.1], selfkerr=[0.2], T=20.0,
              randomize_init_ctrl=False, initctrl_MHz=5.0)
    rj = JQuandary(**kw).evalControls(points_per_ns=2)
    rt = TQuandary(device="cpu", **kw).evalControls(points_per_ns=2)
    assert len(rt[0]) == 41
    _close(rt[0], rj[0], 1e-12)
    for a, b in zip(rt[1] + rt[2], rj[1] + rj[2]):
        _close(a, b, 1e-12)


def test_lindblad(tmp_path):
    kw = dict(Ne=[2], Ng=[0], freq01=[4.1], selfkerr=[0.2], T1=[50.0],
              T2=[30.0], T=20.0, randomize_init_ctrl=False, initctrl_MHz=2.0,
              initialcondition="pure, 1", optim_target="pure, 0",
              costfunction="Jfrobenius")
    out = _both(tmp_path, kw)
    _assert_run(*out)
    np.testing.assert_allclose(out[3][5][0][0].sum(axis=0), 1.0, atol=1e-8)


def test_lindblad_basis_observables(tmp_path):
    """The Lindblad 'basis' batch: observables are reported for the
    diagonal (physical) ids only; every file of every id is written."""
    kw = dict(Ne=[2], Ng=[0], freq01=[4.1], selfkerr=[0.2], T1=[50.0],
              T2=[30.0], T=4.0, randomize_init_ctrl=False, initctrl_MHz=2.0,
              initialcondition="basis", optim_target="pure, 0")
    out = _both(tmp_path, kw)
    _assert_run(*out)
    assert len(out[3][4][0]) == 2
    assert len(glob.glob(os.path.join(out[5], "rho_Re.iinit*.dat"))) == 4


def test_spline0(tmp_path):
    kw = dict(Ne=[2], Ng=[1], freq01=[4.10595], selfkerr=[0.2198],
              maxctrl_MHz=12.0, initctrl_MHz=4.0, spline_order=0,
              initialcondition=[1.0, 0.0], targetstate=[0.0, 1.0], T=12.0,
              rand_seed=2345, maxiter=3, gamma_variation=0.001)
    _assert_run(*_both(tmp_path, kw, "optimize"), rtol=1e-8)


def test_sampled_pulses(tmp_path):
    kw = dict(Ne=[2], freq01=[4.1], selfkerr=[0.2], T=20.0,
              randomize_init_ctrl=False, initctrl_MHz=0.0,
              initialcondition="pure, 0", optim_target="pure, 1",
              costfunction="Jfrobenius")
    nt = JQuandary(**kw).nsteps + 1
    tgrid = np.linspace(0, 20.0, nt)
    pt0, qt0 = [10.0 * np.sin(np.pi * tgrid / 20.0)], [np.zeros(nt)]
    out = _both(tmp_path, kw, pt0=pt0, qt0=qt0)
    _assert_run(*out)
    assert out[3][5][0][0][0][-1] < 0.99


def test_dump_reference_config_roundtrip(tmp_path):
    """Both packages dump the same files; the dumped directory runs through
    both CLIs to the same outputs, and to the direct simulation's
    objective."""
    from quandary_tpu.cli import run as jrun
    from quandary_tpu_torch.cli import run as trun
    kw = dict(Ne=[2, 2], freq01=[4.8, 4.9], rotfreq=[4.8, 4.9],
              selfkerr=[0.2, 0.21], Jkl=[0.004], T=8.0, targetgate=CNOT,
              randomize_init_ctrl=False, initctrl_MHz=3.0,
              carrier_frequency=[[0.0], [0.0]])
    jq, tq = JQuandary(**kw), TQuandary(device="cpu", **kw)
    cj = jq.dump_reference_config(runtype="simulation",
                                  datadir=str(tmp_path / "dj"))
    ct = tq.dump_reference_config(runtype="simulation",
                                  datadir=str(tmp_path / "dt"))
    names = sorted(os.listdir(tmp_path / "dj"))
    assert sorted(os.listdir(tmp_path / "dt")) == names
    for n in names:
        with open(tmp_path / "dj" / n, "rb") as a, \
                open(tmp_path / "dt" / n, "rb") as b:
            assert a.read() == b.read(), n
    rj = jrun(cj, quiet=True, datadir_override=str(tmp_path / "oj"))
    rt = trun(ct, quiet=True, datadir_override=str(tmp_path / "ot"),
              device="cpu")
    _assert_files(str(tmp_path / "ot"), str(tmp_path / "oj"), 1e-10)
    assert abs(rt["objective"] - rj["objective"]) <= 1e-10 * abs(
        rj["objective"])
    direct = tq.simulate(datadir=str(tmp_path / "direct"))
    assert abs(rt["fidelity"] - (1.0 - direct[3])) <= 1e-10


def test_get_results(tmp_path):
    kw = dict(Ne=[3], Ng=[0], freq01=[4.1], selfkerr=[0.2], T1=[20000.0],
              T2=[8000.0], T=5.0, nsteps=40, randomize_init_ctrl=False,
              initctrl_MHz=2.0, initialcondition="diagonal, 0",
              costfunction="Jtrace", optim_target="pure, 0")
    jq, tq, rj, rt, dj, dt = _both(tmp_path, kw)
    _assert_run(jq, tq, rj, rt, dj, dt)
    gj, gt = jq.get_results(datadir=dj), tq.get_results(datadir=dt)
    for k, (a, b) in enumerate(zip(gt, gj)):
        if isinstance(b, dict):
            for key in b:
                _close(a[key], b[key], 1e-10)
        elif k in (4, 5):
            for ea, eb in zip(a, b):
                for x, y in zip(ea, eb):
                    _close(x, y, 1e-10)
        else:
            _close(a, b, 1e-10)


def test_resolve_datadir(tmp_path, monkeypatch):
    from quandary_tpu.api import resolve_datadir as jres
    from quandary_tpu_torch.api import resolve_datadir as tres
    base = tmp_path / "base"
    base.mkdir()
    monkeypatch.setenv("QUANDARY_BASE_DATADIR", str(base))
    for d in ("run1", str(tmp_path / "abs"), "a/../b"):
        assert tres(d) == jres(d)
    monkeypatch.setenv("QUANDARY_BASE_DATADIR", str(tmp_path / "missing"))
    with pytest.raises(ValueError):
        tres("run1")


def test_multistart(tmp_path):
    """optimize(multistart=4): the batched L-BFGS over the 4 starts through
    Problem.packed_batch_fns, then the optimizer from the best one."""
    kw = dict(Ne=[2], freq01=[4.10595], selfkerr=[0.2198], maxctrl_MHz=8.0,
              initialcondition="pure, 0", optim_target="pure, 1",
              costfunction="Jfrobenius", T=10.0, rand_seed=11, maxiter=3)
    _assert_run(*_both(tmp_path, kw, "optimize", multistart=4), rtol=1e-8)


def test_single_precision_guard_cnot(tmp_path):
    """precision='single': complex64 in both packages (the port's plain
    loop on the CPU, the JAX scan), the guarded CNOT of test_api.py at a
    short horizon."""
    favg = sum(FREQ01) / 2
    kw = dict(Ne=[2, 2], Ng=[1, 1], freq01=FREQ01, rotfreq=[favg, favg],
              selfkerr=[0.2198, 0.2252], Jkl=[0.005], T=10.0,
              targetgate=CNOT, rand_seed=1234, gamma_leakage=0.1,
              precision="single")
    jq, tq, rj, rt, dj, dt = _both(tmp_path, kw)
    _assert_tuples(rt, rj, TOL_F32)
    assert abs(rt[3] - rj[3]) <= TOL_F32
