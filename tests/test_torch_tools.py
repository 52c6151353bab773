"""quandary_tpu_torch's tools on the CPU: profiling.py (timer's line and its
timing.dat format against quandary_tpu.profiling.timer; trace around a
gradient writes a Chrome trace with operator events; sweep_timer's rate),
utils/cache.py (the build directory, QTPU_BUILD_DIR, the off switch
QTPU_NO_BUILD_CACHE), and plots.py: the plot helpers headless under Agg
on a port simulation, as tests/test_plots.py runs the JAX package's, and
timestep_richardson_est on the port's Quandary against the JAX package's
on the same fields (3 refinements, f64): the step sizes equal, the error
estimates within 1e-9 relative (each a difference of two infidelities or
final states; measured: the infidelity's equal, the final states' 3e-12
apart)."""

import json
import os
import re
import subprocess
import sys

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from quandary_tpu import Quandary as JQuandary  # noqa: E402
from quandary_tpu_torch import Quandary as TQuandary  # noqa: E402
from quandary_tpu_torch import profiling  # noqa: E402
from quandary_tpu_torch.utils import cache  # noqa: E402

QUBIT = dict(Ne=[2], freq01=[4.10595], rotfreq=[4.10595], selfkerr=[0.2198],
             T=30.0, initialcondition="pure, 0", targetstate=[0.0, 1.0],
             initctrl_MHz=[2.0], rand_seed=7, verbose=False)


def _numbers_out(text):
    return re.sub(r"\d+\.\d+(e[+-]\d+)?", "#", text)


def test_timer_line_and_timing_file_match_jax(tmp_path, capsys):
    from quandary_tpu.profiling import timer as jtimer

    lines = {}
    for name, timer in (("jax", jtimer), ("torch", profiling.timer)):
        path = tmp_path / f"{name}.dat"
        with timer("sweep", timing_file=str(path)):
            sum(range(1000))
        with timer():
            pass
        lines[name] = (capsys.readouterr().out, path.read_text())
    assert _numbers_out(lines["torch"][0]) == _numbers_out(lines["jax"][0])
    assert _numbers_out(lines["torch"][1]) == _numbers_out(lines["jax"][1])
    out, dat = lines["torch"]
    assert re.fullmatch(r"sweep: \d+\.\d{3} s, peak RSS \d+\.\d MB\n"
                        r"\d+\.\d{3} s, peak RSS \d+\.\d MB\n", out)
    assert re.fullmatch(r"1  \d\.\d{8}e[+-]\d\d\n", dat)


@pytest.fixture(scope="module")
def problem_vg():
    from test_torch_model import flagship_setup
    from quandary_tpu_torch.problem import Problem

    s = flagship_setup("torch", ntime=12)
    p = Problem(s, device="cpu")
    x = np.random.default_rng(0).normal(size=s.nparams) * 0.02
    return p.build_value_and_grad(), x


def test_trace_of_a_cpu_gradient(tmp_path, problem_vg):
    vg, x = problem_vg
    with profiling.trace(str(tmp_path / "tr")) as logdir:
        with torch.profiler.record_function("sweep"):
            (J, _), g = vg(x, x)
    assert logdir == str(tmp_path / "tr") and torch.isfinite(J)
    with open(os.path.join(logdir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert "aten::mul" in ops and any("Backward" in n for n in ops), ops
    summ = profiling.trace_summary(logdir, window="sweep")
    assert summ["kernels"] == {} and summ["busy_ms"] == 0.0
    assert summ["idle_share"] == 1.0 and summ["window_ms"] > 0.0
    assert profiling.trace_summary(logdir)["window_ms"] >= summ["window_ms"]


def test_sweep_timer_rate(problem_vg):
    vg, x = problem_vg
    rate = profiling.sweep_timer(vg, lambda i: (x, x), reps=3)
    assert np.isfinite(rate) and rate > 0.0


def test_build_directory_and_its_off_switch(tmp_path, monkeypatch):
    """build_dir() reads the environment; ops/cuda_build.py resolves it
    once per process (BUILD_DIR), and io/native.py builds there: under the
    off switch a fresh directory under TMPDIR, removed when the process
    exits."""
    from quandary_tpu_torch.io import native
    from quandary_tpu_torch.ops import cuda_build

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.delenv("QTPU_BUILD_DIR", raising=False)
    monkeypatch.delenv("QTPU_NO_BUILD_CACHE", raising=False)
    default = os.path.join(repo, "build", "quandary_tpu_torch")
    assert cache.build_dir() == default
    assert cuda_build.BUILD_DIR == native.BUILD_DIR == default
    monkeypatch.setenv("QTPU_BUILD_DIR", str(tmp_path / "libs"))
    assert cache.build_dir() == str(tmp_path / "libs")

    # the off switch: a fresh directory of the process, where the native
    # library builds from the package's source
    env = dict(os.environ, QTPU_NO_BUILD_CACHE="1", TMPDIR=str(tmp_path))
    env.pop("QTPU_BUILD_DIR")
    out = subprocess.run(
        [sys.executable, "-c",
         "import os\n"
         "from quandary_tpu_torch.io import native\n"
         "from quandary_tpu_torch.ops import cuda_build\n"
         "from quandary_tpu_torch.utils import cache\n"
         "d = cuda_build.BUILD_DIR\n"
         "assert cache.build_dir() == d and os.listdir(d) == []\n"
         "print(d)\n"
         "print(native._build())\n"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    d, so = out.stdout.split()
    assert os.path.dirname(d) == str(tmp_path)
    assert os.path.dirname(so) == d and os.path.basename(so).startswith(
        "libquandary_native_")
    assert not os.path.exists(d)


@pytest.fixture(scope="module")
def qres(tmp_path_factory):
    q = TQuandary(device="cpu", nsteps=60, **QUBIT)
    out = q.simulate(datadir=str(tmp_path_factory.mktemp("plots")))
    return q, out


def test_plot_helpers_run_headless(qres):
    from quandary_tpu_torch import plots

    q, (t, pt, qt, inf, energy, pop) = qres
    import matplotlib.pyplot as plt
    for fig in (plots.plot_pulse(q.Ne, t, pt, qt),
                plots.plot_expectedEnergy(q.Ne, t, energy),
                plots.plot_population(q.Ne, t, pop),
                plots.plot_results_1osc(q, pt[0], qt[0], energy[0], pop[0])):
        assert isinstance(fig, matplotlib.figure.Figure) and fig.axes
        plt.close(fig)


def test_richardson_estimator_matches_jax(tmp_path, capsys):
    from quandary_tpu.plots import timestep_richardson_est as jrich
    from quandary_tpu_torch.plots import timestep_richardson_est

    kw = dict(QUBIT, nsteps=30)
    got = timestep_richardson_est(TQuandary(device="cpu", **kw), tol=1e-10,
                                  datadir=str(tmp_path / "t"),
                                  max_refinements=3)
    want = jrich(JQuandary(**kw), tol=1e-10, datadir=str(tmp_path / "j"),
                 max_refinements=3)
    errs_J, errs_u, dts = got
    assert len(dts) == 3 and dts == want[2]
    np.testing.assert_allclose(errs_J, want[0], rtol=1e-9, atol=0)
    np.testing.assert_allclose(errs_u, want[1], rtol=1e-9, atol=0)
    # IMR is second order: each refinement shrinks the estimate ~4x
    assert all(errs_u[i] > 2.0 * errs_u[i + 1] for i in range(2)), errs_u
    assert "-> Error at i=2" in capsys.readouterr().out
