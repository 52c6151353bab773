"""quandary_tpu_torch.optim against quandary_tpu.optim on the small f64 CNOT
flagship, and the port's independence from JAX."""

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
    rt = run_optimization(TProblem(st), x0, lb, ub, maxiter=3,
                          verbose=False)
    fj = [h.objective for h in rj.history]
    ft = [h.objective for h in rt.history]
    assert len(ft) == len(fj) == 4
    np.testing.assert_allclose(ft, fj, rtol=1e-8)
    assert ft[-1] < ft[0]
    np.testing.assert_allclose([h.fidelity for h in rt.history],
                               [h.fidelity for h in rj.history], rtol=1e-8)
    np.testing.assert_allclose(rt.params, rj.params, rtol=1e-6, atol=1e-12)


def test_package_imports_without_jax():
    """Every module of the port imports with jax blocked."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import pkgutil, importlib, quandary_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "quandary_tpu_torch.__path__, 'quandary_tpu_torch.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "assert 'quandary_tpu' not in sys.modules\n"
        "print(len(names))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
