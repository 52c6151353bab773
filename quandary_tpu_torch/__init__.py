"""quandary_tpu_torch: the PyTorch and CUDA port of quandary_tpu.

Simulation and pulse optimization of closed and open (Lindblad) quantum
systems: the dense operator-stack model, the IMR, IMR4, IMR8 and explicit
Euler steppers (Neumann, Jacobi, GMRES and diagonally-split stage solves),
the multi-initial-condition objective
with its penalties, ensembles of control candidates and of system
realizations (robust control), bound-constrained L-BFGS on the host, on the
device in chunks, and for whole populations, and the gradient with respect
to the Hamiltonian itself (calibration.py). On an NVIDIA Hopper GPU the
time loop and its exact adjoint run in one hand-written CUDA kernel per
direction (ops/streamk.py, ops/stream.py and ops/rho.py on csrc/*.cu); on
the CPU the same math runs in plain torch.

The front end, as quandary_tpu's (the reference's Python interface and its
config files):

    from quandary_tpu_torch import Quandary
    q = Quandary(Ne=[2, 2], freq01=[4.80595, 4.8601], Jkl=[0.005], T=200.0,
                 targetgate=cnot, rand_seed=1234, precision="single")
    t, pt, qt, infidelity, energy, population = q.optimize(datadir="run")

    python -m quandary_tpu_torch config.cfg   # --device cpu off the card

Both run on the CUDA device unless told otherwise (`device="cpu"`,
`--device cpu`). `precision="single"` builds a complex64 problem, which
takes the CUDA kernels; the default "double", and every config file, a
complex128 one, which takes the plain time loop.

The layers below it:

    from quandary_tpu_torch.problem import Problem, Setup
    problem = Problem(setup)            # the CUDA device; device="cpu" asks
    (J, aux), grad = problem.build_value_and_grad()(params, params)
    from quandary_tpu_torch.optim.device_driver import run_optimization_device
    result = run_optimization_device(problem, params, lb, ub)
"""

__version__ = "0.1.0"

from .api import Quandary  # noqa: E402

__all__ = ["Quandary"]
