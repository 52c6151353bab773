"""quandary_tpu_torch: the PyTorch and CUDA port of quandary_tpu.

Simulation and pulse optimization of closed and open (Lindblad) quantum
systems: the dense operator-stack model, the IMR stepper (Neumann, Jacobi
and diagonally-split stage solves), the multi-initial-condition objective
with its penalties, ensembles of control candidates and of system
realizations (robust control), bound-constrained L-BFGS on the host, on the
device in chunks, and for whole populations, and the gradient with respect
to the Hamiltonian itself (calibration.py). On an NVIDIA Hopper GPU the
time loop and its exact adjoint run in one hand-written CUDA kernel per
direction (ops/streamk.py, ops/stream.py and ops/rho.py on csrc/*.cu); on
the CPU the same math runs in plain torch.

    from quandary_tpu_torch.problem import Problem, Setup
    problem = Problem(setup)            # the CUDA device; device="cpu" asks
    (J, aux), grad = problem.build_value_and_grad()(params, params)
    from quandary_tpu_torch.optim.device_driver import run_optimization_device
    result = run_optimization_device(problem, params, lb, ub)
"""

__version__ = "0.1.0"
