"""quandary_tpu_torch: the PyTorch and CUDA port of quandary_tpu.

Simulation and pulse optimization of closed quantum systems: the dense
operator-stack model, the IMR stepper (Neumann, Jacobi and diagonally-split
stage solves), the multi-initial-condition objective with its penalties,
and bound-constrained L-BFGS. On an NVIDIA Hopper GPU the time loop and its
exact adjoint run in one hand-written CUDA kernel per direction
(ops/streamk.py, csrc/streamk.cu); on the CPU the same math runs in plain
torch.

    from quandary_tpu_torch.problem import Problem, Setup
    problem = Problem(setup, device="cuda")
    (J, aux), grad = problem.build_value_and_grad()(params, params)
"""

__version__ = "0.1.0"
