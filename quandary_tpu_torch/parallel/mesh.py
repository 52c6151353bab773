"""The ('init', 'hilbert') mesh of ranks on torch.distributed: the
counterpart of quandary_tpu/parallel/mesh.py (the reference's 3-way MPI
communicator split, main.cpp:133-177).

Axes:
* ``init`` — data parallelism over the initial conditions (comm_init).
  `shard_problem` gives each rank a contiguous B / n_init share of the batch
  of initial conditions; every rank runs the whole per-rank program (the
  CUDA kernels included) on its share. The only collectives sit at the two
  ends of the route: the objective's sums over the batch are all-reduced
  before the nonlinear tail (`reduce_from`), and the gradient of the
  coefficient rows, the replicated input every rank's share depends on, is
  all-reduced in the backward (`copy_to`, applied by
  `Problem.coeff_rows_mid`). The pair has a first backward only (ROADMAP
  C4 item 16). The terms that do not depend on
  the states (Tikhonov, energy, variation) are computed once on every rank
  and never summed.
* ``hilbert`` — the state dimension over ranks (comm_petsc). Not ported
  yet: it needs collectives inside every step (ROADMAP A8's last slice);
  `shard_problem(..., shard_hilbert=True)` raises, and ranks along
  'hilbert' compute replicas.

The candidate axis, the one the throughput figures ride, shards through
``Problem.build_ensemble_value_and_grad(mesh=...)``, ``packed_batch_fns``
and ``build_ensemble_sweeps``: each rank runs the unchanged per-rank program
on its E / n rows of the candidates, and `gather_rows` hands every rank the
whole (E, ...) results by one all-reduce of zero-filled buffers (exact:
x + 0 = x, the same bits on every rank, one collective kind for NCCL and
gloo, on CPU and CUDA tensors).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("init", "hilbert")


def make_mesh(n_init: int, n_hilbert: int = 1,
              device: Optional[str] = None) -> DeviceMesh:
    """A DeviceMesh with axes ('init', 'hilbert') over the first
    n_init * n_hilbert ranks of the default process group, rank
    i * n_hilbert + h at (i, h). On the CUDA device unless `device` names
    another ('cpu'). Every rank of the default group calls it (it creates
    the axes' subgroups); a rank past the mesh gets a mesh it is not in."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.multihost.initialize() first")
    device = device or "cuda"
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh builds a CUDA mesh by default and "
                           "torch.cuda.is_available() is false; pass "
                           "device='cpu'")
    need, have = n_init * n_hilbert, dist.get_world_size()
    if have < need:
        raise ValueError(f"need {need} ranks, have {have}")
    return DeviceMesh(torch.device(device).type,
                      torch.arange(need).reshape(n_init, n_hilbert),
                      mesh_dim_names=AXES)


class MeshAxis:
    """This rank's place along one axis of a mesh: its index, the axis'
    size and its process group (one group per slice across the other
    axis). Raises where this rank is not in the mesh or the mesh holds
    tensors of another device type than `device`."""

    def __init__(self, mesh: DeviceMesh, axis: str, device: torch.device):
        names = tuple(mesh.mesh_dim_names or ())
        if axis not in names:
            raise ValueError(f"mesh axis {axis!r} not in {names}")
        if mesh.get_coordinate() is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                             f"{mesh.mesh.tolist()}")
        if mesh.device_type != device.type:
            raise ValueError(f"the mesh is on {mesh.device_type!r} and the "
                             f"problem on {device.type!r}")
        self.name = axis
        self.size = int(mesh.shape[names.index(axis)])
        self.index = int(mesh.get_local_rank(axis))
        self.group = mesh.get_group(axis)

    def rows(self, n: int, what: str) -> slice:
        """This rank's contiguous share of `n` rows."""
        if n % self.size:
            raise ValueError(f"{what} {n} not divisible by mesh axis "
                             f"'{self.name}' of size {self.size}")
        b = n // self.size
        return slice(self.index * b, (self.index + 1) * b)


def shard_problem(problem, mesh: DeviceMesh, shard_hilbert: bool = False):
    """Shard a Problem's batch of initial conditions over the mesh's
    'init' axis (the reference's comm_init, quandary_tpu/parallel/
    mesh.py:62-100) and return it. The rank keeps its contiguous B / n_init
    share of x0, the target, the weights (normalized over the whole batch
    before) and the purities, and rebuilds its route at that B
    (`Problem.fused_form` records the route the rank takes); the objective
    all-reduces its sums over the batch and divides the fidelity by the
    whole B. Raises ValueError where n_init does not divide B."""
    if shard_hilbert:
        raise NotImplementedError(
            "shard_hilbert=True: the 'hilbert' axis (the state dimension "
            "over ranks, with collectives inside every step) is not ported "
            "yet (ROADMAP A8's 'hilbert' slice); shard_hilbert=False "
            "computes replicas along 'hilbert'")
    if problem.mesh is not None:
        raise ValueError("the problem is sharded already")
    axis = MeshAxis(mesh, "init", problem.device)
    rows = axis.rows(problem.ninit, "the batch of initial conditions")
    problem._shard_init(rows, mesh, axis.group)
    return problem


def _first_order_only():
    """Raise where a backward builds a graph (create_graph, as a Hessian
    asks): in the gradient's graph the cotangent of a replicated value (the
    objective's reduced sums) would come back as each rank's share, so a
    second derivative through the pair would drop the cross-rank terms.
    (torch's once_differentiable would not raise there: autograd.grad with
    `inputs` prunes its error node, and the second derivative is zero.)"""
    if torch.is_grad_enabled():
        raise RuntimeError(
            "a double backward through the 'init' axis' collectives "
            "(parallel/mesh.py copy_to / reduce_from) is not supported "
            "(ROADMAP C4 item 16); fd_hessian differentiates the gradient "
            "by differences")


class _CopyTo(torch.autograd.Function):
    """Identity forward; all-reduces the cotangent backward (first order
    only)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _first_order_only()
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    """All-reduces forward; identity backward (first order only)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        _first_order_only()
        return g, None


def copy_to(x, group):
    """`x`, a replicated input that every rank's share of a sum depends
    on: its gradient sums over the group's ranks. (The conjugate of
    `reduce_from`; torch.distributed.nn.functional.all_reduce would
    all-reduce the cotangent a second time.)"""
    return _CopyTo.apply(x, group)


def reduce_from(x, group):
    """The sum of `x` over the group's ranks, each rank holding its share;
    the cotangent passes back unchanged to every rank's share."""
    return _ReduceFrom.apply(x, group)


def gather_rows(parts: Sequence[torch.Tensor], rows: slice, n: int,
                group) -> list:
    """Every rank's `rows` of each tensor of `parts` (leading axis: this
    rank's rows) put together into tensors of n rows on every rank, by one
    all-reduce of a zero-filled buffer. The parts share one dtype and
    device."""
    flat = [p.detach().reshape(p.shape[0], -1) for p in parts]
    width = [f.shape[1] for f in flat]
    buf = flat[0].new_zeros((n, sum(width)))
    buf[rows] = torch.cat(flat, dim=1)
    dist.all_reduce(buf, group=group)
    return [b.reshape((n,) + p.shape[1:])
            for b, p in zip(buf.split(width, dim=1), parts)]
