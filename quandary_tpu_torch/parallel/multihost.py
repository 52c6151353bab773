"""Multi-process execution on torch.distributed.

One process per rank (one per card on a GPU host, as `torchrun` starts
them); after `initialize()` every rank holds the default process group,
and parallel/mesh.py lays the ('init', 'hilbert') mesh over its ranks.

The host-side optimizer loops (optim/driver.py, optim/batched_lbfgs.py)
run REPLICATED on every rank over the small design vector, as the
reference replicates its TAO state (main.cpp:372-377): every collective of
the port (parallel/mesh.py) hands every rank the same bits, so the ranks
take the same decisions and no broadcast is needed.

Checklist for an n-rank run:

    from quandary_tpu_torch.parallel import mesh, multihost
    device = multihost.initialize()        # once per process, torchrun's env
    m = mesh.make_mesh(n_init, 1)          # every rank calls it
    problem = Problem(setup, device=device)
    mesh.shard_problem(problem, m)         # the 'init' axis
    # or, on an unsharded problem, the candidate axis:
    #   problem.build_ensemble_value_and_grad(mesh=m)

    torchrun --nproc-per-node 2 my_script.py        # NCCL on the cards
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> torch.device:
    """Create the default process group and return this rank's device.

    With `coordinator_address` ('host:port'), `num_processes` and
    `process_id` the group meets at tcp://coordinator_address; without
    them it reads MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE as
    `torchrun` sets them. The backend is NCCL where a CUDA device exists
    and gloo otherwise, unless `backend` names one (gloo lets several ranks
    share one card). On the card a rank's device is
    cuda:{LOCAL_RANK % device_count} (LOCAL_RANK defaults to the rank);
    elsewhere the CPU. Unlike the reference (quandary_tpu/parallel/
    multihost.py:30-41), num_processes=1 still creates a one-rank group, so
    that the port's collectives run on one process too (ROADMAP C4 item
    14)."""
    if dist.is_initialized():
        raise RuntimeError("initialize(): a default process group exists "
                           "already in this process")
    given = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in given):
        if any(v is None for v in given):
            raise ValueError("initialize(): give coordinator_address, "
                             "num_processes and process_id together, or "
                             "none of them (torchrun's environment)")
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    else:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                               "WORLD_SIZE") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"initialize(): {', '.join(missing)} not set; run under "
                "torchrun or pass coordinator_address, num_processes and "
                "process_id")
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    device = torch.device("cpu")
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    return device


def is_multihost() -> bool:
    """Whether a process group of more than one rank exists."""
    return dist.is_initialized() and dist.get_world_size() > 1


def sync_global_value(x):
    """Rank 0's value of `x` on every rank (the reference's
    broadcast_one_to_all, quandary_tpu/parallel/multihost.py:50-60), for a
    decision every rank must take alike (a stopping test). A tensor comes
    back as a tensor on its device, anything else as a numpy value (a
    Python number for a scalar). Without a process group, `x` itself."""
    if not dist.is_initialized():
        return x
    t = torch.as_tensor(x)
    out = t.detach().clone().contiguous()
    if dist.get_backend() == "nccl" and out.device.type != "cuda":
        out = out.to(torch.device("cuda", torch.cuda.current_device()))
    dist.broadcast(out, src=0)
    if isinstance(x, torch.Tensor):
        return out.to(t.device)
    out = out.cpu().numpy()
    return out.item() if out.ndim == 0 and np.isscalar(x) else out
