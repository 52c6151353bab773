"""The chunked cross-check propagation: port of
quandary_tpu/ops/pallas_adjoint.py::make_pallas_propagate (B5).

The TPU kernels run Tc plain-Neumann IMR steps per launch with the chunk's
planes resident in VMEM, under lax.scan; the backward replays the stage
iterates from the stored pre-step states and emits per-step plane
cotangents. Tc chunking is TPU VMEM scheduling: here the whole time loop
runs in one launch per direction of csrc/stream.cu's kernel pair (past one
thread block, csrc/stream_mid.cu's), through its own entry points
(chunk_fwd_launch / chunk_bwd_launch, chunk_mid_fwd_launch /
chunk_mid_bwd_launch, which hold it to plain Neumann with replayed
iterates) and launch counters (stream.chunk_fwd_launches /
chunk_bwd_launches, stream_mid.chunk_mid_fwd_launches /
chunk_mid_bwd_launches). Exact f32, as the TPU kernels' HIGHEST
precision. The reference's 'chunk' mode takes dim <= 1024.

The contract is that of ops/stream.py::make_stream_propagate:

    propagate(Sr, Si, (x0r, x0i), C) -> ((xTr, xTi), (hr, hi))

differentiable in Sr, Si, x0 and C, with Sr, Si the unpadded (K, N, N)
planes of ``plane_args(stack)``.
"""

from __future__ import annotations

import numpy as np

from . import stream


def make_pallas_propagate(dt: float, iters: int = 10):
    """Build propagate(Sr, Si, (x0r, x0i), C) -> ((xTr, xTi), (hr, hi)) on
    the chunk kernels: plain Neumann with `iters` stage iterations. C is
    (ntime, K) or (E, ntime, K)."""
    return stream.propagate_fn(dt, iters, None, "neumann", "chunk")


def plane_args(stack):
    """f32 real and imaginary planes (K, N, N) of a complex operator stack
    (unpadded: the kernels need no lane padding)."""
    stack = np.asarray(stack)
    return (np.ascontiguousarray(stack.real, dtype=np.float32),
            np.ascontiguousarray(stack.imag, dtype=np.float32))
