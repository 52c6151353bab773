"""Forward-only dense propagation: port of
quandary_tpu/ops/pallas_kernels.py::pallas_propagate_dense (B6).

The TPU version assembles every step's H planes with one contraction and
drives a one-step Pallas kernel under lax.scan (one launch per step). Here
the planes come from ops/stream.py::planes and the whole plain-Neumann time
loop runs in ONE launch of csrc/stream.cu's forward kernel without its
history writes (entry point dense_fwd_launch, counter
stream.dense_fwd_launches; past one thread block csrc/stream_mid.cu's,
dense_mid_fwd_launch, stream_mid.dense_mid_fwd_launches): only xT leaves
the kernel. Exact f32, as the TPU
kernel's HIGHEST precision. CUDA tensors run the kernel, CPU tensors the
plain torch forward; there is no fallback from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from . import stream


def dense_propagate(plan, Hr, Hi, x0r, x0i):
    """xT pair (E, B, N) of the planes (E, nt, N, N) from x0 (B, N): the
    kernel for CUDA tensors, the plain forward for CPU tensors."""
    if Hr.device.type == "cuda":
        return stream._kernel_fwd(plan, Hr.contiguous(), Hi.contiguous(),
                                  x0r.contiguous(), x0i.contiguous())[:2]
    if Hr.device.type == "cpu":
        hr, hi = stream.plain_forward(plan, Hr, Hi, x0r, x0i)
        return hr[:, -1], hi[:, -1]
    raise NotImplementedError(f"dense has no path for {Hr.device}")


def pallas_propagate_dense(stack, C, x0, dt: float, iters: int = 10,
                           device=None):
    """Propagate x0 (B, N) complex through all IMR steps (plain Neumann with
    `iters` stage iterations); returns xT (B, N) in x0's complex dtype.

    stack: (K, N, N) complex operator stack; C: (ntime, K) real coefficient
    rows at the step midpoints. Runs on `device`: by default x0's device
    when x0 is a tensor, else the CUDA device. complex64 runs f32 planes
    (the kernel's type), complex128 f64 (CPU only). Forward only."""
    if device is None:
        device = x0.device if torch.is_tensor(x0) else "cuda"
    x0 = torch.as_tensor(x0, device=device)
    if not x0.is_complex():
        x0 = x0.to(torch.complex128 if x0.dtype == torch.float64
                   else torch.complex64)
    rdt = torch.float64 if x0.dtype == torch.complex128 else torch.float32
    S = torch.as_tensor(np.asarray(stack) if not torch.is_tensor(stack)
                        else stack, device=device)
    if not S.is_complex():
        S = S.to(torch.complex128)
    Sr, Si = S.real.to(rdt).contiguous(), S.imag.to(rdt).contiguous()
    Ce = torch.as_tensor(C, device=device).to(rdt)[None]
    plan = stream.make_plan(Sr, dt, iters, kind="dense")
    with torch.no_grad():
        Hr, Hi = stream.planes(plan, Sr, Si, Ce)
        xTr, xTi = dense_propagate(plan, Hr, Hi, x0.real.to(rdt).contiguous(),
                                   x0.imag.to(rdt).contiguous())
    return torch.complex(xTr[0], xTi[0]).to(x0.dtype)
