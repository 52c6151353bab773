"""Evaluation of rotating-frame controls p_k(t), q_k(t) in torch.

Takes the global parameter vector alpha (or a (..., nparams) batch of
control candidates) and a host-built
:class:`~quandary_tpu_torch.utils.splines.ControlEvalPlan`, and returns
tensors (p, q) of shape (..., nt, Q) for all oscillators at all plan time
points: a handful of small matmuls, differentiable in the parameters by
autograd, evaluated ONCE per objective evaluation (versus one scalar spline
sum per step per oscillator in the reference, oscillator.cpp:281-337).

Pi-pulses (oscillator.cpp:327-334) override (p, q) with amp/sqrt(2) inside
their time windows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.splines import ControlEvalPlan, ControlSegment


def _const(a, like):
    """Host array (or a tensor of plan_on_device) -> tensor with the dtype
    and device of `like`."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype=like.dtype, device=like.device)
    return torch.as_tensor(np.asarray(a), dtype=like.dtype, device=like.device)


def plan_on_device(plan: ControlEvalPlan, dtype, device) -> ControlEvalPlan:
    """The plan with its time grid, basis matrices and carrier tables as
    tensors on `device`: eval_controls then copies nothing from the host,
    which a loop on the device (and its capture as a CUDA graph) needs."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return dataclasses.replace(
        plan, ts=t(plan.ts),
        basis=tuple(tuple(t(B) for B in segs) for segs in plan.basis),
        cos_t=tuple(t(c) for c in plan.cos_t),
        sin_t=tuple(t(c) for c in plan.sin_t))


def _eval_segment_pq(seg: ControlSegment, B, cos_t, sin_t, seg_params, nf, ts):
    """(p, q) contribution of one segment, shape (..., nt).

    seg_params: (..., n) slice of the oscillator's parameters for this
    segment, layout [carrier f: nparams_per_carrier]."""
    npc = seg.nparams_per_carrier()
    P = seg_params.reshape(seg_params.shape[:-1] + (nf, npc))
    if seg.kind in ("spline", "spline0"):
        ns = seg.nsplines
        B1 = B @ P[..., :ns].transpose(-1, -2)       # (..., nt, nf)
        B2 = B @ P[..., ns:].transpose(-1, -2)
        p = torch.sum(cos_t * B1 - sin_t * B2, dim=-1)
        q = torch.sum(sin_t * B1 + cos_t * B2, dim=-1)
    elif seg.kind == "spline_amplitude":
        ns = seg.nsplines
        amp = B @ P[..., :ns].transpose(-1, -2)      # (..., nt, nf)
        phase = seg.scaling * P[..., ns]             # (..., nf)
        # p = cos(Om t + phase) * amp ; q = sin(Om t + phase) * amp
        cph = torch.cos(phase)[..., None, :]
        sph = torch.sin(phase)[..., None, :]
        cos_full = cos_t * cph - sin_t * sph
        sin_full = sin_t * cph + cos_t * sph
        p = torch.sum(cos_full * amp, dim=-1)
        q = torch.sum(sin_full * amp, dim=-1)
    elif seg.kind == "step":
        # Parameter alpha in [0,1] sets the step end time; the window mask was
        # folded into B (column 0). Ramp: up over tramp after tstart, down
        # over tramp before tstepend (controlbasis.cpp:195-206, util.cpp:92).
        a = P[..., 0, 0][..., None]                  # reference: carrier 0 slot
        tstepend = seg.tstart + a * (seg.tstop - seg.tstart)
        if seg.tramp > 1e-13:
            up = (ts - seg.tstart) / seg.tramp
            down = (tstepend - ts) / seg.tramp
            ramp = torch.clamp(torch.minimum(up, down), 0.0, 1.0)
            ramp = torch.where(tstepend < seg.tstart + 2 * seg.tramp,
                               torch.zeros_like(ramp), ramp)
        else:
            inwin = (ts >= seg.tstart) & (ts <= tstepend)
            ramp = inwin.to(seg_params.dtype)
        ramp = ramp * B[:, 0]
        p = ramp * seg.step_amp1
        q = ramp * seg.step_amp2
    else:
        raise ValueError(seg.kind)
    return p, q


def eval_controls(plan: ControlEvalPlan, params,
                  pipulses: Optional[Sequence] = None):
    """Evaluate (p, q) for all oscillators on the plan's time grid.

    Parameters
    ----------
    plan : ControlEvalPlan (static, host-built)
    params : (..., nparams) parameter tensor (rad/ns units); leading axes
        are independent control candidates.
    pipulses : optional list (per oscillator) of lists of (tstart, tstop, amp)
        tuples; inside those windows p=q=amp/sqrt(2) (oscillator.cpp:327-334).

    Returns
    -------
    p, q : (..., nt, Q) tensors.
    """
    ts = _const(plan.ts, params)
    lead = params.shape[:-1]
    p_cols = []
    q_cols = []
    for k, osc in enumerate(plan.oscillators):
        nf = len(osc.carrier_freqs)
        p_k = params.new_zeros(lead + ts.shape)
        q_k = params.new_zeros(lead + ts.shape)
        seg_off = int(plan.param_offsets[k])
        cos_t = _const(plan.cos_t[k], params)
        sin_t = _const(plan.sin_t[k], params)
        for s, seg in enumerate(osc.segments):
            nseg_params = seg.nparams_per_carrier() * nf
            seg_params = params[..., seg_off:seg_off + nseg_params]
            B = _const(plan.basis[k][s], params)
            ps, qs = _eval_segment_pq(seg, B, cos_t, sin_t, seg_params, nf, ts)
            p_k = p_k + ps
            q_k = q_k + qs
            seg_off += nseg_params
        if pipulses is not None and k < len(pipulses):
            for (t0, t1, amp) in pipulses[k]:
                inwin = (ts >= t0) & (ts <= t1)
                amp_pq = torch.full_like(p_k, amp / np.sqrt(2.0))
                p_k = torch.where(inwin, amp_pq, p_k)
                q_k = torch.where(inwin, amp_pq, q_k)
        p_cols.append(p_k)
        q_cols.append(q_k)
    return torch.stack(p_cols, dim=-1), torch.stack(q_cols, dim=-1)


def eval_controls_labframe(plan: ControlEvalPlan, params, ground_freqs_radns,
                           pipulses: Optional[Sequence] = None):
    """Lab-frame pulse f_k(t) = 2(p cos(w_k t) - q sin(w_k t)) where w_k is
    the oscillator ground frequency (oscillator.cpp:383-428): the rotating-
    frame p, q with their carrier waves, modulated by the ground
    frequency."""
    p, q = eval_controls(plan, params, pipulses)
    wt = _const(plan.ts, params)[:, None] \
        * _const(np.asarray(ground_freqs_radns, dtype=float), params)[None, :]
    return 2.0 * (p * torch.cos(wt) - q * torch.sin(wt))


def control_variation_penalty(plan: ControlEvalPlan, params):
    """Total-variation penalty over consecutive spline0 coefficients
    (controlbasis.cpp:257-277): sum over oscillators, carriers, Re/Im blocks
    of sum_s (a_s - a_{s-1})^2, plus first/last coefficient squared when
    boundary conditions are enforced. Only spline0 segments contribute (the
    reference implements computeVariation only for BSpline0). Returns a
    (...,) tensor for (..., nparams) params."""
    total = params.new_zeros(params.shape[:-1])
    for k, osc in enumerate(plan.oscillators):
        nf = len(osc.carrier_freqs)
        seg_off = int(plan.param_offsets[k])
        for seg in osc.segments:
            nseg_params = seg.nparams_per_carrier() * nf
            if seg.kind == "spline0":
                ns = seg.nsplines
                P = params[..., seg_off:seg_off + nseg_params]
                P = P.reshape(params.shape[:-1] + (nf, 2, ns))
                d = P[..., 1:] - P[..., :-1]
                total = total + torch.sum(d * d, dim=(-3, -2, -1))
                if osc.enforce_bc:
                    total = total + torch.sum(P[..., 0] ** 2, dim=(-2, -1)) \
                        + torch.sum(P[..., -1] ** 2, dim=(-2, -1))
            seg_off += nseg_params
    return total
