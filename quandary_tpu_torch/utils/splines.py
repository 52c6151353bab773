"""Control-pulse parameterizations: B-spline envelopes x carrier waves.

The rotating-frame control for oscillator k is
    d^k(t) = p^k(t) + i q^k(t)
            = sum_f e^{i Omega_f t} sum_s (alpha^{(1)}_{s,f} + i alpha^{(2)}_{s,f}) B_s(t)
so that
    p(t) = sum_f cos(Omega_f t) B1_f(t) - sin(Omega_f t) B2_f(t)
    q(t) = sum_f sin(Omega_f t) B1_f(t) + cos(Omega_f t) B2_f(t)
with B1_f = B @ alpha_re[f], B2_f = B @ alpha_im[f].

Instead of evaluating splines per time step (reference:
controlbasis.cpp + oscillator.cpp:281-337, one scalar evaluation per step), we
precompute the dense basis matrix B of shape (ntimes, nsplines) on the host
once, and evaluate ALL control values on the full time grid with a single
matmul. The evaluation is linear in the parameters, so autograd through it gives
the exact spline-coefficient chain rule of the reference's
`evalControl_diff`/`derivative` at zero extra cost.

Parameter storage layout matches user_guide.md:399-417: oscillators first,
then carrier waves, then splines, real parts before imaginary parts:
    alpha[k][f] = [re_1..re_Ns, im_1..im_Ns].
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


def bspline2_basis(nsplines: int, t0: float, T: float, ts: np.ndarray,
                   enforce_bc: bool = False) -> np.ndarray:
    """Quadratic B-spline basis matrix, shape (len(ts), nsplines).

    Closed-form piecewise quadratic with knot spacing dtknot=(T-t0)/(ns-2),
    width 3*dtknot, centers t0 + dtknot*(i - 0.5) (controlbasis.cpp:20-96).
    If enforce_bc, the first/last two basis columns are zeroed so the pulse
    starts and ends at zero (controlbasis.cpp:38-46).
    """
    dtknot = (T - t0) / (nsplines - 2)
    width = 3.0 * dtknot
    centers = t0 + dtknot * (np.arange(nsplines) - 0.5)
    tau = (ts[:, None] - centers[None, :]) / width
    B = np.zeros_like(tau)
    m1 = (-0.5 <= tau) & (tau < -1.0 / 6.0)
    m2 = (-1.0 / 6.0 <= tau) & (tau < 1.0 / 6.0)
    m3 = (1.0 / 6.0 <= tau) & (tau < 0.5)
    B[m1] = 9.0 / 8.0 + 9.0 / 2.0 * tau[m1] + 9.0 / 2.0 * tau[m1] ** 2
    B[m2] = 3.0 / 4.0 - 9.0 * tau[m2] ** 2
    B[m3] = 9.0 / 8.0 - 9.0 / 2.0 * tau[m3] + 9.0 / 2.0 * tau[m3] ** 2
    if enforce_bc:
        B[:, :2] = 0.0
        B[:, nsplines - 2:] = 0.0
    return B


def bspline0_basis(nsplines: int, t0: float, T: float, ts: np.ndarray,
                   enforce_bc: bool = False) -> np.ndarray:
    """Piecewise-constant (0th order) basis matrix (controlbasis.cpp:218-254).

    Active spline at time t: ceil((t-t0)/dtknot - 0.5), dtknot=(T-t0)/(ns-1);
    zero outside [0, nsplines).
    """
    dtknot = (T - t0) / (nsplines - 1.0)
    sid = np.ceil((ts - t0) / dtknot - 0.5).astype(np.int64)
    B = np.zeros((len(ts), nsplines))
    valid = (sid >= 0) & (sid < nsplines)
    B[np.nonzero(valid)[0], sid[valid]] = 1.0
    if enforce_bc:
        B[:, 0] = 0.0
        B[:, nsplines - 1] = 0.0
    return B


def ramp_factor(ts: np.ndarray, tstart: float, tstop: float, tramp: float) -> np.ndarray:
    """Linear ramp envelope used by Step segments (util.cpp:92-120)."""
    if tramp <= 1e-13:
        return np.ones_like(ts) * ((ts >= tstart) & (ts <= tstop))
    up = (ts - tstart) / tramp
    down = (tstop - ts) / tramp
    r = np.minimum(1.0, np.minimum(up, down))
    r = np.maximum(r, 0.0)
    if tstop < tstart + 2 * tramp:
        r = np.zeros_like(ts)
    return r


@dataclasses.dataclass(frozen=True)
class ControlSegment:
    """One control segment of an oscillator (reference: ControlBasis subclass).

    kind: 'spline' (2nd order), 'spline0' (piecewise constant),
          'spline_amplitude' (amplitude splines + per-carrier phase),
          'step' (ramped step whose width is the single parameter).
    """
    kind: str
    nsplines: int = 0
    tstart: float = 0.0
    tstop: float = 0.0
    scaling: float = 1.0        # spline_amplitude phase scaling
    step_amp1: float = 0.0      # step amplitudes (rad/ns)
    step_amp2: float = 0.0
    tramp: float = 0.0

    def nparams_per_carrier(self) -> int:
        if self.kind in ("spline", "spline0"):
            return 2 * self.nsplines
        if self.kind == "spline_amplitude":
            return self.nsplines + 1
        if self.kind == "step":
            return 1
        raise ValueError(f"unknown control segment kind {self.kind}")


@dataclasses.dataclass(frozen=True)
class OscillatorControl:
    """Full control parameterization of one oscillator: a list of segments,
    a list of carrier frequencies (rad/ns), and the boundary-condition flag."""
    segments: Tuple[ControlSegment, ...]
    carrier_freqs: Tuple[float, ...]     # rad/ns
    enforce_bc: bool = False

    @property
    def nparams(self) -> int:
        nf = len(self.carrier_freqs)
        return sum(seg.nparams_per_carrier() * nf for seg in self.segments)


def segment_window_masks(segments: Sequence[ControlSegment], ts: np.ndarray) -> np.ndarray:
    """(nseg, nt) bool: segment s active at ts[j]. Matches the reference's
    first-match-wins lookup (oscillator.cpp:296-323)."""
    nseg = len(segments)
    masks = np.zeros((nseg, len(ts)), dtype=bool)
    taken = np.zeros(len(ts), dtype=bool)
    for s, seg in enumerate(segments):
        m = (ts >= seg.tstart) & (ts <= seg.tstop) & (~taken)
        masks[s] = m
        taken |= m
    return masks


@dataclasses.dataclass(frozen=True)
class ControlEvalPlan:
    """Precomputed host-side tensors to evaluate (p, q) for ALL oscillators on
    a fixed time grid with a few matmuls. Built once per (controls, ts) pair.

    For each oscillator k and segment s the plan holds a masked basis matrix
    (nt, nsplines) and carrier cos/sin tables (nt, nf). The device-side
    evaluation is in quandary_tpu_torch.models.controls.eval_controls.
    """
    ts: np.ndarray
    oscillators: Tuple[OscillatorControl, ...]
    # per oscillator: list over segments of basis matrices (nt, nparams_layout)
    basis: tuple            # nested: basis[k][s] -> np.ndarray (nt, ns)
    cos_t: tuple            # cos_t[k] -> (nt, nf)
    sin_t: tuple
    param_offsets: np.ndarray   # (Q+1,) offsets of each oscillator in the global vector

    @property
    def nparams(self) -> int:
        return int(self.param_offsets[-1])


def build_control_plan(oscillators: Sequence[OscillatorControl], ts: np.ndarray) -> ControlEvalPlan:
    ts = np.asarray(ts, dtype=np.float64)
    basis_all = []
    cos_all = []
    sin_all = []
    offsets = [0]
    for osc in oscillators:
        masks = segment_window_masks(osc.segments, ts)
        seg_bases = []
        for s, seg in enumerate(osc.segments):
            if seg.kind == "spline":
                B = bspline2_basis(seg.nsplines, seg.tstart, seg.tstop, ts, osc.enforce_bc)
            elif seg.kind == "spline0":
                B = bspline0_basis(seg.nsplines, seg.tstart, seg.tstop, ts, osc.enforce_bc)
            elif seg.kind == "spline_amplitude":
                B = bspline2_basis(seg.nsplines, seg.tstart, seg.tstop, ts, osc.enforce_bc)
            elif seg.kind == "step":
                # Step segments are parameter-NONLINEAR (the single parameter
                # sets the step end time, controlbasis.cpp:195-206), so no
                # linear basis exists; store the window mask and let the
                # device-side evaluator compute the ramp from the parameter.
                B = np.ones((len(ts), 1))
            else:
                raise ValueError(seg.kind)
            seg_bases.append(B * masks[s][:, None])
        basis_all.append(tuple(seg_bases))
        om = np.asarray(osc.carrier_freqs)
        cos_all.append(np.cos(om[None, :] * ts[:, None]))
        sin_all.append(np.sin(om[None, :] * ts[:, None]))
        offsets.append(offsets[-1] + osc.nparams)
    return ControlEvalPlan(
        ts=ts,
        oscillators=tuple(oscillators),
        basis=tuple(basis_all),
        cos_t=tuple(cos_all),
        sin_t=tuple(sin_all),
        param_offsets=np.asarray(offsets, dtype=np.int64),
    )
