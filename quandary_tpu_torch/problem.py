"""Problem assembly: from a resolved setup to differentiable objective
functions, in PyTorch.

Counterpart of quandary_tpu/problem.py for closed and open (Lindblad)
systems with the dense operator-stack engine and the single-stage IMR
stepper. The multi-initial-condition objective (forward propagation of the
whole batch, final-time cost, fidelity, the penalty integrals and the
regularizers) is one torch function of the control parameters, evaluated
for a (E, nparams) batch of control candidates at once.

Two propagation paths, as in the JAX package:

* fused (the default): one kernel launch per direction, the CUDA kernel
  pair on the GPU and its plain torch version on the CPU; the objective
  tail runs on (re, im) planes. ``Setup.fused_mode`` (the JAX package's
  ``pallas_mode``) picks the kernel family: 'streamk' (the default), the
  streamK propagation of ops/streamk.py with the H planes contracted
  in-kernel; 'stream', the streamed-plane kernels of ops/stream.py, whose
  planes are built outside the kernel and whose backward emits the plane
  cotangents; 'chunk', the cross-check path of ops/adjoint.py (closed
  systems, plain Neumann). Open systems take one of two routes
  (``Setup.fused_rho``): 'superop', the column-major vec(rho) of dimension
  N^2 with the pseudo-Hamiltonian stack H' = i L (lindblad_prime_stack) on
  the streamK or the stream kernels, or 'rho', the density-matrix kernels
  of ops/rho.py (streamK mode only), whose state stays an (N, N) matrix.
  'auto' takes superop where one thread block of the streamK kernels holds
  dimension N^2, else rho;
* plain (``fused=False``, CPU only): the complex-arithmetic step function
  in a Python time loop, differentiated by autograd (density matrices in
  matrix form).

A Problem's operator stacks are constants, as in the JAX Problem: only the
controls are differentiated here. Stack cotangents, for calibrating the
Hamiltonian itself, come from ops/stream.py::make_stream_propagate (the
stream route); the streamK route has none by contract.

The problem lives on the CUDA device unless the caller names another
(``device="cpu"``, as the CPU tests do); without a CUDA device and without
that argument the constructor raises.

Not ported yet, and refused with NotImplementedError: structured engines,
IMR4/IMR8/EE, GMRES, the time-parallel scan; on CUDA also complex128, the
plain path, and systems past what one thread block of the route's kernels
holds (``Problem.fused_ok``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .models import initialconditions as ic
from .models.controls import (control_variation_penalty, eval_controls,
                              eval_controls_labframe, plan_on_device)
from .models.hamiltonian import HamiltonianModel
from .ops import rho, solvers, stream, streamk
from .ops.rhs import DenseEngine
from .ops.steppers import make_step_fn, stage_midpoint_times
from .utils.indexing import flat_index, guard_mask
from .utils.splines import OscillatorControl, build_control_plan


@dataclasses.dataclass
class Setup:
    """Fully-resolved problem specification in internal units (rad/ns, ns).
    Field names and meanings follow quandary_tpu.problem.Setup; ``fused``
    plays the role of its ``pallas`` flag."""
    model: HamiltonianModel
    nessential: Tuple[int, ...]
    ntime: int
    dt: float
    timestepper: str = "IMR"
    linsolve_iters: int = 20
    linsolver: str = "neumann"

    oscillators: Tuple[OscillatorControl, ...] = ()
    pipulses: Optional[tuple] = None
    ground_freqs_radns: Tuple[float, ...] = ()

    initcond_type: str = "basis"
    initcond_ids: Tuple[int, ...] = ()
    pure_levels: Optional[Tuple[int, ...]] = None
    initial_state_ess: Optional[np.ndarray] = None

    target_type: str = "none"                  # 'gate' | 'pure' | 'file' | 'state' | 'none'
    target_gate_full: Optional[np.ndarray] = None
    target_state_full: Optional[np.ndarray] = None
    target_batch: Optional[np.ndarray] = None
    pure_target_levels: Optional[Tuple[int, ...]] = None

    objective_type: str = "Jtrace"
    obj_weights: Optional[np.ndarray] = None

    gamma_tik: float = 1e-4
    gamma_tik_interpolate: bool = False
    gamma_penalty: float = 0.0
    penalty_param: float = 0.0
    gamma_penalty_dpdm: float = 0.0
    gamma_penalty_energy: float = 0.0
    gamma_penalty_variation: float = 0.0

    dtype: torch.dtype = torch.complex128
    # True: fused propagation (kernel on CUDA, plain torch on CPU);
    # False: the plain complex time loop (CPU only)
    fused: bool = True
    # Fused state form for OPEN systems (quandary_tpu's pallas_rho): 'auto'
    # runs the vectorized superoperator on the streamK kernels where one
    # thread block holds dimension N^2 and the density-matrix kernels
    # (ops/rho.py) past that; 'rho' forces the matrix form, 'superop'
    # forbids it.
    fused_rho: str = "auto"
    # Fused kernel family (quandary_tpu's pallas_mode): 'streamk' contracts
    # the H planes in-kernel (ops/streamk.py); 'stream' builds them outside
    # and streams them (ops/stream.py; open systems on the superop route
    # only); 'chunk' is the cross-check path (ops/adjoint.py; closed
    # systems with plain Neumann only).
    fused_mode: str = "streamk"

    @property
    def total_time(self) -> float:
        return self.ntime * self.dt

    @property
    def nparams(self) -> int:
        return sum(o.nparams for o in self.oscillators)


class Problem:
    """Device-ready problem: control plans, state batches and constants on
    `device`, and the objective built from them. `device=None` is the CUDA
    device, and raises where there is none."""

    def __init__(self, setup: Setup, device=None):
        s = self.setup = setup
        model = self.model = setup.model
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Problem runs on the CUDA device by default and "
                    "torch.cuda.is_available() is false; pass device='cpu' "
                    "to run the plain torch version on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.lindblad = model.lindblad
        if s.fused_rho not in ("auto", "rho", "superop"):
            raise ValueError("fused_rho must be 'auto', 'rho' or 'superop', "
                             f"got {s.fused_rho!r}")
        if s.fused_mode not in ("streamk", "stream", "chunk"):
            raise ValueError("fused_mode must be 'streamk', 'stream' or "
                             f"'chunk', got {s.fused_mode!r}")
        if s.dtype not in (torch.complex64, torch.complex128):
            raise ValueError(f"dtype must be complex64/complex128, got {s.dtype}")
        if cuda and s.dtype != torch.complex64:
            raise NotImplementedError(
                "complex128 is not ported to CUDA: the kernels run float32 "
                "planes (dtype=torch.complex64)")
        # the fused-path gate, reduced to the dense single-stage branch
        # (make_step_fn below refuses every other stepper/solver)
        self.use_fused = bool(s.fused)
        if cuda and not self.use_fused:
            raise NotImplementedError(
                "on CUDA only the fused streamK and rho paths are ported; "
                "the plain complex time loop (fused=False) runs on the CPU")
        if cuda and self.device.index is None:
            # with its index ("cuda" -> "cuda:0"), as tensors report it
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.N = model.N
        self.rdtype = (torch.float64 if s.dtype == torch.complex128
                       else torch.float32)
        self.engine = DenseEngine(model, s.dtype, self.device)
        npdt = np.complex64 if s.dtype == torch.complex64 else np.complex128
        nprdt = np.float32 if s.dtype == torch.complex64 else np.float64

        # --- time grids and control plans ---
        ntime, dt = s.ntime, s.dt
        self.ts_mid = stage_midpoint_times(ntime, dt, s.timestepper)
        self.nstages = self.ts_mid.shape[1]
        self.plan_mid = build_control_plan(s.oscillators, self.ts_mid.reshape(-1))
        self.ts_stop = np.arange(1, ntime + 1) * dt
        self.plan_stop = build_control_plan(s.oscillators, self.ts_stop)
        self.ts_out = np.arange(ntime + 1) * dt
        self.plan_out = build_control_plan(s.oscillators, self.ts_out)

        # --- initial conditions ---
        osc_ids = s.initcond_ids if len(s.initcond_ids) > 0 \
            else tuple(range(model.n_osc))
        x0_np, _ = ic.build_initial_states(
            s.initcond_type, model.dims, s.nessential, osc_ids, self.lindblad,
            pure_levels=s.pure_levels, from_file_state=s.initial_state_ess)
        self.ninit = x0_np.shape[0]
        self.x0 = x0_np.astype(npdt)

        # --- objective weights (optimproblem.cpp:71-91) ---
        w = np.asarray(s.obj_weights if s.obj_weights is not None else [1.0],
                       dtype=float)
        if w.size < self.ninit:
            w = np.concatenate([w, np.full(self.ninit - w.size, w[-1])])
        w = w[: self.ninit]
        self.weights = (w / w.sum()).astype(nprdt)

        # --- targets ---
        self.pure_target_id = None
        self.target = None
        if s.target_batch is not None:
            self.target = np.asarray(s.target_batch).astype(npdt)
        elif s.target_type == "gate" and s.target_gate_full is not None:
            V = np.asarray(s.target_gate_full, dtype=np.complex128)
            if self.lindblad:
                tgt = np.einsum("ij,bjk,lk->bil", V, x0_np, V.conj())
            else:
                tgt = np.einsum("ij,bj->bi", V, x0_np)
            self.target = tgt.astype(npdt)
        elif s.target_type in ("file", "state") \
                and s.target_state_full is not None:
            t1 = np.asarray(s.target_state_full, dtype=np.complex128)
            if self.lindblad and t1.ndim == 1:
                t1 = np.outer(t1, t1.conj())
            tgt = np.broadcast_to(t1, (self.ninit,) + t1.shape)
            self.target = np.ascontiguousarray(tgt).astype(npdt)
        elif s.target_type == "pure":
            levels = s.pure_target_levels or tuple([0] * model.n_osc)
            self.pure_target_id = flat_index(levels, model.dims)
        elif s.target_type not in ("none", None):
            raise ValueError(
                f"target_type {s.target_type!r} provided without a usable "
                "target (expected gate/file/state/pure/none with the "
                "matching target_* field set)")

        # purity Tr(rho0^2) per initial condition (optimtarget.cpp:701-708)
        flat0 = x0_np.reshape(self.ninit, -1)
        self.purity = np.maximum(np.sum(np.abs(flat0) ** 2, axis=1),
                                 1e-300).astype(nprdt)

        # --- penalty precomputations ---
        gmask = guard_mask(model.dims, s.nessential)
        self.has_guard = bool(gmask.any())
        self.guard_mask = gmask
        if s.penalty_param > 1e-13:
            a, T = s.penalty_param, s.total_time
            self.jt_weight = ((1.0 / a) * np.exp(
                -(((self.ts_stop - T) / a) ** 2))).astype(nprdt)
        else:
            self.jt_weight = None
        self.measure_weights = None if self.pure_target_id is None else \
            np.abs(np.arange(self.N) - self.pure_target_id).astype(nprdt)

        # --- stiffness guard (problem.py:386-438 of the JAX package): past
        # u = dt/2 * max|H_diag| the truncated Neumann series is inaccurate
        # long before it diverges; switch to the Jacobi-preconditioned
        # solve, which the dense engine's diagonal always allows ---
        self.linsolver = s.linsolver
        self.gen_diag = self.engine.gen_diag()
        lam = float(np.abs(np.diagonal(self.engine.stack_np[0])).max())
        u_stiff = 0.5 * dt * lam
        u_ok = float(np.exp(np.log(1e-6) / (s.linsolve_iters + 1)))
        if self.linsolver == "neumann" and u_stiff > u_ok:
            self.linsolver = "jacobi"
        self.step_fn = make_step_fn(self.engine.rhs, dt, s.timestepper,
                                    s.linsolve_iters, self.linsolver,
                                    gen_diag=self.gen_diag)

        # --- the fused route (the JAX package's pallas_form gate,
        # problem.py:440-499) ---
        # closed: the fused_mode's kernels on (B, N) vectors. Open:
        # 'superop', the column-major vec(rho) of dimension N^2, where one
        # thread block of the streamK kernels holds it (or when forced, and
        # always in 'stream' mode); else 'rho', the density-matrix kernels
        # on (B, N, N) matrices. 'chunk' takes closed plain-Neumann
        # problems only.
        iters, K = s.linsolve_iters, model.K
        self.fused_form = None
        if self.use_fused:
            self.fused_form = s.fused_mode
            if s.fused_mode == "chunk" and (self.lindblad
                                            or self.linsolver != "neumann"):
                raise NotImplementedError(
                    "fused_mode='chunk' runs closed systems with plain "
                    "Neumann stage solves only; this problem is "
                    + ("open" if self.lindblad else
                       f"closed with linsolver={self.linsolver!r}")
                    + " (use fused_mode='stream')")
            if self.lindblad and s.fused_mode == "stream":
                if s.fused_rho == "rho":
                    raise NotImplementedError(
                        "the density-matrix (rho) route runs on the streamK "
                        "kernels only; fused_mode='stream' takes open "
                        "systems on the superop route")
                self.fused_form = "superop"
            elif self.lindblad:
                too_big = streamk.size_refusal(
                    self.ninit, self.N * self.N,
                    K + (self.linsolver == "split"), iters) is not None
                self.fused_form = "rho" if s.fused_rho == "rho" or (
                    s.fused_rho == "auto" and too_big) else "superop"
        # superop states are FLAT: diagonals become the strided j*(N+1)
        # gather and the Hilbert-Schmidt overlap the same flat sum
        self._flat = self.fused_form == "superop"
        self._srank = 2 if self.lindblad and not self._flat else 1

        # --- constants on the device: real planes of x0, the target and
        # the operator stack, in the fused route's state layout ---
        dev = dict(device=self.device)
        rt = lambda a: torch.as_tensor(np.ascontiguousarray(a), **dev).to(
            self.rdtype)
        vec = (lambda a: a.transpose(0, 2, 1).reshape(self.ninit, -1)) \
            if self._flat else (lambda a: a)
        x0k = vec(self.x0)
        self._x0r, self._x0i = rt(x0k.real), rt(x0k.imag)
        self._x0c = torch.as_tensor(self.x0, **dev)
        if self.target is not None:
            tk = vec(self.target)
            self._tgtr, self._tgti = rt(tk.real), rt(tk.imag)
        self._weights = rt(self.weights)
        self._purity = rt(self.purity)
        self._gmask = rt(self.guard_mask.astype(nprdt))
        self._jt_weight = None if self.jt_weight is None else rt(self.jt_weight)
        self._measure = None if self.measure_weights is None \
            else rt(self.measure_weights)
        self._diag_idx = torch.arange(self.N, device=self.device) \
            * (self.N + 1)
        stack_k = streamk.lindblad_prime_stack(
            self.engine.stack_np, self.engine.Ls_np) if self._flat \
            else self.engine.stack_np
        self._Sr, self._Si = rt(stack_k.real), rt(stack_k.imag)
        # the control plans and the JC phase columns as device tensors, so
        # that an objective evaluation copies nothing from the host
        self._plan_mid = plan_on_device(self.plan_mid, self.rdtype,
                                        self.device)
        self._plan_stop = plan_on_device(self.plan_stop, self.rdtype,
                                         self.device)
        self._jc_mid = rt(model.jc_columns(self.plan_mid.ts))
        # the route's launch plan (stacks, solver rows or planes), built once
        self._plan = self._refusal = None
        gd = self.gen_diag.T.reshape(-1) if self._flat else self.gen_diag
        if self.fused_form == "rho":
            self._plan = rho.make_plan(
                self._Sr, self._Si, self.engine.Ls_np, s.dt, iters,
                self.gen_diag, self.linsolver)
            self._refusal = rho.launch_refusal(self.N, K)
        elif self.use_fused and s.fused_mode == "streamk":
            self._plan = streamk.make_plan(self._Sr, self._Si, s.dt, iters,
                                           gd, self.linsolver)
            self._refusal = streamk.launch_refusal(
                self._plan, self.ninit, self._Sr.shape[-1])
        elif self.use_fused:
            self._plan = stream.make_plan(self._Sr, s.dt, iters,
                                          gd, self.linsolver,
                                          kind=s.fused_mode)
            self._refusal = stream.launch_refusal(
                self._plan, self.ninit, self._Sr.shape[-1], ntime)
        if cuda and self._refusal is not None:
            raise NotImplementedError(self._refusal)

    @property
    def fused_ok(self) -> bool:
        """Whether the kernels of the problem's fused route (`fused_form`)
        admit it: the fused path is on and one thread block holds a
        candidate (streamK: B*dim state entries, the stacks and the stage
        iterates; stream and chunk: B*dim state entries, the step's planes
        and the stage iterates, and the sweep's plane arrays at E = 1 under
        stream.PLANE_BUDGET_BYTES; rho: one (N, N) density matrix).
        `fused_refusal` names the limit otherwise. On the CPU it tells what
        the card would do; the plain version there runs any size."""
        return self.use_fused and self._refusal is None

    @property
    def fused_refusal(self) -> Optional[str]:
        if not self.use_fused:
            return "the fused path is off (Setup.fused=False)"
        return self._refusal

    # ------------------------------------------------------------------
    # objective tail on (re, im) planes; every function takes leading
    # candidate axes: states (..., B, N) closed, (..., B, N^2) open on the
    # superop route (column-major vec(rho)), (..., B, N, N) open otherwise;
    # histories carry the time axis before B
    # ------------------------------------------------------------------

    def _state_sum(self, t):
        """Sum over the state axes (one, or two for (N, N) matrices)."""
        return torch.sum(t, dim=tuple(range(-self._srank, 0)))

    def _diag_real(self, xr):
        """Diagonal entries of one plane, (..., N): rho_ii for open systems
        (the strided j*(N+1) gather in the flat vec layout), the plane
        itself for closed ones."""
        if not self.lindblad:
            return xr
        if self._flat:
            return xr[..., self._diag_idx]
        return torch.diagonal(xr, dim1=-2, dim2=-1)

    def _overlaps_real(self, xr, xi):
        """Hilbert-Schmidt overlap <target, x> per initial condition:
        (Re, Im) of shape (..., B)."""
        if self.target is not None:
            re = self._state_sum(self._tgtr * xr + self._tgti * xi)
            im = self._state_sum(self._tgtr * xi - self._tgti * xr)
            return re, im
        if self.pure_target_id is not None:
            m = self.pure_target_id
            return self._diag_real(xr)[..., m], self._diag_real(xi)[..., m]
        z = xr.new_zeros(xr.shape[:-self._srank])
        return z, z

    def _eval_J_parts_real(self, xr, xi):
        """Per-initial-condition raw objective parts (J_re, J_im), (..., B)."""
        obj = self.setup.objective_type
        if obj == "Jtrace":
            re, im = self._overlaps_real(xr, xi)
            return re / self._purity, im
        if obj == "Jfrobenius":
            if self.target is not None:
                dr, di = xr - self._tgtr, xi - self._tgti
                J = 0.5 * self._state_sum(dr * dr + di * di)
            else:
                dm = self._diag_real(xr)[..., self.pure_target_id]
                norm2 = self._state_sum(xr * xr + xi * xi)
                J = 0.5 * (norm2 - 2.0 * dm + 1.0)
            return J, torch.zeros_like(J)
        if obj == "Jmeasure":
            pop = self._diag_real(xr) if self.lindblad else xr * xr + xi * xi
            J = pop @ self._measure
            return J, torch.zeros_like(J)
        raise ValueError(obj)

    def _finalize_J(self, J_re, J_im):
        """Scalar objective from the J parts (optimtarget.cpp:864-879)."""
        if self.setup.objective_type == "Jtrace":
            if self.lindblad:
                return 1.0 - J_re
            return 1.0 - (J_re ** 2 + J_im ** 2)
        return J_re

    def _history_penalties_real(self, hr, hi):
        """Integral penalties over the (..., ntime, B, state) history: guard
        leakage (on the diagonal for open systems), the weighted-J window
        and the population second difference (dpdm, closed systems only);
        each (..., B) or None when off."""
        s = self.setup
        pen_leak = pen_jt = pen_dpdm = None
        if self.has_guard and s.gamma_penalty > 1e-13:
            dr, di = self._diag_real(hr), self._diag_real(hi)
            leak = torch.sum((dr * dr + di * di) * self._gmask, dim=-1)
            pen_leak = torch.sum(leak, dim=-2) / s.ntime
        if self._jt_weight is not None and s.gamma_penalty > 1e-13:
            re, im = self._eval_J_parts_real(hr, hi)
            Jtb = self._finalize_J(re, im)
            pen_jt = torch.sum(self._jt_weight[:, None] * Jtb, dim=-2) * s.dt
        if s.gamma_penalty_dpdm > 1e-13 and not self.lindblad:
            pop0 = (self._x0r ** 2 + self._x0i ** 2).expand(
                hr.shape[:-3] + (1,) + self._x0r.shape)
            pop = torch.cat([pop0, hr * hr + hi * hi], dim=-3)
            sec = pop[..., 2:, :, :] - 2.0 * pop[..., 1:-1, :, :] \
                + pop[..., :-2, :, :]
            pen_dpdm = torch.sum(sec * sec, dim=(-3, -1)) / s.dt ** 4
        return pen_leak, pen_jt, pen_dpdm

    def _energy_integral(self, params):
        s = self.setup
        if s.gamma_penalty_energy > 1e-13:
            p, q = eval_controls(self._host_or_device(self._plan_stop,
                                                      self.plan_stop, params),
                                 params, s.pipulses)
            return torch.sum(p ** 2 + q ** 2, dim=(-2, -1)) / s.ntime
        return params.new_zeros(params.shape[:-1])

    def _assemble_objective_real(self, params, params_ref, xTr, xTi,
                                 pen_leak, pen_jt, pen_dpdm, energy_int):
        """Final-time cost, fidelity, regularizers and totals, (...,)."""
        s = self.setup
        w = self._weights
        J_re_b, J_im_b = self._eval_J_parts_real(xTr, xTi)
        obj_cost = self._finalize_J(torch.sum(w * J_re_b, dim=-1),
                                    torch.sum(w * J_im_b, dim=-1))
        ov_re, ov_im = self._overlaps_real(xTr, xTi)
        fid_re = torch.sum(ov_re, dim=-1) / self.ninit
        fid_im = torch.sum(ov_im, dim=-1) / self.ninit
        fidelity = fid_re if self.lindblad else fid_re ** 2 + fid_im ** 2

        dx = params - params_ref if s.gamma_tik_interpolate else params
        obj_regul = 0.5 * s.gamma_tik * torch.sum(dx * dx, dim=-1)
        zero = torch.zeros_like(obj_cost)
        obj_penal = zero
        if pen_leak is not None:
            obj_penal = obj_penal + s.gamma_penalty * torch.sum(w * pen_leak, -1)
        if pen_jt is not None:
            obj_penal = obj_penal + s.gamma_penalty * torch.sum(w * pen_jt, -1)
        obj_penal_dpdm = zero if pen_dpdm is None else (
            s.gamma_penalty_dpdm * torch.sum(w * pen_dpdm, -1) / s.ntime)
        obj_penal_energy = s.gamma_penalty_energy * energy_int
        obj_penal_variation = zero
        if s.gamma_penalty_variation > 1e-13:
            obj_penal_variation = 0.5 * s.gamma_penalty_variation * \
                control_variation_penalty(self.plan_mid, params)
        J = (obj_cost + obj_regul + obj_penal + obj_penal_dpdm
             + obj_penal_energy + obj_penal_variation)
        aux = {
            "obj_cost": obj_cost,
            "obj_regul": obj_regul,
            "obj_penal": obj_penal,
            "obj_penal_dpdm": obj_penal_dpdm,
            "obj_penal_energy": obj_penal_energy,
            "obj_penal_variation": obj_penal_variation,
            "fidelity": fidelity,
        }
        return J, aux

    # ------------------------------------------------------------------
    # objective
    # ------------------------------------------------------------------

    def _host_or_device(self, dev_plan, host_plan, params):
        """The device plan for parameters in the problem's dtype on its
        device; else the f64 host plan, cast to the parameters' dtype."""
        same = params.dtype == self.rdtype and params.device == self.device
        return dev_plan if same else host_plan

    def coeff_rows_mid(self, params):
        """(..., ntime, nstages, K) coefficient rows at the stage midpoints."""
        plan = self._host_or_device(self._plan_mid, self.plan_mid, params)
        p, q = eval_controls(plan, params, self.setup.pipulses)
        C = self.model.coeff_rows(
            p, q, self.plan_mid.ts,
            jc=self._jc_mid if plan is self._plan_mid else None)
        return C.reshape(params.shape[:-1]
                         + (self.setup.ntime, self.nstages, self.model.K))

    def _objective_batch(self, Ps, params_ref):
        """Objective of the (E, nparams) candidates Ps: (J (E,), aux)."""
        C = self.coeff_rows_mid(Ps)
        energy_int = self._energy_integral(Ps)
        if self.fused_form == "rho":
            xTr, xTi, hr, hi = rho.rho_propagate(
                self._plan, self._x0r, self._x0i,
                C[..., 0, :].to(self.rdtype).contiguous())
        elif self.use_fused and self.setup.fused_mode == "streamk":
            xTr, xTi, hr, hi = streamk.streamk_propagate(
                self._plan, self._x0r, self._x0i,
                streamk.extend_coeffs(self._plan, C[..., 0, :]))
        elif self.use_fused:
            Hr, Hi = stream.planes(self._plan, self._Sr, self._Si,
                                   C[..., 0, :].to(self.rdtype))
            xTr, xTi, hr, hi = stream.stream_propagate(
                self._plan, Hr, Hi, self._x0r, self._x0i)
        else:
            x0 = self._x0c.expand((Ps.shape[0],) + self._x0c.shape)
            traj = solvers.propagate_trajectory(self.step_fn, x0,
                                                C.movedim(-3, 0))
            hist = traj[1:].movedim(0, 1)
            hr, hi = hist.real, hist.imag
            xTr, xTi = hr[:, -1], hi[:, -1]
        pens = self._history_penalties_real(hr, hi)
        return self._assemble_objective_real(Ps, params_ref, xTr, xTi,
                                             *pens, energy_int)

    def objective(self, params, params_ref):
        """Full objective of one control vector: (J, aux) with every term
        and the fidelity (optimproblem.cpp:224-338 semantics)."""
        J, aux = self._objective_batch(params[None], params_ref)
        return J[0], {k: v[0] for k, v in aux.items()}

    def _param_tensor(self, x):
        return torch.as_tensor(x, device=self.device).to(self.rdtype).detach()

    @staticmethod
    def _detached(J, aux):
        return J.detach(), {k: v.detach() for k, v in aux.items()}

    def build_value_and_grad(self):
        """fn(params, params_ref) -> ((J, aux), grad), one gradient sweep."""
        def vg(params, params_ref):
            p = self._param_tensor(params).requires_grad_(True)
            J, aux = self.objective(p, self._param_tensor(params_ref))
            (g,) = torch.autograd.grad(J, p)
            return self._detached(J, aux), g
        return vg

    def build_objective(self):
        """fn(params, params_ref) -> (J, aux): the forward propagation and
        the objective tail only."""
        def obj(params, params_ref):
            with torch.no_grad():
                return self.objective(self._param_tensor(params),
                                      self._param_tensor(params_ref))
        return obj

    def build_ensemble_value_and_grad(self):
        """fn(Ps, params_ref) -> ((J (E,), aux (E,)), grad (E, nparams)):
        E control candidates through one kernel launch per direction. Each
        J_e depends on Ps[e] only, so the gradient of sum(J) is the stack of
        per-candidate gradients."""
        def evg(Ps, params_ref):
            P = self._param_tensor(Ps).requires_grad_(True)
            J, aux = self._objective_batch(P, self._param_tensor(params_ref))
            (g,) = torch.autograd.grad(J.sum(), P)
            return self._detached(J, aux), g
        return evg

    def _ensemble_objective(self):
        """fn(Ps, params_ref) -> (J (E,), aux (E,)): the objective-only
        companion of the ensemble value_and_grad, one forward launch and no
        backward (batched line searches, population evaluation)."""
        def eobj(Ps, params_ref):
            with torch.no_grad():
                return self._objective_batch(
                    self._param_tensor(Ps), self._param_tensor(params_ref))
        return eobj

    def packed_batch_fns(self, params_ref):
        """The batch hooks of optim.batched_lbfgs.batched_lbfgsb: a
        population's objective and gradient evaluations as ensemble
        launches. Returns dict(objective_batch, grad_batch, vg_batch), to
        be splatted into batched_lbfgsb(**kw); they take and return
        tensors on the problem's device."""
        ref = self._param_tensor(params_ref)
        eobj = self._ensemble_objective()
        evg = self.build_ensemble_value_and_grad()

        def vg_batch(xs):
            (J, _), g = evg(xs, ref)
            return J, g

        return dict(objective_batch=lambda xs: eobj(xs, ref)[0],
                    grad_batch=lambda xs: vg_batch(xs)[1],
                    vg_batch=vg_batch)

    def build_ensemble_sweeps(self):
        """f(Ps (reps, E, nparams), params_ref) -> scalar tensor: reps
        ensemble gradient sweeps enqueued back to back, summed into one
        scalar (J and the gradients), with one synchronization at the end.
        The throughput probe: nothing is fetched between the sweeps."""
        evg = self.build_ensemble_value_and_grad()

        def reps(Ps, params_ref):
            Ps = self._param_tensor(Ps)
            ref = self._param_tensor(params_ref)
            acc = torch.zeros((), dtype=self.rdtype, device=self.device)
            for P in Ps:
                (J, _), g = evg(P, ref)
                acc = acc + J.sum() + g.sum()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return acc
        return reps

    def controls_on_output_grid(self, params):
        """(ts, p, q, f_lab) on the output time grid t_n = n*dt."""
        params = self._param_tensor(params)
        p, q = eval_controls(self.plan_out, params, self.setup.pipulses)
        f = eval_controls_labframe(self.plan_out, params,
                                   self.setup.ground_freqs_radns,
                                   self.setup.pipulses)
        return self.ts_out, p, q, f
