"""Problem assembly: from a resolved setup to differentiable objective
functions, in PyTorch.

Counterpart of quandary_tpu/problem.py for closed and open (Lindblad)
systems: the dense operator-stack engine, and past N = 1024 the structured
engines (ops/tensor_rhs.py, ops/grouped_rhs.py, ops/grouped_lindblad.py)
of a StructuredModel. The multi-initial-condition
objective (forward propagation of the whole batch, final-time cost,
fidelity, the penalty integrals and the regularizers) is one torch function
of the control parameters, evaluated for a (E, nparams) batch of control
candidates at once.

Three propagation paths, as in the JAX package:

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
* plain (``fused=False``): the complex-arithmetic step function in a
  Python time loop, differentiated by autograd (density matrices in matrix
  form), on the CPU or on the card: the counterpart of the JAX package's
  XLA scan, for what neither the fused route nor the time-parallel scan
  takes (GMRES, the split stepper off the kernels, the structured engines,
  large systems);
* time-parallel (``Setup.time_parallel``, ops/propagator.py): every step's
  operator S_n as a matrix, all at once, and the prefix products
  P_n = S_n ... S_1 by an associative scan, so that the whole history
  comes from batched matrix products and the gradient from autograd
  through them. 'auto' takes it where the reference does
  (quandary_tpu/problem.py:574-590): off the fused route, on the dense
  engine with a Neumann or Jacobi stage solve, with ntime dim^2 within
  ``time_parallel_budget`` (dim = N closed, N^2 open) and dim <= 64 or
  dim <= 4 ninit; True takes it wherever that is feasible, False never.
  On the card that is the small dense problems in complex128 (a config
  file's) and those the fused route does not take. A sweep keeps about
  (3 + linsolve_iters) complex arrays of ntime dim^2 entries per
  candidate for the gradient (16 bytes an entry in complex128: 2 GiB an
  array at the budget's 2^27 entries), and the scan's operands, about two
  more.

``fused='auto'`` is the JAX package's ``pallas='auto'`` gate: the fused
route where that gate admits the problem (IMR, a stage solve the kernel
family takes, complex64, the dense engine, the family's size budget) and
the problem is on a CUDA device, the plain route everywhere else.

On the plain route the gradient takes one of three adjoints
(``Setup.adjoint``, ``Problem.adjoint_route``): 'stored', autograd through
the loop over the stored states (per-step recomputation on the structured
engines, the reference's 'remat'); 'reversible', the states recomputed
backward by the inverse step (ops/reversible.py); 'grouped', the
hand-written solve-based adjoint of the grouped engine's real-plane step
(ops/grouped_adjoint.py), or 'grouped-ad', the reversible adjoint over
that step. 'auto' picks what the reference's 'auto' picks on the
structured engines (quandary_tpu/problem.py:1194-1290), and 'stored' on the
dense engine, whose plain route carries the CUDA graphs of the step loop
and of the device driver (ROADMAP C4 item 12: the same numbers to
rounding, another memory footprint).
The time-parallel scan takes 'stored' under any ``Setup.adjoint`` (autograd
through its products), as the reference's scan precedes its adjoints.
``fused=True`` forces the fused route and refuses by name
what it does not take; ``Problem.fused_form`` records the route taken
(None on the plain route).

A Problem's operator stacks are constants, as in the JAX Problem: only the
controls are differentiated here. Stack cotangents, for calibrating the
Hamiltonian itself, come from ops/stream.py::make_stream_propagate (the
stream route); the streamK route has none by contract.

The problem lives on the CUDA device unless the caller names another
(``device="cpu"``, as the CPU tests do); without a CUDA device and without
that argument the constructor raises.

On CUDA a fused route (forced, or admitted by 'auto') refuses complex128 and
what the route's kernels do not hold (``Problem.fused_refusal``): 'streamk',
closed or superop, only a sweep past the device-memory budget
(ops/streamk.py::route_refusal; one thread block or a thread-block cluster
per candidate and chunk of basis states); 'stream' and 'chunk' past their
plane budgets; 'rho' past N = 128 (the TPU kernel's
one 128-lane tile: csrc/rho.cu holds N <= 64, csrc/rho_mid.cu the rest).
Under 'auto' such a problem runs on the plain loop instead, with
``fused_refusal`` naming the limit (``route_refusal``, ``fused_decision``);
``fused=True`` raises there.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .models import initialconditions as ic
from .models.controls import (control_variation_penalty, eval_controls,
                              eval_controls_labframe, plan_on_device)
from .models.hamiltonian import HamiltonianModel
from .ops import rho, solvers, stream, streamk
from .ops.grouped_adjoint import make_grouped_adjoint_propagate
from .ops.grouped_lindblad import GroupedLindbladEngine
from .ops.grouped_rhs import (GroupedEngine, make_real_imr_step,
                              make_real_split_step)
from .ops.propagator import (build_step_matrices_dense,
                             lindblad_superop_builder, prefix_propagators,
                             propagate_states)
from .ops.reversible import make_reversible_propagate
from .ops.rhs import DenseEngine
from .ops.steppers import make_step_fn, stage_midpoint_times
from .ops.tensor_rhs import StructuredModel, TensorEngine
from .parallel import mesh as mesh_ops
from .utils.indexing import flat_index, guard_mask
from .utils.operators import drift_diagonal
from .utils.splines import OscillatorControl, build_control_plan


@dataclasses.dataclass
class Setup:
    """Fully-resolved problem specification in internal units (rad/ns, ns).
    Field names and meanings follow quandary_tpu.problem.Setup; ``fused``
    plays the role of its ``pallas`` flag."""
    model: Union[HamiltonianModel, StructuredModel]
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
    # True: fused propagation (kernel on CUDA, its plain torch version on
    # the CPU), refused by name where the route does not take the problem;
    # 'auto' (the default, as quandary_tpu's pallas='auto'): fused where
    # that gate admits it and the problem is on CUDA, else plain; False:
    # the plain complex time loop
    fused: object = "auto"
    # Fused state form for OPEN systems (quandary_tpu's pallas_rho): 'auto'
    # runs the vectorized superoperator on the streamK kernels where one
    # thread block holds dimension N^2 and the density-matrix kernels
    # (ops/rho.py) past that; 'rho' forces the matrix form, 'superop'
    # forbids it (on 'streamk' past one block the mid pair,
    # csrc/streamk_mid.cu, runs it).
    fused_rho: str = "auto"
    # Fused kernel family (quandary_tpu's pallas_mode): 'streamk' contracts
    # the H planes in-kernel (ops/streamk.py); 'stream' builds them outside
    # and streams them (ops/stream.py; open systems on the superop route
    # only); 'chunk' is the cross-check path (ops/adjoint.py; closed
    # systems with plain Neumann only).
    fused_mode: str = "streamk"
    # the plain route's adjoint (quandary_tpu's): 'auto' | 'remat' (autograd
    # over the stored states) | 'reversible' (states recomputed backward;
    # on the grouped engine the hand-written adjoint) | 'reversible-ad'
    # (the reversible adjoint through the step, the grouped cross-check);
    # closed IMR-family systems without dpdm, as the reference
    adjoint: str = "auto"
    # the time-parallel scan (quandary_tpu's, ops/propagator.py): 'auto'
    # takes it on small dense plain-route problems, True wherever it is
    # feasible, False never (the sequential step loop)
    time_parallel: object = "auto"
    time_parallel_budget: int = 1 << 27        # max ntime * dim^2 entries
    # the engine of a StructuredModel (quandary_tpu's): 'auto' (tensor;
    # grouped for closed N >= 2^15 and open N >= 512 with two or more
    # oscillators) | 'tensor' | 'grouped'; a HamiltonianModel takes the
    # dense engine
    engine: str = "auto"

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
        if s.fused not in (True, False, "auto"):
            raise ValueError(f"fused must be True, False or 'auto', got "
                             f"{s.fused!r}")
        if s.adjoint not in ("auto", "remat", "reversible", "reversible-ad"):
            raise ValueError("adjoint must be 'auto', 'remat', 'reversible' "
                             f"or 'reversible-ad', got {s.adjoint!r}")
        if s.engine not in ("auto", "tensor", "grouped"):
            raise ValueError("engine must be 'auto', 'tensor' or 'grouped', "
                             f"got {s.engine!r}")
        if s.time_parallel not in (True, False, "auto"):
            raise ValueError("time_parallel must be True, False or 'auto', "
                             f"got {s.time_parallel!r}")
        if cuda and s.fused is True and s.dtype != torch.complex64:
            raise NotImplementedError(
                "fused=True: complex128 is not ported to the CUDA kernels, "
                "which run float32 planes (dtype=torch.complex64); "
                "fused='auto' or False runs the plain time loop on the card")
        if cuda and self.device.index is None:
            # with its index ("cuda" -> "cuda:0"), as tensors report it
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.N = model.N
        self.rdtype = (torch.float64 if s.dtype == torch.complex128
                       else torch.float32)
        self.engine = self._make_engine()
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
        x0_np, initids = ic.build_initial_states(
            s.initcond_type, model.dims, s.nessential, osc_ids, self.lindblad,
            pure_levels=s.pure_levels, from_file_state=s.initial_state_ess)
        self.initids = initids
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
        # long before it diverges; the grouped engines switch to the
        # diagonally-split stepper (the stiff diagonal integrated exactly),
        # the others to the Jacobi-preconditioned solve where the
        # generator's diagonal is known (always, here), else to GMRES once
        # the series stops converging ---
        self.linsolver = s.linsolver
        self.gen_diag = self.engine.gen_diag()
        u_stiff = 0.5 * dt * self._diag_scale_estimate()
        u_ok = float(np.exp(np.log(1e-6) / (s.linsolve_iters + 1)))
        if self.linsolver == "neumann" and u_stiff > u_ok:
            if isinstance(self.engine, (GroupedEngine,
                                        GroupedLindbladEngine)):
                self.linsolver = "split"
            elif self.gen_diag is not None:
                self.linsolver = "jacobi"
            elif u_stiff > 0.9:
                warnings.warn(
                    f"Stiff step: dt/2*|H_diag|max = {u_stiff:.2f} > 0.9; "
                    "switching the IMR stage solve to GMRES.")
                self.linsolver = "gmres"
            else:
                warnings.warn(
                    f"Stiff step: dt/2*|H_diag|max = {u_stiff:.2f} leaves "
                    f"~{u_stiff ** (s.linsolve_iters + 1):.1e} relative "
                    "truncation error per Neumann stage solve; consider more "
                    "linsolve_iters.")
        self.step_fn = self._make_step_fn(dt)

        # --- fused or plain: the JAX package's pallas gate
        # (problem.py:440-500), decided at the whole batch; 'auto' admits
        # where that gate does, on CUDA where it asks for a TPU ---
        self._gate = self._fused_gate_refusal(cuda)
        if s.fused is True and self._gate is not None:
            raise NotImplementedError(
                f"fused=True: the fused route does not take this "
                f"problem: {self._gate} (fused='auto' or False runs the "
                "plain time loop)")
        # the 'init' axis (parallel/mesh.py::shard_problem): the mesh, the
        # group of the ranks sharing the batch, and the whole batch's size
        self.mesh = self._init_group = None
        self.ninit_global = self.ninit
        self._place()

    def _place(self):
        """The route at the problem's batch of initial conditions (this
        rank's share of it under the 'init' axis) and the constants on the
        device in the route's state layout: whether the route's kernels
        hold the problem (route_refusal) and their plan's stored-iterate
        rule (store_iters_ok) are decided at that batch, which can change
        the route family."""
        s, model = self.setup, self.model
        cuda = self.device.type == "cuda"
        forced = s.fused != "auto" and bool(s.fused)
        why_not = self._gate
        nprdt = np.float32 if s.dtype == torch.complex64 else np.float64
        iters, K = s.linsolve_iters, model.K
        form = self._fused_form() if why_not is None and (
            forced or (s.fused == "auto" and cuda)) else None
        route_why = None if form is None else route_refusal(
            form, s.fused_mode, self.ninit, self.N, K, iters, s.ntime,
            self.linsolver)
        self.use_fused, self._off = fused_decision(s.fused, cuda, why_not,
                                                   route_why)
        self.fused_form = form if self.use_fused else None
        self._refusal = route_why if self.use_fused else None
        self.time_parallel = self._time_parallel_decision()

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
        self._Sr = self._Si = None
        if isinstance(self.engine, DenseEngine):
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
        # the scan's constants: the open generator builder (its
        # superoperator stacks on the device) and the Jacobi diagonal,
        # flattened as the state is (column-major vec(rho) for open systems)
        self._superop = self._tp_diag = None
        if self.time_parallel:
            eng = self.engine
            if self.lindblad:
                self._superop = lindblad_superop_builder(eng.stack, eng.Ls)
            self._tp_diag = torch.as_tensor(
                self.gen_diag.T.reshape(-1) if self.lindblad
                else self.gen_diag, **dev)
        self.adjoint_route = self._adjoint_route()
        self._reversible = None if self.adjoint_route == "stored" \
            else self._make_reversible()
        # the route's launch plan (stacks, solver rows or planes), built once
        self._plan = None
        gd = self.gen_diag.T.reshape(-1) if self._flat else self.gen_diag
        if self.fused_form == "rho":
            self._plan = rho.make_plan(
                self._Sr, self._Si, self.engine.Ls_np, s.dt, iters,
                self.gen_diag, self.linsolver)
        elif self.use_fused:
            dim = self._Sr.shape[-1]
            store = store_iters_ok(s.ntime, iters, self.ninit, dim)
            self._plan = streamk.make_plan(
                self._Sr, self._Si, s.dt, iters, gd, self.linsolver,
                store_iters=store) if s.fused_mode == "streamk" \
                else stream.make_plan(self._Sr, s.dt, iters, gd,
                                      self.linsolver, kind=s.fused_mode,
                                      store_iters=store)

    def _make_engine(self):
        """The JAX Problem's engine choice (quandary_tpu/problem.py:272-293):
        a HamiltonianModel takes the dense engine; a StructuredModel the
        tensor engine, or the grouped one (closed: engine 'grouped' or, under
        'auto', N >= 2^15; open with two or more oscillators: 'grouped' or,
        under 'auto', N >= 512)."""
        s, model = self.setup, self.model
        if not isinstance(model, StructuredModel):
            return DenseEngine(model, s.dtype, self.device)
        two = len(model.dims) >= 2
        if not model.lindblad and two and (s.engine == "grouped" or (
                s.engine == "auto" and model.N >= 1 << 15)):
            return GroupedEngine(model, s.dtype, self.device)
        if model.lindblad and two and (s.engine == "grouped" or (
                s.engine == "auto" and model.N >= 1 << 9)):
            return GroupedLindbladEngine(model, s.dtype, self.device)
        return TensorEngine(model, s.dtype, self.device)

    def _diag_scale_estimate(self) -> float:
        """max |diag(H_d)| (rad/ns), the host bound of the generator's
        dominant scale that the stiffness guard reads (the JAX Problem's,
        problem.py:636-646)."""
        m = self.model
        if isinstance(m, StructuredModel):
            return float(np.abs(drift_diagonal(
                m.dims, m.detune, m.selfkerr, m.crosskerr)).max())
        return float(np.abs(np.diagonal(self.engine.stack_np[0])).max())

    def _make_step_fn(self, dt):
        """The plain loop's step at `dt` (negative: the inverse step of the
        reversible adjoint). Engines with assemble / apply (dense, grouped)
        assemble each stage's operator once for its solve."""
        s = self.setup
        eng = self.engine if hasattr(self.engine, "assemble") else None
        return make_step_fn(self.engine.rhs, dt, s.timestepper,
                            s.linsolve_iters, self.linsolver,
                            gen_diag=self.gen_diag,
                            vec_ndim=3 if self.lindblad else 2, engine=eng)

    def _time_parallel_decision(self) -> bool:
        """Whether the objective runs the time-parallel scan, as the JAX
        Problem decides (quandary_tpu/problem.py:574-590, with use_fused
        for its use_pallas): feasible on the dense engine with a Neumann
        or Jacobi stage solve (after the stiffness guard) and ntime dim^2
        within time_parallel_budget, dim = N closed and N^2 open; under
        'auto' also profitable, dim <= 64 or dim <= 4 ninit (building the
        propagators costs O(dim^2) a step against the loop's O(dim B)), at
        the whole batch's ninit as the reference decides it before any
        sharding.
        The fused route owns propagation where it is taken."""
        s = self.setup
        dim = self.N * self.N if self.lindblad else self.N
        feasible = (isinstance(self.engine, DenseEngine)
                    and self.linsolver in ("neumann", "jacobi")
                    and s.ntime * dim * dim <= s.time_parallel_budget)
        if s.time_parallel == "auto":
            on = feasible and (dim <= 64 or dim <= 4 * self.ninit_global)
        else:
            on = bool(s.time_parallel) and feasible
        return on and not self.use_fused

    def _adjoint_route(self) -> str:
        """The plain route's adjoint (Setup.adjoint), as the JAX Problem
        picks it (problem.py:1194-1290): the reversible adjoints on closed
        IMR-family systems without dpdm; on the grouped engine with IMR
        the real-plane step, with the hand-written adjoint ('grouped') or
        the reversible one through that step ('grouped-ad' under
        'reversible-ad'); else the generic reversible adjoint. 'stored'
        elsewhere, under 'remat', on the fused route, on the time-parallel
        scan (autograd through its products, as the reference's scan
        precedes its reversible adjoints) and under 'auto' on the dense
        engine (ROADMAP C4 item 12)."""
        s = self.setup
        imr = s.timestepper.upper()
        if (self.use_fused or self.time_parallel or self.lindblad
                or s.adjoint == "remat"
                or imr not in ("IMR", "IMR4", "IMR8")
                or s.gamma_penalty_dpdm > 1e-13
                or (s.adjoint == "auto"
                    and isinstance(self.engine, DenseEngine))):
            return "stored"
        if isinstance(self.engine, GroupedEngine) and imr == "IMR" \
                and self.linsolver in ("neumann", "jacobi", "split"):
            return "grouped-ad" if s.adjoint == "reversible-ad" \
                else "grouped"
        return "reversible"

    def _fused_form(self) -> str:
        """The fused route's form (the JAX package's pallas_form gate,
        problem.py:440-499): closed, the fused_mode's kernels on (B, N)
        vectors. Open: 'superop', the column-major vec(rho) of dimension
        N^2, where one thread block of the streamK kernels holds it (or when
        forced, and always in 'stream' mode); else 'rho', the
        density-matrix kernels on (B, N, N) matrices. 'chunk' takes closed
        plain-Neumann problems only."""
        s = self.setup
        if s.fused_mode == "chunk" and (self.lindblad
                                        or self.linsolver != "neumann"):
            raise NotImplementedError(
                "fused_mode='chunk' runs closed systems with plain "
                "Neumann stage solves only; this problem is "
                + ("open" if self.lindblad else
                   f"closed with linsolver={self.linsolver!r}")
                + " (use fused_mode='stream')")
        if not self.lindblad:
            return s.fused_mode
        if s.fused_mode == "stream":
            if s.fused_rho == "rho":
                raise NotImplementedError(
                    "the density-matrix (rho) route runs on the streamK "
                    "kernels only; fused_mode='stream' takes open "
                    "systems on the superop route")
            return "superop"
        too_big = streamk.size_refusal(
            self.ninit, self.N * self.N,
            self.model.K + (self.linsolver == "split"),
            s.linsolve_iters) is not None
        return "rho" if s.fused_rho == "rho" or (
            s.fused_rho == "auto" and too_big) else "superop"

    def _fused_gate_refusal(self, cuda: bool) -> Optional[str]:
        """Why the fused route does not take this problem, or None. Forced
        (fused=True): the stepper, the stage solve and, on CUDA, the dtype.
        'auto': quandary_tpu's pallas gate (problem.py:440-500) in full:
        also complex64 anywhere and the kernel family's size budget (the
        JAX package's VMEM / HBM admission), so that 'auto' sends the same
        problems to the fused route as that gate."""
        s = self.setup
        auto = s.fused == "auto"
        if not isinstance(self.engine, DenseEngine):
            return (f"the {type(self.engine).__name__} of a StructuredModel "
                    "(the kernels take the dense operator stack)")
        if s.timestepper.upper() != "IMR":
            return f"timestepper {s.timestepper!r} (the kernels run IMR)"
        family = ("neumann",) if auto and s.fused_mode == "chunk" \
            else ("neumann", "jacobi", "split")
        if self.linsolver not in family:
            return (f"linsolver {self.linsolver!r} (fused_mode="
                    f"{s.fused_mode!r} takes {', '.join(family)})")
        if s.dtype != torch.complex64 and (cuda or auto):
            return ("complex128 (the kernels run float32 planes, "
                    "dtype=torch.complex64)")
        if auto and not _jax_size_gate(self, s):
            return "past the JAX package's size budget of the kernel family"
        return None

    @property
    def fused_ok(self) -> bool:
        """Whether the kernels of the problem's fused route (`fused_form`)
        admit it: the fused path is on and the route's kernels hold a
        candidate (closed streamK: one thread block or a cluster per chunk
        of basis states, a sweep's history and stored iterates at E = 1
        under streamk.DEVICE_BUDGET_BYTES, and superop on 'streamk' the same
        at dim N^2; stream and chunk, closed or superop: one thread block or
        a cluster per chunk of states, the sweep's plane arrays at E = 1 under
        stream.PLANE_BUDGET_BYTES (stream past one block: on the JAX gate's
        P = roundup(dim, 128)), chunk at dim <= 1024; rho: N <= 128, an
        (N, N) density matrix on a thread-block cluster).
        `fused_refusal` names the limit otherwise. On the CPU it tells what
        the card would do; the plain version there runs any size."""
        return self.use_fused and self._refusal is None

    @property
    def fused_refusal(self) -> Optional[str]:
        if not self.use_fused:
            return self._off
        return self._refusal

    def ensemble_refusal(self, E: int) -> Optional[str]:
        """Why the route's kernels do not take E candidates in one launch
        (the device driver's line search evaluates its trial steps at
        once), or None. fused_refusal gates at E = 1; the plane arrays of
        'stream' / 'chunk' and the history of the 'streamk' route (closed
        and superop) grow with E."""
        if not self.fused_ok:
            return self.fused_refusal
        s, dim = self.setup, self._Sr.shape[-1]
        if self.fused_form == "rho":
            return None
        if s.fused_mode == "streamk":
            return streamk.route_refusal(
                self.ninit, dim, self._plan.Ke, self._plan.iters, s.ntime,
                E, store=self._plan.store_iters)
        return stream.launch_refusal(self._plan, self.ninit, dim, s.ntime, E)

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
        ov_re, ov_im = self._overlaps_real(xTr, xTi)
        # every sum over the batch, all-reduced over the 'init' axis before
        # the nonlinear tail
        pens = [torch.sum(w * p, -1) for p in (pen_leak, pen_jt, pen_dpdm)
                if p is not None]
        J_re, J_im, ov_re, ov_im, *pens = self._batch_sums(
            [torch.sum(w * J_re_b, dim=-1), torch.sum(w * J_im_b, dim=-1),
             torch.sum(ov_re, dim=-1), torch.sum(ov_im, dim=-1)] + pens)
        obj_cost = self._finalize_J(J_re, J_im)
        fid_re = ov_re / self.ninit_global
        fid_im = ov_im / self.ninit_global
        fidelity = fid_re if self.lindblad else fid_re ** 2 + fid_im ** 2

        dx = params - params_ref if s.gamma_tik_interpolate else params
        obj_regul = 0.5 * s.gamma_tik * torch.sum(dx * dx, dim=-1)
        zero = torch.zeros_like(obj_cost)
        obj_penal = zero
        if pen_leak is not None:
            obj_penal = obj_penal + s.gamma_penalty * pens.pop(0)
        if pen_jt is not None:
            obj_penal = obj_penal + s.gamma_penalty * pens.pop(0)
        obj_penal_dpdm = zero if pen_dpdm is None else (
            s.gamma_penalty_dpdm * pens.pop(0) / s.ntime)
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
    # the 'init' axis (parallel/mesh.py)
    # ------------------------------------------------------------------

    def _shard_init(self, rows: slice, mesh, group):
        """Keep this rank's `rows` of the batch of initial conditions and
        rebuild the route at that batch (parallel/mesh.py::shard_problem).
        The weights were normalized over the whole batch."""
        self.x0 = self.x0[rows]
        if self.target is not None:
            self.target = self.target[rows]
        self.weights = self.weights[rows]
        self.purity = self.purity[rows]
        self.initids = list(self.initids)[rows]
        self.ninit = self.x0.shape[0]
        self.mesh, self._init_group = mesh, group
        self._place()

    def _shared_input(self, C):
        """The coefficient rows, the replicated input of every rank's
        share of the batch: under the 'init' axis their gradient sums over
        the ranks (mesh.copy_to), the conjugate of _batch_sums; else C
        itself."""
        if self._init_group is None:
            return C
        return mesh_ops.copy_to(C, self._init_group)

    def _batch_sums(self, sums):
        """The objective's sums over the batch (each (...,)): under the
        'init' axis each the sum over the ranks' shares, in one all-reduce
        (mesh.reduce_from); else `sums` themselves."""
        if self._init_group is None:
            return sums
        return list(mesh_ops.reduce_from(torch.stack(sums, dim=-1),
                                         self._init_group).unbind(-1))

    def _candidate_axis(self, mesh, axis):
        """The candidate axis' MeshAxis of `mesh` (None without one)."""
        if mesh is None:
            return None
        if self.mesh is not None:
            raise NotImplementedError(
                "a problem sharded over the 'init' axis takes no mesh on "
                "the ensemble entry points: the candidates and the initial "
                "conditions cannot share the axis (ROADMAP C4 item 15)")
        return mesh_ops.MeshAxis(mesh, axis, self.device)

    # ------------------------------------------------------------------
    # objective
    # ------------------------------------------------------------------

    def _host_or_device(self, dev_plan, host_plan, params):
        """The device plan for parameters in the problem's dtype on its
        device; else the f64 host plan, cast to the parameters' dtype."""
        same = params.dtype == self.rdtype and params.device == self.device
        return dev_plan if same else host_plan

    def coeff_rows_mid(self, params):
        """(..., ntime, nstages, K) coefficient rows at the stage midpoints.
        Under the 'init' axis their gradient sums over the ranks
        (_shared_input), so that every objective built on them and on
        _assemble_objective_real has both halves of the pair."""
        plan = self._host_or_device(self._plan_mid, self.plan_mid, params)
        p, q = eval_controls(plan, params, self.setup.pipulses)
        C = self.model.coeff_rows(
            p, q, self.plan_mid.ts,
            jc=self._jc_mid if plan is self._plan_mid else None)
        return self._shared_input(C.reshape(
            params.shape[:-1] + (self.setup.ntime, self.nstages,
                                 self.model.K)))

    def _objective_batch(self, Ps, params_ref):
        """Objective of the (E, nparams) candidates Ps: (J (E,), aux)."""
        C = self.coeff_rows_mid(Ps)
        energy_int = self._energy_integral(Ps)
        if self.time_parallel:
            hist = self._states_time_parallel(C)
            hr, hi = hist.real, hist.imag
            xTr, xTi = hr[:, -1], hi[:, -1]
        elif self.fused_form == "rho":
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
        elif self._reversible is not None:
            xTr, xTi, pen_leak, pen_jt = self._reversible(C)
            return self._assemble_objective_real(
                Ps, params_ref, xTr, xTi, pen_leak, pen_jt, None, energy_int)
        else:
            x0 = self._x0c.expand((Ps.shape[0],) + self._x0c.shape)
            remat = not isinstance(self.engine, DenseEngine) \
                and torch.is_grad_enabled()
            traj = (solvers.propagate_trajectory_remat if remat else
                    solvers.propagate_trajectory)(self.step_fn, x0,
                                                  C.movedim(-3, 0))
            hist = traj[1:].movedim(0, 1)
            hr, hi = hist.real, hist.imag
            xTr, xTi = hr[:, -1], hi[:, -1]
        pens = self._history_penalties_real(hr, hi)
        return self._assemble_objective_real(Ps, params_ref, xTr, xTi,
                                             *pens, energy_int)

    def _states_time_parallel(self, C):
        """The states after steps 1..ntime, (..., ntime, B, N) closed or
        (..., ntime, B, N, N) open, from the coefficient rows C (..., ntime,
        nstages, K) by the time-parallel scan (ops/propagator.py); open
        systems propagate the column-major vec(rho)."""
        s = self.setup
        S = build_step_matrices_dense(
            self.engine.stack, C, s.dt, s.timestepper, s.linsolve_iters,
            lindblad_superop=self._superop, gen_diag=self._tp_diag,
            linsolver=self.linsolver)
        P = prefix_propagators(S)
        if not self.lindblad:
            return propagate_states(P, self._x0c)
        N = self.N
        sv = propagate_states(P, self._x0c.transpose(-1, -2).reshape(
            self.ninit, N * N))
        return sv.reshape(sv.shape[:-1] + (N, N)).transpose(-1, -2)

    def _make_reversible(self):
        """The propagation of `adjoint_route` ('reversible', 'grouped',
        'grouped-ad'), built once: a function of the candidates'
        coefficient rows C (E, ntime, nstages, K) returning the final-state
        planes (E, B, N) and the leakage and weighted-J penalties (E, B)
        summed at the post-step states (each None when off). Candidates
        ride the leading axis of the state."""
        s = self.setup
        use_leak = self.has_guard and s.gamma_penalty > 1e-13
        use_jt = self._jt_weight is not None and s.gamma_penalty > 1e-13
        extras = (self._jt_weight,) if use_jt else ()

        def pens(xr, xi, extra):
            out = []
            if use_leak:
                out.append(torch.sum((xr * xr + xi * xi) * self._gmask, -1)
                           / s.ntime)
            if use_jt:
                out.append(extra[0] * self._finalize_J(
                    *self._eval_J_parts_real(xr, xi)) * s.dt)
            return tuple(out)

        on = use_leak or use_jt
        if self.adjoint_route == "reversible":
            step_bwd = self._make_step_fn(-s.dt)
            # the inverse of a composed step runs the stages in reverse
            # order at -dt: flip the per-stage rows
            prop = make_reversible_propagate(
                self.step_fn, lambda x, c: step_bwd(x, c.flip(-2)),
                (lambda x, extra: pens(x.real.to(self.rdtype),
                                       x.imag.to(self.rdtype), extra))
                if on else None)

            def states(C):
                x0 = self._x0c.expand((C.shape[0],) + self._x0c.shape)
                out = prop(x0, C.movedim(-3, 0), extras)
                return (out[0].real.to(self.rdtype),
                        out[0].imag.to(self.rdtype)) + tuple(out[1:])
        else:
            eng, split = self.engine, self.linsolver == "split"
            plane_pen = (lambda x, extra: pens(
                x[0].flatten(-2), x[1].flatten(-2), extra)) if on else None
            if self.adjoint_route == "grouped":
                prop = make_grouped_adjoint_propagate(
                    eng, s.dt, s.linsolve_iters, plane_pen, split=split)
            else:
                mk = make_real_split_step if split else make_real_imr_step
                fwd = mk(eng, s.dt, s.linsolve_iters)
                bwd = mk(eng, -s.dt, s.linsolve_iters)
                prop = make_reversible_propagate(
                    lambda x, c: fwd(x[0], x[1], c),
                    lambda x, c: bwd(x[0], x[1], c), plane_pen)

            def states(C):
                shape = (C.shape[0], self.ninit, eng.m1, eng.m2)
                out = prop((self._x0r.reshape(shape[1:]).expand(shape),
                            self._x0i.reshape(shape[1:]).expand(shape)),
                           C[..., 0, :].movedim(-2, 0), extras)
                return (out[0].flatten(-2), out[1].flatten(-2)) \
                    + tuple(out[2:])

        def run(C):
            xTr, xTi, *rest = states(C)
            pen_leak = rest.pop(0) if use_leak else None
            pen_jt = rest.pop(0) if use_jt else None
            return xTr, xTi, pen_leak, pen_jt

        return run

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

    def _ensemble_fn(self, grad: bool, mesh=None, axis="init"):
        """fn(Ps (E, nparams), params_ref) -> (J (E,), aux (E,), gradient
        (E, nparams) or None without `grad`): E control candidates through
        one kernel launch per direction. Each J_e depends on Ps[e] only, so
        the gradient of sum(J) is the stack of per-candidate gradients.

        With `mesh`, the candidates shard over the mesh's `axis`, as the
        reference's _ensemble_shard (quandary_tpu/problem.py:1639-1667):
        each rank runs this program unchanged, kernels included, on its
        E / n rows, and every rank gets the whole results back
        (mesh.gather_rows); E must divide by n. Ranks along the other axis
        compute replicas."""
        ax = self._candidate_axis(mesh, axis)

        def local(P, ref):
            if not grad:
                with torch.no_grad():
                    J, aux = self._objective_batch(P, ref)
                return J, aux, None
            P = P.detach().requires_grad_(True)
            J, aux = self._objective_batch(P, ref)
            (g,) = torch.autograd.grad(J.sum(), P)
            return (*self._detached(J, aux), g)

        def fn(Ps, params_ref):
            Ps, ref = self._param_tensor(Ps), self._param_tensor(params_ref)
            if ax is None:
                return local(Ps, ref)
            E = Ps.shape[0]
            rows = ax.rows(E, "ensemble size E")
            J, aux, g = local(Ps[rows], ref)
            keys = list(aux)
            out = mesh_ops.gather_rows(
                [J] + [aux[k] for k in keys] + ([g] if grad else []),
                rows, E, ax.group)
            return (out[0], dict(zip(keys, out[1:1 + len(keys)])),
                    out[-1] if grad else None)
        return fn

    def build_ensemble_value_and_grad(self, mesh=None, axis="init"):
        """fn(Ps, params_ref) -> ((J (E,), aux (E,)), grad (E, nparams)):
        E control candidates through one kernel launch per direction; with
        `mesh`, sharded over its `axis` (_ensemble_fn)."""
        fn = self._ensemble_fn(True, mesh, axis)

        def evg(Ps, params_ref):
            J, aux, g = fn(Ps, params_ref)
            return (J, aux), g
        return evg

    def _ensemble_objective(self, mesh=None, axis="init"):
        """fn(Ps, params_ref) -> (J (E,), aux (E,)): the objective-only
        companion of the ensemble value_and_grad, one forward launch and no
        backward (batched line searches, population evaluation)."""
        fn = self._ensemble_fn(False, mesh, axis)
        return lambda Ps, params_ref: fn(Ps, params_ref)[:2]

    def packed_batch_fns(self, params_ref, mesh=None, axis="init"):
        """The batch hooks of optim.batched_lbfgs.batched_lbfgsb: a
        population's objective and gradient evaluations as ensemble
        launches. Returns dict(objective_batch, grad_batch, vg_batch), to
        be splatted into batched_lbfgsb(**kw); they take and return
        tensors on the problem's device. With `mesh`, every evaluation
        shards the population over the mesh's `axis` (_ensemble_fn), and
        batched_lbfgsb runs replicated on every rank over the whole
        results."""
        ref = self._param_tensor(params_ref)
        eobj = self._ensemble_objective(mesh, axis)
        evg = self.build_ensemble_value_and_grad(mesh, axis)

        def vg_batch(xs):
            (J, _), g = evg(xs, ref)
            return J, g

        return dict(objective_batch=lambda xs: eobj(xs, ref)[0],
                    grad_batch=lambda xs: vg_batch(xs)[1],
                    vg_batch=vg_batch)

    def build_ensemble_sweeps(self, mesh=None, axis="init"):
        """f(Ps (reps, E, nparams), params_ref) -> scalar tensor: reps
        ensemble gradient sweeps enqueued back to back, summed into one
        scalar (J and the gradients), with one synchronization at the end.
        The throughput probe: nothing is fetched between the sweeps. With
        `mesh`, each rank sweeps its E / n rows of every Ps and the scalar
        is summed over the mesh's `axis` by one all-reduce at the end."""
        ax = self._candidate_axis(mesh, axis)
        evg = self.build_ensemble_value_and_grad()

        def reps(Ps, params_ref):
            Ps = self._param_tensor(Ps)
            ref = self._param_tensor(params_ref)
            if ax is not None:
                Ps = Ps[:, ax.rows(Ps.shape[1], "ensemble size E")]
            acc = torch.zeros((), dtype=self.rdtype, device=self.device)
            for P in Ps:
                (J, _), g = evg(P, ref)
                acc = acc + J.sum() + g.sum()
            if ax is not None:
                acc = mesh_ops.reduce_from(acc, ax.group)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return acc
        return reps

    # ------------------------------------------------------------------
    # forward propagation and per-state functionals of complex states
    # ------------------------------------------------------------------

    def eval_J_per_state(self, x):
        """Per-state finalized J of complex states x (..., B, N) or
        (..., B, N, N): the weighted-J penalty integrand
        (timestepper.cpp:256-270, finalizeJ per state)."""
        if self._flat:      # the route's planes hold column-major vec(rho)
            x = x.transpose(-1, -2).reshape(x.shape[:-2] + (-1,))
        re, im = self._eval_J_parts_real(x.real.to(self.rdtype),
                                         x.imag.to(self.rdtype))
        return self._finalize_J(re, im)

    def propagate_final(self, params):
        """Forward-only propagation: final states (B, ...), by the
        time-parallel scan where the problem takes it, else by the plain
        step loop."""
        C = self.coeff_rows_mid(params)
        if self.time_parallel:
            return self._states_time_parallel(C)[-1]
        return solvers.propagate(self.step_fn, self._x0c, C)

    def propagate_trajectory(self, params):
        """All states (ntime+1, B, ...) for the trajectory output: from the
        time-parallel scan's prefix products where the problem takes it,
        else by the plain step loop (as the JAX package, also where the
        objective runs fused)."""
        C = self.coeff_rows_mid(params)
        if self.time_parallel:
            states = self._states_time_parallel(C)
            return torch.cat([self._x0c[None], states], dim=0)
        return solvers.propagate_trajectory(self.step_fn, self._x0c, C)

    def build_propagate_trajectory(self):
        """fn(params) -> (ntime+1, B, ...) states, no autograd."""
        def traj(params):
            with torch.no_grad():
                return self.propagate_trajectory(self._param_tensor(params))
        return traj

    def build_propagate_final(self):
        """fn(params) -> (B, ...) final states, no autograd."""
        def final(params):
            with torch.no_grad():
                return self.propagate_final(self._param_tensor(params))
        return final

    def controls_on_output_grid(self, params):
        """(ts, p, q, f_lab) on the output time grid t_n = n*dt."""
        params = self._param_tensor(params)
        p, q = eval_controls(self.plan_out, params, self.setup.pipulses)
        f = eval_controls_labframe(self.plan_out, params,
                                   self.setup.ground_freqs_radns,
                                   self.setup.pipulses)
        return self.ts_out, p, q, f


def store_iters_ok(ntime, iters, ninit, dim) -> bool:
    """Whether the streamK and 'stream' forwards store their stage iterates
    for the backward, which otherwise replays them: iters <= 4 (the
    kernel's rule) and the JAX Problem's gate on bytes
    (quandary_tpu/problem.py:1333-1343, _store_iters_ok): 2 x ntime x
    iters x Bp x P f32 at most 1.5 GiB, with Bp = roundup(ninit, 8) (at
    least 8) and P = roundup(dim, 128)."""
    Bp = max(8, -(-ninit // 8) * 8)
    P = -(-dim // 128) * 128
    return iters <= 4 and 2 * ntime * iters * Bp * P * 4 <= 1.5 * (1 << 30)


def route_refusal(form, fused_mode, ninit, N, K, iters, ntime,
                  linsolver) -> Optional[str]:
    """Why the kernels of a fused route do not hold a problem at E = 1 (a
    sentence naming the limit), or None; a function of the problem's sizes
    and the port's budgets (streamk.DEVICE_BUDGET_BYTES,
    stream.PLANE_BUDGET_BYTES), so that a route is chosen before any plan
    or state layout is built. form: 'rho' (an (N, N) density matrix,
    rho.launch_refusal), 'superop' (dimension N^2) or the fused_mode's
    closed form (dimension N), on the fused_mode's kernel pairs with the
    plan's stored-iterate rule (store_iters_ok) and, on 'streamk', its
    Ke = K + 1 under split."""
    if form == "rho":
        return rho.launch_refusal(N, K)
    dim = N * N if form == "superop" else N
    store = store_iters_ok(ntime, iters, ninit, dim)
    if fused_mode == "streamk":
        return streamk.route_refusal(ninit, dim, K + (linsolver == "split"),
                                     iters, ntime, store=store)
    return stream.route_refusal(ninit, dim, iters, ntime, 1,
                                fused_mode == "stream" and store, fused_mode)


def fused_decision(fused, cuda: bool, gate_refusal: Optional[str],
                   route_why: Optional[str]) -> Tuple[bool, str]:
    """(whether the fused route runs, why the plain loop runs otherwise) of
    a problem the JAX gate refuses with `gate_refusal` (None: admits) and
    the route's kernels with `route_why` (route_refusal; None: they hold
    it). fused='auto' takes the fused route on a CUDA device where both
    admit it and the plain loop on the same device everywhere else, as the
    reference falls back to its scan where its gate refuses
    (quandary_tpu/problem.py:440-499): a routing decision made before any
    launch, not a failure caught. fused=True raises NotImplementedError on
    CUDA where the kernels refuse (the gate's refusal raises before);
    on the CPU it runs the kernels' plain versions at any size."""
    if fused == "auto":
        why = gate_refusal or (route_why if cuda else None)
        if why is not None:
            return False, f"fused='auto': {why}"
        if not cuda:
            return False, ("fused='auto' takes the fused route on a CUDA "
                           "device only; the plain loop runs here")
        return True, ""
    if fused:
        if cuda and route_why is not None:
            raise NotImplementedError(route_why)
        return True, ""
    return False, "the fused path is off (Setup.fused=False)"


def _jax_size_gate(problem, s) -> bool:
    """The size half of quandary_tpu's pallas gate (problem.py:456-499):
    the streamK family's two (Ke, P, P) f32 stacks within 80 MiB, stream's
    six (ntime, P, P) plane arrays within 8 GiB, chunk's dimension at most
    1024, with P = roundup(dim, 128) and dim = N (closed) or N^2 (open); an
    open system past the superop budget takes the density-matrix form if
    its (P_rho = roundup(N, 128)) stacks and history fit."""
    budget, hbm = 80 << 20, 8 << 30
    N, lind = problem.N, problem.lindblad
    dim = N * N if lind else N
    P = -(-dim // 128) * 128
    Ke = problem.model.K + (problem.linsolver == "split")
    mode = s.fused_mode
    if mode == "streamk":
        size_ok = 2 * Ke * P * P * 4 <= budget
    elif mode == "stream":
        size_ok = 6 * s.ntime * P * P * 4 <= hbm
    else:
        size_ok = dim <= 1024
    if not lind:
        return size_ok
    if mode not in ("stream", "streamk"):
        return False
    rho_ok = False
    if mode == "streamk" and (s.fused_rho == "rho" or (
            s.fused_rho == "auto" and not size_ok)):
        Pr = -(-N // 128) * 128
        Hr = max(8, -(-N // 8) * 8)
        njump = 0 if problem.engine.Ls_np is None else len(problem.engine.Ls_np)
        rho_vmem = 4 * (4 * problem.model.K + 4 * njump + 8) * Pr * Pr * 4
        rho_hist = 2 * problem.ninit * s.ntime * Hr * Pr * 4
        rho_ok = rho_vmem <= budget and 3 * rho_hist <= hbm
    return size_ok or rho_ok
