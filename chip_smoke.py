"""End-to-end check of quandary_tpu_torch on one CUDA GPU.

Drives the port's main paths at the full width of the CNOT flagship
(bench.py:59-93: 2 transmons with 2 essential + 2 guard levels, N = 16,
4 basis states, ntime = 1221, split stepper with 3 iterations, Jtrace with
leakage, energy, dpdm and Tikhonov terms, complex64), through the entry
points a user calls: Problem(...).build_value_and_grad(),
optim.driver.run_optimization, optim.robust.build_packed_robust_objective,
optim.device_driver.run_optimization_device,
optim.batched_lbfgs.batched_lbfgsb, ops.stream.make_stream_propagate,
ops.dense.pallas_propagate_dense and calibration.KerrCalibration. Phases:

1. the device: CUDA must be available; prints the card's name and power
   limit as nvidia-smi gives them;
2. builds the kernels from the checkout, one nvcc per source and all three
   at once: csrc/streamk.cu here, csrc/rho.cu reported in phase 11,
   csrc/stream.cu in phase 17;
3. each kernel against its plain torch version on the card, at the
   flagship shapes (K = 7, N = 16, B = 4, ntime = 1221), for E = 1 and
   E = 128 candidates: split with 3 iterations (stored stage iterates), the
   bench default neumann-8 request (which the stiffness guard turns into
   jacobi with 8 iterations, replayed), and neumann with 8 iterations
   (replayed) at dt/4, where plain Neumann is accurate;
4. the flagship value_and_grad on the card: both kernels launched, J and
   the gradient against the plain version on the card and the f64 port on
   the CPU;
5. five L-BFGS-B iterations on the card from the bench's parameter seed:
   J must fall;
6. sweeps/s of the kernel path (median of 5 runs after a warm-up) and the
   plain path (2 runs) at E = 1 and E = 128, and each kernel's time;
7. the packed kernels (one operator stack and one set of solver rows per
   candidate) against the plain version on the card: S = 8 detuned
   realizations of the flagship (scripts/perf/robust_packed_bench.py:30-57:
   freq01 + uniform(-0.002, 0.002) GHz per qubit from default_rng(5)),
   split-3 and jacobi-8, against plain in f32 and in f64 (the detuned
   systems' own bounds, stated at the constants); times at S = 8 and 128;
8. build_packed_robust_objective value and gradient on the card: exactly
   one launch of each packed kernel, J and gradient against
   build_robust_objective (S launches of the plain-stack kernels) on the
   card and against the f64 port on the CPU, bounds of phase 4 but for the
   detuned systems' f64 gradient bound;
9. run_optimization_device on the flagship from the bench seed, 60
   iterations in chunks of 10 replayed as a CUDA graph: J must fall and end
   at or below 1.1 x the host driver's J after the same 60 iterations,
   inside the bounds; wall of the first (capturing) and a second run, and
   of the eager chunk;
10. batched_lbfgsb through Problem.packed_batch_fns, 128 starts x 60
   iterations in the box and from the seed of bench.py:303-309.

Open (Lindblad) systems, three configurations at full width:
(1) the unguarded open CNOT of scripts/perf/lindblad_pallas_bench.py:29-63
(N = 4, 16 basis density matrices, ntime = 1221, 8 iterations, T1/T2
collapse), which the route gate sends down the superoperator route on the
streamK kernels; (2) the guarded one (N = 16), which it sends to the
density-matrix kernels, also with E = 8 control candidates; (3) the
mid-size systems of scripts/perf/rho_bench.py:25-65 (3 qutrits, N = 27, six
collapse operators, and two 8-level qudits, N = 64, four collapse
operators; 3 initial conditions, ntime = 1000, 6 iterations).

11. the build of csrc/rho.cu (registers and spills as ptxas reports them,
   for the three instances of rho_fwd and of rho_bwd, tiles 1, 2 and 4);
12. rho_fwd / rho_bwd against rho_propagate_plain on the card at the stacks
   of configurations 2 and 3 and a short ntime: neumann, jacobi, split;
   with and without jump operators; E = 1 and 8; stored and replayed stage
   iterates; also both against the plain version in f64 on the card;
13. configuration 1 value_and_grad on the superop route against plain on
   the card and the f64 port on the CPU, and the same problem forced down
   the rho route: the two routes agree;
14. configurations 2 (E = 1 and E = 8) and 3 (N = 27, N = 64) at full
   depth on the rho route: one launch of each kernel per sweep for any E;
   J, fidelity and gradient against plain on the card at a short ntime and
   against the f64 port on the CPU at 400 steps (the depth is cut for the
   host's time: phase 16 holds the kernels against plain at full depth);
15. a few L-BFGS-B iterations on configuration 2 through
   run_optimization_device (J falls; the CUDA graph's launches counted);
16. times: rho_fwd / rho_bwd at N = 16 (E = 1, 8), 27, 64, with each
   kernel's cluster (CTAs per density matrix, CTAs launched, tile, threads)
   and time per step, sweeps/s of the
   three configurations, the plain version's times, the bounds; the history
   and cotangents of the timed kernels against those of the timed plain
   runs, at the configurations' full depth.

The streamed-plane kernels (csrc/stream.cu: H planes built outside the
kernel, plane cotangents out, so the operator stacks are differentiable):
17. the build; stream_fwd / stream_bwd against plain on the card at the
   flagship shapes, E = 1 and 128, split-3 (stored stage iterates) and
   jacobi-8 (replayed), states and the x0, coefficient and stack
   cotangents; chunk_fwd / chunk_bwd and dense_fwd the same at dt/4
   (ntime 4884, neumann-8, which the stiffness guard keeps), E = 1;
18. Problem(fused_mode='stream') value_and_grad at E = 1 and 128: one launch
   of each stream kernel per sweep and no streamK launch; J and gradient
   against the streamK route on the card and phase 4's f64 reference; open
   configuration 1 on 'stream' against phase 13;
19. fused_mode='chunk' at ntime 4884 against plain on the card and a new f64
   reference; pallas_propagate_dense's xT against the chunk forward's and
   plain;
20. the calibration on the card: the Kerr recovery of
   examples/example_calibration.py (n = 4, ntime 200, 6 iterations) to rel
   err < 1e-4, and make_stream_propagate's stack cotangents at the
   flagship's width against plain;
21. times: the five kernels by CUDA events, their plain versions and
   bounds; sweeps/s of the stream and chunk routes; for each of the five
   (stream at the flagship, E = 1 and 128; chunk and dense at ntime 4884)
   the helper threads, stage syncs per step and their kind, block-wide
   barriers and us per (reversed) step, and the registers and spills of
   every instance of stream_fwd and stream_bwd as ptxas reports them;
   fails if any of their chains passes a block-wide barrier (no helper
   warps).

Each main path (4-5, 8, 9, 10, 13, 14, 15, 18, 19, 20) is driven with the
launch counters set to 0 just before and read just after. Before the device
record one line lists the eleven kernels with their launches, error, time,
plain time and bound.
Any failure raises (non-zero exit). The last line is the device record:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Run from the repository root:  python3 chip_smoke.py
"""

import contextlib
import dataclasses
import json
import re
import statistics
import subprocess
import time

import numpy as np
import torch

from quandary_tpu_torch.models import gates
from quandary_tpu_torch.models.hamiltonian import build_standard_model
from quandary_tpu_torch import calibration
from quandary_tpu_torch.ops import cuda_build, dense, rho, stream, streamk
from quandary_tpu_torch.optim import robust
from quandary_tpu_torch.optim.batched_lbfgs import batched_lbfgsb
from quandary_tpu_torch.optim.device_driver import run_optimization_device
from quandary_tpu_torch.optim.driver import build_bounds, run_optimization
from quandary_tpu_torch.problem import Problem, Setup
from quandary_tpu_torch.utils.splines import ControlSegment, OscillatorControl

FREQ01 = [4.80595, 4.8601]
SELFKERR = [0.2198, 0.2252]
E_BIG = 128
S_ROBUST = 8

# published peaks of one H100 SXM (NVIDIA's data sheet), for the bounds
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
# The yardstick of the dependent chain (an estimate, not a measurement): a
# barrier-separated stage is one matvec, per thread two chains of 2 N
# dependent FMAs, plus one shared-memory round trip and one block barrier.
# Assumed latencies in SM cycles: 4 per dependent FMA, 30 per shared-memory
# load, 20 per barrier of a 256-thread block.
FMA_CYCLES, SMEM_CYCLES, BARRIER_CYCLES = 4, 30, 20

# Bounds set from the errors measured on an H100 80GB HBM3 (700 W), about
# 5-10x above them (PERF.md): both sides are exact f32 and differ only in
# summation order. Kernel against plain on the card, phase 3:
TOL_STATE_ABS = 1e-5       # xT, hist: abs (states are O(1)); measured 1.5e-6
TOL_GRAD_REL = 2e-5        # C-bar, x0-bar: x max|plain|; measured 2.4e-6
# flagship value_and_grad, phase 4: kernel path against plain on the card
# (measured J 0, gradient 7.2e-7) and against the f64 port on the CPU
# (measured J 2.0e-7, gradient 7.3e-6); relative, gradient x max
TOL_J_PLAIN, TOL_G_PLAIN = 1e-6, 1e-5
TOL_J_F64, TOL_G_F64 = 2e-6, 5e-5
# Phase 7, the detuned realizations. Their states rotate at the detuning in
# the frame of the nominal qubits, and f32 rounding then grows about 15x
# faster than on the nominal system, in the plain version more than in the
# kernel: measured on an H100 80GB HBM3 (700 W) against the plain version in
# f64 on the card, the plain f32 states are 2.0e-5 off and the kernel's
# 6.8e-6, already with one detuned system on the shared-stack kernels. So
# kernel against plain f32 gets 5x the measured 2.1e-5 (states) and 2.1e-5 x
# max (cotangents), and the kernel must stay as close to f64 as plain does.
TOL_DETUNED_STATE_ABS = 1e-4
TOL_DETUNED_GRAD_REL = 1e-4
TOL_DETUNED_F64_ABS = 2e-5
# phase 8, the robust gradient of the detuned ensemble against the f64 port
# on the CPU: measured 5.2e-5 x max (against 7.3e-6 on the nominal system),
# while the packed kernels and the 8 shared-stack launches agree to 1.1e-7
TOL_DETUNED_G_F64 = 2.5e-4
# Phase 9, the device optimizer's J after 60 iterations against the host
# driver's from the same start: both run L-BFGS-B on the same kernels with
# different line searches, at amplitudes where the split stage solve is
# under-resolved (the driver warns), so their last J moves with the kernels'
# f32 rounding. Measured on an H100 80GB HBM3 (700 W): 1.028 x with one
# build of streamk.cu, 1.052 x with one that contracts its FMAs otherwise.
TOL_DEVICE_OPT = 1.1
# Open systems (phases 12-14), measured on an H100 80GB HBM3 (700 W); the
# bounds are about 5x the errors. rho kernels against the plain version on
# the card at NT_SHORT steps, over the three solvers, with and without jump
# operators, stored and replayed iterates, N = 16, 27, 64: states 1.5e-7
# abs, cotangents 1.6e-5 x max (neumann at N = 64, where C-bar itself is
# 5e-7; 7.5e-6 otherwise), and both 5.0e-7 from the plain version in f64
TOL_RHO_STATE_ABS = 1e-6
TOL_RHO_GRAD_REL = 1e-4
TOL_RHO_F64_ABS = 2.5e-6
# the same at the configurations' full depth (1221 and 1000 steps, jacobi,
# E = 1), against the plain runs that phase 16 times: states 1.8e-7 abs,
# cotangents 6.9e-6 x max (x0-bar at N = 64; 1.3e-6 otherwise)
TOL_RHO_FULL_STATE_ABS = 1e-6
TOL_RHO_FULL_GRAD_REL = 3.5e-5
# value_and_grad of the three configurations, relative (gradient x max):
# (J, g) against plain on the card (configuration 1 at full depth, the rho
# route at NT_SHORT steps) and against the f64 port on the CPU
# (configuration 1 at full depth, the rho route at NT_F64 steps; the bounds
# were set from errors measured at full depth). Measured: cnot4 plain 8.1e-8
# / 1.7e-7, f64 8.4e-8 / 1.4e-6;
# cnot16 plain 1.0e-7 / 8.6e-7, f64 5.6e-8 / 9.6e-7; qutrits27 plain 0 /
# 6.6e-7, f64 9.3e-7 / 2.9e-7; qudits64 plain 0 / 1.6e-6, f64 3.3e-8 /
# 5.7e-7. The open systems' f32 drift is that of the nominal closed
# flagship (phase 4), not the detuned systems' (phase 7).
TOL_OPEN = {
    "cnot4": dict(J_plain=1e-6, g_plain=1e-6, J_f64=1e-6, g_f64=1e-5),
    "cnot16": dict(J_plain=1e-6, g_plain=5e-6, J_f64=1e-6, g_f64=5e-6),
    "qutrits27": dict(J_plain=1e-6, g_plain=5e-6, J_f64=5e-6, g_f64=2e-6),
    "qudits64": dict(J_plain=1e-6, g_plain=1e-5, J_f64=1e-6, g_f64=5e-6),
}
# superop against rho route on configuration 1: measured J 0, gradient 1.7e-7
TOL_ROUTES_J, TOL_ROUTES_G = 1e-6, 1e-6
# The streamed-plane kernels (phases 17-20) run streamK's step arithmetic
# and are held to the bounds of phases 3 and 4, measured on an H100 80GB
# HBM3 (700 W): kernel against plain states 2.0e-6 abs (chunk at 4884
# steps), cotangents 2.3e-6 x max (stack cotangents 6.6e-7); 'stream'
# against the streamK route J 0, gradient 1.5e-7 x max; 'chunk' against f64
# J 3.7e-7, gradient 5.4e-6 x max; dense_fwd equal to the chunk forward to
# the bit.
NT_SHORT = 40           # steps of the comparisons with the plain version
NT_F64 = 400            # steps of configurations 2 and 3 against f64
E_OPEN = 8


def flagship_setup(linsolver="split", linsolve_iters=3, dtype=torch.complex64,
                   freq01=FREQ01, ntime=1221, fused_mode="streamk"):
    """bench.py:59-93, built with the port's own functions. `freq01` detunes
    the qubits against the rotating frame and the carriers, which stay at
    the nominal frequencies (a system realization of the robust ensemble).
    `ntime` refines the time step at the same horizon."""
    Ne, Ng = [2, 2], [2, 2]
    nlevels = [e + g for e, g in zip(Ne, Ng)]
    model = build_standard_model(
        nlevels=nlevels, freq01_ghz=freq01, rotfreq_ghz=FREQ01,
        selfkerr_ghz=SELFKERR, jkl_ghz=[0.005], crosskerr_ghz=[])
    T = 200.0
    oscs = tuple(
        OscillatorControl(
            segments=(ControlSegment("spline", nsplines=30, tstart=0.0,
                                     tstop=T),),
            carrier_freqs=(0.0, 2 * np.pi * (FREQ01[1 - k] - FREQ01[k]),
                           -2 * np.pi * SELFKERR[k]))
        for k in range(2))
    V = gates.assemble_gate(gates.cnot(), nlevels, Ne, [0.0, 0.0], T)
    return Setup(
        model=model, nessential=tuple(Ne), ntime=ntime, dt=T / ntime,
        oscillators=oscs,
        ground_freqs_radns=tuple(2 * np.pi * f for f in FREQ01),
        initcond_type="basis", target_type="gate", target_gate_full=V,
        objective_type="Jtrace", gamma_tik=1e-4, gamma_penalty=0.1,
        gamma_penalty_energy=0.1, gamma_penalty_dpdm=0.01,
        dtype=dtype, linsolve_iters=linsolve_iters, linsolver=linsolver,
        fused_mode=fused_mode)


def bench_params(n, E=None, seed=1234):
    """The bench's parameter draw: uniform(-1, 1) * 0.005."""
    shape = (n,) if E is None else (E, n)
    return np.random.default_rng(seed).uniform(-1, 1, shape) * 0.005


def open_cnot_setup(guards, dtype=torch.complex64, ntime=1221,
                    fused_rho="auto"):
    """scripts/perf/lindblad_pallas_bench.py:29-63, built with the port's
    own functions: the CNOT with T1/T2 collapse, without guard levels
    (N = 4) or with two per qubit (N = 16), 16 basis density matrices.
    `ntime` below 1221 cuts the horizon at the same step."""
    Ne, Ng = [2, 2], ([2, 2] if guards else [0, 0])
    nlevels = [e + g for e, g in zip(Ne, Ng)]
    model = build_standard_model(
        nlevels=nlevels, freq01_ghz=FREQ01, rotfreq_ghz=FREQ01,
        selfkerr_ghz=SELFKERR, jkl_ghz=[0.005], crosskerr_ghz=[],
        decay_time=[80.0, 90.0], dephase_time=[40.0, 45.0], lindblad=True)
    dt = 200.0 / 1221
    T = ntime * dt
    oscs = tuple(
        OscillatorControl(
            segments=(ControlSegment("spline", nsplines=30, tstart=0.0,
                                     tstop=T),),
            carrier_freqs=(0.0, 2 * np.pi * (FREQ01[1 - k] - FREQ01[k])))
        for k in range(2))
    V = gates.assemble_gate(gates.cnot(), nlevels, Ne, [0.0, 0.0], T)
    return Setup(
        model=model, nessential=tuple(Ne), ntime=ntime, dt=dt,
        oscillators=oscs,
        ground_freqs_radns=tuple(2 * np.pi * f for f in FREQ01),
        initcond_type="basis", target_type="gate", target_gate_full=V,
        objective_type="Jtrace", gamma_tik=1e-4, gamma_penalty=0.1,
        gamma_penalty_energy=0.1, dtype=dtype, linsolve_iters=8,
        fused_rho=fused_rho)


def midsize_setup(N, dtype=torch.complex64, ntime=1000):
    """scripts/perf/rho_bench.py:25-65: 3 qutrits (N = 27) or two 8-level
    qudits (N = 64) with T1/T2 collapse, '3states' initial conditions, a
    random pure target state. `ntime` below 1000 cuts the horizon at the
    same step."""
    cfg = {
        27: dict(nlevels=[3, 3, 3], freq01=[4.80595, 4.8601, 4.9],
                 selfkerr=[0.2198, 0.2252, 0.22], jkl=[0.005, 0.0, 0.004],
                 decay=[80.0, 90.0, 85.0], dephase=[40.0, 45.0, 42.0]),
        64: dict(nlevels=[8, 8], freq01=[4.80595, 4.8601],
                 selfkerr=[0.2198, 0.2252], jkl=[0.005],
                 decay=[80.0, 90.0], dephase=[40.0, 45.0]),
    }[N]
    model = build_standard_model(
        nlevels=cfg["nlevels"], freq01_ghz=cfg["freq01"],
        rotfreq_ghz=cfg["freq01"], selfkerr_ghz=cfg["selfkerr"],
        jkl_ghz=cfg["jkl"], crosskerr_ghz=[], decay_time=cfg["decay"],
        dephase_time=cfg["dephase"], lindblad=True)
    dt = 100.0 / 1000
    T = ntime * dt
    oscs = tuple(
        OscillatorControl(
            segments=(ControlSegment("spline", nsplines=20, tstart=0.0,
                                     tstop=T),),
            carrier_freqs=(0.0,)) for _ in cfg["nlevels"])
    rng = np.random.default_rng(42)
    tgt = rng.normal(size=N) + 1j * rng.normal(size=N)
    tgt = tgt / np.linalg.norm(tgt)
    return Setup(
        model=model, nessential=tuple(cfg["nlevels"]), ntime=ntime, dt=dt,
        oscillators=oscs,
        ground_freqs_radns=tuple(2 * np.pi * f for f in cfg["freq01"]),
        initcond_type="3states", target_type="state",
        target_state_full=np.outer(tgt, tgt.conj()),
        objective_type="Jtrace", gamma_tik=1e-4, dtype=dtype,
        linsolve_iters=6)


T_START = time.perf_counter()


def phase(n, msg):
    print(f"phase {n} [{time.perf_counter() - T_START:.0f} s]: {msg}",
          flush=True)


@contextlib.contextmanager
def plain_on_card():
    """Route the problem's propagation through the plain torch versions
    for CUDA tensors too (the reference runs on the card)."""
    saved = (streamk.streamk_propagate, rho.rho_propagate,
             stream.stream_propagate)
    streamk.streamk_propagate = streamk.streamk_propagate_plain
    rho.rho_propagate = rho.rho_propagate_plain
    stream.stream_propagate = stream.stream_propagate_plain
    try:
        yield
    finally:
        (streamk.streamk_propagate, rho.rho_propagate,
         stream.stream_propagate) = saved


def max_rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def compare_kernel(problem, linsolver, iters, dt, E, rng):
    """One kernel-vs-plain comparison at the problem's shapes, E control
    candidates on the problem's one stack."""
    plan = streamk.make_plan(problem._Sr, problem._Si, dt, iters,
                             problem.gen_diag, linsolver)
    n = problem.setup.nparams
    P = torch.as_tensor(bench_params(n, E, seed=int(rng.integers(1 << 30))),
                        device="cuda", dtype=torch.float32)
    C = streamk.extend_coeffs(plan, problem.coeff_rows_mid(P)[..., 0, :])
    return compare_plan(plan, problem, C, rng)


def packed_plan(problems, linsolver, iters):
    """The per-candidate plan of S system realizations and the coefficient
    rows of one control (the bench's parameter draw) on each of them."""
    p0 = problems[0]
    plan = streamk.make_plan(
        torch.stack([p._Sr for p in problems]),
        torch.stack([p._Si for p in problems]), p0.setup.dt, iters,
        np.stack([p.gen_diag for p in problems]), linsolver)
    x = torch.as_tensor(bench_params(p0.setup.nparams), device="cuda",
                        dtype=torch.float32)
    C = streamk.extend_coeffs(plan, torch.stack(
        [p.coeff_rows_mid(x)[:, 0, :] for p in problems]))
    return plan, C


def compare_plan(plan, problem, C, rng, with_f64=False):
    """Kernel against plain for one plan and its (E, nt, Ke) coefficients;
    returns the max abs errors (states, C-bar, x0-bar) and the relative
    ones. with_f64: also the state errors of both against the plain version
    in f64 on the card."""
    E = C.shape[0]
    wT = torch.as_tensor(rng.normal(size=(E,) + problem._x0r.shape),
                         device="cuda", dtype=torch.float32)
    wh = torch.as_tensor(rng.normal(size=tuple(C.shape[:2])
                                    + problem._x0r.shape),
                         device="cuda", dtype=torch.float32)
    out = {}
    for name, fn in (("kernel", streamk.streamk_propagate_kernel),
                     ("plain", streamk.streamk_propagate_plain)):
        Cg = C.clone().requires_grad_()
        x0r = problem._x0r.clone().requires_grad_()
        x0i = problem._x0i.clone().requires_grad_()
        xTr, xTi, hr, hi = fn(plan, x0r, x0i, Cg)
        torch.cuda.synchronize()
        L = torch.sum(wT * xTr) + torch.sum(wT * xTi) \
            + torch.sum(wh * (hr * hr + hi * hi))
        L.backward()
        torch.cuda.synchronize()
        out[name] = (torch.cat([xTr.flatten(), xTi.flatten(), hr.flatten(),
                                hi.flatten()]).detach(),
                     Cg.grad[..., :problem.model.K],
                     torch.cat([x0r.grad.flatten(), x0i.grad.flatten()]))
    (sk, ck, xk), (sp, cp, xp) = out["kernel"], out["plain"]
    if not all(bool(torch.isfinite(t).all()) for t in (sk, ck, xk)):
        raise RuntimeError("kernel produced non-finite values")
    err = dict(state=float((sk - sp).abs().max()),
               cbar=float((ck - cp).abs().max()),
               x0bar=float((xk - xp).abs().max()),
               cbar_rel=max_rel(ck, cp), x0bar_rel=max_rel(xk, xp))
    if with_f64:
        plan64 = dataclasses.replace(plan, Sr=plan.Sr.double(),
                                     Si=plan.Si.double(),
                                     rows=plan.rows.double())
        with torch.no_grad():
            s64 = torch.cat([t.flatten() for t in streamk.plain_forward(
                plan64, problem._x0r.double(), problem._x0i.double(),
                C.double())])
        n = s64.numel()   # the histories; sk, sp begin with the two xT
        err.update(kernel_f64=float((sk[-n:] - s64).abs().max()),
                   plain_f64=float((sp[-n:] - s64).abs().max()))
    return err


def median_seconds(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def event_ms(fn, reps, warm=True):
    if warm:
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def work_bound(plan, E, nt, B, N, backward):
    """(bound_ms, bound_by) of one launch: the least time the card could
    take, the larger of the bytes the function must move (each input read
    once, each output written once) over the memory rate and its f32
    operations over the CUDA cores' peak. The function is the propagation
    (x0 -> xT, history) and its transpose: the stage iterates a kernel
    stores for its backward, or replays instead, are its own choice and
    count neither as bytes nor as operations. streamK plans read the stacks
    and coefficients and contract the planes in-kernel; the streamed-plane
    kernels (stream.StreamPlan) read the (E, nt, N, N) plane pair instead
    and their backward writes its cotangent, as many words; the dense
    member writes no history."""
    BN, NN, it = B * N, N * N, plan.iters
    hist = 2 * E * nt * BN
    matvec = 8 * BN * N                    # complex (B, N) x (N, N), real ops
    pairs = (it + 1) * 8 * B * NN          # the step's H cotangent
    if isinstance(plan, stream.StreamPlan):
        if plan.kind == "dense":
            hist = 0
        ins = plan.rows.numel() + 2 * E * nt * NN + 2 * BN
        cot = 2 * E * nt * NN
        contract = reduce = 0
    else:
        Ke = plan.Ke
        ins = (E if plan.per_block else 1) * (2 * Ke * NN) \
            + plan.rows.numel() + E * nt * Ke + 2 * BN
        cot = E * nt * Ke
        contract = reduce = 4 * Ke * NN
    if backward:
        words = ins + 2 * hist + 2 * E * BN + 2 * E * BN + cot
        flops = contract + (it + 1) * matvec + pairs + reduce
    else:
        words = ins + 2 * E * BN + hist
        flops = contract + (it + 1) * matvec
    t_bytes = 4 * words / PEAK_BYTES_S
    t_flops = E * nt * flops / PEAK_F32_FLOP_S
    return (1e3 * max(t_bytes, t_flops),
            "bytes" if t_bytes >= t_flops else "operations")


def kernel_ms(plan, x0r, x0i, C, reps, plain_reps):
    """CUDA-event times of both kernels and of their plain versions for
    one plan, and the launch's bounds."""
    fwd = streamk._kernel_fwd(plan, x0r, x0i, C)
    hr, hi, ksr, ksi = fwd[2:]
    ones_T, ones_h = torch.ones_like(fwd[0]), torch.ones_like(hr)
    out = dict(
        fwd=event_ms(lambda: streamk._kernel_fwd(plan, x0r, x0i, C), reps),
        bwd=event_ms(lambda: streamk._kernel_bwd(
            plan, x0r, x0i, C, hr, hi, ksr, ksi, ones_T, ones_T, ones_h,
            ones_h), reps))
    if plain_reps:
        out.update(
            plain_fwd=event_ms(
                lambda: streamk.plain_forward(plan, x0r, x0i, C), plain_reps),
            plain_bwd=event_ms(lambda: streamk.plain_backward(
                plan, x0r, x0i, C, hr, hi, ones_T, ones_T, ones_h, ones_h),
                plain_reps))
    E, nt = C.shape[:2]
    out["fwd_bound"] = work_bound(plan, E, nt, *x0r.shape, backward=False)
    out["bwd_bound"] = work_bound(plan, E, nt, *x0r.shape, backward=True)
    return out


def stream_compare(plan, Sr, Si, x0r, x0i, C, rng):
    """The stream.cu kernels of the plan's member against the plain version
    on the card, for the (E, nt, K) coefficients C on the stack planes
    Sr, Si through stream.planes: max abs errors of the states and of the
    coefficient, x0 and stack cotangents, and the relative ones."""
    E, nt = C.shape[:2]
    w = lambda *s: torch.as_tensor(rng.normal(size=s), device="cuda",
                                   dtype=torch.float32)
    wT, wh = w(E, *x0r.shape), w(E, nt, *x0r.shape)
    out = {}
    for name, fn in (("kernel", stream.stream_propagate_kernel),
                     ("plain", stream.stream_propagate_plain)):
        Srg, Sig = Sr.clone().requires_grad_(), Si.clone().requires_grad_()
        Cg = C.clone().requires_grad_()
        xr, xi = x0r.clone().requires_grad_(), x0i.clone().requires_grad_()
        xTr, xTi, hr, hi = fn(plan, *stream.planes(plan, Srg, Sig, Cg), xr,
                              xi)
        L = torch.sum(wT * xTr) + torch.sum(wT * xTi) \
            + torch.sum(wh * (hr * hr + hi * hi))
        L.backward()
        torch.cuda.synchronize()
        flat = lambda ts: torch.cat([t.flatten() for t in ts]).detach()
        out[name] = (flat((xTr, xTi, hr, hi)), Cg.grad, flat((xr.grad,
                                                              xi.grad)),
                     flat((Srg.grad, Sig.grad)))
        del xTr, xTi, hr, hi, L
    (sk, ck, xk, gk), (sp, cp, xp, gp) = out["kernel"], out["plain"]
    if not all(bool(torch.isfinite(t).all()) for t in (sk, ck, xk, gk)):
        raise RuntimeError("stream kernel produced non-finite values")
    return dict(state=float((sk - sp).abs().max()),
                cbar=float((ck - cp).abs().max()),
                x0bar=float((xk - xp).abs().max()),
                sbar=float((gk - gp).abs().max()),
                cbar_rel=max_rel(ck, cp), x0bar_rel=max_rel(xk, xp),
                sbar_rel=max_rel(gk, gp))


def stream_kernel_ms(plan, Hr, Hi, x0r, x0i, reps, plain):
    """CUDA-event times of the plan's stream.cu kernels on the planes
    Hr, Hi (the forward only for 'dense'), their bounds and, with `plain`,
    one run of each plain version at the same depth."""
    E, nt = Hr.shape[:2]
    B, N = x0r.shape
    fwd = stream._kernel_fwd(plan, Hr, Hi, x0r, x0i)
    keys = ("fwd",) if plan.kind == "dense" else ("fwd", "bwd")
    out = dict(fwd=event_ms(lambda: stream._kernel_fwd(plan, Hr, Hi, x0r,
                                                       x0i), reps))
    if "bwd" in keys:
        hr, hi, ksr, ksi = fwd[2:]
        oT, oh = torch.ones_like(fwd[0]), torch.ones_like(hr)
        out["bwd"] = event_ms(lambda: stream._kernel_bwd(
            plan, Hr, Hi, x0r, x0i, hr, hi, ksr, ksi, oT, oT, oh, oh), reps)
    if plain:
        with torch.no_grad():
            out["plain_fwd"] = event_ms(lambda: stream.plain_forward(
                plan, Hr, Hi, x0r, x0i), 1, warm=False)
            if "bwd" in keys:
                out["plain_bwd"] = event_ms(lambda: stream.plain_backward(
                    plan, Hr, Hi, x0r, x0i, hr, hi, oT, oT, oh, oh), 1,
                    warm=False)
    for k in keys:
        out[f"{k}_bound"] = work_bound(plan, E, nt, B, N, k == "bwd")
    return out


@contextlib.contextmanager
def iterates_budget(nbytes):
    """The rho forward stores its stage iterates up to this many bytes."""
    saved, rho.KS_BUDGET_BYTES = rho.KS_BUDGET_BYTES, nbytes
    try:
        yield
    finally:
        rho.KS_BUDGET_BYTES = saved


def rho_compare(plan, x0r, x0i, C, rng, store):
    """rho kernels against rho_propagate_plain for one plan and its
    (E, nt, K) coefficients, with stored or replayed stage iterates: max abs
    errors (states, C-bar, x0-bar), the relative ones, and the state errors
    of both against the plain version in f64 on the card."""
    E, nt = C.shape[:2]
    w = lambda *s: torch.as_tensor(rng.normal(size=s), device="cuda",
                                   dtype=torch.float32)
    wT, wh = w(E, *x0r.shape), w(E, nt, *x0r.shape)
    out = {}
    for name, fn in (("kernel", rho.rho_propagate_kernel),
                     ("plain", rho.rho_propagate_plain)):
        Cg = C.clone().requires_grad_()
        xr, xi = x0r.clone().requires_grad_(), x0i.clone().requires_grad_()
        before = rho.launch_counts()
        with iterates_budget((1 << 62) if store else 0):
            xTr, xTi, hr, hi = fn(plan, xr, xi, Cg)
            L = torch.sum(wT * xTr) + torch.sum(wT * xTi) \
                + torch.sum(wh * (hr * hr + hi * hi))
            L.backward()
        torch.cuda.synchronize()
        moved = [v - before[k] for k, v in rho.launch_counts().items()]
        if moved != ([1, 1] if name == "kernel" else [0, 0]):
            raise RuntimeError(f"{name}: rho launches {moved}")
        out[name] = (torch.cat([hr.flatten(), hi.flatten()]).detach(),
                     Cg.grad, torch.cat([xr.grad.flatten(),
                                         xi.grad.flatten()]))
    (sk, ck, xk), (sp, cp, xp) = out["kernel"], out["plain"]
    if not all(bool(torch.isfinite(t).all()) for t in (sk, ck, xk)):
        raise RuntimeError("rho kernel produced non-finite values")
    d = lambda t: None if t is None else t.double()
    plan64 = dataclasses.replace(plan, Sr=d(plan.Sr), Si=d(plan.Si),
                                 L=d(plan.L), planes=d(plan.planes))
    with torch.no_grad():
        s64 = torch.cat([t.flatten() for t in rho.plain_forward(
            plan64, x0r.double(), x0i.double(), C.double())])
    return dict(state=float((sk - sp).abs().max()),
                cbar=float((ck - cp).abs().max()),
                x0bar=float((xk - xp).abs().max()),
                cbar_rel=max_rel(ck, cp), x0bar_rel=max_rel(xk, xp),
                kernel_f64=float((sk - s64).abs().max()),
                plain_f64=float((sp - s64).abs().max()))


def rho_work_bound(plan, E, nt, B, backward):
    """work_bound for one launch of a rho kernel. Bytes: stacks, jump and
    solver planes, coefficients and x0 once, the history (and its cotangent)
    once; stored stage iterates are the kernel's choice, as in work_bound,
    and not counted. Operations: one T or Tt is 2 + 2 J complex
    (N, N) products, (8 + 8 J) 2 N^3 real operations; a step applies
    iters + 1 of them forward, and backward iters + 1 Tt and one complex
    product per (cotangent, input) pair: W = c u^dag + (c u^dag)^dag is
    Hermitian, so c u^dag, four real products of 2 N^3, is all it needs (the
    kernel computes both halves). A backward that replays its stage
    iterates recomputes them by its own choice: the replay is not
    counted."""
    N, K, J, it = plan.N, plan.K, plan.njump, plan.iters
    NN, EB = N * N, E * B
    const = 2 * K * NN + 4 * J * NN + plan.planes.numel() + E * nt * K \
        + 2 * B * NN
    hist = 2 * EB * nt * NN
    gen = (8 + 8 * J) * 2 * N ** 3
    if backward:
        words = const + 2 * hist + 4 * EB * NN + EB * nt * K
        flops = (it + 1) * gen + (it + 1) * 4 * 2 * N ** 3 + 8 * K * NN
    else:
        words = const + hist + 2 * EB * NN
        flops = (it + 1) * gen + 4 * K * NN
    t_bytes = 4 * words / PEAK_BYTES_S
    t_flops = EB * nt * flops / PEAK_F32_FLOP_S
    return (1e3 * max(t_bytes, t_flops),
            "bytes" if t_bytes >= t_flops else "operations")


def rho_kernel_ms(plan, x0r, x0i, C, reps, plain):
    """CUDA-event times of both rho kernels at the sizes of a sweep (stage
    iterates stored where the gate on bytes stores them), their bounds and,
    with `plain`, one timed run of each plain version at the same depth,
    whose history and cotangents the kernels' are held against
    (`full_depth`: states abs, cotangents x max)."""
    E, nt = C.shape[:2]
    B = x0r.shape[0]
    fwd = rho._kernel_fwd(plan, x0r, x0i, C)
    hr, hi, ksr, ksi = fwd[2:]
    store = ksr is not None
    oT, oh = torch.ones_like(fwd[0]), torch.ones_like(hr)
    out = dict(
        stored=store,
        fwd=event_ms(lambda: rho._kernel_fwd(plan, x0r, x0i, C), reps),
        bwd=event_ms(lambda: rho._kernel_bwd(
            plan, x0r, x0i, C, hr, hi, ksr, ksi, oT, oT, oh, oh), reps),
        fwd_bound=rho_work_bound(plan, E, nt, x0r.shape[0], False),
        bwd_bound=rho_work_bound(plan, E, nt, x0r.shape[0], True))
    # each kernel's cluster: CTAs per matrix, CTAs launched, tile, threads
    lib = cuda_build.library(rho._SRC, rho._bind)
    for key, args in (("fwd", rho._fwd_args), ("bwd", rho._bwd_args)):
        tile, G, threads, _ = args(lib, plan, E, nt, B, store)[-4:]
        out[f"{key}_cluster"] = dict(G=G, ctas=E * B * G, tile=tile,
                                     threads=threads)
        out[f"{key}_us_per_step"] = 1e3 * out[key] / nt
    if plain:
        got = rho._kernel_bwd(plan, x0r, x0i, C, hr, hi, ksr, ksi, oT, oT, oh,
                              oh)
    del fwd, ksr, ksi
    if plain:
        kept = {}
        with torch.no_grad():
            out["plain_fwd"] = event_ms(lambda: kept.update(
                fwd=rho.plain_forward(plan, x0r, x0i, C)), 1, warm=False)
            out["plain_bwd"] = event_ms(lambda: kept.update(
                bwd=rho.plain_backward(plan, x0r, x0i, C, hr, hi, oT, oT, oh,
                                       oh)), 1, warm=False)
        flat = lambda ts: torch.cat([t.flatten() for t in ts])
        out["full_depth"] = dict(
            state=float((flat((hr, hi)) - flat(kept["fwd"])).abs().max()),
            x0bar_rel=max_rel(flat(got[:2]), flat(kept["bwd"][:2])),
            cbar_rel=max_rel(got[2], kept["bwd"][2]))
    return out


def open_vg(prob, P):
    """(J (E,), fidelity (E,), grad (E, n)) of the candidates P (E, n),
    through the single-candidate entry point when E = 1."""
    if P.shape[0] == 1:
        (J, aux), g = prob.build_value_and_grad()(P[0], P[0])
        return J[None], aux["fidelity"][None], g[None]
    (J, aux), g = prob.build_ensemble_value_and_grad()(P, P[0])
    return J, aux["fidelity"], g


def open_errors(got, ref):
    """Relative errors of (J, fidelity, grad) against a reference."""
    (J, f, g), (Jr, fr, gr) = ([t.double().cpu() for t in x]
                               for x in (got, ref))
    return (float(((J - Jr).abs() / Jr.abs()).max()),
            float((f - fr).abs().max()), max_rel(g, gr))


OPEN_CONFIGS = {
    "cnot4": lambda **kw: open_cnot_setup(False, **kw),
    "cnot16": lambda **kw: open_cnot_setup(True, **kw),
    "qutrits27": lambda **kw: midsize_setup(27, **kw),
    "qudits64": lambda **kw: midsize_setup(64, **kw),
}


def f64_reference(name, **kw):
    """((J, fidelity, grad), seconds) of open configuration `name` (cut to
    `ntime` steps if given) through the complex128 port on the CPU, at the
    bench's parameter draw rounded to float32 as the card takes it."""
    prob = Problem(OPEN_CONFIGS[name](dtype=torch.complex128, **kw),
                   device="cpu")
    P = torch.as_tensor(bench_params(prob.setup.nparams),
                        dtype=torch.float32).double()[None]
    t0 = time.perf_counter()
    out = open_vg(prob, P)
    return out, time.perf_counter() - t0


def ptxas_lines(log):
    """What ptxas reports per kernel: entry, registers, spills."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "Compiling entry" in ln
            or ("spill" in ln and "0 bytes spill stores" not in ln)]


def ptxas_kernels(log, name):
    """Registers and spill bytes of each instance of the kernel template
    `name` (integer and bool arguments) as ptxas reports them:
    {"name<16, 512>":
    {"registers": r, "spill_stores": bytes, "spill_loads": bytes}}."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            t = re.search(rf"{len(name)}{name}I((?:L[bi]\d+E)+)E",
                          m.group(1))
            args = [("false", "true")[int(v)] if k == "b" else v
                    for k, v in re.findall(r"L([bi])(\d+)E", t.group(1))
                    ] if t else ()
            cur = f"{name}<{', '.join(args)}>" if t else None
            if cur:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out[cur].update(spill_stores=int(m.group(1)),
                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def reset_counts():
    streamk.reset_launch_counts()
    rho.reset_launch_counts()
    stream.reset_launch_counts()


def main_path_launches(names):
    """Reads the counters after a main path was driven (they were set to 0
    just before it) and fails if a kernel of that path never launched."""
    counts = {**streamk.launch_counts(), **rho.launch_counts(),
              **stream.launch_counts()}
    missing = [k for k in names if counts[k] < 1]
    if missing:
        raise RuntimeError(f"main path did not launch {missing}: {counts}")
    return counts


def sweep_launches(want):
    """main_path_launches of one sweep: exactly one launch of each kernel in
    `want` and none of any other."""
    counts = main_path_launches(want)
    if any(v != (1 if k in want else 0) for k, v in counts.items()):
        raise RuntimeError(f"a sweep must be one launch of each of {want}: "
                           f"{counts}")
    return counts


B1 = ("streamk_fwd_launches", "streamk_bwd_launches")
B2 = ("streamk_packed_fwd_launches", "streamk_packed_bwd_launches")
B3 = ("stream_fwd_launches", "stream_bwd_launches")
B4 = ("rho_fwd_launches", "rho_bwd_launches")
B5 = ("chunk_fwd_launches", "chunk_bwd_launches")
B6 = ("dense_fwd_launches",)
NT_FINE = 4 * 1221      # dt/4: plain Neumann with 8 iterations is accurate
STREAM_SRC = "quandary_tpu_torch/csrc/stream.cu"


def vg_errors(J, g, Jp, gp, J64, g64):
    """Relative errors of a value and gradient against the same through
    another path on the card (`plain`) and against f64 on the CPU."""
    g, gp, g64 = g.double().cpu(), gp.double().cpu(), g64.double().cpu()
    return dict(J_plain=abs(float(J) - float(Jp)) / abs(float(Jp)),
                g_plain=max_rel(g, gp),
                J_f64=abs(float(J) - float(J64)) / abs(float(J64)),
                g_f64=max_rel(g, g64))


def check_vg_errors(errs, what, tol_g_f64=TOL_G_F64):
    if errs["J_plain"] > TOL_J_PLAIN or errs["g_plain"] > TOL_G_PLAIN \
            or errs["J_f64"] > TOL_J_F64 or errs["g_f64"] > tol_g_f64:
        raise RuntimeError(f"{what} out of bounds: {errs}")


def main():
    # ---- 1. device ----
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    phase(1, f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch "
             f"{torch.__version__}, "
             f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain path in full f32
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build ----
    t0 = time.perf_counter()
    (path, secs, log), rho_build, stream_build = cuda_build.build_parallel(
        [streamk.build_kernels, rho.build_kernels, stream.build_kernels],
        verbose=True)
    phase(2, f"built {path} in {secs:.2f} s (all three sources in "
             f"{time.perf_counter() - t0:.2f} s); " + " | ".join(ptxas_lines(log)))

    # ---- 3. kernel against plain at the flagship shapes ----
    setup = flagship_setup()
    prob = Problem(setup)               # no device named: the card
    prob_j = Problem(flagship_setup("neumann", 8))
    if prob.device.type != "cuda" or prob_j.linsolver != "jacobi":
        raise RuntimeError("the default device is not the card, or the "
                           "stiffness guard did not pick jacobi")
    rng = np.random.default_rng(0)
    cases = [("split", 3, prob, setup.dt), ("jacobi", 8, prob_j, setup.dt),
             ("neumann", 8, prob_j, setup.dt / 4)]
    worst = dict(state=0.0, cbar=0.0, x0bar=0.0)
    for solver, iters, pr, dt in cases:
        for E in (1, E_BIG):
            err = compare_kernel(pr, solver, iters, dt, E, rng)
            print(f"  {solver}-{iters} E={E}: {json.dumps(err)}", flush=True)
            for k in worst:
                worst[k] = max(worst[k], err[k])
            if err["state"] > TOL_STATE_ABS or err["cbar_rel"] > TOL_GRAD_REL \
                    or err["x0bar_rel"] > TOL_GRAD_REL:
                raise RuntimeError(f"kernel disagrees with plain: {solver}-"
                                   f"{iters} E={E} {err}")
    phase(3, f"kernel == plain within abs {TOL_STATE_ABS} (states), "
             f"{TOL_GRAD_REL} x max (cotangents); worst {json.dumps(worst)}")

    # ---- 4. flagship value_and_grad through the kernels ----
    x = bench_params(setup.nparams)
    vg = prob.build_value_and_grad()
    reset_counts()
    (J, aux), g = vg(x, x)
    torch.cuda.synchronize()
    launches = main_path_launches(B1)
    if not (torch.isfinite(J) and bool(torch.isfinite(g).all())) \
            or g.shape != (setup.nparams,):
        raise RuntimeError("non-finite or misshapen value_and_grad")
    with plain_on_card():
        (Jp, _), gp = prob.build_value_and_grad()(x, x)
    p64 = Problem(flagship_setup(dtype=torch.complex128), device="cpu")
    (J64, _), g64 = p64.build_value_and_grad()(x, x)
    errs = vg_errors(J, g, Jp, gp, J64, g64)
    ref_flagship = (J64, g64)
    phase(4, f"J={float(J):.8f} fidelity={float(aux['fidelity']):.8f} "
             f"launches {json.dumps(launches)}; {json.dumps(errs)}")
    check_vg_errors(errs, "flagship value_and_grad")

    # ---- 5. L-BFGS-B on the card ----
    lb, ub = build_bounds(setup.oscillators, [[0.045]] * 2)
    t0 = time.perf_counter()
    res = run_optimization(prob, x, lb, ub, maxiter=5, verbose=False)
    wall = time.perf_counter() - t0
    # the first main path's launches: phase 4's sweep and the optimizer's
    launches = main_path_launches(B1)
    objs = [h.objective for h in res.history]
    phase(5, f"{res.niter} iterations in {wall:.2f} s ({res.reason}); "
             f"J: {' '.join(f'{v:.8f}' for v in objs)}")
    if not (len(objs) >= 2 and objs[-1] < objs[0]
            and all(np.isfinite(objs))):
        raise RuntimeError(f"L-BFGS-B did not lower J: {objs}")

    # ---- 6. times ----
    rates = {}
    evg = prob.build_ensemble_value_and_grad()
    Ps = bench_params(setup.nparams, E_BIG, seed=7)
    runs = {"E1": lambda: vg(x, x), f"E{E_BIG}": lambda: evg(Ps, x)}
    for name, fn in runs.items():
        E = 1 if name == "E1" else E_BIG
        rates[f"kernel_{name}"] = E / median_seconds(fn)
        with plain_on_card():
            rates[f"plain_{name}"] = E / median_seconds(fn, reps=2)
    plan = prob._plan
    to_card = lambda a: torch.as_tensor(a, device="cuda", dtype=torch.float32)
    C1 = streamk.extend_coeffs(plan, prob.coeff_rows_mid(to_card(x))[None, :, 0])
    CE = streamk.extend_coeffs(plan, prob.coeff_rows_mid(to_card(Ps))[:, :, 0])
    x0r, x0i = prob._x0r, prob._x0i
    ms = kernel_ms(plan, x0r, x0i, C1, 20, 2)
    ms_big = kernel_ms(plan, x0r, x0i, CE, 10, 0)
    # the dependent chain per time step: iters + 1 stage syncs in each
    # direction (the forward's matvecs, the backward's transposed stages; a
    # backward replay adds iters), each on the state threads alone (a
    # __syncwarp where a state's N entries lie in one warp), and no
    # block-wide barrier where helper warps contract H (and in the backward
    # reduce C-bar) beside it; the inline branch passes 2 (forward) or 4
    # (backward) per step
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.strip()
    try:
        sm_mhz = float(clock.splitlines()[0])
    except (ValueError, IndexError):
        sm_mhz = 1980.0     # the H100 SXM's published boost clock
    floor_us = (2 * prob.N * FMA_CYCLES + SMEM_CYCLES + BARRIER_CYCLES) \
        / sm_mhz
    B, N = x0r.shape
    bwd_stages = plan.iters + 1 + (0 if plan.store_iters else plan.iters)
    chain = {}
    for k, st, shape, inline in (
            ("fwd", plan.iters + 1, streamk._fwd_shape, 2),
            ("bwd", bwd_stages, streamk._bwd_shape, 4)):
        helpers = shape(plan.Ke, plan.iters, B, N)[2]
        chain[k] = dict(
            stages_per_step=st, us_per_step=1e3 * ms[k] / setup.ntime,
            us_per_step_E128=1e3 * ms_big[k] / setup.ntime,
            us_per_stage=1e3 * ms[k] / setup.ntime / st,
            floor_us_per_stage=floor_us,
            floor_ms_per_sweep=1e-3 * floor_us * st * setup.ntime,
            helper_threads=helpers,
            stage_sync="warp" if 32 % N == 0 else "state warps",
            block_barriers_per_step=0 if helpers else inline)
    phase(6, "sweeps/s " + json.dumps({k: round(v, 3) for k, v in
                                      rates.items()})
          + f"; kernel ms at E=1 split-3 {json.dumps(ms)}; at E={E_BIG} "
          + f"{json.dumps(ms_big)}; chain {json.dumps(chain)}; card: {smi}")
    if any(c["block_barriers_per_step"] for c in chain.values()):
        raise RuntimeError("the flagship's chain passes block-wide barriers "
                           "(no helper warps)")

    # ---- 7. packed kernels: one stack and one set of rows per candidate ----
    det = np.random.default_rng(5).uniform(-0.002, 0.002, (S_ROBUST, 2))
    f01 = [[FREQ01[0] + d0, FREQ01[1] + d1] for d0, d1 in det]
    samples = [Problem(flagship_setup(freq01=f)) for f in f01]
    samples_j = [Problem(flagship_setup("neumann", 8, freq01=f)) for f in f01]
    if samples_j[0].linsolver != "jacobi":
        raise RuntimeError("stiffness guard did not pick jacobi")
    worst_p = dict(state=0.0, cbar=0.0, x0bar=0.0, kernel_f64=0.0,
                   plain_f64=0.0)
    for solver, iters, probs in (("split", 3, samples),
                                 ("jacobi", 8, samples_j)):
        pplan, pC = packed_plan(probs, solver, iters)
        err = compare_plan(pplan, probs[0], pC, rng, with_f64=True)
        print(f"  packed {solver}-{iters} S={S_ROBUST}: {json.dumps(err)}",
              flush=True)
        for k in worst_p:
            worst_p[k] = max(worst_p[k], err[k])
        if err["state"] > TOL_DETUNED_STATE_ABS \
                or err["cbar_rel"] > TOL_DETUNED_GRAD_REL \
                or err["x0bar_rel"] > TOL_DETUNED_GRAD_REL \
                or err["kernel_f64"] > max(TOL_DETUNED_F64_ABS,
                                           err["plain_f64"]):
            raise RuntimeError(f"packed kernel disagrees with plain: "
                               f"{solver}-{iters} {err}")
    pplan, pC = packed_plan(samples, "split", 3)
    ms_p = kernel_ms(pplan, x0r, x0i, pC, 20, 2)
    rep16 = lambda t: t.repeat((E_BIG // S_ROBUST,) + (1,) * (t.dim() - 1))
    big = dataclasses.replace(pplan, Sr=rep16(pplan.Sr), Si=rep16(pplan.Si),
                              rows=rep16(pplan.rows))
    ms_pbig = kernel_ms(big, x0r, x0i, rep16(pC), 10, 0)
    phase(7, f"packed kernel == plain within abs {TOL_DETUNED_STATE_ABS} "
             f"(states), {TOL_DETUNED_GRAD_REL} x max (cotangents), and "
             f"within {TOL_DETUNED_F64_ABS} of plain f64 or closer than "
             f"plain f32; worst "
             f"{json.dumps(worst_p)}; ms at S={S_ROBUST} split-3 "
             f"{json.dumps(ms_p)}; at S={E_BIG} {json.dumps(ms_pbig)}")

    # ---- 8. the packed robust objective: its own main path ----
    w = np.full(S_ROBUST, 1.0 / S_ROBUST)

    def robust_vg(objective, params, device):
        xt = torch.as_tensor(params, device=device).requires_grad_(True)
        Jr, auxr = objective(xt, torch.zeros_like(xt))
        (gr,) = torch.autograd.grad(Jr, xt)
        return Jr.detach(), gr, auxr

    packed_obj = robust.build_packed_robust_objective(samples, w)
    x32 = x.astype(np.float32)
    reset_counts()
    Jr, gr, auxr = robust_vg(packed_obj, x32, "cuda")
    torch.cuda.synchronize()
    launches_robust = sweep_launches(B2)
    J1, g1, _ = robust_vg(robust.build_robust_objective(samples, w), x32,
                          "cuda")
    samples64 = [Problem(flagship_setup(dtype=torch.complex128, freq01=f),
                         device="cpu") for f in f01]
    J64, g64, _ = robust_vg(
        robust.build_packed_robust_objective(samples64, w), x, "cpu")
    errs = vg_errors(Jr, gr, J1, g1, J64, g64)
    t_packed = median_seconds(lambda: robust_vg(packed_obj, x32, "cuda"))
    phase(8, f"robust J={float(Jr):.8f} worst fidelity="
             f"{float(auxr['fidelity'].detach()):.8f} launches "
             f"{json.dumps(launches_robust)}; against {S_ROBUST} launches of "
             f"the shared-stack kernels and the f64 CPU port: "
             f"{json.dumps(errs)}; {1e3 * t_packed:.2f} ms per robust "
             f"gradient of {S_ROBUST} samples")
    check_vg_errors(errs, "packed robust value_and_grad", TOL_DETUNED_G_F64)

    # ---- 9. the device optimizer: chunks of iterations as a CUDA graph ----
    tight = dict(maxiter=60, gatol=1e-14, grtol=1e-30, inftol=1e-12,
                 fatol=1e-14, verbose=False)
    t0 = time.perf_counter()
    res_h = run_optimization(prob, x, lb, ub, **tight)
    wall_h = time.perf_counter() - t0
    walls = {}
    for label, kw in (("eager", dict(graph=False)), ("graph_cold", {}),
                      ("graph_warm", {})):
        reset_counts()
        t0 = time.perf_counter()
        res_d = run_optimization_device(prob, x, lb, ub, chunk=10, **tight,
                                        **kw)
        walls[label] = time.perf_counter() - t0
        launches_dev = main_path_launches(B1)
    objs = [h.objective for h in res_d.history]
    phase(9, f"device L-BFGS-B {res_d.niter} iterations ({res_d.reason}): "
             f"J {objs[0]:.8f} -> {objs[-1]:.8f}, infidelity "
             f"{res_d.infidelity:.6e}; host driver after {res_h.niter} "
             f"iterations J {res_h.objective:.8f} in {wall_h:.2f} s; wall s "
             f"{json.dumps({k: round(v, 4) for k, v in walls.items()})}; "
             f"warm run launches {json.dumps(launches_dev)}, "
             f"{launches_dev[B1[0]] * 8 - 7} sweeps consumed (8 trial points "
             f"per iteration)")
    if not (res_d.niter == 60 and np.all(np.isfinite(objs))
            and objs[-1] < objs[0]
            and res_d.objective <= TOL_DEVICE_OPT * res_h.objective + 1e-10
            and np.all(res_d.params >= lb - 1e-6)
            and np.all(res_d.params <= ub + 1e-6)):
        raise RuntimeError(f"device optimizer out of bounds: {objs[-1]} "
                           f"against host {res_h.objective}")

    # ---- 10. the population optimizer ----
    n, iters10 = setup.nparams, 60
    bound = 15e-3 * 2 * np.pi / np.sqrt(2.0) / 2.0 * 3.0
    lb10, ub10 = -bound * np.ones(n, np.float32), bound * np.ones(n, np.float32)
    x0s = to_card(np.random.default_rng(1234).uniform(-1, 1, (E_BIG, n))
                  * 0.03)
    hooks = prob.packed_batch_fns(np.zeros(n))
    walls10 = []
    for _ in range(2):
        reset_counts()
        t0 = time.perf_counter()
        xb, fb, tr, stats = batched_lbfgsb(
            None, None, x0s, lb10, ub10, iters=iters10, ls_lengths=8,
            return_stats=True, **hooks)
        torch.cuda.synchronize()
        walls10.append(time.perf_counter() - t0)
        launches_pop = main_path_launches(B1)
    tr, fb = tr.cpu().numpy(), fb.cpu().numpy()
    best = np.minimum.accumulate(tr, axis=0)
    phase(10, f"{E_BIG} starts x {iters10} iterations: wall s first/second "
              f"{walls10[0]:.3f}/{walls10[1]:.3f}, "
              f"{E_BIG * (iters10 + 1) / walls10[1]:.1f} delivered sweeps/s; "
              f"objective start median {np.median(tr[0]):.6f}, final min "
              f"{fb.min():.6f} median {np.median(fb):.6f}; ladder iterations "
              f"{stats['ladder_iters']}, rejected {int(stats['rejected'])}; "
              f"launches {json.dumps(launches_pop)}")
    if not (tr.shape == (iters10 + 1, E_BIG) and np.all(np.isfinite(tr))
            and np.allclose(fb, best[-1]) and np.all(fb <= tr[0])
            and np.median(fb) < np.median(tr[0])
            and bool((xb >= to_card(lb10)).all())
            and bool((xb <= to_card(ub10)).all())):
        raise RuntimeError("population optimizer: f_best is not the running "
                           "minimum of a finite trace inside the box")

    # ---- 11. the build of the density-matrix kernels ----
    rpath, rsecs, rlog = rho_build
    phase(11, f"built {rpath} in {rsecs:.2f} s; "
              + " | ".join(ptxas_lines(rlog)))
    # every instance, where this process built the library (rsecs > 0)
    missing = [f"{k}<{ts}>" for k in ("rho_fwd", "rho_bwd") for ts in (1, 2, 4)
               if f"{k}ILi{ts}E" not in rlog]
    if rsecs > 0 and missing:
        raise RuntimeError(f"ptxas reported no {missing}")

    # ---- 12. rho kernels against plain at the open systems' stacks ----
    c64 = torch.complex64
    short = {
        "cnot16": Problem(open_cnot_setup(True, ntime=NT_SHORT)),
        "qutrits27": Problem(midsize_setup(27, ntime=NT_SHORT)),
        "qudits64": Problem(midsize_setup(64, ntime=NT_SHORT)),
    }
    worst_r = dict(state=0.0, cbar=0.0, x0bar=0.0, kernel_f64=0.0,
                   plain_f64=0.0)
    for name, pr in short.items():
        if pr.fused_form != "rho" or pr.linsolver != "jacobi":
            raise RuntimeError(f"{name}: route {pr.fused_form}, solver "
                               f"{pr.linsolver}; expected rho, jacobi")
        st = pr.setup
        it = st.linsolve_iters
        # (solver, dt, jump operators, E, stored iterates); plain Neumann at
        # dt/8, where its series converges on these stiff diagonals
        cases = [("jacobi", st.dt, True, 1, True),
                 ("jacobi", st.dt, True, 1, False),
                 ("jacobi", st.dt, False, 1, True),
                 ("split", st.dt, True, 1, True),
                 ("split", st.dt, False, 1, False),
                 ("neumann", st.dt / 8, True, 1, True),
                 ("neumann", st.dt / 8, False, 1, False)]
        if name == "cnot16":
            cases += [("jacobi", st.dt, True, E_OPEN, False),
                      ("split", st.dt, True, E_OPEN, True)]
        for solver, dt, jumps, E, store in cases:
            plan = rho.make_plan(pr._Sr, pr._Si,
                                 pr.engine.Ls_np if jumps else None, dt, it,
                                 pr.gen_diag, solver)
            P = to_card(bench_params(st.nparams, E,
                                     seed=int(rng.integers(1 << 30))))
            C = pr.coeff_rows_mid(P)[..., 0, :].contiguous()
            err = rho_compare(plan, pr._x0r, pr._x0i, C, rng, store)
            print(f"  rho {name} N={pr.N} {solver}-{it} jumps="
                  f"{plan.njump} E={E} stored={store}: {json.dumps(err)}",
                  flush=True)
            for k in worst_r:
                worst_r[k] = max(worst_r[k], err[k])
            if err["state"] > TOL_RHO_STATE_ABS \
                    or err["cbar_rel"] > TOL_RHO_GRAD_REL \
                    or err["x0bar_rel"] > TOL_RHO_GRAD_REL \
                    or err["kernel_f64"] > max(TOL_RHO_F64_ABS,
                                               err["plain_f64"]):
                raise RuntimeError(f"rho kernel disagrees with plain: {name} "
                                   f"{solver} {err}")
    phase(12, f"rho kernel == plain within abs {TOL_RHO_STATE_ABS} (states), "
              f"{TOL_RHO_GRAD_REL} x max (cotangents), and within "
              f"{TOL_RHO_F64_ABS} of plain f64 or closer than plain f32; "
              f"worst {json.dumps(worst_r)}")

    # ---- 13. configuration 1: the superop route on the streamK kernels ----
    def drive(prob, P, want):
        """One value_and_grad sweep of a main path: counters set to 0 just
        before, read just after; `want` names the pair that must have
        launched exactly once each, and nothing else may have."""
        reset_counts()
        out = open_vg(prob, P)
        torch.cuda.synchronize()
        counts = sweep_launches(want)
        J, f, g = out
        if not (bool(torch.isfinite(J).all()) and bool(torch.isfinite(g).all())
                and g.shape == P.shape):
            raise RuntimeError("non-finite or misshapen value_and_grad")
        return out, counts

    def against(name, got, ref, keyJ, keyg, what):
        eJ, ef, eg = open_errors(got, ref)
        tol = TOL_OPEN[name]
        if eJ > tol[keyJ] or ef > tol[keyJ] or eg > tol[keyg]:
            raise RuntimeError(f"{name} against {what}: J {eJ}, fidelity "
                               f"{ef}, gradient {eg}; bounds {tol}")
        return dict(J=eJ, fidelity=ef, grad=eg)

    open_launches, open_report = {}, {}
    cnot4 = OPEN_CONFIGS["cnot4"]
    p4 = Problem(cnot4())
    if p4.fused_form != "superop" or not p4.fused_ok:
        raise RuntimeError(f"configuration 1 took route {p4.fused_form}")
    P1 = to_card(bench_params(p4.setup.nparams))[None]
    got4, open_launches["cnot4"] = drive(p4, P1, B1)
    with plain_on_card():
        plain4 = open_vg(p4, P1)
    ref4, secs4 = f64_reference("cnot4")
    p4r = Problem(cnot4(fused_rho="rho"))
    got4r, _ = drive(p4r, P1, B4)
    eJ, ef, eg = open_errors(got4r, got4)
    open_report["cnot4"] = dict(
        J=float(got4[0][0]), fidelity=float(got4[1][0]),
        plain=against("cnot4", got4, plain4, "J_plain", "g_plain", "plain"),
        f64=against("cnot4", got4, ref4, "J_f64", "g_f64", "the f64 port"),
        rho_route_f64=against("cnot4", got4r, ref4, "J_f64", "g_f64",
                              "the f64 port (rho route)"),
        routes=dict(J=eJ, fidelity=ef, grad=eg), f64_cpu_seconds=secs4)
    phase(13, f"configuration 1 (N=4, B=16, dim 16) on the superop route: "
              f"launches {json.dumps(open_launches['cnot4'])}; "
              f"{json.dumps(open_report['cnot4'])}")
    if eJ > TOL_ROUTES_J or eg > TOL_ROUTES_G:
        raise RuntimeError(f"the two routes disagree: J {eJ}, gradient {eg}")

    # ---- 14. the rho route at full width and depth ----
    full = {}
    for name in ("cnot16", "qutrits27", "qudits64"):
        fn = OPEN_CONFIGS[name]
        pr = full[name] = Problem(fn())
        if pr.fused_form != "rho" or not pr.fused_ok:
            raise RuntimeError(f"{name} took route {pr.fused_form}")
        P = to_card(bench_params(pr.setup.nparams))[None]
        got, open_launches[name] = drive(pr, P, B4)
        ps = short[name]
        got_s = open_vg(ps, P)
        with plain_on_card():
            plain_s = open_vg(ps, P)
        # the f64 port on the CPU at NT_F64 steps: at full depth it took
        # 277 s of host time for the three configurations
        got_m = open_vg(Problem(fn(ntime=NT_F64)), P)
        ref, secs = f64_reference(name, ntime=NT_F64)
        open_report[name] = dict(
            N=pr.N, ninit=pr.ninit, ntime=pr.setup.ntime,
            J=float(got[0][0]), fidelity=float(got[1][0]),
            plain_short=against(name, got_s, plain_s, "J_plain", "g_plain",
                                f"plain at {NT_SHORT} steps"),
            f64=against(name, got_m, ref, "J_f64", "g_f64",
                        f"the f64 port at {NT_F64} steps"),
            f64_cpu_seconds=secs)
        if name == "cnot16":
            # E candidates: candidate 0 is the E = 1 control
            PE = to_card(bench_params(pr.setup.nparams, E_OPEN, seed=7))
            PE[0] = P[0]
            gotE, open_launches["cnot16_E8"] = drive(pr, PE, B4)
            with plain_on_card():
                plain_E = open_vg(ps, PE)
            open_report["cnot16_E8"] = dict(
                J=[float(v) for v in gotE[0]],
                first=against(name, [t[:1] for t in gotE], got, "J_plain",
                              "g_plain", "the E = 1 sweep"),
                plain_short=against(name, open_vg(ps, PE), plain_E, "J_plain",
                                    "g_plain", f"plain at {NT_SHORT} steps"))
    phase(14, f"rho route, one launch of each kernel per sweep: launches "
              f"{json.dumps(open_launches)}; {json.dumps(open_report)}; "
              f"bounds {json.dumps(TOL_OPEN)}")

    # ---- 15. the device optimizer on configuration 2 ----
    p16 = full["cnot16"]
    lb16, ub16 = build_bounds(p16.setup.oscillators, [[0.045]] * 2)
    x16 = bench_params(p16.setup.nparams)
    reset_counts()
    t0 = time.perf_counter()
    res16 = run_optimization_device(p16, x16, lb16, ub16, chunk=2, maxiter=4,
                                    gatol=1e-14, grtol=1e-30, inftol=1e-12,
                                    fatol=1e-14, verbose=False)
    wall16 = time.perf_counter() - t0
    launches_dev16 = main_path_launches(B4)
    objs16 = [h.objective for h in res16.history]
    phase(15, f"device L-BFGS-B on configuration 2, {res16.niter} iterations "
              f"in chunks of 2 (warm-up chunk, capture and 2 replays) in "
              f"{wall16:.2f} s: J {' '.join(f'{v:.8f}' for v in objs16)}; "
              f"launches {json.dumps(launches_dev16)}")
    if not (res16.niter == 4 and np.all(np.isfinite(objs16))
            and objs16[-1] < objs16[0]
            and launches_dev16[B1[0]] == launches_dev16[B1[1]] == 0):
        raise RuntimeError(f"device optimizer on the open problem: {objs16}")

    # ---- 16. times ----
    ms_r, rates_open = {}, {}
    for name, pr, E, reps in (("cnot16", p16, 1, 3), ("cnot16_E8", p16,
                                                      E_OPEN, 3),
                              ("qutrits27", full["qutrits27"], 1, 2),
                              ("qudits64", full["qudits64"], 1, 2)):
        P = to_card(bench_params(pr.setup.nparams, E, seed=7))
        C = pr.coeff_rows_mid(P)[..., 0, :].contiguous()
        ms_r[name] = rho_kernel_ms(pr._plan, pr._x0r, pr._x0i, C, reps,
                                   plain=E == 1)
        rates_open[name] = E / median_seconds(lambda: open_vg(pr, P), reps=3)
    rates_open["cnot4"] = 1 / median_seconds(lambda: open_vg(p4, P1), reps=3)
    C4 = streamk.extend_coeffs(p4._plan, p4.coeff_rows_mid(P1)[..., 0, :])
    ms_4 = kernel_ms(p4._plan, p4._x0r, p4._x0i, C4, 5, 1)
    phase(16, "rho clusters per configuration: " + "; ".join(
        f"{k} {name} G={t[f'{key}_cluster']['G']}, "
        f"{t[f'{key}_cluster']['ctas']} CTAs, tile "
        f"{t[f'{key}_cluster']['tile']}, {t[f'{key}_cluster']['threads']} "
        f"threads, {t[f'{key}_us_per_step']:.3f} us per step"
        for k, t in ms_r.items()
        for name, key in (("rho_fwd", "fwd"), ("rho_bwd", "bwd"))))
    phase(16, f"rho kernel ms {json.dumps(ms_r)}; configuration 1 on the "
              f"streamK kernels {json.dumps(ms_4)}; sweeps/s (delivered, "
              f"candidates per second) "
              f"{json.dumps({k: round(v, 4) for k, v in rates_open.items()})}"
              f"; card: {smi}")
    for name, t in ms_r.items():
        deep = t.get("full_depth")
        if deep and (deep["state"] > TOL_RHO_FULL_STATE_ABS
                     or deep["cbar_rel"] > TOL_RHO_FULL_GRAD_REL
                     or deep["x0bar_rel"] > TOL_RHO_FULL_GRAD_REL):
            raise RuntimeError(
                f"rho kernel disagrees with plain at full depth: {name} "
                f"{deep}; bounds {TOL_RHO_FULL_STATE_ABS} (states), "
                f"{TOL_RHO_FULL_GRAD_REL} x max (cotangents)")

    # ---- 17. the streamed-plane kernels against plain ----
    spath, ssecs, slog = stream_build
    prob_f = Problem(flagship_setup("neumann", 8, ntime=NT_FINE))
    if prob_f.linsolver != "neumann":
        raise RuntimeError("the stiffness guard did not keep neumann at dt/4")
    worst_s = {k: dict(state=0.0, cbar=0.0, x0bar=0.0, sbar=0.0)
               for k in ("stream", "chunk")}
    # chunk at E = 1 only: its plain version at 4884 steps takes 25 s
    for member, solver, iters, pr, Es in (
            ("stream", "split", 3, prob, (1, E_BIG)),
            ("stream", "jacobi", 8, prob_j, (1, E_BIG)),
            ("chunk", "neumann", 8, prob_f, (1,))):
        plan = stream.make_plan(pr._Sr, pr.setup.dt, iters, pr.gen_diag,
                                solver, kind=member)
        for E in Es:
            P = to_card(bench_params(pr.setup.nparams, E,
                                     seed=int(rng.integers(1 << 30))))
            C = pr.coeff_rows_mid(P)[..., 0, :].contiguous()
            err = stream_compare(plan, pr._Sr, pr._Si, pr._x0r, pr._x0i, C,
                                 rng)
            print(f"  {member} {solver}-{iters} nt={pr.setup.ntime} E={E} "
                  f"stored={plan.store_iters}: {json.dumps(err)}", flush=True)
            for k in worst_s[member]:
                worst_s[member][k] = max(worst_s[member][k], err[k])
            if err["state"] > TOL_STATE_ABS or max(
                    err["cbar_rel"], err["x0bar_rel"],
                    err["sbar_rel"]) > TOL_GRAD_REL:
                raise RuntimeError(f"{member} kernels disagree with plain: "
                                   f"{solver}-{iters} E={E} {err}")
    dplan = stream.make_plan(prob_f._Sr, prob_f.setup.dt, 8, kind="dense")
    with torch.no_grad():
        P = to_card(bench_params(prob_f.setup.nparams, 1, seed=17))
        H = stream.planes(dplan, prob_f._Sr, prob_f._Si,
                          prob_f.coeff_rows_mid(P)[..., 0, :])
        xd = torch.cat(dense.dense_propagate(dplan, *H, prob_f._x0r,
                                             prob_f._x0i))
        hp = stream.plain_forward(dplan, *H, prob_f._x0r, prob_f._x0i)
        worst_d = float((xd - torch.cat([hp[0][:, -1], hp[1][:, -1]])
                         ).abs().max())
    del H, hp
    if worst_d > TOL_STATE_ABS:
        raise RuntimeError(f"dense_fwd disagrees with plain: {worst_d}")
    phase(17, f"built {spath} in {ssecs:.2f} s; "
              + " | ".join(ptxas_lines(slog))
              + f"; stream/chunk kernels == plain within abs {TOL_STATE_ABS} "
              f"(states), {TOL_GRAD_REL} x max (x0, coefficient and stack "
              f"cotangents); worst {json.dumps(worst_s)}; dense_fwd xT "
              f"{worst_d}")

    # ---- 18. the stream route through Problem ----
    ps = Problem(flagship_setup(fused_mode="stream"))
    if ps.fused_form != "stream" or not ps.fused_ok:
        raise RuntimeError(f"fused_mode='stream' took {ps.fused_form}")
    reset_counts()
    (Js, aux_s), gs = ps.build_value_and_grad()(x, x)
    torch.cuda.synchronize()
    launches_s = sweep_launches(B3)
    errs_s = vg_errors(Js, gs, J, g, *ref_flagship)
    check_vg_errors(errs_s, "stream value_and_grad against streamK")
    reset_counts()
    (JsE, _), gsE = ps.build_ensemble_value_and_grad()(Ps, x)
    torch.cuda.synchronize()
    launches_sE = sweep_launches(B3)
    (JkE, _), gkE = prob.build_ensemble_value_and_grad()(Ps, x)
    errs_sE = dict(J=max_rel(JsE.double(), JkE.double()),
                   g=max_rel(gsE.double(), gkE.double()))
    if errs_sE["J"] > TOL_J_PLAIN or errs_sE["g"] > TOL_G_PLAIN:
        raise RuntimeError(f"stream E={E_BIG} against streamK: {errs_sE}")
    p4s = Problem(dataclasses.replace(cnot4(), fused_mode="stream"))
    if p4s.fused_form != "superop" or not p4s.fused_ok:
        raise RuntimeError(f"open 'stream' took route {p4s.fused_form}")
    got4s, launches_4s = drive(p4s, P1, B3)
    open_s = dict(
        streamk_route=against("cnot4", got4s, got4, "J_plain", "g_plain",
                              "the streamK superop route"),
        f64=against("cnot4", got4s, ref4, "J_f64", "g_f64", "the f64 port"))
    phase(18, f"fused_mode='stream': J={float(Js):.8f} launches "
              f"{json.dumps(launches_s)}, at E={E_BIG} "
              f"{json.dumps(launches_sE)}; against the streamK route and f64 "
              f"{json.dumps(errs_s)}; E={E_BIG} against streamK "
              f"{json.dumps(errs_sE)}; open configuration 1 on 'stream' "
              f"(superop) launches {json.dumps(launches_4s)} "
              f"{json.dumps(open_s)}")

    # ---- 19. the chunk route at dt/4 and the dense forward ----
    pc = Problem(flagship_setup("neumann", 8, ntime=NT_FINE,
                                fused_mode="chunk"))
    if pc.fused_form != "chunk" or pc.linsolver != "neumann":
        raise RuntimeError(f"chunk route {pc.fused_form}, {pc.linsolver}")
    reset_counts()
    (Jc, _), gc = pc.build_value_and_grad()(x, x)
    torch.cuda.synchronize()
    launches_c = sweep_launches(B5)
    with plain_on_card():
        (Jcp, _), gcp = pc.build_value_and_grad()(x, x)
    pc64 = Problem(flagship_setup("neumann", 8, torch.complex128,
                                  ntime=NT_FINE), device="cpu")
    t0 = time.perf_counter()
    (Jc64, _), gc64 = pc64.build_value_and_grad()(x, x)
    secs_c64 = time.perf_counter() - t0
    errs_c = vg_errors(Jc, gc, Jcp, gcp, Jc64, gc64)
    Cc = pc.coeff_rows_mid(to_card(x))[:, 0, :]
    reset_counts()
    xd = dense.pallas_propagate_dense(pc.engine.stack_np, Cc,
                                      torch.complex(pc._x0r, pc._x0i),
                                      pc.setup.dt, 8)
    torch.cuda.synchronize()
    launches_d = sweep_launches(B6)
    with torch.no_grad():
        Hc = stream.planes(pc._plan, pc._Sr, pc._Si, Cc[None])
        xc = stream._kernel_fwd(pc._plan, *Hc, pc._x0r, pc._x0i)[:2]
        hp = stream.plain_forward(pc._plan, *Hc, pc._x0r, pc._x0i)
    err_d = dict(chunk=float((xd - torch.complex(*xc)[0]).abs().max()),
                 plain=float((xd - torch.complex(hp[0][0, -1], hp[1][0, -1])
                              ).abs().max()))
    del hp
    phase(19, f"fused_mode='chunk' at ntime {NT_FINE}: J={float(Jc):.8f} "
              f"launches {json.dumps(launches_c)}; against plain and f64 "
              f"{json.dumps(errs_c)} (f64 on the CPU in {secs_c64:.1f} s); "
              f"pallas_propagate_dense launches {json.dumps(launches_d)}, xT "
              f"against the chunk forward and plain {json.dumps(err_d)}")
    check_vg_errors(errs_c, "chunk value_and_grad")
    if max(err_d.values()) > TOL_STATE_ABS:
        raise RuntimeError(f"dense xT disagrees: {err_d}")

    # ---- 20. calibration: the stack cotangents in user position ----
    reset_counts()
    t0 = time.perf_counter()
    xi_c, err_c, its_c = calibration.KerrCalibration().run()
    torch.cuda.synchronize()
    wall_cal = time.perf_counter() - t0
    launches_cal = main_path_launches(B3)
    sprop = stream.make_stream_propagate(setup.dt, 3, prob.gen_diag, "split")
    wh = to_card(np.random.default_rng(20).normal(
        size=(setup.ntime,) + tuple(prob._x0r.shape)))

    def stack_grads():
        Sr, Si = prob._Sr.clone().requires_grad_(), \
            prob._Si.clone().requires_grad_()
        _, (hr, hi) = sprop(Sr, Si, (prob._x0r, prob._x0i), Cs1)
        L = torch.sum(wh * (hr * hr + hi * hi))
        return torch.cat([t.flatten() for t in torch.autograd.grad(
            L, (Sr, Si))])

    Cs1 = prob.coeff_rows_mid(to_card(x))[:, 0, :]
    sbar = stack_grads()
    with plain_on_card():
        sbar_p = stack_grads()
    sbar_rel = max_rel(sbar, sbar_p)
    phase(20, f"Kerr calibration on the card: xi/2pi "
              f"{xi_c / 2 / np.pi:.6f} GHz (true "
              f"{calibration.XI_TRUE / 2 / np.pi:.6f}), rel err {err_c:.3e} "
              f"after {its_c} secant iterations in {wall_cal:.2f} s, "
              f"launches {json.dumps(launches_cal)}; flagship stack "
              f"cotangents (split-3) kernel against plain {sbar_rel:.3e} x "
              f"max")
    if not err_c < 1e-4 or sbar_rel > TOL_GRAD_REL:
        raise RuntimeError(f"calibration: rel err {err_c}, stack cotangents "
                           f"{sbar_rel}")

    # ---- 21. times of the streamed-plane kernels ----
    Hs1 = stream.planes(ps._plan, ps._Sr, ps._Si, C1[..., :prob.model.K])
    ms_s = stream_kernel_ms(ps._plan, *Hs1, x0r, x0i, 20, True)
    HsE = stream.planes(ps._plan, ps._Sr, ps._Si, CE[..., :prob.model.K])
    ms_sE = stream_kernel_ms(ps._plan, *HsE, x0r, x0i, 10, False)
    del HsE
    ms_c = stream_kernel_ms(pc._plan, *Hc, pc._x0r, pc._x0i, 5, True)
    ms_d = stream_kernel_ms(dplan, *Hc, pc._x0r, pc._x0i, 5, False)
    # dense_fwd's plain version is plain_forward on the same planes, which
    # the chunk row has just timed
    ms_d["plain_fwd"] = ms_c["plain_fwd"]
    vgs, evgs = ps.build_value_and_grad(), ps.build_ensemble_value_and_grad()
    vgc = pc.build_value_and_grad()
    rates_s = {"stream_E1": 1 / median_seconds(lambda: vgs(x, x)),
               f"stream_E{E_BIG}": E_BIG / median_seconds(lambda: evgs(Ps,
                                                                       x)),
               "chunk_E1": 1 / median_seconds(lambda: vgc(x, x), reps=3)}
    # the forward's chain per step: iters + 1 stages, the backward's per
    # reversed step iters + 1 transposed stages (a replay adds iters), each
    # ending on a stage sync over the state threads alone (a __syncwarp
    # where a state's N entries lie in one warp), one named-barrier wait
    # for the step's H (and in the backward pairs) slot, and no block-wide
    # barrier where helper warps copy H ahead (and reduce Hb a step
    # behind); the inline branches pass 2 per step
    def chain_shape(plan, B, N, backward):
        it = plan.iters
        helpers = (stream._bwd_shape(it, B, N) if backward
                   else stream._fwd_shape(B, N))[2]
        replay = backward and not plan.store_iters
        return dict(helper_threads=helpers,
                    stage_syncs_per_step=it + 1 + (it if replay else 0),
                    stage_sync="warp" if 32 % N == 0 else "state warps",
                    block_barriers_per_step=0 if helpers else 2)

    chain_s = {}
    for name, pr, plan, t_ms in (("stream_fwd", ps, ps._plan, ms_s),
                                 ("chunk_fwd", pc, pc._plan, ms_c),
                                 ("dense_fwd", pc, dplan, ms_d),
                                 ("stream_bwd", ps, ps._plan, ms_s),
                                 ("chunk_bwd", pc, pc._plan, ms_c)):
        key = name[-3:]
        chain_s[name] = dict(
            chain_shape(plan, *pr._x0r.shape, key == "bwd"),
            us_per_step=1e3 * t_ms[key] / pr.setup.ntime)
    for key in ("fwd", "bwd"):
        chain_s[f"stream_{key}"]["us_per_step_E128"] = \
            1e3 * ms_sE[key] / ps.setup.ntime
    # empty where the library was built before this run
    regs = {**ptxas_kernels(slog, "stream_fwd"),
            **ptxas_kernels(slog, "stream_bwd")}
    phase(21, f"ms stream split-3 E=1 {json.dumps(ms_s)}; E={E_BIG} "
              f"{json.dumps(ms_sE)}; chunk neumann-8 ntime {NT_FINE} "
              f"{json.dumps(ms_c)}; dense {json.dumps(ms_d)}; sweeps/s "
              f"{json.dumps({k: round(v, 3) for k, v in rates_s.items()})}; "
              f"chains {json.dumps(chain_s)}; ptxas {json.dumps(regs)}; "
              f"card: {smi}")
    inline = [k for k, v in chain_s.items() if v["block_barriers_per_step"]]
    if inline:
        raise RuntimeError(f"the chains of {inline} pass block-wide barriers "
                           "(no helper warps)")

    def record(name, line, n_launch, err, t, key,
               src="quandary_tpu_torch/csrc/streamk.cu",
               tpu="quandary_tpu/ops/pallas_stream.py", **more):
        bound_ms, bound_by = t[f"{key}_bound"]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": f"{tpu}:{line}", "launches": n_launch,
                "max_abs_err": err, "ms": t[key],
                "plain_ms": t[f"plain_{key}"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None, **more}

    def rho_more(i):
        key = ("fwd", "bwd")[i]
        more = dict(src="quandary_tpu_torch/csrc/rho.cu",
                    tpu="quandary_tpu/ops/pallas_rho.py",
                    launches_superop_route=open_launches["cnot4"][B1[i]],
                    launches_device_optimizer=launches_dev16[B4[i]])
        # the kernel's cluster per density matrix and its time per step
        # (reversed for rho_bwd), at configuration 2 and the others
        more["cluster"] = ms_r["cnot16"][f"{key}_cluster"]
        more["us_per_step"] = ms_r["cnot16"][f"{key}_us_per_step"]
        for name, t in ms_r.items():
            if "full_depth" in t:
                more[f"full_depth_{name}"] = t["full_depth"]
            if name != "cnot16":
                more[f"launches_{name}"] = open_launches[name][B4[i]]
                more[f"ms_{name}"] = t[key]
                more[f"bound_ms_{name}"] = t[f"{key}_bound"][0]
                if f"plain_{key}" in t:
                    more[f"plain_ms_{name}"] = t[f"plain_{key}"]
                more[f"cluster_{name}"] = t[f"{key}_cluster"]
                more[f"us_per_step_{name}"] = t[f"{key}_us_per_step"]
        return more

    def streamk_more(i):
        """B1 at E = 128 and on open configuration 1 (superop), and its
        time per reversed (forward) step."""
        key = ("fwd", "bwd")[i]
        return dict(ms_E128=ms_big[key],
                    bound_ms_E128=ms_big[f"{key}_bound"][0],
                    us_per_step=chain[key]["us_per_step"],
                    us_per_step_E128=chain[key]["us_per_step_E128"],
                    launches_open1=open_launches["cnot4"][B1[i]],
                    ms_open1=ms_4[key],
                    bound_ms_open1=ms_4[f"{key}_bound"][0],
                    plain_ms_open1=ms_4[f"plain_{key}"])

    def chain_more(name):
        """A stream.cu kernel's time per (reversed) step and helpers."""
        c = chain_s[name]
        return dict(helpers=c["helper_threads"], **{
            k: c[k] for k in ("us_per_step", "us_per_step_E128") if k in c})

    # library_ms is null: no single PyTorch call computes a whole
    # propagation (a time loop of stage solves) or its transpose
    print(json.dumps({"kernels": [
        record("streamk_fwd", 907, launches[B1[0]], worst["state"], ms, "fwd",
               launches_device_optimizer=launches_dev[B1[0]],
               launches_population=launches_pop[B1[0]], **streamk_more(0)),
        record("streamk_bwd", 967, launches[B1[1]],
               max(worst["cbar"], worst["x0bar"]), ms, "bwd",
               launches_device_optimizer=launches_dev[B1[1]],
               launches_population=launches_pop[B1[1]], **streamk_more(1)),
        record("streamk_packed_fwd", 1324, launches_robust[B2[0]],
               worst_p["state"], ms_p, "fwd", ms_S128=ms_pbig["fwd"],
               bound_ms_S128=ms_pbig["fwd_bound"][0]),
        record("streamk_packed_bwd", 1415, launches_robust[B2[1]],
               max(worst_p["cbar"], worst_p["x0bar"]), ms_p, "bwd",
               ms_S128=ms_pbig["bwd"], bound_ms_S128=ms_pbig["bwd_bound"][0]),
        # the rho kernels at configuration 2 (N = 16, B = 16, E = 1); the
        # other sizes ride along
        record("rho_fwd", 374, open_launches["cnot16"][B4[0]],
               worst_r["state"], ms_r["cnot16"], "fwd", **rho_more(0)),
        record("rho_bwd", 494, open_launches["cnot16"][B4[1]],
               max(worst_r["cbar"], worst_r["x0bar"]), ms_r["cnot16"], "bwd",
               **rho_more(1)),
        # the streamed-plane kernels: stream at the flagship (split-3,
        # E = 1), chunk and dense at ntime 4884 (neumann-8, E = 1)
        record("stream_fwd", 613, launches_s[B3[0]], worst_s["stream"][
            "state"], ms_s, "fwd", src=STREAM_SRC,
               ms_E128=ms_sE["fwd"], bound_ms_E128=ms_sE["fwd_bound"][0],
               launches_E128=launches_sE[B3[0]],
               launches_open_superop=launches_4s[B3[0]],
               launches_calibration=launches_cal[B3[0]], **chain_more(
                   "stream_fwd")),
        record("stream_bwd", 657, launches_s[B3[1]], max(
            worst_s["stream"][k] for k in ("cbar", "x0bar", "sbar")), ms_s,
               "bwd", src=STREAM_SRC, ms_E128=ms_sE["bwd"],
               bound_ms_E128=ms_sE["bwd_bound"][0],
               launches_E128=launches_sE[B3[1]],
               launches_open_superop=launches_4s[B3[1]],
               launches_calibration=launches_cal[B3[1]],
               **chain_more("stream_bwd")),
        record("chunk_fwd", 202, launches_c[B5[0]], worst_s["chunk"]["state"],
               ms_c, "fwd", src=STREAM_SRC,
               tpu="quandary_tpu/ops/pallas_adjoint.py",
               **chain_more("chunk_fwd")),
        record("chunk_bwd", 211, launches_c[B5[1]], max(
            worst_s["chunk"][k] for k in ("cbar", "x0bar", "sbar")), ms_c,
               "bwd", src=STREAM_SRC,
               tpu="quandary_tpu/ops/pallas_adjoint.py",
               **chain_more("chunk_bwd")),
        record("dense_fwd", 111, launches_d[B6[0]], worst_d, ms_d, "fwd",
               src=STREAM_SRC, tpu="quandary_tpu/ops/pallas_kernels.py",
               **chain_more("dense_fwd"))]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
