"""End-to-end check of quandary_tpu_torch on one CUDA GPU.

Drives the port's main paths at the full width of the CNOT flagship
(bench.py:59-93: 2 transmons with 2 essential + 2 guard levels, N = 16,
4 basis states, ntime = 1221, split stepper with 3 iterations, Jtrace with
leakage, energy, dpdm and Tikhonov terms, complex64), through the entry
points a user calls: Problem(...).build_value_and_grad(),
optim.driver.run_optimization, optim.robust.build_packed_robust_objective,
optim.device_driver.run_optimization_device and
optim.batched_lbfgs.batched_lbfgsb. Phases:

1. the device: CUDA must be available; prints the card's name and power
   limit as nvidia-smi gives them;
2. builds the streamK kernels (csrc/streamk.cu) from the checkout;
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
   at or below 1.05 x the host driver's J after the same 60 iterations,
   inside the bounds; wall of the first (capturing) and a second run, and
   of the eager chunk;
10. batched_lbfgsb through Problem.packed_batch_fns, 128 starts x 60
   iterations in the box and from the seed of bench.py:303-309.

Each main path (4-5, 8, 9, 10) is driven with the launch counters set to 0
just before and read just after. Before the device record one line lists
the four kernels with their launches, error, time, plain time and bound.
Any failure raises (non-zero exit). The last line is the device record:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Run from the repository root:  python3 chip_smoke.py
"""

import contextlib
import dataclasses
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from quandary_tpu_torch.models import gates
from quandary_tpu_torch.models.hamiltonian import build_standard_model
from quandary_tpu_torch.ops import streamk
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


def flagship_setup(linsolver="split", linsolve_iters=3, dtype=torch.complex64,
                   freq01=FREQ01):
    """bench.py:59-93, built with the port's own functions. `freq01` detunes
    the qubits against the rotating frame and the carriers, which stay at
    the nominal frequencies (a system realization of the robust ensemble)."""
    Ne, Ng = [2, 2], [2, 2]
    nlevels = [e + g for e, g in zip(Ne, Ng)]
    model = build_standard_model(
        nlevels=nlevels, freq01_ghz=freq01, rotfreq_ghz=FREQ01,
        selfkerr_ghz=SELFKERR, jkl_ghz=[0.005], crosskerr_ghz=[])
    T, ntime = 200.0, 1221
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
        dtype=dtype, linsolve_iters=linsolve_iters, linsolver=linsolver)


def bench_params(n, E=None, seed=1234):
    """The bench's parameter draw: uniform(-1, 1) * 0.005."""
    shape = (n,) if E is None else (E, n)
    return np.random.default_rng(seed).uniform(-1, 1, shape) * 0.005


def phase(n, msg):
    print(f"phase {n}: {msg}", flush=True)


@contextlib.contextmanager
def plain_on_card():
    """Route the problem's streamK propagation through the plain torch
    version for CUDA tensors too (the reference run of phases 4 and 6)."""
    saved = streamk.streamk_propagate
    streamk.streamk_propagate = streamk.streamk_propagate_plain
    try:
        yield
    finally:
        streamk.streamk_propagate = saved


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


def event_ms(fn, reps):
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
    operations over the CUDA cores' peak."""
    BN, NN, Ke, it = B * N, N * N, plan.Ke, plan.iters
    stacks = (E if plan.per_block else 1) * (2 * Ke * NN) + plan.rows.numel()
    ks = 2 * E * nt * it * BN if plan.store_iters else 0
    hist = 2 * E * nt * BN
    matvec = 8 * BN * N                    # complex (B, N) x (N, N), real ops
    contract = 4 * Ke * NN
    if backward:
        words = stacks + E * nt * Ke + 2 * BN + 2 * hist + 2 * E * BN + ks \
            + 2 * E * BN + E * nt * Ke
        replay = 0 if plan.store_iters else it * matvec
        flops = contract + replay + (it + 1) * matvec \
            + (it + 1) * 8 * B * NN + 4 * Ke * NN
    else:
        words = stacks + E * nt * Ke + 2 * BN + 2 * E * BN + hist + ks
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


def main_path_launches(names):
    """Reads the counters after a main path was driven (they were set to 0
    just before it) and fails if a kernel of that path never launched."""
    counts = streamk.launch_counts()
    missing = [k for k in names if counts[k] < 1]
    if missing:
        raise RuntimeError(f"main path did not launch {missing}: {counts}")
    return counts


B1 = ("streamk_fwd_launches", "streamk_bwd_launches")
B2 = ("streamk_packed_fwd_launches", "streamk_packed_bwd_launches")


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
    kind = torch.cuda.get_device_name(0)
    phase(1, f"{kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
             f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain path in full f32
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build ----
    path, secs, log = streamk.build_kernels(verbose=True)
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    phase(2, f"built {path} in {secs:.2f} s; " + " | ".join(ptxas))

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
    streamk.reset_launch_counts()
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
    # the dependent chain: per time step the forward passes iters + 2
    # block-wide barriers (contraction, b = T(x), one per stage iterate)
    # and the backward with stored iterates iters + 3
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
    chain = {k: dict(stages_per_step=st, us_per_step=1e3 * ms[k] / setup.ntime,
                     us_per_stage=1e3 * ms[k] / setup.ntime / st,
                     floor_us_per_stage=floor_us,
                     floor_ms_per_sweep=1e-3 * floor_us * st * setup.ntime)
             for k, st in (("fwd", plan.iters + 2), ("bwd", plan.iters + 3))}
    phase(6, "sweeps/s " + json.dumps({k: round(v, 3) for k, v in
                                      rates.items()})
          + f"; kernel ms at E=1 split-3 {json.dumps(ms)}; at E={E_BIG} "
          + f"{json.dumps(ms_big)}; chain {json.dumps(chain)}; card: {smi}")

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
    streamk.reset_launch_counts()
    Jr, gr, auxr = robust_vg(packed_obj, x32, "cuda")
    torch.cuda.synchronize()
    launches_robust = main_path_launches(B2)
    if launches_robust != dict(zip(B1 + B2, (0, 0, 1, 1))):
        raise RuntimeError("a packed robust gradient must be one launch of "
                           f"each packed kernel: {launches_robust}")
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
        streamk.reset_launch_counts()
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
            and res_d.objective <= 1.05 * res_h.objective + 1e-10
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
        streamk.reset_launch_counts()
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

    src = "quandary_tpu_torch/csrc/streamk.cu"
    tpu = "quandary_tpu/ops/pallas_stream.py"

    def record(name, line, n_launch, err, t, key, **more):
        bound_ms, bound_by = t[f"{key}_bound"]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": f"{tpu}:{line}", "launches": n_launch,
                "max_abs_err": err, "ms": t[key],
                "plain_ms": t[f"plain_{key}"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None, **more}

    # library_ms is null: no single PyTorch call computes a whole
    # propagation (a time loop of stage solves) or its transpose
    print(json.dumps({"kernels": [
        record("streamk_fwd", 907, launches[B1[0]], worst["state"], ms, "fwd",
               launches_device_optimizer=launches_dev[B1[0]],
               launches_population=launches_pop[B1[0]]),
        record("streamk_bwd", 967, launches[B1[1]],
               max(worst["cbar"], worst["x0bar"]), ms, "bwd",
               launches_device_optimizer=launches_dev[B1[1]],
               launches_population=launches_pop[B1[1]]),
        record("streamk_packed_fwd", 1324, launches_robust[B2[0]],
               worst_p["state"], ms_p, "fwd"),
        record("streamk_packed_bwd", 1415, launches_robust[B2[1]],
               max(worst_p["cbar"], worst_p["x0bar"]), ms_p, "bwd")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
